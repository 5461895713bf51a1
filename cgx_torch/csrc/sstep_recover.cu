// The recover launch of the fused streaming s-step block for Hopper (sm_90a),
// the second of a block's two launches (the Gram launch is in sstep_stream.cu).
//
// Replaces the Pallas TPU kernel of cgx/ops/sstep_stream.py:
//   _sstep_recover (_recover_kernel, pallas_call at sstep_stream.py:466)
//
// It forms sum xc_i V_i, sum d_i V_i and sum c_i V_i a row at a time, in level
// order, the coefficients rounded to the vectors' type (sstep_stream.py:734),
// and writes x + (sum xc_i V_i) in place and r and p to the other half of their
// ping-pong pairs. cgx's kernel adds each term to x in turn; adding the whole
// increment once, as cgx's s-step loop does (sstep.py:226), rounds x once a
// block instead of 2s+1 times, which keeps the float64 goldens' true residual
// under the reference's 1e-11. cgx aliases r and p in place and orders its DMAs
// so that block j+1 reads its halo before block j writes
// (sstep_stream.py:454-461); CUDA blocks run at once and the halo reaches s R
// rows, so here the halves alternate: the generator reads only the current
// half, and a block touches x only at its own rows. The parity is the state's
// block count, which only a live recover advances (its last block, by a
// ticket, also clears the live mark): a launch pair that finds the solve
// stopped (converged, broken down or at maxiter) changes nothing, so the host
// may queue blocks past the stop freely.
//
// Two designs, the Gram launch's (cgx_torch.ops.dia_powers.basis_plan picks
// one for both launches of a block):
// - "wavefront" (recover_wave_kernel): one 512-thread block an SM on one slab
//   generates the levels with gen_wave (sstep_basis.cuh), every level in a
//   ring in shared memory, and the consumer forms the three combinations at
//   the frontier, where every level of its rows is formed. It keeps three sums
//   a thread (the Gram 23), so the generator has the registers; x's load for
//   the frontier's rows is issued with the step's other loads.
// - "slab" (recover_kernel), where the rings do not fit: each block
//   regenerates its slab's levels into its scratch in device memory with
//   gen_chain, a latency-bound pass a level, then combines them row by row.
//
// Bound: memory. The launch must read the bands, p, r and x once and write x,
// r and p: (ndiag b + 6 v) N bytes for b-byte bands and v-byte vectors. The
// wavefront reads p and r once and the bands once an application, from L2
// for all but the first (a block's window of them is a few thousand rows).
#include <cuda_bf16.h>

#include "common.cuh"
#include "sstep_block.cuh"

namespace cgx {

// After every block of a live recover is done: the last block to take the
// ticket advances the block count and clears the live mark.
template <typename T, typename B>
__device__ void recover_finish(const BlockArgs<T, B>& g) {
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    g.state[kBlk] = g.state[kBlk] + 1.0;
    g.state[kLive] = 0.0;
    *g.ticket = 0u;
  }
}

template <typename T, typename B>
__global__ void __launch_bounds__(kBasisThreads, 2) recover_kernel(BlockArgs<T, B> g) {
  __shared__ T coef[3 * kMaxM];  // xc, d, c
  const double* st = g.state;
  if (st[kLive] == 0.0) return;  // the Gram launch found the solve stopped
  const int q = static_cast<long long>(st[kBlk]) & 1;
  const int s = g.a.s, m = 2 * s + 1;
  for (int t = threadIdx.x; t < 3 * m; t += blockDim.x) coef[t] = static_cast<T>(st[kCoef + t]);
  T* buf0 = g.scratch + static_cast<long long>(blockIdx.x) * g.per_block;
  T* buf1 = buf0 + g.half;
  T* lv = buf1 + g.half;
  const long long n = g.a.n, tile = g.tile;
  T* x = g.x;
  T* r_out = g.r_out[q ^ 1];
  T* p_out = g.p_out[q ^ 1];
  __syncthreads();  // coef is loaded
  for (long long t0 = static_cast<long long>(blockIdx.x) * tile; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * tile) {
    const long long t1 = t0 + tile < n ? t0 + tile : n;
    LevelSink<T> sink{lv, t0, tile};
    gen_chain(g.a, g.p[q], s + 1, 0, t0, t1, buf0, buf1, sink);
    gen_chain(g.a, g.r[q], s, s + 1, t0, t1, buf0, buf1, sink);  // ends with a barrier
    for (long long j = t0 + threadIdx.x; j < t1; j += blockDim.x) {
      T dx = T(0), rr = T(0), pp = T(0);
      for (int i = 0; i < m; ++i) {  // level order, as the plain version
        const T v = lv[i * tile + (j - t0)];
        dx = dx + coef[i] * v;
        rr = rr + coef[m + i] * v;
        pp = pp + coef[2 * m + i] * v;
      }
      x[j] = x[j] + dx;
      r_out[j] = rr;
      p_out[j] = pp;
    }
    __syncthreads();  // lv is rewritten by a next tile
  }
  recover_finish(g);
}

// A level's three coefficients, read as one vector from shared memory
template <typename T>
struct alignas(4 * sizeof(T)) Coef3 {
  T xc, d, c, pad;
};

// The recover's consumer of gen_wave: thread jj combines the m levels of
// frontier row first + jj, in level order, if the row is the slab's.
template <typename T, int S>
struct RecoverRows : WaveUse {
  static constexpr int kM = 2 * S + 1;
  const WavePlan* pl;
  const T* ring;
  const Coef3<T>* coef;
  T* x;
  T* r_out;
  T* p_out;
  long long t0, t1;
  T x_row;  // x at the thread's frontier row, loaded with the step's other loads

  __device__ __forceinline__ bool mine(long long row) const { return row >= t0 && row < t1; }

  __device__ __forceinline__ void load(long long first) {
    const long long row = first + threadIdx.x;
    if (mine(row)) x_row = x[row];
  }

  __device__ __forceinline__ void operator()(long long first, const WaveSlots* sl) {
    const int jj = threadIdx.x;
    const long long row = first + jj;
    if (!mine(row)) return;
    T dx = T(0), rr = T(0), pp = T(0);
#pragma unroll
    for (int l = 0; l < kM; ++l) {
      const T v = wave_at(*pl, ring, sl, l, jj);
      const Coef3<T> c = coef[l];
      dx = dx + c.xc * v;
      rr = rr + c.d * v;
      pp = pp + c.c * v;
    }
    x[row] = x_row + dx;
    r_out[row] = rr;
    p_out[row] = pp;
  }
};

// One block an SM (the grid of basis_plan); 512 threads of at most 128
// registers.
template <typename T, typename B, int S, int ND>
__global__ void __launch_bounds__(kWaveThreads, 1)
    recover_wave_kernel(const __grid_constant__ BlockArgs<T, B> g,
                        const __grid_constant__ WavePlan pl) {  // read in place, never copied
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WaveSlots slots[2][kWaveMaxM];
  __shared__ Coef3<T> coef[2 * S + 1];
  const double* st = g.state;
  if (st[kLive] == 0.0) return;  // the Gram launch found the solve stopped
  const int q = static_cast<long long>(st[kBlk]) & 1;
  constexpr int M = 2 * S + 1;
  if (threadIdx.x < M)  // gen_wave's first barrier orders these stores before any read
    coef[threadIdx.x] = {static_cast<T>(st[kCoef + threadIdx.x]),
                         static_cast<T>(st[kCoef + M + threadIdx.x]),
                         static_cast<T>(st[kCoef + 2 * M + threadIdx.x]), T(0)};
  RecoverRows<T, S> rows;
  rows.pl = &pl;
  rows.ring = reinterpret_cast<const T*>(smem);
  rows.coef = coef;
  rows.x = g.x;
  rows.r_out = g.r_out[q ^ 1];
  rows.p_out = g.p_out[q ^ 1];
  const long long n = g.a.n;
  for (long long t0 = static_cast<long long>(blockIdx.x) * pl.slab; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * pl.slab) {
    rows.t0 = t0;
    rows.t1 = t0 + pl.slab < n ? t0 + pl.slab : n;
    gen_wave<S, ND>(g.a, pl, g.p[q], g.r[q], reinterpret_cast<T*>(smem), t0, rows.t1, slots,
                     rows);
  }
  recover_finish(g);
}

template <typename T, typename B>
static int launch_recover(const void* bands, void* const* pr, void* x, void* state,
                          void* scratch, long long scratch_len, void* ticket, long long n,
                          const long long* offsets, int ndiag, int s, double theta, double delta,
                          const double* shifts, int nshifts, long long tile, int grid,
                          void* stream) {
  BlockArgs<T, B> g;
  if (!make_block(&g, bands, pr, x, state, nullptr, scratch, scratch_len, ticket, n, offsets,
                  ndiag, s, theta, delta, shifts, nshifts, tile, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  recover_kernel<T, B><<<grid, kBasisThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B>
static int launch_recover_wave(const void* bands, void* const* pr, void* x, void* state,
                               void* ticket, long long n, const long long* offsets, int ndiag,
                               int s, double theta, double delta, const double* shifts,
                               int nshifts, const long long* plan, int plan_len, int grid,
                               void* stream) {
  BlockArgs<T, B> g;
  WavePlan pl;
  if (!make_wave_block(&g, &pl, bands, pr, x, state, nullptr, ticket, n, offsets, ndiag, s,
                       theta, delta, shifts, nshifts, plan, plan_len, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  return wave_dispatch(s, offsets, ndiag, [&](auto S, auto ND) {
    return wave_launch<recover_wave_kernel<T, B, decltype(S)::value, decltype(ND)::value>>(
        grid, plan[3], stream, g, pl);
  });
}

}  // namespace cgx

extern "C" {

#define CGX_RECOVER_ENTRIES(SUFFIX, T, B)                                                        \
  int cgx_sstep_recover##SUFFIX(const void* bands, void* p0, void* p1, void* r0, void* r1,      \
                                void* x, void* state, void* scratch, long long scratch_len,     \
                                void* ticket, long long n, const long long* offsets,            \
                                int ndiag, int s, double theta, double delta,                   \
                                const double* shifts, int nshifts, long long tile, int grid,    \
                                void* stream) {                                                 \
    void* pr[4] = {p0, p1, r0, r1};                                                              \
    return cgx::launch_recover<T, B>(bands, pr, x, state, scratch, scratch_len, ticket, n,      \
                                     offsets, ndiag, s, theta, delta, shifts, nshifts, tile,    \
                                     grid, stream);                                             \
  }                                                                                              \
  int cgx_sstep_recover_wave##SUFFIX(const void* bands, void* p0, void* p1, void* r0, void* r1, \
                                     void* x, void* state, void* ticket, long long n,           \
                                     const long long* offsets, int ndiag, int s, double theta,  \
                                     double delta, const double* shifts, int nshifts,           \
                                     const long long* plan, int plan_len, int grid,             \
                                     void* stream) {                                            \
    void* pr[4] = {p0, p1, r0, r1};                                                              \
    return cgx::launch_recover_wave<T, B>(bands, pr, x, state, ticket, n, offsets, ndiag, s,    \
                                          theta, delta, shifts, nshifts, plan, plan_len, grid,  \
                                          stream);                                              \
  }

CGX_RECOVER_ENTRIES(_f32, float, float)
CGX_RECOVER_ENTRIES(_f64, double, double)
CGX_RECOVER_ENTRIES(_f32_bf16b, float, __nv_bfloat16)

#undef CGX_RECOVER_ENTRIES

}  // extern "C"
