// The fused streaming s-step block for Hopper (sm_90a): s CG iterations as a
// Gram launch and a recover launch (sstep_recover.cu), the Krylov basis never
// written to device memory; and the coefficient replay as a one-block kernel.
//
// Replaces the Pallas TPU kernel of cgx/ops/sstep_stream.py:
//   _sstep_gram    (_gram_kernel,    pallas_call at sstep_stream.py:395)
// and, as cgx_sstep_replay, the XLA replay between the launches (replay_block
// at sstep_stream.py:730, and the replay of the matrix-powers route,
// cgx/solver/sstep.py:218).
//
// Gram launch, two designs; cgx_torch.ops.dia_powers.basis_plan picks one by
// a size rule, the same for both launches of a block, and the wrapper records
// it. Both add the m(m+1)/2 products of each row's levels to a block's
// partial Gram in float64: a product of two floats is exact in double, so only
// the sums round (cgx accumulated in double-float32 with two_sum,
// sstep_stream.py:212-239; double is the Hopper equivalent and more).
// - "wavefront" (gram_wave_kernel), where the levels' rings fit the shared
//   memory of one block an SM (float32 vectors at s <= 4 and R = 3200): one
//   block an SM, each on one slab of n / grid rows, generates the levels with
//   gen_wave (sstep_basis.cuh), so no level leaves the chip; each thread
//   adds the products of two of each step's Gram rows, keeping half of the
//   m(m+1)/2 sums in registers, and the block sums its threads' in warp and
//   thread order at the end.
// - "slab" (gram_slab_kernel), elsewhere (float64 at that reach, a large s):
//   each block generates its slab's levels with gen_chain into its scratch in
//   device memory, then walks over the slab in sub-tiles staged in shared
//   memory; a warp owns fixed pairs.
// Each block has a fixed slab and each sum a fixed order, so every partial is
// summed in one order. The last block to take an integer ticket sums the
// partials in block order (no float atomics), stores G, and replays the s
// iterations in float64 on one thread (cgx replays in float32 with compensated
// quadratic forms; the port keeps the whole replay in double, ROADMAP C). It
// writes [xc, d, c] and the scalars [k, rsold, rsnew, conv, brk] to the packed
// state and marks the block live.
//
// Bound: memory. A block of s iterations must read the bands and p and r twice
// (once a launch) and x once, and write x, r and p: (2 ndiag + 3 + 2 + 3) N
// values, in bytes (2 ndiag b + 8 v) N for b-byte bands and v-byte vectors;
// the products and the 2s - 1 band applications a launch are far below the
// card's rate. The slab designs move several times that: the bands once an
// application, each working level out and back, the slab's levels once more.
// The wavefront reads the bands once an application too, but from L2 (a
// block's window of them is the lags' few thousand rows), and p and r twice.
#include <cuda_bf16.h>

#include "common.cuh"
#include "sstep_block.cuh"

namespace cgx {

// pair index -> (row, column), row <= column, rows first
__device__ __forceinline__ void pair_of(int pr, int m, int* ia, int* ib) {
  int i = 0;
  while (pr >= m - i) {
    pr -= m - i;
    ++i;
  }
  *ia = i;
  *ib = i + pr;
}

constexpr int kGramShared = 64 * 1024;  // bytes of the Gram's sub-tile of m levels

template <typename T>
__host__ __device__ inline int gram_sub(int m) {  // rows of a sub-tile, a multiple of 32
  return kGramShared / (m * static_cast<int>(sizeof(T))) / 32 * 32;
}

// After each block wrote its partials: the last block to take the ticket sums
// them in block order into G (gm: m x m doubles of shared memory), stores it,
// replays the s iterations, marks the block live and resets the ticket.
template <typename T, typename B>
__device__ void gram_finish(const BlockArgs<T, B>& g, double* gm) {
  __shared__ bool is_last;
  const int m = 2 * g.a.s + 1, npairs = m * (m + 1) / 2;
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const volatile double* parts = g.partials;  // written by other SMs: bypass L1
  for (int t = threadIdx.x; t < npairs; t += blockDim.x) {
    double v = 0.0;
    for (unsigned int b = 0; b < gridDim.x; ++b) v += parts[static_cast<long long>(b) * npairs + t];
    int ia, ib;
    pair_of(t, m, &ia, &ib);
    gm[ia * m + ib] = v;
    gm[ib * m + ia] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double* out = g.state;
    for (int i = 0; i < m * m; ++i) out[kGram + i] = gm[i];
    replay(out, gm, g.bmat, g.a.s, g.tol, g.nearzero, g.maxiter);
    out[kLive] = 1.0;
    *g.ticket = 0u;
  }
}

template <typename T, typename B>
__global__ void __launch_bounds__(kBasisThreads, 2) gram_slab_kernel(BlockArgs<T, B> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cen = reinterpret_cast<T*>(smem);  // m x sub: a sub-tile's rows of each level
  __shared__ double part[kMaxM * (kMaxM + 1) / 2];
  __shared__ double gm[kMaxM * kMaxM];
  const double* st = g.state;
  if (st[kConv] != 0.0 || st[kBrk] != 0.0 || !(st[kK] < g.maxiter)) return;  // stopped
  const int q = static_cast<long long>(st[kBlk]) & 1;
  const int s = g.a.s, m = 2 * s + 1, npairs = m * (m + 1) / 2;
  for (int t = threadIdx.x; t < npairs; t += blockDim.x) part[t] = 0.0;
  T* buf0 = g.scratch + static_cast<long long>(blockIdx.x) * g.per_block;
  T* buf1 = buf0 + g.half;
  T* lv = buf1 + g.half;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int sub = gram_sub<T>(m);
  const long long n = g.a.n;
  for (long long t0 = static_cast<long long>(blockIdx.x) * g.tile; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * g.tile) {
    const long long t1 = t0 + g.tile < n ? t0 + g.tile : n;
    LevelSink<T> sink{lv, t0, g.tile};
    gen_chain(g.a, g.p[q], s + 1, 0, t0, t1, buf0, buf1, sink);
    gen_chain(g.a, g.r[q], s, s + 1, t0, t1, buf0, buf1, sink);  // ends with a barrier
    for (long long u0 = 0; u0 < t1 - t0; u0 += sub) {
      const int rows = static_cast<int>(t1 - t0 - u0 < sub ? t1 - t0 - u0 : sub);
      for (int t = threadIdx.x; t < m * sub; t += blockDim.x) {
        const int level = t / sub, i = t - level * sub;
        if (i < rows) cen[t] = lv[level * g.tile + u0 + i];
      }
      __syncthreads();
      for (int pr = warp; pr < npairs; pr += nwarps) {
        int ia, ib;
        pair_of(pr, m, &ia, &ib);
        const T* va = cen + ia * sub;
        const T* vb = cen + ib * sub;
        double acc = 0.0;
        for (int i = lane; i < rows; i += 32)
          acc += static_cast<double>(va[i]) * static_cast<double>(vb[i]);
        acc = warp_sum(acc);
        if (lane == 0) part[pr] += acc;
      }
      __syncthreads();  // cen is restaged, and lv rewritten by a next tile
    }
  }
  for (int t = threadIdx.x; t < npairs; t += blockDim.x)
    g.partials[static_cast<long long>(blockIdx.x) * npairs + t] = part[t];
  gram_finish(g, gm);
}

// The Gram's consumer of gen_wave. The pairs (i, j >= i), in pair_of's
// order, are cut in two runs; each half of the block (warps 0-7, 8-15) keeps
// one run's float64 sums in registers, and its thread i adds the products of
// window rows i and i + 256. 23 sums a thread at s = 4 leave the generator
// the rest of the 128 registers (on the H100 this ran faster than a quarter of
// the sums over four rows, and than sums reduced over the warp every step).
template <typename T, int S>
struct GramRows : WaveUse {
  static constexpr int kM = 2 * S + 1, kPairs = kM * (kM + 1) / 2;
  static constexpr int kRun = (kPairs + 1) / 2, kHalf = kWaveThreads / 2;
  const WavePlan* pl;
  const T* ring;
  long long t0, t1;
  double acc[kRun];

  template <int P0>
  __device__ __forceinline__ void add_rows(long long first, const WaveSlots* sl) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int jj = (threadIdx.x & (kHalf - 1)) + k * kHalf;
      const long long row = first + jj;
      const bool ok = row >= t0 && row < t1;
      double v[kM];
#pragma unroll
      for (int l = 0; l < kM; ++l)
        v[l] = ok ? static_cast<double>(wave_at(*pl, ring, sl, l, jj)) : 0.0;
      int pr = 0;
#pragma unroll
      for (int i = 0; i < kM; ++i) {
#pragma unroll
        for (int j = i; j < kM; ++j) {
          if (pr >= P0 && pr < P0 + kRun) acc[pr - P0] += v[i] * v[j];
          ++pr;
        }
      }
    }
  }

  __device__ __forceinline__ void operator()(long long first, const WaveSlots* sl) {
    if (threadIdx.x < kHalf)  // one run a warp
      add_rows<0>(first, sl);
    else
      add_rows<kRun>(first, sl);
  }
};

// One block an SM (the grid of basis_plan); 512 threads of at most 128
// registers.
template <typename T, typename B, int S, int ND>
__global__ void __launch_bounds__(kWaveThreads, 1)
    gram_wave_kernel(const __grid_constant__ BlockArgs<T, B> g,
                     const __grid_constant__ WavePlan pl) {  // read in place, never copied
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WaveSlots slots[2][kWaveMaxM];
  const double* st = g.state;
  if (st[kConv] != 0.0 || st[kBrk] != 0.0 || !(st[kK] < g.maxiter)) return;  // stopped
  const int q = static_cast<long long>(st[kBlk]) & 1;
  using Rows = GramRows<T, S>;
  Rows rows;
  rows.pl = &pl;
  rows.ring = reinterpret_cast<const T*>(smem);
#pragma unroll
  for (int t = 0; t < Rows::kRun; ++t) rows.acc[t] = 0.0;
  const long long n = g.a.n;
  for (long long t0 = static_cast<long long>(blockIdx.x) * pl.slab; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * pl.slab) {
    rows.t0 = t0;
    rows.t1 = t0 + pl.slab < n ? t0 + pl.slab : n;
    gen_wave<S, ND>(g.a, pl, g.p[q], g.r[q], reinterpret_cast<T*>(smem), t0, rows.t1, slots,
                     rows);
  }  // gen_wave ends with a barrier: the rings are free
  double* red = reinterpret_cast<double*>(smem);  // (warps, a run of pairs)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kRunWarps = Rows::kHalf / 32;
#pragma unroll
  for (int t = 0; t < Rows::kRun; ++t) {
    const double v = warp_sum(rows.acc[t]);
    if (lane == 0) red[warp * Rows::kRun + t] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Rows::kPairs; t += blockDim.x) {  // pair t: its run's warps
    const int w0 = t / Rows::kRun * kRunWarps, pt = t % Rows::kRun;
    double v = 0.0;
    for (int w = w0; w < w0 + kRunWarps; ++w) v += red[w * Rows::kRun + pt];
    g.partials[static_cast<long long>(blockIdx.x) * Rows::kPairs + t] = v;
  }
  gram_finish(g, red);  // its barrier comes before red is reused for G
}

__global__ void replay_kernel(double* st, const double* bmat, int s, double tol, double nearzero,
                              double maxiter) {
  if (threadIdx.x == 0 && blockIdx.x == 0) replay(st, st + kGram, bmat, s, tol, nearzero, maxiter);
}

template <typename T, typename B>
static int launch_gram_wave(const void* bands, void* const* pr, void* state, const void* bmat,
                            void* partials, long long partials_len, void* ticket, long long n,
                            const long long* offsets, int ndiag, int s, double theta,
                            double delta, const double* shifts, int nshifts, double tol,
                            double nearzero, double maxiter, const long long* plan, int plan_len,
                            int grid, void* stream) {
  BlockArgs<T, B> g;
  WavePlan pl;
  const int m = 2 * s + 1;
  const long long npairs = m * (m + 1) / 2;
  if (!make_wave_block(&g, &pl, bands, pr, nullptr, state, bmat, ticket, n, offsets, ndiag, s,
                       theta, delta, shifts, nshifts, plan, plan_len, grid) ||
      partials_len < grid * npairs ||
      plan[3] < kWaveThreads / 32 * npairs * 8 || plan[3] < m * m * 8)
    return static_cast<int>(cudaErrorInvalidValue);  // the block's reduction and G reuse the rings
  g.partials = static_cast<double*>(partials);
  g.tol = tol;
  g.nearzero = nearzero;
  g.maxiter = maxiter;
  return wave_dispatch(s, offsets, ndiag, [&](auto S, auto ND) {
    return wave_launch<gram_wave_kernel<T, B, decltype(S)::value, decltype(ND)::value>>(
        grid, plan[3], stream, g, pl);
  });
}

template <typename T, typename B>
static int launch_gram(const void* bands, void* const* pr, void* state, const void* bmat,
                       void* scratch, long long scratch_len, void* partials,
                       long long partials_len, void* ticket, long long n,
                       const long long* offsets, int ndiag, int s, double theta, double delta,
                       const double* shifts, int nshifts, double tol, double nearzero,
                       double maxiter, long long tile, int grid, void* stream) {
  BlockArgs<T, B> g;
  const int m = 2 * s + 1;
  if (!make_block(&g, bands, pr, nullptr, state, bmat, scratch, scratch_len, ticket, n, offsets,
                  ndiag, s, theta, delta, shifts, nshifts, tile, grid) ||
      partials_len < static_cast<long long>(grid) * m * (m + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  g.partials = static_cast<double*>(partials);
  g.tol = tol;
  g.nearzero = nearzero;
  g.maxiter = maxiter;
  const size_t shared = static_cast<size_t>(m) * gram_sub<T>(m) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(gram_slab_kernel<T, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_slab_kernel<T, B><<<grid, kBasisThreads, shared, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx

extern "C" {

#define CGX_SSTEP_ENTRIES(SUFFIX, T, B)                                                         \
  int cgx_sstep_gram##SUFFIX(const void* bands, void* p0, void* p1, void* r0, void* r1,        \
                             void* state, const void* bmat, void* scratch,                     \
                             long long scratch_len, void* partials, long long partials_len,    \
                             void* ticket, long long n, const long long* offsets, int ndiag,   \
                             int s, double theta, double delta, const double* shifts,          \
                             int nshifts, double tol, double nearzero, double maxiter,         \
                             long long tile, int grid, void* stream) {                         \
    void* pr[4] = {p0, p1, r0, r1};                                                             \
    return cgx::launch_gram<T, B>(bands, pr, state, bmat, scratch, scratch_len, partials,      \
                                  partials_len, ticket, n, offsets, ndiag, s, theta, delta,    \
                                  shifts, nshifts, tol, nearzero, maxiter, tile, grid, stream); \
  }                                                                                             \
  int cgx_sstep_gram_wave##SUFFIX(const void* bands, void* p0, void* p1, void* r0, void* r1,   \
                                  void* state, const void* bmat, void* partials,               \
                                  long long partials_len, void* ticket, long long n,           \
                                  const long long* offsets, int ndiag, int s, double theta,    \
                                  double delta, const double* shifts, int nshifts, double tol, \
                                  double nearzero, double maxiter, const long long* plan,      \
                                  int plan_len, int grid, void* stream) {                      \
    void* pr[4] = {p0, p1, r0, r1};                                                             \
    return cgx::launch_gram_wave<T, B>(bands, pr, state, bmat, partials, partials_len, ticket, \
                                       n, offsets, ndiag, s, theta, delta, shifts, nshifts,    \
                                       tol, nearzero, maxiter, plan, plan_len, grid, stream);  \
  }

CGX_SSTEP_ENTRIES(_f32, float, float)
CGX_SSTEP_ENTRIES(_f64, double, double)
CGX_SSTEP_ENTRIES(_f32_bf16b, float, __nv_bfloat16)

#undef CGX_SSTEP_ENTRIES

int cgx_sstep_replay_f64(void* state, const void* bmat, int s, double tol, double nearzero,
                         double maxiter, void* stream) {
  if (s < 1 || s > cgx::kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  cgx::replay_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(state), static_cast<const double*>(bmat), s, tol, nearzero, maxiter);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
