// The fused streaming s-step block for Hopper (sm_90a): s CG iterations as a
// Gram launch and a recover launch, the Krylov basis never written to device
// memory; and the coefficient replay as a one-block kernel.
//
// Replaces the Pallas TPU kernels of cgx/ops/sstep_stream.py:
//   _sstep_gram    (_gram_kernel,    pallas_call at sstep_stream.py:395)
//   _sstep_recover (_recover_kernel, pallas_call at sstep_stream.py:466)
// and, as cgx_sstep_replay, the XLA replay between them (replay_block at
// sstep_stream.py:730, and the replay of the matrix-powers route,
// cgx/solver/sstep.py:218).
//
// Gram launch. Each block owns one contiguous slab of rows, generates the
// slab's rows of all 2s+1 basis levels (sstep_basis.cuh, the generator of B9)
// into its scratch, then walks over the slab in sub-tiles staged in shared
// memory and adds the m(m+1)/2 products of their rows to its partial Gram in
// float64: a product of two floats is exact in double, so only the sums round
// (cgx accumulated in double-float32 with two_sum, sstep_stream.py:212-239;
// double is the Hopper equivalent and more). A warp owns fixed pairs and each
// block a fixed slab, so every partial is summed in one order. The last block to take an integer ticket sums the
// partials in block order (no float atomics), stores G, and replays the s
// iterations in float64 on one thread (cgx replays in float32 with compensated
// quadratic forms; the port keeps the whole replay in double, ROADMAP C). It
// writes [xc, d, c] and the scalars [k, rsold, rsnew, conv, brk] to the packed
// state and marks the block live.
//
// Recover launch. Each block regenerates its slab's levels into its scratch,
// then forms sum xc_i V_i, sum d_i V_i and sum c_i V_i a row at a time, in
// level order, the coefficients rounded to the vectors' type
// (sstep_stream.py:734), and writes x + (sum xc_i V_i) in place and r and p
// to the other half of their ping-pong pairs. cgx's kernel adds each term to
// x in turn; adding the whole increment once, as cgx's s-step loop does
// (sstep.py:226), rounds x once a block instead of 2s+1 times, which keeps
// the float64 goldens' true residual under the reference's 1e-11. cgx aliases r and p in place and orders its DMAs so
// that block j+1 reads its halo before block j writes (sstep_stream.py:454-461);
// CUDA blocks run at once and the halo reaches s R rows, so here the halves
// alternate. The parity is the state's block count, which only a live recover
// advances (its last block, by a ticket, also clears the live mark): a launch
// pair that finds the solve stopped (converged, broken down or at maxiter)
// changes nothing, so the host may queue blocks past the stop freely.
//
// Bound: memory. A block of s iterations must read the bands and p and r twice
// (once a launch) and x once, and write x, r and p: (2 ndiag + 3 + 2 + 3) N
// values, in bytes (2 ndiag b + 8 v) N for b-byte bands and v-byte vectors;
// the products and the 2s - 1 band applications a launch are far below the
// card's rate. This kernel moves several times that: the bands once an
// application, each working level out and back, the slab's levels once more.
#include <cuda_bf16.h>

#include "common.cuh"
#include "sstep_basis.cuh"

namespace cgx {

template <typename T, typename B>
struct BlockArgs {
  Basis<T, B> a;
  const T* p[2];  // ping-pong pairs, read [blk % 2]
  const T* r[2];
  T* p_out[2];    // written [1 - blk % 2] by the recover launch
  T* r_out[2];
  T* x;           // recover: in place
  double* state;  // the packed float64 state (sstep_basis.cuh, enum State)
  const double* bmat;
  T* scratch;      // a block's: two working buffers, then m x tile levels
  long long per_block;  // scratch values a block
  long long half;  // values of one working buffer
  double* partials;  // gram: m(m+1)/2 a block
  unsigned int* ticket;
  long long tile;
  double tol, nearzero, maxiter;
};

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

// the slab's rows of each level, m x tile, in the block's scratch
template <typename T>
struct LevelSink {
  T* lv;
  long long t0, tile;
  __device__ void operator()(int level, long long j, T v) { lv[level * tile + (j - t0)] = v; }
};

constexpr int kGramShared = 64 * 1024;  // bytes of the Gram's sub-tile of m levels

template <typename T>
__host__ __device__ inline int gram_sub(int m) {  // rows of a sub-tile, a multiple of 32
  return kGramShared / (m * static_cast<int>(sizeof(T))) / 32 * 32;
}

template <typename T, typename B>
__global__ void __launch_bounds__(kBasisThreads, 2) gram_kernel(BlockArgs<T, B> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cen = reinterpret_cast<T*>(smem);  // m x sub: a sub-tile's rows of each level
  __shared__ double part[kMaxM * (kMaxM + 1) / 2];
  __shared__ double gm[kMaxM * kMaxM];
  __shared__ bool is_last;
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
    replay(out, gm, g.bmat, s, g.tol, g.nearzero, g.maxiter);
    out[kLive] = 1.0;
    *g.ticket = 0u;
  }
}

template <typename T, typename B>
__global__ void __launch_bounds__(kBasisThreads, 2) recover_kernel(BlockArgs<T, B> g) {
  __shared__ T coef[3 * kMaxM];  // xc, d, c
  __shared__ bool is_last;
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
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    g.state[kBlk] = st[kBlk] + 1.0;
    g.state[kLive] = 0.0;
    *g.ticket = 0u;
  }
}

__global__ void replay_kernel(double* st, const double* bmat, int s, double tol, double nearzero,
                              double maxiter) {
  if (threadIdx.x == 0 && blockIdx.x == 0) replay(st, st + kGram, bmat, s, tol, nearzero, maxiter);
}

template <typename T, typename B>
static bool make_block(BlockArgs<T, B>* g, const void* bands, void* const* pr, void* x,
                       void* state, const void* bmat, void* scratch, long long scratch_len,
                       void* ticket, long long n, const long long* offsets, int ndiag, int s,
                       double theta, double delta, const double* shifts, int nshifts,
                       long long tile, int grid) {
  if (!make_basis(&g->a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      tile < 1 || grid < 1)
    return false;
  const long long need = block_scratch(tile, g->a.reach, s, 2 * s + 1);
  if (scratch_len < need * grid) return false;
  for (int t = 0; t < 2; ++t) {
    g->p[t] = static_cast<const T*>(pr[t]);
    g->r[t] = static_cast<const T*>(pr[2 + t]);
    g->p_out[t] = static_cast<T*>(pr[t]);
    g->r_out[t] = static_cast<T*>(pr[2 + t]);
  }
  g->x = static_cast<T*>(x);
  g->state = static_cast<double*>(state);
  g->bmat = static_cast<const double*>(bmat);
  g->scratch = static_cast<T*>(scratch);
  g->per_block = need;
  g->half = basis_scratch(tile, g->a.reach, s) / 2;
  g->ticket = static_cast<unsigned int*>(ticket);
  g->tile = tile;
  return true;
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
  cudaError_t err = cudaFuncSetAttribute(gram_kernel<T, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_kernel<T, B><<<grid, kBasisThreads, shared, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
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
  int cgx_sstep_recover##SUFFIX(const void* bands, void* p0, void* p1, void* r0, void* r1,     \
                                void* x, void* state, void* scratch, long long scratch_len,    \
                                void* ticket, long long n, const long long* offsets,           \
                                int ndiag, int s, double theta, double delta,                  \
                                const double* shifts, int nshifts, long long tile, int grid,   \
                                void* stream) {                                                \
    void* pr[4] = {p0, p1, r0, r1};                                                             \
    return cgx::launch_recover<T, B>(bands, pr, x, state, scratch, scratch_len, ticket, n,     \
                                     offsets, ndiag, s, theta, delta, shifts, nshifts, tile,   \
                                     grid, stream);                                            \
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
