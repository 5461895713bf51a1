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
// Gram launch, two designs; cgx_torch.ops.sstep_stream.gram_plan picks one
// by a size rule and records it. Both add the m(m+1)/2 products of each row's
// levels to a block's partial Gram in float64: a product of two floats is
// exact in double, so only the sums round (cgx accumulated in double-float32
// with two_sum, sstep_stream.py:212-239; double is the Hopper equivalent and
// more).
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
// card's rate. The slab designs move several times that: the bands once an
// application, each working level out and back, the slab's levels once more.
// The wavefront reads the bands once an application too, but from L2 (a
// block's window of them is the lags' few thousand rows), and p and r twice.
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
struct GramRows {
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

// One block an SM (the grid of gram_plan); 512 threads of at most 128
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
static void block_pointers(BlockArgs<T, B>* g, void* const* pr, void* x, void* state,
                           const void* bmat, void* ticket) {
  for (int t = 0; t < 2; ++t) {
    g->p[t] = static_cast<const T*>(pr[t]);
    g->r[t] = static_cast<const T*>(pr[2 + t]);
    g->p_out[t] = static_cast<T*>(pr[t]);
    g->r_out[t] = static_cast<T*>(pr[2 + t]);
  }
  g->x = static_cast<T*>(x);
  g->state = static_cast<double*>(state);
  g->bmat = static_cast<const double*>(bmat);
  g->ticket = static_cast<unsigned int*>(ticket);
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
  block_pointers(g, pr, x, state, bmat, ticket);
  g->scratch = static_cast<T*>(scratch);
  g->per_block = need;
  g->half = basis_scratch(tile, g->a.reach, s) / 2;
  g->tile = tile;
  return true;
}

// The plan array of gram_plan: [width, lag_use, slab, shared bytes, lag[m],
// ring[m], ring_off[m]]. Refused unless W is the block's size, every ring is
// at least a step long, a ring a stencil reads is at least the reach, the
// rings fit the shared bytes without overlapping, and grid slabs cover [0, n).
template <typename T>
static bool make_wave_plan(WavePlan* pl, const long long* plan, int plan_len, int s,
                           long long n, long long reach, int grid) {
  const int m = 2 * s + 1;
  if (s < 1 || s > kWaveMaxS || plan_len != kWavePlanHead + 3 * m) return false;
  pl->width = plan[0];
  pl->lag_use = plan[1];
  pl->slab = plan[2];
  const long long shared = plan[3];
  if (pl->width != kWaveThreads || pl->slab < 1 || grid < 1 || pl->slab * grid < n)
    return false;
  const int npairs = m * (m + 1) / 2;
  if (shared < static_cast<long long>(kWaveThreads / 32) * npairs * 8 ||
      shared < static_cast<long long>(m) * m * 8)
    return false;  // the block's reduction and G reuse the rings' memory
  long long end = 0;
  for (int l = 0; l < m; ++l) {
    const long long q = plan[kWavePlanHead + m + l], off = plan[kWavePlanHead + 2 * m + l];
    const bool feeds = l != s && l != 2 * s && l != s + 1 && l != 0;  // not a top, not a copy
    if (q < pl->width || (feeds && q < reach) || off < end || q > (1LL << 30)) return false;
    end = off + q;
    pl->lag[l] = plan[kWavePlanHead + l];
    pl->ring[l] = static_cast<int>(q);
    pl->ring_off[l] = static_cast<int>(off);
  }
  return end * static_cast<long long>(sizeof(T)) <= shared;
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
  if (!make_basis(&g.a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      !make_wave_plan<T>(&pl, plan, plan_len, s, n, g.a.reach, grid) ||
      partials_len < static_cast<long long>(grid) * m * (m + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  block_pointers(&g, pr, nullptr, state, bmat, ticket);
  g.partials = static_cast<double*>(partials);
  g.tol = tol;
  g.nearzero = nearzero;
  g.maxiter = maxiter;
  const int shared = static_cast<int>(plan[3]);
  const auto run = [&](auto kernel, cudaError_t allowed) {
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    kernel<<<grid, kWaveThreads, shared, static_cast<cudaStream_t>(stream)>>>(g, pl);
    return static_cast<int>(cudaGetLastError());
  };
  if (ndiag == 5) {  // the 5-point stencils: their diagonals known when compiled
    switch (s) {
      case 1:
        return run(gram_wave_kernel<T, B, 1, 5>, allow_shared<gram_wave_kernel<T, B, 1, 5>>());
      case 2:
        return run(gram_wave_kernel<T, B, 2, 5>, allow_shared<gram_wave_kernel<T, B, 2, 5>>());
      case 3:
        return run(gram_wave_kernel<T, B, 3, 5>, allow_shared<gram_wave_kernel<T, B, 3, 5>>());
      default:
        return run(gram_wave_kernel<T, B, 4, 5>, allow_shared<gram_wave_kernel<T, B, 4, 5>>());
    }
  }
  switch (s) {
    case 1:
      return run(gram_wave_kernel<T, B, 1, 0>, allow_shared<gram_wave_kernel<T, B, 1, 0>>());
    case 2:
      return run(gram_wave_kernel<T, B, 2, 0>, allow_shared<gram_wave_kernel<T, B, 2, 0>>());
    case 3:
      return run(gram_wave_kernel<T, B, 3, 0>, allow_shared<gram_wave_kernel<T, B, 3, 0>>());
    default:
      return run(gram_wave_kernel<T, B, 4, 0>, allow_shared<gram_wave_kernel<T, B, 4, 0>>());
  }
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
