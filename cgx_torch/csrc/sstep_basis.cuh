// The s-step Krylov basis generator and the coefficient replay, shared by the
// matrix-powers kernel (dia_powers.cu, B9) and the fused s-step block
// (sstep_stream.cu, B10), as cgx keeps _gen_basis in lockstep with
// _powers_kernel.
//
// The basis of a block of s iterations is 2s+1 vectors of length n:
//   V[0..s]     = T_0(A)p .. T_s(A)p       (the p-chain, width s+1)
//   V[s+1..2s]  = T_0(A)r .. T_{s-1}(A)r   (the r-chain, width s)
// Chebyshev on (theta, delta):  T_1 = (A v - theta v) / delta,
//   T_i = 2 (A T_{i-1} - theta T_{i-1}) / delta - T_{i-2};
// scaled Newton with shifts:    N_i = (A N_{i-1} - shift_{i-1} N_{i-1}) / sigma,
// sigma = delta / 2. Each value is formed by exactly these operations, in this
// order, and the banded product sums its terms in offset order, as
// cgx_torch.solver.sstep.basis_columns_fn does over the plain mat-vec: with
// -fmad=false a level equals the plain one bit for bit.
//
// A thread block owns a tile [t0, t1) of rows: one contiguous slab of about
// n / grid rows, so that the halo is a small share of it. Level i of a chain
// of width w is needed on the tile widened by (w-1-i) R rows on each side, R
// the largest |offset|: each application of A needs R more rows of the level
// below. Levels outside [0, n) are never read (the banded row skips them). The
// two working levels of a chain live in a block-private scratch in device
// memory (two buffers of tile + 2 (w-2) R values; level i overwrites level
// i-2 at the same row, which only the same thread reads); level 0 is read from
// the input vector itself. Only the tile's rows of each level leave the
// generator, through a sink: B9 writes them out, the Gram and recover kernels
// keep them in the block's scratch for a last pass over the tile. The halo is
// computed redundantly by neighbouring blocks: (7 tile + 18 R) / (7 tile) row
// evaluations a row for s = 4, 1.2 at N = 10,240,000 over 264 blocks with
// R = 3200. Each level is a pass over the slab through device memory and L2;
// keeping the levels on chip (a wavefront over the slab, clusters and
// distributed shared memory, or TMA) is the next kernel's work.
#pragma once

#include <cuda_bf16.h>

#include "dia_row.cuh"

namespace cgx {

constexpr int kMaxS = 16;  // s of the kernels (cgx_torch.ops.sstep_stream.MAX_S)
// Threads of a basis kernel's block. A block walks its slab alone, so its
// warps are what hides the latency of the level passes: two blocks of 512 an
// SM (the grid of cgx_torch.ops.dia_powers.BLOCKS_PER_SM), which
// __launch_bounds__(kBasisThreads, 2) caps at 64 registers a thread.
constexpr int kBasisThreads = 512;
constexpr int kMaxM = 2 * kMaxS + 1;

// The packed float64 state of cgx_torch.ops.sstep_stream (header, then the
// coefficients [xc, d, c] at stride m, then the Gram matrix, row-major m x m).
enum State { kK = 0, kRsold, kRsnew, kConv, kBrk, kBlk, kLive, kHeader = 8 };
constexpr int kCoef = kHeader;
constexpr int kGram = kCoef + 3 * kMaxM;
constexpr int kStateLen = kGram + kMaxM * kMaxM;

template <typename T, typename B>
struct Basis {
  const B* bands;  // (ndiag, n)
  long long n;
  long long reach;  // max |offset|
  Offsets o;
  int s;
  int newton;
  T theta, delta, sigma;
  T shifts[kMaxS];
};

template <typename T, typename B>
__host__ bool make_basis(Basis<T, B>* a, const void* bands, long long n, const long long* offsets,
                         int ndiag, int s, double theta, double delta, const double* shifts,
                         int nshifts) {
  if (n < 1 || s < 1 || s > kMaxS || !make_offsets(offsets, ndiag, &a->o)) return false;
  if (nshifts != 0 && nshifts < s) return false;
  a->bands = static_cast<const B*>(bands);
  a->n = n;
  a->reach = 0;
  for (int d = 0; d < ndiag; ++d) {
    const long long r = offsets[d] < 0 ? -offsets[d] : offsets[d];
    if (r > a->reach) a->reach = r;
  }
  a->s = s;
  a->newton = nshifts != 0;
  a->theta = static_cast<T>(theta);
  a->delta = static_cast<T>(delta);
  a->sigma = static_cast<T>(delta / 2.0);
  for (int i = 0; i < kMaxS; ++i) a->shifts[i] = static_cast<T>(i < nshifts ? shifts[i] : 0.0);
  return true;
}

// Scratch values a block needs: two buffers of the widest working level, and
// with keep = 2s + 1 the tile's rows of every level after them.
inline long long basis_scratch(long long tile, long long reach, int s) {
  return 2 * (tile + 2 * (s > 1 ? s - 1 : 0) * reach);
}
inline long long block_scratch(long long tile, long long reach, int s, int keep) {
  return basis_scratch(tile, reach, s) + keep * tile;
}

// Row i of the banded product with the vector x held from index xb on:
// x[j - xb] is the value at row j. dia_row's order and skips.
template <typename T, typename B>
__device__ __forceinline__ T band_row(const Basis<T, B>& a, const T* x, long long xb, long long i) {
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d < a.o.ndiag) {
      const long long j = i + a.o.off[d];
      if (j >= 0 && j < a.n) acc += widen(a.bands[d * a.n + i]) * x[j - xb];
    }
  }
  return acc;
}

// Level i's value at a row from A times level i-1 there (mv), level i-1 (tc)
// and level i-2 (to, which only Chebyshev's three-term step reads).
template <typename T, typename B>
__device__ __forceinline__ T next_level(const Basis<T, B>& a, int i, T mv, T tc, T to) {
  if (a.newton) return (mv - a.shifts[i - 1] * tc) / a.sigma;
  if (i == 1) return (mv - a.theta * tc) / a.delta;
  return T(2) * (mv - a.theta * tc) / a.delta - to;
}

// Levels 0..width-1 of the chain on v0 over the tile [t0, t1): sink(base + i,
// j, value) for each tile row j of level i, by the thread that formed it. buf
// holds basis_scratch(...) / 2 values twice. Every thread of the block calls it;
// it ends with a barrier, and a level's sink calls finish before the next
// level's start. A thread takes two rows an iteration and issues both rows'
// loads before either store: the passes are bound by load latency.
template <typename T, typename B, typename Sink>
__device__ void gen_chain(const Basis<T, B>& a, const T* __restrict__ v0, int width, int base,
                          long long t0, long long t1, T* buf0, T* buf1, Sink& sink) {
  for (long long j = t0 + threadIdx.x; j < t1; j += blockDim.x) sink(base, j, v0[j]);
  const long long wb = t0 - static_cast<long long>(width > 2 ? width - 2 : 0) * a.reach;
  const long long step = blockDim.x;
  for (int i = 1; i < width; ++i) {
    __syncthreads();  // level i-1 is complete, in the scratch and in the sink
    const long long grow = static_cast<long long>(width - 1 - i) * a.reach;
    const long long lo = t0 - grow > 0 ? t0 - grow : 0;
    const long long hi = t1 + grow < a.n ? t1 + grow : a.n;
    T* out = (i & 1) ? buf0 : buf1;
    const T* cur = i == 1 ? v0 : ((i & 1) ? buf1 : buf0);  // level i-1
    const long long cb = i == 1 ? 0 : wb;
    const T* old = i == 2 ? v0 : out;  // level i-2, at the row's own index
    const long long ob = i == 2 ? 0 : wb;
    const bool three = !a.newton && i >= 2;
    for (long long j = lo + threadIdx.x; j < hi; j += 2 * step) {
      const long long j2 = j + step;
      const bool pair = j2 < hi;
      const T mv = band_row(a, cur, cb, j), tc = cur[j - cb];
      const T to = three ? old[j - ob] : T(0);
      T mv2 = T(0), tc2 = T(0), to2 = T(0);
      if (pair) {
        mv2 = band_row(a, cur, cb, j2);
        tc2 = cur[j2 - cb];
        to2 = three ? old[j2 - ob] : T(0);
      }
      const T v = next_level(a, i, mv, tc, to);
      out[j - wb] = v;
      if (j >= t0 && j < t1) sink(base + i, j, v);
      if (pair) {
        const T v2 = next_level(a, i, mv2, tc2, to2);
        out[j2 - wb] = v2;
        if (j2 >= t0 && j2 < t1) sink(base + i, j2, v2);
      }
    }
  }
  __syncthreads();
}

// max that propagates a NaN from either side, as torch.maximum does
__device__ __forceinline__ double nan_max(double a, double b) { return (a != a || a > b) ? a : b; }

__device__ __forceinline__ double qform(const double* x, const double* g, const double* y, int m) {
  double acc = 0.0;
  for (int i = 0; i < m; ++i) {
    double gi = 0.0;
    for (int j = 0; j < m; ++j) gi += g[i * m + j] * y[j];
    acc += x[i] * gi;
  }
  return acc;
}

// cgx's replay_block in float64 (cgx_torch.solver.sstep.replay_block with a
// float64 Gram): s reference-recurrence iterations in coefficient space from
// the Gram matrix g (m x m) and the operator matrix bmat, with its break and
// freeze semantics; reads and rewrites the header of st and writes [xc, d, c]
// to st[kCoef..]. One thread.
__device__ void replay(double* st, const double* g, const double* bmat, int s, double tol,
                       double nearzero, double maxiter) {
  const int m = 2 * s + 1;
  double c[kMaxM], d[kMaxM], xc[kMaxM], bc[kMaxM], dn[kMaxM];
  for (int i = 0; i < m; ++i) {
    c[i] = i == 0 ? 1.0 : 0.0;
    d[i] = i == s + 1 ? 1.0 : 0.0;
    xc[i] = 0.0;
  }
  double k = st[kK], rsnew = st[kRsnew];
  bool conv = st[kConv] != 0.0, brk = st[kBrk] != 0.0;
  double rs = qform(d, g, d, m);
  for (int it = 0; it < s; ++it) {
    const bool live = !conv && !brk && k < maxiter;
    for (int i = 0; i < m; ++i) {
      double acc = 0.0;
      for (int j = 0; j < m; ++j) acc += bmat[i * m + j] * c[j];
      bc[i] = acc;  // A p_j in basis coordinates
    }
    const double conj = qform(c, g, bc, m);
    const bool bad = live && conj <= 0.0;
    brk = brk || bad;
    const bool active = live && !bad;
    const double alpha = rs / nan_max(conj, rs * nearzero);
    for (int i = 0; i < m; ++i) dn[i] = d[i] - alpha * bc[i];
    const double rr = qform(dn, g, dn, m);
    const bool conv_now = sqrt(rr) < tol;
    const bool adv = active && !conv_now;
    const double beta = rr / rs;
    if (active) {
      for (int i = 0; i < m; ++i) {
        xc[i] = xc[i] + alpha * c[i];
        d[i] = dn[i];
      }
      rsnew = rr;
    }
    if (adv) {
      for (int i = 0; i < m; ++i) c[i] = dn[i] + beta * c[i];
      rs = rr;
      k += 1.0;
    }
    conv = conv || (active && conv_now);
  }
  for (int i = 0; i < m; ++i) {
    st[kCoef + i] = xc[i];
    st[kCoef + m + i] = d[i];
    st[kCoef + 2 * m + i] = c[i];
  }
  st[kK] = k;
  st[kRsold] = rs;
  st[kRsnew] = rsnew;
  st[kConv] = conv ? 1.0 : 0.0;
  st[kBrk] = brk ? 1.0 : 0.0;
}

}  // namespace cgx
