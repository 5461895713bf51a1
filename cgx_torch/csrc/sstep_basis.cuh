// The s-step Krylov basis generator and the coefficient replay, shared by the
// matrix-powers kernel (dia_powers.cu, B9) and the fused s-step block
// (sstep_stream.cu and sstep_recover.cu, B10), as cgx keeps _gen_basis in
// lockstep with _powers_kernel.
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
// R = 3200. Each level of gen_chain is a pass over the slab through device
// memory and L2.
//
// gen_wave keeps the levels on chip instead: a wavefront over the slab. Each
// step, every level advances W rows, each a fixed lag behind the level below
// it (R + W: a level's stencil reaches R rows ahead, and it reads only rows
// the level below finished in an earlier step, so a step needs one barrier).
// A level lives only in a ring in shared memory, long enough for its oldest
// reader: the next level's stencil, Chebyshev's three-term step two levels up,
// and a consumer that reads all 2s+1 levels at one row (the frontier, the
// last lag: the Gram's products, the recover's combinations, B9's stores).
// Level 0 is read from the input vector; a copy of it at the frontier's rows
// rides in a ring of its own. The lags, ring lengths and W are planned on the
// host (cgx_torch.ops.dia_powers.basis_plan), so the CPU tests can walk the
// same schedule.
//
// bfloat16 vectors (T = cgx::bf16, bf16.cuh; the bands in bfloat16 too): each
// product, sum, difference and quotient above is done in float and rounded to
// bfloat16 right after it, in this order, as torch does on the plain version's
// bfloat16 tensors; theta, delta, delta/2 and the shifts round to bfloat16 on
// the host (host_scalar), as the plain version's constants do. The wavefront's
// rings hold bfloat16, half float's bytes; no ring is filled by cp.async (a
// level is formed in registers and stored), so 2-byte values need no copy of
// their own.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
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
  a->theta = host_scalar<T>(theta);
  a->delta = host_scalar<T>(delta);
  a->sigma = host_scalar<T>(delta / 2.0);
  for (int i = 0; i < kMaxS; ++i) a->shifts[i] = host_scalar<T>(i < nshifts ? shifts[i] : 0.0);
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

// ---- the wavefront generator ----

constexpr int kWaveThreads = 512;  // threads of a wavefront block, and W; one block an SM
constexpr int kWaveMaxS = 4;       // s of the wavefront kernels (basis_plan's WAVE_MAX_S)
constexpr int kWaveMaxM = 2 * kWaveMaxS + 1;
constexpr int kWavePlanHead = 4;   // width, lag of the consumer, slab rows, shared bytes

// The schedule of basis_plan, per level in basis order (p-chain, then r-chain).
// At step t level l forms rows [F + t W - lag[l], + W) of its range, where
// F = max(0, t0 - (s-1) R) is where the p-chain's level 1 starts; the
// consumer reads rows [F + t W - lag_use, + W) of the slab.
struct WavePlan {
  long long width;
  long long lag_use;
  long long slab;
  long long lag[kWaveMaxM];
  int ring[kWaveMaxM];      // values of each level's ring
  int ring_off[kWaveMaxM];  // its first value in the shared buffer
};

// The plan array of basis_plan: [width, lag_use, slab, shared bytes, lag[m],
// ring[m], ring_off[m]]. Refused unless W is the block's size, every ring is
// at least a step long, a ring a stencil reads is at least the reach, the
// rings fit the shared bytes without overlapping, and grid slabs cover [0, n).
template <typename T>
inline bool make_wave_plan(WavePlan* pl, const long long* plan, int plan_len, int s, long long n,
                           long long reach, int grid) {
  const int m = 2 * s + 1;
  if (s < 1 || s > kWaveMaxS || plan_len != kWavePlanHead + 3 * m) return false;
  pl->width = plan[0];
  pl->lag_use = plan[1];
  pl->slab = plan[2];
  if (pl->width != kWaveThreads || pl->slab < 1 || grid < 1 || pl->slab * grid < n) return false;
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
  return end * static_cast<long long>(sizeof(T)) <= plan[3];
}

// A level's place in a step: its window's first row, its range [lo, hi) on
// the slab, whether the whole window and its stencil lie inside the range and
// [0, n) (inner: no row needs a bound test), and the ring slots of the
// window's first row: in its own ring, in its source level's ring, in the ring
// two levels below (the three-term step), and of the consumer's window in its
// own ring.
struct WaveSlots {
  long long row, lo, hi;
  int inner, own, src, old, use;
};

__host__ __device__ inline long long pos_mod(long long x, long long q) {
  const long long r = x % q;
  return r < 0 ? r + q : r;
}

__device__ __forceinline__ int wrap(int slot, int q) { return slot >= q ? slot - q : slot; }

// Level l of the basis as its index k in its chain and the chain's width
__host__ __device__ constexpr int chain_k(int l, int s) { return l <= s ? l : l - s - 1; }
__host__ __device__ constexpr int chain_width(int l, int s) { return l <= s ? s + 1 : s; }

// band_row with x held in a ring of q values whose slot base holds row i
template <typename T, typename B>
__device__ __forceinline__ T ring_band_row(const Basis<T, B>& a, const T* ring, int q, int base,
                                           long long i) {
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d < a.o.ndiag) {
      const long long j = i + a.o.off[d];
      if (j >= 0 && j < a.n) {
        int slot = base + static_cast<int>(a.o.off[d]);
        slot = slot < 0 ? slot + q : (slot >= q ? slot - q : slot);
        acc += widen(a.bands[d * a.n + i]) * ring[slot];
      }
    }
  }
  return acc;
}

// Level l's place at step 0 of the slab [t0, t1) (from f0, the p-chain's
// level 1's first row), or at the step after sl (advance); one thread a level.
__device__ __forceinline__ WaveSlots wave_slots(const WavePlan& pl, int l, int s, long long reach,
                                                long long n, long long t0, long long t1,
                                                long long f0, bool advance, WaveSlots sl) {
  const int k = chain_k(l, s);
  const int q = pl.ring[l];
  const int qs = k >= 2 ? pl.ring[l - 1] : 1;
  const int qo = k >= 3 ? pl.ring[l - 2] : 1;
  const int w = static_cast<int>(pl.width);
  if (advance) {
    sl.row += w;
    sl.own = wrap(sl.own + w, q);
    sl.src = k >= 2 ? wrap(sl.src + w, qs) : 0;
    sl.old = k >= 3 ? wrap(sl.old + w, qo) : 0;
    sl.use = wrap(sl.use + w, q);
  } else {
    // level k is needed (width - 1 - k) R rows past the slab; the copy of level 0 on it only
    const long long grow =
        k == 0 ? 0 : static_cast<long long>(chain_width(l, s) - 1 - k) * reach;
    sl.row = f0 - pl.lag[l];
    sl.lo = t0 - grow > 0 ? t0 - grow : 0;
    sl.hi = t1 + grow < n ? t1 + grow : n;
    sl.own = static_cast<int>(pos_mod(sl.row, q));
    sl.src = static_cast<int>(pos_mod(sl.row, qs));
    sl.old = static_cast<int>(pos_mod(sl.row, qo));
    sl.use = static_cast<int>(pos_mod(f0 - pl.lag_use, q));
  }
  sl.inner = sl.row >= sl.lo && sl.row + w <= sl.hi && sl.row - reach >= 0 &&
             sl.row + w + reach <= n;
  return sl;
}

// Diagonals of a kernel built for ND of them (ND = 0: any number, read at run
// time). ND = 5 is built for the 5-point stencils with their offsets sorted
// and centred, off[0] < off[1] < off[2] = 0 < off[3] < off[4] (wave_dispatch
// sends other offsets to ND = 0): a tap then wraps round its ring on one side
// only, and the centre tap is the level's own value.
template <int ND>
struct Diags {
  static constexpr int n = ND ? ND : kMaxDiags;
};

// The global values of a full window's row, loaded up front: the chain's
// level 0 at the row's taps (level 1: x, whose tap at offset 0 is x0) and at
// the row (level 2's three-term step).
template <int ND, typename T>
struct Taps {
  T x[Diags<ND>::n];
  T x0, to;
};

// Level l's value (k = its index in its chain, k >= 1) at window position jj
// of a full window (inner: every row and tap in range, no test), from the band
// values bw at the row and, for k = 1 and 2, the loaded taps of level 0.
template <int S, int ND, typename T, typename B>
__device__ __forceinline__ T level_full(const Basis<T, B>& a, const WavePlan& pl,
                                        const WaveSlots& sl, const T* ring, const Taps<ND, T>& tp,
                                        int l, int jj, const T (&bw)[Diags<ND>::n]) {
  const int k = chain_k(l, S);
  T mv = T(0), tc, to = T(0);
  if (k == 1) {
#pragma unroll
    for (int d = 0; d < Diags<ND>::n; ++d)
      if (ND || d < a.o.ndiag) mv += bw[d] * tp.x[d];
    tc = tp.x0;
  } else {
    const int qs = pl.ring[l - 1];
    const T* src = ring + pl.ring_off[l - 1];
    const int base = wrap(sl.src + jj, qs);
    tc = src[base];
#pragma unroll
    for (int d = 0; d < Diags<ND>::n; ++d) {
      if (ND || d < a.o.ndiag) {
        int slot = base + static_cast<int>(a.o.off[d]);
        if (ND != 5 || d < 2) slot = slot < 0 ? slot + qs : slot;
        if (ND != 5 || d > 2) slot = slot >= qs ? slot - qs : slot;
        mv += bw[d] * (ND == 5 && d == 2 ? tc : src[slot]);  // ND = 5: the centre is tc
      }
    }
  }
  if (!a.newton && k >= 2)
    to = k == 2 ? tp.to : ring[pl.ring_off[l - 2] + wrap(sl.old + jj, pl.ring[l - 2])];
  return next_level(a, k, mv, tc, to);
}

// A value of a level at one row, or ok = false where the row is outside the
// level's range
template <typename T>
struct Formed {
  T v;
  bool ok;
};

// Level l's value at window position jj of a window that is not full: the
// row and each tap tested as band_row does, so the sums are the same as a
// full window's. Kept out of line, away from the steps' hot path.
template <int S, typename T, typename B>
__device__ __noinline__ Formed<T> level_edge(const Basis<T, B>& a, const WavePlan& pl,
                                             WaveSlots sl, const T* ring, const T* v0, int l,
                                             int jj) {
  const long long row = sl.row + jj;
  if (row < sl.lo || row >= sl.hi) return {T(0), false};
  const int k = chain_k(l, S);
  if (k == 0) return {v0[row], true};
  T mv, tc, to = T(0);
  if (k == 1) {
    mv = band_row(a, v0, 0, row);
    tc = v0[row];
  } else {
    const int qs = pl.ring[l - 1];
    const T* src = ring + pl.ring_off[l - 1];
    const int base = wrap(sl.src + jj, qs);
    mv = ring_band_row(a, src, qs, base, row);
    tc = src[base];
  }
  if (!a.newton && k >= 2)
    to = k == 2 ? v0[row] : ring[pl.ring_off[l - 2] + wrap(sl.old + jj, pl.ring[l - 2])];
  return {next_level(a, k, mv, tc, to), true};
}

// A gen_wave consumer's hook besides its call at the frontier, a no-op unless
// the consumer defines its own: load(first) issues the consumer's own loads
// from device memory for the frontier's window [first, first + W) among the
// step's others, before the call.
struct WaveUse {
  __device__ __forceinline__ void load(long long) {}
};

// All 2s+1 levels (s = S) over the slab [t0, t1) by the wavefront of pl, in
// the ring buffer of the block's shared memory; slots is a shared
// [2][kWaveMaxM] table. W is the block's size: thread jj forms row jj of
// every level's window. The p-chain's level v+1 and the r-chain's level v lag
// alike, so they share the step's band values: s windows of bands a step, for
// 2s - 1 levels. A step issues all of its loads from device memory first (the
// consumer's load hook among them), then calls use(first row, slots) while
// they are in flight, then forms and stores its levels. Full windows (inner)
// take a path with no tests; the few others, at the slab's and the vector's
// ends, take level_edge. A step whose windows are all full (three in four at
// N = 10,240,000; the and-reduction of the step's barrier says so) runs a copy
// of the step with no test and no branch a level, which the compiler schedules
// as one block: on the H100 it took the recover from 1.00 to 0.72 ms with
// bf16 bands. The consumer
// may read, at its window's rows, every level formed in an earlier step
// (wave_at), and nothing else of the rings. Every thread of the block calls
// it; each step ends with the one barrier. ND (0: any) is the number of
// diagonals the kernel is built for. Each value is formed by band_row's and
// next_level's operations, so with -fmad=false the levels are gen_chain's bit
// for bit.
template <int S, int ND, typename T, typename B, typename Use>
__device__ __forceinline__ void gen_wave(const Basis<T, B>& a, const WavePlan& pl,
                                         const T* __restrict__ p0, const T* __restrict__ r0,
                                         T* ring, long long t0, long long t1,
                                         WaveSlots (*slots)[kWaveMaxM], Use& use) {
  constexpr int M = 2 * S + 1;
  const int w = static_cast<int>(pl.width);
  const long long n = a.n;
  const long long f0 = t0 - (S - 1) * a.reach > 0 ? t0 - (S - 1) * a.reach : 0;
  const long long steps = (t1 - f0 + pl.lag_use + w - 1) / w;
  const int jj = threadIdx.x;
  WaveSlots next;
  bool inner = true;
  if (threadIdx.x < M) {
    next = wave_slots(pl, threadIdx.x, S, a.reach, n, t0, t1, f0, false, {});
    slots[0][threadIdx.x] = next;
    inner = next.inner;
  }
  // Whether every level's window of the step is full: then the step takes a
  // path with no test a level (the uniform one of most steps)
  bool full = __syncthreads_and(inner);
  for (long long t = 0; t < steps; ++t) {
    const WaveSlots* sl = slots[t & 1];
    const auto step = [&](auto all_full) {
      constexpr bool kFull = decltype(all_full)::value;
      // 1. the loads from device memory of the full windows: the copies of
      // level 0, the bands of the s windows, level 0's taps for level 1 and 2
      T copy[2], bw[S][Diags<ND>::n];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int l = c ? S + 1 : 0;
        if (kFull || sl[l].inner) copy[c] = (c ? r0 : p0)[sl[l].row + jj];
      }
#pragma unroll
      for (int v = 0; v < S; ++v) {  // window v: the p-chain's level v+1, the r-chain's level v
        if (kFull || sl[v + 1].inner) {
          const B* bp = a.bands + sl[v + 1].row + jj;
#pragma unroll
          for (int d = 0; d < Diags<ND>::n; ++d)
            bw[v][d] = (ND || d < a.o.ndiag) ? widen(bp[d * n]) : T(0);
        }
      }
      Taps<ND, T> tp[2];  // the p-chain's, the r-chain's
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int l1 = c ? S + 2 : 1;  // the chain's level 1 (in window c) and level 2
        const int top = c ? 2 * S : S;
        const T* v0 = c ? r0 : p0;
        if (l1 <= top && (kFull || sl[l1].inner)) {
          const T* x = v0 + sl[l1].row + jj;
#pragma unroll
          for (int d = 0; d < Diags<ND>::n; ++d)
            tp[c].x[d] = (ND || d < a.o.ndiag) ? x[a.o.off[d]] : T(0);
          tp[c].x0 = ND == 5 ? tp[c].x[2] : x[0];
        }
        if (l1 + 1 <= top && (kFull || sl[l1 + 1].inner)) tp[c].to = v0[sl[l1 + 1].row + jj];
      }
      const long long first = f0 + t * w - pl.lag_use;
      use.load(first);
      // 2. the consumer, on rows formed in earlier steps, while the loads fly
      use(first, sl);
      // 3. this step's levels, stored
#pragma unroll
      for (int l = 0; l < M; ++l) {
        const int k = chain_k(l, S);
        T val;
        bool ok = true;
        if (kFull || sl[l].inner) {
          if (k == 0)
            val = copy[l ? 1 : 0];
          else
            val = level_full<S, ND>(a, pl, sl[l], ring, tp[l <= S ? 0 : 1], l, jj,
                                    bw[l <= S ? k - 1 : k]);
        } else {
          const Formed<T> e = level_edge<S>(a, pl, sl[l], ring, l <= S ? p0 : r0, l, jj);
          val = e.v;
          ok = e.ok;
        }
        if (ok) ring[pl.ring_off[l] + wrap(sl[l].own + jj, pl.ring[l])] = val;
      }
    };
    if (full)
      step(std::true_type{});
    else
      step(std::false_type{});
    if (threadIdx.x < M) {
      next = wave_slots(pl, threadIdx.x, S, a.reach, n, t0, t1, f0, true, sl[threadIdx.x]);
      slots[(t + 1) & 1][threadIdx.x] = next;
      inner = next.inner;
    }
    full = __syncthreads_and(inner);  // this step's levels are formed, the next step's slots set
  }
}

// Level l at position jj of the consumer's window (see gen_wave)
template <typename T>
__device__ __forceinline__ T wave_at(const WavePlan& pl, const T* ring, const WaveSlots* sl, int l,
                                     int jj) {
  return ring[pl.ring_off[l] + wrap(sl[l].use + jj, pl.ring[l])];
}

// f(S, ND) with S = s and ND the diagonals a wavefront kernel is built for,
// both std::integral_constant: 5 (the 5-point stencils with sorted, centred
// offsets, see Diags) or 0 (any number, read at run time).
template <typename F>
int wave_dispatch(int s, const long long* offsets, int ndiag, F&& f) {
  using std::integral_constant;
  const auto in_s = [&](auto nd) {
    switch (s) {
      case 1:
        return f(integral_constant<int, 1>{}, nd);
      case 2:
        return f(integral_constant<int, 2>{}, nd);
      case 3:
        return f(integral_constant<int, 3>{}, nd);
      default:
        return f(integral_constant<int, 4>{}, nd);
    }
  };
  const bool centred = ndiag == 5 && offsets[0] < offsets[1] && offsets[1] < 0 &&
                       offsets[2] == 0 && 0 < offsets[3] && offsets[3] < offsets[4];
  return centred ? in_s(integral_constant<int, 5>{}) : in_s(integral_constant<int, 0>{});
}

// Launches wave kernel K on the stream with the plan's shared bytes, after
// letting K take them; the launch's error
template <auto K, typename... Args>
int wave_launch(int grid, long long shared, void* stream, const Args&... args) {
  const cudaError_t allowed = allow_shared<K>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  K<<<grid, kWaveThreads, static_cast<size_t>(shared), static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx
