// Streaming Chronopoulos-Gear CG for Hopper (sm_90a): an iteration per launch,
// for banded operators whose state is too large to keep on chip.
//
// Replaces the Pallas TPU kernels of cgx/ops/cg_stream.py:
//   _stream_iteration          (_iter_kernel,         pallas_call at cg_stream.py:404)
//   _stream_iteration_stacked  (_iter_kernel_stacked, pallas_call at cg_stream.py:930)
//   _stream_iteration_pcg      (_iter_kernel_pcg,     pallas_call at cg_stream.py:1203)
// The first two differ only in where r, w and s lie in device memory (three
// arrays, or one (3, rows, cols) array for fewer DMA streams). A CUDA thread
// loads by address, so one kernel serves both: the wrapper passes the six
// pointers of the split buffers or of the slices of the stacked one.
//
// An iteration, from the scalars that the iteration before left (the arithmetic
// of cgx_torch.solver.pipelined with float64 dots):
//   beta  = 0 (k = 0) or gamma / gamma_old
//   alpha = gamma / max(delta - beta gamma / alpha_old, gamma NEARZERO)  (delta at k = 0)
//   s' = w + beta s ; r' = r - alpha s' ; p' = u + beta p ; x' = x + alpha p'
//   plain:   u' = r',                          w' = A r'
//   precond: u' = 2 D^-1 r' - D^-1 A D^-1 r',  w' = A u'
//   gamma' = <r', u'>, delta' = <w', u'> (and rr' = <r', r'>)
// with u == r without the preconditioner, so p' = r + beta p there.
//
// The preconditioned iteration applies the bands twice: c' = D^-1 r', then
// u' = 2 c' - D^-1 A c', then w' = A u'. Each application needs the level
// below at its neighbours, R = max |offset| rows away. Two designs, picked on
// the host by cgx_torch.ops.cg_stream.pcg_plan:
// - "wavefront" (pcg_wave_kernel), one launch an iteration, where its rings
//   fit one block's shared memory (float32 and float64 at R = 3200). One block
//   an SM walks one contiguous slab in steps of W = 512 rows, three levels
//   at once, each a fixed lag behind the one below (the scheme of gen_wave,
//   sstep_basis.cuh): L0 at the frontier forms s', r', p', x' and c' and
//   writes the updates; L1, R + W behind, forms u' from a ring of c' and
//   writes it; L2, R + W behind L1, forms w' from a ring of u' and writes it.
//   c' and u' never leave the chip. Rows outside the slab are the halo: L0
//   runs 2R rows past each end and L1 R rows, recomputed from r, w, s and the
//   bands only, which no block of the launch writes (the read halves of the
//   pairs); p, x and u are touched at the slab's own rows only, u read at L0
//   before L1 rewrites it later in the same block's walk. It moves
//   (ndiag + 12) N words and the halo: 4R rows of r, w, s and the diagonal and
//   2R rows of the bands a slab, 43.9 MB at N = 10,240,000 over 132 slabs in
//   float32 (L2 re-reads the bands R + W rows after L1, from the L2 cache).
// - "three" (cg_stream_kernel, three modes), where the rings do not fit: the
//   updates and c'; then u'; then w' and the dots, since only a launch
//   boundary publishes a level to the neighbouring blocks. c' and u' go out
//   and back through device memory and the bands are read twice: (2 ndiag +
//   17) N words. In one launch without rings each row would re-form u' at its
//   neighbours and c' at theirs (about 130 loads and 25 divisions a row); on
//   an H100 at N = 10,240,000 one, two and three launches took 0.94, 0.72 and
//   0.60 ms an iteration (PERF.md).
//
// What differs from the TPU's sequential grid, and how:
// - Halo reads of vectors rewritten in the same pass. cgx aliases r, w and s in
//   place and orders its DMAs so that block j+1's halo read lands before block j
//   writes. CUDA blocks run at once, so r, w and s are ping-pong pairs: a launch
//   reads set k % 2 and writes the other. The parity comes from the device's k,
//   which a frozen launch does not advance, so the current set stays current
//   however many frozen launches the host queues. p, x and u are read and written
//   at their own index only and stay in place.
// - The halo window. The TPU recomputes r' over a window of rows + 2 m_rows (and
//   u' over a 2 p_rows margin). Here r'[j] = r[j] - alpha (w[j] + beta s[j]) is
//   formed again at each neighbour j from the old r, w and s; with -fmad=false
//   the value is bit for bit the one its own thread writes. The neighbours of a
//   block's rows are rows of the blocks beside it, read while those blocks run,
//   so L1 and L2 serve the re-reads and device memory sees each vector about
//   once. The preconditioned wavefront recomputes its halo the same way.
// - Dots. Each block owns a contiguous range of rows, sums its products in
//   double in thread order and by a shuffle tree (common.cuh), and writes one
//   partial per dot; the last block to take the ticket sums all partials in
//   index order. No float atomics; the order is fixed by the launch shape.
// - Scalars. cgx computes alpha and beta in float32 on the host between launches.
//   Here [gamma, delta, rr, gamma_old, alpha_old, k, stop, breakdown] stay in
//   double on the device, and every block derives alpha and beta from them. The
//   last block rewrites them in place: it takes the ticket after every other
//   block has taken it, and a block takes it only after reading the scalars, so
//   no block can still read the old values when they change.
// - Stopping. A launch that starts with stop set (sqrt(gamma) >= tol fails, or
//   gamma is not > 0; rr in place of gamma with the preconditioner) or with
//   k >= maxiter returns at once in every block: no vector, ring, scalar or
//   ticket changes. The host reads the scalars once per 32 iterations.
// - Bounds. Terms outside [0, n) are zero (dia_row.cuh), so no padding rows and
//   no identity rows are needed, and no tail diagonal entry is ever divided by.
//
// bfloat16 vectors (the _bf16 entries, bands in bfloat16 too): s', r', p', x', c',
// u' and w' are formed in float and rounded to bfloat16 after each operation, in
// the plain version's order (bf16.cuh), where cgx's kernel keeps them in the
// vectors' dtype (cg_stream.py:296-330); a dot's products are exact in double,
// as for float (bf16.cuh). The wavefront's rings hold
// bfloat16, half the float bytes, so its plan fits wherever float's does.
//
// Band storage under float vectors: bfloat16 (the _f32_bf16b entries, "auto"'s
// pick where it is exact) or, for the plain iteration only, float16 (the
// _f32_f16b entry, cgx's explicit bands_dtype=float16), each value widened
// exactly on load (dia_row.cuh).
//
// Bound: memory. The recurrence must move, per iteration, the bands once, p, x,
// r, w, s in and out: (ndiag + 10) N words (ndiag/2 + 10 with bfloat16 bands
// under float vectors); with the preconditioner u as well, (ndiag + 12) N. On
// bfloat16 vectors the words are 2 bytes. The
// neighbour re-reads of the plain iteration cost load instructions and cache
// bandwidth, not device memory traffic, so long as a block's halo stays in
// cache.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "dia_row.cuh"

namespace cgx {

// The scalar block, float64, read and rewritten in place by each active launch.
enum Scalar { kGamma = 0, kDelta, kRr, kGammaOld, kAlphaOld, kK, kStop, kBreakdown, kScalars };

template <typename T, typename B>
struct StreamArgs {
  const B* bands;  // (ndiag, n)
  T* p;            // in place
  T* x;            // in place
  T* u;            // preconditioner only, in place
  T* c;            // preconditioner only: D^-1 r', between the first two launches
  T* r[2];         // ping-pong pairs: read [k % 2], write [1 - k % 2]
  T* w[2];
  T* s[2];
  double* partials;  // 3 * gridDim.x: gamma, delta, rr
  unsigned int* ticket;
  double* scal;      // kScalars entries
  long long n;
  long long rows;    // rows per block
  Offsets o;
  int d0;            // index of offset 0 (preconditioner only)
  double tol, nearzero, maxiter;
};

// max that propagates a NaN from either side, as torch.maximum does
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// The sum of gridDim.x partials in index order; valid in thread 0.
__device__ double ordered_sum(const double* partials) {
  const volatile double* parts = partials;  // written by other SMs: bypass L1
  double v = 0.0;
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) v += parts[j];
  return block_sum(v);
}

// Launch shape: at most 32 registers, so that 8 blocks of 256 threads fit an
// SM, and a block for each kRowsPerThread * kThreads contiguous rows, so that
// there are many waves. The first build let the compiler take 100-175
// registers and ran one wave of 264 blocks, each on a contiguous range: 0.671
// ms an iteration with fp32 bands at N = 10,240,000 on an H100, against 0.301
// ms for this shape (chip_smoke.py's stream kernel phase, PERF.md).
constexpr int kMinBlocks = 8;
constexpr int kRowsPerThread = 4;

// What a launch does: the whole plain iteration, or one of the preconditioned
// iteration's three launches (see the header note).
enum Mode { kPlain = 0, kPcgUpdate = 1, kPcgPrecond = 2, kPcgApply = 3 };

template <typename T, typename B, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks) cg_stream_kernel(StreamArgs<T, B> a) {
  const double* sc = a.scal;
  const double gamma = sc[kGamma], delta = sc[kDelta], gamma_old = sc[kGammaOld];
  const double alpha_old = sc[kAlphaOld], k = sc[kK];
  double brk = sc[kBreakdown];
  if (sc[kStop] != 0.0 || !(k < a.maxiter)) return;  // frozen: the same in every block

  const bool first = k == 0.0;
  const double beta_d = first ? 0.0 : gamma / gamma_old;
  const double denom = first ? delta : delta - beta_d * gamma / alpha_old;
  if (denom <= 0.0) brk = 1.0;
  const T alpha = static_cast<T>(gamma / nan_max(denom, gamma * a.nearzero));
  const T beta = static_cast<T>(beta_d);

  const int q = static_cast<long long>(k) & 1;
  const T* __restrict__ r = a.r[q];
  const T* __restrict__ w = a.w[q];
  const T* __restrict__ s = a.s[q];
  T* r_out = a.r[q ^ 1];
  T* w_out = a.w[q ^ 1];
  T* s_out = a.s[q ^ 1];
  const long long n = a.n;
  const B* __restrict__ bands = a.bands;
  const B* __restrict__ diag = bands + a.d0 * n;
  const long long lo = static_cast<long long>(blockIdx.x) * a.rows;
  const long long hi = lo + a.rows < n ? lo + a.rows : n;

  if (kMode == kPcgUpdate) {  // the updates, and c' = D^-1 r'
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const T s_new = w[i] + beta * s[i];
      const T r_new = r[i] - alpha * s_new;
      const T p_new = a.u[i] + beta * a.p[i];
      a.x[i] = a.x[i] + alpha * p_new;
      a.p[i] = p_new;
      r_out[i] = r_new;
      s_out[i] = s_new;
      a.c[i] = (T(1) / widen(diag[i])) * r_new;
    }
    return;
  }
  if (kMode == kPcgPrecond) {  // u' = 2 c' - D^-1 A c', as B5 and neumann_banded(sweeps=2)
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
      a.u[i] = T(2) * a.c[i] - (T(1) / widen(diag[i])) * dia_row(bands, a.c, n, a.o, i);
    return;
  }

  double g = 0.0, dl = 0.0, rr = 0.0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    T r_new, u_new, w_new;
    if (kMode == kPcgApply) {  // w' = A u' and the dots, r' from the update launch
      r_new = r_out[i];
      u_new = a.u[i];
      w_new = dia_row(bands, a.u, n, a.o, i);
      rr += prod64(r_new, r_new);
    } else {  // the whole plain iteration: u' = r', w' = A r', r' formed at each neighbour
      const T s_new = w[i] + beta * s[i];
      r_new = r[i] - alpha * s_new;
      const T p_new = r[i] + beta * a.p[i];
      a.x[i] = a.x[i] + alpha * p_new;
      a.p[i] = p_new;
      w_new = T(0);
#pragma unroll
      for (int d = 0; d < kMaxDiags; ++d) {
        if (d < a.o.ndiag) {
          const long long j = i + a.o.off[d];
          if (j >= 0 && j < n) {
            const T r_j = j == i ? r_new : r[j] - alpha * (w[j] + beta * s[j]);
            w_new += widen(bands[d * n + i]) * r_j;
          }
        }
      }
      r_out[i] = r_new;
      s_out[i] = s_new;
      u_new = r_new;
    }
    w_out[i] = w_new;
    g += prod64(r_new, u_new);
    dl += prod64(w_new, u_new);
  }

  g = block_sum(g);
  dl = block_sum(dl);
  if (kMode == kPcgApply) rr = block_sum(rr);
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = g;
    a.partials[gridDim.x + blockIdx.x] = dl;
    a.partials[2 * gridDim.x + blockIdx.x] = rr;
    __threadfence();  // the partials are visible before the ticket is taken
    is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const double gamma_new = ordered_sum(a.partials);
  const double delta_new = ordered_sum(a.partials + gridDim.x);
  const double rr_new = kMode == kPcgApply ? ordered_sum(a.partials + 2 * gridDim.x) : gamma_new;
  if (threadIdx.x == 0) {
    double* out = a.scal;
    out[kGamma] = gamma_new;
    out[kDelta] = delta_new;
    out[kRr] = rr_new;
    out[kGammaOld] = gamma;
    out[kAlphaOld] = static_cast<double>(alpha);
    out[kK] = k + 1.0;
    out[kStop] = (rr_new > 0.0 && sqrt(rr_new) >= a.tol) ? 0.0 : 1.0;
    out[kBreakdown] = brk;
    *a.ticket = 0u;
  }
}

// ---- the preconditioned iteration on a wavefront (one launch) ----

constexpr int kPcgThreads = 512;  // threads of a block, and W; one block an SM
constexpr int kPcgWarps = kPcgThreads / 32;
constexpr int kPcgPlanLen = 11;   // see PcgPlan

// The plan array of cgx_torch.ops.cg_stream.pcg_plan: [width, slab, shared
// bytes, lag1, lag2, ring c', ring u', ring r', and the three rings' first
// values in the shared buffer]. L1 forms rows lag1 behind L0's, L2 lag2.
struct PcgPlan {
  long long width, slab, reach, lag1, lag2;
  int ring_c, ring_u, ring_r;
  int off_c, off_u, off_r;
};

// Refused unless W is the block's size, each lag covers the stencil (a level
// reads only rows the level below finished in an earlier step), each ring
// holds its oldest read row and its newest written row of one step, the rings
// fit the shared bytes without overlapping, and the slabs cover [0, n).
template <typename T>
inline bool make_pcg_plan(PcgPlan* pl, const long long* plan, int plan_len, long long n,
                          long long reach, int grid) {
  if (plan_len != kPcgPlanLen) return false;
  const long long w = plan[0];
  pl->width = w;
  pl->slab = plan[1];
  pl->reach = reach;
  pl->lag1 = plan[3];
  pl->lag2 = plan[4];
  if (w != kPcgThreads || pl->slab < 1 || grid < 1 || pl->slab * grid < n) return false;
  if (pl->lag1 < reach + w || pl->lag2 - pl->lag1 < reach + w) return false;
  const long long need[3] = {pl->lag1 + w + reach, pl->lag2 - pl->lag1 + w + reach,
                             pl->lag1 + w};
  long long end = 0;
  for (int i = 0; i < 3; ++i) {
    const long long q = plan[5 + i], off = plan[8 + i];
    if (q < need[i] || off < end || q > (1LL << 30)) return false;
    end = off + q;
  }
  pl->ring_c = static_cast<int>(plan[5]);
  pl->ring_u = static_cast<int>(plan[6]);
  pl->ring_r = static_cast<int>(plan[7]);
  pl->off_c = static_cast<int>(plan[8]);
  pl->off_u = static_cast<int>(plan[9]);
  pl->off_r = static_cast<int>(plan[10]);
  return end * static_cast<long long>(sizeof(T)) <= plan[2] && plan[2] <= kSharedOptin;
}

__host__ __device__ inline long long pcg_pos_mod(long long x, long long q) {
  const long long r = x % q;
  return r < 0 ? r + q : r;
}

__device__ __forceinline__ int pcg_wrap(int slot, int q) { return slot >= q ? slot - q : slot; }

// Diagonals of a wavefront kernel built for ND of them: 5 takes the sorted,
// centred 5-point offsets only, off[0] < off[1] < off[2] = 0 < off[3] < off[4]
// (launch_pcg_wave sends others to ND = 0, any count read at run time): a tap
// then wraps round its ring on one side only, the centre tap is the row's own
// ring value and the diagonal is band 2. ND = 0 loads each band as it is used.
template <int ND>
struct PcgDiags {
  static constexpr int n = ND ? ND : 1;
};

// Sum over the diagonals of band_d(row) * v[row + off_d], in offset order,
// with v in a ring of q values whose slot `slot` holds the row and `own` is
// that value; terms outside [0, n) skipped unless kFull (no tap leaves
// [0, n)). bw: the row's band values when ND > 0, else read from bp.
template <int ND, bool kFull, typename T, typename B>
__device__ __forceinline__ T ring_taps(const Offsets& o, const T (&bw)[PcgDiags<ND>::n],
                                       const B* __restrict__ bp, long long n, long long row,
                                       const T* ring, int q, int slot, T own) {
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < (ND ? ND : kMaxDiags); ++d) {
    if (ND || d < o.ndiag) {
      const long long off = o.off[d];
      if (kFull || (row + off >= 0 && row + off < n)) {
        T v;
        if (ND == 5 && d == 2) {
          v = own;
        } else {
          int sl = slot + static_cast<int>(off);
          if (ND != 5 || d < 2) sl = sl < 0 ? sl + q : sl;
          if (ND != 5 || d > 2) sl = sl >= q ? sl - q : sl;
          v = ring[sl];
        }
        acc += (ND ? bw[ND ? d : 0] : widen(bp[d * n])) * v;
      }
    }
  }
  return acc;
}

// Sum of v over the block of kPcgThreads in a fixed order; valid in thread 0.
__device__ double pcg_block_sum(double v, double* part) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < 32) {
    s = threadIdx.x < kPcgWarps ? part[threadIdx.x] : 0.0;
    s = warp_sum(s);
  }
  __syncthreads();  // part is free for the next sum
  return s;
}

// One Neumann-preconditioned iteration in one launch (see the header note).
// Block b owns the slab [t0, t1) = [b slab, (b + 1) slab) of [0, n). At step
// t, L0 forms rows [f + t W, + W) of its range [t0 - 2R, t1 + 2R), L1 the
// rows lag1 behind of [t0 - R, t1 + R), L2 the rows lag2 behind of the slab
// (f = max(0, t0 - 2R); ranges clipped to [0, n)). Thread jj takes row jj of
// each window. A step issues its loads from device memory first, then forms
// L2, L1 and L0 from the rings (each reading only rows formed in earlier
// steps), stores the ring values last and ends with the one barrier. A step
// whose three windows and stencils lie inside their ranges and [0, n) (a
// uniform test) runs a copy with no test a row. Each value is formed by the
// operations of cg_stream_kernel's three modes, so with -fmad=false p', x',
// u', r', s' and w' are theirs bit for bit.
template <typename T, typename B, int ND>
__global__ void __launch_bounds__(kPcgThreads, 1)
    pcg_wave_kernel(StreamArgs<T, B> a, PcgPlan pl) {
  const double* sc = a.scal;
  const double gamma = sc[kGamma], delta = sc[kDelta], gamma_old = sc[kGammaOld];
  const double alpha_old = sc[kAlphaOld], k = sc[kK];
  double brk = sc[kBreakdown];
  if (sc[kStop] != 0.0 || !(k < a.maxiter)) return;  // frozen: the same in every block

  const bool first = k == 0.0;
  const double beta_d = first ? 0.0 : gamma / gamma_old;
  const double denom = first ? delta : delta - beta_d * gamma / alpha_old;
  if (denom <= 0.0) brk = 1.0;
  const T alpha = static_cast<T>(gamma / nan_max(denom, gamma * a.nearzero));
  const T beta = static_cast<T>(beta_d);

  const int q = static_cast<long long>(k) & 1;
  const T* __restrict__ r = a.r[q];
  const T* __restrict__ w = a.w[q];
  const T* __restrict__ s = a.s[q];
  T* r_out = a.r[q ^ 1];
  T* w_out = a.w[q ^ 1];
  T* s_out = a.s[q ^ 1];
  const long long n = a.n;
  const B* __restrict__ bands = a.bands;
  const B* __restrict__ diag = bands + a.d0 * n;

  extern __shared__ __align__(16) unsigned char pcg_smem[];
  T* ring = reinterpret_cast<T*>(pcg_smem);
  T* cr = ring + pl.off_c;  // c' (L0 -> L1)
  T* ur = ring + pl.off_u;  // u' (L1 -> L2)
  T* rq = ring + pl.off_r;  // r' (L0 -> gamma' at L1)
  const int qc = pl.ring_c, qu = pl.ring_u, qr = pl.ring_r;
  constexpr int W = kPcgThreads;
  const long long R = pl.reach;
  const int jj = threadIdx.x;

  const long long t0 = static_cast<long long>(blockIdx.x) * pl.slab;
  const long long t1 = t0 + pl.slab < n ? t0 + pl.slab : n;
  double g = 0.0, dl = 0.0, rr = 0.0;
  if (t0 < t1) {
    const long long lo0 = t0 - 2 * R > 0 ? t0 - 2 * R : 0;
    const long long hi0 = t1 + 2 * R < n ? t1 + 2 * R : n;
    const long long lo1 = t0 - R > 0 ? t0 - R : 0;
    const long long hi1 = t1 + R < n ? t1 + R : n;
    const long long f = lo0;
    const long long steps = (t1 - f + pl.lag2 + W - 1) / W;
    // ring slots of each window's first row
    int c0 = static_cast<int>(pcg_pos_mod(f, qc));
    int r0 = static_cast<int>(pcg_pos_mod(f, qr));
    int c1 = static_cast<int>(pcg_pos_mod(f - pl.lag1, qc));
    int r1 = static_cast<int>(pcg_pos_mod(f - pl.lag1, qr));
    int u1 = static_cast<int>(pcg_pos_mod(f - pl.lag1, qu));
    int u2 = static_cast<int>(pcg_pos_mod(f - pl.lag2, qu));
    for (long long t = 0; t < steps; ++t) {
      const long long a0 = f + t * W, a1 = a0 - pl.lag1, a2 = a0 - pl.lag2;
      const auto step = [&](auto all_full) {
        constexpr bool kFull = decltype(all_full)::value;
        const long long i0 = a0 + jj, i1 = a1 + jj, i2 = a2 + jj;
        const bool ok0 = kFull || (i0 >= lo0 && i0 < hi0);
        const bool own0 = ok0 && i0 >= t0 && i0 < t1;
        const bool ok1 = kFull || (i1 >= lo1 && i1 < hi1);
        const bool own1 = ok1 && i1 >= t0 && i1 < t1;
        const bool ok2 = kFull || (i2 >= t0 && i2 < t1);
        // 1. the loads from device memory
        T rv = T(0), wv = T(0), sv = T(0), dv = T(1), pv = T(0), uv = T(0), xv = T(0);
        if (ok0) {
          rv = r[i0];
          wv = w[i0];
          sv = s[i0];
          dv = widen(diag[i0]);
        }
        if (own0) {
          pv = a.p[i0];
          uv = a.u[i0];
          xv = a.x[i0];
        }
        T b1[PcgDiags<ND>::n], b2[PcgDiags<ND>::n];
        T d1 = T(1);
#pragma unroll
        for (int d = 0; d < PcgDiags<ND>::n; ++d) {
          b1[d] = (ND && ok1) ? widen(bands[d * n + i1]) : T(0);
          b2[d] = (ND && ok2) ? widen(bands[d * n + i2]) : T(0);
        }
        if (ok1) d1 = ND == 5 ? b1[ND == 5 ? 2 : 0] : widen(diag[i1]);
        // 2. L2: w' = A u' from the u' ring, and delta'
        if (ok2) {
          const int su = pcg_wrap(u2 + jj, qu);
          const T un = ur[su];
          const T wn = ring_taps<ND, kFull>(a.o, b2, bands + i2, n, i2, ur, qu, su, un);
          w_out[i2] = wn;
          dl += prod64(wn, un);
        }
        // 3. L1: u' = 2 c' - D^-1 A c' from the c' ring
        T un1 = T(0);
        if (ok1) {
          const int sc1 = pcg_wrap(c1 + jj, qc);
          const T cc = cr[sc1];
          const T ac = ring_taps<ND, kFull>(a.o, b1, bands + i1, n, i1, cr, qc, sc1, cc);
          un1 = T(2) * cc - (T(1) / d1) * ac;
        }
        // 4. L0: the updates and c' = D^-1 r'
        T cn = T(0), rn = T(0);
        if (ok0) {
          const T sn = wv + beta * sv;
          rn = rv - alpha * sn;
          cn = (T(1) / dv) * rn;
          if (own0) {
            const T pn = uv + beta * pv;
            a.x[i0] = xv + alpha * pn;
            a.p[i0] = pn;
            r_out[i0] = rn;
            s_out[i0] = sn;
            rr += prod64(rn, rn);
          }
        }
        // 5. this step's ring values, and u' with gamma' at the slab's rows
        if (ok1) {
          ur[pcg_wrap(u1 + jj, qu)] = un1;
          if (own1) {
            a.u[i1] = un1;
            g += prod64(rq[pcg_wrap(r1 + jj, qr)], un1);
          }
        }
        if (ok0) {
          cr[pcg_wrap(c0 + jj, qc)] = cn;
          rq[pcg_wrap(r0 + jj, qr)] = rn;
        }
      };
      const bool full = a0 >= lo0 && a0 + W <= hi0 && a1 >= lo1 && a1 + W <= hi1 &&
                        a2 >= t0 && a2 + W <= t1 && a2 - R >= 0 && a1 + W + R <= n;
      if (full)
        step(std::true_type{});
      else
        step(std::false_type{});
      c0 = pcg_wrap(c0 + W, qc);
      r0 = pcg_wrap(r0 + W, qr);
      c1 = pcg_wrap(c1 + W, qc);
      r1 = pcg_wrap(r1 + W, qr);
      u1 = pcg_wrap(u1 + W, qu);
      u2 = pcg_wrap(u2 + W, qu);
      __syncthreads();  // this step's ring values are in place
    }
  }

  __shared__ double part[kPcgWarps];
  g = pcg_block_sum(g, part);
  dl = pcg_block_sum(dl, part);
  rr = pcg_block_sum(rr, part);
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = g;
    a.partials[gridDim.x + blockIdx.x] = dl;
    a.partials[2 * gridDim.x + blockIdx.x] = rr;
    __threadfence();  // the partials are visible before the ticket is taken
    is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const volatile double* parts = a.partials;  // written by other SMs: bypass L1
  double sums[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    double v = 0.0;
    for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kPcgThreads)
      v += parts[c * gridDim.x + j];
    sums[c] = pcg_block_sum(v, part);
  }
  if (threadIdx.x == 0) {
    double* out = a.scal;
    out[kGamma] = sums[0];
    out[kDelta] = sums[1];
    out[kRr] = sums[2];
    out[kGammaOld] = gamma;
    out[kAlphaOld] = static_cast<double>(alpha);
    out[kK] = k + 1.0;
    out[kStop] = (sums[2] > 0.0 && sqrt(sums[2]) >= a.tol) ? 0.0 : 1.0;
    out[kBreakdown] = brk;
    *a.ticket = 0u;
  }
}

template <typename T, typename B>
static int launch_stream(const void* bands, void* p, void* x, void* u, void* c, void* const* rws,
                         void* partials, long long partials_len, void* ticket, void* scal,
                         long long n, const long long* offsets, int ndiag, int d0, double tol,
                         double nearzero, double maxiter, int precond, int* grid_out,
                         void* stream) {
  StreamArgs<T, B> a;
  if (n < 1 || !make_offsets(offsets, ndiag, &a.o) || (precond && (d0 < 0 || d0 >= ndiag)))
    return static_cast<int>(cudaErrorInvalidValue);
  // A block for each kRowsPerThread * kThreads contiguous rows, and a partial
  // of each dot for each block.
  const long long g = (n + kThreads * kRowsPerThread - 1) / (kThreads * kRowsPerThread);
  if (partials_len < 3 * g || g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.bands = static_cast<const B*>(bands);
  a.p = static_cast<T*>(p);
  a.x = static_cast<T*>(x);
  a.u = static_cast<T*>(u);
  a.c = static_cast<T*>(c);
  for (int t = 0; t < 2; ++t) {
    a.r[t] = static_cast<T*>(rws[t]);
    a.w[t] = static_cast<T*>(rws[2 + t]);
    a.s[t] = static_cast<T*>(rws[4 + t]);
  }
  a.partials = static_cast<double*>(partials);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.scal = static_cast<double*>(scal);
  a.n = n;
  a.rows = kThreads * kRowsPerThread;
  a.d0 = precond ? d0 : 0;
  a.tol = tol;
  a.nearzero = nearzero;
  a.maxiter = maxiter;
  *grid_out = static_cast<int>(g);
  const dim3 grid(static_cast<unsigned int>(g));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precond) {
    cg_stream_kernel<T, B, kPcgUpdate><<<grid, kThreads, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cg_stream_kernel<T, B, kPcgPrecond><<<grid, kThreads, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cg_stream_kernel<T, B, kPcgApply><<<grid, kThreads, 0, st>>>(a);
  } else {
    cg_stream_kernel<T, B, kPlain><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches wavefront kernel K with the plan's shared bytes, after letting K
// take them (once a process); the launch's error
template <auto K, typename A>
static int pcg_launch(int grid, long long shared, void* stream, const A& a, const PcgPlan& pl) {
  const cudaError_t allowed = allow_shared<K>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  K<<<grid, kPcgThreads, static_cast<size_t>(shared), static_cast<cudaStream_t>(stream)>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B>
static int launch_pcg_wave(const void* bands, void* p, void* x, void* u, void* const* rws,
                           void* partials, long long partials_len, void* ticket, void* scal,
                           long long n, const long long* offsets, int ndiag, double tol,
                           double nearzero, double maxiter, const long long* plan, int plan_len,
                           int grid, void* stream) {
  StreamArgs<T, B> a;
  if (n < 1 || !make_offsets(offsets, ndiag, &a.o)) return static_cast<int>(cudaErrorInvalidValue);
  int d0 = -1;
  long long reach = 0;
  for (int d = 0; d < ndiag; ++d) {
    if (offsets[d] == 0) d0 = d;
    const long long r = offsets[d] < 0 ? -offsets[d] : offsets[d];
    reach = r > reach ? r : reach;
  }
  PcgPlan pl;
  if (d0 < 0 || !make_pcg_plan<T>(&pl, plan, plan_len, n, reach, grid) ||
      partials_len < 3LL * grid)
    return static_cast<int>(cudaErrorInvalidValue);
  a.bands = static_cast<const B*>(bands);
  a.p = static_cast<T*>(p);
  a.x = static_cast<T*>(x);
  a.u = static_cast<T*>(u);
  a.c = nullptr;
  for (int t = 0; t < 2; ++t) {
    a.r[t] = static_cast<T*>(rws[t]);
    a.w[t] = static_cast<T*>(rws[2 + t]);
    a.s[t] = static_cast<T*>(rws[4 + t]);
  }
  a.partials = static_cast<double*>(partials);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.scal = static_cast<double*>(scal);
  a.n = n;
  a.rows = pl.slab;
  a.d0 = d0;
  a.tol = tol;
  a.nearzero = nearzero;
  a.maxiter = maxiter;
  const bool centred = ndiag == 5 && offsets[0] < offsets[1] && offsets[1] < 0 &&
                       offsets[2] == 0 && 0 < offsets[3] && offsets[3] < offsets[4];
  if (centred) return pcg_launch<pcg_wave_kernel<T, B, 5>>(grid, plan[2], stream, a, pl);
  return pcg_launch<pcg_wave_kernel<T, B, 0>>(grid, plan[2], stream, a, pl);
}

}  // namespace cgx

extern "C" {

#define CGX_STREAM_ENTRY(NAME, T, B)                                                         \
  int NAME(const void* bands, void* p, void* x, void* u, void* c, void* r0, void* r1,       \
           void* w0, void* w1, void* s0, void* s1, void* partials, long long partials_len,  \
           void* ticket, void* scal, long long n, const long long* offsets, int ndiag,      \
           int d0, double tol, double nearzero, double maxiter, int precond,                \
           int* grid_out, void* stream) {                                                   \
    void* rws[6] = {r0, r1, w0, w1, s0, s1};                                                \
    return cgx::launch_stream<T, B>(bands, p, x, u, c, rws, partials, partials_len, ticket, \
                                    scal, n, offsets, ndiag, d0, tol, nearzero, maxiter,    \
                                    precond, grid_out, stream);                              \
  }

CGX_STREAM_ENTRY(cgx_cg_stream_f32, float, float)
CGX_STREAM_ENTRY(cgx_cg_stream_f64, double, double)
CGX_STREAM_ENTRY(cgx_cg_stream_f32_bf16b, float, __nv_bfloat16)
CGX_STREAM_ENTRY(cgx_cg_stream_f32_f16b, float, __half)
CGX_STREAM_ENTRY(cgx_cg_stream_bf16, cgx::bf16, cgx::bf16)

#undef CGX_STREAM_ENTRY

// The preconditioned iteration in the wavefront design: plan from
// cgx_torch.ops.cg_stream.pcg_plan, grid blocks.
#define CGX_PCG_WAVE_ENTRY(NAME, T, B)                                                       \
  int NAME(const void* bands, void* p, void* x, void* u, void* r0, void* r1, void* w0,      \
           void* w1, void* s0, void* s1, void* partials, long long partials_len,            \
           void* ticket, void* scal, long long n, const long long* offsets, int ndiag,      \
           double tol, double nearzero, double maxiter, const long long* plan,              \
           int plan_len, int grid, void* stream) {                                          \
    void* rws[6] = {r0, r1, w0, w1, s0, s1};                                                \
    return cgx::launch_pcg_wave<T, B>(bands, p, x, u, rws, partials, partials_len, ticket,  \
                                      scal, n, offsets, ndiag, tol, nearzero, maxiter, plan,  \
                                      plan_len, grid, stream);                               \
  }

CGX_PCG_WAVE_ENTRY(cgx_pcg_wave_f32, float, float)
CGX_PCG_WAVE_ENTRY(cgx_pcg_wave_f64, double, double)
CGX_PCG_WAVE_ENTRY(cgx_pcg_wave_f32_bf16b, float, __nv_bfloat16)
CGX_PCG_WAVE_ENTRY(cgx_pcg_wave_bf16, cgx::bf16, cgx::bf16)

#undef CGX_PCG_WAVE_ENTRY

}  // extern "C"
