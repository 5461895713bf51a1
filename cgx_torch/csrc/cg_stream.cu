// Streaming Chronopoulos-Gear CG for Hopper (sm_90a): an iteration per launch
// (three with the Neumann preconditioner), for banded operators whose state is
// too large to keep on chip.
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
// Without the preconditioner an iteration is one launch. With it, it is three:
// the updates and c' = D^-1 r'; then u' = 2 c' - D^-1 A c'; then w' = A u' and
// the dots. Each needs its input at the neighbours, which only a launch
// boundary publishes on CUDA. In one launch each row had to form u' at its
// neighbours from c' at theirs, and c' from r, w, s and the diagonal (about 130
// loads and 25 divisions a row); in two (u' re-formed at the neighbours from
// c'), about 60 loads. Three launches move c' and u' out and back (4 N more
// words) and leave about 12 loads a row in each; on an H100 at N = 10,240,000
// they took 0.94, 0.72 and 0.60 ms an iteration (PERF.md).
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
//   once. With the preconditioner c' and u' go through device memory between
//   the three launches instead.
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
//   k >= maxiter returns at once in every block: no vector, scalar or ticket
//   changes. The host reads the scalars once per 32 iterations.
// - Bounds. Terms outside [0, n) are zero (dia_row.cuh), so no padding rows and
//   no identity rows are needed, and no tail diagonal entry is ever divided by.
//
// Bound: memory. The recurrence must move, per iteration, the bands once, p, x,
// r, w, s in and out: (ndiag + 10) N words (ndiag/2 + 10 with bfloat16 bands
// under float vectors); with the preconditioner u as well, (ndiag + 12) N, and
// the three launches move (2 ndiag + 17) N before caching (the bands twice,
// the diagonal once more, c' and u' out and back). The neighbour re-reads of
// the plain iteration cost load instructions and cache bandwidth, not device
// memory traffic, so long as a block's halo stays in cache.
#include <cuda_bf16.h>

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
      rr += static_cast<double>(r_new) * r_new;
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
    g += static_cast<double>(r_new) * u_new;
    dl += static_cast<double>(w_new) * u_new;
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

#undef CGX_STREAM_ENTRY

}  // extern "C"
