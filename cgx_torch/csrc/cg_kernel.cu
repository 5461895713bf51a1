// Whole-solve CG kernel for Hopper (sm_90a), float and double: one launch runs a
// chunk of iterations of the reference recurrence, optionally with the degree-1
// Neumann preconditioner M^-1 r = 2 D^-1 r - D^-1 A D^-1 r.
//
// Replaces the Pallas TPU kernels of cgx/ops/cg_kernel.py:
//   _dia_cg_vmem    (_chunk_kernel,   pallas_call at cg_kernel.py:245)
//   _dia_cg_vmem2d  (_chunk_kernel2d, pallas_call at cg_kernel.py:479)
// The two compute the same function; the second only tiles the vectors as
// (rows, cols) planes for the TPU's (8, 128) registers and Mosaic's tiling. On
// Hopper one kernel over flat vectors serves both. As in cgx, the bands may be
// stored in bfloat16 under float vectors (entry cgx_dia_cg_chunk_f32_bf16b, the
// refinement's inner solve): each band value is widened to float as it is loaded
// (dia_row.cuh), which halves the bands' share of the traffic; the float and
// double entries compute what they did before, bit for bit.
//
// Per iteration, with the scalars [rsold, converged, k, breakdown] carried in
// registers, in double, and identical in every block:
//   (a) Ap = A p on the block's rows, and the block's partial of <p, Ap>;  grid sync
//   (b) alpha from the ordered sum of all blocks' partials; x += alpha p,
//       r -= alpha Ap, the partial of <r, r>; with the preconditioner also
//       c = D^-1 r;                                                      grid sync
//       (precond) z = 2c - D^-1 A c (c's halo comes from the neighbours), the
//       partial of <r, z>, z kept in Ap's slot;                          grid sync
//   (c) beta, conv_now, k from the ordered sums; p = new_dir + beta p on the
//       block's rows;                                                    grid sync
// An iteration that starts inactive (converged, or k = maxiter) ends the chunk
// in every block at once, since every block holds the same scalars; x and r are
// written only while active, p and k only while active and not converging, the
// frozen-iteration rules of cgx's _chunk_kernel. Block 0 writes the scalars back.
//
// Dots: each block owns a fixed, contiguous range of rows; a block sums its
// rows' products in thread order, then with a shuffle tree (common.cuh); then
// EVERY block reads all blocks' partials and sums them in index order, so alpha
// and beta are bitwise the same in every block and on every run. No float
// atomics, no ticket. The three dots use three partial buffers: a fast block
// writes <r, r> partials while a slow one may still read the <p, Ap> ones.
//
// Precision: the dots sum in double and the scalars stay in double (a float
// product is exact in double); alpha and beta round to the data's type only
// where they scale vectors. For float data that is the arithmetic of
// cg_solve(dot_precision=float64), the plain loop of solve(precision="fp32"),
// so the two take the same iterations. cgx's TPU kernel keeps float scalars,
// and so did this one at first: the float Neumann PCG count then followed the
// rounding of the scalars, 1948 iterations on lap2d_fd(1414) at tol 1e-5 ||b||
// against the plain loop's 1899, and 1141 on lap2d_fd(1000) against 1200 when
// the plain loop's dots were float too.
//
// Halos: p is read with a halo in (a) and rewritten in place in (c). The grid
// sync that ends (a) makes the in-place write safe: every block has finished
// reading p's halo before any block starts (b), let alone (c); the sync that
// ends (c) publishes the new p to the next (a). c is written in (b) and read
// with a halo after the next sync. p and c are read with plain (coherent) loads,
// never through the read-only path, since they change within the launch.
//
// Bound: memory. The recurrence must move, per iteration, the bands once, p, x
// and r in and p, x and r out: (ndiag + 6) N words; the preconditioner adds a
// second band pass and c out and back, (2 ndiag + 8) N. As written the kernel
// moves, before caching, (ndiag + 11) N words (Ap out and back in, p read in
// (a), (b) and (c)) and (2 ndiag + 17) N with the preconditioner. For 5 bands
// at N = 1,000,000 in float the state (bands, x, r, p, Ap: 36 MB) largely stays
// in the 50 MB L2, so the kernel can beat the HBM bound there; at 4,000,000 it
// cannot. Three grid syncs (four with the preconditioner) and three ordered
// sums of all partials are the fixed cost of an iteration. The kernel asks for
// 4 blocks of 256 threads an SM (at most 64 registers a thread): the compiler's
// own choice, 128 registers and 2 blocks, left too few loads in flight (36.3 us
// an iteration at N = 1e6 in float, chip_smoke.py on an earlier build). SMEM or
// cluster residency, TMA and an L2 access-policy window are later work.
#include <cooperative_groups.h>

#include "common.cuh"
#include "dia_row.cuh"

namespace cgx {

namespace cg = cooperative_groups;

template <typename T, typename B>
struct ChunkArgs {
  const B* bands;  // (ndiag, n), in the vectors' type or bfloat16
  T* p;            // read with a halo in (a), rewritten in (c)
  T* x;
  T* r;
  T* ap;           // Ap, then z with the preconditioner
  T* c;            // D^-1 r (preconditioner only)
  double* partials;  // 3 * gridDim.x: <p, Ap>, <r, r>, <r, z>
  const double* scal_in;  // [rsold, converged, k, breakdown]
  double* scal_out;
  long long n;
  long long rows;  // rows per block
  Offsets o;
  int d0;          // index of offset 0 (preconditioner only)
  double tol, nearzero, maxiter;
  int chunk;
};

// max that propagates a NaN from either side, as torch.maximum and jnp.maximum do
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// The sum of all blocks' partials in index order, in every thread of the block.
__device__ double ordered_total(const double* parts) {
  __shared__ double total;
  double v = 0.0;
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) v += parts[j];
  v = block_sum(v);  // its leading __syncthreads also guards `total` from the last call
  if (threadIdx.x == 0) total = v;
  __syncthreads();
  return total;
}

template <typename T, typename B, bool kPrecond>
__global__ void __launch_bounds__(kThreads, 4) dia_cg_chunk_kernel(ChunkArgs<T, B> a) {
  cg::grid_group grid = cg::this_grid();
  double* part_pap = a.partials;
  double* part_rr = a.partials + gridDim.x;
  double* part_rz = a.partials + 2 * gridDim.x;
  const long long lo = static_cast<long long>(blockIdx.x) * a.rows;
  const long long hi = lo + a.rows < a.n ? lo + a.rows : a.n;
  const long long first = lo + threadIdx.x;
  const B* diag = a.bands + a.d0 * a.n;

  double rsold = a.scal_in[0], conv = a.scal_in[1], k = a.scal_in[2], brk = a.scal_in[3];
  for (int it = 0; it < a.chunk; ++it) {
    if (!(conv == 0.0 && k < a.maxiter)) break;  // the same decision in every block

    // (a) Ap and <p, Ap>
    double part = 0.0;
    for (long long i = first; i < hi; i += kThreads) {
      const T v = dia_row(a.bands, a.p, a.n, a.o, i);
      a.ap[i] = v;
      part += static_cast<double>(a.p[i]) * v;
    }
    part = block_sum(part);
    if (threadIdx.x == 0) part_pap[blockIdx.x] = part;
    grid.sync();

    // (b) alpha, x, r, <r, r> (and c = D^-1 r)
    const double conj = ordered_total(part_pap);
    if (conj <= 0.0) brk = 1.0;
    const T alpha = static_cast<T>(rsold / nan_max(conj, rsold * a.nearzero));
    part = 0.0;
    for (long long i = first; i < hi; i += kThreads) {
      const T pi = a.p[i];
      const T ri = a.r[i] - alpha * a.ap[i];
      a.x[i] = a.x[i] + alpha * pi;
      a.r[i] = ri;
      part += static_cast<double>(ri) * ri;
      if (kPrecond) a.c[i] = (T(1) / widen(diag[i])) * ri;
    }
    part = block_sum(part);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = part;
    grid.sync();

    if (kPrecond) {  // z = 2c - D^-1 A c and <r, z>; Ap is spent, its slot takes z
      part = 0.0;
      for (long long i = first; i < hi; i += kThreads) {
        const T zi = T(2) * a.c[i] - (T(1) / widen(diag[i])) * dia_row(a.bands, a.c, a.n, a.o, i);
        a.ap[i] = zi;
        part += static_cast<double>(a.r[i]) * zi;
      }
      part = block_sum(part);
      if (threadIdx.x == 0) part_rz[blockIdx.x] = part;
      grid.sync();
    }

    // (c) convergence, beta and the new direction
    const double rr = ordered_total(part_rr);
    const bool conv_now = sqrt(rr) < a.tol;
    const double rsnew = kPrecond ? ordered_total(part_rz) : rr;
    if (conv_now) {
      conv = 1.0;  // break before update: p, rsold and k keep their values
    } else {
      const T beta = static_cast<T>(rsnew / rsold);
      const T* new_dir = kPrecond ? a.ap : a.r;
      for (long long i = first; i < hi; i += kThreads) a.p[i] = new_dir[i] + beta * a.p[i];
      rsold = rsnew;
      k = k + 1.0;
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scal_out[0] = rsold;
    a.scal_out[1] = conv;
    a.scal_out[2] = k;
    a.scal_out[3] = brk;
  }
}

template <typename T, typename B, bool kPrecond>
static int launch_chunk(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                        void* partials, long long partials_len, const void* scal_in,
                        void* scal_out, long long n, const long long* offsets, int ndiag, int d0,
                        double tol, double nearzero, double maxiter, int chunk, int* grid_out,
                        void* stream) {
  ChunkArgs<T, B> a;
  if (n < 0 || chunk < 0 || !make_offsets(offsets, ndiag, &a.o) || (kPrecond && (d0 < 0 || d0 >= ndiag)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The grid is no larger than the blocks that fit at once, as a cooperative launch needs.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dia_cg_chunk_kernel<T, B, kPrecond>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long g = static_cast<long long>(per_sm) * sms;
  const long long need = (n + kThreads - 1) / kThreads;
  if (need < g) g = need;
  if (partials_len / 3 < g) g = partials_len / 3;
  if (g < 1) g = 1;
  a.bands = static_cast<const B*>(bands);
  a.p = static_cast<T*>(p);
  a.x = static_cast<T*>(x);
  a.r = static_cast<T*>(r);
  a.ap = static_cast<T*>(ap);
  a.c = static_cast<T*>(c);
  a.partials = static_cast<double*>(partials);
  a.scal_in = static_cast<const double*>(scal_in);
  a.scal_out = static_cast<double*>(scal_out);
  a.n = n;
  a.rows = (n + g - 1) / g;
  a.d0 = kPrecond ? d0 : 0;
  a.tol = tol;
  a.nearzero = nearzero;
  a.maxiter = maxiter;
  a.chunk = chunk;
  *grid_out = static_cast<int>(g);
  void* args[] = {&a};
  // a launch the card refuses (cudaErrorCooperativeLaunchTooLarge, ...) returns its code
  err = cudaLaunchCooperativeKernel((const void*)dia_cg_chunk_kernel<T, B, kPrecond>,
                                    dim3(static_cast<unsigned int>(g)), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B>
static int launch_chunk_any(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                            void* partials, long long partials_len, const void* scal_in,
                            void* scal_out, long long n, const long long* offsets, int ndiag,
                            int d0, double tol, double nearzero, double maxiter, int chunk,
                            int precond, int* grid_out, void* stream) {
  if (precond)
    return launch_chunk<T, B, true>(bands, p, x, r, ap, c, partials, partials_len, scal_in,
                                    scal_out, n, offsets, ndiag, d0, tol, nearzero, maxiter, chunk,
                                    grid_out, stream);
  return launch_chunk<T, B, false>(bands, p, x, r, ap, c, partials, partials_len, scal_in, scal_out,
                                n, offsets, ndiag, d0, tol, nearzero, maxiter, chunk, grid_out,
                                stream);
}

}  // namespace cgx

extern "C" {

int cgx_dia_cg_chunk_f32(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                         void* partials, long long partials_len, const void* scal_in,
                         void* scal_out, long long n, const long long* offsets, int ndiag, int d0,
                         double tol, double nearzero, double maxiter, int chunk, int precond,
                         int* grid_out, void* stream) {
  return cgx::launch_chunk_any<float, float>(bands, p, x, r, ap, c, partials, partials_len, scal_in,
                                      scal_out, n, offsets, ndiag, d0, tol, nearzero, maxiter,
                                      chunk, precond, grid_out, stream);
}

int cgx_dia_cg_chunk_f64(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                         void* partials, long long partials_len, const void* scal_in,
                         void* scal_out, long long n, const long long* offsets, int ndiag, int d0,
                         double tol, double nearzero, double maxiter, int chunk, int precond,
                         int* grid_out, void* stream) {
  return cgx::launch_chunk_any<double, double>(bands, p, x, r, ap, c, partials, partials_len,
                                               scal_in, scal_out, n, offsets, ndiag, d0, tol,
                                               nearzero, maxiter, chunk, precond, grid_out, stream);
}

int cgx_dia_cg_chunk_f32_bf16b(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                               void* partials, long long partials_len, const void* scal_in,
                               void* scal_out, long long n, const long long* offsets, int ndiag,
                               int d0, double tol, double nearzero, double maxiter, int chunk,
                               int precond, int* grid_out, void* stream) {
  return cgx::launch_chunk_any<float, __nv_bfloat16>(bands, p, x, r, ap, c, partials, partials_len,
                                                     scal_in, scal_out, n, offsets, ndiag, d0, tol,
                                                     nearzero, maxiter, chunk, precond, grid_out,
                                                     stream);
}

}  // extern "C"
