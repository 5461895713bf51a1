// Banded (DIA) mat-vec kernels for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernels of cgx/ops/dia_spmv.py:
//   dia_matvec      (_dia_kernel, pallas_call at dia_spmv.py:91)
//   dia_matvec_dot  (_dia_dot_kernel, pallas_call at dia_spmv.py:431)
//
//   y[i] = sum_d bands[d*n + i] * x[i + off_d]   (terms with i + off_d outside [0, n) are 0)
//   dot  = <x, y>                                 (dia_matvec_dot only)
//
// Bound: memory. The work is 2*ndiag flops per row against (ndiag + 2) words
// moved per row (each band read once, x read once, y written once): for the
// 5-band stencils at n = 10,240,000 that is 7 * 4 B * n = 287 MB in float
// (86 us at 3.35 TB/s) and 573 MB in double.
//
// Two designs, picked on the host by cgx_torch.ops.dia_spmv.matvec_plan. Where
// B8's plan places x's rings in shared memory (every 2D and 3D stencil the
// solvers build) and n gives every SM a 1024-row tile, both entries run B8's
// kernel (csrc/dia_stream.cu, the flat form with stride n): dia_matvec is its
// product, bitwise the same y, and dia_matvec_dot the same kernel with a dot
// epilogue: x[i]*y[i] summed in the data type, one partial a block, combined
// by the last-block ticket. That took 0.1095 ms against this file's 0.2262 at
// n = 10,240,000 in float on an H100 (PERF.md). This file's kernels are the
// other design: below a tile an SM (the fp64 goldens' n = 10,000) they are
// the faster, and a caller may also force them (dia_spmv.GRID_PLAN).
//
// The grid-stride design: one thread per row in a grid-stride loop. Band reads are coalesced
// across a warp; the shifted reads of x are coalesced too and come back from
// L1/L2 (each x element is read by ndiag neighbouring rows). The TPU kernel
// padded x by an aligned halo and rolled lanes because Mosaic needs 128-lane
// aligned loads; here a bounds test replaces the padding, so no padded copy of
// x or of the bands is made. Offsets are runtime values passed by value (at
// most kMaxDiags). The dot accumulates in the data type, as the TPU kernel did,
// and its cross-block combine is deterministic (common.cuh).
#include "common.cuh"
#include "dia_row.cuh"

namespace cgx {

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_matvec_kernel(const T* __restrict__ bands, const T* __restrict__ x, T* __restrict__ y,
                  long long n, Offsets o) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = dia_row(bands, x, n, o, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_matvec_dot_kernel(const T* __restrict__ bands, const T* __restrict__ x, T* __restrict__ y,
                      T* __restrict__ partials, unsigned int* __restrict__ ticket,
                      T* __restrict__ dot, long long n, Offsets o) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  T part = T(0);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T yi = dia_row(bands, x, n, o, i);
    y[i] = yi;
    part += x[i] * yi;
  }
  grid_sum(block_sum(part), partials, ticket, dot);
}

template <typename T>
static int launch_matvec(const void* bands, const void* x, void* y, long long n,
                         const long long* offsets, int ndiag, void* stream) {
  Offsets o;
  if (n < 0 || !make_offsets(offsets, ndiag, &o)) return static_cast<int>(cudaErrorInvalidValue);
  dia_matvec_kernel<T><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const T*>(x), static_cast<T*>(y), n, o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_matvec_dot(const void* bands, const void* x, void* y, void* partials,
                             long long partials_len, void* ticket, void* dot, long long n,
                             const long long* offsets, int ndiag, void* stream) {
  Offsets o;
  const int grid = grid_for(n);
  if (n < 0 || grid > partials_len || !make_offsets(offsets, ndiag, &o))
    return static_cast<int>(cudaErrorInvalidValue);
  dia_matvec_dot_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<T*>(partials), static_cast<unsigned int*>(ticket), static_cast<T*>(dot), n, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx

extern "C" {

int cgx_dia_matvec_f32(const void* bands, const void* x, void* y, long long n,
                       const long long* offsets, int ndiag, void* stream) {
  return cgx::launch_matvec<float>(bands, x, y, n, offsets, ndiag, stream);
}

int cgx_dia_matvec_f64(const void* bands, const void* x, void* y, long long n,
                       const long long* offsets, int ndiag, void* stream) {
  return cgx::launch_matvec<double>(bands, x, y, n, offsets, ndiag, stream);
}

int cgx_dia_matvec_dot_f32(const void* bands, const void* x, void* y, void* partials,
                           long long partials_len, void* ticket, void* dot, long long n,
                           const long long* offsets, int ndiag, void* stream) {
  return cgx::launch_matvec_dot<float>(bands, x, y, partials, partials_len, ticket, dot, n,
                                       offsets, ndiag, stream);
}

int cgx_dia_matvec_dot_f64(const void* bands, const void* x, void* y, void* partials,
                           long long partials_len, void* ticket, void* dot, long long n,
                           const long long* offsets, int ndiag, void* stream) {
  return cgx::launch_matvec_dot<double>(bands, x, y, partials, partials_len, ticket, dot, n,
                                        offsets, ndiag, stream);
}

}  // extern "C"
