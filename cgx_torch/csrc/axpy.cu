// Fused vector-update kernels of the CG iteration tail, for Hopper (sm_90a),
// float and double.
//
// Replaces the Pallas TPU kernels of cgx/ops/axpy.py:
//   fused_update_rs (_update_rs_kernel, pallas_call at axpy.py:68)
//     x' = x + alpha p,  r' = r - alpha Ap,  rs = <r', r'>
//   fused_axpby     (_axpby_kernel, pallas_call at axpy.py:118)
//     out = alpha a + beta b
//
// Bound: memory. fused_update_rs reads 4 vectors and writes 2 (6 words per
// element: 246 MB in float at n = 10,240,000, 73 us at 3.35 TB/s);
// fused_axpby reads 2 and writes 1 (3 words: 123 MB, 37 us).
//
// Design: one thread per element in a grid-stride loop, coalesced loads and
// stores, and <r', r'> taken while r' is still in registers, so the dot costs
// no extra pass. alpha and beta are read through device pointers, so the
// solver's scalars never visit the host. The outputs are separate buffers (the
// callers pass fresh ones), which is what lets every pointer be __restrict__.
// The dot accumulates in the data type, as the TPU kernel did, and its
// cross-block combine is deterministic (common.cuh).
#include "common.cuh"

namespace cgx {

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_rs_kernel(const T* __restrict__ x, const T* __restrict__ p, const T* __restrict__ r,
                 const T* __restrict__ ap, const T* __restrict__ alpha_ptr, T* __restrict__ xo,
                 T* __restrict__ ro, T* __restrict__ partials, unsigned int* __restrict__ ticket,
                 T* __restrict__ rs, long long n) {
  const T alpha = *alpha_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  T part = T(0);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    xo[i] = x[i] + alpha * p[i];
    const T rn = r[i] - alpha * ap[i];
    ro[i] = rn;
    part += rn * rn;
  }
  grid_sum(block_sum(part), partials, ticket, rs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ alpha_ptr,
             const T* __restrict__ beta_ptr, T* __restrict__ out, long long n) {
  const T alpha = *alpha_ptr;
  const T beta = *beta_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = alpha * a[i] + beta * b[i];
  }
}

template <typename T>
static int launch_update_rs(const void* x, const void* p, const void* r, const void* ap,
                            const void* alpha, void* xo, void* ro, void* partials,
                            long long partials_len, void* ticket, void* rs, long long n,
                            void* stream) {
  const int grid = grid_for(n);
  if (n < 0 || grid > partials_len) return static_cast<int>(cudaErrorInvalidValue);
  update_rs_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(p), static_cast<const T*>(r),
      static_cast<const T*>(ap), static_cast<const T*>(alpha), static_cast<T*>(xo),
      static_cast<T*>(ro), static_cast<T*>(partials), static_cast<unsigned int*>(ticket),
      static_cast<T*>(rs), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_axpby(const void* a, const void* b, const void* alpha, const void* beta,
                        void* out, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  axpby_kernel<T><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(alpha),
      static_cast<const T*>(beta), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx

extern "C" {

int cgx_fused_update_rs_f32(const void* x, const void* p, const void* r, const void* ap,
                            const void* alpha, void* xo, void* ro, void* partials,
                            long long partials_len, void* ticket, void* rs, long long n,
                            void* stream) {
  return cgx::launch_update_rs<float>(x, p, r, ap, alpha, xo, ro, partials, partials_len, ticket,
                                      rs, n, stream);
}

int cgx_fused_update_rs_f64(const void* x, const void* p, const void* r, const void* ap,
                            const void* alpha, void* xo, void* ro, void* partials,
                            long long partials_len, void* ticket, void* rs, long long n,
                            void* stream) {
  return cgx::launch_update_rs<double>(x, p, r, ap, alpha, xo, ro, partials, partials_len,
                                       ticket, rs, n, stream);
}

int cgx_fused_axpby_f32(const void* a, const void* b, const void* alpha, const void* beta,
                        void* out, long long n, void* stream) {
  return cgx::launch_axpby<float>(a, b, alpha, beta, out, n, stream);
}

int cgx_fused_axpby_f64(const void* a, const void* b, const void* alpha, const void* beta,
                        void* out, long long n, void* stream) {
  return cgx::launch_axpby<double>(a, b, alpha, beta, out, n, stream);
}

}  // extern "C"
