// The s-step matrix-powers kernel for Hopper (sm_90a): the whole (2s+1, n)
// Krylov basis [T_0..T_s(A)p, T_0..T_{s-1}(A)r] of a banded operator in one
// launch.
//
// Replaces the Pallas TPU kernel of cgx/ops/dia_powers.py:
//   dia_sstep_basis_planes (_powers_kernel, pallas_call at dia_powers.py:299)
// cgx streams halo'd windows of p, r and the bands through VMEM and runs the s
// applications there, each shrinking the trustworthy window by p_rows rows.
// Here each block of a grid of a few blocks an SM owns one contiguous slab of
// rows; the generator of sstep_basis.cuh builds every level over a window that
// shrinks by R = max |offset| rows an application, the two working levels of a
// chain in a block-private scratch in device memory, and writes the slab's rows
// of all 2s+1 levels. Each level is formed by
// the plain version's operations in its order, so the basis equals
// cgx_torch.ops.dia_powers.dia_sstep_basis_ref bit for bit.
//
// Bound: memory. The function must read the bands and p and r once and write
// the basis: (ndiag + 2 + 2s + 1) N values. The kernel reads the bands again
// for each of the 2s - 1 applications and each working level out and back
// through the scratch, and evaluates the halo rows again (1.2x at
// N = 10,240,000): several times the bound's traffic.
#include "common.cuh"
#include "sstep_basis.cuh"

namespace cgx {

template <typename T>
struct OutSink {
  T* out;
  long long n;
  __device__ void operator()(int level, long long j, T v) { out[level * n + j] = v; }
};

template <typename T, typename B>
__global__ void __launch_bounds__(kBasisThreads, 2)
    powers_kernel(Basis<T, B> a, const T* __restrict__ p, const T* __restrict__ r, T* out,
                  T* scratch, long long half, long long tile) {
  T* buf0 = scratch + static_cast<long long>(blockIdx.x) * 2 * half;
  T* buf1 = buf0 + half;
  OutSink<T> sink{out, a.n};
  for (long long t0 = static_cast<long long>(blockIdx.x) * tile; t0 < a.n;
       t0 += static_cast<long long>(gridDim.x) * tile) {
    const long long t1 = t0 + tile < a.n ? t0 + tile : a.n;
    gen_chain(a, p, a.s + 1, 0, t0, t1, buf0, buf1, sink);
    gen_chain(a, r, a.s, a.s + 1, t0, t1, buf0, buf1, sink);
  }
}

template <typename T>
static int launch_powers(const void* bands, const void* p, const void* r, void* out,
                         void* scratch, long long scratch_len, long long n,
                         const long long* offsets, int ndiag, int s, double theta, double delta,
                         const double* shifts, int nshifts, long long tile, int grid,
                         void* stream) {
  Basis<T, T> a;
  if (!make_basis(&a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) || tile < 1 ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need = basis_scratch(tile, a.reach, s);
  if (scratch_len < need * grid) return static_cast<int>(cudaErrorInvalidValue);
  powers_kernel<T, T><<<grid, kBasisThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(p), static_cast<const T*>(r), static_cast<T*>(out),
      static_cast<T*>(scratch), need / 2, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx

extern "C" {

#define CGX_POWERS_ENTRY(NAME, T)                                                              \
  int NAME(const void* bands, const void* p, const void* r, void* out, void* scratch,          \
           long long scratch_len, long long n, const long long* offsets, int ndiag, int s,    \
           double theta, double delta, const double* shifts, int nshifts, long long tile,     \
           int grid, void* stream) {                                                          \
    return cgx::launch_powers<T>(bands, p, r, out, scratch, scratch_len, n, offsets, ndiag, s, \
                                 theta, delta, shifts, nshifts, tile, grid, stream);          \
  }

CGX_POWERS_ENTRY(cgx_dia_sstep_basis_f32, float)
CGX_POWERS_ENTRY(cgx_dia_sstep_basis_f64, double)

#undef CGX_POWERS_ENTRY

}  // extern "C"
