// The s-step matrix-powers kernel for Hopper (sm_90a): the whole (2s+1, n)
// Krylov basis [T_0..T_s(A)p, T_0..T_{s-1}(A)r] of a banded operator in one
// launch.
//
// Replaces the Pallas TPU kernel of cgx/ops/dia_powers.py:
//   dia_sstep_basis_planes (_powers_kernel, pallas_call at dia_powers.py:299)
// cgx streams halo'd windows of p, r and the bands through VMEM and runs the s
// applications there, each shrinking the trustworthy window by p_rows rows.
// Here each block owns one contiguous slab of rows and generates every level
// of it with the generator of sstep_basis.cuh, in one of two designs, which
// cgx_torch.ops.dia_powers.basis_plan picks by the size rule of the fused
// s-step block and the wrapper records:
// - "wavefront" (powers_wave_kernel), where the levels' rings fit the shared
//   memory of one block an SM: gen_wave keeps every level in a ring in shared
//   memory, and the consumer stores each level's rows of the slab, 512
//   consecutive rows a level a step, so only the basis itself leaves the chip.
// - "slab" (powers_kernel), elsewhere (float64 at R = 3200, s > 4): two blocks
//   an SM, each level over a window that shrinks by R = max |offset| rows an
//   application, the two working levels of a chain in a block-private scratch
//   in device memory, a latency-bound pass a level.
// Each level is formed by the plain version's operations in its order, so the
// basis equals cgx_torch.ops.dia_powers.dia_sstep_basis_ref bit for bit.
//
// Vectors: float, double and bfloat16 (the _bf16 entries, the bands in
// bfloat16 too, cgx's kernel being dtype-generic): on bfloat16 each operation
// rounds to bfloat16 right after it (sstep_basis.cuh), as the plain version's
// does.
//
// Bound: memory. The function must read the bands and p and r once and write
// the basis: (ndiag + 2 + 2s + 1) N values, the basis most of them. The
// wavefront reads p and r once and the bands once an application, from L2
// for all but the first (a block's window of them is a few thousand rows);
// the slab design reads the bands again for each of the 2s - 1 applications
// and each working level out and back through the scratch, and evaluates the
// halo rows again (1.2x at N = 10,240,000).
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

// B9's consumer of gen_wave: thread jj stores every level's value at frontier
// row first + jj, if the row is the slab's, from the rings to out[l n + row].
// (Storing each value from registers as it is formed, with the same rings,
// ran slower on the H100.)
template <typename T, int S>
struct StoreRows : WaveUse {
  static constexpr int kM = 2 * S + 1;
  const WavePlan* pl;
  const T* ring;
  T* out;
  long long n, t0, t1;

  __device__ __forceinline__ void operator()(long long first, const WaveSlots* sl) {
    const long long row = first + threadIdx.x;
    if (row < t0 || row >= t1) return;
#pragma unroll
    for (int l = 0; l < kM; ++l) out[l * n + row] = wave_at(*pl, ring, sl, l, threadIdx.x);
  }
};

// One block an SM (the grid of basis_plan); 512 threads of at most 128
// registers.
template <typename T, int S, int ND>
__global__ void __launch_bounds__(kWaveThreads, 1)
    powers_wave_kernel(const __grid_constant__ Basis<T, T> a,
                       const __grid_constant__ WavePlan pl,  // read in place, never copied
                       const T* __restrict__ p, const T* __restrict__ r, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WaveSlots slots[2][kWaveMaxM];
  StoreRows<T, S> rows;
  rows.pl = &pl;
  rows.ring = reinterpret_cast<const T*>(smem);
  rows.out = out;
  rows.n = a.n;
  for (long long t0 = static_cast<long long>(blockIdx.x) * pl.slab; t0 < a.n;
       t0 += static_cast<long long>(gridDim.x) * pl.slab) {
    rows.t0 = t0;
    rows.t1 = t0 + pl.slab < a.n ? t0 + pl.slab : a.n;
    gen_wave<S, ND>(a, pl, p, r, reinterpret_cast<T*>(smem), t0, rows.t1, slots, rows);
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

template <typename T>
static int launch_powers_wave(const void* bands, const void* p, const void* r, void* out,
                              long long n, const long long* offsets, int ndiag, int s,
                              double theta, double delta, const double* shifts, int nshifts,
                              const long long* plan, int plan_len, int grid, void* stream) {
  Basis<T, T> a;
  WavePlan pl;
  if (!make_basis(&a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      !make_wave_plan<T>(&pl, plan, plan_len, s, n, a.reach, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* pp = static_cast<const T*>(p);
  const T* rr = static_cast<const T*>(r);
  T* o = static_cast<T*>(out);
  return wave_dispatch(s, offsets, ndiag, [&](auto S, auto ND) {
    return wave_launch<powers_wave_kernel<T, decltype(S)::value, decltype(ND)::value>>(
        grid, plan[3], stream, a, pl, pp, rr, o);
  });
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

#define CGX_POWERS_WAVE_ENTRY(NAME, T)                                                       \
  int NAME(const void* bands, const void* p, const void* r, void* out, long long n,          \
           const long long* offsets, int ndiag, int s, double theta, double delta,           \
           const double* shifts, int nshifts, const long long* plan, int plan_len, int grid, \
           void* stream) {                                                                   \
    return cgx::launch_powers_wave<T>(bands, p, r, out, n, offsets, ndiag, s, theta, delta,  \
                                      shifts, nshifts, plan, plan_len, grid, stream);        \
  }

CGX_POWERS_ENTRY(cgx_dia_sstep_basis_f32, float)
CGX_POWERS_ENTRY(cgx_dia_sstep_basis_f64, double)
CGX_POWERS_ENTRY(cgx_dia_sstep_basis_bf16, cgx::bf16)
CGX_POWERS_WAVE_ENTRY(cgx_dia_sstep_basis_wave_f32, float)
CGX_POWERS_WAVE_ENTRY(cgx_dia_sstep_basis_wave_f64, double)
CGX_POWERS_WAVE_ENTRY(cgx_dia_sstep_basis_wave_bf16, cgx::bf16)

#undef CGX_POWERS_ENTRY
#undef CGX_POWERS_WAVE_ENTRY

}  // extern "C"
