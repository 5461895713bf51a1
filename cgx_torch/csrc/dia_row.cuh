// One row of the banded (DIA) product, shared by dia_spmv.cu, cg_kernel.cu and
// cg_stream.cu.
//
//   y[i] = sum_d bands[d*n + i] * x[i + off_d]   (terms with i + off_d outside [0, n) are 0)
//
// The bands may be stored in a narrower type than the vectors (bfloat16 or
// float16 bands under float vectors): each band value is widened exactly to the
// vector type as it is loaded, so the product is the one of the widened bands.
// With the bands in the vectors' own type the code is what it was before, bit
// for bit; that
// includes bfloat16 vectors (cgx::bf16, bf16.cuh), whose product and sum each
// round to bfloat16.
//
// x carries no __restrict__: the whole-solve kernel of cg_kernel.cu rewrites the
// vector it reads here between grid syncs, so its loads must stay coherent ones.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "bf16.cuh"

namespace cgx {

constexpr int kMaxDiags = 16;

struct Offsets {
  long long off[kMaxDiags];
  int ndiag;
};

// A band value in the vectors' type: exact for each pair the kernels take.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ bf16 widen(bf16 v) { return v; }

template <typename T, typename B>
__device__ __forceinline__ T dia_row(const B* __restrict__ bands, const T* x, long long n,
                                     const Offsets& o, long long i) {
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {  // static indices keep o in the parameter bank
    if (d < o.ndiag) {
      const long long j = i + o.off[d];
      if (j >= 0 && j < n) acc += widen(bands[d * n + i]) * x[j];
    }
  }
  return acc;
}

inline bool make_offsets(const long long* offsets, int ndiag, Offsets* o) {
  if (ndiag < 1 || ndiag > kMaxDiags) return false;
  for (int d = 0; d < kMaxDiags; ++d) o->off[d] = d < ndiag ? offsets[d] : 0;
  o->ndiag = ndiag;
  return true;
}

}  // namespace cgx
