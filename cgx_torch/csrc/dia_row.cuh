// One row of the banded (DIA) product, shared by dia_spmv.cu and cg_kernel.cu.
//
//   y[i] = sum_d bands[d*n + i] * x[i + off_d]   (terms with i + off_d outside [0, n) are 0)
//
// x carries no __restrict__: the whole-solve kernel of cg_kernel.cu rewrites the
// vector it reads here between grid syncs, so its loads must stay coherent ones.
#pragma once

#include <cuda_runtime.h>

namespace cgx {

constexpr int kMaxDiags = 16;

struct Offsets {
  long long off[kMaxDiags];
  int ndiag;
};

template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ bands, const T* x, long long n,
                                     const Offsets& o, long long i) {
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {  // static indices keep o in the parameter bank
    if (d < o.ndiag) {
      const long long j = i + o.off[d];
      if (j >= 0 && j < n) acc += bands[d * n + i] * x[j];
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
