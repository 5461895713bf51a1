// Shared launch shape and deterministic reductions for the cgx_torch kernels.
//
// A TPU grid runs its steps in order, so the Pallas kernels could carry a dot
// product across grid steps in SMEM. CUDA blocks run concurrently and in no
// order. Here each block reduces its share with warp shuffles, writes one
// partial, and the last block to finish (found with an integer ticket) sums the
// partials in index order. No float atomics: the combine order is fixed by the
// launch shape alone, so a dot, and every alpha and beta that depends on it, is
// the same on every run.
#pragma once

#include <cuda_runtime.h>

// A source that _build.py splits (its _SPLIT) compiles once per entry
// suffix, with -DCGX_PART_F32, _F64, _F32_BF16B, _F32_F16B or _BF16, and its
// library holds that suffix's entries only: the template instantiations build
// on several cores at once. With no such define a source holds them all.
#if !defined(CGX_PART_F32) && !defined(CGX_PART_F64) && !defined(CGX_PART_F32_BF16B) && \
    !defined(CGX_PART_F32_F16B) && !defined(CGX_PART_BF16)
#define CGX_PART_F32
#define CGX_PART_F64
#define CGX_PART_F32_BF16B
#define CGX_PART_F32_F16B
#define CGX_PART_BF16
#endif

namespace cgx {

constexpr int kThreads = 256;     // threads per block
constexpr int kMaxBlocks = 1024;  // grid-stride loops cover any n with at most this many blocks
constexpr int kSharedOptin = 232448;  // bytes of shared memory a block may take on the H100

// Lets kernel K take all the dynamic shared memory a block may have beside
// its static shared memory: set once per kernel and process (one device a
// process), not on every launch, which the host loops would pay for. Returns
// the setting's error.
template <auto K>
cudaError_t allow_shared() {
  static const cudaError_t err = [] {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, K);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSharedOptin - static_cast<int>(attr.sharedSizeBytes));
  }();
  return err;
}

inline int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the warp's sum
}

// Sum of v over a block of at most NT threads (whole warps), in a fixed order:
// a shuffle tree a warp, then one over the warps' sums; the result is valid in
// thread 0. Every thread of the block must call it.
template <typename T, int NT = kThreads>
__device__ T block_sum(T v) {
  static_assert(NT % 32 == 0 && NT <= 1024, "a block of whole warps");
  __shared__ T warp_part[NT / 32];
  __syncthreads();  // an earlier call may still be reading warp_part
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  T s = T(0);
  if (warp == 0) {
    s = lane < static_cast<int>(blockDim.x >> 5) ? warp_part[lane] : T(0);
    s = warp_sum(s);
  }
  return s;
}

// Writes this block's partial, and lets the last block to arrive sum all
// partials in index order into *out. *ticket must be 0 at launch; the last
// block sets it back to 0. block_total is read from thread 0 only.
template <typename T>
__device__ void grid_sum(T block_total, T* partials, unsigned int* ticket, T* out) {
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block_total;
    __threadfence();  // the partial is visible before the ticket is taken
    const unsigned int arrived = atomicAdd(ticket, 1u);
    is_last = arrived == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const volatile T* parts = partials;  // written by other SMs: bypass L1
  T v = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x) v += parts[i];
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *out = v;
    *ticket = 0u;
  }
}

}  // namespace cgx
