// Dense mat-vec kernels for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernels of cgx/ops/matvec.py:
//   dense_matvec      (_matvec_kernel, pallas_call at matvec.py:88)
//   dense_matvec_dot  (_matvec_dot_kernel, pallas_call at matvec.py:163)
//
//   y[i] = sum over column tiles j, in ascending order, of
//          sum_{c in tile j} a[i*n_cols + c] * x[c]
//   dot  = sum over row tiles t, in ascending order, of
//          sum_{i in tile t, i < n_cols} x[i] * y[i]      (dense_matvec_dot only)
//
// block_cols and block_rows fix this summation grouping, as the TPU kernel's
// grid did (it accumulated y across the column-tile axis and the dot across
// the row-tile axis, in order). They do not set the CTA shape: the CLI maps the
// reference's "1024 16" to 1024 x 128 tiles, and a 1024-row CTA would leave 10
// CTAs for N = 10,000 on a card with 132 SMs.
//
// Bound: memory. One multiply-add per element of A read: N^2 words for a
// square A (400 MB in float at N = 10,000, 119 us at 3.35 TB/s), against
// which x and y are negligible.
//
// Design: one warp per row, in a grid-stride loop over rows. Within a column
// tile the 32 lanes stride along the contiguous row (coalesced loads), each
// lane sums its elements in order, a shuffle tree sums the lanes, and lane 0
// adds the tile sums in column-tile order in a register. x is re-read by every
// row and comes from L2. The reference merged tile partials with atomicAdd;
// there are no float atomics here: dense_matvec_dot writes x[i]*y[i] per row,
// and the last block to take the integer ticket sums them per row tile and the
// tile sums in order, so every result is bitwise repeatable. Bounds are tested
// in the kernel, so A and x are read in place with no padded copy. No tensor
// cores: their float path is TF32, which the solver's precision rule forbids.
#include "common.cuh"

namespace cgx {

constexpr int kWarps = kThreads / 32;  // rows in flight per block
constexpr long long kMaxRowBlocks = 65535;

inline int row_grid(long long n_rows) {
  long long blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  return static_cast<int>(blocks);
}

// y[row] by the grouping above; valid in lane 0. All 32 lanes must call it.
template <typename T>
__device__ __forceinline__ T dense_row(const T* __restrict__ a, const T* __restrict__ x,
                                       long long n_cols, long long block_cols, long long row,
                                       int lane) {
  const T* __restrict__ arow = a + row * n_cols;
  T acc = T(0);
  for (long long c0 = 0; c0 < n_cols; c0 += block_cols) {
    const long long c1 = c0 + block_cols < n_cols ? c0 + block_cols : n_cols;
    T part = T(0);
#pragma unroll 4
    for (long long c = c0 + lane; c < c1; c += 32) part += arow[c] * x[c];
    acc += warp_sum(part);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_matvec_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y,
                    long long n_rows, long long n_cols, long long block_cols) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < n_rows; row += stride) {
    const T v = dense_row(a, x, n_cols, block_cols, row, lane);
    if (lane == 0) y[row] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_matvec_dot_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y,
                        T* __restrict__ prods, T* __restrict__ tile_sums,
                        unsigned int* __restrict__ ticket, T* __restrict__ dot, long long n_rows,
                        long long n_cols, long long block_rows, long long block_cols) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < n_rows;
       row += stride) {
    const T v = dense_row(a, x, n_cols, block_cols, row, lane);
    if (lane == 0) {
      y[row] = v;
      prods[row] = row < n_cols ? x[row] * v : T(0);
    }
  }
  __threadfence();  // this block's products are visible before its ticket is taken
  __syncthreads();
  __shared__ bool is_last;
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const volatile T* p = prods;  // written by other SMs: bypass L1
  const long long tiles = (n_rows + block_rows - 1) / block_rows;
  for (long long t = warp; t < tiles; t += kWarps) {
    const long long r1 = (t + 1) * block_rows < n_rows ? (t + 1) * block_rows : n_rows;
    T s = T(0);
    for (long long i = t * block_rows + lane; i < r1; i += 32) s += p[i];
    s = warp_sum(s);
    if (lane == 0) tile_sums[t] = s;
  }
  __syncthreads();  // the tile sums of all warps are visible to thread 0
  if (threadIdx.x == 0) {
    const volatile T* ts = tile_sums;
    T d = T(0);
    for (long long t = 0; t < tiles; ++t) d += ts[t];
    *dot = d;
    *ticket = 0u;
  }
}

static bool bad_shape(long long n_rows, long long n_cols, long long block_rows,
                      long long block_cols) {
  return n_rows < 0 || n_cols < 0 || block_rows < 1 || block_cols < 1;
}

template <typename T>
static int launch_matvec(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, void* stream) {
  if (bad_shape(n_rows, n_cols, 1, block_cols)) return static_cast<int>(cudaErrorInvalidValue);
  dense_matvec_kernel<T><<<row_grid(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y), n_rows, n_cols,
      block_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_matvec_dot(const void* a, const void* x, void* y, void* prods, void* tile_sums,
                             void* ticket, void* dot, long long n_rows, long long n_cols,
                             long long block_rows, long long block_cols, void* stream) {
  if (bad_shape(n_rows, n_cols, block_rows, block_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  dense_matvec_dot_kernel<T>
      <<<row_grid(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y),
          static_cast<T*>(prods), static_cast<T*>(tile_sums), static_cast<unsigned int*>(ticket),
          static_cast<T*>(dot), n_rows, n_cols, block_rows, block_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx

extern "C" {

int cgx_dense_matvec_f32(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, void* stream) {
  return cgx::launch_matvec<float>(a, x, y, n_rows, n_cols, block_cols, stream);
}

int cgx_dense_matvec_f64(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, void* stream) {
  return cgx::launch_matvec<double>(a, x, y, n_rows, n_cols, block_cols, stream);
}

int cgx_dense_matvec_dot_f32(const void* a, const void* x, void* y, void* prods, void* tile_sums,
                             void* ticket, void* dot, long long n_rows, long long n_cols,
                             long long block_rows, long long block_cols, void* stream) {
  return cgx::launch_matvec_dot<float>(a, x, y, prods, tile_sums, ticket, dot, n_rows, n_cols,
                                       block_rows, block_cols, stream);
}

int cgx_dense_matvec_dot_f64(const void* a, const void* x, void* y, void* prods, void* tile_sums,
                             void* ticket, void* dot, long long n_rows, long long n_cols,
                             long long block_rows, long long block_cols, void* stream) {
  return cgx::launch_matvec_dot<double>(a, x, y, prods, tile_sums, ticket, dot, n_rows, n_cols,
                                        block_rows, block_cols, stream);
}

}  // extern "C"
