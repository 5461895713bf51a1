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
// dense_matvec (dense_matvec_persistent_kernel): a persistent grid, planned on
// the host (cgx_torch.ops.matvec.dense_plan): one block an SM, each owning one
// equal contiguous range of rows, so there is no tail wave. A block stages x
// in shared memory once, by asynchronous copies (80 KB in double at
// N = 10,000; where x and the tile sums do not fit the 227 KB a block may
// take, by column chunks of whole tiles; with a tile wider than that, x is
// read in place). Its work, its
// rows' runs of eight neighbouring tiles, is dealt to its 16 warps evenly
// whatever the number of rows. A warp takes eight neighbouring tiles of a row at once and
// streams them with 16-byte loads, one a lane and a tile before it multiplies:
// 128 bytes a lane in flight. Each lane sums its vectors of a tile in order,
// eight independent shuffle trees sum the lanes, and each tile's sum goes to
// shared memory; one thread a row then adds the row's tile sums
// in column-tile order. Rows whose starts are not 16-byte aligned (n_cols *
// size not a multiple of 16) take the peeled path: a scalar head up to the
// first aligned column, the vectors, a scalar tail; x is then read a value at
// a time.
//
// dense_matvec_dot: the same kernel with a dot epilogue (DOT), so its y is
// bitwise dense_matvec's. Where a row's sum is written, the block also writes
// x[i]*y[i] (0 past n_cols); the last block to take the integer ticket sums
// them per row tile (one warp a tile: lanes strided, then a shuffle tree) and
// the tile sums in order, so every result is bitwise repeatable. The
// reference merged tile partials with atomicAdd; there are no float atomics
// here. Bounds are tested in the kernel, so A and x are read in place with no
// padded copy. No tensor cores: their float path is TF32, which the solver's
// precision rule forbids. The design before this one ran the dot on one warp a
// row (lanes strided along each tile), which grouped a tile's products
// otherwise than dense_matvec, so the two gave different y; it took 0.3189 ms
// in double at N = 10,000 on an H100 (PERF.md).
#include "common.cuh"

namespace cgx {

constexpr int kDenseThreads = 512;  // cgx_torch.ops.matvec.DENSE_THREADS; one block an SM
constexpr int kDenseUnits = 8;      // neighbouring tiles of a row a warp works on at once

template <typename T>
struct Vec16;  // 16 bytes of T
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// p + a . x, element by element in order
__device__ __forceinline__ float vdot(float p, float4 a, float4 x) {
  p += a.x * x.x;
  p += a.y * x.y;
  p += a.z * x.z;
  p += a.w * x.w;
  return p;
}
__device__ __forceinline__ double vdot(double p, double2 a, double2 x) {
  p += a.x * x.x;
  p += a.y * x.y;
  return p;
}
__device__ __forceinline__ float vdot(float p, float4 a, const float* x) {
  p += a.x * x[0];
  p += a.y * x[1];
  p += a.z * x[2];
  p += a.w * x[3];
  return p;
}
__device__ __forceinline__ double vdot(double p, double2 a, const double* x) {
  p += a.x * x[0];
  p += a.y * x[1];
  return p;
}

// This lane's partial of row arow over columns [c0, c1) on the peeled path:
// head, vectors in order, tail. xs[c] is x's value at column c.
template <typename T>
__device__ __forceinline__ T peeled_part(const T* __restrict__ arow, const T* xs, long long c0,
                                         long long c1, int lane) {
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
  const long long mis = (reinterpret_cast<unsigned long long>(arow + c0) % 16) / sizeof(T);
  long long head = mis ? VN - mis : 0;
  if (head > c1 - c0) head = c1 - c0;
  const long long nvec = (c1 - c0 - head) / VN;
  const long long cb = c0 + head + nvec * VN;
  T p = T(0);
  if (lane < head) p += arow[c0 + lane] * xs[c0 + lane];
  const V* av = reinterpret_cast<const V*>(arow + c0 + head);
  for (long long v = lane; v < nvec; v += 32) p = vdot(p, __ldg(av + v), xs + c0 + head + v * VN);
  if (lane < c1 - cb) p += arow[cb + lane] * xs[cb + lane];
  return p;
}

__host__ __device__ inline long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// Shared bytes of a block: the staged x chunk, the tile partials of its rows
// over a chunk, and its rows' running sums.
__host__ __device__ inline long long dense_shared(long long chunk_cols, long long chunk_tiles,
                                                  long long rows, long long size, int staged) {
  return (staged ? align16(chunk_cols * size) : 0) + align16(rows * chunk_tiles * size) +
         rows * size;
}

// The warp's sums of v[0..7]: lane i ends with the sum of v[t] over the 32
// lanes for tile t = its lane bits 4, 3, 2 (read as 4, 2, 1), by recursive
// halving: 9 shuffles for the 8 sums, against 40 for 8 trees. Each sum is
// formed in a fixed order, in every lane that holds it alike.
template <typename T>
__device__ __forceinline__ T transpose_sum8(const T (&v)[8], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  T a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T send = h4 ? v[i] : v[i + 4], keep = h4 ? v[i + 4] : v[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T send = h3 ? a[i] : a[i + 2], keep = h3 ? a[i + 2] : a[i];
    b[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const T send = h2 ? b[0] : b[1], keep = h2 ? b[1] : b[0];
  T c = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  c = c + __shfl_xor_sync(0xffffffffu, c, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// A warp's span of kDenseUnits neighbouring tiles of a row: the row in the
// block, and the span's first tile in the chunk.
struct Span {
  unsigned row;
  long long tile;
};

// y = A x by the grouping above. Block b owns rows [b rows_per_cta, + rows_per_cta).
// Columns go by chunks of chunk_cols (whole tiles; n_cols in one chunk where all
// fits): x's chunk is staged in shared memory (staged = 0 reads x in place), the
// warps take kDenseUnits neighbouring tiles of a row at a time, and write each
// tile's sum to shared memory; then one thread a row adds them, in tile order, to
// the row's running sum. ALIGNED: every row start, tile and chunk is 16-byte aligned.
// DOT: where a row's sum is written, also prods[i] = x[i] * y[i] (0 past n_cols).
template <typename T, bool ALIGNED, bool DOT>
__device__ __forceinline__ void dense_rows(const T* __restrict__ a, const T* __restrict__ x,
                                           T* __restrict__ y, long long n_rows,
                                           long long n_cols, long long block_cols,
                                           long long chunk_cols, long long rows_per_cta,
                                           int staged, T* __restrict__ prods) {
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
  constexpr int G = kDenseUnits;
  static_assert(G == 8, "transpose_sum8 sums eight tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  if (r0 >= n_rows) return;  // the whole block
  const long long rows = r0 + rows_per_cta < n_rows ? rows_per_cta : n_rows - r0;
  const long long max_tiles = (chunk_cols + block_cols - 1) / block_cols;
  T* xsh = reinterpret_cast<T*>(smem);
  T* tsum = reinterpret_cast<T*>(smem + (staged ? align16(chunk_cols * sizeof(T)) : 0));
  T* run = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(tsum) +
                                align16(rows * max_tiles * sizeof(T)));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int mine = (lane & 16 ? 4 : 0) + (lane & 8 ? 2 : 0) + (lane & 4 ? 1 : 0);
  if (n_cols == 0)
    for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
      y[r0 + r] = T(0);
      if (DOT) prods[r0 + r] = T(0);
    }
  for (long long k0 = 0; k0 < n_cols; k0 += chunk_cols) {
    const long long k1 = k0 + chunk_cols < n_cols ? k0 + chunk_cols : n_cols;
    const long long tiles = (k1 - k0 + block_cols - 1) / block_cols;
    const T* xs = staged ? xsh - k0 : x;  // xs[c] for c in [k0, k1)
    __syncthreads();  // the last chunk's x and tile sums are no longer read
    if (staged) {
      if (ALIGNED) {  // 16-byte asynchronous copies, waited for below
        for (long long v = threadIdx.x; v < (k1 - k0) / VN; v += blockDim.x) {
          const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(xsh + v * VN));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                       "l"(x + k0 + v * VN));
        }
      } else {
        for (long long c = k0 + threadIdx.x; c < k1; c += blockDim.x) xsh[c - k0] = x[c];
      }
    }
    const unsigned spans = static_cast<unsigned>((tiles + G - 1) / G);  // spans a row
    const unsigned groups = static_cast<unsigned>(rows) * spans;
    auto span_of = [&](unsigned q) {
      const unsigned r = q / spans;
      return Span{r, static_cast<long long>(q - r * spans) * G};
    };
    auto put = [&](const T (&part)[G], const Span& sp) {
      const T sum = transpose_sum8(part, lane);
      if ((lane & 3) == 0 && sp.tile + mine < tiles) tsum[sp.row * tiles + sp.tile + mine] = sum;
    };
    if (ALIGNED) {
      const long long full = block_cols / VN;  // vectors of a whole tile
      const long long last = (k1 - (k0 + (tiles - 1) * block_cols)) / VN;  // of the last tile
      const long long nr = (full + 31) / 32;  // rounds of a span: a vector a lane and tile each
      auto nvec = [&](long long t) { return t < tiles - 1 ? full : (t == tiles - 1 ? last : 0); };
      auto load = [&](unsigned q, long long j, V (&dst)[G]) {
        const Span sp = span_of(q);
        const V* av0 = reinterpret_cast<const V*>(a + (r0 + sp.row) * n_cols + k0 +
                                                  sp.tile * block_cols);
        const long long v = lane + 32 * j;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (v < nvec(sp.tile + g)) dst[g] = __ldg(av0 + g * full + v);
      };
      // rounds (span q, j) in order; the next round's loads issue before this
      // round's products and sums
      unsigned q = warp;
      long long j = 0;
      V cur[G], nxt[G];
      T part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = T(0);
      if (q < groups) load(q, 0, cur);  // A's first round flies while x arrives
      if (staged) asm volatile("cp.async.wait_all;" ::);
      __syncthreads();  // x is staged
      while (q < groups) {
        unsigned qn = q;
        long long jn = j + 1;
        if (jn == nr) {
          jn = 0;
          qn = q + nwarps;
        }
        if (qn < groups) load(qn, jn, nxt);
        const Span sp = span_of(q);
        const T* xv0 = xs + k0 + sp.tile * block_cols;
        const long long v = lane + 32 * j;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (v < nvec(sp.tile + g))
            part[g] = vdot(part[g], cur[g], *reinterpret_cast<const V*>(xv0 + (g * full + v) * VN));
        if (jn == 0) {
          put(part, sp);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] = T(0);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) cur[g] = nxt[g];
        q = qn;
        j = jn;
      }
    } else {
      __syncthreads();  // x is staged
      for (unsigned q = warp; q < groups; q += nwarps) {
        const Span sp = span_of(q);
        const T* arow = a + (r0 + sp.row) * n_cols;
        T part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const long long c0 = k0 + (sp.tile + g) * block_cols;
          const long long c1 = c0 + block_cols < k1 ? c0 + block_cols : k1;
          part[g] = sp.tile + g < tiles ? peeled_part(arow, xs, c0, c1, lane) : T(0);
        }
        put(part, sp);
      }
    }
    __syncthreads();  // every tile sum of the chunk is in shared memory
    for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
      T acc = k0 == 0 ? T(0) : run[r];
      for (long long t = 0; t < tiles; ++t) acc += tsum[r * tiles + t];
      if (k1 == n_cols) {
        y[r0 + r] = acc;
        if (DOT) prods[r0 + r] = r0 + r < n_cols ? x[r0 + r] * acc : T(0);
      } else {
        run[r] = acc;
      }
    }
  }
}

// dense_matvec_dot's outputs and scratch (unused by dense_matvec).
template <typename T>
struct DenseDot {
  T* prods;              // x[i] * y[i] a row
  T* tile_sums;          // one a row tile
  unsigned int* ticket;  // 0 at launch; the last block sets it back to 0
  T* dot;
  long long block_rows;
};

// y = A x on the persistent grid; with DOT also <x, y>: the last block to take
// the ticket sums the products per row tile (a warp a tile) and the tile sums
// in order.
template <typename T, bool ALIGNED, bool DOT>
__global__ void __launch_bounds__(kDenseThreads, 1)
dense_matvec_persistent_kernel(const T* __restrict__ a, const T* __restrict__ x,
                               T* __restrict__ y, long long n_rows, long long n_cols,
                               long long block_cols, long long chunk_cols,
                               long long rows_per_cta, int staged, DenseDot<T> dd) {
  dense_rows<T, ALIGNED, DOT>(a, x, y, n_rows, n_cols, block_cols, chunk_cols, rows_per_cta,
                              staged, dd.prods);
  if constexpr (DOT) {
    __threadfence();  // this block's products are visible before its ticket is taken
    __syncthreads();
    __shared__ bool is_last;
    if (threadIdx.x == 0) is_last = atomicAdd(dd.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const volatile T* p = dd.prods;  // written by other SMs: bypass L1
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const long long tiles = (n_rows + dd.block_rows - 1) / dd.block_rows;
    for (long long t = warp; t < tiles; t += nwarps) {
      const long long r1 = (t + 1) * dd.block_rows < n_rows ? (t + 1) * dd.block_rows : n_rows;
      T s = T(0);
      for (long long i = t * dd.block_rows + lane; i < r1; i += 32) s += p[i];
      s = warp_sum(s);
      if (lane == 0) dd.tile_sums[t] = s;
    }
    __syncthreads();  // the tile sums of all warps are visible to thread 0
    if (threadIdx.x == 0) {
      const volatile T* ts = dd.tile_sums;
      T d = T(0);
      for (long long t = 0; t < tiles; ++t) d += ts[t];
      *dd.dot = d;
      *dd.ticket = 0u;
    }
  }
}

static bool bad_shape(long long n_rows, long long n_cols, long long block_rows,
                      long long block_cols) {
  return n_rows < 0 || n_cols < 0 || block_rows < 1 || block_cols < 1;
}

// The plan of cgx_torch.ops.matvec.dense_plan. Refused unless the grid's row
// ranges cover the rows, chunks hold whole tiles, x fits the shared bytes when
// staged, and the aligned path's rows, tiles and pointers are 16-byte aligned.
// With DOT the kernel also runs on n_rows = 0 (the dot is 0).
template <typename T, bool DOT>
static int launch_matvec(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, long long chunk_cols,
                         long long rows_per_cta, int staged, int aligned, int shared, int grid,
                         DenseDot<T> dd, void* stream) {
  const long long sz = sizeof(T);
  if (bad_shape(n_rows, n_cols, DOT ? dd.block_rows : 1, block_cols) || grid < 1 ||
      rows_per_cta < 1 || rows_per_cta * grid < n_rows || chunk_cols < 1 ||
      (chunk_cols < n_cols && chunk_cols % block_cols != 0) ||
      shared < dense_shared(chunk_cols, (chunk_cols + block_cols - 1) / block_cols,
                            rows_per_cta, sz, staged) ||
      (aligned && ((n_cols * sz) % 16 != 0 || (block_cols * sz) % 16 != 0 ||
                   reinterpret_cast<unsigned long long>(a) % 16 != 0 ||
                   (!staged && reinterpret_cast<unsigned long long>(x) % 16 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 && !DOT) return static_cast<int>(cudaSuccess);
  const auto launch = [&](auto kernel, cudaError_t allowed) {
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    kernel<<<grid, kDenseThreads, shared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y), n_rows, n_cols,
        block_cols, chunk_cols, rows_per_cta, staged, dd);
    return static_cast<int>(cudaGetLastError());
  };
  return aligned ? launch(dense_matvec_persistent_kernel<T, true, DOT>,
                          allow_shared<dense_matvec_persistent_kernel<T, true, DOT>>())
                 : launch(dense_matvec_persistent_kernel<T, false, DOT>,
                          allow_shared<dense_matvec_persistent_kernel<T, false, DOT>>());
}

template <typename T>
static DenseDot<T> dense_dot(void* prods, void* tile_sums, void* ticket, void* dot,
                             long long block_rows) {
  return DenseDot<T>{static_cast<T*>(prods), static_cast<T*>(tile_sums),
                     static_cast<unsigned int*>(ticket), static_cast<T*>(dot), block_rows};
}

}  // namespace cgx

extern "C" {

int cgx_dense_matvec_f32(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, long long chunk_cols,
                         long long rows_per_cta, int staged, int aligned, int shared, int grid,
                         void* stream) {
  return cgx::launch_matvec<float, false>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,
                                          rows_per_cta, staged, aligned, shared, grid, {},
                                          stream);
}

int cgx_dense_matvec_f64(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, long long chunk_cols,
                         long long rows_per_cta, int staged, int aligned, int shared, int grid,
                         void* stream) {
  return cgx::launch_matvec<double, false>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,
                                           rows_per_cta, staged, aligned, shared, grid, {},
                                           stream);
}

// dense_matvec's arguments, then the products (n_rows), the tile sums (one a
// row tile), the ticket (0), the dot and the row tile.
int cgx_dense_matvec_dot_f32(const void* a, const void* x, void* y, long long n_rows,
                             long long n_cols, long long block_cols, long long chunk_cols,
                             long long rows_per_cta, int staged, int aligned, int shared,
                             int grid, void* prods, void* tile_sums, void* ticket, void* dot,
                             long long block_rows, void* stream) {
  return cgx::launch_matvec<float, true>(
      a, x, y, n_rows, n_cols, block_cols, chunk_cols, rows_per_cta, staged, aligned, shared,
      grid, cgx::dense_dot<float>(prods, tile_sums, ticket, dot, block_rows), stream);
}

int cgx_dense_matvec_dot_f64(const void* a, const void* x, void* y, long long n_rows,
                             long long n_cols, long long block_cols, long long chunk_cols,
                             long long rows_per_cta, int staged, int aligned, int shared,
                             int grid, void* prods, void* tile_sums, void* ticket, void* dot,
                             long long block_rows, void* stream) {
  return cgx::launch_matvec<double, true>(
      a, x, y, n_rows, n_cols, block_cols, chunk_cols, rows_per_cta, staged, aligned, shared,
      grid, cgx::dense_dot<double>(prods, tile_sums, ticket, dot, block_rows), stream);
}

}  // extern "C"
