// Dense mat-vec kernels for Hopper (sm_90a), float, double and bfloat16.
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
// bfloat16 (the _bf16 entries): A and x are read as bfloat16 (8 a 16-byte load),
// each product and sum is formed in float (a product of two bfloat16 is exact
// there, so one fused multiply-add rounds as the product and the sum did), the
// tile sums and the running sums are float, and y rounds to bfloat16 once, at
// the store, with the grouping above. cgx's TPU kernel rounds y to bfloat16
// after each column tile (matvec.py:58-65), a choice of its tiling; the plain
// version here sums the tiles in float as this kernel does. dense_matvec_dot's
// products x[i] * y[i] round to bfloat16 (cgx's xrow * y in the vectors'
// dtype) and are summed in float: the dot is float32.
// A bfloat16 tile of 128 columns (the CLI's "1024 16") is 16 vectors, so a
// span on a whole warp left lanes 16-31 idle: 0.1387 ms at N = 10,000 against
// torch.mv's 0.0731, and 0.0793 ms with 256-column tiles, whose 32 vectors
// fill the warp (H100 80GB HBM3, 700 W; redesign_probe.py). So where a tile has
// at most 16 or 8 vectors (dense_plan's lanes, cgx_torch.ops.matvec.span_lanes),
// a span takes a half or a quarter of a warp and the warp works on two or four
// spans at once (SUB below); their lanes also ask L2 for their spans
// kDensePrefetch units ahead. Bound: 0.0597 ms at N = 10,000 (200 MB at
// 3.35 TB/s). With 1024 x 128 tiles the kernel takes 0.0743 ms on the device
// (0.0767 without the prefetch) against 0.1283 on whole warps and torch.mv's
// 0.0699: a static split waits for its last block, 3% after the mean one
// (PERF.md). float32 and float64 keep whole-warp spans, bit for bit as before.
#include <type_traits>

#include "bf16.cuh"
#include "common.cuh"

namespace cgx {

constexpr int kDenseThreads = 512;  // cgx_torch.ops.matvec.DENSE_THREADS; one block an SM
constexpr int kDenseUnits = 8;      // neighbouring tiles of a row a warp works on at once
// bfloat16 spans on a half or a quarter warp: a warp asks L2 for its spans this
// many units ahead (cp.async.bulk.prefetch.L2), beyond the next round that its
// registers hold. On an H100 at N = 10,000 with 1024 x 128 tiles it took the
// kernel from 76.7 to 74.3 us (one and four units ahead: 80.2, 102.2); on
// whole-warp spans of 512-column tiles (8 KB a span) it made it slower (183.9
// to 270.3 us at N = 16,384), so those take none.
constexpr int kDensePrefetch = 2;

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
template <>
struct Vec16<bf16> {
  using type = uint4;
  static constexpr int n = 8;
};

// bfloat16 value e of a 32-bit word (e = 0 the low half), widened exactly
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

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
// bfloat16: a product of two bfloat16 values is exact in float, so one fused
// multiply-add rounds as the product and the sum did (one rounding, the sum's)
__device__ __forceinline__ float vdot(float p, uint4 a, uint4 x) {
  const unsigned aw[4] = {a.x, a.y, a.z, a.w}, xw[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p = __fmaf_rn(bf_lo(aw[k]), bf_lo(xw[k]), p);
    p = __fmaf_rn(bf_hi(aw[k]), bf_hi(xw[k]), p);
  }
  return p;
}
__device__ __forceinline__ float vdot(float p, uint4 a, const bf16* x) {
  const unsigned aw[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p += bf_lo(aw[k]) * static_cast<float>(x[2 * k]);
    p += bf_hi(aw[k]) * static_cast<float>(x[2 * k + 1]);
  }
  return p;
}

// This lane's partial of row arow over columns [c0, c1) on the peeled path:
// head, vectors in order, tail. xs[c] is x's value at column c. The partial is
// in the accumulation type A (float for bfloat16).
template <typename T, typename A = typename Acc<T>::type>
__device__ __forceinline__ A peeled_part(const T* __restrict__ arow, const T* xs, long long c0,
                                         long long c1, int lane) {
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
  const long long mis = (reinterpret_cast<unsigned long long>(arow + c0) % 16) / sizeof(T);
  long long head = mis ? VN - mis : 0;
  if (head > c1 - c0) head = c1 - c0;
  const long long nvec = (c1 - c0 - head) / VN;
  const long long cb = c0 + head + nvec * VN;
  A p = A(0);
  if (lane < head) p += static_cast<A>(arow[c0 + lane]) * static_cast<A>(xs[c0 + lane]);
  const V* av = reinterpret_cast<const V*>(arow + c0 + head);
  for (long long v = lane; v < nvec; v += 32) p = vdot(p, __ldg(av + v), xs + c0 + head + v * VN);
  if (lane < c1 - cb) p += static_cast<A>(arow[cb + lane]) * static_cast<A>(xs[cb + lane]);
  return p;
}

__host__ __device__ inline long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// Shared bytes of a block: the staged x chunk (size bytes a value), the tile
// partials of its rows over a chunk, and its rows' running sums (acc bytes a
// value: float for bfloat16, else size).
__host__ __device__ inline long long dense_shared(long long chunk_cols, long long chunk_tiles,
                                                  long long rows, long long size, long long acc,
                                                  int staged) {
  return (staged ? align16(chunk_cols * size) : 0) + align16(rows * chunk_tiles * acc) +
         rows * acc;
}

// The sums of v[0..7] over each group of SUB neighbouring lanes (32: the
// warp; 16 or 8: its half or quarter): lane i ends with the sum of v[t] over
// its group for tile t = its lane bits SUB/2, SUB/4, SUB/8 (read as 4, 2, 1),
// by recursive halving, then a tree over the SUB/8 lanes that share a tile: 9
// shuffles for the 8 sums of a warp, against 40 for 8 trees. Each sum is
// formed in a fixed order, in every lane that holds it alike.
template <int SUB, typename T>
__device__ __forceinline__ T transpose_sum8(const T (&v)[8], int lane) {
  static_assert(SUB == 8 || SUB == 16 || SUB == 32, "a warp, or its half or quarter");
  const bool h4 = lane & (SUB / 2), h3 = lane & (SUB / 4), h2 = lane & (SUB / 8);
  T a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T send = h4 ? v[i] : v[i + 4], keep = h4 ? v[i + 4] : v[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, SUB / 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T send = h3 ? a[i] : a[i + 2], keep = h3 ? a[i + 2] : a[i];
    b[i] = keep + __shfl_xor_sync(0xffffffffu, send, SUB / 4);
  }
  const T send = h2 ? b[0] : b[1], keep = h2 ? b[1] : b[0];
  T c = keep + __shfl_xor_sync(0xffffffffu, send, SUB / 8);
#pragma unroll
  for (int o = SUB / 16; o >= 1; o >>= 1) c = c + __shfl_xor_sync(0xffffffffu, c, o);
  return c;
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
// SUB (aligned path only): lanes a span, 32 or, where a tile has at most 16 or 8
// vectors (bfloat16 tiles of 128 or 64 columns), 16 or 8, so that a warp works on
// 32 / SUB spans at once (spans q NS + h, h = lane / SUB) and every lane loads.
// DOT: where a row's sum is written, also prods[i] = x[i] * y[i] (0 past n_cols).
// Sums run in A = Acc<T>::type; y rounds to T at the store.
template <typename T, bool ALIGNED, bool DOT, int SUB, typename A = typename Acc<T>::type>
__device__ __forceinline__ void dense_rows(const T* __restrict__ a, const T* __restrict__ x,
                                           T* __restrict__ y, long long n_rows,
                                           long long n_cols, long long block_cols,
                                           long long chunk_cols, long long rows_per_cta,
                                           int staged, A* __restrict__ prods) {
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
  A* tsum = reinterpret_cast<A*>(smem + (staged ? align16(chunk_cols * sizeof(T)) : 0));
  A* run = reinterpret_cast<A*>(reinterpret_cast<unsigned char*>(tsum) +
                                align16(rows * max_tiles * sizeof(A)));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  static_assert(ALIGNED || SUB == 32, "the peeled path takes a warp a span");
  constexpr int NS = 32 / SUB;                   // spans a warp works on at once
  const int sub = lane / SUB, sl = lane % SUB;  // the lane's span of them, its lane in it
  const int mine = (sl & (SUB / 2) ? 4 : 0) + (sl & (SUB / 4) ? 2 : 0) + (sl & (SUB / 8) ? 1 : 0);
  if (n_cols == 0)
    for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
      y[r0 + r] = T(0);
      if (DOT) prods[r0 + r] = A(0);
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
    auto put = [&](const A (&part)[G], const Span& sp, bool live) {
      const A sum = transpose_sum8<SUB>(part, lane);
      if ((sl & (SUB / 8 - 1)) == 0 && live && sp.tile + mine < tiles)
        tsum[sp.row * tiles + sp.tile + mine] = sum;
    };
    if (ALIGNED) {
      const long long full = block_cols / VN;  // vectors of a whole tile
      const long long last = (k1 - (k0 + (tiles - 1) * block_cols)) / VN;  // of the last tile
      const long long nr = (full + SUB - 1) / SUB;  // rounds of a span: a vector a lane and tile
      const unsigned supers = (groups + NS - 1) / NS;  // the warps' units: NS spans each
      auto nvec = [&](long long t) { return t < tiles - 1 ? full : (t == tiles - 1 ? last : 0); };
      auto load = [&](unsigned q, long long j, V (&dst)[G]) {
        if (NS > 1 && q >= groups) return;  // a sub-warp past the last span
        const Span sp = span_of(q);
        const V* av0 = reinterpret_cast<const V*>(a + (r0 + sp.row) * n_cols + k0 +
                                                  sp.tile * block_cols);
        const long long v = sl + SUB * j;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (v < nvec(sp.tile + g)) dst[g] = __ldg(av0 + g * full + v);
      };
      // bfloat16 on sub-warp spans: the first lane of each span of unit w asks L2
      // for the span's bytes, one bulk prefetch
      constexpr int PF = std::is_same_v<T, bf16> && SUB < 32 ? kDensePrefetch : 0;
      auto prefetch = [&](unsigned w) {
        const unsigned q = w * NS + sub;
        if (PF == 0 || sl != 0 || w >= supers || q >= groups) return;
        const Span sp = span_of(q);
        const long long cols = k1 - k0 - sp.tile * block_cols;
        const unsigned bytes =
            static_cast<unsigned>((cols < G * block_cols ? cols : G * block_cols) * sizeof(T));
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                         a + (r0 + sp.row) * n_cols + k0 + sp.tile * block_cols),
                     "r"(bytes)
                     : "memory");
      };
      // rounds (unit u, j) in order, the lane on span u NS + sub; the next
      // round's loads issue before this round's products and sums
      unsigned u = warp;
      long long j = 0;
#pragma unroll
      for (int k = 1; k < PF; ++k) prefetch(u + k * nwarps);
      V cur[G], nxt[G];
      A part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = A(0);
      if (u < supers) load(u * NS + sub, 0, cur);  // A's first round flies while x arrives
      if (staged) asm volatile("cp.async.wait_all;" ::);
      __syncthreads();  // x is staged
      while (u < supers) {
        unsigned un = u;
        long long jn = j + 1;
        if (jn == nr) {
          jn = 0;
          un = u + nwarps;
        }
        if (un < supers) load(un * NS + sub, jn, nxt);
        if (j == 0) prefetch(u + PF * nwarps);
        const unsigned q = u * NS + sub;
        const bool live = NS == 1 || q < groups;  // a whole warp's span is always live
        const Span sp = span_of(live ? q : 0);
        const T* xv0 = xs + k0 + sp.tile * block_cols;
        const long long v = sl + SUB * j;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (live && v < nvec(sp.tile + g))
            part[g] = vdot(part[g], cur[g], *reinterpret_cast<const V*>(xv0 + (g * full + v) * VN));
        if (jn == 0) {
          put(part, sp, live);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] = A(0);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) cur[g] = nxt[g];
        u = un;
        j = jn;
      }
    } else {
      __syncthreads();  // x is staged
      for (unsigned q = warp; q < groups; q += nwarps) {
        const Span sp = span_of(q);
        const T* arow = a + (r0 + sp.row) * n_cols;
        A part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const long long c0 = k0 + (sp.tile + g) * block_cols;
          const long long c1 = c0 + block_cols < k1 ? c0 + block_cols : k1;
          part[g] = sp.tile + g < tiles ? peeled_part(arow, xs, c0, c1, lane) : A(0);
        }
        put(part, sp, true);
      }
    }
    __syncthreads();  // every tile sum of the chunk is in shared memory
    for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
      A acc = k0 == 0 ? A(0) : run[r];
      for (long long t = 0; t < tiles; ++t) acc += tsum[r * tiles + t];
      if (k1 == n_cols) {
        const T yv = static_cast<T>(acc);
        y[r0 + r] = yv;
        if (DOT) prods[r0 + r] = r0 + r < n_cols ? static_cast<A>(x[r0 + r] * yv) : A(0);
      } else {
        run[r] = acc;
      }
    }
  }
}

// dense_matvec_dot's outputs and scratch (unused by dense_matvec), in the
// accumulation type.
template <typename T, typename A = typename Acc<T>::type>
struct DenseDot {
  A* prods;              // x[i] * y[i] a row
  A* tile_sums;          // one a row tile
  unsigned int* ticket;  // 0 at launch; the last block sets it back to 0
  A* dot;
  long long block_rows;
};

// y = A x on the persistent grid; with DOT also <x, y>: the last block to take
// the ticket sums the products per row tile (a warp a tile) and the tile sums
// in order.
template <typename T, bool ALIGNED, bool DOT, int SUB>
__global__ void __launch_bounds__(kDenseThreads, 1)
dense_matvec_persistent_kernel(const T* __restrict__ a, const T* __restrict__ x,
                               T* __restrict__ y, long long n_rows, long long n_cols,
                               long long block_cols, long long chunk_cols,
                               long long rows_per_cta, int staged, DenseDot<T> dd) {
  dense_rows<T, ALIGNED, DOT, SUB>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,
                                   rows_per_cta, staged, dd.prods);
  if constexpr (DOT) {
    __threadfence();  // this block's products are visible before its ticket is taken
    __syncthreads();
    __shared__ bool is_last;
    if (threadIdx.x == 0) is_last = atomicAdd(dd.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    using A = typename Acc<T>::type;
    const volatile A* p = dd.prods;  // written by other SMs: bypass L1
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const long long tiles = (n_rows + dd.block_rows - 1) / dd.block_rows;
    for (long long t = warp; t < tiles; t += nwarps) {
      const long long r1 = (t + 1) * dd.block_rows < n_rows ? (t + 1) * dd.block_rows : n_rows;
      A s = A(0);
      for (long long i = t * dd.block_rows + lane; i < r1; i += 32) s += p[i];
      s = warp_sum(s);
      if (lane == 0) dd.tile_sums[t] = s;
    }
    __syncthreads();  // the tile sums of all warps are visible to thread 0
    if (threadIdx.x == 0) {
      const volatile A* ts = dd.tile_sums;
      A d = A(0);
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
// staged, the aligned path's rows, tiles and pointers are 16-byte aligned, and
// the lanes a span are 32 or, on the aligned path of bfloat16, 16 or 8 with a
// tile of at most that many vectors. With DOT the kernel also runs on
// n_rows = 0 (the dot is 0).
template <typename T, bool DOT>
static int launch_matvec(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, long long chunk_cols,
                         long long rows_per_cta, int staged, int aligned, int shared, int grid,
                         int lanes, DenseDot<T> dd, void* stream) {
  const long long sz = sizeof(T);
  const bool narrow_ok = std::is_same_v<T, bf16> && aligned &&
                         (lanes == 16 || lanes == 8) && block_cols * sz <= 16LL * lanes;
  if ((lanes != 32 && !narrow_ok) ||
      bad_shape(n_rows, n_cols, DOT ? dd.block_rows : 1, block_cols) || grid < 1 ||
      rows_per_cta < 1 || rows_per_cta * grid < n_rows || chunk_cols < 1 ||
      (chunk_cols < n_cols && chunk_cols % block_cols != 0) ||
      shared < dense_shared(chunk_cols, (chunk_cols + block_cols - 1) / block_cols,
                            rows_per_cta, sz, sizeof(typename Acc<T>::type), staged) ||
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
  if (!aligned)
    return launch(dense_matvec_persistent_kernel<T, false, DOT, 32>,
                  allow_shared<dense_matvec_persistent_kernel<T, false, DOT, 32>>());
  if constexpr (std::is_same_v<T, bf16>) {
    if (lanes == 16)
      return launch(dense_matvec_persistent_kernel<T, true, DOT, 16>,
                    allow_shared<dense_matvec_persistent_kernel<T, true, DOT, 16>>());
    if (lanes == 8)
      return launch(dense_matvec_persistent_kernel<T, true, DOT, 8>,
                    allow_shared<dense_matvec_persistent_kernel<T, true, DOT, 8>>());
  }
  return launch(dense_matvec_persistent_kernel<T, true, DOT, 32>,
                allow_shared<dense_matvec_persistent_kernel<T, true, DOT, 32>>());
}

template <typename T, typename A = typename Acc<T>::type>
static DenseDot<T> dense_dot(void* prods, void* tile_sums, void* ticket, void* dot,
                             long long block_rows) {
  return DenseDot<T>{static_cast<A*>(prods), static_cast<A*>(tile_sums),
                     static_cast<unsigned int*>(ticket), static_cast<A*>(dot), block_rows};
}

}  // namespace cgx

extern "C" {

int cgx_dense_matvec_f32(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, long long chunk_cols,
                         long long rows_per_cta, int staged, int aligned, int shared, int grid,
                         int lanes, void* stream) {
  return cgx::launch_matvec<float, false>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,
                                          rows_per_cta, staged, aligned, shared, grid, lanes, {},
                                          stream);
}

int cgx_dense_matvec_f64(const void* a, const void* x, void* y, long long n_rows,
                         long long n_cols, long long block_cols, long long chunk_cols,
                         long long rows_per_cta, int staged, int aligned, int shared, int grid,
                         int lanes, void* stream) {
  return cgx::launch_matvec<double, false>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,
                                           rows_per_cta, staged, aligned, shared, grid, lanes, {},
                                           stream);
}

// dense_matvec's arguments, then the products (n_rows), the tile sums (one a
// row tile), the ticket (0), the dot and the row tile. lanes: a span's (32, or
// for bfloat16 16 or 8).
int cgx_dense_matvec_dot_f32(const void* a, const void* x, void* y, long long n_rows,
                             long long n_cols, long long block_cols, long long chunk_cols,
                             long long rows_per_cta, int staged, int aligned, int shared,
                             int grid, int lanes, void* prods, void* tile_sums, void* ticket,
                             void* dot, long long block_rows, void* stream) {
  return cgx::launch_matvec<float, true>(
      a, x, y, n_rows, n_cols, block_cols, chunk_cols, rows_per_cta, staged, aligned, shared,
      grid, lanes, cgx::dense_dot<float>(prods, tile_sums, ticket, dot, block_rows), stream);
}

int cgx_dense_matvec_dot_f64(const void* a, const void* x, void* y, long long n_rows,
                             long long n_cols, long long block_cols, long long chunk_cols,
                             long long rows_per_cta, int staged, int aligned, int shared,
                             int grid, int lanes, void* prods, void* tile_sums, void* ticket,
                             void* dot, long long block_rows, void* stream) {
  return cgx::launch_matvec<double, true>(
      a, x, y, n_rows, n_cols, block_cols, chunk_cols, rows_per_cta, staged, aligned, shared,
      grid, lanes, cgx::dense_dot<double>(prods, tile_sums, ticket, dot, block_rows), stream);
}

// bfloat16 A, x and y; the dot's products, tile sums and dot in float
int cgx_dense_matvec_bf16(const void* a, const void* x, void* y, long long n_rows,
                          long long n_cols, long long block_cols, long long chunk_cols,
                          long long rows_per_cta, int staged, int aligned, int shared, int grid,
                          int lanes, void* stream) {
  return cgx::launch_matvec<cgx::bf16, false>(a, x, y, n_rows, n_cols, block_cols, chunk_cols,
                                              rows_per_cta, staged, aligned, shared, grid, lanes,
                                              {}, stream);
}

int cgx_dense_matvec_dot_bf16(const void* a, const void* x, void* y, long long n_rows,
                              long long n_cols, long long block_cols, long long chunk_cols,
                              long long rows_per_cta, int staged, int aligned, int shared,
                              int grid, int lanes, void* prods, void* tile_sums, void* ticket,
                              void* dot, long long block_rows, void* stream) {
  return cgx::launch_matvec<cgx::bf16, true>(
      a, x, y, n_rows, n_cols, block_cols, chunk_cols, rows_per_cta, staged, aligned, shared,
      grid, lanes, cgx::dense_dot<cgx::bf16>(prods, tile_sums, ticket, dot, block_rows), stream);
}

}  // extern "C"
