// Streaming banded (DIA) mat-vec for Hopper (sm_90a), float and double: kernel B8.
//
// Replaces the Pallas TPU kernels of cgx/ops/dia_spmv.py:
//   dia_matvec_stream           (_dia_stream_kernel, pallas_call at dia_spmv.py:192)
//   dia_matvec_stream2d_planes  (_dia_stream2d_kernel, pallas_call at dia_spmv.py:354)
// Both entries run the one kernel below: the flat form on (ndiag, n) bands,
// the planes form on the (ndiag, rows_p, cols) band planes, which are
// contiguous and so are flat bands of row stride rows_p * cols >= n.
//
//   y[i] = sum_d bands[d*stride + i] * x[i + off_d]   (x is 0 outside [0, n))
//
// The terms are summed in offset order, each product and each sum rounded on
// its own (-fmad=false), so y is bitwise the plain version's; no atomics.
//
// Bound: memory, as B1: (ndiag + 2) words a row (each band once, x once, y
// once), 2*ndiag flops. For the 5-band lap2d_fd(3200), n = 10,240,000, that
// is 287 MB in float (86 us at 3.35 TB/s) and 573 MB in double.
//
// The same kernel with a dot epilogue (DOT) is B1's dia_matvec_dot on B8's
// design (csrc/dia_spmv.cu names it): each thread sums x[i] * y[i] over its rows
// in the data type, tile after tile, a block sums its threads (shuffle trees,
// then the warps in order) into one partial, and the last block to take the
// integer ticket sums the partials in index order. No float atomics.
//
// Design. cgx's TPU kernels keep x in HBM and DMA a double-buffered halo
// window of it into VMEM for each block of rows. Here x is staged on chip
// too, once per block: a persistent grid of a few blocks an SM, each walking
// a contiguous run of tiles (tile = 4 rows a thread). The offsets are grouped
// into clusters (cgx_torch.ops.dia_spmv.stream_plan: one cluster while its
// ring fits, so the 5- and 7-point stencils take one), and each cluster keeps
// a ring of x in shared memory indexed by row modulo its length Q >= 2 tile +
// span + 8: the window [t + lo, t + tile + hi) a tile reads, and the next
// tile's tile new rows, which 16-byte cp.async copies bring in while the
// current tile's products run. So each x value enters shared memory once per
// block and cluster, a tile costs one barrier, and no block waits on a lone
// staging pass but its first. The ring's first four values are mirrored past
// its end, so four consecutive rows never wrap. Each thread owns 4
// consecutive rows: 16-byte loads of each band row where the band's rows lie
// on the 16-byte grid (every band of the planes, whose stride is a multiple
// of 131,072; band d of the flat form where d * n % 4 == 0), else four scalar
// loads, and a 16-byte store of y; the rows past n take a scalar tail. A tap
// whose offset is a multiple of 4 reads its four x values as one 16-byte
// shared load. An x that is off the 16-byte grid (a view) is copied value by
// value; y is always a fresh tensor. The design before this one (three
// segments staged per 2048-row block with scalar loads, every x value staged
// three times, and the shared-memory opt-in set on every launch) took 0.1713
// ms in float at n = 10,240,000 on an H100 (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "dia_row.cuh"

namespace cgx {

constexpr int kStreamThreads = 256;  // the most threads a block (the plan's threads)
constexpr int kStreamRows = 4;       // rows a thread owns in a tile
constexpr int kStreamPlanHead = 5;   // threads, tiles a block, shared bytes, clusters, ndiag
constexpr int kMirror = 4;           // ring values mirrored past its end
// blocks an SM of the plan (cgx_torch.ops.dia_spmv.STREAM_BLOCKS_PER_SM), which
// the registers must leave room for: the grid is that many blocks an SM
template <typename T>
constexpr int kStreamBlocksPerSM = sizeof(T) == 4 ? 4 : 2;

// The plan of cgx_torch.ops.dia_spmv.stream_plan.
struct StreamPlan {
  long long lo[kMaxDiags];    // each cluster's least offset
  long long hi[kMaxDiags];    // and greatest
  int ring[kMaxDiags];        // each cluster's ring length Q (a multiple of 4)
  int ring_off[kMaxDiags];    // its first value in shared memory (a multiple of 4)
  long long off[kMaxDiags];   // each diagonal's offset
  int dring[kMaxDiags];       // the ring length of each diagonal's cluster
  int droff[kMaxDiags];       // and its first value
  long long tiles_per_block;
  int tile;
  int nclus;
  int ndiag;
  int vec_x;                  // x on the 16-byte grid: 16-byte copies
  int vec_y;                  // y on the 16-byte grid: 16-byte stores
  int self;                   // an offset is 0: the dot reads x from its ring
  unsigned band_vec;          // bit d: band d's rows on the 16-byte grid
};

// The plan array [threads, tiles a block, shared bytes, clusters, ndiag, then
// (lo, hi, Q, first value) a cluster, then the cluster of each diagonal].
// Refused unless the tile is 4 rows a thread, every ring holds a tile's window
// and the next tile's rows, the rings fit the shared bytes without
// overlapping, each diagonal lies in its cluster, and the tiles cover [0, n).
template <typename T>
static bool make_stream_plan(StreamPlan* p, const long long* plan, int plan_len,
                             const long long* offsets, int ndiag, long long n, int grid,
                             int* threads) {
  if (plan_len < kStreamPlanHead) return false;
  const long long nthreads = plan[0], nclus = plan[3];
  if (nthreads < 32 || nthreads > kStreamThreads || nthreads % 32 || plan[4] != ndiag ||
      nclus < 1 || nclus > ndiag || plan_len != kStreamPlanHead + 4 * nclus + ndiag)
    return false;
  *threads = static_cast<int>(nthreads);
  p->tile = static_cast<int>(nthreads * kStreamRows);
  p->tiles_per_block = plan[1];
  if (p->tiles_per_block < 1 || grid < 1 || p->tiles_per_block * grid * p->tile < n) return false;
  long long end = 0;
  for (int c = 0; c < kMaxDiags; ++c) p->lo[c] = p->hi[c] = 0, p->ring[c] = p->ring_off[c] = 0;
  for (int c = 0; c < nclus; ++c) {
    const long long* e = plan + kStreamPlanHead + 4 * c;
    const long long q = e[2];
    if (e[1] < e[0] || q % 4 || q < 2LL * p->tile + (e[1] - e[0]) + 8 || e[3] % 4 ||
        e[3] < end || q > (1LL << 28))
      return false;
    p->lo[c] = e[0];
    p->hi[c] = e[1];
    p->ring[c] = static_cast<int>(q);
    p->ring_off[c] = static_cast<int>(e[3]);
    end = e[3] + q + kMirror;
  }
  if (end * static_cast<long long>(sizeof(T)) > plan[2] || plan[2] > kSharedOptin) return false;
  for (int d = 0; d < kMaxDiags; ++d) {
    p->off[d] = d < ndiag ? offsets[d] : 0;
    p->dring[d] = 1;
    p->droff[d] = 0;
    if (d >= ndiag) continue;
    const long long c = plan[kStreamPlanHead + 4 * nclus + d];
    if (c < 0 || c >= nclus || offsets[d] < p->lo[c] || offsets[d] > p->hi[c]) return false;
    p->dring[d] = p->ring[c];
    p->droff[d] = p->ring_off[c];
  }
  p->nclus = static_cast<int>(nclus);
  p->ndiag = ndiag;
  p->self = 0;
  for (int d = 0; d < ndiag; ++d) p->self |= offsets[d] == 0;
  return true;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n"); }

__device__ __forceinline__ long long stream_pos_mod(long long x, long long q) {
  const long long r = x % q;
  return r < 0 ? r + q : r;
}

// Rows [j0, j1) of x (multiples of 4) into the ring of q values at slot
// row mod q, zeros outside [0, n); slots 0..3 also at q..q+3. Asynchronous:
// the caller commits and waits.
template <typename T>
__device__ void stage(T* ring, int q, const T* __restrict__ x, long long n, long long j0,
                      long long j1, bool vec) {
  const int v = vec ? 16 / static_cast<int>(sizeof(T)) : 1;  // values a copy
  const long long step = static_cast<long long>(blockDim.x) * v;
  long long j = j0 + static_cast<long long>(threadIdx.x) * v;
  if (j >= j1) return;
  int slot = static_cast<int>(stream_pos_mod(j, q));
  const int adv = static_cast<int>(step % q);
  for (; j < j1; j += step) {
    const long long have = j < 0 ? 0 : (n - j < v ? n - j : v);
    const int valid = have > 0 ? static_cast<int>(have) * static_cast<int>(sizeof(T)) : 0;
    const T* src = valid ? x + j : x;
    cp_async(ring + slot, src, v * static_cast<int>(sizeof(T)), valid);
    if (slot < kMirror) cp_async(ring + q + slot, src, v * static_cast<int>(sizeof(T)), valid);
    slot += adv;
    slot = slot >= q ? slot - q : slot;
  }
}

__device__ __forceinline__ long long floor4(long long v) { return v >= 0 ? v & ~3LL : -((-v + 3) & ~3LL); }
__device__ __forceinline__ long long ceil4(long long v) { return -floor4(-v); }

template <typename T>
struct Vec4 {
  T v[4];
};

// Four values from p, 16-byte aligned
template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p) {
  Vec4<T> r;
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    r.v[0] = a.x, r.v[1] = a.y, r.v[2] = b.x, r.v[3] = b.y;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

// A thread's four band values of one band row from bp: a 16-byte load where
// bit 0 of vec says the band's rows are on the 16-byte grid and all four rows
// are below n (whole), else one value a row, zero past n (left: rows below n).
template <typename T>
__device__ __forceinline__ Vec4<T> band4(const T* __restrict__ bp, long long left, bool whole,
                                         unsigned vec) {
  if (whole && (vec & 1u)) return load4(bp);
  Vec4<T> r;
#pragma unroll
  for (int e = 0; e < kStreamRows; ++e) r.v[e] = e < left ? bp[e] : T(0);
  return r;
}

// The dot of dia_matvec_dot (unused by the plain product).
template <typename T>
struct StreamDot {
  T* partials;           // one a block
  unsigned int* ticket;  // 0 at launch; the last block sets it back to 0
  T* dot;
};

// This block's partial, then, in the last block to take the ticket, the
// partials summed in index order into *dot.
template <typename T>
__device__ void stream_dot_combine(T part, const StreamDot<T>& sd) {
  const T total = block_sum<T, kStreamThreads>(part);
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    sd.partials[blockIdx.x] = total;
    __threadfence();  // the partial is visible before the ticket is taken
    is_last = atomicAdd(sd.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const volatile T* parts = sd.partials;  // written by other SMs: bypass L1
  T v = T(0);
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += blockDim.x) v += parts[j];
  v = block_sum<T, kStreamThreads>(v);
  if (threadIdx.x == 0) {
    *sd.dot = v;
    *sd.ticket = 0u;
  }
}

// ND: the diagonals the kernel is built for, their band values loaded ahead
// of the tile's barrier (5 and 7, the 2D and 3D stencils), or 0: any number,
// each band loaded as its term is summed. DOT: also <x, y> (StreamDot).
template <typename T, int ND, bool DOT>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSM<T>)
    dia_stream_kernel(const T* __restrict__ bands, long long stride, const T* __restrict__ x,
                      T* __restrict__ y, long long n, StreamPlan p, StreamDot<T> sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tile = p.tile;
  const long long ntiles = (n + tile - 1) / tile;
  const long long k0 = static_cast<long long>(blockIdx.x) * p.tiles_per_block;
  const long long k1 = k0 + p.tiles_per_block < ntiles ? k0 + p.tiles_per_block : ntiles;
  if (k0 >= k1) {  // the whole block
    if constexpr (DOT) stream_dot_combine(T(0), sd);
    return;
  }
  T part = T(0);  // this thread's x[i] * y[i], summed in the data type (DOT)
  // each diagonal's ring slot of row t + off, for the current tile t
  int base[kMaxDiags];
  const long long first = k0 * tile;
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d)  // static indices keep p and base in registers
    base[d] = d < p.ndiag ? static_cast<int>(stream_pos_mod(first + p.off[d], p.dring[d])) : 0;
  // the first tile's windows, [floor4(t + lo), ceil4(t + tile + hi)) a cluster
#pragma unroll
  for (int c = 0; c < kMaxDiags; ++c)
    if (c < p.nclus)
      stage(sm + p.ring_off[c], p.ring[c], x, n, floor4(first + p.lo[c]),
            ceil4(first + tile + p.hi[c]), p.vec_x);
  cp_async_commit();
  for (long long k = k0; k < k1; ++k) {
    const long long t = k * tile;
    const long long i = t + static_cast<long long>(threadIdx.x) * kStreamRows;
    const bool whole = i + kStreamRows <= n;
    // 1. this thread's band values, in flight across the barrier
    Vec4<T> bv[ND ? ND : 1];
#pragma unroll
    for (int d = 0; d < ND; ++d) bv[d] = band4(bands + d * stride + i, n - i, whole, p.band_vec >> d);
    // 2. this tile's x is in the rings; the ring slots of the tile before are free
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < k1) {
#pragma unroll
      for (int c = 0; c < kMaxDiags; ++c) {
        if (c < p.nclus) {
          const long long j0 = ceil4(t + tile + p.hi[c]);
          stage(sm + p.ring_off[c], p.ring[c], x, n, j0, j0 + tile, p.vec_x);
        }
      }
      cp_async_commit();
    }
    // 3. the products, in offset order
    T acc[kStreamRows] = {T(0), T(0), T(0), T(0)};
    T x0[kStreamRows];  // x at this thread's rows, from the ring of offset 0 (DOT)
#pragma unroll
    for (int d = 0; d < (ND ? ND : kMaxDiags); ++d) {
      if (ND || d < p.ndiag) {
        const Vec4<T> b4 = ND ? bv[ND ? d : 0]
                              : band4(bands + d * stride + i, n - i, whole, p.band_vec >> d);
        const int q = p.dring[d];
        int s = base[d] + threadIdx.x * kStreamRows;
        s = s >= q ? s - q : s;
        const T* xr = sm + p.droff[d] + s;
        T xv[kStreamRows];
        if ((p.off[d] & 3) == 0) {
          const Vec4<T> x4 = load4(xr);
#pragma unroll
          for (int e = 0; e < kStreamRows; ++e) xv[e] = x4.v[e];
        } else {
#pragma unroll
          for (int e = 0; e < kStreamRows; ++e) xv[e] = xr[e];
        }
#pragma unroll
        for (int e = 0; e < kStreamRows; ++e) acc[e] += b4.v[e] * xv[e];
        if constexpr (DOT) {
          if (p.off[d] == 0) {
#pragma unroll
            for (int e = 0; e < kStreamRows; ++e) x0[e] = xv[e];
          }
        }
      }
    }
    if (whole && p.vec_y) {
      store4(y + i, acc);
    } else {
#pragma unroll
      for (int e = 0; e < kStreamRows; ++e)
        if (i + e < n) y[i + e] = acc[e];
    }
    if constexpr (DOT) {  // x at this thread's rows: from the ring, else from device memory
      if (p.self) {
#pragma unroll
        for (int e = 0; e < kStreamRows; ++e)
          if (i + e < n) part += x0[e] * acc[e];
      } else if (whole && p.vec_x) {
        const Vec4<T> x4 = load4(x + i);
#pragma unroll
        for (int e = 0; e < kStreamRows; ++e) part += x4.v[e] * acc[e];
      } else {
#pragma unroll
        for (int e = 0; e < kStreamRows; ++e)
          if (i + e < n) part += x[i + e] * acc[e];
      }
    }
#pragma unroll
    for (int d = 0; d < kMaxDiags; ++d) {
      if (d < p.ndiag) {
        const int b = base[d] + tile;
        base[d] = b >= p.dring[d] ? b - p.dring[d] : b;
      }
    }
  }
  if constexpr (DOT) stream_dot_combine(part, sd);
}

// Launches kernel K with the plan's shared bytes, after letting K take them
// (once a process, common.cuh); the launch's error
template <auto K, typename T>
static int stream_launch(int grid, int threads, long long shared, void* stream, const void* bands,
                         long long stride, const void* x, void* y, long long n,
                         const StreamPlan& p, const StreamDot<T>& sd) {
  const cudaError_t allowed = allow_shared<K>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  K<<<grid, threads, static_cast<size_t>(shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), stride, static_cast<const T*>(x), static_cast<T*>(y), n, p,
      sd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DOT>
static int launch_stream(const void* bands, long long stride, const void* x, void* y, long long n,
                         const long long* offsets, int ndiag, const long long* plan, int plan_len,
                         int grid, const StreamDot<T>& sd, void* stream) {
  if (n < 0 || stride < n || ndiag < 1 || ndiag > kMaxDiags)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && !DOT) return 0;
  StreamPlan p;
  int threads = 0;
  if (!make_stream_plan<T>(&p, plan, plan_len, offsets, ndiag, n, grid, &threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto on_grid = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.vec_x = on_grid(x);
  p.vec_y = on_grid(y);
  p.band_vec = 0u;
  for (int d = 0; d < ndiag; ++d)
    if (on_grid(static_cast<const T*>(bands) + d * stride)) p.band_vec |= 1u << d;
  if (ndiag == 5)
    return stream_launch<dia_stream_kernel<T, 5, DOT>, T>(grid, threads, plan[2], stream, bands,
                                                          stride, x, y, n, p, sd);
  if (ndiag == 7)
    return stream_launch<dia_stream_kernel<T, 7, DOT>, T>(grid, threads, plan[2], stream, bands,
                                                          stride, x, y, n, p, sd);
  return stream_launch<dia_stream_kernel<T, 0, DOT>, T>(grid, threads, plan[2], stream, bands,
                                                        stride, x, y, n, p, sd);
}

// dia_matvec_dot's launch: the product's, with one partial a block
template <typename T>
static int launch_stream_dot(const void* bands, long long stride, const void* x, void* y,
                             long long n, const long long* offsets, int ndiag,
                             const long long* plan, int plan_len, int grid, void* partials,
                             long long partials_len, void* ticket, void* dot, void* stream) {
  if (grid > partials_len) return static_cast<int>(cudaErrorInvalidValue);
  const StreamDot<T> sd{static_cast<T*>(partials), static_cast<unsigned int*>(ticket),
                        static_cast<T*>(dot)};
  return launch_stream<T, true>(bands, stride, x, y, n, offsets, ndiag, plan, plan_len, grid, sd,
                                stream);
}

}  // namespace cgx

extern "C" {

// bands: ndiag rows of `stride` elements (stride = n for the flat form,
// rows_p * cols for the planes form); x and y: n elements; the plan and grid
// of cgx_torch.ops.dia_spmv.stream_plan.
int cgx_dia_matvec_stream_f32(const void* bands, long long stride, const void* x, void* y,
                              long long n, const long long* offsets, int ndiag,
                              const long long* plan, int plan_len, int grid, void* stream) {
  return cgx::launch_stream<float, false>(bands, stride, x, y, n, offsets, ndiag, plan, plan_len,
                                          grid, {}, stream);
}

int cgx_dia_matvec_stream_f64(const void* bands, long long stride, const void* x, void* y,
                              long long n, const long long* offsets, int ndiag,
                              const long long* plan, int plan_len, int grid, void* stream) {
  return cgx::launch_stream<double, false>(bands, stride, x, y, n, offsets, ndiag, plan, plan_len,
                                           grid, {}, stream);
}

// the same, and <x, y>: partials (at least grid of them), the ticket (0), the dot
int cgx_dia_matvec_stream_dot_f32(const void* bands, long long stride, const void* x, void* y,
                                  long long n, const long long* offsets, int ndiag,
                                  const long long* plan, int plan_len, int grid, void* partials,
                                  long long partials_len, void* ticket, void* dot, void* stream) {
  return cgx::launch_stream_dot<float>(bands, stride, x, y, n, offsets, ndiag, plan, plan_len,
                                       grid, partials, partials_len, ticket, dot, stream);
}

int cgx_dia_matvec_stream_dot_f64(const void* bands, long long stride, const void* x, void* y,
                                  long long n, const long long* offsets, int ndiag,
                                  const long long* plan, int plan_len, int grid, void* partials,
                                  long long partials_len, void* ticket, void* dot, void* stream) {
  return cgx::launch_stream_dot<double>(bands, stride, x, y, n, offsets, ndiag, plan, plan_len,
                                        grid, partials, partials_len, ticket, dot, stream);
}

}  // extern "C"
