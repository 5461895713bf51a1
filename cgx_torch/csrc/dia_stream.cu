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
// Design. cgx's TPU kernels keep x in HBM and DMA a double-buffered halo
// window of it into VMEM for each block of rows; that is a TPU layout device
// and is not copied here. What the Hopper kernel takes from it is that x is
// staged on chip: a block owns a tile of `tile` consecutive rows; the offsets
// are grouped into clusters of neighbouring offsets (a gap of at most `tile`),
// and for each cluster the block loads the x segment its tile needs,
// [t0 + lo, t0 + tile + hi), margins included, into shared memory with
// coalesced loads, zero-filled outside [0, n). Every band's term then comes
// from shared memory. For lap2d_fd(3200) (offsets -3200, -1, 0, 1, 3200) and
// the 2048-row tile that is three segments, 2048 + 2048 + 2050 elements: 24.6
// KB in float, 49.2 KB in double. Above 48 KB a block needs the dynamic
// shared-memory opt-in, which the launcher sets on every launch (the
// choice over a smaller tile: fewer, larger segments keep the halo share of
// the loads small). A tile of 1024, 512 or 256 rows is taken where the
// clusters of a wide stencil would not fit kSmemBudget.
//
// Not done yet (later speed work): cp.async double buffering across tiles,
// TMA, vector loads.
#include <cuda_runtime.h>

#include "dia_row.cuh"

namespace cgx {

constexpr int kStreamThreads = 256;
constexpr int kSmemBudget = 112 * 1024;  // bytes a block may stage
constexpr int kTiles[] = {2048, 1024, 512, 256};

struct StreamPlan {
  long long lo[kMaxDiags];  // each cluster's least offset
  int width[kMaxDiags];     // tile + the cluster's span: elements staged
  int base[kMaxDiags];      // where the cluster starts in shared memory
  int pos[kMaxDiags];       // per diagonal: base of its cluster + (off - lo)
  int nseg;
  int ndiag;
  int tile;
  int smem_elems;
};

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
dia_stream_kernel(const T* __restrict__ bands, long long stride, const T* __restrict__ x,
                  T* __restrict__ y, long long n, StreamPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* seg = reinterpret_cast<T*>(smem_raw);
  const long long t0 = static_cast<long long>(blockIdx.x) * p.tile;
#pragma unroll
  for (int c = 0; c < kMaxDiags; ++c) {  // static indices keep p in the parameter bank
    if (c < p.nseg) {
      const long long g0 = t0 + p.lo[c];
      T* dst = seg + p.base[c];
      for (int k = threadIdx.x; k < p.width[c]; k += kStreamThreads) {
        const long long j = g0 + k;
        dst[k] = (j >= 0 && j < n) ? x[j] : T(0);
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < p.tile; r += kStreamThreads) {
    const long long i = t0 + r;
    if (i >= n) break;
    T acc = T(0);
#pragma unroll
    for (int d = 0; d < kMaxDiags; ++d) {
      if (d < p.ndiag) acc += bands[d * stride + i] * seg[p.pos[d] + r];
    }
    y[i] = acc;
  }
}

// Clusters of the offsets for one tile; false if they would not fit the budget.
static bool make_plan(const long long* offsets, int ndiag, int tile, int elem_bytes,
                      StreamPlan* p) {
  long long s[kMaxDiags];
  for (int d = 0; d < ndiag; ++d) s[d] = offsets[d];
  for (int a = 1; a < ndiag; ++a)  // insertion sort: ndiag <= 16
    for (int b = a; b > 0 && s[b - 1] > s[b]; --b) {
      const long long t = s[b];
      s[b] = s[b - 1];
      s[b - 1] = t;
    }
  long long hi[kMaxDiags];
  int nseg = 0;
  for (int d = 0; d < ndiag; ++d) {
    if (nseg > 0 && s[d] - hi[nseg - 1] <= tile) {
      hi[nseg - 1] = s[d];
    } else {
      p->lo[nseg] = s[d];
      hi[nseg] = s[d];
      ++nseg;
    }
  }
  long long total = 0;
  for (int c = 0; c < nseg; ++c) {
    p->base[c] = static_cast<int>(total);
    p->width[c] = static_cast<int>(tile + (hi[c] - p->lo[c]));
    total += p->width[c];
  }
  if (total * elem_bytes > kSmemBudget) return false;
  for (int c = nseg; c < kMaxDiags; ++c) p->lo[c] = 0, p->width[c] = 0, p->base[c] = 0;
  for (int d = 0; d < kMaxDiags; ++d) {
    p->pos[d] = 0;
    if (d >= ndiag) continue;
    for (int c = 0; c < nseg; ++c)
      if (offsets[d] >= p->lo[c] && offsets[d] <= hi[c])
        p->pos[d] = p->base[c] + static_cast<int>(offsets[d] - p->lo[c]);
  }
  p->nseg = nseg;
  p->ndiag = ndiag;
  p->tile = tile;
  p->smem_elems = static_cast<int>(total);
  return true;
}

template <typename T>
static int launch_stream(const void* bands, long long stride, const void* x, void* y, long long n,
                         const long long* offsets, int ndiag, void* stream) {
  if (n < 0 || stride < n || ndiag < 1 || ndiag > kMaxDiags)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  StreamPlan p;
  bool ok = false;
  for (int tile : kTiles)
    if ((ok = make_plan(offsets, ndiag, tile, static_cast<int>(sizeof(T)), &p))) break;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // the >48 KB opt-in holds for the current device only: set it on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      dia_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (n + p.tile - 1) / p.tile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dia_stream_kernel<T><<<static_cast<unsigned int>(blocks), kStreamThreads,
                         static_cast<size_t>(p.smem_elems) * sizeof(T),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bands), stride, static_cast<const T*>(x), static_cast<T*>(y), n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cgx

extern "C" {

// bands: ndiag rows of `stride` elements (stride = n for the flat form,
// rows_p * cols for the planes form); x and y: n elements.
int cgx_dia_matvec_stream_f32(const void* bands, long long stride, const void* x, void* y,
                              long long n, const long long* offsets, int ndiag, void* stream) {
  return cgx::launch_stream<float>(bands, stride, x, y, n, offsets, ndiag, stream);
}

int cgx_dia_matvec_stream_f64(const void* bands, long long stride, const void* x, void* y,
                              long long n, const long long* offsets, int ndiag, void* stream) {
  return cgx::launch_stream<double>(bands, stride, x, y, n, offsets, ndiag, stream);
}

}  // extern "C"
