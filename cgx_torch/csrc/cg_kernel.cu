// Whole-solve CG kernel for Hopper (sm_90a), float and double: one launch runs a
// chunk of iterations of the reference recurrence, optionally with the degree-1
// Neumann preconditioner M^-1 r = 2 D^-1 r - D^-1 A D^-1 r.
//
// Replaces the Pallas TPU kernels of cgx/ops/cg_kernel.py:
//   _dia_cg_vmem    (_chunk_kernel,   pallas_call at cg_kernel.py:245)
//   _dia_cg_vmem2d  (_chunk_kernel2d, pallas_call at cg_kernel.py:479)
// The two compute the same function; the second only tiles the vectors as
// (rows, cols) planes for the TPU's (8, 128) registers and Mosaic's tiling. On
// Hopper one kernel over flat vectors serves both. As in cgx, the bands may be
// stored in bfloat16 under float vectors (entry cgx_dia_cg_chunk_f32_bf16b, the
// refinement's inner solve): each band value is widened to float as it is loaded
// (dia_row.cuh), which halves the bands' share of the traffic; the float and
// double entries compute what they did before, bit for bit.
//
// Two designs, picked on the host by cgx_torch.ops.cg_kernel.resident_plan:
// "resident" (dia_cg_resident_kernel, below) where a block's vectors fit on
// chip, else "global" (dia_cg_chunk_kernel), whose state lives in device memory.
//
// The global design. Per iteration, with the scalars [rsold, converged, k,
// breakdown] carried in registers, in double, and identical in every block:
//   (a) Ap = A p on the block's rows, and the block's partial of <p, Ap>;  grid sync
//   (b) alpha from the ordered sum of all blocks' partials; x += alpha p,
//       r -= alpha Ap, the partial of <r, r>; with the preconditioner also
//       c = D^-1 r;                                                      grid sync
//       (precond) z = 2c - D^-1 A c (c's halo comes from the neighbours), the
//       partial of <r, z>, z kept in Ap's slot;                          grid sync
//   (c) beta, conv_now, k from the ordered sums; p = new_dir + beta p on the
//       block's rows;                                                    grid sync
// An iteration that starts inactive (converged, or k = maxiter) ends the chunk
// in every block at once, since every block holds the same scalars; x and r are
// written only while active, p and k only while active and not converging, the
// frozen-iteration rules of cgx's _chunk_kernel. Block 0 writes the scalars back.
//
// Dots: each block owns a fixed, contiguous range of rows; a block sums its
// rows' products in thread order, then with a shuffle tree (common.cuh); then
// EVERY block reads all blocks' partials and sums them in index order, so alpha
// and beta are bitwise the same in every block and on every run. No float
// atomics, no ticket. The three dots use three partial buffers: a fast block
// writes <r, r> partials while a slow one may still read the <p, Ap> ones.
//
// Precision: the dots sum in double and the scalars stay in double (a float
// product is exact in double); alpha and beta round to the data's type only
// where they scale vectors. For float data that is the arithmetic of
// cg_solve(dot_precision=float64), the plain loop of solve(precision="fp32"),
// so the two take the same iterations. cgx's TPU kernel keeps float scalars,
// and so did this one at first: the float Neumann PCG count then followed the
// rounding of the scalars, 1948 iterations on lap2d_fd(1414) at tol 1e-5 ||b||
// against the plain loop's 1899, and 1141 on lap2d_fd(1000) against 1200 when
// the plain loop's dots were float too.
//
// Halos: p is read with a halo in (a) and rewritten in place in (c). The grid
// sync that ends (a) makes the in-place write safe: every block has finished
// reading p's halo before any block starts (b), let alone (c); the sync that
// ends (c) publishes the new p to the next (a). c is written in (b) and read
// with a halo after the next sync. p and c are read with plain (coherent) loads,
// never through the read-only path, since they change within the launch.
//
// Bound: memory. The recurrence must move, per iteration, the bands once, p, x
// and r in and p, x and r out: (ndiag + 6) N words; the preconditioner adds a
// second band pass and c out and back, (2 ndiag + 8) N. The global design
// moves, before caching, (ndiag + 11) N words (Ap out and back in, p read in
// (a), (b) and (c)) and (2 ndiag + 17) N with the preconditioner. For 5 bands
// at N = 1,000,000 in float the state (bands, x, r, p, Ap: 36 MB) largely stays
// in the 50 MB L2, so it can beat the HBM bound there; at 4,000,000 it cannot.
// Three grid syncs (four with the preconditioner) and three ordered sums of all
// partials are its fixed cost an iteration. It asks for 4 blocks of 256
// threads an SM (at most 64 registers a thread): the compiler's own choice, 128
// registers and 2 blocks, left too few loads in flight (36.3 us an iteration
// at N = 1e6 in float, chip_smoke.py on an earlier build). It took 2.0719 ms a
// 64-iteration chunk there (3.0386 with bf16 bands and the preconditioner) on
// an H100 (PERF.md).
//
// The resident design (dia_cg_resident_kernel) keeps the state on chip across
// the chunk, as cgx's TPU kernel keeps it in VMEM. One block of kResThreads an
// SM on a cooperative grid; block b owns rows [b rows, (b + 1) rows), thread t
// its rows lo + t + j kResThreads, j < R. x, r and Ap (then z) of a thread's rows
// sit in registers from the launch's start to its end; p (and c) of the
// block's rows and halo sit in shared memory, and so do the block's bands where
// the plan finds room (else they stream from L2 as before). What another block
// reads is published each iteration to a device-memory pair that alternates by
// iteration parity: p, the new direction's source (r, or z with the
// preconditioner) and c, each only for the rows within reach of the block's
// edges. Per iteration:
//   (A) beta from the last iteration; p = src + beta p on the block's rows and
//       on its halo, the halo's from the published pair of the last iteration
//       (the same operations as the owner's, so bitwise the owner's values; the
//       first iteration of a launch takes p as given); publish p; Ap and the
//       partial of <p, Ap>;                                             grid sync
//   (B) alpha; x += alpha p, r -= alpha Ap, the partial of <r, r>; publish r
//       (with the preconditioner c = D^-1 r, published, instead);        grid sync
//   (Z) (precond) c's halo from this iteration's pair, z = 2c - D^-1 A c, the
//       partial of <r, z>, publish z;                                    grid sync
// So two grid syncs an iteration, three with the preconditioner. Each is
// resident_sync: the block's partial, a counting barrier on one word in
// device memory (a cooperative launch keeps every block resident, so it
// cannot deadlock), then the ordered sum read by one warp: one block barrier
// where cooperative_groups' grid.sync followed by the sum took three.
// p of the block's rows goes back to device memory at the end of the launch,
// with the last beta applied where the last iteration advanced, and x and r
// with it.
// The writes of one parity are read in the next iteration and rewritten only
// in the one after, two grid syncs later; every published value is read with
// ld.global.cg (L2), never through L1 or the read-only path. The dots and the
// scalars keep the rules above; the grouping of the dots changes with the
// grid (512 threads, one block an SM), which tests/test_torch_cg_kernel.py
// replays against the fp64 goldens. Its fixed cost, the syncs and ordered sums
// alone, is what chip_smoke.py times as the sync floor (empty = 1). On an H100
// a 64-iteration chunk at N = 1e6 in float takes 0.70 ms, about half of it that
// floor, against the global design's 2.14 (PERF.md).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "dia_row.cuh"

namespace cgx {

namespace cg = cooperative_groups;

template <typename T, typename B>
struct ChunkArgs {
  const B* bands;  // (ndiag, n), in the vectors' type or bfloat16
  T* p;            // read with a halo in (a), rewritten in (c)
  T* x;
  T* r;
  T* ap;           // Ap, then z with the preconditioner
  T* c;            // D^-1 r (preconditioner only)
  double* partials;  // 3 * gridDim.x: <p, Ap>, <r, r>, <r, z>
  const double* scal_in;  // [rsold, converged, k, breakdown]
  double* scal_out;
  long long n;
  long long rows;  // rows per block
  Offsets o;
  int d0;          // index of offset 0 (preconditioner only)
  double tol, nearzero, maxiter;
  int chunk;
};

// max that propagates a NaN from either side, as torch.maximum and jnp.maximum do
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// The sum of all blocks' partials in index order, in every thread of the block.
__device__ double ordered_total(const double* parts) {
  __shared__ double total;
  double v = 0.0;
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads) v += parts[j];
  v = block_sum(v);  // its leading __syncthreads also guards `total` from the last call
  if (threadIdx.x == 0) total = v;
  __syncthreads();
  return total;
}

template <typename T, typename B, bool kPrecond>
__global__ void __launch_bounds__(kThreads, 4) dia_cg_chunk_kernel(ChunkArgs<T, B> a) {
  cg::grid_group grid = cg::this_grid();
  double* part_pap = a.partials;
  double* part_rr = a.partials + gridDim.x;
  double* part_rz = a.partials + 2 * gridDim.x;
  const long long lo = static_cast<long long>(blockIdx.x) * a.rows;
  const long long hi = lo + a.rows < a.n ? lo + a.rows : a.n;
  const long long first = lo + threadIdx.x;
  const B* diag = a.bands + a.d0 * a.n;

  double rsold = a.scal_in[0], conv = a.scal_in[1], k = a.scal_in[2], brk = a.scal_in[3];
  for (int it = 0; it < a.chunk; ++it) {
    if (!(conv == 0.0 && k < a.maxiter)) break;  // the same decision in every block

    // (a) Ap and <p, Ap>
    double part = 0.0;
    for (long long i = first; i < hi; i += kThreads) {
      const T v = dia_row(a.bands, a.p, a.n, a.o, i);
      a.ap[i] = v;
      part += static_cast<double>(a.p[i]) * v;
    }
    part = block_sum(part);
    if (threadIdx.x == 0) part_pap[blockIdx.x] = part;
    grid.sync();

    // (b) alpha, x, r, <r, r> (and c = D^-1 r)
    const double conj = ordered_total(part_pap);
    if (conj <= 0.0) brk = 1.0;
    const T alpha = static_cast<T>(rsold / nan_max(conj, rsold * a.nearzero));
    part = 0.0;
    for (long long i = first; i < hi; i += kThreads) {
      const T pi = a.p[i];
      const T ri = a.r[i] - alpha * a.ap[i];
      a.x[i] = a.x[i] + alpha * pi;
      a.r[i] = ri;
      part += static_cast<double>(ri) * ri;
      if (kPrecond) a.c[i] = (T(1) / widen(diag[i])) * ri;
    }
    part = block_sum(part);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = part;
    grid.sync();

    if (kPrecond) {  // z = 2c - D^-1 A c and <r, z>; Ap is spent, its slot takes z
      part = 0.0;
      for (long long i = first; i < hi; i += kThreads) {
        const T zi = T(2) * a.c[i] - (T(1) / widen(diag[i])) * dia_row(a.bands, a.c, a.n, a.o, i);
        a.ap[i] = zi;
        part += static_cast<double>(a.r[i]) * zi;
      }
      part = block_sum(part);
      if (threadIdx.x == 0) part_rz[blockIdx.x] = part;
      grid.sync();
    }

    // (c) convergence, beta and the new direction
    const double rr = ordered_total(part_rr);
    const bool conv_now = sqrt(rr) < a.tol;
    const double rsnew = kPrecond ? ordered_total(part_rz) : rr;
    if (conv_now) {
      conv = 1.0;  // break before update: p, rsold and k keep their values
    } else {
      const T beta = static_cast<T>(rsnew / rsold);
      const T* new_dir = kPrecond ? a.ap : a.r;
      for (long long i = first; i < hi; i += kThreads) a.p[i] = new_dir[i] + beta * a.p[i];
      rsold = rsnew;
      k = k + 1.0;
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scal_out[0] = rsold;
    a.scal_out[1] = conv;
    a.scal_out[2] = k;
    a.scal_out[3] = brk;
  }
}

constexpr int kResThreads = 512;  // cgx_torch.ops.cg_kernel.RES_THREADS; one block an SM
// polls of the grid barrier after which a launch gives up (seconds; a barrier takes microseconds)
constexpr unsigned int kResMaxPolls = 1u << 24;

template <typename T, typename B>
struct ResidentArgs {
  const B* bands;    // (ndiag, n), in the vectors' type or bfloat16
  T* p;              // in at the launch's start, out at its end
  T* x;
  T* r;
  T* pub;            // pairs of n: p, the direction's source (r or z), c (precond only)
  double* partials;  // 3 * gridDim.x: <p, Ap>, <r, r>, <r, z>
  const double* scal_in;  // [rsold, converged, k, breakdown]
  double* scal_out;
  long long n;
  long long rows;    // rows a block (the last may have fewer)
  long long left;    // rows below a block's own that its products read
  long long right;   // and above
  Offsets o;
  int d0;            // index of offset 0 (preconditioner only)
  double tol, nearzero, maxiter;
  int chunk;
  int empty;         // 1: only the syncs and ordered sums (the sync floor)
  unsigned int* bar;  // the grid barrier's count, zero at launch
};

// This block's partial (valid in thread 0) to parts, a grid barrier, then the
// ordered sum of all blocks' partials in every thread. The barrier is the
// launch's round-th: thread 0 arrives on *bar (zero at launch) after a fence
// that makes the block's writes visible (the partial, and through the block
// barrier before it, every published row), and waits until all gridDim.x
// blocks have arrived round times. Then lane l of warp 0 sums partials l,
// l + 32, ... in order (coherent loads), a shuffle tree adds the lanes, and
// one block barrier hands the total on. The two slots of `total` alternate,
// so one call's write cannot race the reads of the call before.
__device__ double resident_sync(double part, double* parts, unsigned int* bar,
                                unsigned int round, int slot) {
  __shared__ double total[2];
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      parts[blockIdx.x] = part;
      __threadfence();
      atomicAdd(bar, 1u);
      const unsigned int target = round * gridDim.x;
      unsigned int seen;
      for (unsigned int polls = 0;; ++polls) {
        asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(seen) : "l"(bar) : "memory");
        if (seen >= target) break;
        if (polls == kResMaxPolls) __trap();  // a block never came: fail, do not hang the card
      }
    }
    __syncwarp();
    double v = 0.0;
#pragma unroll 4
    for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += 32) v += __ldcg(parts + j);
    v = warp_sum(v);
    if (threadIdx.x == 0) total[slot] = v;
  }
  __syncthreads();
  return total[slot];
}

// acc[j] = row lo + l_j of A v for this thread's rows l_j = t + j kResThreads
// (relative to lo, clamped to the block's last row, own - 1), with band d of
// relative row l at bs[d * bstride + l] and v's relative row l at vs[l + left]:
// the terms in offset order, each only where its column lies in [0, n), as
// dia_row. Offsets outermost and rows innermost, without branches, so the
// R rows' loads and sums interleave.
template <typename T, typename B, int R>
__device__ __forceinline__ void resident_rows(T (&acc)[R], const B* bs, long long bstride,
                                              const T* vs, int left, int lo, int own, int n,
                                              const Offsets& o) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {  // static indices keep o in the parameter bank
    if (d < o.ndiag) {
      const int off = static_cast<int>(o.off[d]);
      const B* bd = bs + d * bstride;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int l = min(static_cast<int>(threadIdx.x) + j * kResThreads, own - 1);
        const int col = lo + l + off;
        const T term = widen(bd[l]) * vs[l + left + off];
        acc[j] = (col >= 0 && col < n) ? acc[j] + term : acc[j];
      }
    }
  }
}

template <typename T, typename B, bool kPrecond, int R, bool kBandsShared>
__global__ void __launch_bounds__(kResThreads, 1) dia_cg_resident_kernel(ResidentArgs<T, B> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = static_cast<int>(a.n);  // launch_resident keeps n below 2^31
  const int rows = static_cast<int>(a.rows), left = static_cast<int>(a.left);
  const int right = static_cast<int>(a.right);
  const int lo = static_cast<int>(blockIdx.x) * rows;
  const int own = min(rows, n - lo);          // the block's rows: [lo, lo + own)
  const int elo = max(0, lo - left) - lo;     // its halo, relative to lo:
  const int ehi = min(n, lo + own + right) - lo;  // [elo, 0) and [own, ehi)
  const int t = threadIdx.x;
  B* bsh = reinterpret_cast<B*>(smem);
  const long long band_bytes =
      kBandsShared ? (static_cast<long long>(a.o.ndiag) * rows * sizeof(B) + 15) / 16 * 16 : 0;
  T* psh = reinterpret_cast<T*>(smem + band_bytes);  // relative row l of p at psh[l + left]
  T* csh = psh + (rows + left + right);             // and of c
  // band d of relative row l at bs[d * bstride + l]
  const B* bs = kBandsShared ? bsh : a.bands + lo;
  const long long bstride = kBandsShared ? rows : a.n;
  const B* diag = bs + a.d0 * bstride;
  double* part_pap = a.partials;
  double* part_rr = a.partials + gridDim.x;
  double* part_rz = a.partials + 2 * gridDim.x;
  const bool work = !a.empty;
  // who else reads relative row l: the blocks above [own - left, own), those below [0, right)
  const auto published = [&](int l) { return l >= own - left || l < right; };
  const auto row = [&](int j) { return min(t + j * kResThreads, own - 1); };  // clamped
  const auto mine = [&](int j) { return t + j * kResThreads < own; };

  T xv[R], rv[R], wv[R];  // x, r and Ap (then z) of this thread's rows
#pragma unroll
  for (int j = 0; j < R; ++j) {
    xv[j] = rv[j] = wv[j] = T(0);
    if (work) {
      xv[j] = a.x[lo + row(j)];
      rv[j] = a.r[lo + row(j)];
    }
  }
  if (kBandsShared && work)
    for (int d = 0; d < a.o.ndiag; ++d)
      for (int l = t; l < own; l += kResThreads)
        bsh[d * rows + l] = a.bands[d * a.n + lo + l];

  double rsold = a.scal_in[0], conv = a.scal_in[1], k = a.scal_in[2], brk = a.scal_in[3];
  T beta = T(0);
  bool ran = false, pending = false;  // an iteration ran; the last one advanced p
  unsigned int round = 0;             // grid barriers passed
  for (int it = 0; it < a.chunk; ++it) {
    if (!(conv == 0.0 && k < a.maxiter)) break;  // the same decision in every block
    const long long q = it & 1;
    T* p_w = a.pub + q * a.n + lo;              // this iteration's p
    const T* p_r = a.pub + (q ^ 1) * a.n + lo;  // the last one's
    T* s_w = a.pub + (2 + q) * a.n + lo;        // the direction's source: r, or z
    const T* s_r = a.pub + (2 + (q ^ 1)) * a.n + lo;
    T* c_w = a.pub + (4 + q) * a.n + lo;

    // (A) p on the block's rows and halo, then Ap and <p, Ap>
    double part = 0.0;
    if (work) {
      if (it == 0) {
        const T* p0 = a.p + lo;
        for (int l = elo + t; l < ehi; l += kResThreads) psh[l + left] = __ldcg(p0 + l);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (mine(j))
            psh[row(j) + left] = (kPrecond ? wv[j] : rv[j]) + beta * psh[row(j) + left];
#pragma unroll 4
        for (int l = elo + t; l < 0; l += kResThreads)
          psh[l + left] = __ldcg(s_r + l) + beta * __ldcg(p_r + l);
#pragma unroll 4
        for (int l = own + t; l < ehi; l += kResThreads)
          psh[l + left] = __ldcg(s_r + l) + beta * __ldcg(p_r + l);
      }
      __syncthreads();  // p's rows and halo are in shared memory
      resident_rows(wv, bs, bstride, psh, left, lo, own, n, a.o);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const T pi = psh[row(j) + left];
        if (mine(j) && published(row(j))) p_w[row(j)] = pi;
        part = part + (mine(j) ? static_cast<double>(pi) * wv[j] : 0.0);
      }
    }
    const double conj =
        resident_sync(block_sum<double, kResThreads>(part), part_pap, a.bar, ++round, 0);

    // (B) alpha, x, r, <r, r>; publish r, or c = D^-1 r
    if (conj <= 0.0) brk = 1.0;
    const T alpha = static_cast<T>(rsold / nan_max(conj, rsold * a.nearzero));
    part = 0.0;
    if (work) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int l = row(j);
        const T ri = rv[j] - alpha * wv[j];
        xv[j] = xv[j] + alpha * psh[l + left];
        rv[j] = ri;
        part = part + (mine(j) ? static_cast<double>(ri) * ri : 0.0);
        if (kPrecond) {
          const T ci = (T(1) / widen(diag[l])) * ri;
          if (mine(j)) {
            csh[l + left] = ci;
            if (published(l)) c_w[l] = ci;
          }
        } else if (mine(j) && published(l)) {
          s_w[l] = ri;
        }
      }
    }
    const double rr =
        resident_sync(block_sum<double, kResThreads>(part), part_rr, a.bar, ++round, 1);

    double rz = 0.0;
    if (kPrecond) {  // (Z) z = 2c - D^-1 A c and <r, z>; publish z
      part = 0.0;
      if (work) {
#pragma unroll 4
        for (int l = elo + t; l < 0; l += kResThreads) csh[l + left] = __ldcg(c_w + l);
#pragma unroll 4
        for (int l = own + t; l < ehi; l += kResThreads) csh[l + left] = __ldcg(c_w + l);
        __syncthreads();  // c's halo is in shared memory
        T ac[R];
        resident_rows(ac, bs, bstride, csh, left, lo, own, n, a.o);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int l = row(j);
          const T zi = T(2) * csh[l + left] - (T(1) / widen(diag[l])) * ac[j];
          wv[j] = zi;
          part = part + (mine(j) ? static_cast<double>(rv[j]) * zi : 0.0);
          if (mine(j) && published(l)) s_w[l] = zi;
        }
      }
      rz = resident_sync(block_sum<double, kResThreads>(part), part_rz, a.bar, ++round, 0);
    }

    // convergence and beta; p moves at the start of the next iteration
    const bool conv_now = sqrt(rr) < a.tol;
    const double rsnew = kPrecond ? rz : rr;
    ran = true;
    if (conv_now) {
      conv = 1.0;  // break before update: p, rsold and k keep their values
      pending = false;
    } else {
      beta = static_cast<T>(rsnew / rsold);
      pending = true;
      rsold = rsnew;
      k = k + 1.0;
    }
  }
  if (work) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (mine(j)) {
        const int l = row(j);
        if (ran) {
          const T pi = psh[l + left];
          a.p[lo + l] = pending ? (kPrecond ? wv[j] : rv[j]) + beta * pi : pi;
        }
        a.x[lo + l] = xv[j];
        a.r[lo + l] = rv[j];
      }
    }
  }
  if (blockIdx.x == 0 && t == 0) {
    a.scal_out[0] = rsold;
    a.scal_out[1] = conv;
    a.scal_out[2] = k;
    a.scal_out[3] = brk;
  }
}

template <typename T, typename B, bool kPrecond>
static int launch_chunk(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                        void* partials, long long partials_len, const void* scal_in,
                        void* scal_out, long long n, const long long* offsets, int ndiag, int d0,
                        double tol, double nearzero, double maxiter, int chunk, int* grid_out,
                        void* stream) {
  ChunkArgs<T, B> a;
  if (n < 0 || chunk < 0 || !make_offsets(offsets, ndiag, &a.o) || (kPrecond && (d0 < 0 || d0 >= ndiag)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The grid is no larger than the blocks that fit at once, as a cooperative launch needs.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dia_cg_chunk_kernel<T, B, kPrecond>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long g = static_cast<long long>(per_sm) * sms;
  const long long need = (n + kThreads - 1) / kThreads;
  if (need < g) g = need;
  if (partials_len / 3 < g) g = partials_len / 3;
  if (g < 1) g = 1;
  a.bands = static_cast<const B*>(bands);
  a.p = static_cast<T*>(p);
  a.x = static_cast<T*>(x);
  a.r = static_cast<T*>(r);
  a.ap = static_cast<T*>(ap);
  a.c = static_cast<T*>(c);
  a.partials = static_cast<double*>(partials);
  a.scal_in = static_cast<const double*>(scal_in);
  a.scal_out = static_cast<double*>(scal_out);
  a.n = n;
  a.rows = (n + g - 1) / g;
  a.d0 = kPrecond ? d0 : 0;
  a.tol = tol;
  a.nearzero = nearzero;
  a.maxiter = maxiter;
  a.chunk = chunk;
  *grid_out = static_cast<int>(g);
  void* args[] = {&a};
  // a launch the card refuses (cudaErrorCooperativeLaunchTooLarge, ...) returns its code
  err = cudaLaunchCooperativeKernel((const void*)dia_cg_chunk_kernel<T, B, kPrecond>,
                                    dim3(static_cast<unsigned int>(g)), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B>
static int launch_chunk_any(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                            void* partials, long long partials_len, const void* scal_in,
                            void* scal_out, long long n, const long long* offsets, int ndiag,
                            int d0, double tol, double nearzero, double maxiter, int chunk,
                            int precond, int* grid_out, void* stream) {
  if (precond)
    return launch_chunk<T, B, true>(bands, p, x, r, ap, c, partials, partials_len, scal_in,
                                    scal_out, n, offsets, ndiag, d0, tol, nearzero, maxiter, chunk,
                                    grid_out, stream);
  return launch_chunk<T, B, false>(bands, p, x, r, ap, c, partials, partials_len, scal_in, scal_out,
                                n, offsets, ndiag, d0, tol, nearzero, maxiter, chunk, grid_out,
                                stream);
}

constexpr int kResPlanLen = 7;  // threads, rows, rows a thread, left, right, bands shared, shared bytes

template <typename T, typename B, bool kPrecond, int R, bool kBandsShared>
static int launch_resident_k(ResidentArgs<T, B>& a, int grid, int shared, void* stream) {
  const auto K = dia_cg_resident_kernel<T, B, kPrecond, R, kBandsShared>;
  cudaError_t err = allow_shared<dia_cg_resident_kernel<T, B, kPrecond, R, kBandsShared>>();
  // the grid is no larger than the blocks that fit at once, as a cooperative launch needs
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, kResThreads, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)K, dim3(static_cast<unsigned int>(grid)),
                                    dim3(kResThreads), args, static_cast<size_t>(shared),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B, bool kPrecond, int R>
static int launch_resident_r(ResidentArgs<T, B>& a, int grid, int shared, bool bands_shared,
                             void* stream) {
  return bands_shared ? launch_resident_k<T, B, kPrecond, R, true>(a, grid, shared, stream)
                      : launch_resident_k<T, B, kPrecond, R, false>(a, grid, shared, stream);
}

// The plan of cgx_torch.ops.cg_kernel.resident_plan. Refused unless the blocks
// cover [0, n) with rows each and none is empty, each thread's R rows cover a
// block's, the halo holds every offset's reach, the shared bytes hold p (and c)
// over a block's rows and halo (and the bands where the plan puts them there),
// and the partials hold three a block.
template <typename T, typename B>
static int launch_resident(const void* bands, void* p, void* x, void* r, void* pub, void* partials,
                           long long partials_len, void* bar, const void* scal_in, void* scal_out,
                           long long n, const long long* offsets, int ndiag, int d0, double tol,
                           double nearzero, double maxiter, int chunk, int precond,
                           const long long* plan, int plan_len, int grid, int empty,
                           void* stream) {
  ResidentArgs<T, B> a;
  if (n < 1 || n >= (1LL << 31) || chunk < 0 || grid < 1 || plan_len != kResPlanLen ||
      !make_offsets(offsets, ndiag, &a.o) || (precond && (d0 < 0 || d0 >= ndiag)) ||
      partials_len < 3LL * grid)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = plan[1], per_thread = plan[2], left = plan[3], right = plan[4];
  const bool bands_shared = plan[5] != 0;
  const long long shared = plan[6];
  long long need = (rows + left + right) * static_cast<long long>(sizeof(T)) * (precond ? 2 : 1);
  if (bands_shared) need += (ndiag * rows * static_cast<long long>(sizeof(B)) + 15) / 16 * 16;
  bool reach = true;
  for (int d = 0; d < ndiag; ++d) reach = reach && -offsets[d] <= left && offsets[d] <= right;
  if (plan[0] != kResThreads || rows < 1 || rows * grid < n || (grid - 1) * rows >= n ||
      per_thread * kResThreads < rows || left < 0 || right < 0 || !reach || shared < need ||
      shared > kSharedOptin)
    return static_cast<int>(cudaErrorInvalidValue);
  a.bands = static_cast<const B*>(bands);
  a.p = static_cast<T*>(p);
  a.x = static_cast<T*>(x);
  a.r = static_cast<T*>(r);
  a.pub = static_cast<T*>(pub);
  a.partials = static_cast<double*>(partials);
  a.scal_in = static_cast<const double*>(scal_in);
  a.scal_out = static_cast<double*>(scal_out);
  a.n = n;
  a.rows = rows;
  a.left = left;
  a.right = right;
  a.d0 = precond ? d0 : 0;
  a.tol = tol;
  a.nearzero = nearzero;
  a.maxiter = maxiter;
  a.chunk = chunk;
  a.empty = empty;
  a.bar = static_cast<unsigned int*>(bar);
  const int sh = static_cast<int>(shared);
  const auto by_r = [&](auto pc) -> int {
    constexpr bool P = decltype(pc)::value;
    if (per_thread == 4) return launch_resident_r<T, B, P, 4>(a, grid, sh, bands_shared, stream);
    if (per_thread == 8) return launch_resident_r<T, B, P, 8>(a, grid, sh, bands_shared, stream);
    if constexpr (sizeof(T) == 4)
      if (per_thread == 16)
        return launch_resident_r<T, B, P, 16>(a, grid, sh, bands_shared, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  };
  return precond ? by_r(std::true_type{}) : by_r(std::false_type{});
}

}  // namespace cgx

extern "C" {

int cgx_dia_cg_chunk_f32(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                         void* partials, long long partials_len, const void* scal_in,
                         void* scal_out, long long n, const long long* offsets, int ndiag, int d0,
                         double tol, double nearzero, double maxiter, int chunk, int precond,
                         int* grid_out, void* stream) {
  return cgx::launch_chunk_any<float, float>(bands, p, x, r, ap, c, partials, partials_len, scal_in,
                                      scal_out, n, offsets, ndiag, d0, tol, nearzero, maxiter,
                                      chunk, precond, grid_out, stream);
}

int cgx_dia_cg_chunk_f64(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                         void* partials, long long partials_len, const void* scal_in,
                         void* scal_out, long long n, const long long* offsets, int ndiag, int d0,
                         double tol, double nearzero, double maxiter, int chunk, int precond,
                         int* grid_out, void* stream) {
  return cgx::launch_chunk_any<double, double>(bands, p, x, r, ap, c, partials, partials_len,
                                               scal_in, scal_out, n, offsets, ndiag, d0, tol,
                                               nearzero, maxiter, chunk, precond, grid_out, stream);
}

int cgx_dia_cg_chunk_f32_bf16b(const void* bands, void* p, void* x, void* r, void* ap, void* c,
                               void* partials, long long partials_len, const void* scal_in,
                               void* scal_out, long long n, const long long* offsets, int ndiag,
                               int d0, double tol, double nearzero, double maxiter, int chunk,
                               int precond, int* grid_out, void* stream) {
  return cgx::launch_chunk_any<float, __nv_bfloat16>(bands, p, x, r, ap, c, partials, partials_len,
                                                     scal_in, scal_out, n, offsets, ndiag, d0, tol,
                                                     nearzero, maxiter, chunk, precond, grid_out,
                                                     stream);
}


// The resident design: the chunk's arguments, with the published pairs (4 n
// values, 6 n with the preconditioner) and the grid barrier's count (one
// zero unsigned) beside the partials, then the plan array of resident_plan
// and its grid, and empty (1: only the syncs and ordered sums).
#define CGX_RESIDENT_ENTRY(NAME, T, B)                                                         \
  int NAME(const void* bands, void* p, void* x, void* r, void* pub, void* partials,            \
           long long partials_len, void* bar, const void* scal_in, void* scal_out, long long n, \
           const long long* offsets, int ndiag, int d0, double tol, double nearzero,            \
           double maxiter, int chunk, int precond, const long long* plan, int plan_len,         \
           int grid, int empty, void* stream) {                                                 \
    return cgx::launch_resident<T, B>(bands, p, x, r, pub, partials, partials_len, bar, scal_in,\
                                      scal_out, n, offsets, ndiag, d0, tol, nearzero, maxiter,  \
                                      chunk, precond, plan, plan_len, grid, empty, stream);     \
  }

CGX_RESIDENT_ENTRY(cgx_dia_cg_resident_f32, float, float)
CGX_RESIDENT_ENTRY(cgx_dia_cg_resident_f64, double, double)
CGX_RESIDENT_ENTRY(cgx_dia_cg_resident_f32_bf16b, float, __nv_bfloat16)

}  // extern "C"
