// The arguments of the fused s-step block's two launches (kernels B10: the
// Gram launch in sstep_stream.cu, the recover launch in sstep_recover.cu),
// and what both designs of each share.
//
// The halo mode (the sharded route, cgx_torch.parallel.sstep_fused): the
// vectors and bands are a shard's extended rows, its n_loc rows with d rows of
// each neighbour on either side (zeros past the mesh's ends), and the launches
// cover only the window [w_lo, w_hi) of the shard's own rows: the slabs tile the
// window, so the Gram sums and the recover writes only its rows, while the
// generator reads the halo rows as it reads any row inside [0, n). With
// d >= s R the window's levels are those of the whole vector. The single-device
// launches are the window [0, n).
#pragma once

#include "sstep_basis.cuh"

namespace cgx {

template <typename T, typename B>
struct BlockArgs {
  Basis<T, B> a;
  const T* p[2];  // ping-pong pairs, read [blk % 2]
  const T* r[2];
  T* p_out[2];    // written [1 - blk % 2] by the recover launch
  T* r_out[2];
  T* x;           // recover: in place
  double* state;  // the packed float64 state (sstep_basis.cuh, enum State)
  const double* bmat;
  T* scratch;      // the slab design's, a block's: two working buffers, then m x tile levels
  long long per_block;  // scratch values a block
  long long half;  // values of one working buffer
  double* partials;  // gram: m(m+1)/2 a block
  unsigned int* ticket;
  long long tile;
  double tol, nearzero, maxiter;
  long long w_lo, w_hi;  // the window of rows the slabs tile
  int part;              // gram: store the block's G and mark it live, no replay
};

// the slab's rows of each level, m x tile, in the block's scratch
template <typename T>
struct LevelSink {
  T* lv;
  long long t0, tile;
  __device__ void operator()(int level, long long j, T v) { lv[level * tile + (j - t0)] = v; }
};

// The window of rows [w_lo, w_hi) inside [0, n), non-empty
template <typename T, typename B>
static bool set_window(BlockArgs<T, B>* g, long long w_lo, long long w_hi) {
  if (w_lo < 0 || w_hi > g->a.n || w_lo >= w_hi) return false;
  g->w_lo = w_lo;
  g->w_hi = w_hi;
  return true;
}

template <typename T, typename B>
static void block_pointers(BlockArgs<T, B>* g, void* const* pr, void* x, void* state,
                           const void* bmat, void* ticket) {
  g->part = 0;
  for (int t = 0; t < 2; ++t) {
    g->p[t] = static_cast<const T*>(pr[t]);
    g->r[t] = static_cast<const T*>(pr[2 + t]);
    g->p_out[t] = static_cast<T*>(pr[t]);
    g->r_out[t] = static_cast<T*>(pr[2 + t]);
  }
  g->x = static_cast<T*>(x);
  g->state = static_cast<double*>(state);
  g->bmat = static_cast<const double*>(bmat);
  g->ticket = static_cast<unsigned int*>(ticket);
}

// The slab design's arguments: the scratch holds block_scratch(tile, ...,
// keep = 2s + 1) values for each of grid blocks.
template <typename T, typename B>
static bool make_block(BlockArgs<T, B>* g, const void* bands, void* const* pr, void* x,
                       void* state, const void* bmat, void* scratch, long long scratch_len,
                       void* ticket, long long n, const long long* offsets, int ndiag, int s,
                       double theta, double delta, const double* shifts, int nshifts,
                       long long tile, int grid, long long w_lo, long long w_hi) {
  if (!make_basis(&g->a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      tile < 1 || grid < 1 || !set_window(g, w_lo, w_hi))
    return false;
  const long long need = block_scratch(tile, g->a.reach, s, 2 * s + 1);
  if (scratch_len < need * grid) return false;
  block_pointers(g, pr, x, state, bmat, ticket);
  g->scratch = static_cast<T*>(scratch);
  g->per_block = need;
  g->half = basis_scratch(tile, g->a.reach, s) / 2;
  g->tile = tile;
  return true;
}

// The wavefront design's arguments: the basis and the plan, no scratch
template <typename T, typename B>
static bool make_wave_block(BlockArgs<T, B>* g, WavePlan* pl, const void* bands, void* const* pr,
                            void* x, void* state, const void* bmat, void* ticket, long long n,
                            const long long* offsets, int ndiag, int s, double theta,
                            double delta, const double* shifts, int nshifts,
                            const long long* plan, int plan_len, int grid,
                            long long w_lo, long long w_hi) {
  if (!make_basis(&g->a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      !set_window(g, w_lo, w_hi) ||
      !make_wave_plan<T>(pl, plan, plan_len, s, w_hi - w_lo, g->a.reach, grid))
    return false;
  block_pointers(g, pr, x, state, bmat, ticket);
  return true;
}

}  // namespace cgx
