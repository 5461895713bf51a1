// The arguments of the fused s-step block's two launches (kernels B10: the
// Gram launch in sstep_stream.cu, the recover launch in sstep_recover.cu),
// and what both designs of each share.
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
};

// the slab's rows of each level, m x tile, in the block's scratch
template <typename T>
struct LevelSink {
  T* lv;
  long long t0, tile;
  __device__ void operator()(int level, long long j, T v) { lv[level * tile + (j - t0)] = v; }
};

template <typename T, typename B>
static void block_pointers(BlockArgs<T, B>* g, void* const* pr, void* x, void* state,
                           const void* bmat, void* ticket) {
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
                       long long tile, int grid) {
  if (!make_basis(&g->a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      tile < 1 || grid < 1)
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
                            const long long* plan, int plan_len, int grid) {
  if (!make_basis(&g->a, bands, n, offsets, ndiag, s, theta, delta, shifts, nshifts) ||
      !make_wave_plan<T>(pl, plan, plan_len, s, n, g->a.reach, grid))
    return false;
  block_pointers(g, pr, x, state, bmat, ticket);
  return true;
}

}  // namespace cgx
