// All-pairs pass (kernel K3): per-point sums over every pair of the first n
// points, for a force given as a device functor (forces.cuh).
//
// Replaces yalla_tpu/ops/tile_pallas.py::tile_pairwise_pallas, the TPU's
// 8 x 128 pair-tile kernel.  What it computes, not its TPU layout: for every
// row i, the sums over j < n of the functor's pair terms (dF, aux, the
// friction and friction * old_v[j]); the i == j diagonal is included, as
// the functor's self_pair (models put reaction terms there); inactive j
// (j >= n) are masked; rows i >= n are computed but are don't-care.
//
// Design (the reference's compute_tile, solvers.cuh:282-339): one thread
// per i, 128 to a block.  The block stages j in tiles of 128 points (every
// channel and old_v) in shared memory with coalesced loads; every thread
// then reads the same j from the tile (a broadcast, no bank conflicts),
// evaluates the functor and accumulates its sums in registers, written
// once, in the rows of tile_pallas.py: dF fields, aux, sum_f, sum_v xyz
// (the wrapper names them from the functor's entry in ops/functors.py).
//
// Bound: the pair arithmetic, issued by too few threads.  At the 5k sorting
// configuration (n_pad 5120) the pass is 26M pairs at about 25 operations
// each, which the card's 132 SMs could issue in some 20 us; but 5120
// threads make 40 blocks, so 92 SMs idle and each busy SM holds four warps,
// each running 5000 dependent iterations with little to hide their
// latency.  Splitting j across blocks (a second reduction pass, or atomics)
// is later work.
//
// Numerics: dist comes from pair_dist (no FMA contraction, IEEE sqrt), as
// the plain torch version rounds it, so the gates (dist < r_max, dist < 1)
// decide exactly as it does and the counters agree exactly.  The force
// values may contract into FMAs and use rsqrtf, and the sums run in j
// order; they agree with the plain version to f32 rounding.
#include <cuda_runtime.h>

#include <cstring>

#include "forces.cuh"

namespace {

constexpr int kThreads = 128;  // i per block, and the width of a j tile

template <int N>
struct Ptrs {
  const float* p[N];
};

template <class Cell, int N>
__device__ __forceinline__ Cell as_cell(const float (&v)[N]) {
  static_assert(sizeof(Cell) == N * sizeof(float), "a Cell is N floats");
  Cell c;
  memcpy(&c, v, sizeof(Cell));
  return c;
}

// ch: the functor's kFields channels, then old_v x y z, each [n_pad]
template <class Force>
__global__ void __launch_bounds__(kThreads)
tile_pair_kernel(const Force f, const Ptrs<Force::kFields + 3> ch, int n,
                 int n_pad, float* __restrict__ out) {
  using Cell = typename Force::Cell;
  constexpr int kF = Force::kFields;
  __shared__ float tile[kF + 3][kThreads];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;

  float av[kF];
#pragma unroll
  for (int k = 0; k < kF; ++k) av[k] = i < n_pad ? ch.p[k][i] : 0.0f;
  const Cell a = as_cell<Cell>(av);
  float acc[Force::kSums];
#pragma unroll
  for (int m = 0; m < Force::kSums; ++m) acc[m] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += kThreads) {
    __syncthreads();  // the previous tile is consumed
    const int jl = j0 + t;
#pragma unroll
    for (int k = 0; k < kF + 3; ++k) tile[k][t] = jl < n ? ch.p[k][jl] : 0.0f;
    __syncthreads();
    const int jn = min(kThreads, n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      if (j0 + jj == i) {
        f.self_pair(a, acc);
        continue;
      }
      float bv[kF];
#pragma unroll
      for (int k = 0; k < kF; ++k) bv[k] = tile[k][jj];
      const Cell b = as_cell<Cell>(bv);
      const float dist = yalla::pair_dist(a.x, a.y, a.z, b.x, b.y, b.z);
      f.pair(a, b, dist, tile[kF][jj], tile[kF + 1][jj], tile[kF + 2][jj],
             acc);
    }
  }
  if (i < n_pad) {
#pragma unroll
    for (int m = 0; m < Force::kSums; ++m)
      out[(long long)m * n_pad + i] = acc[m];
  }
}

template <class Force>
int launch(const Force& f, const void* const* chans, int n, int n_pad,
           float* out, cudaStream_t stream) {
  if (n < 0 || n > n_pad) return (int)cudaErrorInvalidValue;
  Ptrs<Force::kFields + 3> ch;
  for (int k = 0; k < Force::kFields + 3; ++k)
    ch.p[k] = (const float*)chans[k];
  const int blocks = (n_pad + kThreads - 1) / kThreads;
  if (blocks > 0)
    tile_pair_kernel<<<blocks, kThreads, 0, stream>>>(f, ch, n, n_pad, out);
  return (int)cudaGetLastError();
}

}  // namespace

// chans: host array of the functor's channel pointers then old_v x y z,
// each [n_pad] f32 on the device; params: host array of the functor's
// parameters; out: [kSums, n_pad] f32 on the device.
extern "C" int yalla_tile_pair_branching(const void* const* chans, int n,
                                         int n_pad, const float* params,
                                         float* out, cudaStream_t stream) {
  yalla::BranchingForce f;
  f.p = yalla::BranchingParams{params[0], params[1], params[2], params[3],
                               params[4], params[5], params[6], params[7],
                               params[8], params[9]};
  return launch(f, chans, n, n_pad, out, stream);
}

extern "C" int yalla_tile_pair_sorting(const void* const* chans, int n,
                                       int n_pad, const float* params,
                                       float* out, cudaStream_t stream) {
  const yalla::SortingAdhesion f{params[0], params[1]};
  return launch(f, chans, n, n_pad, out, stream);
}
