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
// Bound: the pair arithmetic.  At the 5k sorting configuration (n 5000,
// n_pad 5120) a pass is 25M pairs at about 30 operations each, two of them
// on the MUFU unit (sqrtf, rsqrtf): some 15-20 us at the card's f32 rate.
// The first version ran one thread per i in 40 blocks of 128 threads, so
// 92 of the 132 SMs idled and each busy SM held four warps running 5000
// dependent iterations.
//
// Design for Hopper:
// * j is split across blocks.  The grid is (ceil(n_pad / (128 R)), S):
//   block (bx, s) takes R i-points per thread, held in registers (R is a
//   template parameter per functor: 4 for the 7-sum sorting functor, 2 for
//   the 13-sum branching functor with its 9 fields), and the j range
//   [s * chunk, min(n, (s + 1) * chunk)).  ops/tile_pallas.py::tile_plan
//   picks S so that no SM holds more than four blocks and most hold four.
// * The j range streams through two shared-memory tiles of kTileJ points
//   (every channel and old_v), filled by cp.async while the other tile is
//   consumed.  Every read of a j value from shared memory (a broadcast)
//   feeds R pairs.
// * No atomics: each block writes its partial sums to a scratch
//   [S, kSums, n_pad] (allocated by the wrapper), and tile_reduce_kernel
//   sums over S in fixed order into out.  Counters (sum_f, epi_nbs) are
//   integers below 2^24, exact in any order.
// * The diagonal is evaluated once, by the split whose j range holds i.
//
// Numerics: dist comes from pair_dist (no FMA contraction, IEEE sqrt), as
// the plain torch version rounds it, so the gates (dist < r_max, dist < 1)
// decide exactly as it does and the counters agree exactly.  The force
// values may contract into FMAs and use rsqrtf, and the sums run in j
// order within a split, then over the splits; they agree with the plain
// version to f32 rounding.
#include <cuda_runtime.h>

#include <cstring>

#include "cp_async.cuh"
#include "forces.cuh"

namespace {

using yalla::cp_async4;
using yalla::cp_async_commit;
using yalla::cp_async_wait;

constexpr int kThreads = 128;  // threads per block
constexpr int kTileJ = 64;     // j points per shared-memory tile

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

// Start the copy of j in [j0, min(j0 + kTileJ, j_hi)) of every channel
// into ``tile``, as one cp.async group.
template <int K>
__device__ __forceinline__ void stage(float (*tile)[kTileJ],
                                      const Ptrs<K>& ch, int j0, int j_hi) {
  for (int e = threadIdx.x; e < K * kTileJ; e += kThreads) {
    const int k = e / kTileJ, jj = e % kTileJ;
    if (j0 + jj < j_hi) cp_async4(&tile[k][jj], ch.p[k] + j0 + jj);
  }
  cp_async_commit();
}

// ch: the functor's kFields channels, then old_v x y z, each [n_pad].
// part: [gridDim.y, kSums, n_pad], this block's split in row blockIdx.y.
template <class Force, int R>
__global__ void __launch_bounds__(kThreads)
tile_pair_kernel(const Force f, const Ptrs<Force::kFields + 3> ch, int n,
                 int n_pad, int chunk, float* __restrict__ part) {
  using Cell = typename Force::Cell;
  constexpr int kF = Force::kFields;
  constexpr int kK = kF + 3;
  constexpr int kS = Force::kSums;
  __shared__ float tile[2][kK][kTileJ];
  const int i0 = blockIdx.x * kThreads * R + threadIdx.x;
  const int j_lo = blockIdx.y * chunk;
  const int j_hi = min(n, j_lo + chunk);

  Cell a[R];
  float acc[R][kS];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    float av[kF];
#pragma unroll
    for (int k = 0; k < kF; ++k) av[k] = i < n_pad ? ch.p[k][i] : 0.0f;
    a[r] = as_cell<Cell>(av);
#pragma unroll
    for (int m = 0; m < kS; ++m) acc[r][m] = 0.0f;
  }

  const int n_tiles = j_hi > j_lo ? (j_hi - j_lo + kTileJ - 1) / kTileJ : 0;
  if (n_tiles > 0) stage(tile[0], ch, j_lo, j_hi);
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int j0 = j_lo + tt * kTileJ;
    if (tt + 1 < n_tiles) {
      stage(tile[(tt + 1) & 1], ch, j0 + kTileJ, j_hi);
      cp_async_wait<1>();  // tile tt has landed, tile tt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*T)[kTileJ] = tile[tt & 1];
    const int jn = min(kTileJ, j_hi - j0);
    for (int jj = 0; jj < jn; ++jj) {
      float bv[kF];
#pragma unroll
      for (int k = 0; k < kF; ++k) bv[k] = T[k][jj];
      const Cell b = as_cell<Cell>(bv);
      const float ovx = T[kF][jj], ovy = T[kF + 1][jj], ovz = T[kF + 2][jj];
      const int j = j0 + jj;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (j == i0 + r * kThreads) {
          f.self_pair(a[r], acc[r]);
        } else {
          const float dist =
              yalla::pair_dist(a[r].x, a[r].y, a[r].z, b.x, b.y, b.z);
          f.pair(a[r], b, dist, ovx, ovy, ovz, acc[r]);
        }
      }
    }
    __syncthreads();  // tile tt consumed before it is refilled
  }

  float* dst = part + (long long)blockIdx.y * kS * n_pad;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i < n_pad) {
#pragma unroll
      for (int m = 0; m < kS; ++m) dst[(long long)m * n_pad + i] = acc[r][m];
    }
  }
}

// out[m, i] = sum over s = 0 .. S-1, in that order, of part[s, m, i]
__global__ void __launch_bounds__(256)
tile_reduce_kernel(const float* __restrict__ part, int S, long long size,
                   float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size) return;
  float s = 0.0f;
  for (int k = 0; k < S; ++k) s += part[k * size + idx];
  out[idx] = s;
}

template <class Force, int R>
int launch(const Force& f, const void* const* chans, int n, int n_pad,
           int rows, int S, int chunk, float* part, float* out,
           cudaStream_t stream) {
  if (n < 0 || n > n_pad || rows != R || S < 1 || chunk < 1 ||
      (long long)S * chunk < n)
    return (int)cudaErrorInvalidValue;
  Ptrs<Force::kFields + 3> ch;
  for (int k = 0; k < Force::kFields + 3; ++k)
    ch.p[k] = (const float*)chans[k];
  const int bx = (n_pad + kThreads * R - 1) / (kThreads * R);
  if (bx == 0) return (int)cudaGetLastError();
  tile_pair_kernel<Force, R><<<dim3(bx, S), kThreads, 0, stream>>>(
      f, ch, n, n_pad, chunk, part);
  const long long size = (long long)Force::kSums * n_pad;
  tile_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, stream>>>(
      part, S, size, out);
  return (int)cudaGetLastError();
}

}  // namespace

// chans: host array of the functor's channel pointers then old_v x y z,
// each [n_pad] f32 on the device; rows, S, chunk: the plan of
// ops/tile_pallas.py::tile_plan (rows must be the functor's R); params:
// host array of the functor's parameters; part: [S, kSums, n_pad] f32
// scratch and out: [kSums, n_pad] f32, both on the device.
extern "C" int yalla_tile_pair_branching(const void* const* chans, int n,
                                         int n_pad, int rows, int S,
                                         int chunk, const float* params,
                                         float* part, float* out,
                                         cudaStream_t stream) {
  yalla::BranchingForce f;
  f.p = yalla::BranchingParams{params[0], params[1], params[2], params[3],
                               params[4], params[5], params[6], params[7],
                               params[8], params[9]};
  return launch<yalla::BranchingForce, 2>(f, chans, n, n_pad, rows, S, chunk,
                                          part, out, stream);
}

extern "C" int yalla_tile_pair_sorting(const void* const* chans, int n,
                                       int n_pad, int rows, int S, int chunk,
                                       const float* params, float* part,
                                       float* out, cudaStream_t stream) {
  const yalla::SortingAdhesion f{params[0], params[1]};
  return launch<yalla::SortingAdhesion, 4>(f, chans, n, n_pad, rows, S,
                                           chunk, part, out, stream);
}
