// Gabriel lattice pair pass (kernel K5): Gabriel-pruned pair sums on the
// dense cube lattice, written in stable-id order.
//
// Replaces yalla_tpu/ops/gabriel_pallas.py::gabriel_lattice_pallas.  What it
// computes, not its TPU layout: for every active point i (stable id t, in
// lattice slot slot_of[t]), the candidates are the occupied slots j != i of
// the 27 cubes around i's with dist < cube_size.  A candidate r is kept
// unless another candidate k lies inside the sphere of radius
// 0.5 * gc * d(i, r) on the i-r midpoint:
//   |m - x_k|^2 < d2_r * gc2  and  d2_k < cube_size^2,  m = (x_i + x_r) / 2,
// and only if d2_r < cube_size^2 itself (gabriel_pallas.py:203-225).  The
// force functor then runs on the kept pairs with the points' stable ids,
// and once on the diagonal (:227-268).  Sums: the functor's dF fields and
// aux channels, sum_f, sum_v x y z, then the flag row: 1 where i had more
// than NC candidates (``__err_gabriel_candidates``, :188-201).
//
// Design (the reference's own per-thread list, solvers.cuh:549-597): one
// thread per stable id, 128 to a block; ids with no slot (inactive or
// dropped) write zeros.  A thread sweeps the 27 cubes x C slots in
// (dz, dy, dx, slot) order and keeps the first NC candidates (position and
// squared distance) in a per-thread array; it counts them all.  The
// midpoint test and the force loops run to the real count (about 9 at the
// growth_w_wall density), not to NC.  The array's size is a template
// parameter: 32 entries, or 128 for a larger NC; the wrapper refuses more.
// The TPU kernel's in-VMEM cursor compaction, lane rolls and shifted
// windows are TPU workarounds and have no counterpart here.
//
// Bound: memory latency of the sweep.  Each active point reads 27 * C stable
// ids (8 bytes each) and the positions of the occupied ones, about 2 kB per
// point served mostly from L1/L2 because neighbouring threads share cubes;
// the arithmetic (about 65 distances, 9 x 8 midpoint tests and ~7 forces per
// point) is small beside it.  Shared-memory staging of the cubes around a
// block is later work.
//
// Numerics: every product and sum of the distances and of the midpoint test
// is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction) in the
// order the plain torch version computes it, with IEEE sqrt, so the
// candidate and kept sets equal the plain version's and the friction sum
// agrees exactly.  The force values may contract into FMAs and are summed in
// another order; they agree to f32 rounding.
#include <cuda_runtime.h>

#include <cstring>

#include "forces.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
struct Ptrs {
  const float* p[N];
};

struct Lattice {
  int gx, gy, gz, C;
  long long n_slots;
  float cutoff, cutoff2, gc2;
};

struct Candidate {
  float x, y, z, d2;
};

template <class Cell, int N>
__device__ __forceinline__ Cell load_cell(const Ptrs<N>& ch, long long s) {
  constexpr int kF = sizeof(Cell) / sizeof(float);
  float v[kF];
#pragma unroll
  for (int k = 0; k < kF; ++k) v[k] = ch.p[k][s];
  Cell c;
  memcpy(&c, v, sizeof(Cell));
  return c;
}

__device__ __forceinline__ float sq_sum(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ch: the functor's kFields slot channels, then old_v x y z, each [n_slots];
// pid: [n_slots] stable id per slot (n_pad where empty); slot_of: [n_pad]
// slot per stable id (n_slots where none); out: [kSums + 1, n_pad].
template <class Force, int kMaxNC>
__global__ void __launch_bounds__(kThreads)
gabriel_pair_kernel(const Force f, const Ptrs<Force::kFields + 3> ch,
                    const long long* __restrict__ pid,
                    const long long* __restrict__ slot_of, int n_pad, int NC,
                    const Lattice g, float* __restrict__ out) {
  using Cell = typename Force::Cell;
  constexpr int kF = Force::kFields;
  constexpr int kOut = Force::kSums + 1;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_pad) return;
  float acc[kOut];
#pragma unroll
  for (int m = 0; m < kOut; ++m) acc[m] = 0.0f;

  const long long s = slot_of[t];
  if (s < g.n_slots) {
    const Cell a = load_cell<Cell>(ch, s);
    const long long cube = s / g.C;
    const int cx = (int)(cube % g.gx);
    const int cy = (int)((cube / g.gx) % g.gy);
    const int cz = (int)(cube / ((long long)g.gx * g.gy));

    // pass A: the first NC candidates, in stencil order, and their count
    Candidate cand[kMaxNC];
    int cslot[kMaxNC];
    int count = 0;
    for (int dz = -1; dz <= 1; ++dz) {
      const int z = cz + dz;
      if (z < 0 || z >= g.gz) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int y = cy + dy;
        if (y < 0 || y >= g.gy) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int x = cx + dx;
          if (x < 0 || x >= g.gx) continue;
          const long long j0 = (((long long)z * g.gy + y) * g.gx + x) * g.C;
          for (int c = 0; c < g.C; ++c) {
            const long long j = j0 + c;
            if (j == s || pid[j] >= n_pad) continue;
            const float xj = ch.p[0][j], yj = ch.p[1][j], zj = ch.p[2][j];
            const float d2 = sq_sum(a.x - xj, a.y - yj, a.z - zj);
            if (!(sqrtf(d2) < g.cutoff)) continue;
            if (count < NC) {
              cand[count] = Candidate{xj, yj, zj, d2};
              cslot[count] = (int)j;
            }
            ++count;
          }
        }
      }
    }
    acc[Force::kSums] = count > NC ? 1.0f : 0.0f;
    const int m = min(count, NC);

    // midpoint test on the compact set, then the force on the kept pairs
    for (int r = 0; r < m; ++r) {
      const Candidate cr = cand[r];
      if (!(cr.d2 < g.cutoff2)) continue;
      const float mx = __fmul_rn(__fadd_rn(a.x, cr.x), 0.5f);
      const float my = __fmul_rn(__fadd_rn(a.y, cr.y), 0.5f);
      const float mz = __fmul_rn(__fadd_rn(a.z, cr.z), 0.5f);
      const float rad2 = __fmul_rn(cr.d2, g.gc2);
      bool blocked = false;
      for (int k = 0; k < m && !blocked; ++k) {
        if (k == r) continue;
        const Candidate ck = cand[k];
        blocked = sq_sum(mx - ck.x, my - ck.y, mz - ck.z) < rad2 &&
                  ck.d2 < g.cutoff2;
      }
      if (blocked) continue;
      const long long j = cslot[r];
      f.pair(a, load_cell<Cell>(ch, j), t, (int)pid[j], sqrtf(cr.d2),
             ch.p[kF][j], ch.p[kF + 1][j], ch.p[kF + 2][j], acc);
    }
    f.self_pair(a, t, acc);
  }
#pragma unroll
  for (int m = 0; m < kOut; ++m) out[(long long)m * n_pad + t] = acc[m];
}

template <class Force>
int launch(const Force& f, const void* const* chans, const long long* pid,
           const long long* slot_of, int n_pad, const Lattice& g, int NC,
           float* out, cudaStream_t stream) {
  Ptrs<Force::kFields + 3> ch;
  for (int k = 0; k < Force::kFields + 3; ++k)
    ch.p[k] = (const float*)chans[k];
  const int blocks = (n_pad + kThreads - 1) / kThreads;
  if (NC < 1 || NC > 128 || n_pad < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  if (NC <= 32)
    gabriel_pair_kernel<Force, 32><<<blocks, kThreads, 0, stream>>>(
        f, ch, pid, slot_of, n_pad, NC, g, out);
  else
    gabriel_pair_kernel<Force, 128><<<blocks, kThreads, 0, stream>>>(
        f, ch, pid, slot_of, n_pad, NC, g, out);
  return (int)cudaGetLastError();
}

}  // namespace

// chans: host array of the functor's slot-channel pointers then old_v x y z,
// each [gx * gy * gz * C] f32 on the device; pid, slot_of: int64 on the
// device; gc2: (0.5 * gabriel_coefficient)^2 as f32; params: host array of
// the functor's parameters; out: [kSums + 1, n_pad] f32 on the device.
extern "C" int yalla_gabriel_pair_wall_relu(
    const void* const* chans, const long long* pid, const long long* slot_of,
    int n_pad, int gx, int gy, int gz, int C, float cube_size, float gc2,
    int NC, const float* params, float* out, cudaStream_t stream) {
  const yalla::WallRelu f{params[0], (int)params[1]};
  const Lattice g{gx, gy, gz, C, (long long)gx * gy * gz * C, cube_size,
                  cube_size * cube_size, gc2};
  return launch(f, chans, pid, slot_of, n_pad, g, NC, out, stream);
}
