// Lattice pair pass (kernel K1): per-cell pair sums on the dense cube lattice.
//
// Replaces yalla_tpu/ops/lattice_pallas.py::lattice_pairwise_pallas (with its
// overflow-extras sidecar, _extras_tables and the extras-extras merge).
// What it computes, not its TPU layout: for every occupied slot i, the sums
// over partners j in the 27-cube stencil with dist < cube_size of the force
// (dF x y z u v), the aux channels (epi_nbs, pg_x/y/z), the friction and
// friction * old_v[j].  The self-pair uses the full force (the Meinhardt
// reaction); every other pair the off-diagonal force.  Each overflow extra
// gets the same sums over lattice partners, extras partners and its own
// diagonal, and every lattice slot also sees the extras of its 27 cubes.
//
// The force is a device functor shared with the tile kernel (forces.cuh).
//
// Design (the reference's own compute_cube shape, solvers.cuh:443-459): one
// thread per slot, which exits at once if the slot is empty; it loops over
// the 27 neighbour cubes x C slots, applies the cutoff, evaluates the force
// functor and accumulates the 13 sums in registers, written once.  Extras
// are reached through a per-cube [start, end) table over the cube-sorted
// extras, so both sides scan only the 27 neighbour cubes' extras.  A second
// launch, one thread per extra, computes the extras' own sums.
//
// Bound: the pair arithmetic.  Each occupied slot scans 27 * C = 216
// candidate slots; at the settled density (about 2.4 cells per unit cube)
// about 65 of them are live and within reach, at about 60 flops each: about
// 2e9 flops per pass at 500k cells, with the neighbour channels served from
// L1/L2.  Shared-memory j-tiles and tuned blocking are later work.
//
// Numerics: the pair distance is computed with explicitly rounded products
// and sums (no FMA contraction) and IEEE sqrt, in the same order as the
// plain torch version, so the cutoff and the gates (dist < cube_size,
// dist < r_max, dist < 1) decide exactly as it does and the counters agree
// exactly.  The force values may contract into FMAs and use rsqrtf; they
// agree with the plain version to f32 rounding and summation order.
#include <cuda_runtime.h>

#include "forces.cuh"

namespace {

using yalla::BranchingForce;
using yalla::BranchingParams;
using yalla::pair_dist;
using Cell = BranchingForce::Cell;

constexpr int kChans = 12;  // x y z u v ctype px py pz ov_x ov_y ov_z
constexpr int kOut = 13;    // fx fy fz du dv epi_nbs pg_x pg_y pg_z
                            // sum_f sum_vx sum_vy sum_vz
static_assert(BranchingForce::kSums == kOut, "one sum per output row");

struct Chans {
  const float* p[kChans];
};

__device__ __forceinline__ Cell load_cell(const Chans& c, long long s) {
  return Cell{c.p[0][s], c.p[1][s], c.p[2][s], c.p[3][s], c.p[4][s],
              c.p[5][s], c.p[6][s], c.p[7][s], c.p[8][s]};
}

struct Grid {
  int gx, gy, gz, C;
  float cutoff;
};

struct Extras {
  Chans ch;
  const int* cube;   // [E_cap] cube id per extra, n_cubes = empty
  const int* order;  // [E_cap] extras sorted by cube
  const int* start;  // [n_cubes + 1] run of each cube in ``order``
  int cap;
};

// Sums of partner ``j`` (lattice slot or extra) into ``acc`` for point ``a``
template <class Force>
__device__ __forceinline__ void visit(const Force& f, const Cell& a,
                                      const Chans& ch, long long j,
                                      float cutoff, float* acc) {
  const float dist = pair_dist(a.x, a.y, a.z, ch.p[0][j], ch.p[1][j],
                               ch.p[2][j]);
  if (!(dist < cutoff)) return;
  f.pair(a, load_cell(ch, j), dist, ch.p[9][j], ch.p[10][j], ch.p[11][j],
         acc);
}

// Walk the 27-cube stencil of cube (cx, cy, cz): lattice partners (except
// slot ``self_slot``) and extras partners (except extra ``self_extra``,
// whose diagonal is the full force).
template <class Force>
__device__ void stencil(const Force& f, const Cell& a, int cx, int cy, int cz,
                        const Grid& g, const Chans& L,
                        const unsigned char* __restrict__ occ,
                        const Extras& E, long long self_slot, int self_extra,
                        float* acc) {
  for (int dz = -1; dz <= 1; ++dz) {
    const int z = cz + dz;
    if (z < 0 || z >= g.gz) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = cy + dy;
      if (y < 0 || y >= g.gy) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int x = cx + dx;
        if (x < 0 || x >= g.gx) continue;
        const long long cube = ((long long)z * g.gy + y) * g.gx + x;
        for (int c = 0; c < g.C; ++c) {
          const long long j = cube * g.C + c;
          if (j != self_slot && occ[j]) visit(f, a, L, j, g.cutoff, acc);
        }
        if (E.cap == 0) continue;
        for (int k = E.start[cube]; k < E.start[cube + 1]; ++k) {
          const int e = E.order[k];
          if (e == self_extra)
            f.self_pair(a, acc);
          else
            visit(f, a, E.ch, e, g.cutoff, acc);
        }
      }
    }
  }
}

template <class Force>
__global__ void __launch_bounds__(128)
lattice_pair_kernel(const Force f, const Grid g, const Chans L,
                    const unsigned char* __restrict__ occ, const Extras E,
                    float* __restrict__ out) {
  const long long n_slots = (long long)g.gx * g.gy * g.gz * g.C;
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  float acc[kOut];
#pragma unroll
  for (int m = 0; m < kOut; ++m) acc[m] = 0.0f;
  if (occ[s]) {
    const Cell a = load_cell(L, s);
    f.self_pair(a, acc);
    const long long cube = s / g.C;
    const int cx = (int)(cube % g.gx);
    const int cy = (int)((cube / g.gx) % g.gy);
    const int cz = (int)(cube / ((long long)g.gx * g.gy));
    stencil(f, a, cx, cy, cz, g, L, occ, E, s, -1, acc);
  }
#pragma unroll
  for (int m = 0; m < kOut; ++m) out[m * n_slots + s] = acc[m];
}

template <class Force>
__global__ void __launch_bounds__(128)
extras_pair_kernel(const Force f, const Grid g, const Chans L,
                   const unsigned char* __restrict__ occ, const Extras E,
                   float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E.cap) return;
  const long long n_cubes = (long long)g.gx * g.gy * g.gz;
  float acc[kOut];
#pragma unroll
  for (int m = 0; m < kOut; ++m) acc[m] = 0.0f;
  const long long cube = E.cube[e];
  if (cube < n_cubes) {
    const Cell a = load_cell(E.ch, e);
    const int cx = (int)(cube % g.gx);
    const int cy = (int)((cube / g.gx) % g.gy);
    const int cz = (int)(cube / ((long long)g.gx * g.gy));
    stencil(f, a, cx, cy, cz, g, L, occ, E, -1, e, acc);
  }
#pragma unroll
  for (int m = 0; m < kOut; ++m) out[(long long)m * E.cap + e] = acc[m];
}

template <class Force>
int launch(const Force& f, const Grid& g, const Chans& L,
           const unsigned char* occ, const Extras& E, float* out, float* eout,
           cudaStream_t stream) {
  const int threads = 128;
  const long long n_slots = (long long)g.gx * g.gy * g.gz * g.C;
  lattice_pair_kernel<<<(unsigned)((n_slots + threads - 1) / threads),
                        threads, 0, stream>>>(f, g, L, occ, E, out);
  if (E.cap > 0)
    extras_pair_kernel<<<(E.cap + threads - 1) / threads, threads, 0,
                         stream>>>(f, g, L, occ, E, eout);
  return (int)cudaGetLastError();
}

Chans chans_of(const void* const* ptrs) {
  Chans c{};
  if (ptrs)
    for (int k = 0; k < kChans; ++k) c.p[k] = (const float*)ptrs[k];
  return c;
}

}  // namespace

// chans / echans: host arrays of kChans device pointers (lattice slots and
// extras); params: host array of the 10 BranchingParams values.
extern "C" int yalla_lattice_pair_branching(
    const void* const* chans, const unsigned char* occ,
    const void* const* echans, const int* ecube, const int* eorder,
    const int* estart, int E_cap, int gx, int gy, int gz, int C,
    float cube_size, const float* params, float* out, float* eout,
    cudaStream_t stream) {
  BranchingForce f;
  f.p = BranchingParams{params[0], params[1], params[2], params[3],
                        params[4], params[5], params[6], params[7],
                        params[8], params[9]};
  const Grid g{gx, gy, gz, C, cube_size};
  const Extras E{chans_of(echans), ecube, eorder, estart, E_cap};
  return launch(f, g, chans_of(chans), occ, E, out, eout, stream);
}
