// Device force functors shared by the pair kernels (lattice_pair.cu, K1, and
// tile_pair.cu, K3), and the pair distance they gate on.
//
// A functor implements one torch force of the port (its ``cuda_functor``
// declaration names it) together with friction_w_neighbour:
//   Cell            the per-point channels it reads, all float, in the order
//                   of the ``fields`` of its entry in ops/functors.py;
//   kFields, kSums  the channel count and the number of per-point sums;
//   pair(a, b, dist, ovx, ovy, ovz, acc)   adds the pair (i != j) to acc;
//   self_pair(a, acc)                      adds the i == j terms to acc.
// acc holds the dF fields, the aux channels, then sum_f and sum_v x y z.
#pragma once

#include <cuda_runtime.h>

namespace yalla {

// |a - b| rounded exactly as torch computes sqrt(rx*rx + ry*ry + rz*rz):
// every product and sum rounded on its own (no FMA contraction), IEEE sqrt
__device__ __forceinline__ float pair_dist(float ax, float ay, float az,
                                           float bx, float by, float bz) {
  const float rx = ax - bx, ry = ay - by, rz = az - bz;
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                             __fmul_rn(rz, rz));
  return sqrtf(d2);
}

struct BranchingCell {
  float x, y, z, u, v, ctype, px, py, pz;
};

struct BranchingParams {
  float r_max, lam, D_u, D_v, f_v, f_u, g_u, m_u, m_v, s_u;
};

// yalla_tpu_torch/models/branching.py::make_force as a device functor
// (ref examples/branching.cu:64-107).  ``pair`` is the off-diagonal force
// plus friction_w_neighbour for i != j; ``self_pair`` the i == j terms.
// Sums: fx fy fz du dv epi_nbs pg_x pg_y pg_z sum_f sum_vx sum_vy sum_vz.
struct BranchingForce {
  using Cell = BranchingCell;
  static constexpr int kFields = 9;
  static constexpr int kSums = 13;
  static constexpr int kSumF = 9, kSumV = 10;
  BranchingParams p;

  __device__ void pair(const Cell& a, const Cell& b, float dist, float ovx,
                       float ovy, float ovz, float* acc) const {
    const float rx = a.x - b.x, ry = a.y - b.y, rz = a.z - b.z;
    const float ru = a.u - b.u, rv = a.v - b.v, rc = a.ctype - b.ctype;
    const float rpx = a.px - b.px, rpy = a.py - b.py, rpz = a.pz - b.pz;
    const float both = a.ctype * (a.ctype - rc);  // 1 iff both epithelial
    const bool near = dist < p.r_max;

    // mechanics: type-dependent ReLU band (branching.cu:82-87)
    const float F = rc == 0.0f
        ? fmaxf(0.7f - dist, 0.0f) * 2.0f - fmaxf(dist - 0.8f, 0.0f)
        : fmaxf(0.8f - dist, 0.0f) * 2.0f - fmaxf(dist - 0.9f, 0.0f);
    const float inv = dist > 0.0f ? rsqrtf(__fmul_rn(dist, dist)) : 0.0f;
    const float w = near ? F * inv : 0.0f;
    float fx = rx * w, fy = ry * w, fz = rz * w;

    // diffusion between epithelial pairs, v into the mesenchyme
    // (branching.cu:91-103)
    const bool epi_pair = near && both == 1.0f;
    float du = epi_pair ? -p.D_u * ru : 0.0f;
    const float dv0 = near ? -p.D_v * rv : 0.0f;
    du = (-du > a.u) ? 0.0f : du;
    const float dv = (epi_pair && -dv0 > a.v) ? 0.0f : dv0;

    // epithelial bending, Cartesian form (polarity.bending_force_cart)
    const float prodi = (a.px * rx + a.py * ry + a.pz * rz) * inv;
    const float prodj = prodi - (rpx * rx + rpy * ry + rpz * rz) * inv;
    const float ai = prodi * inv, aj = prodj * inv;
    const float s1 = ai + aj, s2 = ai * ai + aj * aj;
    const float t = -prodi * inv;
    const float bw = epi_pair ? 0.2f : 0.0f;
    fx += (s2 * rx - s1 * a.px + aj * rpx) * bw;
    fy += (s2 * ry - s1 * a.py + aj * rpy) * bw;
    fz += (s2 * rz - s1 * a.pz + aj * rpz) * bw;

    acc[0] += fx;
    acc[1] += fy;
    acc[2] += fz;
    acc[3] += du;
    acc[4] += dv;
    acc[5] += (near && (a.ctype - rc) == 1.0f) ? 1.0f : 0.0f;
    acc[6] += t * rx * bw;
    acc[7] += t * ry * bw;
    acc[8] += t * rz * bw;
    // friction_w_neighbour (i != j here)
    const float fr = dist < 1.0f ? 1.0f : 0.0f;
    acc[kSumF] += fr;
    acc[kSumV] += fr * ovx;
    acc[kSumV + 1] += fr * ovy;
    acc[kSumV + 2] += fr * ovz;
  }

  // i == j: Meinhardt kinetics on the epithelium (branching.cu:66-77);
  // every other term and the friction vanish on the diagonal
  __device__ void self_pair(const Cell& a, float* acc) const {
    if (a.ctype != 1.0f) return;
    float du_r = p.lam * ((p.f_u * a.u * a.u) / (1.0f + p.f_v * a.v)
                          - p.m_u * a.u + p.s_u);
    float dv_r = p.lam * (p.g_u * a.u * a.u - p.m_v * a.v);
    du_r = (-du_r > a.u) ? 0.0f : du_r;
    dv_r = (-dv_r > a.v) ? 0.0f : dv_r;
    acc[3] += du_r;
    acc[4] += dv_r;
  }
};

struct SortingCell {
  float x, y, z, ctype;
};

// yalla_tpu_torch/models/sorting.py::make_adhesion as a device functor:
// differential adhesion (ref examples/sorting.cu:16-28, bench.py:697-708)
// with strength 1 between type-0 cells, 9 between type-1 cells and 3
// between types, plus friction_w_neighbour.  Nothing on the diagonal.
// Sums: fx fy fz sum_f sum_vx sum_vy sum_vz.
struct SortingAdhesion {
  using Cell = SortingCell;
  static constexpr int kFields = 4;
  static constexpr int kSums = 7;
  float r_max, r_min;

  __device__ void pair(const Cell& a, const Cell& b, float dist, float ovx,
                       float ovy, float ovz, float* acc) const {
    const float rx = a.x - b.x, ry = a.y - b.y, rz = a.z - b.z;
    const float strength =
        a.ctype - b.ctype == 0.0f ? (a.ctype > 0.5f ? 9.0f : 1.0f) : 3.0f;
    const float F = 2.0f * (r_min - dist) * (r_max - dist)
                    + (r_max - dist) * (r_max - dist);
    const float inv = dist > 0.0f ? rsqrtf(__fmul_rn(dist, dist)) : 0.0f;
    const float w = dist < r_max ? strength * F * inv : 0.0f;
    acc[0] += rx * w;
    acc[1] += ry * w;
    acc[2] += rz * w;
    const float fr = dist < 1.0f ? 1.0f : 0.0f;
    acc[3] += fr;
    acc[4] += fr * ovx;
    acc[5] += fr * ovy;
    acc[6] += fr * ovz;
  }

  __device__ void self_pair(const Cell&, float*) const {}
};

}  // namespace yalla
