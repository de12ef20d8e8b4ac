// Device force functors shared by the pair kernels (lattice_pair.cu, K1,
// tile_pair.cu, K3, and gabriel_pair.cu, K5), and the pair distance they
// gate on.
//
// A functor implements one torch force of the port (its ``cuda_functor``
// declaration names it) together with the friction its entry in
// ops/functors.py names (``friction``):
//   Cell            the per-point channels it reads, all float, in the order
//                   of the ``fields`` of its entry in ops/functors.py;
//   kFields, kSums  the channel count and the number of per-point sums;
//   pair(a, b, dist, ovx, ovy, ovz, acc)   adds the pair (i != j) to acc;
//   self_pair(a, acc)                      adds the i == j terms to acc.
// acc holds the dF fields, the aux channels, then sum_f and sum_v x y z.
// The functors of K3 and K5 see the points' ids as well (forces may single
// out a point by id; in K3 the id is the row): pair(a, b, i, j, dist, ovx,
// ovy, ovz, acc) and self_pair(a, i, acc).  K3 takes the id-free ones of
// K1 through an adapter (tile_pair.cu, ``IgnoreIds``).
//
// Gates decide as the plain version does.  A force that switches at a
// threshold computes every quantity that feeds the switch as torch
// computes it on the card: each operation rounded on its own (the rn_*
// helpers below; nvcc would otherwise contract a product and a sum into
// one FMA), the same libm functions (acosf, atan2f, sinf, cosf; the build
// has no fast-math) and the same clip.  Values past the gates may
// contract.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace yalla {

// |a - b|^2 rounded exactly as torch computes rx*rx + ry*ry + rz*rz: every
// product and sum rounded on its own (no FMA contraction)
__device__ __forceinline__ float pair_d2(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float rx = ax - bx, ry = ay - by, rz = az - bz;
  return __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                   __fmul_rn(rz, rz));
}

// |a - b| rounded exactly as torch computes sqrt(rx*rx + ry*ry + rz*rz):
// pair_d2, then IEEE sqrt
__device__ __forceinline__ float pair_dist(float ax, float ay, float az,
                                           float bx, float by, float bz) {
  return sqrtf(pair_d2(ax, ay, az, bx, by, bz));
}

// IEEE sqrt is correctly rounded and monotone, so sqrtf(d2) < cutoff holds
// exactly for d2 <= reach2_of(cutoff): the largest such float, or -1 if
// none is.  A scan that tests d2 against it skips the square root and
// decides as sqrtf does.  Host code: the entry points compute it once.
inline float reach2_of(float cutoff) {
  if (!(cutoff > 0.0f)) return -1.0f;
  float t = cutoff * cutoff;
  while (t > 0.0f && !(std::sqrt(t) < cutoff)) t = std::nextafter(t, 0.0f);
  while (std::sqrt(std::nextafter(t, INFINITY)) < cutoff)
    t = std::nextafter(t, INFINITY);
  return t;
}

// One IEEE operation each, never contracted into an FMA: torch's eager
// elementwise kernels round every operation on its own.
__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}

// polarity.pol_dot_product of (th_a, ph_a) and (th_p, ph_p), rounded as
// torch rounds it: sin(th_a) * sin(th_p) * cos(ph_a - ph_p)
// + cos(th_a) * cos(th_p), left to right
__device__ __forceinline__ float pol_dot(float th_a, float ph_a, float th_p,
                                         float ph_p) {
  return rn_add(rn_mul(rn_mul(sinf(th_a), sinf(th_p)),
                       cosf(rn_sub(ph_a, ph_p))),
                rn_mul(cosf(th_a), cosf(th_p)));
}

// polarity.pt_to_pol(r, dist) as torch computes it: theta =
// acos(clip(rz / dist, -1, 1)), phi = atan2(ry, rx)
__device__ __forceinline__ void pt_to_pol(float rx, float ry, float rz,
                                          float dist, float& th,
                                          float& ph) {
  th = acosf(fminf(fmaxf(rn_div(rz, dist), -1.0f), 1.0f));
  ph = atan2f(ry, rx);
}

// polarity.unidirectional_polarization_force(Xi, p): the (theta, phi)
// gradient, the phi term divided by the SIGNED sin(theta) and zero where
// |sin theta| <= 1e-10 (the gimbal guard, ref polarity.cuh:56-58)
__device__ __forceinline__ void unidirectional(float th, float ph, float pth,
                                               float pph, float& d_theta,
                                               float& d_phi) {
  const float st = sinf(th), cdp = cosf(ph - pph), spth = sinf(pth);
  d_theta = cosf(th) * spth * cdp - st * cosf(pth);
  d_phi = fabsf(st) > 1e-10f ? -spth * sinf(ph - pph) / st : 0.0f;
}

// polarity.orthonormal(r, p): the unit vector in the r-p plane orthogonal
// to unit p, zero where that plane is degenerate (the n2 > 0 gate rounded
// as torch rounds it; rsqrtf is torch.rsqrt bit for bit on the card)
__device__ __forceinline__ void orthonormal(float rx, float ry, float rz,
                                            float px, float py, float pz,
                                            float& ox, float& oy, float& oz) {
  const float rp = rn_add(rn_add(rn_mul(rx, px), rn_mul(ry, py)),
                          rn_mul(rz, pz));
  const float nx = rn_sub(rx, rn_mul(rp, px));
  const float ny = rn_sub(ry, rn_mul(rp, py));
  const float nz = rn_sub(rz, rn_mul(rp, pz));
  const float n2 = rn_add(rn_add(rn_mul(nx, nx), rn_mul(ny, ny)),
                          rn_mul(nz, nz));
  const float inv = n2 > 0.0f ? rsqrtf(n2) : 0.0f;
  ox = nx * inv;
  oy = ny * inv;
  oz = nz * inv;
}

// friction_w_neighbour for i != j into acc[k], acc[k + 1 .. k + 3]
__device__ __forceinline__ void friction_w_neighbour(float dist, float ovx,
                                                     float ovy, float ovz,
                                                     float* acc, int k) {
  const float fr = dist < 1.0f ? 1.0f : 0.0f;
  acc[k] += fr;
  acc[k + 1] += fr * ovx;
  acc[k + 2] += fr * ovy;
  acc[k + 3] += fr * ovz;
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
  static constexpr int kSumF = 9;
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
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, kSumF);
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

struct IwgCell {
  float x, y, z, w, f, ctype, px, py, pz, pcf, psf, pst, psg;
};

// yalla_tpu_torch/examples/intercalation_w_gradient.py::force with
// friction_w_neighbour as a device functor (ref
// examples/intercalation_w_gradient.cu:31-68), on the point fields and the
// seven channels of polarity.polarity_precompute (the unit polarity p, cos
// and sin of phi, the signed sin theta and its guarded inverse).  Within
// r_max: a type-dependent ReLU band, w and f diffusing into the
// mesenchyme, polarity.bending_force_fast scaled by 0.15 between
// epithelial cells, and the counts of epithelial and mesenchymal
// neighbours.  The gates (dist <= r_max, the types of i, of j and of the
// pair) read the pair distance and differences of 0/1 types, all exact,
// so both counts come out as the plain version's.  On the diagonal, w and
// f degrade in the mesenchyme.
// Sums: fx fy fz dw df dtheta dphi epi_nbs mes_nbs sum_f sum_vx sum_vy
// sum_vz.
struct IntercalationWGradient {
  using Cell = IwgCell;
  static constexpr int kFields = 13;
  static constexpr int kSums = 13;
  static constexpr int kSumF = 9;
  float r_max;

  __device__ void pair(const Cell& a, const Cell& b, float dist, float ovx,
                       float ovy, float ovz, float* acc) const {
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, kSumF);
    if (!(dist <= r_max)) return;
    const float rx = a.x - b.x, ry = a.y - b.y, rz = a.z - b.z;
    const float rc = a.ctype - b.ctype;
    const float ctype_j = a.ctype - rc;
    const bool mes_i = a.ctype == 0.0f;
    // the band: same type (mesenchyme or epithelium) or mixed pair
    float F;
    if (rc == 0.0f)
      F = mes_i ? fmaxf(0.8f - dist, 0.0f) * 2.0f - fmaxf(dist - 0.8f, 0.0f)
                : fmaxf(0.8f - dist, 0.0f) * 2.0f -
                      fmaxf(dist - 0.8f, 0.0f) * 2.0f;
    else
      F = fmaxf(0.9f - dist, 0.0f) * 2.0f - fmaxf(dist - 0.9f, 0.0f) * 2.0f;
    const float w = F / (dist > 0.0f ? dist : 1.0f);
    float fx = rx * w, fy = ry * w, fz = rz * w;
    if (mes_i) {
      acc[3] += -(a.w - b.w) * 0.1f;
      acc[4] += -(a.f - b.f) * 0.1f;
    }
    if (a.ctype * ctype_j == 1.0f) {
      // bending_force_fast: p_j eliminated as p_i - r.p, the per-point
      // trig of p_i from the precompute channels
      const float inv = 1.0f / dist;
      const float rpx = a.px - b.px, rpy = a.py - b.py, rpz = a.pz - b.pz;
      const float prodi = (a.px * rx + a.py * ry + a.pz * rz) * inv;
      const float prodj = prodi - (rpx * rx + rpy * ry + rpz * rz) * inv;
      const float d_theta = (a.pz * (a.pcf * rx + a.psf * ry) - a.pst * rz)
                            * inv;
      const float d_phi = (a.pcf * ry - a.psf * rx) * inv * a.psg;
      const float ai = prodi * inv, aj = prodj * inv;
      const float s1 = ai + aj, s2 = ai * ai + aj * aj;
      fx += (s2 * rx - s1 * a.px + aj * rpx) * 0.15f;
      fy += (s2 * ry - s1 * a.py + aj * rpy) * 0.15f;
      fz += (s2 * rz - s1 * a.pz + aj * rpz) * 0.15f;
      acc[5] += -prodi * d_theta * 0.15f;
      acc[6] += -prodi * d_phi * 0.15f;
    }
    acc[0] += fx;
    acc[1] += fy;
    acc[2] += fz;
    acc[7] += ctype_j == 1.0f ? 1.0f : 0.0f;
    acc[8] += ctype_j == 0.0f ? 1.0f : 0.0f;
  }

  // i == j: degradation of w and f in the mesenchyme; every other term
  // and the friction vanish on the diagonal
  __device__ void self_pair(const Cell& a, float* acc) const {
    if (a.ctype != 0.0f) return;
    acc[3] += -0.01f * a.w;
    acc[4] += -0.01f * a.f;
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
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 3);
  }

  __device__ void self_pair(const Cell&, float*) const {}
};

struct Float3Cell {
  float x, y, z;
};

// yalla_tpu_torch/inits.py::relu_force as a device functor (ref
// inits.cuh:78-93): the repulsion/adhesion band the initial conditions
// relax under, within dist <= 1 (inclusive), plus friction_w_neighbour
// (dist < 1).  Nothing on the diagonal; a pair at dist 0 gets no force.
// Sums: fx fy fz sum_f sum_vx sum_vy sum_vz.
struct InitsRelu {
  using Cell = Float3Cell;
  static constexpr int kFields = 3;
  static constexpr int kSums = 7;

  __device__ void pair(const Cell& a, const Cell& b, float dist, float ovx,
                       float ovy, float ovz, float* acc) const {
    const float F =
        fmaxf(0.8f - dist, 0.0f) * 2.0f - fmaxf(dist - 0.8f, 0.0f);
    const float inv = dist > 0.0f ? rsqrtf(__fmul_rn(dist, dist)) : 0.0f;
    const float w = dist <= 1.0f ? F * inv : 0.0f;
    acc[0] += (a.x - b.x) * w;
    acc[1] += (a.y - b.y) * w;
    acc[2] += (a.z - b.z) * w;
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 3);
  }

  __device__ void self_pair(const Cell&, float*) const {}
};

// yalla_tpu_torch/models/growth_w_wall.py::relu_force with wall_friction as
// a device functor (ref examples/growth_w_wall.cu:40-71): a ReLU band
// between cells, none with the wall node (stable id ``wall``), friction
// between cells within r_max.  Both vanish on the diagonal.
// Sums: fx fy fz sum_f sum_vx sum_vy sum_vz.
struct WallRelu {
  using Cell = Float3Cell;
  static constexpr int kFields = 3;
  static constexpr int kSums = 7;
  float r_max;
  int wall;

  __device__ void pair(const Cell& a, const Cell& b, int i, int j,
                       float dist, float ovx, float ovy, float ovz,
                       float* acc) const {
    const bool cells = i != wall && j != wall && i != j;
    const float F = fmaxf(0.7f - dist, 0.0f) - fmaxf(dist - 0.8f, 0.0f);
    const float safe = dist > 0.0f ? dist : 1.0f;
    const float w = (cells && dist <= r_max) ? F / safe : 0.0f;
    acc[0] += (a.x - b.x) * w;
    acc[1] += (a.y - b.y) * w;
    acc[2] += (a.z - b.z) * w;
    const float fr = (cells && dist < r_max) ? 1.0f : 0.0f;
    acc[3] += fr;
    acc[4] += fr * ovx;
    acc[5] += fr * ovy;
    acc[6] += fr * ovz;
  }

  __device__ void self_pair(const Cell&, int, float*) const {}
};

// --- the all-pairs examples of yalla_tpu_torch/examples (K3) -------------

// examples/springs.py::spring: a spring of rest length L_0 between every
// pair, plus friction_w_neighbour.  Nothing on the diagonal.
// Sums: fx fy fz sum_f sum_vx sum_vy sum_vz.
struct Spring {
  using Cell = Float3Cell;
  static constexpr int kFields = 3;
  static constexpr int kSums = 7;
  float L_0;

  __device__ void pair(const Cell& a, const Cell& b, int, int, float dist,
                       float ovx, float ovy, float ovz, float* acc) const {
    const float w = (L_0 - dist) / (dist > 0.0f ? dist : 1.0f);
    acc[0] += (a.x - b.x) * w;
    acc[1] += (a.y - b.y) * w;
    acc[2] += (a.z - b.z) * w;
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 3);
  }

  __device__ void self_pair(const Cell&, int, float*) const {}
};

struct Float4Cell {
  float x, y, z, w;
};

// examples/gradient.py::diffusion: w diffuses pairwise within r_max
// (dw = -D * r.w), except into the source cell (row ``source``), plus
// friction_w_neighbour.  Sums: dw sum_f sum_vx sum_vy sum_vz.
struct GradientDiffusion {
  using Cell = Float4Cell;
  static constexpr int kFields = 4;
  static constexpr int kSums = 5;
  float r_max, D;
  int source;

  __device__ void pair(const Cell& a, const Cell& b, int i, int, float dist,
                       float ovx, float ovy, float ovz, float* acc) const {
    const bool valid = dist <= r_max && i != source;
    acc[0] += valid ? -(a.w - b.w) * D : 0.0f;
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 1);
  }

  __device__ void self_pair(const Cell&, int, float*) const {}
};

struct PoCell {
  float x, y, z, theta, phi;
};

// The ReLU band of the polarity examples within r_max (dist <= r_max):
// max(0.7 - d, 0) * 2 - max(d - 0.8, 0), over d.
__device__ __forceinline__ float relu_band(float dist) {
  return (fmaxf(0.7f - dist, 0.0f) * 2.0f - fmaxf(dist - 0.8f, 0.0f))
         / (dist > 0.0f ? dist : 1.0f);
}

// examples/bending.py::layer_force: the ReLU band plus polarity.
// bending_force (ref polarity.cuh:72-94) in its spherical form, weighted
// by ``weight``, within r_max; plus friction_w_neighbour.  The j-term reads
// Xj's angles as torch forms them, Xi - r.  The only gates are the band
// and the gimbal guard on sin(theta_i).
// Sums: fx fy fz dtheta dphi sum_f sum_vx sum_vy sum_vz.
struct BendingLayer {
  using Cell = PoCell;
  static constexpr int kFields = 5;
  static constexpr int kSums = 9;
  float r_max, weight;

  __device__ void pair(const Cell& a, const Cell& b, int, int, float dist,
                       float ovx, float ovy, float ovz, float* acc) const {
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 5);
    if (!(dist <= r_max)) return;
    const float rx = a.x - b.x, ry = a.y - b.y, rz = a.z - b.z;
    const float w = relu_band(dist);
    // p_i, prod_i and the (theta, phi) gradient along r-hat
    const float sti = sinf(a.theta);
    const float pix = sti * cosf(a.phi), piy = sti * sinf(a.phi);
    const float piz = cosf(a.theta);
    const float prodi = (pix * rx + piy * ry + piz * rz) / dist;
    float rth, rph, d_theta, d_phi;
    pt_to_pol(rx, ry, rz, dist, rth, rph);
    unidirectional(a.theta, a.phi, rth, rph, d_theta, d_phi);
    const float d2 = dist * dist;
    const float ai = prodi / dist, bi = prodi * prodi / d2;
    // p_j from Xj's angles Xi - r
    const float thj = a.theta - (a.theta - b.theta);
    const float phj = a.phi - (a.phi - b.phi);
    const float stj = sinf(thj);
    const float pjx = stj * cosf(phj), pjy = stj * sinf(phj);
    const float pjz = cosf(thj);
    const float prodj = (pjx * rx + pjy * ry + pjz * rz) / dist;
    const float aj = prodj / dist, bj = prodj * prodj / d2;
    acc[0] += rx * w + (-ai * pix + bi * rx - aj * pjx + bj * rx) * weight;
    acc[1] += ry * w + (-ai * piy + bi * ry - aj * pjy + bj * ry) * weight;
    acc[2] += rz * w + (-ai * piz + bi * rz - aj * pjz + bj * rz) * weight;
    acc[3] += d_theta * -prodi * weight;
    acc[4] += d_phi * -prodi * weight;
  }

  __device__ void self_pair(const Cell&, int, float*) const {}
};

// examples/migration.py::relu_w_migration (and random_walk.py's): the ReLU
// band plus polarity.migration_force (ref polarity.cuh:123-164) within
// r_max, plus friction_w_neighbour.  Pull around j along p_i where cell i
// has a set polarity and p_i . r-hat <= -0.15; get pushed aside along p_j
// where Xj's angles (Xi - r) exceed 1e-10 and p_j . r-hat >= 0.15.  Both
// dot products, the angles of r-hat and of Xj are rounded as torch rounds
// them, so each gate decides as the plain version does.
// Sums: fx fy fz sum_f sum_vx sum_vy sum_vz.
struct ReluMigration {
  using Cell = PoCell;
  static constexpr int kFields = 5;
  static constexpr int kSums = 7;
  float r_max;

  __device__ void pair(const Cell& a, const Cell& b, int, int, float dist,
                       float ovx, float ovy, float ovz, float* acc) const {
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 3);
    if (!(dist <= r_max)) return;
    const float rx = a.x - b.x, ry = a.y - b.y, rz = a.z - b.z;
    const float w = relu_band(dist);
    float fx = rx * w, fy = ry * w, fz = rz * w;
    float rth, rph;
    pt_to_pol(rx, ry, rz, dist, rth, rph);
    const float th = a.theta, ph = a.phi;
    if ((ph != 0.0f || th != 0.0f) && pol_dot(th, ph, rth, rph) <= -0.15f) {
      const float st = sinf(th);
      const float px = st * cosf(ph), py = st * sinf(ph), pz = cosf(th);
      float ox, oy, oz;
      orthonormal(rx, ry, rz, px, py, pz, ox, oy, oz);
      fx += 0.6f * px + 0.8f * ox;
      fy += 0.6f * py + 0.8f * oy;
      fz += 0.6f * pz + 0.8f * oz;
    }
    const float thj = th - (a.theta - b.theta);
    const float phj = ph - (a.phi - b.phi);
    if ((phj > 1e-10f || thj > 1e-10f) &&
        pol_dot(thj, phj, rth, rph) >= 0.15f) {
      const float st = sinf(thj);
      const float px = st * cosf(phj), py = st * sinf(phj), pz = cosf(thj);
      float ox, oy, oz;
      orthonormal(-rx, -ry, -rz, px, py, pz, ox, oy, oz);
      fx -= 0.6f * px + 0.8f * ox;
      fy -= 0.6f * py + 0.8f * oy;
      fz -= 0.6f * pz + 0.8f * oz;
    }
    acc[0] += fx;
    acc[1] += fy;
    acc[2] += fz;
  }

  __device__ void self_pair(const Cell&, int, float*) const {}
};

struct WntCell {
  float x, y, z, w, theta, phi;
};

// examples/wnt.py::diffusion: w diffuses within r_max except into the
// source (row ``source``); within r_max, towards higher w (r.w <= 0), the
// bidirectional polarization force to the direction of j (the angles of
// -r, dist taken as 1 where it is 0), weighted by Xi.w - r.w; plus
// friction_w_neighbour.  Gates: the band, the source, r.w <= 0 and the
// gimbal guard on sin(theta_i).
// Sums: dw dtheta dphi sum_f sum_vx sum_vy sum_vz.
struct WntDiffusion {
  using Cell = WntCell;
  static constexpr int kFields = 6;
  static constexpr int kSums = 7;
  float r_max, D;
  int source;

  __device__ void pair(const Cell& a, const Cell& b, int i, int, float dist,
                       float ovx, float ovy, float ovz, float* acc) const {
    friction_w_neighbour(dist, ovx, ovy, ovz, acc, 3);
    if (!(dist <= r_max)) return;
    const float rw = a.w - b.w;
    if (i != source) acc[0] += -rw * D;
    if (!(rw <= 0.0f)) return;
    float rth, rph;
    pt_to_pol(-(a.x - b.x), -(a.y - b.y), -(a.z - b.z),
              dist > 0.0f ? dist : 1.0f, rth, rph);
    const float prod = pol_dot(a.theta, a.phi, rth, rph);
    float d_theta, d_phi;
    unidirectional(a.theta, a.phi, rth, rph, d_theta, d_phi);
    const float wgt = a.w - rw;
    acc[1] += d_theta * prod * wgt;
    acc[2] += d_phi * prod * wgt;
  }

  __device__ void self_pair(const Cell&, int, float*) const {}
};

}  // namespace yalla
