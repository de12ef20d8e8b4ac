// Lattice pair pass (kernel K1): per-cell pair sums on the dense cube lattice.
//
// Replaces yalla_tpu/ops/lattice_pallas.py::lattice_pairwise_pallas (with its
// overflow-extras sidecar, _extras_tables and the extras-extras merge).
// What it computes, not its TPU layout: for every occupied slot i, the sums
// over partners j in its stencil (27 cubes; 9 (2 xr + 1) with thin x-cubes,
// below) with dist < cube_size of a force
// functor's sums (its dF fields and aux channels), the friction and
// friction * old_v[j].  The self-pair uses the full force (the Meinhardt
// reaction of branching, the degradation of intercalation_w_gradient);
// every other pair the off-diagonal force.  Each overflow extra gets the
// same sums over lattice partners, extras partners and its own diagonal,
// and every lattice slot also sees the extras of its stencil.  Empty
// slots and dead extras get zero sums.
//
// The kernel is generic in its functor (forces.cuh): the channel count is
// the functor's kFields + 3 (12 for branching, 16 for
// intercalation_w_gradient), the sum count its kSums (13 for both), and
// the shared-memory layout, the staging and the sums follow them.  Each
// functor has its own C entry point (YALLA_LATTICE_ENTRY below).
//
// The force is a device functor shared with the tile kernel (forces.cuh).
//
// Thin x-cubes (the JAX package's x_split = xr > 1): x is binned at
// cube_size / xr, so a cell's stencil is 3 x 3 cubes in z and y by
// 2 xr + 1 in x, and the halo reaches xr cubes on each side in x.  The
// cutoff stays cube_size.  xr = 1 runs its own instantiation (kThin
// false), with the reach a compile-time 1.
//
// A z-slab of the lattice (the multi-device path, parallel/lattice_spmd.py;
// the JAX package's ``z_halo``): the kernel's grid is the slab's gz planes,
// and the two planes past its z faces come from the neighbouring slabs'
// edge planes (channels and occupancy, one [gy * gx * C] plane each), read
// where the halo's row lies at z = -1 or z = gz.  Sums are written for the
// slab's own slots only.  The slab runs its own instantiation (kHalo); the
// single-device path's (null planes) keeps the code it had without them,
// which the first version with one instantiation for both slowed by a
// tenth (0.470 -> 0.520 ms a 500k pass, kernel_profile.py --k1).
//
// Bound (branching): memory.  A pass writes 13 sums for every slot (109 MB
// at gs 64^3, C 8) and reads the occupied slots' channels and the
// occupancy (about 26 MB): about 0.04 ms on an H100.  Its arithmetic is below that line but
// not small: in the settled 500k tissue a cell has about 126 live
// candidates in its 27 cubes and about 19 partners in reach
// (chip_smoke.py prints both).
//
// What held the first version back: one thread per slot, 2.1M threads,
// three quarters of them on empty slots; each live thread walked 27 x C
// candidate slots serially and gathered each partner's 12 channels from
// 12 SoA arrays.  At a quarter occupancy a 128-byte line of one channel
// holds about 8 live slots, so the gathers hit in L1 only while L1 holds
// the neighbourhood's lines of all 12 arrays, and from L2 they cost some
// 290 bytes of sectors per partner.
//
// Design for Hopper:
// * A block owns a brick of bz x by x bx cubes (ops/lattice_pallas.py::
//   lattice_plan picks it from C and the channel count: 2 x 4 x 8 for
//   branching at C <= 8, smaller above, clipped to the grid; a ragged
//   brick at the grid's edge is masked).
// * It stages its halo, (bz+2) x (by+2) x (bx+2xr) cubes, in shared
//   memory: first the occupancy, every load independent; then, one warp
//   per x-row of (bx+2xr) * C contiguous slots, cp.async copies of the live
//   slots' channels, waited for once.  Each x-row's live slots form a
//   list in slot order (a ballot and a prefix count per 32 slots) of
//   float4 entries (x, y, z, slot id); the other channels (9 for
//   branching, 13 for intercalation_w_gradient) stay in slot order.  The
//   2xr + 1 cubes of one x-row around a cell are then one contiguous run
//   of that list.  113 KB at C 8 for branching: two blocks per SM.
// * The halo's extras table ([start, end) of each cube's extras) is read
//   once per block into shared memory; a block whose halo holds no extra
//   skips them.
// * A prefix sum over the brick's cubes lays out a work list of its live
//   cells.  Eight lanes take each live cell and split each of its 9 runs
//   slot by slot, so they test the same number of candidates, give or
//   take one per run, and read neighbouring entries.  A candidate is one
//   16-byte read and a d2 test; every candidate is listed and kept only
//   in reach (no branch).  The eight lanes' lists are then joined and
//   split evenly for the force, and the sums meet by shuffles in a fixed
//   order.  Empty slots of the brick get their zeros in a coalesced pass.
// * The extras' own sums run one warp per extra: the lanes load the
//   stencil's cubes' extras runs 32 cubes at a time, split those cubes'
//   lattice candidates and extras, then reduce with warp shuffles in a
//   fixed order.  Dead extras exit at once.
//
// Where it stands (H100 80GB HBM3, 700 W; yalla_tpu_torch/kernel_profile.py):
// about 0.455 ms per 500k pass and 0.015 ms for the extras kernel, against
// 0.97 for the first version's two kernels.  The scan is bound by
// instruction issue, not latency: two candidates per lane per step ran
// slower.  What is left: fewer candidate tests (about 126 per cell for 19
// partners in reach).
//
// Numerics: the pair distance is computed with explicitly rounded products
// and sums (no FMA contraction) and IEEE sqrt, in the same order as the
// plain torch version, so the cutoff and the gates (dist < cube_size,
// dist < r_max, dist < 1) decide exactly as it does and the counters agree
// exactly.  The scan's d2 <= reach2 decides as sqrtf(d2) < cube_size does
// (reach2_of).  The force values may contract into FMAs and use rsqrtf; they
// agree with the plain version to f32 rounding and summation order.
#include <cuda_runtime.h>

#include <cmath>

#include "cp_async.cuh"
#include "forces.cuh"

namespace {

using yalla::BranchingForce;
using yalla::BranchingParams;
using yalla::cp_async4;
using yalla::IntercalationWGradient;
using yalla::pair_d2;
using yalla::pair_dist;
using yalla::reach2_of;

constexpr int kThreads = 256;      // lattice kernel: threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;          // lanes per live cell
constexpr int kList = 8;           // in-reach partners a lane lists
constexpr int kExtrasThreads = 128;
constexpr int kMaxDevices = 64;
static_assert(32 % kGroup == 0, "a cell's lanes share a warp");

// The channels of a functor: its kFields point fields in the order of its
// Cell (x, y, z first), then old_v x y z.  Branching reads 12 (x y z u v
// ctype px py pz and old_v), intercalation_w_gradient 16 (x y z w f
// ctype px py pz pcf psf pst psg and old_v).
template <class Force>
struct Chans {
  static constexpr int kChans = Force::kFields + 3;
  const float* p[kChans];
};

// A functor's Cell is kFields floats in channel order
template <class Force>
__device__ __forceinline__ typename Force::Cell load_cell(
    const Chans<Force>& c, int s) {
  static_assert(sizeof(typename Force::Cell) == Force::kFields * sizeof(float),
                "a Cell is its kFields floats");
  typename Force::Cell a;
  float* v = reinterpret_cast<float*>(&a);
#pragma unroll
  for (int k = 0; k < Force::kFields; ++k) v[k] = __ldg(c.p[k] + s);
  return a;
}

struct Grid {
  int gx, gy, gz, C;
  float cutoff;
  float reach2;  // the largest d2 with sqrtf(d2) < cutoff
                 // (forces.cuh::reach2_of)
};

struct Brick {
  int bz, by, bx;  // cubes per block
};

// The exchanged z planes of a slab: channels and occupancy of the plane
// below z = 0 (lo) and above z = gz - 1 (hi); null where there is none
template <class Force>
struct ZHalo {
  Chans<Force> lo, hi;
  const unsigned char* occ_lo;
  const unsigned char* occ_hi;
};

template <class Force>
struct Extras {
  Chans<Force> ch;
  const int* cube;   // [E_cap] cube id per extra, n_cubes = empty
  const int* order;  // [E_cap] extras sorted by cube
  const int* start;  // [n_cubes + 1] run of each cube in ``order``
  int cap;
};

// Shared-memory bytes of a block for a functor of ``n_chans`` channels
// (ops/lattice_pallas.py::lattice_plan computes the same sum), with H the
// halo's cubes, R = hy * hz its x-rows of hx = bx + 2 xr cubes, B the
// brick's cubes and HC = H * C the halo's slots:
//   rl     float4 [HC]              each x-row's live slots in slot order,
//                                   row r from r * hx * C: x y z and the
//                                   slot's id e, slot (hc, c) being
//                                   e = hc * C + c
//   ch     float  [n_chans - 3][HC] the live slots' other channels, at e
//   cs     int    [R][hx + 1]       live slots of each row before each of
//                                   its cubes, and the row's total
//   es/ee  int    [2 * H]           extras run of each halo cube
//   off    int    [B + 1]           work-list offset of each own cube
//   items  int    [B * C]           work list: each own live cell's place
//                                   in rl (16 bits) and its cube's halo
//                                   x, y, z (5, 5 and 6 bits)
//   plist  ushort [kList][kThreads] each lane's partners in reach (places
//                                   in rl)
//   glist  ushort [kThreads][kList] each cell's partners, its lanes' lists
//                                   joined
// While the halo is staged, plist and glist hold its occupancy, a byte per
// slot (launch refuses a halo of more than 4 * kList * kThreads slots).
long long smem_bytes(const Brick& b, int C, int n_chans, int xr) {
  const long long hx = b.bx + 2 * xr,
                  R = (long long)(b.by + 2) * (b.bz + 2);
  const long long H = hx * R;
  const long long B = (long long)b.bz * b.by * b.bx;
  const long long HC = H * C;
  return 16 * HC + 4LL * (n_chans - 3) * HC + 4 * R * (hx + 1) + 8 * H +
         4 * (B + 1) + 4 * B * C + 4LL * kList * kThreads;
}

// Sums of partner ``j`` (an extra, from device memory) into ``acc`` for
// point ``a``
template <class Force>
__device__ __forceinline__ void visit(const Force& f,
                                      const typename Force::Cell& a,
                                      const Chans<Force>& ch, int j,
                                      float cutoff, float* acc) {
  constexpr int kF = Force::kFields;
  const float dist = pair_dist(a.x, a.y, a.z, __ldg(ch.p[0] + j),
                               __ldg(ch.p[1] + j), __ldg(ch.p[2] + j));
  if (!(dist < cutoff)) return;
  f.pair(a, load_cell(ch, j), dist, __ldg(ch.p[kF] + j),
         __ldg(ch.p[kF + 1] + j), __ldg(ch.p[kF + 2] + j), acc);
}

// The staged cell at place ``i`` of rl; its slot id in ``e``
template <class Force>
__device__ __forceinline__ typename Force::Cell staged_cell(
    const float4* rl, const float* ch, int HC, int i, int& e) {
  const float4 p = rl[i];
  e = __float_as_int(p.w);
  typename Force::Cell a;
  float* v = reinterpret_cast<float*>(&a);
  v[0] = p.x;
  v[1] = p.y;
  v[2] = p.z;
#pragma unroll
  for (int k = 3; k < Force::kFields; ++k) v[k] = ch[(k - 3) * HC + e];
  return a;
}

// The force on ``a`` (at place ``i_me`` of rl) from the staged partner at
// place ``i`` in reach, unless that is ``a`` itself
template <class Force>
__device__ __forceinline__ void staged_pair(const Force& f,
                                            const typename Force::Cell& a,
                                            const float4* rl,
                                            const float* ch, int HC,
                                            int i_me, int i, float* acc) {
  constexpr int kOv = Force::kFields - 3;  // old_v's first row in ch
  if (i == i_me) return;
  int e;
  const typename Force::Cell b = staged_cell<Force>(rl, ch, HC, i, e);
  const float dist = pair_dist(a.x, a.y, a.z, b.x, b.y, b.z);
  f.pair(a, b, dist, ch[kOv * HC + e], ch[(kOv + 1) * HC + e],
         ch[(kOv + 2) * HC + e], acc);
}

// Stage halo x-row ``r`` of ``RL`` slots from ``src`` at slot ``base``
// (one warp): asynchronous copies of its live slots' channels, its list of
// live slots in slot order, and where each of its cubes starts in that list
template <class Force>
__device__ __forceinline__ void stage_row(const Chans<Force>& src, int base,
                                          int r, int RL, int HC, int hx,
                                          int C, const unsigned char* occ_s,
                                          float4* rl, float* ch, int* cs) {
  constexpr int kChans = Chans<Force>::kChans;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int q0 = 0; q0 < RL; q0 += 32) {
    const int q = q0 + lane, e = r * RL + q;
    const bool live = q < RL && occ_s[e];
    const unsigned m = __ballot_sync(0xffffffffu, live);
    const int rank = count + __popc(m & below);
    if (live) {
      const int s = base + q;
      float* p = (float*)(rl + r * RL + rank);
#pragma unroll
      for (int k = 0; k < 3; ++k) cp_async4(p + k, src.p[k] + s);
      p[3] = __int_as_float(e);
#pragma unroll
      for (int k = 3; k < kChans; ++k)
        cp_async4(ch + (k - 3) * HC + e, src.p[k] + s);
    }
    if (q < RL && q % C == 0) cs[r * (hx + 1) + q / C] = rank;
    count += __popc(m);
  }
  if (lane == 0) cs[r * (hx + 1) + hx] = count;
}

template <class Force, bool kThin, bool kHalo>
__global__ void __launch_bounds__(kThreads, 2)
lattice_pair_kernel(const Force f, const Grid g, const Brick br,
                    const Chans<Force> L,
                    const unsigned char* __restrict__ occ,
                    const ZHalo<Force> Z, const Extras<Force> E,
                    float* __restrict__ out, const int thin_xr) {
  using Cell = typename Force::Cell;
  constexpr int kChans = Chans<Force>::kChans;
  constexpr int kOut = Force::kSums;
  extern __shared__ float4 smem[];
  const int C = g.C;
  const int xr = kThin ? thin_xr : 1;
  const int hx = br.bx + 2 * xr, hy = br.by + 2, hz = br.bz + 2;
  const int H = hx * hy * hz, HC = H * C, R = hy * hz, RL = hx * C;
  const int B = br.bx * br.by * br.bz;
  float4* rl = smem;
  float* ch = (float*)(rl + HC);
  int* cs = (int*)(ch + (kChans - 3) * HC);
  int* es = cs + R * (hx + 1);
  int* ee = es + H;
  int* off = ee + H;
  int* items = off + B + 1;
  unsigned short* plist = (unsigned short*)(items + B * C) + threadIdx.x;
  const int u = threadIdx.x % kGroup;
  unsigned short* glist = plist - threadIdx.x + kList * kThreads +
                          (threadIdx.x - u) * kList;
  const long long n_slots = (long long)g.gx * g.gy * g.gz * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int nbx = (g.gx + br.bx - 1) / br.bx;
  const int nby = (g.gy + br.by - 1) / br.by;
  const int x0 = (blockIdx.x % nbx) * br.bx;
  const int y0 = (blockIdx.x / nbx % nby) * br.by;
  const int z0 = (blockIdx.x / (nbx * nby)) * br.bz;

  // 1. stage the halo.  First its occupancy, into the partner lists' room
  //    (unused until step 3), all loads independent; a slab's rows at
  //    z = -1 and z = gz read the exchanged planes
  unsigned char* occ_s = (unsigned char*)(plist - threadIdx.x);
  const int plane = g.gy * g.gx * C;
  for (int i = threadIdx.x; i < HC; i += kThreads) {
    const int r = i / RL, xs = (x0 - xr) * C + i - r * RL;
    const int y = y0 + r % hy - 1, z = z0 + r / hy - 1;
    const bool in_xy = y >= 0 && y < g.gy && xs >= 0 && xs < g.gx * C;
    if (kHalo) {
      const unsigned char* o = z < 0       ? Z.occ_lo
                               : z < g.gz  ? occ + z * plane
                               : z == g.gz ? Z.occ_hi
                                           : nullptr;
      occ_s[i] = o && in_xy ? o[y * g.gx * C + xs] : 0;
    } else {
      occ_s[i] = in_xy && z >= 0 && z < g.gz
                     ? occ[(z * g.gy + y) * g.gx * C + xs]
                     : 0;
    }
  }
  __syncthreads();
  //    Then one warp per x-row of RL contiguous slots (stage_row), from the
  //    lattice or from an exchanged plane, the same source for the whole
  //    warp; then the extras runs
  for (int r = warp; r < R; r += kWarps) {
    const int y = y0 + r % hy - 1, z = z0 + r / hy - 1;
    const int row = (y * g.gx + x0 - xr) * C;
    if (kHalo && z < 0)
      stage_row<Force>(Z.lo, row, r, RL, HC, hx, C, occ_s, rl, ch, cs);
    else if (kHalo && z >= g.gz)
      stage_row<Force>(Z.hi, row, r, RL, HC, hx, C, occ_s, rl, ch, cs);
    else
      stage_row<Force>(L, z * plane + row, r, RL, HC, hx, C, occ_s, rl, ch,
                       cs);
  }
  int extras_here = 0;
  for (int hc = threadIdx.x; hc < H; hc += kThreads) {
    const int x = x0 + hc % hx - xr, y = y0 + hc / hx % hy - 1,
              z = z0 + hc / (hx * hy) - 1;
    int lo = 0, hi = 0;
    if (E.cap > 0 && x >= 0 && x < g.gx && y >= 0 && y < g.gy && z >= 0 &&
        z < g.gz) {
      const int cube = (z * g.gy + y) * g.gx + x;
      lo = E.start[cube];
      hi = E.start[cube + 1];
    }
    es[hc] = lo;
    ee[hc] = hi;
    extras_here |= hi > lo;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  const bool halo_extras = __syncthreads_or(extras_here);

  // 2. the work list: an exclusive prefix sum of the own cubes' live
  //    counts (one warp), then each own cube's places in rl.  A ragged
  //    brick's cubes past the grid own nothing: in a slab, its plane at
  //    z = gz is the exchanged halo plane, staged but not the brick's
  auto own_cs = [&](int o) {  // own cube o's entry in cs
    const int ox = o % br.bx, oy = o / br.bx % br.by,
              oz = o / (br.bx * br.by);
    return ((oz + 1) * hy + oy + 1) * (hx + 1) + ox + xr;
  };
  auto own_n = [&](int o) {  // own cube o's live cells
    return kHalo && z0 + o / (br.bx * br.by) >= g.gz
               ? 0
               : cs[own_cs(o) + 1] - cs[own_cs(o)];
  };
  if (threadIdx.x < 32) {
    const int per = (B + 31) / 32;
    const int o0 = min(lane * per, B), o1 = min(o0 + per, B);
    int local = 0;
    for (int o = o0; o < o1; ++o) local += own_n(o);
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - local;
    for (int o = o0; o < o1; ++o) {
      off[o] = run;
      run += own_n(o);
    }
    if (lane == 31) off[B] = incl;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < B; o += kThreads) {
    const int first = own_cs(o) / (hx + 1) * RL + cs[own_cs(o)];
    const int where = (o % br.bx + xr) << 16 | (o / br.bx % br.by + 1) << 21 |
                      (o / (br.bx * br.by) + 1) << 26;
    for (int k = 0; k < off[o + 1] - off[o]; ++k)
      items[off[o] + k] = first + k | where;
  }
  __syncthreads();

  // 3. each live cell's sums.  Its kGroup lanes split each of the 9 rows
  //    of 2 xr + 1 cubes around it, slot by slot, and list the partners
  //    in reach (the extras of its stencil's cubes are visited in device
  //    memory); then the lanes' lists are joined and split evenly for the
  //    force
  const int W = off[B];
  for (int w0 = 0; w0 < W; w0 += kThreads / kGroup) {
    const int w = w0 + threadIdx.x / kGroup;
    float acc[kOut];
#pragma unroll
    for (int m = 0; m < kOut; ++m) acc[m] = 0.0f;
    int i_me = -1, e_me = 0, nl = 0, xh = 0, yh = 0, zh = 0;
    Cell a{};
    if (w < W) {
      const int item = items[w];
      i_me = item & 0xffff;
      xh = item >> 16 & 31;
      yh = item >> 21 & 31;
      zh = item >> 26;
      a = staged_cell<Force>(rl, ch, HC, i_me, e_me);
      if (u == 0) f.self_pair(a, acc);
      const int r_me = zh * hy + yh, hc = r_me * hx + xh;
      for (int k = 0; k < 9; ++k) {
        const int r = r_me + (k / 3 - 1) * hy + k % 3 - 1;
        const int* c = cs + r * (hx + 1) + xh;
        const int hi = r * RL + c[xr + 1];
        for (int idx = r * RL + c[-xr] + u; idx < hi; idx += kGroup) {
          // listed always, kept if in reach (itself included: it is
          // skipped in the force, one test per partner, not per candidate)
          const float4 b = rl[idx];
          plist[nl * kThreads] = (unsigned short)idx;
          nl += pair_d2(a.x, a.y, a.z, b.x, b.y, b.z) <= g.reach2;
          if (nl == kList) {
            for (int t = 0; t < kList; ++t)
              staged_pair(f, a, rl, ch, HC, i_me, plist[t * kThreads], acc);
            nl = 0;
          }
        }
      }
      if (halo_extras) {
        const int nx = 2 * xr + 1;
        for (int nb = u; nb < 9 * nx; nb += kGroup) {
          const int nh = hc + (nb / (3 * nx) - 1) * hy * hx +
                         (nb / nx % 3 - 1) * hx + nb % nx - xr;
          for (int k2 = es[nh]; k2 < ee[nh]; ++k2)
            visit(f, a, E.ch, E.order[k2], g.cutoff, acc);
        }
      }
    }
    int incl = nl;
#pragma unroll
    for (int d = 1; d < kGroup; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d, kGroup);
      if (u >= d) incl += v;
    }
    const int n_partners = __shfl_sync(0xffffffffu, incl, kGroup - 1, kGroup);
    for (int t = 0; t < nl; ++t) glist[incl - nl + t] = plist[t * kThreads];
    __syncwarp();
    for (int p = u; p < n_partners; p += kGroup)
      staged_pair(f, a, rl, ch, HC, i_me, glist[p], acc);
    __syncwarp();  // the joined list is read before the next cell's
#pragma unroll
    for (int m = 0; m < kOut; ++m)
#pragma unroll
      for (int d = 1; d < kGroup; d <<= 1)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], d);
    if (w < W) {  // lane u writes sums u and u + kGroup
      const int c = e_me - ((zh * hy + yh) * hx + xh) * C;
      const long long s = ((long long)((z0 + zh - 1) * g.gy + y0 + yh - 1) *
                               g.gx + x0 + xh - xr) * C + c;
#pragma unroll
      for (int m = 0; m < kOut; ++m)
        if (m % kGroup == u) out[m * n_slots + s] = acc[m];
    }
  }

  // 4. zeros for the brick's empty slots, one warp per brick x-row of
  //    bx * C contiguous slots
  const int run = min(br.bx, g.gx - x0) * C;
  for (int r = warp; r < br.bz * br.by; r += kWarps) {
    const int y = y0 + r % br.by, z = z0 + r / br.by;
    if (y >= g.gy || z >= g.gz) continue;
    const long long s0 = ((long long)(z * g.gy + y) * g.gx + x0) * C;
    for (int q = lane; q < run; q += 32) {
      if (occ[s0 + q]) continue;
#pragma unroll
      for (int m = 0; m < kOut; ++m) out[m * n_slots + s0 + q] = 0.0f;
    }
  }
}

template <class Force, bool kThin>
__global__ void __launch_bounds__(kExtrasThreads)
extras_pair_kernel(const Force f, const Grid g, const Chans<Force> L,
                   const unsigned char* __restrict__ occ,
                   const Extras<Force> E, float* __restrict__ out,
                   const int thin_xr) {
  using Cell = typename Force::Cell;
  constexpr int kOut = Force::kSums;
  static_assert(kOut <= 32, "a lane zeroes each sum of a dead extra");
  const int lane = threadIdx.x & 31;
  const int e = (blockIdx.x * kExtrasThreads + threadIdx.x) >> 5;
  if (e >= E.cap) return;
  const int n_cubes = g.gx * g.gy * g.gz;
  const int cube = E.cube[e];
  if (cube >= n_cubes) {
    if (lane < kOut) out[(long long)lane * E.cap + e] = 0.0f;
    return;
  }
  const Cell a = load_cell(E.ch, e);
  float acc[kOut];
#pragma unroll
  for (int m = 0; m < kOut; ++m) acc[m] = 0.0f;
  const int cx = cube % g.gx, cy = cube / g.gx % g.gy,
            cz = cube / (g.gx * g.gy);
  const int xr = kThin ? thin_xr : 1, nx = 2 * xr + 1, n_nb = 9 * nx;
  // the stencil's cubes 32 at a time (27 at xr 1, 45 at xr 2): lane k
  // loads cube nb0 + k (-1 outside the grid) and its run of extras, at
  // once rather than one cube after another
  for (int nb0 = 0; nb0 < n_nb; nb0 += 32) {
    const int nb = nb0 + lane, m = min(32, n_nb - nb0);
    int nc = -1, lo = 0, hi = 0;
    if (lane < m) {
      const int x = cx + nb % nx - xr, y = cy + nb / nx % 3 - 1,
                z = cz + nb / (3 * nx) - 1;
      if (x >= 0 && x < g.gx && y >= 0 && y < g.gy && z >= 0 && z < g.gz) {
        nc = (z * g.gy + y) * g.gx + x;
        lo = E.start[nc];
        hi = E.start[nc + 1];
      }
    }
    for (int t0 = 0; t0 < m * g.C; t0 += 32) {
      const int t = t0 + lane, k = min(t / g.C, m - 1);
      const int c3 = __shfl_sync(0xffffffffu, nc, k);
      if (t < m * g.C && c3 >= 0) {
        const int j = c3 * g.C + t - k * g.C;
        if (occ[j]) visit(f, a, L, j, g.cutoff, acc);
      }
    }
    for (int k = 0; k < m; ++k) {
      const int k0 = __shfl_sync(0xffffffffu, lo, k),
                k1 = __shfl_sync(0xffffffffu, hi, k);
      for (int q = k0 + lane; q < k1; q += 32) {
        const int e2 = E.order[q];
        if (e2 == e)
          f.self_pair(a, acc);
        else
          visit(f, a, E.ch, e2, g.cutoff, acc);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kOut; ++m) {
    float v = acc[m];
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    acc[m] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < kOut; ++m) out[(long long)m * E.cap + e] = acc[m];
  }
}

template <class Force, bool kThin, bool kHalo>
int launch(const Force& f, const Grid& g, int xr, const Brick& br,
           long long smem, const Chans<Force>& L, const unsigned char* occ,
           const ZHalo<Force>& Z, const Extras<Force>& E, float* out,
           float* eout, cudaStream_t stream) {
  const long long n_slots = (long long)g.gx * g.gy * g.gz * g.C;
  const long long HC = (long long)(br.bx + 2 * xr) * (br.by + 2) *
                       (br.bz + 2) * g.C;
  // places in rl are 16-bit, a cube's halo coordinates 5 bits (x, y) and
  // 6 (z), and the halo's occupancy is staged in the partner lists' room
  if (g.gx < 1 || g.gy < 1 || g.gz < 1 || g.C < 1 || xr < 1 ||
      (xr > 1) != kThin || br.bx < 1 || br.by < 1 || br.bz < 1 ||
      n_slots >= (1LL << 31) || HC > 65535 || HC > 4 * kList * kThreads ||
      br.bx + 2 * xr > 32 || br.by > 30 || br.bz > 30 ||
      smem < smem_bytes(br, g.C, Chans<Force>::kChans, xr) ||
      smem > 232448 || (kHalo && (E.cap > 0 || !Z.occ_lo || !Z.occ_hi)))
    return (int)cudaErrorInvalidValue;
  // above the default 48 KB a kernel takes dynamic shared memory only by
  // opting in; once per device, for the largest size asked so far
  static long long opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > opted[dev]) {
    err = cudaFuncSetAttribute(lattice_pair_kernel<Force, kThin, kHalo>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  const int blocks = ((g.gx + br.bx - 1) / br.bx) *
                     ((g.gy + br.by - 1) / br.by) *
                     ((g.gz + br.bz - 1) / br.bz);
  lattice_pair_kernel<Force, kThin, kHalo>
      <<<blocks, kThreads, (size_t)smem, stream>>>(f, g, br, L, occ, Z, E,
                                                   out, xr);
  if (E.cap > 0)
    extras_pair_kernel<Force, kThin>
        <<<(E.cap * 32 + kExtrasThreads - 1) / kExtrasThreads,
           kExtrasThreads, 0, stream>>>(f, g, L, occ, E, eout, xr);
  return (int)cudaGetLastError();
}

template <class Force>
Chans<Force> chans_of(const void* const* ptrs) {
  Chans<Force> c{};
  if (ptrs)
    for (int k = 0; k < Chans<Force>::kChans; ++k)
      c.p[k] = (const float*)ptrs[k];
  return c;
}

// One entry point's work: the grid, brick and extras of its arguments
template <class Force>
int launch_entry(const Force& f, const void* const* chans,
                 const unsigned char* occ, const void* const* lo_chans,
                 const void* const* hi_chans, const unsigned char* lo_occ,
                 const unsigned char* hi_occ, const void* const* echans,
                 const int* ecube, const int* eorder, const int* estart,
                 int E_cap, int gx, int gy, int gz, int C, float cube_size,
                 int xr, int bz, int by, int bx, long long smem, float* out,
                 float* eout, cudaStream_t stream) {
  const Grid g{gx, gy, gz, C, cube_size, reach2_of(cube_size)};
  const Brick br{bz, by, bx};
  const Extras<Force> E{chans_of<Force>(echans), ecube, eorder, estart,
                        E_cap};
  const Chans<Force> L = chans_of<Force>(chans);
  // a slab has both planes, each with its channels and occupancy
  const bool halo = lo_occ || hi_occ || lo_chans || hi_chans;
  if (halo && !(lo_occ && hi_occ && lo_chans && hi_chans))
    return (int)cudaErrorInvalidValue;
  const ZHalo<Force> Z{chans_of<Force>(lo_chans), chans_of<Force>(hi_chans),
                       lo_occ, hi_occ};
  if (halo)
    return xr == 1 ? launch<Force, false, true>(f, g, xr, br, smem, L, occ,
                                                Z, E, out, eout, stream)
                   : launch<Force, true, true>(f, g, xr, br, smem, L, occ,
                                               Z, E, out, eout, stream);
  return xr == 1 ? launch<Force, false, false>(f, g, xr, br, smem, L, occ,
                                               Z, E, out, eout, stream)
                 : launch<Force, true, false>(f, g, xr, br, smem, L, occ, Z,
                                              E, out, eout, stream);
}

}  // namespace

// One entry point per functor.  chans / echans: host arrays of the
// functor's kFields + 3 device pointers (lattice slots and extras);
// lo_chans / hi_chans and lo_occ / hi_occ: a slab's exchanged z planes
// (null on the single-device path; no extras with them); xr:
// the x reach in cubes (1, or x_split); bz, by, bx, smem: the brick and
// shared-memory bytes of ops/lattice_pallas.py::lattice_plan; params:
// host array of the functor's parameter values (ops/functors.py,
// ``params``).
#define YALLA_LATTICE_ENTRY(NAME, FORCE, SET_PARAMS)                        \
  extern "C" int NAME(                                                     \
      const void* const* chans, const unsigned char* occ,                  \
      const void* const* lo_chans, const void* const* hi_chans,            \
      const unsigned char* lo_occ, const unsigned char* hi_occ,            \
      const void* const* echans, const int* ecube, const int* eorder,      \
      const int* estart, int E_cap, int gx, int gy, int gz, int C,         \
      float cube_size, int xr, int bz, int by, int bx, long long smem,     \
      const float* params, float* out, float* eout, cudaStream_t stream) { \
    FORCE f;                                                               \
    SET_PARAMS;                                                            \
    return launch_entry(f, chans, occ, lo_chans, hi_chans, lo_occ,        \
                        hi_occ, echans, ecube, eorder, estart, E_cap, gx,  \
                        gy, gz, C, cube_size, xr, bz, by, bx, smem, out,   \
                        eout, stream);                                     \
  }

// the 10 BranchingParams values
YALLA_LATTICE_ENTRY(yalla_lattice_pair_branching, BranchingForce,
                    f.p = (BranchingParams{params[0], params[1], params[2],
                                           params[3], params[4], params[5],
                                           params[6], params[7], params[8],
                                           params[9]}))
// r_max
YALLA_LATTICE_ENTRY(yalla_lattice_pair_intercalation_w_gradient,
                    IntercalationWGradient, f.r_max = params[0])
