// Gabriel lattice pair pass (kernel K5): Gabriel-pruned pair sums on the
// dense cube lattice, written in stable-id order.
//
// Replaces yalla_tpu/ops/gabriel_pallas.py::gabriel_lattice_pallas.  What it
// computes, not its TPU layout: for every active point i (stable id t, in
// some lattice slot), the candidates are the occupied slots j != i of the 27
// cubes around i's with dist < cube_size.  The first NC of them in stencil
// order (dz, dy, dx, slot) form the compact set; more set the point's flag
// (``__err_gabriel_candidates``, gabriel_pallas.py:188-201).  A compact
// candidate r is kept unless another compact candidate k lies inside the
// sphere of radius 0.5 * gc * d(i, r) on the i-r midpoint:
//   |m - x_k|^2 < d2_r * gc2  and  d2_k < cube_size^2,  m = (x_i + x_r) / 2,
// and only if d2_r < cube_size^2 itself (:203-225).  The force functor then
// runs on the kept pairs with the points' stable ids, and once on the
// diagonal (:227-268).  Sums: the functor's dF fields and aux channels,
// sum_f, sum_v x y z, then the flag row.  The TPU kernel's shifted windows,
// in-VMEM cursor compaction and replay pass are TPU workarounds and have no
// counterpart here.
//
// Bound: operations, not bytes, and both are small.  At the growth_w_wall
// density (2.4 points a cube) a point tests about 65 live candidates for
// reach, its 9 or so candidates in reach against each other, and takes the
// force of about 8 kept pairs; the pass reads the live prefix of each cube's
// stable ids, the live points' positions and old_v once and writes 8 rows of
// n_pad sums: microseconds on an H100.  What costs time is finding the live
// slots, fetching them, and keeping the lanes busy on lists this short.
// The first version ran one thread per stable id, walked all 27 x C slots of
// its stencil in device memory (432 reads of an 8-byte id per point at C 16
// to find 65 live ones) and kept its candidates in per-thread arrays with
// dynamic indices, which live in local memory.
//
// Design for Hopper:
// * Work in slot order.  A block owns a brick of bz x by x bx cubes
//   (ops/gabriel_pallas.py::gabriel_plan picks it: 4 x 4 x 4 where the
//   shared memory allows, clipped to the grid; a ragged brick at the grid's
//   edge is masked).  A brick whose cubes hold no point exits at once.
// * Read only what is live.  The pour places a cube's points at ranks 0, 1,
//   ..., so a cube's live slots are a prefix of its C slots.  Four lanes
//   take each cube of the brick's halo, (bz+2) x (by+2) x (bx+2) cubes, read
//   four ids at a time (one 32-byte sector) and stop at the first empty
//   slot; each live slot's x, y, z go to shared memory by cp.async, with
//   its stable id, as one 16-byte entry at cube * Cp + rank (Cp is C
//   rounded up to a power of two, so a place splits into cube and rank by a
//   shift and a mask, and a cube's first lattice slot is kept beside its
//   count: no division in the loops).  The copies are waited for once.
// * Four lanes take each live point of the brick.  They sweep the 9 x-rows
//   of 3 cubes around it in stencil order, four entries of a row's three
//   live prefixes at a time; a warp-wide ballot, cut to the group's bits,
//   and a population count give each candidate in reach its rank, so the
//   first NC are the plain version's first NC.  A warp's eight groups sweep
//   in step, each row to the longest of the eight: a vote under a
//   lane-group mask inside a loop the groups leave at different times
//   splits the warp for good, and every instruction then runs once per
//   group.  A candidate is one 16-byte shared-memory read and a d2 test
//   (d2 <= reach2 decides as sqrtf(d2) < cube_size does,
//   forces.cuh::reach2_of).
// * The compact set lives in shared memory as 16-bit entries: the place in
//   the staged list (15 bits) and whether d2 < cube_size^2.  One code path
//   serves every NC; nothing is indexed dynamically in registers.
// * The lanes split the compact set for the midpoint test, candidate r to
//   lane r % 4, and the lane that keeps a pair runs the force on it: the
//   partner's other channels and old_v come from device memory, for kept
//   pairs only.  The sums meet by shuffles in a fixed order and go to
//   out[m, stable id].  Rows of ids with no slot are zeroed by the wrapper.
//
// Where it stands (H100 80GB HBM3, 700 W; yalla_tpu_torch/kernel_profile.py
// and its --plans): 0.090 ms per 100k pass at gs 48, C 16, NC 32, and 0.006
// for the wrapper's fill and casts, against 0.31 to 0.33 for the first
// version; 53 registers, no spills, no local memory.  It is bound by the
// instruction rate on short lists: a row holds about 7 live entries and a
// compact set about 9, and a warp's groups run to the longest of theirs, so
// under half of the lanes' tests are needed ones.  Measured on the way, fill
// included: 8 lanes a point 0.111 ms and 2 lanes 0.107 for 0.096 with 4;
// bricks of 2 x 4 x 4 cubes 0.097, 4 x 4 x 8 0.130 (fewer blocks an SM);
// votes under lane-group masks 0.133 for 0.114 warp-wide; divisions in the
// loops 5 % slower; having four cubes' ids in flight per quad while
// staging, asking for a partner's old_v before its midpoint test, and two
// candidates a lane per pass over the compact set each moved nothing or
// lost.
//
// Numerics: every product and sum of the distances and of the midpoint test
// is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction) in the
// order the plain torch version computes it, with IEEE sqrt, so the
// candidate and kept sets equal the plain version's and the friction sum
// agrees exactly.  The force values may contract into FMAs and are summed in
// another order; they agree to f32 rounding.
#include <cuda_runtime.h>

#include <cstring>

#include "cp_async.cuh"
#include "forces.cuh"

namespace {

using yalla::cp_async4;
using yalla::pair_d2;

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // lanes per live point (8 and 2 ran slower)
constexpr int kGroups = kThreads / kGroup;
constexpr int kQuad = 4;  // lanes per halo cube while staging
constexpr int kNear = 0x8000;  // compact entry: d2 < cube_size^2
constexpr int kMaxDevices = 64;
static_assert(32 % kGroup == 0, "a point's lanes share a warp");

template <int N>
struct Ptrs {
  const float* p[N];
};

struct Lattice {
  int gx, gy, gz, C;
  int lgC;  // log2 of a cube's stride in the staged list, C rounded up
  int n_pad, NC;
  float reach2;   // the largest d2 with sqrtf(d2) < cube_size
  float cutoff2;  // cube_size^2 as f32
  float gc2;
};

struct Brick {
  int bz, by, bx;  // cubes per block
};

// Shared-memory bytes of a block (ops/gabriel_pallas.py::gabriel_smem_bytes
// computes the same sum), with H the halo's cubes, B the brick's and Cp the
// capacity rounded up to a power of two (places split by shift and mask):
//   rl     float4 [H * Cp]      the halo's live points: x y z and the stable
//                               id, point of rank k in halo cube hc at
//                               hc * Cp + k
//   cnt    int    [H]           live points of each halo cube
//   first  int    [H]           each halo cube's first lattice slot
//   nW     int    [4]           the work list's length (and padding)
//   items  ushort [B * C]       work list: each own live point's place in rl
//   cset   ushort [kGroups][NC] each group's compact set: places in rl, with
//                               kNear set where d2 < cube_size^2
long long smem_bytes(const Brick& b, int C, int lgC, int NC) {
  const long long H = (long long)(b.bx + 2) * (b.by + 2) * (b.bz + 2);
  const long long B = (long long)b.bx * b.by * b.bz;
  return ((16 * H) << lgC) + 8 * H + 16 + 2 * B * C + 2LL * kGroups * NC;
}

int log2_ceil(int C) {
  int lg = 0;
  while ((1 << lg) < C) ++lg;
  return lg;
}

__device__ __forceinline__ float sq_sum(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The functor's cell of the point staged as ``p`` in lattice slot ``s``: x, y,
// z from shared memory, further fields from device memory
template <class Cell, int N>
__device__ __forceinline__ Cell cell_of(const float4& p, const Ptrs<N>& ch,
                                        int s) {
  constexpr int kF = sizeof(Cell) / sizeof(float);
  float v[kF];
  v[0] = p.x;
  v[1] = p.y;
  v[2] = p.z;
#pragma unroll
  for (int k = 3; k < kF; ++k) v[k] = __ldg(ch.p[k] + s);
  Cell c;
  memcpy(&c, v, sizeof(Cell));
  return c;
}

// ch: the functor's kFields slot channels (x y z first), then old_v x y z,
// each [n_slots]; pid: [n_slots] stable id per slot (n_pad where empty), a
// cube's live slots a prefix of its C; out: [kSums + 1, n_pad], zeroed.
template <class Force>
__global__ void __launch_bounds__(kThreads, 3)
gabriel_pair_kernel(const Force f, const Ptrs<Force::kFields + 3> ch,
                    const long long* __restrict__ pid, const Lattice g,
                    const Brick br, float* __restrict__ out) {
  using Cell = typename Force::Cell;
  constexpr int kF = Force::kFields;
  constexpr int kOut = Force::kSums + 1;
  extern __shared__ float4 smem[];
  const int C = g.C, NC = g.NC, lg = g.lgC, kmask = (1 << g.lgC) - 1;
  const int hx = br.bx + 2, hy = br.by + 2, hz = br.bz + 2;
  const int H = hx * hy * hz, B = br.bx * br.by * br.bz;
  float4* __restrict__ rl = smem;
  int* __restrict__ cnt = (int*)(rl + (H << lg));
  int* __restrict__ first = cnt + H;
  int* nW = first + H;
  unsigned short* __restrict__ items = (unsigned short*)(nW + 4);
  const int lane = threadIdx.x & 31, u = threadIdx.x % kGroup;
  unsigned short* __restrict__ cset =
      items + B * C + (threadIdx.x / kGroup) * NC;

  const int nbx = (g.gx + br.bx - 1) / br.bx;
  const int nby = (g.gy + br.by - 1) / br.by;
  const int x0 = (blockIdx.x % nbx) * br.bx;
  const int y0 = (blockIdx.x / nbx % nby) * br.by;
  const int z0 = (blockIdx.x / (nbx * nby)) * br.bz;

  // 0. a brick that holds no point has nothing to do (a cube's first slot
  //    is live iff the cube is)
  int live_here = 0;
  for (int o = threadIdx.x; o < B; o += kThreads) {
    const int x = x0 + o % br.bx, y = y0 + o / br.bx % br.by,
              z = z0 + o / (br.bx * br.by);
    if (x < g.gx && y < g.gy && z < g.gz)
      live_here |= pid[(long long)((z * g.gy + y) * g.gx + x) * C] < g.n_pad;
  }
  if (threadIdx.x == 0) *nW = 0;
  if (!__syncthreads_or(live_here)) return;

  // 1. stage the halo: kQuad lanes per cube read its stable ids kQuad at a
  //    time up to the first empty slot, and copy the live slots' positions.
  //    Every vote is warp-wide and the loops around it warp-uniform (a
  //    cube whose ids have ended idles while a neighbour's go on): votes
  //    under lane-group masks would split the warp for good
  {
    const int q = threadIdx.x % kQuad;
    const unsigned qshift = lane & ~(kQuad - 1);
    for (int hc0 = 0; hc0 < H; hc0 += kThreads / kQuad) {
      const int hc = hc0 + threadIdx.x / kQuad;
      const int x = x0 + hc % hx - 1, y = y0 + hc / hx % hy - 1,
                z = z0 + hc / (hx * hy) - 1;
      bool open = hc < H && x >= 0 && x < g.gx && y >= 0 && y < g.gy &&
                  z >= 0 && z < g.gz;
      const int base = open ? ((z * g.gy + y) * g.gx + x) * C : 0;
      int n_live = 0;
      for (int k0 = 0; k0 < C; k0 += kQuad) {
        const int k = k0 + q;
        const long long id =
            open && k < C ? pid[base + k] : (long long)g.n_pad;
        const bool live = id < g.n_pad;
        if (live) {
          float* p = (float*)(rl + (hc << lg) + k);
#pragma unroll
          for (int c = 0; c < 3; ++c) cp_async4(p + c, ch.p[c] + base + k);
          p[3] = __int_as_float((int)id);
        }
        // the quad's live lanes are a prefix; a gap ends the cube
        const unsigned m = (__ballot_sync(0xffffffffu, live) >> qshift) &
                           ((1u << kQuad) - 1u);
        const int lead = __ffs(~m) - 1;
        n_live += lead;
        open = open && lead == kQuad;
        if (!__any_sync(0xffffffffu, open)) break;
      }
      if (q == 0 && hc < H) {
        cnt[hc] = n_live;
        first[hc] = base;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. the work list of the brick's live points, in any order: each point's
  //    sums are its own
  for (int o = threadIdx.x; o < B; o += kThreads) {
    const int hc = ((o / (br.bx * br.by) + 1) * hy + o / br.bx % br.by + 1) *
                       hx + o % br.bx + 1;
    const int n_live = cnt[hc];
    if (n_live > 0) {
      const int at = atomicAdd(nW, n_live);
      for (int k = 0; k < n_live; ++k)
        items[at + k] = (unsigned short)((hc << lg) + k);
    }
  }
  __syncthreads();

  // 3. each live point's sums, kGroup lanes a point.  A warp's groups walk
  //    their points in step: every vote and shuffle is warp-wide, and a
  //    row's sweep runs to the longest of the warp's rows
  const int W = *nW;
  const unsigned gshift = lane & ~(kGroup - 1);
  for (int w0 = 0; w0 < W; w0 += kGroups) {
    const int w = w0 + threadIdx.x / kGroup;
    const bool active = w < W;
    const int e_me = items[active ? w : 0];
    const int hc_me = e_me >> lg;
    const float4 pa = rl[e_me];
    const int t = __float_as_int(pa.w);
    const Cell a = cell_of<Cell>(pa, ch, first[hc_me] + (e_me & kmask));

    // 3a. the candidates in reach, ranked in stencil order; the first NC
    //     form the compact set
    int count = 0;
    for (int k9 = 0; k9 < 9; ++k9) {
      const int hrow = hc_me + (k9 / 3 - 1) * hx * hy + (k9 % 3 - 1) * hx;
      const int c0 = cnt[hrow - 1], c1 = cnt[hrow], c2 = cnt[hrow + 1];
      const int n_row = active ? c0 + c1 + c2 : 0;
      const int n_warp = __reduce_max_sync(0xffffffffu, n_row);
      for (int p0 = 0; p0 < n_warp; p0 += kGroup) {
        const int p = p0 + u;
        bool hit = false;
        int e = 0;
        if (p < n_row) {
          e = p < c0 ? ((hrow - 1) << lg) + p
                     : p < c0 + c1 ? (hrow << lg) + p - c0
                                   : ((hrow + 1) << lg) + p - c0 - c1;
          const float4 b = rl[e];
          const float d2 = pair_d2(pa.x, pa.y, pa.z, b.x, b.y, b.z);
          hit = e != e_me && d2 <= g.reach2;
          e |= d2 < g.cutoff2 ? kNear : 0;
        }
        const unsigned bits = (__ballot_sync(0xffffffffu, hit) >> gshift) &
                              ((1u << kGroup) - 1u);
        const int rank = count + __popc(bits & ((1u << u) - 1u));
        if (hit && rank < NC) cset[rank] = (unsigned short)e;
        count += __popc(bits);
      }
    }
    __syncwarp();
    const int m = min(count, NC);

    // 3b. the midpoint test and the force: candidate r to lane r % kGroup
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
    if (u == 0) {
      acc[Force::kSums] = count > NC ? 1.0f : 0.0f;
      f.self_pair(a, t, acc);
    }
    for (int r = u; r < m; r += kGroup) {
      const int er = cset[r];
      if (!(er & kNear)) continue;
      const float4 b = rl[er & (kNear - 1)];
      const float d2 = pair_d2(pa.x, pa.y, pa.z, b.x, b.y, b.z);
      const float mx = __fmul_rn(__fadd_rn(pa.x, b.x), 0.5f);
      const float my = __fmul_rn(__fadd_rn(pa.y, b.y), 0.5f);
      const float mz = __fmul_rn(__fadd_rn(pa.z, b.z), 0.5f);
      const float rad2 = __fmul_rn(d2, g.gc2);
      bool blocked = false;
      for (int k = 0; k < m; ++k) {
        const int ek = cset[k];
        const float4 c = rl[ek & (kNear - 1)];
        blocked |= k != r && (ek & kNear) &&
                   sq_sum(mx - c.x, my - c.y, mz - c.z) < rad2;
      }
      if (blocked) continue;
      const int e = er & (kNear - 1);
      const int s = first[e >> lg] + (e & kmask);
      f.pair(a, cell_of<Cell>(b, ch, s), t, __float_as_int(b.w), sqrtf(d2),
             __ldg(ch.p[kF] + s), __ldg(ch.p[kF + 1] + s),
             __ldg(ch.p[kF + 2] + s), acc);
    }
    __syncwarp();  // the compact set is read before the next point's
#pragma unroll
    for (int i = 0; i < kOut; ++i)
#pragma unroll
      for (int d = 1; d < kGroup; d <<= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], d);
    if (active) {
#pragma unroll
      for (int i = 0; i < kOut; ++i)  // lane u writes rows u, u + kGroup, ...
        if (i % kGroup == u) out[(long long)i * g.n_pad + t] = acc[i];
    }
  }
}

template <class Force>
int launch(const Force& f, const void* const* chans, const long long* pid,
           const Lattice& g, const Brick& br, long long smem, float* out,
           cudaStream_t stream) {
  Ptrs<Force::kFields + 3> ch;
  for (int k = 0; k < Force::kFields + 3; ++k)
    ch.p[k] = (const float*)chans[k];
  const long long n_slots = (long long)g.gx * g.gy * g.gz * g.C;
  // places in the staged list take 15 bits of a compact entry
  if (g.gx < 1 || g.gy < 1 || g.gz < 1 || g.C < 1 || g.NC < 1 ||
      g.n_pad < 0 || br.bx < 1 || br.by < 1 || br.bz < 1 ||
      n_slots >= (1LL << 31) ||
      ((long long)(br.bx + 2) * (br.by + 2) * (br.bz + 2) << g.lgC) > kNear ||
      smem < smem_bytes(br, g.C, g.lgC, g.NC) || smem > 232448)
    return (int)cudaErrorInvalidValue;
  // above the default 48 KB a kernel takes dynamic shared memory only by
  // opting in; once per device, for the largest size asked so far
  static long long opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > opted[dev]) {
    err = cudaFuncSetAttribute(gabriel_pair_kernel<Force>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  const long long blocks = (long long)((g.gx + br.bx - 1) / br.bx) *
                           ((g.gy + br.by - 1) / br.by) *
                           ((g.gz + br.bz - 1) / br.bz);
  gabriel_pair_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      f, ch, pid, g, br, out);
  return (int)cudaGetLastError();
}

}  // namespace

// chans: host array of the functor's slot-channel pointers then old_v x y z,
// each [gx * gy * gz * C] f32 on the device; pid: int64 on the device; gc2:
// (0.5 * gabriel_coefficient)^2 as f32; bz, by, bx, smem: the brick and
// shared-memory bytes of ops/gabriel_pallas.py::gabriel_plan; params: host
// array of the functor's parameters; out: [kSums + 1, n_pad] f32 on the
// device, zeroed.
extern "C" int yalla_gabriel_pair_wall_relu(
    const void* const* chans, const long long* pid, int n_pad, int gx, int gy,
    int gz, int C, float cube_size, float gc2, int NC, int bz, int by, int bx,
    long long smem, const float* params, float* out, cudaStream_t stream) {
  const yalla::WallRelu f{params[0], (int)params[1]};
  const Lattice g{gx, gy, gz, C, log2_ceil(C), n_pad, NC,
                  yalla::reach2_of(cube_size),
                  cube_size * cube_size, gc2};
  return launch(f, chans, pid, g, Brick{bz, by, bx}, smem, out, stream);
}
