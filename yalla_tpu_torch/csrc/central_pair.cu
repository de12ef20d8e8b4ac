// All-pairs pass for a central force (kernel K4): per-point sums over every
// pair, for a force of the form dF_xyz = w(dist, S_i, S_j, ch_ij) * r.
//
// Replaces yalla_tpu/ops/central_mxu.py::central_pairwise_mxu, which casts
// the reductions as f32 matmuls on the TPU's matrix unit.  What it
// computes, not its TPU layout: for every row i, over every j < n,
//   sum_w = sum_j w_ij,  sum_wx = sum_j w_ij x_j  (and y, z),
//   sum_f = sum_j f_ij,  sum_v  = sum_j f_ij old_v_j,  aux_a = sum_j g_a,ij
// and writes F = x_i * sum_w - sum_wx per axis, then sum_f, sum_v x y z and
// the aux channels (the output rows of central_mxu.py:250-257).  w is the
// force's radial coefficient and g_a its aux channels, a device functor
// below; f the friction's coefficient (friction_w_neighbour: dist < 1;
// friction_on_background: 0).  The i == j diagonal is excluded by
// poisoning its distance with the sentinel 1e4, and the wrapper has moved
// padding rows to the sentinel (central_mxu.py:180-186, 224-232); padding
// columns j >= n contribute exact zeros by the coefficient contract (0 past
// the cutoff), so the loops stop at n.  Scalar fields S and the bilinear
// channels ch_c = sum_k a_k(X_i) b_k(X_j) come in as columns the wrapper
// built in torch, as many as the functor declares.
//
// Bound: the pair arithmetic.  At the 5k sorting configuration (n 5000,
// n_pad 5120) a pass is 25M pairs at about 38 operations, two of them on
// the MUFU unit (two rsqrtf): some 14 us at the card's f32 rate.  The
// first version ran one thread per i in 40 blocks of 128 threads, so 92 of
// the 132 SMs idled and each busy SM held four warps running 5000
// dependent iterations (0.62 ms a pass).
//
// Design for Hopper, the all-pairs kernel's (tile_pair.cu, K3):
// * j is split across blocks.  The grid is (ceil(n_pad / (128 R)), S):
//   block (bx, s) takes R i-points per thread, held in registers, and the
//   j range [s * chunk, min(n, (s + 1) * chunk)); ops/tile_pallas.py::
//   tile_plan picks S so that no SM holds more than four blocks and most
//   hold four.
// * The j range streams through two shared-memory tiles of kTileJ points
//   (x y z, the fields, the b_k, old_v x y z), filled by cp.async while
//   the other tile is consumed; every read of a j value (a broadcast)
//   feeds R pairs.
// * No atomics: each block writes its partial sums (sum_w, sum_wx y z,
//   sum_f, sum_v x y z, aux) to a scratch [S, 8 + aux, n_pad], and
//   central_reduce_kernel sums them over S in a fixed order, then forms F.
//   Counters (sum_f, aux counts) are integers below 2^24, exact in any
//   order.
// The field, term and channel counts are the functor's, fixed at compile
// time (the wrapper passes the force's, and the entry point checks them).
// No tensor cores: TF32 would break the f32 tolerances the tests hold the
// path to.
//
// Numerics: dist = d2 * rsqrt(max(d2, 1e-12)), as JAX computes it
// (central_mxu.py:227-229), with d2's products and sums rounded one by one
// (no FMA contraction) in torch's order and rsqrtf, which torch.rsqrt on a
// CUDA tensor also uses; so the gates (dist < r_max, dist < 1) decide as
// the plain version's do on the card, and sum_f and the aux counts agree
// exactly.  chip_smoke.py checks rsqrtf against torch.rsqrt over every pair
// of the settled 5k state (yalla_rsqrtf below).  The coefficient may
// contract into FMAs, and the sums run in j order within a split, then
// over the splits; F and sum_v agree with the plain version to f32
// rounding and summation order.
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using yalla::cp_async4;
using yalla::cp_async_commit;
using yalla::cp_async_wait;

constexpr int kThreads = 128;      // threads per block
constexpr int kTileJ = 64;         // j points per shared-memory tile
constexpr int kPairSums = 8;       // sum_w, sum_wx y z, sum_f, sum_v x y z
constexpr float kSentinel = 1e4f;  // CENTRAL_SENTINEL

// yalla_tpu_torch/models/sorting.py::make_adhesion_central (bench.py:
// 764-768): strength (channel 0, two bilinear terms) * a * (a + 2 (r_min -
// dist)) / dist with a = max(r_max - dist, 0), zero past r_max and finite
// at the sentinel.  With kAux 1 it also counts the neighbours within
// r_max (the aux channel ``nbs`` of tests/test_central.py:95-97).
template <int kAux>
struct SortingAdhesionCentral {
  static constexpr int kFields = 0, kArity = 2, kChannels = 1;
  static constexpr int kMaxAux = kAux;
  float r_max, r_min;

  // the channel of bilinear term k
  __host__ __device__ static constexpr int chan(int) { return 0; }

  __device__ float operator()(float dist, const float*, const float*,
                              const float* ch) const {
    const float a = fmaxf(r_max - dist, 0.0f);
    const float b = a + 2.0f * (r_min - dist);
    const float rs = rsqrtf(fmaxf(dist * dist, 1e-12f));
    return ch[0] * (a * b) * rs;
  }

  // adds the pair's aux channels to acc
  __device__ void aux(float dist, const float*, const float*, const float*,
                      float* acc) const {
    if constexpr (kAux > 0) acc[0] += dist < r_max ? 1.0f : 0.0f;
  }
};

struct Layout {
  int n, n_pad;
  int friction;  // 1: dist < 1; 0: no neighbour friction
  int chunk;     // j points per split
};

// Start the copy of j in [j0, min(j0 + kTileJ, j_hi)) of the kRows rows of
// Cj (stride np) into ``tile``, as one cp.async group.
template <int kRows>
__device__ __forceinline__ void stage(float (*tile)[kTileJ], const float* Cj,
                                      long long np, int j0, int j_hi) {
  for (int e = threadIdx.x; e < kRows * kTileJ; e += kThreads) {
    const int k = e / kTileJ, jj = e % kTileJ;
    if (j0 + jj < j_hi) cp_async4(&tile[k][jj], Cj + k * np + j0 + jj);
  }
  cp_async_commit();
}

// Ri: [3 + F + A, n_pad] rows x y z, S, a_k (padding at the sentinel);
// Cj: [3 + F + A + 3, n_pad] rows x y z, S, b_k, old_v x y z;
// part: [gridDim.y, 8 + aux, n_pad], this block's split in row blockIdx.y.
template <class Coef, int R>
__global__ void __launch_bounds__(kThreads)
central_pair_kernel(const Coef coef, const Layout L,
                    const float* __restrict__ Ri,
                    const float* __restrict__ Cj, float* __restrict__ part) {
  constexpr int kF = Coef::kFields, kA = Coef::kArity, kC = Coef::kChannels;
  constexpr int kRows = 3 + kF + kA + 3;
  constexpr int kOv = 3 + kF + kA;
  constexpr int kS = kPairSums + Coef::kMaxAux;
  __shared__ float tile[2][kRows][kTileJ];
  const long long np = L.n_pad;
  const int i0 = blockIdx.x * kThreads * R + threadIdx.x;
  const int j_lo = blockIdx.y * L.chunk;
  const int j_hi = min(L.n, j_lo + L.chunk);

  // (+1: no zero-length arrays)
  float xi[R], yi[R], zi[R], si[R][kF + 1], ai[R][kA + 1];
  float acc[R][kS];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    const int ii = i < L.n_pad ? i : 0;
    xi[r] = Ri[ii];
    yi[r] = Ri[np + ii];
    zi[r] = Ri[2 * np + ii];
#pragma unroll
    for (int k = 0; k < kF; ++k) si[r][k] = Ri[(3 + k) * np + ii];
#pragma unroll
    for (int k = 0; k < kA; ++k) ai[r][k] = Ri[(3 + kF + k) * np + ii];
#pragma unroll
    for (int m = 0; m < kS; ++m) acc[r][m] = 0.0f;
  }

  const int n_tiles = j_hi > j_lo ? (j_hi - j_lo + kTileJ - 1) / kTileJ : 0;
  if (n_tiles > 0) stage<kRows>(tile[0], Cj, np, j_lo, j_hi);
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int j0 = j_lo + tt * kTileJ;
    if (tt + 1 < n_tiles) {
      stage<kRows>(tile[(tt + 1) & 1], Cj, np, j0 + kTileJ, j_hi);
      cp_async_wait<1>();  // tile tt has landed, tile tt + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*T)[kTileJ] = tile[tt & 1];
    const int jn = min(kTileJ, j_hi - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float xj = T[0][jj], yj = T[1][jj], zj = T[2][jj];
      float sj[kF + 1], bj[kA + 1];
#pragma unroll
      for (int k = 0; k < kF; ++k) sj[k] = T[3 + k][jj];
#pragma unroll
      for (int k = 0; k < kA; ++k) bj[k] = T[3 + kF + k][jj];
      const float ovx = T[kOv][jj], ovy = T[kOv + 1][jj],
                  ovz = T[kOv + 2][jj];
      const int j = j0 + jj;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = xi[r] - xj, dy = yi[r] - yj, dz = zi[r] - zj;
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        float dist = __fmul_rn(d2, rsqrtf(fmaxf(d2, 1e-12f)));
        if (j == i0 + r * kThreads) dist = kSentinel;
        float ch[kC + 1];
#pragma unroll
        for (int c = 0; c < kC; ++c) ch[c] = 0.0f;
#pragma unroll
        for (int k = 0; k < kA; ++k) ch[Coef::chan(k)] += ai[r][k] * bj[k];
        const float w = coef(dist, si[r], sj, ch);
        const float f = (L.friction && dist < 1.0f) ? 1.0f : 0.0f;
        float* a = acc[r];
        a[0] += w;
        a[1] += w * xj;
        a[2] += w * yj;
        a[3] += w * zj;
        a[4] += f;
        a[5] += f * ovx;
        a[6] += f * ovy;
        a[7] += f * ovz;
        coef.aux(dist, si[r], sj, ch, a + kPairSums);
      }
    }
    __syncthreads();  // tile tt consumed before it is refilled
  }

  float* dst = part + (long long)blockIdx.y * kS * np;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i < L.n_pad) {
#pragma unroll
      for (int m = 0; m < kS; ++m) dst[m * np + i] = acc[r][m];
    }
  }
}

// Sum over the S splits of part[s * stride] in a fixed order: four
// running sums over s mod 4, then (s0 + s1) + (s2 + s3), so that four
// loads are in flight at a time.
__device__ __forceinline__ float sum_splits(const float* __restrict__ p,
                                            int S, long long stride) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int s = 0;
  for (; s + 4 <= S; s += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] += p[(s + u) * stride];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (s + u < S) a[u] += p[(s + u) * stride];
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// out[o, i], each sum taken over the splits by sum_splits: o < 3 the force
// x_i * sum_w - sum_wx on axis o, the product and the difference rounded
// as the plain version rounds them; then sum_f, sum_v x y z and the aux
// channels (partial sum o + 1).
__global__ void __launch_bounds__(128)
central_reduce_kernel(const float* __restrict__ part, int S, int sums,
                      int n_pad, const float* __restrict__ Ri,
                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y;
  if (i >= n_pad) return;
  const long long stride = (long long)sums * n_pad;
  if (o < 3) {
    const float sw = sum_splits(part + i, S, stride);
    const float swx = sum_splits(part + (long long)(1 + o) * n_pad + i, S,
                                 stride);
    out[(long long)o * n_pad + i] =
        __fsub_rn(__fmul_rn(Ri[(long long)o * n_pad + i], sw), swx);
  } else {
    out[(long long)o * n_pad + i] =
        sum_splits(part + (long long)(o + 1) * n_pad + i, S, stride);
  }
}

__global__ void rsqrtf_kernel(const float* __restrict__ in,
                              float* __restrict__ out, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = rsqrtf(in[k]);
}

template <class Coef, int R>
int launch(const Coef& coef, const float* Ri, const float* Cj, int n,
           int n_pad, int nf, int n_ch, const int* arities, int friction,
           int rows, int S, int chunk, float* part, float* out,
           cudaStream_t stream) {
  if (n < 0 || n > n_pad || nf != Coef::kFields ||
      n_ch != Coef::kChannels || (friction != 0 && friction != 1) ||
      rows != R || S < 1 || chunk < 1 || (long long)S * chunk < n)
    return (int)cudaErrorInvalidValue;
  // the force's bilinear terms, channel by channel, as the functor's
  int na = 0;
  for (int c = 0; c < n_ch; ++c) {
    for (int k = 0; k < arities[c]; ++k, ++na) {
      if (na == Coef::kArity || Coef::chan(na) != c)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (na != Coef::kArity) return (int)cudaErrorInvalidValue;
  const Layout L{n, n_pad, friction, chunk};
  const int bx = (n_pad + kThreads * R - 1) / (kThreads * R);
  if (bx == 0) return (int)cudaGetLastError();
  central_pair_kernel<Coef, R><<<dim3(bx, S), kThreads, 0, stream>>>(
      coef, L, Ri, Cj, part);
  const int sums = kPairSums + Coef::kMaxAux;
  central_reduce_kernel<<<dim3((n_pad + 127) / 128, sums - 1), 128, 0,
                          stream>>>(part, S, sums, n_pad, Ri, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Ri, Cj: the columns above, [rows, n_pad] f32 on the device; nf, n_ch,
// arities (a host array of n_ch terms per channel): the force's, which
// must be the functor's; friction: 1 for dist < 1, 0 for none; params: a
// host array of the coefficient's parameters (r_max, r_min); rows, S,
// chunk: the plan of ops/tile_pallas.py::tile_plan (rows must be 4);
// part: [S, 8 + aux, n_pad] f32 scratch and out: [7 + aux, n_pad] f32,
// both on the device.
extern "C" int yalla_central_pair_sorting(
    const float* Ri, const float* Cj, int n, int n_pad, int nf, int n_ch,
    const int* arities, int friction, const float* params, int rows, int S,
    int chunk, float* part, float* out, cudaStream_t stream) {
  const SortingAdhesionCentral<0> coef{params[0], params[1]};
  return launch<SortingAdhesionCentral<0>, 4>(coef, Ri, Cj, n, n_pad, nf,
                                              n_ch, arities, friction, rows,
                                              S, chunk, part, out, stream);
}

// the same, with the neighbour count (dist < r_max) as aux channel ``nbs``
extern "C" int yalla_central_pair_sorting_nbs(
    const float* Ri, const float* Cj, int n, int n_pad, int nf, int n_ch,
    const int* arities, int friction, const float* params, int rows, int S,
    int chunk, float* part, float* out, cudaStream_t stream) {
  const SortingAdhesionCentral<1> coef{params[0], params[1]};
  return launch<SortingAdhesionCentral<1>, 4>(coef, Ri, Cj, n, n_pad, nf,
                                              n_ch, arities, friction, rows,
                                              S, chunk, part, out, stream);
}

// rsqrtf of n floats: the kernel's own reciprocal square root, for
// checking it against torch.rsqrt on the card
extern "C" int yalla_rsqrtf(const float* in, float* out, long long n,
                            cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    rsqrtf_kernel<<<(unsigned)blocks, threads, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}
