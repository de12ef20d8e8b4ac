// All-pairs pass for a central force (kernel K4): per-point sums over every
// pair, for a force of the form dF_xyz = w(dist, S_i, S_j, ch_ij) * r.
//
// Replaces yalla_tpu/ops/central_mxu.py::central_pairwise_mxu, which casts
// the reductions as f32 matmuls on the TPU's matrix unit.  What it
// computes, not its TPU layout: for every row i, over every j < n,
//   sum_w = sum_j w_ij,  sum_wx = sum_j w_ij x_j  (and y, z),
//   sum_f = sum_j f_ij,  sum_v  = sum_j f_ij old_v_j,
// and writes F = x_i * sum_w - sum_wx per axis, then sum_f and sum_v x y z
// (the output rows of central_mxu.py:250-253).  w is the force's radial
// coefficient, a device functor below; f the friction's coefficient
// (friction_w_neighbour: dist < 1; friction_on_background: 0).  The i == j
// diagonal is excluded by poisoning its distance with the sentinel 1e4, and
// the wrapper has moved padding rows to the sentinel (central_mxu.py:
// 180-186, 224-232); padding columns j >= n contribute exact zeros by the
// coefficient contract (0 past the cutoff), so the loop stops at n.  Scalar
// fields S and the bilinear channels ch_c = sum_k a_k(X_i) b_k(X_j) come in
// as columns the wrapper built in torch; the kernel takes their counts as
// ints, up to the maxima the coefficient functor declares (kMaxFields
// fields, kMaxArity bilinear terms in kMaxChannels channels), which bound
// its unrolled loops and its tile.
//
// Design: one thread per i, 128 to a block, j staged in tiles of 128 points
// (x y z, the scalar fields, the b_k, old_v x y z) in shared memory with
// coalesced loads; every thread reads the same j (a broadcast) and keeps
// its 8 sums in registers.  The TPU needed the matmul form to reduce on
// its matrix unit; on Hopper the same reduction is plain f32 FMAs in
// registers.  No tensor cores: TF32 would break the f32 tolerances the
// tests hold the path to.
//
// Bound: the pair arithmetic, issued by too few threads.  At the 5k sorting
// configuration (n_pad 5120) there are 26M pairs at about 30 operations,
// which the card's 132 SMs could issue in some 25 us; but 5120 threads make
// 40 blocks, so 92 SMs idle and every warp runs 5000 dependent iterations
// with little to hide their latency.  Splitting j across blocks is later
// work.  The loops over fields and bilinear terms run to the functor's
// maxima, not to fixed ones: guarded loops to 4 fields and 8 terms in 4
// channels cost more per pair than the force itself.
//
// Numerics: dist = d2 * rsqrt(max(d2, 1e-12)), as JAX computes it
// (central_mxu.py:227-229), with d2's products and sums rounded one by one
// (no FMA contraction) in torch's order and rsqrtf, which torch.rsqrt on a
// CUDA tensor also uses; so the gates (dist < r_max, dist < 1) decide as
// the plain version's do on the card, and sum_f agrees exactly.
// chip_smoke.py checks rsqrtf against torch.rsqrt over every pair of the
// settled 5k state (yalla_rsqrtf below).  The coefficient may contract into
// FMAs; F and sum_v agree with the plain version to f32 rounding and
// summation order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // i per block, and the width of a j tile
constexpr int kLayoutArity = 8;    // bilinear terms a Layout can describe
constexpr float kSentinel = 1e4f;  // CENTRAL_SENTINEL

struct Layout {
  int n, n_pad;
  int nf, na;                    // scalar fields; bilinear terms in all
  int chan_of[kLayoutArity];     // the channel of each bilinear term
  int friction;                  // 1: dist < 1; 0: no neighbour friction
};

// yalla_tpu_torch/models/sorting.py::make_adhesion_central (bench.py:
// 764-768): strength (channel 0) * a * (a + 2 (r_min - dist)) / dist with
// a = max(r_max - dist, 0), zero past r_max and finite at the sentinel.
struct SortingAdhesionCentral {
  static constexpr int kMaxFields = 0, kMaxArity = 2, kMaxChannels = 1;
  float r_max, r_min;

  __device__ float operator()(float dist, const float*, const float*,
                              const float* ch) const {
    const float a = fmaxf(r_max - dist, 0.0f);
    const float b = a + 2.0f * (r_min - dist);
    const float rs = rsqrtf(fmaxf(dist * dist, 1e-12f));
    return ch[0] * (a * b) * rs;
  }
};

// Ri: [3 + nf + na, n_pad] rows x y z, S, a_k (padding at the sentinel);
// Cj: [3 + nf + na + 3, n_pad] rows x y z, S, b_k, old_v x y z;
// out: [7, n_pad] rows Fx Fy Fz sum_f sum_vx sum_vy sum_vz.
template <class Coef>
__global__ void __launch_bounds__(kThreads)
central_pair_kernel(const Coef coef, const Layout L,
                    const float* __restrict__ Ri,
                    const float* __restrict__ Cj, float* __restrict__ out) {
  constexpr int kMaxFields = Coef::kMaxFields;
  constexpr int kMaxArity = Coef::kMaxArity;
  constexpr int kMaxChannels = Coef::kMaxChannels;
  static_assert(kMaxArity <= kLayoutArity, "a Layout holds the terms");
  __shared__ float tile[3 + kMaxFields + kMaxArity + 3][kThreads];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  const long long np = L.n_pad;
  const int ii = i < L.n_pad ? i : 0;
  const float xi = Ri[ii], yi = Ri[np + ii], zi = Ri[2 * np + ii];
  // (+1: no zero-length arrays)
  float si[kMaxFields + 1], ai[kMaxArity + 1];
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k)
    si[k] = k < L.nf ? Ri[(3 + k) * np + ii] : 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxArity; ++k)
    ai[k] = k < L.na ? Ri[(3 + L.nf + k) * np + ii] : 0.0f;

  const int rows = 3 + L.nf + L.na + 3;
  const int ov = 3 + L.nf + L.na;
  float sw = 0.0f, swx = 0.0f, swy = 0.0f, swz = 0.0f;
  float sf = 0.0f, svx = 0.0f, svy = 0.0f, svz = 0.0f;
  for (int j0 = 0; j0 < L.n; j0 += kThreads) {
    __syncthreads();  // the previous tile is consumed
    const int jl = j0 + t;
    for (int r = 0; r < rows; ++r)
      tile[r][t] = jl < L.n ? Cj[r * np + jl] : 0.0f;
    __syncthreads();
    const int jn = min(kThreads, L.n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float xj = tile[0][jj], yj = tile[1][jj], zj = tile[2][jj];
      const float dx = xi - xj, dy = yi - yj, dz = zi - zj;
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      float dist = __fmul_rn(d2, rsqrtf(fmaxf(d2, 1e-12f)));
      if (j0 + jj == i) dist = kSentinel;
      float sj[kMaxFields + 1], ch[kMaxChannels + 1];
#pragma unroll
      for (int k = 0; k < kMaxFields; ++k)
        sj[k] = k < L.nf ? tile[3 + k][jj] : 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) ch[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxArity; ++k) {
        if (k < L.na) {
          const float p = ai[k] * tile[3 + L.nf + k][jj];
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (L.chan_of[k] == c) ch[c] += p;
        }
      }
      const float w = coef(dist, si, sj, ch);
      const float f = (L.friction && dist < 1.0f) ? 1.0f : 0.0f;
      sw += w;
      swx += w * xj;
      swy += w * yj;
      swz += w * zj;
      sf += f;
      svx += f * tile[ov][jj];
      svy += f * tile[ov + 1][jj];
      svz += f * tile[ov + 2][jj];
    }
  }
  if (i < L.n_pad) {
    // x_i * sum_w - sum_wx, each rounded as the plain version rounds it
    out[i] = __fsub_rn(__fmul_rn(xi, sw), swx);
    out[np + i] = __fsub_rn(__fmul_rn(yi, sw), swy);
    out[2 * np + i] = __fsub_rn(__fmul_rn(zi, sw), swz);
    out[3 * np + i] = sf;
    out[4 * np + i] = svx;
    out[5 * np + i] = svy;
    out[6 * np + i] = svz;
  }
}

__global__ void rsqrtf_kernel(const float* __restrict__ in,
                              float* __restrict__ out, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = rsqrtf(in[k]);
}

template <class Coef>
int launch(const Coef& coef, const float* Ri, const float* Cj, int n,
           int n_pad, int nf, int n_ch, const int* arities, int friction,
           float* out, cudaStream_t stream) {
  Layout L{};
  L.n = n;
  L.n_pad = n_pad;
  L.nf = nf;
  L.friction = friction;
  if (n < 0 || n > n_pad || nf < 0 || nf > Coef::kMaxFields || n_ch < 0 ||
      n_ch > Coef::kMaxChannels)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_ch; ++c) {
    for (int k = 0; k < arities[c]; ++k) {
      if (L.na == Coef::kMaxArity) return (int)cudaErrorInvalidValue;
      L.chan_of[L.na++] = c;
    }
  }
  const int blocks = (n_pad + kThreads - 1) / kThreads;
  if (blocks > 0)
    central_pair_kernel<<<blocks, kThreads, 0, stream>>>(coef, L, Ri, Cj,
                                                         out);
  return (int)cudaGetLastError();
}

}  // namespace

// arities: host array of n_ch bilinear arities (terms per channel);
// params: host array of the coefficient's parameters (r_max, r_min).
extern "C" int yalla_central_pair_sorting(const float* Ri, const float* Cj,
                                          int n, int n_pad, int nf, int n_ch,
                                          const int* arities, int friction,
                                          const float* params, float* out,
                                          cudaStream_t stream) {
  const SortingAdhesionCentral coef{params[0], params[1]};
  return launch(coef, Ri, Cj, n, n_pad, nf, n_ch, arities, friction, out,
                stream);
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
