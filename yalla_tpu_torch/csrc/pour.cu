// Pour: cube-sorted channels -> dense lattice slots (kernel K2).
//
// Replaces yalla_tpu/ops/lattice_pour.py::pour_pallas.  Its contract: S is
// a [K, n_pad] stack sorted by cube id whose last row is each entry's
// target slot (cid * C + rank, or a sentinel >= n_slots for entries that
// must not be placed), and row_starts[r] is the first sorted position of
// the (z, y) row r of gx cubes (W = gx * C slots), row_starts[n_rows] the
// end of the last row.  Outputs: out[K-1, n_slots] with each placed
// entry's K-1 channels at its slot and +0.0 elsewhere, live[n_slots] 1.0
// where an entry was placed and 0.0 elsewhere, and n_unrouted, the count of
// entries with a valid target that could not be placed (their slot lies
// outside the row whose window holds them, or they lie in no window).
//
// Bound: device-memory bandwidth.  The outputs are dense, (K-1) x n_slots
// floats, almost all of them zeros: at 500k cells, K = 13 and 2,097,152
// slots that is 109 MB written against 26 MB of S read.  The first
// version placed one entry per thread and left the zeros to two fills
// beforehand, so every output byte was written twice and its scattered
// stores used about a quarter of each 32-byte sector.
//
// Design for Hopper, slot-major as the TPU kernel is: one block owns
// `rows_per_block` whole rows, so its slots are one contiguous range and
// its entries the window [row_starts[r0], row_starts[r1]).
// * Phase 1 reads the window's targets (coalesced) and records, for each
//   of its slots, the window position placed there in a shared-memory map
//   (-1 where none): the map is kMapSlots ints; a block whose range is
//   wider (one row of more slots) walks it in chunks, reading its window
//   again for each.  An entry is placed only if its slot lies in the row
//   whose window holds it; any other entry with a valid target is counted.
// * Phase 2 writes every slot of the range once, value or zero, for all
//   K-1 channels and live: float4 stores, four neighbouring slots a
//   thread, wherever the rows of out are 16-byte aligned (n_slots % 4 ==
//   0), with scalar stores for the unaligned ends; a slot's value is
//   gathered from S through the map.  The window's entries are
//   contiguous, so these gathers read each of S's sectors about once.
// * The first block also counts placed targets before row_starts[0], the
//   last those from row_starts[n_rows] on: entries in no window.  A block
//   that counts any adds its count to n_unrouted (an integer atomic, exact
//   in any order), which the entry point zeroes first.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMapSlots = 4096;  // slots one pass of a block maps

struct Pour {
  const float* S;
  int K, n_pad;
  const int* row_starts;
  int n_rows, W, rows_per_block;
  long long n_slots;
  float* out;
  float* live;
};

__device__ __forceinline__ bool valid(const Pour& p, float d) {
  // exact in f32: the wrapper requires n_slots < 2^24
  return d >= 0.0f && d < (float)p.n_slots;
}

__device__ __forceinline__ int clamp_pos(const Pour& p, int t) {
  return min(max(t, 0), p.n_pad);
}

// slot g of a block whose map starts at slot c0: all channels and live
__device__ __forceinline__ void write1(const Pour& p, const int* map,
                                       long long c0, long long g) {
  const int m = map[g - c0];
  for (int k = 0; k < p.K - 1; ++k)
    p.out[(long long)k * p.n_slots + g] =
        m >= 0 ? __ldg(p.S + (long long)k * p.n_pad + m) : 0.0f;
  p.live[g] = m >= 0 ? 1.0f : 0.0f;
}

// a 16-byte store
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// slots g .. g+3, g a multiple of 4 and n_slots too (16-byte aligned rows)
__device__ __forceinline__ void write4(const Pour& p, const int* map,
                                       long long c0, long long g) {
  const int m0 = map[g - c0], m1 = map[g - c0 + 1], m2 = map[g - c0 + 2],
            m3 = map[g - c0 + 3];
  for (int k = 0; k < p.K - 1; ++k) {
    const float* s = p.S + (long long)k * p.n_pad;
    float4 v;
    v.x = m0 >= 0 ? __ldg(s + m0) : 0.0f;
    v.y = m1 >= 0 ? __ldg(s + m1) : 0.0f;
    v.z = m2 >= 0 ? __ldg(s + m2) : 0.0f;
    v.w = m3 >= 0 ? __ldg(s + m3) : 0.0f;
    store4(p.out + (long long)k * p.n_slots + g, v);
  }
  store4(p.live + g, make_float4(m0 >= 0 ? 1.0f : 0.0f, m1 >= 0 ? 1.0f : 0.0f,
                                 m2 >= 0 ? 1.0f : 0.0f,
                                 m3 >= 0 ? 1.0f : 0.0f));
}

__global__ void __launch_bounds__(kThreads)
pour_kernel(const Pour p, unsigned long long* __restrict__ unrouted) {
  __shared__ int map[kMapSlots];
  __shared__ int warp_bad[kThreads / 32];
  const int r0 = blockIdx.x * p.rows_per_block;
  const int r1 = min(p.n_rows, r0 + p.rows_per_block);
  const long long slot0 = (long long)r0 * p.W, slot1 = (long long)r1 * p.W;
  const int w0 = clamp_pos(p, p.row_starts[r0]);
  const int w1 = clamp_pos(p, p.row_starts[r1]);
  const float* dst = p.S + (long long)(p.K - 1) * p.n_pad;
  int bad = 0;
  // entries in no window
  if (r0 == 0)
    for (int t = threadIdx.x; t < w0; t += kThreads) bad += valid(p, dst[t]);
  if (r1 == p.n_rows)
    for (int t = w1 + threadIdx.x; t < p.n_pad; t += kThreads)
      bad += valid(p, dst[t]);

  const bool vec = p.n_slots % 4 == 0;
  for (long long c0 = slot0; c0 < slot1; c0 += kMapSlots) {
    const long long c1 = min(slot1, c0 + kMapSlots);
    for (int s = threadIdx.x; s < c1 - c0; s += kThreads) map[s] = -1;
    __syncthreads();
    for (int t = w0 + threadIdx.x; t < w1; t += kThreads) {
      const float d = dst[t];
      if (!valid(p, d)) continue;
      const long long slot = (long long)d;
      const int r = (int)(slot / p.W);
      const bool routed = r >= r0 && r < r1 && p.row_starts[r] <= t &&
                          t < p.row_starts[r + 1];
      if (!routed)
        bad += c0 == slot0;  // counted in the first chunk only
      else if (slot >= c0 && slot < c1)
        map[slot - c0] = t;
    }
    __syncthreads();
    // aligned body [a0, a1) in float4, the ends slot by slot
    long long a0 = c1, a1 = c1;
    if (vec) {
      a0 = min(c1, (c0 + 3) & ~3LL);
      a1 = max(a0, c1 & ~3LL);
    }
    for (long long g = c0 + threadIdx.x; g < a0; g += kThreads)
      write1(p, map, c0, g);
    for (long long g = a0 + 4 * threadIdx.x; g < a1; g += 4 * kThreads)
      write4(p, map, c0, g);
    for (long long g = a1 + threadIdx.x; g < c1; g += kThreads)
      write1(p, map, c0, g);
    __syncthreads();  // the map is consumed before the next chunk
  }

  for (int o = 16; o > 0; o >>= 1)
    bad += __shfl_down_sync(0xffffffffu, bad, o);
  if (threadIdx.x % 32 == 0) warp_bad[threadIdx.x / 32] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_bad[w];
    if (total) atomicAdd(unrouted, (unsigned long long)total);
  }
}

}  // namespace

// S: [K, n_pad] f32; row_starts: [n_rows + 1] i32; rows_per_block and the
// block count from ops/lattice_pour.py::pour_plan; out: [K-1, n_rows * W]
// f32, live: [n_rows * W] f32, n_unrouted: one int64, all on the device
// and written in full.
extern "C" int yalla_pour(const float* S, int K, int n_pad,
                          const int* row_starts, int n_rows, int W,
                          int rows_per_block, int blocks, float* out,
                          float* live, long long* n_unrouted,
                          cudaStream_t stream) {
  if (K < 2 || n_pad < 0 || n_rows < 1 || W < 1 || rows_per_block < 1 ||
      blocks != (n_rows + rows_per_block - 1) / rows_per_block ||
      (long long)n_rows * W >= (1LL << 24))
    return (int)cudaErrorInvalidValue;
  const Pour p{S, K, n_pad, row_starts, n_rows, W, rows_per_block,
               (long long)n_rows * W, out, live};
  const cudaError_t err =
      cudaMemsetAsync(n_unrouted, 0, sizeof(long long), stream);
  if (err != cudaSuccess) return (int)err;
  pour_kernel<<<blocks, kThreads, 0, stream>>>(
      p, reinterpret_cast<unsigned long long*>(n_unrouted));
  return (int)cudaGetLastError();
}

extern "C" const char* yalla_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
