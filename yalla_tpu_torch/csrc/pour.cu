// Pour: cube-sorted channels -> dense lattice slots (kernel K2).
//
// Replaces yalla_tpu/ops/lattice_pour.py::pour_pallas, a butterfly routing
// network that exists only because scatters are slow on the TPU.  On Hopper
// the contract is a direct placement: thread t takes sorted entry t and, if
// its target slot S[K-1][t] is a valid slot id, writes the K-1 channels and
// live = 1 there.  The map entry -> slot is injective, so there are no
// write conflicts and no atomics.
//
// Bound: device-memory bandwidth.  Per build it reads K x n_pad floats
// (coalesced) and writes (K-1) x n_placed floats (scattered, but runs of
// one cube's ranks land in neighbouring slots); at 500k cells and K = 13
// that is a few tens of MB.  The wrapper zero-fills the outputs; the kernel
// allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

namespace {

__global__ void pour_kernel(const float* __restrict__ S, int K,
                            long long n_pad, long long n_slots,
                            float* __restrict__ out,
                            float* __restrict__ live) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pad) return;
  const float d = S[(long long)(K - 1) * n_pad + t];
  // drop entries carry a sentinel target >= n_slots (exact in f32: the
  // wrapper requires n_slots < 2^24)
  if (!(d >= 0.0f && d < (float)n_slots)) return;
  const long long slot = (long long)d;
  for (int k = 0; k < K - 1; ++k)
    out[(long long)k * n_slots + slot] = S[(long long)k * n_pad + t];
  live[slot] = 1.0f;
}

}  // namespace

extern "C" int yalla_pour(const float* S, int K, long long n_pad,
                          long long n_slots, float* out, float* live,
                          cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n_pad + threads - 1) / threads;
  if (blocks > 0)
    pour_kernel<<<(unsigned)blocks, threads, 0, stream>>>(S, K, n_pad,
                                                          n_slots, out, live);
  return (int)cudaGetLastError();
}

extern "C" const char* yalla_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
