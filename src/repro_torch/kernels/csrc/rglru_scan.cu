// RG-LRU diagonal linear recurrence, float32, one thread per (batch, column).
//
// Replaces the Pallas kernel _rglru_kernel of src/repro/kernels/rglru_scan.py.
// Per (b, w):
//
//     h_t = a_t * h_{t-1} + x_t,   t = 0 .. T-1,   h_{-1} = h0
//
// The Pallas kernel tiles width into VPU lanes and walks time in chunks on a
// sequential grid axis, with h in VMEM scratch between chunks (so a chunk
// must divide T). Here each thread owns one column and walks the whole time
// axis with h in a register: no state leaves the SM, no barrier is needed,
// and any T >= 1 and any W work. Consecutive threads take consecutive w, so
// every load of a_t, x_t and store of h_t is coalesced.
//
// What bounds it on an H100: bytes (a, x read once, h written once, h0 and
// h_T: 201.6 MB, 60.2 us at (8, 512, 4096)); the arithmetic is one multiply
// and one add per element. a and x do not depend on h, so each thread loads
// STEPS time steps into registers before it runs their dependent chain,
// keeping 2 * STEPS loads in flight per thread. With few columns (B = 1:
// 4096 threads) that is too little memory parallelism to reach the bound; a
// chunked two-pass scan (chunk products, then a carry pass) is later work.
//
// Built with -fmad=false: a * h + x rounds the product and then the sum,
// as the plain PyTorch version computes it, so the two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int STEPS = 8;

__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
                 const float* __restrict__ h0, float* __restrict__ h_out,
                 float* __restrict__ h_fin, long long T, long long W) {
  const long long w = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  const long long base = b * T * W + w;
  float h = h0[b * W + w];
  long long t = 0;
  for (; t + STEPS <= T; t += STEPS) {
    float av[STEPS], xv[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      av[i] = a[base + (t + i) * W];
      xv[i] = x[base + (t + i) * W];
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      h = av[i] * h + xv[i];
      h_out[base + (t + i) * W] = h;
    }
  }
  for (; t < T; ++t) {
    h = a[base + t * W] * h + x[base + t * W];
    h_out[base + t * W] = h;
  }
  h_fin[b * W + w] = h;
}

}  // namespace

// a, x, h_out (B, T, W); h0, h_fin (B, W); all float32, contiguous, on the
// current device; T >= 1. Returns the launch's cudaError_t.
extern "C" int rglru_f32(const void* a, const void* x, const void* h0,
                         void* h_out, void* h_fin, long long B, long long T,
                         long long W, void* stream) {
  if (B * W == 0) return (int)cudaSuccess;
  const long long blocks_w = (W + THREADS - 1) / THREADS;
  if (T < 1 || B > 65535 || blocks_w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks_w, (unsigned)B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h_out),
      static_cast<float*>(h_fin), T, W);
  return (int)cudaGetLastError();
}
