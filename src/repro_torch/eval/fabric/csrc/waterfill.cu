// Bisected max-min water-fill, float64, one warp per scenario row.
//
// Replaces the Pallas kernel _waterfill_kernel of
// src/repro/eval/fabric/kernels/waterfill_pallas.py: for each row of caps
// (S, C) and pool (S,), 80 halvings of the water level lam from
// hi = max(caps), keeping sum_i min(cap_i, hi) >= min(pool, sum_i cap_i);
// the output is min(cap_i, hi), so every allocation respects its cap and
// the row total matches the pool to float64 resolution.
//
// What bounds it on an H100: not bytes (a row reads C + 1 doubles and
// writes C) but the 80 dependent iterations of a row sum, each a float64
// min per lane plus a five-step warp shuffle reduction, i.e. latency.
// The design keeps the row's caps in registers for the whole loop (one
// load, one store per element), lets the 32 lanes of a warp stride over
// the channel axis (the bucketed C is 4..32, one tile) and reduces with
// __shfl_xor_sync, so no shared memory and no block-level barrier sits
// inside the loop; rows run on independent warps, four to a block.
// Any C up to 1024 is handled (tiles of 32 lanes, T = C/32 rounded up to
// a power of two, held in registers); the wrapper refuses larger C.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kIters = 80;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int T>
__global__ void waterfill_kernel(const double* __restrict__ caps,
                                 const double* __restrict__ pool,
                                 double* __restrict__ out, long long S,
                                 int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= S) return;  // uniform across the warp
  const double* c_row = caps + row * C;
  double cap[T];
  double total = 0.0, hi = 0.0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    cap[t] = col < C ? c_row[col] : 0.0;
    total += cap[t];
    hi = fmax(hi, cap[t]);
  }
  total = warp_sum(total);
  hi = warp_max(hi);
  const double pool_eff = fmax(fmin(pool[row], total), 0.0);
  double lo = 0.0;
  for (int it = 0; it < kIters; ++it) {
    const double mid = 0.5 * (lo + hi);
    double filled = 0.0;
#pragma unroll
    for (int t = 0; t < T; ++t) filled += fmin(cap[t], mid);
    filled = warp_sum(filled);
    if (filled < pool_eff) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  double* o_row = out + row * C;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    if (col < C) o_row[col] = fmin(cap[t], hi);
  }
}

template <int T>
cudaError_t launch(const double* caps, const double* pool, double* out,
                   long long S, int C, cudaStream_t stream) {
  const long long blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  waterfill_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      caps, pool, out, S, C);
  return cudaGetLastError();
}

}  // namespace

// caps (S, C) float64, pool (S,) float64, out (S, C) float64, all
// contiguous on the current device. Returns the launch's cudaError_t.
extern "C" int waterfill_f64(const void* caps, const void* pool, void* out,
                             long long S, long long C, void* stream) {
  if (S <= 0 || C <= 0) return (int)cudaSuccess;
  const double* c = static_cast<const double*>(caps);
  const double* p = static_cast<const double*>(pool);
  double* o = static_cast<double*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ci = (int)C;
  const long long tiles = (C + 31) / 32;
  if (tiles <= 1) return (int)launch<1>(c, p, o, S, Ci, st);
  if (tiles <= 2) return (int)launch<2>(c, p, o, S, Ci, st);
  if (tiles <= 4) return (int)launch<4>(c, p, o, S, Ci, st);
  if (tiles <= 8) return (int)launch<8>(c, p, o, S, Ci, st);
  if (tiles <= 16) return (int)launch<16>(c, p, o, S, Ci, st);
  if (tiles <= 32) return (int)launch<32>(c, p, o, S, Ci, st);
  return (int)cudaErrorInvalidValue;
}
