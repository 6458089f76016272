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
// writes C) but the chain of 80 dependent halvings, i.e. latency. Done one
// at a time (a float64 min per lane, a five-step shuffle butterfly of
// doubles and a branch, ~150-200 cycles each) the chain took 11.69 us at
// S = 1024, C = 16.
//
// Rows of C <= 32 (the sweep's bucketed widths) run the halvings as 16
// rounds of a 32-way descent of the same bisection tree, the loop kernel's
// water level (water_descent.cuh, shared with fused_step.cu). The row's
// caps go once through a warp-private shared slot into every lane's
// registers (CW of them, the row's width rounded up to a power of two);
// lane l evaluates node l + 1 of a round's five levels with the chain's own
// mids and sums, and a ballot picks the path. The output equals the halving
// chain's bit for bit (waterfill_descent_plain in waterfill_bisect.py is its
// plain mirror). A round is ~14 dependent float64 operations plus a ballot
// and two shuffles, against five halvings of the chain. ptxas: the descent
// takes 32 to 103 registers (1 to 32 columns; 67 at 16), no spills.
//
// Measured on an H100, the descent's time grows with the row's width (its
// CW minimums and fold adds a round, on every lane): 5.3 / 7.0 / 10.2 us at
// S = 1024 and C = 8 / 16 / 32, against the 2.5-4 us a round's latency
// alone predicts at 16. Taking the row's total and maximum from the
// registers instead of two butterflies, and finding the round's path by a
// second ballot of the leaves on it, were both slower.
//
// Wider rows (up to C = 1024, tiles of 32 lanes, T = C/32 rounded up to a
// power of two, held in registers) keep the halving chain; the wrapper
// refuses larger C. Rows run on independent warps, four to a block.
#include <cuda_runtime.h>
#include <math.h>

#include "water_descent.cuh"

namespace {

using water::kFull;
using water::kIters;  // halvings of the water level
constexpr int kWarpsPerBlock = 4;

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

// Rows of C <= CW <= 32 (CW a power of two): the 32-way descent.
template <int CW>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    waterfill_descent_kernel(const double* __restrict__ caps, const double* __restrict__ pool,
                             double* __restrict__ out, long long S, int C) {
  __shared__ double slot[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= S) return;  // uniform across the warp
  const double cap = lane < C ? caps[row * C + lane] : 0.0;
  double hi = warp_max(fmax(cap, 0.0));
  const double pool_eff = fmax(fmin(pool[row], warp_sum(cap)), 0.0);
  slot[warp][lane] = cap;
  __syncwarp();
  double cv[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) cv[i] = slot[warp][i];
  hi = water::descend<CW>(cv, hi, pool_eff, lane);
  if (lane < C) out[row * C + lane] = fmin(cap, hi);
}

// Rows of C > 32: the halving chain, T tiles of 32 lanes in registers.
template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    waterfill_chain_kernel(const double* __restrict__ caps, const double* __restrict__ pool,
                           double* __restrict__ out, long long S, int C) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
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

unsigned blocks(long long S) { return (unsigned)((S + kWarpsPerBlock - 1) / kWarpsPerBlock); }

template <int CW>
cudaError_t descent(const double* caps, const double* pool, double* out, long long S, int C,
                    cudaStream_t stream) {
  waterfill_descent_kernel<CW><<<blocks(S), 32 * kWarpsPerBlock, 0, stream>>>(caps, pool, out,
                                                                             S, C);
  return cudaGetLastError();
}

template <int T>
cudaError_t chain(const double* caps, const double* pool, double* out, long long S, int C,
                  cudaStream_t stream) {
  waterfill_chain_kernel<T><<<blocks(S), 32 * kWarpsPerBlock, 0, stream>>>(caps, pool, out, S,
                                                                          C);
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
  if (C <= 1) return (int)descent<1>(c, p, o, S, Ci, st);
  if (C <= 2) return (int)descent<2>(c, p, o, S, Ci, st);
  if (C <= 4) return (int)descent<4>(c, p, o, S, Ci, st);
  if (C <= 8) return (int)descent<8>(c, p, o, S, Ci, st);
  if (C <= 16) return (int)descent<16>(c, p, o, S, Ci, st);
  if (C <= 32) return (int)descent<32>(c, p, o, S, Ci, st);
  const long long tiles = (C + 31) / 32;
  if (tiles <= 2) return (int)chain<2>(c, p, o, S, Ci, st);
  if (tiles <= 4) return (int)chain<4>(c, p, o, S, Ci, st);
  if (tiles <= 8) return (int)chain<8>(c, p, o, S, Ci, st);
  if (tiles <= 16) return (int)chain<16>(c, p, o, S, Ci, st);
  if (tiles <= 32) return (int)chain<32>(c, p, o, S, Ci, st);
  return (int)cudaErrorInvalidValue;
}
