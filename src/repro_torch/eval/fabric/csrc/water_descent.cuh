// The water level's 32-way descent, float64, one warp a row: shared by the
// loop kernel's water_level (fused_step.cu) and the water-fill kernel
// (waterfill.cu). The build hashes each source together with the .cuh
// headers beside it, so an edit here rebuilds both.
//
// The level is kIters halvings of [0, hi], keeping
// sum(min(caps, hi)) >= pool_eff; it is the last hi. For a row of
// C <= CW <= 32 columns (CW a power of two) the halvings run as
// kIters / kLevels rounds of a 32-way descent of the same bisection tree.
// Lane l evaluates node l + 1 (heap order: node n has children 2n and
// 2n + 1) of the round's five levels: it walks to the node with the same
// 0.5 * (lo + hi) halvings the one-at-a-time chain would take, so its mid is
// bit-identical, and sums min(cap, mid) over the row's caps in the
// butterfly's own pairing (fold; the butterfly's levels above CW add only
// zeros), so the sum is the chain's warp-wide butterfly sum bit for bit. A
// ballot of `sum < pool_eff` picks the path, and two shuffles hand the
// round's bracket to every lane. waterfill_descent_plain in
// eval/fabric/kernels/waterfill_bisect.py is its plain mirror.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace water {

constexpr int kIters = 80;  // halvings of the water level
constexpr int kLevels = 5;  // halvings a round of the 32-way descent
constexpr unsigned kFull = 0xffffffffu;

// s[0] = the sum of s[0..N) in the butterfly's pairing: s[i] += s[i + O]
// for O = N / 2 .. 1 (template recursion keeps every index a constant, so
// s stays in registers).
template <int N, int O = N / 2>
__device__ __forceinline__ void fold(double (&s)[N]) {
  if constexpr (O > 0) {
#pragma unroll
    for (int i = 0; i < O; ++i) s[i] += s[i + O];
    fold<N, O / 2>(s);
  }
}

// The water level of the row whose caps every lane holds in cv (columns
// past C hold 0), from [0, hi].
template <int CW>
__device__ __forceinline__ double descend(const double (&cv)[CW], double hi, double pool_eff,
                                          int lane) {
  const int node = lane + 1;
  const int depth = 31 - __clz(node);
  double lo = 0.0;
  for (int r = 0; r < kIters / kLevels; ++r) {
    // four predicated levels on every lane: a loop to each lane's own depth
    // diverges, and measured slower on an H100
    double l = lo, h = hi;
#pragma unroll
    for (int d = kLevels - 2; d >= 0; --d) {
      const double m = 0.5 * (l + h);
      const bool on = d < depth;
      const bool right = (node >> d) & 1;
      l = on && right ? m : l;
      h = on && !right ? m : h;
    }
    const double mid = 0.5 * (l + h);
    double s[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) s[i] = fmin(cv[i], mid);
    fold<CW>(s);
    const unsigned low = __ballot_sync(kFull, s[0] < pool_eff);
    int n = 1;  // the path's node, down to the round's last level
#pragma unroll
    for (int d = 1; d < kLevels; ++d) n = 2 * n + (int)((low >> (n - 1)) & 1u);
    const bool up = (low >> (n - 1)) & 1u;
    lo = __shfl_sync(kFull, up ? mid : l, n - 1);
    hi = __shfl_sync(kFull, up ? h : mid, n - 1);
  }
  return hi;
}

}  // namespace water
