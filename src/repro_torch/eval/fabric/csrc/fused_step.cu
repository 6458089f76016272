// Fused resume-free sweep step, float64, one warp per scenario row.
//
// Replaces the Pallas kernel _fused_kernel of
// src/repro/eval/fabric/kernels/fused_step_pallas.py. Per row:
//   1. disk_pool: n_t transferring channels (busy, dead time burned),
//      pool = min(bw, disk / (1 + contention * max(0, n_t - sat))), 0 if
//      nothing transfers;
//   2. water-fill over the transferring caps by 80 halvings of the level
//      from hi = max(caps) (as waterfill.cu);
//   3. event_horizon: dt = min(tick_dt, dead-time ends, rem / rate),
//      floored at 0; inactive rows get dt = 0 and pass through unchanged;
//   4. advance_channels: burn dead time, move min(rem, rate * dt) bytes,
//      finish files whose remainder drops to <= 1e-12;
//   5. the pure-FIFO feed: an idle open channel's rank is the count of
//      idle channels of the same chunk at a lower column index; it takes
//      qsizes[qoff + qptr + rank] while qptr + rank < qlen, and pays the
//      chunk's per-file dead time. qptr and queue_bytes advance per chunk.
// Outputs dt, rate_sum (S,), fin_any (S,), busy, dead, rem, moved (S, C),
// qptr (S, K), queue_bytes (S, K). bool tensors are 1 byte, int64 stays
// int64.
//
// What bounds it on an H100: latency, not bytes. A row moves ~40 bytes
// per channel and ~50 per chunk, but the 80 dependent bisection steps
// (each a warp-wide float64 sum) and the per-chunk reductions of the feed
// dominate. The design gives each row one warp and keeps its channels in
// registers from the first load to the last store (lanes stride over C,
// the bucketed C is 4..32, one tile); reductions are __shfl_xor_sync
// butterflies, the feed rank of a column within its tile is one
// __match_any_sync plus a popcount, and only the running per-chunk idle
// counts across tiles sit in shared memory (K ints per warp), so the one
// launch replaces the split path's ~40 PyTorch operations and their
// intermediate tensors. Any C up to 1024 and K up to 1024 is handled; the
// wrapper refuses larger shapes.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kIters = 80;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps = 1e-12;

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

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Args {
  const bool* act;
  const bool* busy;
  const double* dead;
  const double* rem;
  const double* cap;
  const long long* chunk_of;
  const double* tick_dt;
  const double* bw;
  const double* disk_rate;
  const long long* sat_cc;
  const double* contention;
  const long long* qoff;
  const long long* qlen;
  const long long* qptr;
  const double* queue_bytes;
  const double* fsdt;
  const double* qsizes;
  double* dt_out;
  double* rate_sum_out;
  bool* fin_out;
  bool* busy_out;
  double* dead_out;
  double* rem_out;
  double* moved_out;
  long long* qptr_out;
  double* qb_out;
  long long S;
  int C;
  int K;
  long long Q;
};

template <int T>
__global__ void fused_step_kernel(Args a) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= a.S) return;  // uniform across the warp
  const int C = a.C, K = a.K;
  const long long rc = row * C, rk = row * K;
  const bool enabled = a.act[row];

  bool busy[T], tr[T];
  double dead[T], rem[T], caps[T];
  int ch[T];
  long long n_t = 0;
  double total = 0.0, hi = 0.0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    const bool in = col < C;
    busy[t] = in && a.busy[rc + col];
    dead[t] = in ? a.dead[rc + col] : 0.0;
    rem[t] = in ? a.rem[rc + col] : 0.0;
    ch[t] = in ? (int)a.chunk_of[rc + col] : -1;
    tr[t] = busy[t] && dead[t] <= kEps;
    caps[t] = tr[t] ? a.cap[rc + col] : 0.0;
    n_t += tr[t] ? 1 : 0;
    total += caps[t];
    hi = fmax(hi, caps[t]);
  }
  n_t = warp_sum_ll(n_t);
  total = warp_sum(total);
  hi = warp_max(hi);

  // ---- disk_pool ----
  const long long over = n_t - a.sat_cc[row] > 0 ? n_t - a.sat_cc[row] : 0;
  const double agg = a.disk_rate[row] / (1.0 + a.contention[row] * (double)over);
  const double pool = n_t > 0 ? fmin(a.bw[row], agg) : 0.0;

  // ---- water-fill (bisected level) ----
  const double pool_eff = fmax(fmin(pool, total), 0.0);
  double lo = 0.0;
  for (int it = 0; it < kIters; ++it) {
    const double mid = 0.5 * (lo + hi);
    double filled = 0.0;
#pragma unroll
    for (int t = 0; t < T; ++t) filled += fmin(caps[t], mid);
    filled = warp_sum(filled);
    if (filled < pool_eff) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  double rate[T];
  double rsum = 0.0, horizon = INFINITY;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    rate[t] = enabled ? fmin(caps[t], hi) : 0.0;
    rsum += rate[t];
    // ---- event_horizon ----
    const double dead_evt = (busy[t] && dead[t] > kEps) ? dead[t] : INFINITY;
    const bool xcond = tr[t] && rate[t] > kEps;
    const double xfer_evt = xcond ? rem[t] / rate[t] : INFINITY;
    horizon = fmin(horizon, fmin(dead_evt, xfer_evt));
  }
  rsum = warp_sum(rsum);
  horizon = warp_min(horizon);
  double dt = fmin(a.tick_dt[row], horizon);
  dt = enabled ? fmax(dt, 0.0) : 0.0;

  // ---- advance_channels ----
  bool fin_any = false;
  double moved[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const bool in_dead = busy[t] && dead[t] > kEps && enabled;
    dead[t] = in_dead ? fmax(0.0, dead[t] - dt) : dead[t];
    const bool moving = tr[t] && rate[t] > kEps && enabled;
    moved[t] = moving ? fmin(rem[t], rate[t] * dt) : 0.0;
    const double rem2 = rem[t] - moved[t];
    const bool fin = tr[t] && enabled && rem2 <= kEps;
    busy[t] = busy[t] && !fin;
    rem[t] = fin ? 0.0 : rem2;
    fin_any = fin_any || fin;
  }
  fin_any = __any_sync(kFull, fin_any);

  // ---- pure-FIFO feed ----
  int* base = smem + warp * K;  // idle channels per chunk in earlier tiles
  for (int k = lane; k < K; k += 32) base[k] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  bool valid[T];
  double sz[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    // a column outside the chunk table has no queue to feed from
    const bool idle = ch[t] >= 0 && ch[t] < K && !busy[t] && enabled;
    const int key = idle ? ch[t] : -2 - lane;  // non-idle lanes match none
    const unsigned grp = __match_any_sync(kFull, key);
    const int rank = idle ? base[ch[t]] + __popc(grp & lt) : -1;
    __syncwarp();
    if (idle && (grp & lt) == 0) base[ch[t]] += __popc(grp);
    __syncwarp();
    const int kc = ch[t] < 0 ? 0 : (ch[t] > K - 1 ? K - 1 : ch[t]);
    valid[t] = false;
    sz[t] = 0.0;
    double fsdt_c = 0.0;
    if (col < C) {
      const long long fidx = a.qptr[rk + kc] + rank;
      valid[t] = idle && rank >= 0 && fidx < a.qlen[rk + kc];
      long long flat = a.qoff[rk + kc] + fidx;
      flat = flat < 0 ? 0 : (flat > a.Q - 1 ? a.Q - 1 : flat);
      sz[t] = valid[t] ? a.qsizes[flat] : 0.0;
      fsdt_c = a.fsdt[rk + kc];
      a.busy_out[rc + col] = busy[t] || valid[t];
      a.rem_out[rc + col] = valid[t] ? sz[t] : rem[t];
      a.dead_out[rc + col] = dead[t] + (valid[t] ? fsdt_c : 0.0);
      a.moved_out[rc + col] = moved[t];
    }
  }
  for (int k = 0; k < K; ++k) {
    long long cnt = 0;
    double fed = 0.0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const bool hit = valid[t] && ch[t] == k;
      cnt += hit ? 1 : 0;
      fed += hit ? sz[t] : 0.0;
    }
    cnt = warp_sum_ll(cnt);
    fed = warp_sum(fed);
    if (lane == 0) {
      a.qptr_out[rk + k] = a.qptr[rk + k] + cnt;
      a.qb_out[rk + k] = a.queue_bytes[rk + k] - fed;
    }
  }
  if (lane == 0) {
    a.dt_out[row] = dt;
    a.rate_sum_out[row] = rsum;
    a.fin_out[row] = fin_any;
  }
}

template <int T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(int) * kWarpsPerBlock * (size_t)a.K;
  fused_step_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Pointers in the order of the Pallas kernel's operands and outputs; every
// tensor contiguous on the current device. Returns the launch's
// cudaError_t.
extern "C" int fused_step_f64(
    const void* act, const void* busy, const void* dead, const void* rem,
    const void* cap, const void* chunk_of, const void* tick_dt,
    const void* bw, const void* disk_rate, const void* sat_cc,
    const void* contention, const void* qoff, const void* qlen,
    const void* qptr, const void* queue_bytes, const void* fsdt,
    const void* qsizes, void* dt_out, void* rate_sum_out, void* fin_out,
    void* busy_out, void* dead_out, void* rem_out, void* moved_out,
    void* qptr_out, void* qb_out, long long S, long long C, long long K,
    long long Q, void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (C <= 0 || K <= 0 || K > 1024 || Q <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.act = static_cast<const bool*>(act);
  a.busy = static_cast<const bool*>(busy);
  a.dead = static_cast<const double*>(dead);
  a.rem = static_cast<const double*>(rem);
  a.cap = static_cast<const double*>(cap);
  a.chunk_of = static_cast<const long long*>(chunk_of);
  a.tick_dt = static_cast<const double*>(tick_dt);
  a.bw = static_cast<const double*>(bw);
  a.disk_rate = static_cast<const double*>(disk_rate);
  a.sat_cc = static_cast<const long long*>(sat_cc);
  a.contention = static_cast<const double*>(contention);
  a.qoff = static_cast<const long long*>(qoff);
  a.qlen = static_cast<const long long*>(qlen);
  a.qptr = static_cast<const long long*>(qptr);
  a.queue_bytes = static_cast<const double*>(queue_bytes);
  a.fsdt = static_cast<const double*>(fsdt);
  a.qsizes = static_cast<const double*>(qsizes);
  a.dt_out = static_cast<double*>(dt_out);
  a.rate_sum_out = static_cast<double*>(rate_sum_out);
  a.fin_out = static_cast<bool*>(fin_out);
  a.busy_out = static_cast<bool*>(busy_out);
  a.dead_out = static_cast<double*>(dead_out);
  a.rem_out = static_cast<double*>(rem_out);
  a.moved_out = static_cast<double*>(moved_out);
  a.qptr_out = static_cast<long long*>(qptr_out);
  a.qb_out = static_cast<double*>(qb_out);
  a.S = S;
  a.C = (int)C;
  a.K = (int)K;
  a.Q = Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (C + 31) / 32;
  if (tiles <= 1) return (int)launch<1>(a, st);
  if (tiles <= 2) return (int)launch<2>(a, st);
  if (tiles <= 4) return (int)launch<4>(a, st);
  if (tiles <= 8) return (int)launch<8>(a, st);
  if (tiles <= 16) return (int)launch<16>(a, st);
  if (tiles <= 32) return (int)launch<32>(a, st);
  return (int)cudaErrorInvalidValue;
}
