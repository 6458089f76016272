// Fused resume-free sweep steps, float64, one warp per scenario row.
//
// Replaces the Pallas kernel _fused_kernel of
// src/repro/eval/fabric/kernels/fused_step_pallas.py. One step of a row
// (row_step):
//   1. disk_pool: n_t transferring channels (busy, dead time burned),
//      pool = min(bw, disk / (1 + contention * max(0, n_t - sat))), 0 if
//      nothing transfers;
//   2. water-fill over the transferring caps by 80 halvings of the level
//      from hi = max(caps) (as waterfill.cu), see water_level;
//   3. event_horizon: dt = min(tick_dt, dead-time ends, rem / rate),
//      floored at 0; inactive rows get dt = 0 and pass through unchanged;
//   4. advance_channels: burn dead time, move min(rem, rate * dt) bytes,
//      finish files whose remainder drops to <= 1e-12;
//   5. the pure-FIFO feed: an idle open channel's rank is the count of
//      idle channels of the same chunk at a lower column index; it takes
//      qsizes[qoff + qptr + rank] while qptr + rank < qlen, and pays the
//      chunk's per-file dead time. qptr and queue_bytes advance per chunk.
//
// Two entry points share it:
//   * fused_step_f64, the Pallas kernel's counterpart: one step of every
//     active row, written to new outputs dt, rate_sum (S,), fin_any (S,),
//     busy, dead, rem, moved (S, C), qptr (S, K), queue_bytes (S, K);
//   * fused_rounds_f64, the device loop of the reference's jax_backend
//     (phase A inside a lax.while_loop) for the card: each row takes up to
//     max_steps steps in one launch. A step also looks up the bandwidth
//     profile at t, advances the clock and the event count, and adds the
//     moved bytes to the chunks' delivered totals in column order (the
//     order of the plain version's scatter_add on the CPU). A row stops
//     after the step in which the host has something to decide: a chunk
//     completes (no file left, no busy channel), a ProMC tick falls due,
//     no channel is busy, the row records a timeline, t passes max_time,
//     or the step count reaches max_steps. That step's transition half
//     (the driver's _post) is left to the host, so every row ends the
//     launch with exactly one pending. A row that goes on past a tick
//     applies the tick's bookkeeping itself (tick_ema, delivered_at_tick,
//     next_tick). The driver's own tensors are updated in place.
// bool tensors are 1 byte, int64 stays int64.
//
// What bounds it on an H100: latency, not bytes. A row moves ~40 bytes per
// channel and ~50 per chunk a step, but a step is a chain of dependent
// warp-wide steps, and the sweep runs one step after another. The design
// gives each row one warp and keeps its channels in registers from the
// first load to the last store (lanes stride over C; the bucketed C is
// 4..32, one tile), and, in the loop, its per-chunk state in shared memory
// for the whole launch. The water level's 80 halvings are the longest part
// of the chain; with the row in one tile they run as 16 rounds of a 32-way
// descent (water_level). Per-chunk sums (files fed, bytes fed, bytes moved,
// busy channels) are serial column loops over shared memory, one lane a
// chunk, instead of a warp-wide sum a chunk. Any C up to 1024 and K up to
// 1024 is handled (fewer warps a block where the shared memory needs it);
// the wrapper refuses larger shapes.
#include <cuda_runtime.h>
#include <math.h>

#include "water_descent.cuh"

namespace {

using water::kIters;          // halvings of the water level
constexpr int kMaxWarps = 4;  // warps (rows) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps = 1e-12;
constexpr long long kKindPromc = 4;  // the driver's kind code of ProMC rows
constexpr size_t kSmemMax = 232448;  // shared memory a block may use
constexpr size_t kSmemDefault = 49152;

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

// A row's channels in registers: column t * 32 + lane in tile t. Columns
// past C are closed (ch -1, cap 0, idle).
template <int T>
struct Channels {
  bool busy[T];
  double dead[T], rem[T], cap[T];
  int ch[T];
};

// A row's per-chunk queues, in device or shared memory. qptr_out and qb_out
// may alias qptr and qb: they are written after the last read.
struct Queues {
  const long long* qoff;
  const long long* qlen;
  const double* fsdt;
  const long long* qptr;
  const double* qb;
  long long* qptr_out;
  double* qb_out;
};

// A row's link and disk.
struct Link {
  double bw, disk_rate, contention;
  long long sat_cc;
};

// A warp's shared working memory: per column of the padded row (T * 32)
// and per chunk.
struct WarpSmem {
  double* col_f;  // caps for the descent; then fed file sizes; then moved bytes
  int* col_k;     // the chunk a column fed (or moved bytes to), else -1
  int* col_b;     // the chunk of a busy column, else -1 (the loop only)
  int* base;      // the feed's idle channels per chunk in earlier tiles
};

struct Step {
  double dt, rate_sum;
  bool fin;
};

// Columns a per-chunk loop walks: the padded tile of a one-tile row (CW),
// else every padded column. Padding columns hold chunk -1.
template <int T, int CW>
constexpr int kLoopCols = CW > 0 ? CW : 32 * T;

// The water level of `caps` for `pool_eff`: kIters halvings of [0, hi],
// keeping sum(min(caps, hi)) >= pool_eff; the level is the last hi. With
// the row in one tile (CW > 0: C <= CW <= 32, CW a power of two) the
// halvings run as the 32-way descent of water_descent.cuh, bit for bit the
// one-at-a-time chain; wider rows halve one level at a time, each sum a
// butterfly.
template <int T, int CW>
__device__ __forceinline__ double water_level(const double (&caps)[T], double hi,
                                              double pool_eff, double* col_f, int lane) {
  if constexpr (CW > 0) {
    col_f[lane] = caps[0];
    __syncwarp();
    double cv[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) cv[i] = col_f[i];
    __syncwarp();
    hi = water::descend<CW>(cv, hi, pool_eff, lane);
  } else {
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
  }
  return hi;
}

// One step of a row: the channels in `c` advance and are fed in place,
// `moved` gets each column's moved bytes, the chunk queues in `q` advance.
template <int T, int CW>
__device__ __forceinline__ Step row_step(Channels<T>& c, double (&moved)[T], bool enabled,
                                         double tick_dt, const Link& link, const Queues& q,
                                         const double* qsizes, long long Q, int K,
                                         const WarpSmem& sm, int lane) {
  bool tr[T];
  double caps[T];
  long long n_t = 0;
  double total = 0.0, hi = 0.0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    tr[t] = c.busy[t] && c.dead[t] <= kEps;
    caps[t] = tr[t] ? c.cap[t] : 0.0;
    n_t += tr[t] ? 1 : 0;
    total += caps[t];
    hi = fmax(hi, caps[t]);
  }
  n_t = warp_sum_ll(n_t);
  total = warp_sum(total);
  hi = warp_max(hi);

  // ---- disk_pool ----
  const long long over = n_t - link.sat_cc > 0 ? n_t - link.sat_cc : 0;
  const double agg = link.disk_rate / (1.0 + link.contention * (double)over);
  const double pool = n_t > 0 ? fmin(link.bw, agg) : 0.0;

  // ---- water-fill ----
  const double level =
      water_level<T, CW>(caps, hi, fmax(fmin(pool, total), 0.0), sm.col_f, lane);
  double rate[T];
  double rsum = 0.0, horizon = INFINITY;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    rate[t] = enabled ? fmin(caps[t], level) : 0.0;
    rsum += rate[t];
    // ---- event_horizon ----
    const double dead_evt = (c.busy[t] && c.dead[t] > kEps) ? c.dead[t] : INFINITY;
    const bool xcond = tr[t] && rate[t] > kEps;
    const double xfer_evt = xcond ? c.rem[t] / rate[t] : INFINITY;
    horizon = fmin(horizon, fmin(dead_evt, xfer_evt));
  }
  rsum = warp_sum(rsum);
  horizon = warp_min(horizon);
  double dt = fmin(tick_dt, horizon);
  dt = enabled ? fmax(dt, 0.0) : 0.0;

  // ---- advance_channels ----
  bool fin_any = false;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const bool in_dead = c.busy[t] && c.dead[t] > kEps && enabled;
    c.dead[t] = in_dead ? fmax(0.0, c.dead[t] - dt) : c.dead[t];
    const bool moving = tr[t] && rate[t] > kEps && enabled;
    moved[t] = moving ? fmin(c.rem[t], rate[t] * dt) : 0.0;
    const double rem2 = c.rem[t] - moved[t];
    const bool fin = tr[t] && enabled && rem2 <= kEps;
    c.busy[t] = c.busy[t] && !fin;
    c.rem[t] = fin ? 0.0 : rem2;
    fin_any = fin_any || fin;
  }
  fin_any = __any_sync(kFull, fin_any);

  // ---- pure-FIFO feed ----
  for (int k = lane; k < K; k += 32) sm.base[k] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    // a column outside the chunk table has no queue to feed from
    const int k = c.ch[t];
    const bool idle = k >= 0 && k < K && !c.busy[t] && enabled;
    const int key = idle ? k : -2 - lane;  // non-idle lanes match none
    const unsigned grp = __match_any_sync(kFull, key);
    const int rank = idle ? sm.base[k] + __popc(grp & lt) : -1;
    __syncwarp();
    if (idle && (grp & lt) == 0) sm.base[k] += __popc(grp);
    __syncwarp();
    bool valid = false;
    double sz = 0.0, fsdt_c = 0.0;
    if (idle) {
      const long long fidx = q.qptr[k] + rank;
      valid = fidx < q.qlen[k];
      long long flat = q.qoff[k] + fidx;
      flat = flat < 0 ? 0 : (flat > Q - 1 ? Q - 1 : flat);
      sz = valid ? qsizes[flat] : 0.0;
      fsdt_c = q.fsdt[k];
    }
    c.busy[t] = c.busy[t] || valid;
    c.rem[t] = valid ? sz : c.rem[t];
    c.dead[t] = c.dead[t] + (valid ? fsdt_c : 0.0);
    sm.col_f[col] = sz;
    sm.col_k[col] = valid ? k : -1;
  }
  __syncwarp();
  // files and bytes fed per chunk; sizes are integer-valued doubles, so
  // the order of the sum is exact
  for (int k = lane; k < K; k += 32) {
    long long cnt = 0;
    double fed = 0.0;
#pragma unroll 8
    for (int col = 0; col < (kLoopCols<T, CW>); ++col) {
      if (sm.col_k[col] == k) {
        ++cnt;
        fed += sm.col_f[col];
      }
    }
    q.qptr_out[k] = q.qptr[k] + cnt;
    q.qb_out[k] = q.qb[k] - fed;
  }
  __syncwarp();
  return {dt, rsum, fin_any};
}

template <int T>
__device__ __forceinline__ Channels<T> load_channels(const bool* busy, const double* dead,
                                                     const double* rem, const double* cap,
                                                     const long long* chunk_of, int C, int lane) {
  Channels<T> c;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    const bool in = col < C;
    c.busy[t] = in && busy[col];
    c.dead[t] = in ? dead[col] : 0.0;
    c.rem[t] = in ? rem[col] : 0.0;
    c.cap[t] = in ? cap[col] : 0.0;
    c.ch[t] = in ? (int)chunk_of[col] : -1;
  }
  return c;
}

// ---------------------------------------------------------------------------
// fused_step_f64: one step a launch
// ---------------------------------------------------------------------------

struct StepArgs {
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
  long long Q;
  int C;
  int K;
  int warps;
};

// Shared memory of one warp: col_f (8 bytes a padded column), col_k (4),
// base (4 a chunk), rounded up to 8 bytes.
__host__ __device__ inline size_t step_warp_bytes(int T, int K) {
  return ((size_t)384 * T + (size_t)4 * K + 7) / 8 * 8;
}

template <int T, int CW>
__global__ void fused_step_kernel(StepArgs a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * a.warps + warp;
  if (row >= a.S) return;  // uniform across the warp
  const int C = a.C, K = a.K;
  const long long rc = row * C, rk = row * K;
  unsigned char* w = smem + warp * step_warp_bytes(T, K);
  WarpSmem sm;
  sm.col_f = reinterpret_cast<double*>(w);
  sm.col_k = reinterpret_cast<int*>(sm.col_f + 32 * T);
  sm.col_b = nullptr;
  sm.base = sm.col_k + 32 * T;

  Channels<T> c = load_channels<T>(a.busy + rc, a.dead + rc, a.rem + rc, a.cap + rc,
                                   a.chunk_of + rc, C, lane);
  const Link link{a.bw[row], a.disk_rate[row], a.contention[row], a.sat_cc[row]};
  const Queues q{a.qoff + rk, a.qlen + rk, a.fsdt + rk, a.qptr + rk,
                 a.queue_bytes + rk, a.qptr_out + rk, a.qb_out + rk};
  double moved[T];
  const Step s = row_step<T, CW>(c, moved, a.act[row], a.tick_dt[row], link, q, a.qsizes,
                                 a.Q, K, sm, lane);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    if (col < C) {
      a.busy_out[rc + col] = c.busy[t];
      a.dead_out[rc + col] = c.dead[t];
      a.rem_out[rc + col] = c.rem[t];
      a.moved_out[rc + col] = moved[t];
    }
  }
  if (lane == 0) {
    a.dt_out[row] = s.dt;
    a.rate_sum_out[row] = s.rate_sum;
    a.fin_out[row] = s.fin;
  }
}

// ---------------------------------------------------------------------------
// fused_rounds_f64: a row's steps in a loop, until the host has a decision
// ---------------------------------------------------------------------------

// Operands in the order of the wrapper's pointer array
// (repro_torch.eval.fabric.kernels.fused_step.ROUND_OPERANDS).
struct RoundArgs {
  // read only
  const bool* act;
  const double* tick_period;
  const double* max_time;
  const bool* record;
  const long long* kind;
  const double* cap;
  const long long* chunk_of;
  const double* bw;
  const double* disk_rate;
  const long long* sat_cc;
  const double* contention;
  const double* prof_t;
  const double* prof_mult;
  const long long* qoff;
  const long long* qlen;
  const double* fsdt;
  const bool* chunk_done;
  const double* qsizes;
  // updated in place
  double* t;
  long long* n_events;
  bool* fin_any;
  double* next_tick;
  bool* busy;
  double* dead;
  double* rem;
  long long* qptr;
  double* queue_bytes;
  double* delivered;
  double* delivered_at_tick;
  double* rate_est;
  // written
  long long* steps;
  double* rate_sum;
  double* t0;
  long long S;
  long long Q;
  long long max_steps;
  int C;
  int K;
  int B;
  int warps;
};

// Shared memory of one warp: col_f and eight per-chunk arrays of 8 bytes,
// col_k, col_b and two per-chunk arrays of 4 bytes.
__host__ __device__ inline size_t round_warp_bytes(int T, int K) {
  return (size_t)8 * (32 * T + 8 * K) + (size_t)4 * (64 * T + 2 * K);
}

template <int T, int CW>
__global__ void fused_rounds_kernel(RoundArgs a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * a.warps + warp;
  if (row >= a.S) return;  // uniform across the warp
  const int C = a.C, K = a.K, B = a.B;
  const long long rc = row * C, rk = row * K, rb = row * B;
  double t = a.t[row];
  if (!a.act[row]) {
    if (lane == 0) {
      a.steps[row] = 0;
      a.rate_sum[row] = 0.0;
      a.t0[row] = t;
    }
    return;
  }

  // shared memory: 8-byte arrays first, then 4-byte ones
  double* f8 = reinterpret_cast<double*>(smem + warp * round_warp_bytes(T, K));
  WarpSmem sm;
  sm.col_f = f8;
  long long* qoff = reinterpret_cast<long long*>(f8 + 32 * T);
  long long* qlen = qoff + K;
  long long* qptr = qlen + K;
  double* qb = reinterpret_cast<double*>(qptr + K);
  double* fsdt = qb + K;
  double* deliv = fsdt + K;
  double* dat = deliv + K;
  double* rate = dat + K;
  sm.col_k = reinterpret_cast<int*>(rate + K);
  sm.col_b = sm.col_k + 32 * T;
  sm.base = sm.col_b + 32 * T;
  int* done = sm.base + K;
  for (int k = lane; k < K; k += 32) {
    qoff[k] = a.qoff[rk + k];
    qlen[k] = a.qlen[rk + k];
    qptr[k] = a.qptr[rk + k];
    qb[k] = a.queue_bytes[rk + k];
    fsdt[k] = a.fsdt[rk + k];
    deliv[k] = a.delivered[rk + k];
    dat[k] = a.delivered_at_tick[rk + k];
    rate[k] = a.rate_est[rk + k];
    done[k] = a.chunk_done[rk + k];
  }
  __syncwarp();

  Channels<T> c = load_channels<T>(a.busy + rc, a.dead + rc, a.rem + rc, a.cap + rc,
                                   a.chunk_of + rc, C, lane);
  const Queues q{qoff, qlen, fsdt, qptr, qb, qptr, qb};
  Link link{a.bw[row], a.disk_rate[row], a.contention[row], a.sat_cc[row]};
  const double bw = link.bw;
  const double period = a.tick_period[row];
  const double max_time = a.max_time[row];
  const bool stop_always = a.record[row];  // a timeline sample every step
  const bool promc = a.kind[row] == kKindPromc;
  double next_tick = a.next_tick[row];
  long long n_events = a.n_events[row];
  long long steps = 0;
  bool fin_any = a.fin_any[row];
  double t0 = t, rate_sum = 0.0;

  for (;;) {
    // (a) the bandwidth profile at t: the last step at or before t, and
    // the time of the next one (inf past the last)
    double next_prof = INFINITY;
    link.bw = bw;
    if (B > 1) {
      int at = -1;
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        const double pt = b < B ? a.prof_t[rb + b] : INFINITY;
        at += __popc(__ballot_sync(kFull, pt <= t));
        next_prof = fmin(next_prof, pt > t ? pt : INFINITY);
      }
      next_prof = warp_min(next_prof);
      const double mult = a.prof_mult[rb + (at < 0 ? 0 : at)];
      link.bw = bw * (at >= 0 ? mult : 1.0);
    }
    // (b) one step
    double moved[T];
    const Step s = row_step<T, CW>(c, moved, true, fmin(next_tick - t, next_prof - t), link, q,
                                   a.qsizes, a.Q, K, sm, lane);
    // (c) the clock
    t0 = t;
    t = t + s.dt;
    ++n_events;
    ++steps;
    fin_any = s.fin;
    rate_sum = s.rate_sum;
    // (d) moved bytes into the chunks' totals, in column order; busy
    // channels per chunk
    bool any_busy = false;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      const int col = tt * 32 + lane;
      sm.col_f[col] = moved[tt];
      sm.col_k[col] = moved[tt] != 0.0 ? c.ch[tt] : -1;
      sm.col_b[col] = c.busy[tt] ? c.ch[tt] : -1;
      any_busy = any_busy || c.busy[tt];
    }
    __syncwarp();
    bool completes = false;
    for (int k = lane; k < K; k += 32) {
      double d = deliv[k];
      int n_busy = 0;
#pragma unroll 8
      for (int col = 0; col < (kLoopCols<T, CW>); ++col) {
        if (sm.col_k[col] == k) d += sm.col_f[col];
        n_busy += sm.col_b[col] == k ? 1 : 0;
      }
      deliv[k] = d;
      completes = completes || (!done[k] && qlen[k] - qptr[k] == 0 && n_busy == 0);
    }
    completes = __any_sync(kFull, completes);
    any_busy = __any_sync(kFull, any_busy);
    // (e) the stop test
    const bool tick = t >= next_tick - kEps;
    if (completes || (tick && promc) || !any_busy || stop_always || t > max_time ||
        steps >= a.max_steps) {
      break;
    }
    if (tick) {  // the tick's bookkeeping of the host's _post
      for (int k = lane; k < K; k += 32) {
        const double inst = (deliv[k] - dat[k]) / period;
        rate[k] = rate[k] == 0.0 ? inst : 0.5 * rate[k] + 0.5 * inst;
        dat[k] = deliv[k];
      }
      next_tick = next_tick + period;
    }
    __syncwarp();
  }
  __syncwarp();

#pragma unroll
  for (int tt = 0; tt < T; ++tt) {
    const int col = tt * 32 + lane;
    if (col < C) {
      a.busy[rc + col] = c.busy[tt];
      a.dead[rc + col] = c.dead[tt];
      a.rem[rc + col] = c.rem[tt];
    }
  }
  for (int k = lane; k < K; k += 32) {
    a.qptr[rk + k] = qptr[k];
    a.queue_bytes[rk + k] = qb[k];
    a.delivered[rk + k] = deliv[k];
    a.delivered_at_tick[rk + k] = dat[k];
    a.rate_est[rk + k] = rate[k];
  }
  if (lane == 0) {
    a.t[row] = t;
    a.n_events[row] = n_events;
    a.fin_any[row] = fin_any;
    a.next_tick[row] = next_tick;
    a.steps[row] = steps;
    a.rate_sum[row] = rate_sum;
    a.t0[row] = t0;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Launch `kernel` over S rows, `per_warp` bytes of shared memory a row:
// up to kMaxWarps rows a block, fewer where the shared memory needs it.
template <typename Kernel, typename Args>
cudaError_t launch_rows(Kernel kernel, Args a, size_t per_warp, cudaStream_t stream) {
  const size_t fit = kSmemMax / per_warp;
  if (fit < 1) return cudaErrorInvalidValue;
  a.warps = (int)(fit < (size_t)kMaxWarps ? fit : (size_t)kMaxWarps);
  const size_t smem = per_warp * a.warps;
  if (smem > kSmemDefault) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (a.S + a.warps - 1) / a.warps;
  kernel<<<(unsigned)blocks, 32 * a.warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int T, int CW>
cudaError_t launch_step(const StepArgs& a, cudaStream_t stream) {
  return launch_rows(fused_step_kernel<T, CW>, a, step_warp_bytes(T, a.K), stream);
}

template <int T, int CW>
cudaError_t launch_rounds(const RoundArgs& a, cudaStream_t stream) {
  return launch_rows(fused_rounds_kernel<T, CW>, a, round_warp_bytes(T, a.K), stream);
}

// The kernel for C columns: one tile of CW = 4, 8, 16 or 32 columns (the
// descent's width), else 2..32 tiles of 32.
#define FUSED_DISPATCH(LAUNCH, ARGS, C, STREAM)                  \
  if ((C) <= 4) return (int)LAUNCH<1, 4>(ARGS, STREAM);          \
  if ((C) <= 8) return (int)LAUNCH<1, 8>(ARGS, STREAM);          \
  if ((C) <= 16) return (int)LAUNCH<1, 16>(ARGS, STREAM);        \
  if ((C) <= 32) return (int)LAUNCH<1, 32>(ARGS, STREAM);        \
  if ((C) <= 64) return (int)LAUNCH<2, 0>(ARGS, STREAM);         \
  if ((C) <= 128) return (int)LAUNCH<4, 0>(ARGS, STREAM);        \
  if ((C) <= 256) return (int)LAUNCH<8, 0>(ARGS, STREAM);        \
  if ((C) <= 512) return (int)LAUNCH<16, 0>(ARGS, STREAM);       \
  if ((C) <= 1024) return (int)LAUNCH<32, 0>(ARGS, STREAM);      \
  return (int)cudaErrorInvalidValue

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
  StepArgs a;
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
  a.Q = Q;
  a.C = (int)C;
  a.K = (int)K;
  a.warps = 0;
  FUSED_DISPATCH(launch_step, a, C, static_cast<cudaStream_t>(stream));
}

// `ptrs`: the 33 operands in RoundArgs order, every tensor
// contiguous on the current device (S rows, C channels, K chunks, B profile
// steps, Q file sizes). Each active row takes 1 to max_steps steps.
// Returns the launch's cudaError_t.
extern "C" int fused_rounds_f64(void* const* ptrs, long long S, long long C, long long K,
                                long long B, long long Q, long long max_steps, void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (C <= 0 || K <= 0 || K > 1024 || B <= 0 || Q <= 0 || max_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RoundArgs a;
  a.act = static_cast<const bool*>(ptrs[0]);
  a.tick_period = static_cast<const double*>(ptrs[1]);
  a.max_time = static_cast<const double*>(ptrs[2]);
  a.record = static_cast<const bool*>(ptrs[3]);
  a.kind = static_cast<const long long*>(ptrs[4]);
  a.cap = static_cast<const double*>(ptrs[5]);
  a.chunk_of = static_cast<const long long*>(ptrs[6]);
  a.bw = static_cast<const double*>(ptrs[7]);
  a.disk_rate = static_cast<const double*>(ptrs[8]);
  a.sat_cc = static_cast<const long long*>(ptrs[9]);
  a.contention = static_cast<const double*>(ptrs[10]);
  a.prof_t = static_cast<const double*>(ptrs[11]);
  a.prof_mult = static_cast<const double*>(ptrs[12]);
  a.qoff = static_cast<const long long*>(ptrs[13]);
  a.qlen = static_cast<const long long*>(ptrs[14]);
  a.fsdt = static_cast<const double*>(ptrs[15]);
  a.chunk_done = static_cast<const bool*>(ptrs[16]);
  a.qsizes = static_cast<const double*>(ptrs[17]);
  a.t = static_cast<double*>(ptrs[18]);
  a.n_events = static_cast<long long*>(ptrs[19]);
  a.fin_any = static_cast<bool*>(ptrs[20]);
  a.next_tick = static_cast<double*>(ptrs[21]);
  a.busy = static_cast<bool*>(ptrs[22]);
  a.dead = static_cast<double*>(ptrs[23]);
  a.rem = static_cast<double*>(ptrs[24]);
  a.qptr = static_cast<long long*>(ptrs[25]);
  a.queue_bytes = static_cast<double*>(ptrs[26]);
  a.delivered = static_cast<double*>(ptrs[27]);
  a.delivered_at_tick = static_cast<double*>(ptrs[28]);
  a.rate_est = static_cast<double*>(ptrs[29]);
  a.steps = static_cast<long long*>(ptrs[30]);
  a.rate_sum = static_cast<double*>(ptrs[31]);
  a.t0 = static_cast<double*>(ptrs[32]);
  a.S = S;
  a.Q = Q;
  a.max_steps = max_steps;
  a.C = (int)C;
  a.K = (int)K;
  a.B = (int)B;
  a.warps = 0;
  FUSED_DISPATCH(launch_rounds, a, C, static_cast<cudaStream_t>(stream));
}
