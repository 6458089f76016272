// Fused sweep steps and the whole device loop, float64, one warp per
// scenario row.
//
// Replaces the Pallas kernel _fused_kernel of
// src/repro/eval/fabric/kernels/fused_step_pallas.py, and the device loop of
// the reference's jax_backend around it. One step of a row (row_step):
//   1. disk_pool: n_t transferring channels (busy, dead time burned),
//      pool = min(bw, disk / (1 + contention * max(0, n_t - sat))), 0 if
//      nothing transfers;
//   2. water-fill over the transferring caps by 80 halvings of the level
//      from hi = max(caps) (as waterfill.cu), see water_level;
//   3. event_horizon: dt = min(tick_dt, dead-time ends, rem / rate),
//      floored at 0; inactive rows get dt = 0 and pass through unchanged;
//   4. advance_channels: burn dead time, move min(rem, rate * dt) bytes,
//      finish files whose remainder drops to <= 1e-12;
//   5. the feed (feed_row): an idle open channel's rank is the count of
//      idle channels of the same chunk at a lower column index; rank r
//      takes the resume file at stack depth pn - 1 - r while r < pn, then
//      qsizes[qoff + qptr + r - pn] while that index is < qlen, and pays
//      the chunk's per-file dead time. qptr, pn and queue_bytes advance per
//      chunk. The one-step kernel has no stack (pn = 0).
//
// Two entry points share it:
//   * fused_step_f64, the Pallas kernel's counterpart: one step of every
//     active row, written to new outputs dt, rate_sum (S,), fin_any (S,),
//     busy, dead, rem, moved (S, C), qptr (S, K), queue_bytes (S, K);
//   * fused_rounds_f64, the reference's device loop (phases A-D of
//     jax_backend in a lax.while_loop) for the card: each row loops until
//     it is done, errs (t > max_time, or a live chunk holds no channel
//     while none is busy), meets a capacity guard, or has taken max_steps
//     steps; its stop code says which. An iteration looks up the bandwidth
//     profile at t, takes a step, pushes the step's (t, rate sum) into the
//     row's timeline ring (halving it when full), advances the clock and
//     the event count, adds the moved bytes to the chunks' delivered totals
//     in column order (the order of the plain version's scatter_add on the
//     CPU), then takes the transition of transition.post_transition:
//     completions marked; SC (close and left-pack, cursor, open at the
//     lowest free columns) or MC / ProMC (chunk views, laggard grants,
//     apply_grants) handlers one completed chunk at a time, lowest first,
//     a re-feed after each; at a tick the rate EMA, then ProMC's streak
//     check and move (a busy victim pushes ceil(rem) on the resume stack)
//     and a re-feed; the done test. The guards (an SC handler that would
//     open more channels than the row has free columns, walked over the
//     column counts first; a ProMC tick with a chunk's stack at P) stop
//     the row before the transition, which the host then takes. The
//     driver's own tensors are updated in place.
// bool tensors are 1 byte, int64 stays int64.
//
// What bounds it on an H100: latency, not bytes. A row moves ~40 bytes per
// channel and ~50 per chunk a step, but a step is a chain of dependent
// warp-wide steps, and the sweep runs one step after another. The design
// gives each row one warp and keeps its channels in registers from the
// first load to the last store (lanes stride over C; the bucketed C is
// 4..32, one tile; a compaction stages them through shared memory), and,
// in the loop, its per-chunk state in shared memory
// for the whole launch. The water level's 80 halvings are the longest part
// of the chain; with the row in one tile they run as 16 rounds of a 32-way
// descent (water_level). Per-chunk sums (files fed, bytes fed, bytes moved,
// busy channels) are serial column loops over shared memory, one lane a
// chunk, instead of a warp-wide sum a chunk. The transition's decisions
// (laggard grants, the ProMC check, the SC guard's walk) are serial loops
// over K, on lane 0 or on every lane alike; they run only on steps with a
// completion or a tick. Any C up to 1024 and K up to
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

// A row's per-chunk queues, in device or shared memory, and its LIFO
// resume stack (pn == nullptr: none, the pure-FIFO feed). qptr_out and
// qb_out may alias qptr and qb, and pn is updated in place: each is written
// after the last read.
struct Queues {
  const long long* qoff;
  const long long* qlen;
  const double* fsdt;
  const long long* qptr;
  const double* qb;
  long long* qptr_out;
  double* qb_out;
  long long* pn;          // files on each chunk's resume stack
  const double* psizes;   // the stack, (K, P) in device memory
  int P;
};

// A row's link and disk.
struct Link {
  double bw, disk_rate, contention;
  long long sat_cc;
};

// A warp's shared working memory: per column of the padded row (T * 32)
// and per chunk.
struct WarpSmem {
  double* col_f;  // caps for the descent; fed file sizes; moved bytes; staging
  double* col_g;  // staging of a compaction (the loop only)
  double* col_h;  // staging of a compaction (the loop only)
  int* col_k;     // the chunk a column fed from its queue (or moved bytes to), else -1
  int* col_b;     // the chunk a column fed from its stack, or of a busy column, else -1
  int* col_s;     // the grant sequence of a handler (the loop only)
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

// The feed (kernels.feed_queues): idle open channels of an enabled row pull
// the next file of their chunk. A channel's rank is the count of idle
// channels of the same chunk at a lower column; rank r < pn takes the
// resume file at stack depth pn - 1 - r, later ranks the queued file at
// qptr + r - pn while that is < qlen. Each pays the chunk's per-file dead
// time; qptr, pn and queue_bytes advance per chunk.
template <int T, int CW>
__device__ __forceinline__ void feed_row(Channels<T>& c, bool enabled, const Queues& q,
                                         const double* qsizes, long long Q, int K,
                                         const WarpSmem& sm, int lane) {
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
    bool valid = false, pre = false;
    double sz = 0.0, fsdt_c = 0.0;
    if (idle) {
      const long long pn_c = q.pn != nullptr ? q.pn[k] : 0;
      if (rank < pn_c) {
        long long d = pn_c - 1 - rank;
        d = d < 0 ? 0 : (d > q.P - 1 ? q.P - 1 : d);
        valid = pre = true;
        sz = q.psizes[(long long)k * q.P + d];
      } else {
        const long long fidx = q.qptr[k] + rank - pn_c;
        valid = fidx < q.qlen[k];
        long long flat = q.qoff[k] + fidx;
        flat = flat < 0 ? 0 : (flat > Q - 1 ? Q - 1 : flat);
        sz = valid ? qsizes[flat] : 0.0;
      }
      fsdt_c = q.fsdt[k];
    }
    c.busy[t] = c.busy[t] || valid;
    c.rem[t] = valid ? sz : c.rem[t];
    c.dead[t] = c.dead[t] + (valid ? fsdt_c : 0.0);
    sm.col_f[col] = sz;
    sm.col_k[col] = valid && !pre ? k : -1;
    sm.col_b[col] = pre ? k : -1;
  }
  __syncwarp();
  // files and bytes fed per chunk; sizes are integer-valued doubles, so
  // the order of the sum is exact
  for (int k = lane; k < K; k += 32) {
    long long cnt = 0, popped = 0;
    double fed = 0.0;
#pragma unroll 8
    for (int col = 0; col < (kLoopCols<T, CW>); ++col) {
      if (sm.col_k[col] == k) {
        ++cnt;
        fed += sm.col_f[col];
      }
      if (sm.col_b[col] == k) {
        ++popped;
        fed += sm.col_f[col];
      }
    }
    q.qptr_out[k] = q.qptr[k] + cnt;
    q.qb_out[k] = q.qb[k] - fed;
    if (q.pn != nullptr) q.pn[k] -= popped;
  }
  __syncwarp();
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

  // ---- feed ----
  feed_row<T, CW>(c, enabled, q, qsizes, Q, K, sm, lane);
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

// Shared memory of one warp: col_f (8 bytes a padded column), col_k and
// col_b (4 each), base (4 a chunk), rounded up to 8 bytes.
__host__ __device__ inline size_t step_warp_bytes(int T, int K) {
  return ((size_t)512 * T + (size_t)4 * K + 7) / 8 * 8;
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
  WarpSmem sm{};
  sm.col_f = reinterpret_cast<double*>(w);
  sm.col_k = reinterpret_cast<int*>(sm.col_f + 32 * T);
  sm.col_b = sm.col_k + 32 * T;
  sm.base = sm.col_b + 32 * T;

  Channels<T> c = load_channels<T>(a.busy + rc, a.dead + rc, a.rem + rc, a.cap + rc,
                                   a.chunk_of + rc, C, lane);
  const Link link{a.bw[row], a.disk_rate[row], a.contention[row], a.sat_cc[row]};
  const Queues q{a.qoff + rk, a.qlen + rk, a.fsdt + rk, a.qptr + rk,
                 a.queue_bytes + rk, a.qptr_out + rk, a.qb_out + rk, nullptr, nullptr, 1};
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
// fused_rounds_f64: a row's steps and transitions in a loop, until it is done
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
  const bool* trivial_complete;
  const long long* n_chunks;
  const double* bw;
  const double* disk_rate;
  const long long* sat_cc;
  const double* contention;
  const double* setup_cost;
  const double* promc_ratio;
  const long long* promc_patience;
  const double* prof_t;
  const double* prof_mult;
  const long long* qoff;
  const long long* qlen;
  const double* fsdt;
  const long long* nfiles;
  const long long* sc_order;
  const long long* conc;
  const long long* par;
  const double* cap_k;
  const double* avg_fs_k;
  const double* qsizes;
  // updated in place
  double* t;
  long long* n_events;
  bool* fin_any;
  double* next_tick;
  bool* done;
  double* finish_t;
  long long* sc_cursor;
  long long* streak;
  long long* pair_fast;
  long long* pair_slow;
  long long* n_moves;
  bool* busy;
  double* dead;
  double* rem;
  double* cap;
  long long* chunk_of;
  long long* qptr;
  double* queue_bytes;
  long long* prepend_n;
  bool* chunk_done;
  double* completed_at;
  double* delivered;
  double* delivered_at_tick;
  double* rate_est;
  double* prepend_sizes;
  double* tl_t;
  double* tl_rate;
  long long* tl_len;
  long long* tl_stride;
  long long* tl_seen;
  double* tl_last_t;
  double* tl_last_rate;
  // written
  long long* steps;
  long long* stop;
  long long S;
  long long Q;
  long long max_steps;
  int C;
  int K;
  int B;
  int P;
  int TL;
  int warps;
};
constexpr int kRoundOperands = 60;

// the driver's kind codes and the loop's stop codes (transition.STOP_*)
constexpr long long kKindSc = 2, kKindMc = 3;
constexpr long long kStopDone = 1, kStopCap = 2, kStopGuard = 3, kStopError = 4;

// A row's per-chunk state in shared memory for the whole launch, and the
// handlers' per-chunk scratch.
struct ChunkSmem {
  long long *qoff, *qlen, *qptr, *pn;
  double *qb, *fsdt, *deliv, *dat, *rate, *cat, *capk, *avgfs, *brem, *eta, *egr;
  int *done, *nfiles, *order, *conc, *par, *nch, *grants, *comp, *ord;
};

// Per-chunk arrays of one warp: fifteen of 8 bytes, nine of 4 (with the
// feed's base); per column three of 8 bytes and three of 4.
__host__ __device__ inline size_t round_warp_bytes(int T, int K) {
  return (size_t)8 * (96 * T + 15 * K) + (size_t)4 * (96 * T + 10 * K);
}

// A row's controller and link constants.
struct RowConst {
  long long kind, n_chunks, sat_cc, patience;
  double bw, disk_rate, contention, setup_cost, ratio;
};

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Close the columns of `close`, then left-pack the row: open channels move
// to the lowest columns keeping their order, the rest are empty
// (kernels.compact_channels). Returns the open channels.
template <int T>
__device__ __forceinline__ int close_compact(Channels<T>& c, const bool (&close)[T],
                                             const WarpSmem& sm, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (close[t]) {
      c.ch[t] = -1;
      c.busy[t] = false;
      c.dead[t] = 0.0;
      c.rem[t] = 0.0;
      c.cap[t] = 0.0;
    }
    const bool open = c.ch[t] >= 0;
    const unsigned m = __ballot_sync(kFull, open);
    if (open) {
      const int pos = n + __popc(m & lt);
      sm.col_f[pos] = c.dead[t];
      sm.col_g[pos] = c.rem[t];
      sm.col_h[pos] = c.cap[t];
      sm.col_k[pos] = c.ch[t];
      sm.col_b[pos] = c.busy[t] ? 1 : 0;
    }
    n += __popc(m);
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    const bool in = col < n;
    c.dead[t] = in ? sm.col_f[col] : 0.0;
    c.rem[t] = in ? sm.col_g[col] : 0.0;
    c.cap[t] = in ? sm.col_h[col] : 0.0;
    c.ch[t] = in ? sm.col_k[col] : -1;
    c.busy[t] = in && sm.col_b[col] != 0;
  }
  __syncwarp();
  return n;
}

// Channels a chunk holds open (ck.nch) and the row's open channels.
template <int T, int CW>
__device__ __forceinline__ int count_open(const Channels<T>& c, const ChunkSmem& ck,
                                          const WarpSmem& sm, int K, int lane) {
  int n = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    sm.col_k[t * 32 + lane] = c.ch[t];
    n += c.ch[t] >= 0 ? 1 : 0;
  }
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    int m = 0;
#pragma unroll 8
    for (int col = 0; col < (kLoopCols<T, CW>); ++col) m += sm.col_k[col] == k ? 1 : 0;
    ck.nch[k] = m;
  }
  __syncwarp();
  return warp_sum_int(n);
}

// The chunk views (transition.views): open channels, remaining bytes (queue
// plus in flight, summed in column order) and the ETA of every chunk.
template <int T, int CW>
__device__ __forceinline__ void row_views(const Channels<T>& c, const ChunkSmem& ck,
                                          const RowConst& rc, const WarpSmem& sm, int K,
                                          int lane) {
  int n = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    const bool open = c.ch[t] >= 0;
    n += open ? 1 : 0;
    sm.col_k[col] = c.ch[t];
    sm.col_b[col] = open && c.busy[t] ? c.ch[t] : -1;
    sm.col_f[col] = c.rem[t];
  }
  const long long n_open = warp_sum_int(n);
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    int m = 0;
    double inflight = 0.0;
#pragma unroll 8
    for (int col = 0; col < (kLoopCols<T, CW>); ++col) {
      m += sm.col_k[col] == k ? 1 : 0;
      if (sm.col_b[col] == k) inflight += sm.col_f[col];
    }
    ck.nch[k] = m;
    const double br = ck.qb[k] + inflight;
    // controllers.predicted_chunk_rate
    const long long nn = m > 1 ? m : 1;
    const long long total = n_open > 1 ? n_open : 1;
    const long long over = total - rc.sat_cc > 0 ? total - rc.sat_cc : 0;
    const double penalty = 1.0 / (1.0 + rc.contention * (double)over);
    const double agg = rc.disk_rate * penalty;
    const double pool = fmin(rc.bw, agg);
    const double r0 = fmin(ck.capk[k], pool / (double)total);
    const double t_file = ck.fsdt[k] + ck.avgfs[k] / fmax(r0, 1e-9);
    const double pred = (double)nn * ck.avgfs[k] / t_file;
    // controllers.chunk_eta
    const double r = ck.rate[k] > 0.0 ? ck.rate[k] : pred;
    const double e = r > 0.0 ? br / r : INFINITY;
    ck.brem[k] = br;
    ck.eta[k] = (ck.done[k] || br <= 0.0) ? 0.0 : e;
  }
  __syncwarp();
}

// The free columns below C take, in column order, the first n opens:
// open(rank, ch, dead, cap) sets each one's chunk, dead time and cap.
template <int T, typename Open>
__device__ __forceinline__ void open_free(Channels<T>& c, int n, int C, int lane, Open open) {
  const unsigned lt = (1u << lane) - 1u;
  int base = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const bool fr = c.ch[t] < 0 && t * 32 + lane < C;
    const unsigned m = __ballot_sync(kFull, fr);
    const int rank = base + __popc(m & lt);
    if (fr && rank < n) open(rank, c.ch[t], c.dead[t], c.cap[t]);
    base += __popc(m);
  }
}

// The lowest column of `sel` (-1 if none).
template <int T>
__device__ __forceinline__ int lowest(const bool (&sel)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const unsigned m = __ballot_sync(kFull, sel[t]);
    if (m) return t * 32 + __ffs(m) - 1;
  }
  return -1;
}

// SC's cursor step after a completion (controllers.sc_advance_cursor).
__device__ __forceinline__ long long sc_advance(long long cursor, const ChunkSmem& ck,
                                                long long n_chunks, int K) {
  ++cursor;
  for (int it = 0; it < K; ++it) {
    const long long at = cursor < 0 ? 0 : (cursor > K - 1 ? K - 1 : cursor);
    if (!(cursor < n_chunks && ck.nfiles[ck.order[at]] == 0)) break;
    ++cursor;
  }
  return cursor;
}

template <int T, int CW>
__global__ void fused_rounds_kernel(RoundArgs a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * a.warps + warp;
  if (row >= a.S) return;  // uniform across the warp
  if (!a.act[row]) {
    if (lane == 0) {
      a.steps[row] = 0;
      a.stop[row] = 0;
    }
    return;
  }
  const int C = a.C, K = a.K, B = a.B, P = a.P, TL = a.TL;
  const long long rc_ = row * C, rk = row * K, rb = row * B;

  // shared memory: 8-byte arrays first, then 4-byte ones
  double* f8 = reinterpret_cast<double*>(smem + warp * round_warp_bytes(T, K));
  WarpSmem sm;
  sm.col_f = f8;
  sm.col_g = sm.col_f + 32 * T;
  sm.col_h = sm.col_g + 32 * T;
  ChunkSmem ck;
  ck.qoff = reinterpret_cast<long long*>(sm.col_h + 32 * T);
  ck.qlen = ck.qoff + K;
  ck.qptr = ck.qlen + K;
  ck.pn = ck.qptr + K;
  ck.qb = reinterpret_cast<double*>(ck.pn + K);
  ck.fsdt = ck.qb + K;
  ck.deliv = ck.fsdt + K;
  ck.dat = ck.deliv + K;
  ck.rate = ck.dat + K;
  ck.cat = ck.rate + K;
  ck.capk = ck.cat + K;
  ck.avgfs = ck.capk + K;
  ck.brem = ck.avgfs + K;
  ck.eta = ck.brem + K;
  ck.egr = ck.eta + K;
  sm.col_k = reinterpret_cast<int*>(ck.egr + K);
  sm.col_b = sm.col_k + 32 * T;
  sm.col_s = sm.col_b + 32 * T;
  sm.base = sm.col_s + 32 * T;
  ck.done = sm.base + K;
  ck.nfiles = ck.done + K;
  ck.order = ck.nfiles + K;
  ck.conc = ck.order + K;
  ck.par = ck.conc + K;
  ck.nch = ck.par + K;
  ck.grants = ck.nch + K;
  ck.comp = ck.grants + K;
  ck.ord = ck.comp + K;
  for (int k = lane; k < K; k += 32) {
    ck.qoff[k] = a.qoff[rk + k];
    ck.qlen[k] = a.qlen[rk + k];
    ck.qptr[k] = a.qptr[rk + k];
    ck.pn[k] = a.prepend_n[rk + k];
    ck.qb[k] = a.queue_bytes[rk + k];
    ck.fsdt[k] = a.fsdt[rk + k];
    ck.deliv[k] = a.delivered[rk + k];
    ck.dat[k] = a.delivered_at_tick[rk + k];
    ck.rate[k] = a.rate_est[rk + k];
    ck.cat[k] = a.completed_at[rk + k];
    ck.capk[k] = a.cap_k[rk + k];
    ck.avgfs[k] = a.avg_fs_k[rk + k];
    ck.done[k] = a.chunk_done[rk + k];
    ck.nfiles[k] = (int)a.nfiles[rk + k];
    ck.order[k] = (int)a.sc_order[rk + k];
    ck.conc[k] = (int)a.conc[rk + k];
    ck.par[k] = (int)a.par[rk + k];
  }
  __syncwarp();

  Channels<T> c = load_channels<T>(a.busy + rc_, a.dead + rc_, a.rem + rc_, a.cap + rc_,
                                   a.chunk_of + rc_, C, lane);
  const Queues q{ck.qoff, ck.qlen, ck.fsdt, ck.qptr, ck.qb, ck.qptr, ck.qb, ck.pn,
                 a.prepend_sizes + rk * P, P};
  double* const psizes = a.prepend_sizes + rk * P;
  double* const tl_t = a.tl_t + row * TL;
  double* const tl_rate = a.tl_rate + row * TL;
  const RowConst rc{a.kind[row], a.n_chunks[row], a.sat_cc[row], a.promc_patience[row],
                    a.bw[row], a.disk_rate[row], a.contention[row], a.setup_cost[row],
                    a.promc_ratio[row]};
  Link link{rc.bw, rc.disk_rate, rc.contention, rc.sat_cc};
  const double period = a.tick_period[row];
  const double max_time = a.max_time[row];
  const bool record = a.record[row];
  const bool trivial_complete = a.trivial_complete[row];
  double t = a.t[row];
  double next_tick = a.next_tick[row];
  double finish_t = a.finish_t[row];
  long long n_events = a.n_events[row];
  long long cursor = a.sc_cursor[row], streak = a.streak[row];
  long long pair_fast = a.pair_fast[row], pair_slow = a.pair_slow[row];
  long long n_moves = a.n_moves[row];
  long long tl_len = a.tl_len[row], tl_stride = a.tl_stride[row], tl_seen = a.tl_seen[row];
  double tl_last_t = a.tl_last_t[row], tl_last_rate = a.tl_last_rate[row];
  bool fin_any = a.fin_any[row];
  bool row_done = false;
  long long steps = 0, stop = 0;

  for (;;) {
    // (0) the error test: past max_time, or a live chunk holding no channel
    // while no channel is busy
    if (t > max_time) {
      stop = kStopError;
      break;
    }
    bool any_busy = false;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) any_busy = any_busy || c.busy[tt];
    if (!__any_sync(kFull, any_busy)) {
      count_open<T, CW>(c, ck, sm, K, lane);
      bool str = false;
      for (int k = lane; k < K; k += 32) str = str || (!ck.done[k] && ck.nch[k] == 0);
      if (__any_sync(kFull, str)) {
        stop = kStopError;
        break;
      }
    }
    // (a) the bandwidth profile at t: the last step at or before t, and
    // the time of the next one (inf past the last)
    double next_prof = INFINITY;
    link.bw = rc.bw;
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
      link.bw = rc.bw * (at >= 0 ? mult : 1.0);
    }
    // (b) one step: physics, then the feed with the resume stack
    double moved[T];
    const Step s = row_step<T, CW>(c, moved, true, fmin(next_tick - t, next_prof - t), link, q,
                                   a.qsizes, a.Q, K, sm, lane);
    // (c) the timeline ring (kernels.timeline_push) at the step's start
    if (record) {
      const long long st_safe = tl_stride > 1 ? tl_stride : 1;
      if (tl_seen % st_safe == 0 && tl_len >= TL) {
        // keep every other sample; the stride doubles
        const int half = (TL + 1) / 2;
        for (int j0 = 0; j0 < half; j0 += 32) {
          const int j = j0 + lane;
          double vt = 0.0, vr = 0.0;
          if (j < half) {
            vt = tl_t[2 * j];
            vr = tl_rate[2 * j];
          }
          __syncwarp();
          if (j < half) {
            tl_t[j] = vt;
            tl_rate[j] = vr;
          }
          __syncwarp();
        }
        for (int j = half + lane; j < TL; j += 32) {
          tl_t[j] = 0.0;
          tl_rate[j] = 0.0;
        }
        __syncwarp();
        tl_len = (tl_len + 1) / 2;
        tl_stride = st_safe * 2;
      }
      const long long st2 = tl_stride > 1 ? tl_stride : 1;
      if (tl_seen % st2 == 0 && tl_len < TL) {
        if (lane == 0) {
          tl_t[tl_len] = t;
          tl_rate[tl_len] = s.rate_sum;
        }
        ++tl_len;
      }
      ++tl_seen;
      tl_last_t = t;
      tl_last_rate = s.rate_sum;
      __syncwarp();
    }
    // (d) the clock; moved bytes into the chunks' totals, in column order;
    // busy channels per chunk and the chunks that complete
    t = t + s.dt;
    ++n_events;
    ++steps;
    fin_any = s.fin;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      const int col = tt * 32 + lane;
      sm.col_f[col] = moved[tt];
      sm.col_k[col] = moved[tt] != 0.0 ? c.ch[tt] : -1;
      sm.col_b[col] = c.busy[tt] ? c.ch[tt] : -1;
    }
    __syncwarp();
    bool comp_any = false, full = false;
    for (int k = lane; k < K; k += 32) {
      double d = ck.deliv[k];
      int n_busy = 0;
#pragma unroll 8
      for (int col = 0; col < (kLoopCols<T, CW>); ++col) {
        if (sm.col_k[col] == k) d += sm.col_f[col];
        n_busy += sm.col_b[col] == k ? 1 : 0;
      }
      ck.deliv[k] = d;
      const bool cmp = !ck.done[k] && ck.qlen[k] - ck.qptr[k] + ck.pn[k] == 0 && n_busy == 0;
      ck.comp[k] = cmp;
      comp_any = comp_any || cmp;
      full = full || ck.pn[k] >= P;
    }
    comp_any = __any_sync(kFull, comp_any);
    const bool tick_hit = t >= next_tick - kEps;
    // (e) the capacity guards: the row stops with its transition pending
    // for the host, which grows the axis
    bool guard = tick_hit && rc.kind == kKindPromc && __any_sync(kFull, full);
    if (!guard && rc.kind == kKindSc && comp_any) {
      // SC's handlers walked over column counts: free columns at each open
      const int n_open = count_open<T, CW>(c, ck, sm, K, lane);
      int short_ = 0;
      if (lane == 0) {
        long long cur = cursor;
        long long free_ = C - n_open;
        for (int k = 0; k < K; ++k) {
          if (!ck.comp[k]) continue;
          free_ += ck.nch[k];
          ck.nch[k] = 0;
          cur = sc_advance(cur, ck, rc.n_chunks, K);
          if (cur < rc.n_chunks) {
            const int nxt = ck.order[cur];
            const long long no = ck.conc[nxt];
            short_ |= free_ < no ? 1 : 0;
            free_ -= no;
            ck.nch[nxt] += (int)no;
          }
        }
      }
      guard = __shfl_sync(kFull, short_, 0) != 0;
      __syncwarp();
    }
    if (guard) {
      stop = kStopGuard;
      break;
    }
    // (f) the transition (transition.post_transition): completions
    if (comp_any && (trivial_complete || rc.kind >= kKindSc)) {
      for (int k = lane; k < K; k += 32) {
        if (ck.comp[k]) {
          ck.done[k] = 1;
          ck.qb[k] = 0.0;
          ck.cat[k] = t;
        }
      }
      __syncwarp();
    }
    const bool ctrl = comp_any && rc.kind >= kKindSc;
    if (ctrl && rc.kind == kKindPromc) {  // ProMC drops its streak evidence
      streak = 0;
      pair_fast = -1;
      pair_slow = -1;
    }
    // each completed chunk's handler in index order, a re-feed after each
    for (int k = 0; ctrl && k < K; ++k) {
      if (!ck.comp[k]) continue;
      bool fed = false;
      if (rc.kind == kKindSc) {
        // close chunk k, advance the cursor past empty classes, open the
        // next class's channels at the lowest free columns
        bool sel[T];
#pragma unroll
        for (int tt = 0; tt < T; ++tt) sel[tt] = c.ch[tt] == k;
        close_compact<T>(c, sel, sm, lane);
        cursor = sc_advance(cursor, ck, rc.n_chunks, K);
        const int nxt = ck.order[cursor < 0 ? 0 : (cursor > K - 1 ? K - 1 : cursor)];
        const int n_open = cursor < rc.n_chunks ? ck.conc[nxt] : 0;
        const double cap_n = ck.capk[nxt];
        const double sc = rc.setup_cost;
        open_free<T>(c, n_open, C, lane, [&](int, int& ch, double& dead, double& cp) {
          ch = nxt;
          dead = sc;
          cp = cap_n;
        });
        fed = true;
      } else if (rc.kind == kKindMc || rc.kind == kKindPromc) {
        // freed channels to the largest-ETA laggards (laggard_grants), in
        // first-grant order onto the lowest free columns (apply_grants)
        row_views<T, CW>(c, ck, rc, sm, K, lane);
        int total = 0;
        if (lane == 0) {
          bool any_live = false;
          for (int j = 0; j < K; ++j) {
            ck.grants[j] = 0;
            ck.egr[j] = ck.eta[j];
            any_live = any_live || (!ck.done[j] && j != k && ck.brem[j] > 0.0);
          }
          const int freed = ck.nch[k];
          int n_ord = 0;
          for (int i = 0; any_live && i < freed; ++i) {
            double cur = -INFINITY;
            for (int j = 0; j < K; ++j) {
              if (!ck.done[j] && j != k && ck.brem[j] > 0.0) cur = fmax(cur, ck.egr[j]);
            }
            int dst = 0;
            for (int j = 0; j < K; ++j) {
              if (!ck.done[j] && j != k && ck.brem[j] > 0.0 && ck.egr[j] == cur) {
                dst = j;
                break;
              }
            }
            if (ck.grants[dst] == 0) ck.ord[n_ord++] = dst;
            ++ck.grants[dst];
            ++total;
            const long long n = (long long)ck.nch[dst] + ck.grants[dst];
            const double nf = (double)n;
            const double factor = n > 1 ? (nf - 1.0) / fmax(nf, 1.0) : 0.5;
            if (isfinite(ck.egr[dst])) ck.egr[dst] = ck.egr[dst] * factor;
          }
          int r = 0;
          for (int o = 0; o < n_ord; ++o) {
            const int d = ck.ord[o];
            for (int g = 0; g < ck.grants[d]; ++g) sm.col_s[r++] = d;
          }
        }
        total = __shfl_sync(kFull, total, 0);
        __syncwarp();
        if (total > 0) {
          bool sel[T];
#pragma unroll
          for (int tt = 0; tt < T; ++tt) sel[tt] = c.ch[tt] == k;
          close_compact<T>(c, sel, sm, lane);
          const int par_src = ck.par[k];
          const double sc = rc.setup_cost;
          open_free<T>(c, total, C, lane, [&](int rank, int& ch, double& dead, double& cp) {
            const int d = sm.col_s[rank];
            ch = d;
            dead = ck.par[d] == par_src ? 0.25 * sc : sc;
            cp = ck.capk[d];
          });
          n_moves += total;
          fed = true;
        }
      }
      if (fed) feed_row<T, CW>(c, true, q, a.qsizes, a.Q, K, sm, lane);
    }
    // the tick: the rate EMA, then ProMC's check and move
    if (tick_hit) {
      for (int k = lane; k < K; k += 32) {
        const double inst = (ck.deliv[k] - ck.dat[k]) / period;
        ck.rate[k] = ck.rate[k] == 0.0 ? inst : 0.5 * ck.rate[k] + 0.5 * inst;
        ck.dat[k] = ck.deliv[k];
      }
      __syncwarp();
      if (rc.kind == kKindPromc) {
        // controllers.promc_tick over the post-handler views (every lane)
        row_views<T, CW>(c, ck, rc, sm, K, lane);
        int nlv = 0;
        double mn = INFINITY, mx = -INFINITY;
        for (int k = 0; k < K; ++k) {
          if (!ck.done[k] && ck.brem[k] > 0.0 && ck.nch[k] > 0) {
            ++nlv;
            mn = fmin(mn, ck.eta[k]);
            mx = fmax(mx, ck.eta[k]);
          }
        }
        int fast = -1, slow = -1;
        for (int k = 0; k < K; ++k) {
          const bool lv = !ck.done[k] && ck.brem[k] > 0.0 && ck.nch[k] > 0;
          if (fast < 0 && lv && ck.eta[k] == mn) fast = k;
          if (slow < 0 && lv && ck.eta[k] == mx) slow = k;
        }
        fast = fast < 0 ? 0 : fast;
        slow = slow < 0 ? 0 : slow;
        const double eta_f = ck.eta[fast], eta_s = ck.eta[slow];
        const bool few = nlv < 2;
        const bool wait_meas = !few && !isfinite(eta_s) && ck.rate[slow] == 0.0;
        const bool imb = eta_s >= rc.ratio * eta_f && fast != slow && ck.nch[fast] > 1;
        const bool same = fast == pair_fast && slow == pair_slow;
        const long long upd = imb && same ? streak + 1 : (imb ? 1 : 0);
        const bool fire = !few && !wait_meas && imb && upd >= rc.patience;
        const bool reset = few || fire;
        const bool pair_ok = !wait_meas && !reset && imb;
        streak = wait_meas ? streak : (reset ? 0 : upd);
        pair_fast = wait_meas ? pair_fast : (pair_ok ? fast : -1);
        pair_slow = wait_meas ? pair_slow : (pair_ok ? slow : -1);
        __syncwarp();
        if (fire) {
          // controllers.move_channel: the source's idle-first lowest column
          // closes (a busy victim pushes ceil(rem) on the resume stack),
          // the lowest free column opens for the destination
          const int src = fast, dst = slow;
          bool sel[T];
#pragma unroll
          for (int tt = 0; tt < T; ++tt) sel[tt] = c.ch[tt] == src && !c.busy[tt];
          int victim = lowest<T>(sel);
          if (victim < 0) {
#pragma unroll
            for (int tt = 0; tt < T; ++tt) sel[tt] = c.ch[tt] == src && c.busy[tt];
            victim = lowest<T>(sel);
          }
          victim = victim < 0 ? 0 : victim;
          double vrem = 0.0;
          bool vbusy = false;
#pragma unroll
          for (int tt = 0; tt < T; ++tt) {
            sel[tt] = tt * 32 + lane == victim;
            if (tt == victim >> 5) {
              vrem = __shfl_sync(kFull, c.rem[tt], victim & 31);
              vbusy = __shfl_sync(kFull, c.busy[tt] ? 1 : 0, victim & 31) != 0;
            }
          }
          if (vbusy && vrem > 0.0 && lane == 0) {
            const double size = ceil(vrem);
            ck.qb[src] = ck.qb[src] + size;
            const long long d = ck.pn[src] < 0 ? 0 : (ck.pn[src] > P - 1 ? P - 1 : ck.pn[src]);
            psizes[(long long)src * P + d] = size;
            ck.pn[src] += 1;
          }
          __syncwarp();
          close_compact<T>(c, sel, sm, lane);
#pragma unroll
          for (int tt = 0; tt < T; ++tt) sel[tt] = c.ch[tt] < 0 && tt * 32 + lane < C;
          int fcol = lowest<T>(sel);
          fcol = fcol < 0 ? 0 : fcol;
          const double sc = rc.setup_cost;
          const double cost = ck.par[src] == ck.par[dst] ? 0.25 * sc : sc;
          const double cap_d = ck.capk[dst];
#pragma unroll
          for (int tt = 0; tt < T; ++tt) {
            if (tt * 32 + lane == fcol) {
              c.ch[tt] = dst;
              c.dead[tt] = cost;
              c.cap[tt] = cap_d;
            }
          }
          ++n_moves;
          feed_row<T, CW>(c, true, q, a.qsizes, a.Q, K, sm, lane);
        }
      }
      next_tick = next_tick + period;
    }
    // (g) the done test, then the step cap
    bool all_done = true;
    for (int k = lane; k < K; k += 32) all_done = all_done && ck.done[k] != 0;
    if (__all_sync(kFull, all_done) && (fin_any || comp_any)) {
      finish_t = t;
      row_done = true;
      stop = kStopDone;
      break;
    }
    if (steps >= a.max_steps) {
      stop = kStopCap;
      break;
    }
    __syncwarp();
  }
  __syncwarp();

#pragma unroll
  for (int tt = 0; tt < T; ++tt) {
    const int col = tt * 32 + lane;
    if (col < C) {
      a.busy[rc_ + col] = c.busy[tt];
      a.dead[rc_ + col] = c.dead[tt];
      a.rem[rc_ + col] = c.rem[tt];
      a.cap[rc_ + col] = c.cap[tt];
      a.chunk_of[rc_ + col] = c.ch[tt];
    }
  }
  for (int k = lane; k < K; k += 32) {
    a.qptr[rk + k] = ck.qptr[k];
    a.queue_bytes[rk + k] = ck.qb[k];
    a.prepend_n[rk + k] = ck.pn[k];
    a.chunk_done[rk + k] = ck.done[k] != 0;
    a.completed_at[rk + k] = ck.cat[k];
    a.delivered[rk + k] = ck.deliv[k];
    a.delivered_at_tick[rk + k] = ck.dat[k];
    a.rate_est[rk + k] = ck.rate[k];
  }
  if (lane == 0) {
    a.t[row] = t;
    a.n_events[row] = n_events;
    a.fin_any[row] = fin_any;
    a.next_tick[row] = next_tick;
    a.done[row] = a.done[row] || row_done;
    a.finish_t[row] = finish_t;
    a.sc_cursor[row] = cursor;
    a.streak[row] = streak;
    a.pair_fast[row] = pair_fast;
    a.pair_slow[row] = pair_slow;
    a.n_moves[row] = n_moves;
    a.tl_len[row] = tl_len;
    a.tl_stride[row] = tl_stride;
    a.tl_seen[row] = tl_seen;
    a.tl_last_t[row] = tl_last_t;
    a.tl_last_rate[row] = tl_last_rate;
    a.steps[row] = steps;
    a.stop[row] = stop;
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

// `ptrs`: the kRoundOperands operands in RoundArgs order, every tensor
// contiguous on the current device (S rows, C channels, K chunks, B profile
// steps, Q file sizes, P resume-stack depth, TL timeline samples). Each
// active row takes 1 to max_steps steps. Returns the launch's cudaError_t.
extern "C" int fused_rounds_f64(void* const* ptrs, long long S, long long C, long long K,
                                long long B, long long Q, long long P, long long TL,
                                long long max_steps, void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (C <= 0 || K <= 0 || K > 1024 || B <= 0 || Q <= 0 || P <= 0 || TL <= 0 ||
      max_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RoundArgs a;
  int i = 0;
  auto next = [&]() { return ptrs[i++]; };
  a.act = static_cast<const bool*>(next());
  a.tick_period = static_cast<const double*>(next());
  a.max_time = static_cast<const double*>(next());
  a.record = static_cast<const bool*>(next());
  a.kind = static_cast<const long long*>(next());
  a.trivial_complete = static_cast<const bool*>(next());
  a.n_chunks = static_cast<const long long*>(next());
  a.bw = static_cast<const double*>(next());
  a.disk_rate = static_cast<const double*>(next());
  a.sat_cc = static_cast<const long long*>(next());
  a.contention = static_cast<const double*>(next());
  a.setup_cost = static_cast<const double*>(next());
  a.promc_ratio = static_cast<const double*>(next());
  a.promc_patience = static_cast<const long long*>(next());
  a.prof_t = static_cast<const double*>(next());
  a.prof_mult = static_cast<const double*>(next());
  a.qoff = static_cast<const long long*>(next());
  a.qlen = static_cast<const long long*>(next());
  a.fsdt = static_cast<const double*>(next());
  a.nfiles = static_cast<const long long*>(next());
  a.sc_order = static_cast<const long long*>(next());
  a.conc = static_cast<const long long*>(next());
  a.par = static_cast<const long long*>(next());
  a.cap_k = static_cast<const double*>(next());
  a.avg_fs_k = static_cast<const double*>(next());
  a.qsizes = static_cast<const double*>(next());
  a.t = static_cast<double*>(next());
  a.n_events = static_cast<long long*>(next());
  a.fin_any = static_cast<bool*>(next());
  a.next_tick = static_cast<double*>(next());
  a.done = static_cast<bool*>(next());
  a.finish_t = static_cast<double*>(next());
  a.sc_cursor = static_cast<long long*>(next());
  a.streak = static_cast<long long*>(next());
  a.pair_fast = static_cast<long long*>(next());
  a.pair_slow = static_cast<long long*>(next());
  a.n_moves = static_cast<long long*>(next());
  a.busy = static_cast<bool*>(next());
  a.dead = static_cast<double*>(next());
  a.rem = static_cast<double*>(next());
  a.cap = static_cast<double*>(next());
  a.chunk_of = static_cast<long long*>(next());
  a.qptr = static_cast<long long*>(next());
  a.queue_bytes = static_cast<double*>(next());
  a.prepend_n = static_cast<long long*>(next());
  a.chunk_done = static_cast<bool*>(next());
  a.completed_at = static_cast<double*>(next());
  a.delivered = static_cast<double*>(next());
  a.delivered_at_tick = static_cast<double*>(next());
  a.rate_est = static_cast<double*>(next());
  a.prepend_sizes = static_cast<double*>(next());
  a.tl_t = static_cast<double*>(next());
  a.tl_rate = static_cast<double*>(next());
  a.tl_len = static_cast<long long*>(next());
  a.tl_stride = static_cast<long long*>(next());
  a.tl_seen = static_cast<long long*>(next());
  a.tl_last_t = static_cast<double*>(next());
  a.tl_last_rate = static_cast<double*>(next());
  a.steps = static_cast<long long*>(next());
  a.stop = static_cast<long long*>(next());
  if (i != kRoundOperands) return (int)cudaErrorInvalidValue;
  a.S = S;
  a.Q = Q;
  a.max_steps = max_steps;
  a.C = (int)C;
  a.K = (int)K;
  a.B = (int)B;
  a.P = (int)P;
  a.TL = (int)TL;
  a.warps = 0;
  FUSED_DISPATCH(launch_rounds, a, C, static_cast<cudaStream_t>(stream));
}
