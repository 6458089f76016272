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
// Entry points (fused_rounds_coupled_f64, the loop for shared fabrics, and
// its probe build fused_rounds_coupled_probe_f64, with SM cycles by phase of
// a group step (enum CoupledPhase), have their section below):
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
//     driver's own tensors are updated in place; `reuses` gets each row's
//     steps that took the last step's water level;
//   * fused_rounds_probe_f64, the same loop for rows of C <= 32 with SM
//     cycles by step phase (enum Phase) added into an (S, kPhases) output.
// bool tensors are 1 byte, int64 stays int64.
//
// What bounds it on an H100: latency, not bytes. A row moves ~40 bytes per
// channel and ~50 per chunk a step, but a step is a chain of dependent
// warp-wide steps, the sweep runs one step after another, and the full grid
// waits on its longest rows (14,834 steps, nearly all of them ticks on one
// channel). Each row has one warp; its channels stay in registers from the
// first load to the last store (lanes stride over C; the bucketed C is
// 4..32, one tile; a compaction stages them through shared memory), its
// per-chunk state in shared memory for the whole launch. The probe build
// (fused_rounds_probe_f64) reads clock64() at the phase boundaries of each
// step. On that longest row the step of the first port took 14,163 SM
// cycles: 8,608 in the water level (16 rounds of the 32-way descent,
// water_level), then the feed (1,501), the transition (1,453), the
// after-step sums (1,028) and the horizon (713). The step now:
//   * keeps what the next step may take again (RowCache): the water level
//     and its rate sum, the caps' total and largest, the disk aggregate and
//     the profile lookup, each taken only when its inputs are bit for bit
//     the last ones' (on a tick of a row whose files run on, all of them);
//   * skips the feed where no column can take a file;
//   * sums per chunk over a ballot of the columns that carry something, in
//     column order (each_column), and reads the busy columns only when a
//     chunk is drained;
//   * takes the horizon's min in two 32-bit reductions (warp_min_nonneg)
//     and keeps a zero dividend off the division's slow routine (quot).
// That row's step is ~3,300 cycles; the transition (~950, the tick's rate
// EMA) and the after-step sums (~830) lead it, each a short chain of shared
// loads, shuffles and float64 operations whose latency the split does not
// break down further (PERF.md §5). The transition's decisions (laggard
// grants, the ProMC check, the SC guard's walk) are serial loops over K,
// on lane 0 or on every lane alike; they run only on steps with a
// completion or a tick. Any C up to 1024 and K up to 1024 is handled
// (fewer warps a block where the shared memory needs it); the wrapper
// refuses larger shapes.
#include <climits>
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

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// n / d, bit for bit: a zero n over a positive d is n itself (+-0 / d >
// 0 is +-0). The division's fast path refuses a zero or tiny dividend and
// calls its slow routine, which the loop would otherwise take at every
// tick for each chunk that delivered nothing.
__device__ __forceinline__ double quot(double n, double d) {
  if (n == 0.0 && d > 0.0) return n;
  return n / d;
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
struct CacheSmem;

struct WarpSmem {
  CacheSmem* cache;  // the row's cached step values (RowCache)
  double* col_c;     // the row's cached caps (RowCache)
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

// What a row's steps keep from one step to the next for a launch (it
// starts empty at each). Each cached value is a pure function of inputs it
// is kept with, and is taken again only when those inputs are bit for bit
// the same, so a step's results do not depend on it:
//   * the water level is a function of the transferring caps (their total
//     and largest are theirs) and pool_eff: a step whose caps and pool_eff
//     are the last ones' takes the last level and rate sum (rates are
//     min(cap, level)) without the descent (`reuses` counts these steps);
//   * the disk aggregate of disk_pool is a function of n_t;
//   * the bandwidth profile's multiplier and next step stay those of the
//     last lookup while t (which never decreases) is below that next step.
// Everything lives in the warp's shared memory (registers are scarce
// around the 32-column descent and in wide rows): the caps a lane its own
// columns', the warp-uniform values written by every lane alike, each lane
// reading back its own write.
struct CacheSmem {
  double total, hi;                 // the cached caps' sum and largest
  double pool_eff, level, rsum;     // the level they give, its rate sum
  double agg;                       // the disk aggregate at n_t
  double prof_bw, prof_next;        // the profile's bandwidth until prof_next
  long long n_t;
};
constexpr size_t kCacheBytes = sizeof(CacheSmem);

template <int T>
struct RowCache {
  CacheSmem* sh;
  double* caps;          // the last step's transferring caps, a padded column each
  long long reuses = 0;
  bool valid = false;    // the level belongs to caps
  bool same = false;     // this step's caps are caps (row_load)
  bool hit = false;      // this step took the cached level (row_level)
  bool prof = false;     // prof_bw and prof_next hold a lookup
  __device__ RowCache(CacheSmem* s, double* c) : sh(s), caps(c) {
    if (s != nullptr) s->n_t = -1;  // no aggregate yet
  }
};

__device__ __forceinline__ long long bits(double x) { return __double_as_longlong(x); }

// Columns a per-chunk loop walks: the padded tile of a one-tile row (CW),
// else every padded column. Padding columns hold chunk -1.
template <int T, int CW>
constexpr int kLoopCols = CW > 0 ? CW : 32 * T;

// Visits the columns of the ballot `m` of a tile in column order: f(src)
// for each set lane src. With the same m on every lane the trip count is
// the same on every lane, so shuffles inside f run converged.
template <typename F>
__device__ __forceinline__ void each_column(unsigned m, F f) {
  for (; m != 0u; m &= m - 1u) f(__ffs(m) - 1);
}

// The least of the lanes' x (warp_min's value, bit for bit, when no x is
// negative, -0 or NaN): the unsigned order of the bits of doubles in
// [+0, +inf] is their numeric order, so two 32-bit reductions give the
// least bits (the high words', then the low words' among lanes of that
// high word). Any other x takes warp_min.
__device__ __forceinline__ double warp_min_nonneg(double x) {
  const long long b = bits(x);
  if (__any_sync(kFull, b < 0 || x != x)) return warp_min(x);
  const unsigned hi = (unsigned)((unsigned long long)b >> 32), lo = (unsigned)b;
  const unsigned hmin = __reduce_min_sync(kFull, hi);
  const unsigned lmin = __reduce_min_sync(kFull, hi == hmin ? lo : 0xffffffffu);
  return __longlong_as_double((long long)(((unsigned long long)hmin << 32) | lmin));
}

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
template <int T>
__device__ __forceinline__ void feed_row(Channels<T>& c, bool enabled, const Queues& q,
                                         const double* qsizes, long long Q, int K,
                                         const WarpSmem& sm, int lane) {
  // A column can take a file when it is idle, open and enabled and its
  // chunk holds a resume file or a queued one. Where none can, no column is
  // valid below: busy and rem keep their values, dead adds 0.0, and each
  // chunk's qptr + 0 and pn - 0 are qptr and pn and qb - 0.0 is qb bit for
  // bit (x - (+0) = x for every x, -0 included), so the feed is skipped.
  bool can = false;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    // a column outside the chunk table has no queue to feed from
    const int k = c.ch[t];
    if (k >= 0 && k < K && !c.busy[t] && enabled) {
      can = can || (q.pn != nullptr && q.pn[k] > 0) || q.qptr[k] < q.qlen[k];
    }
  }
  if (!__any_sync(kFull, can)) {
#pragma unroll
    for (int t = 0; t < T; ++t) c.dead[t] = c.dead[t] + 0.0;
    for (int k = lane; k < K; k += 32) {  // the one-step kernel writes new tensors
      if (q.qptr_out != q.qptr) q.qptr_out[k] = q.qptr[k];
      if (q.qb_out != q.qb) q.qb_out[k] = q.qb[k];
    }
    return;
  }
  if constexpr (T > 1) {
    for (int k = lane; k < K; k += 32) sm.base[k] = 0;
    __syncwarp();
  }
  const unsigned lt = (1u << lane) - 1u;
  unsigned m_fed[T];  // the columns fed, a ballot a tile
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t * 32 + lane;
    const int k = c.ch[t];
    const bool idle = k >= 0 && k < K && !c.busy[t] && enabled;  // busy[t] is still the step's
    const unsigned grp = __match_any_sync(kFull, idle ? k : -2 - lane);  // non-idle match none
    int rank = idle ? __popc(grp & lt) : -1;
    if constexpr (T > 1) {  // idle channels of the chunk in earlier tiles
      if (idle) rank += sm.base[k];
      __syncwarp();
      if (idle && (grp & lt) == 0) sm.base[k] += __popc(grp);
      __syncwarp();
    }
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
    m_fed[t] = __ballot_sync(kFull, valid);
    sm.col_f[col] = sz;
    sm.col_k[col] = valid && !pre ? k : -1;
    sm.col_b[col] = pre ? k : -1;
  }
  __syncwarp();
  // files and bytes fed per chunk, over the columns that fed it in column
  // order (sizes are integer-valued doubles: the sum is exact)
  for (int k = lane; k < K; k += 32) {
    long long cnt = 0, popped = 0;
    double fed = 0.0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      each_column(m_fed[t], [&](int src) {
        const int col = t * 32 + src;
        if (sm.col_k[col] == k) {
          ++cnt;
          fed += sm.col_f[col];
        }
        if (sm.col_b[col] == k) {
          ++popped;
          fed += sm.col_f[col];
        }
      });
    }
    q.qptr_out[k] = q.qptr[k] + cnt;
    q.qb_out[k] = q.qb[k] - fed;
    if (q.pn != nullptr) q.pn[k] -= popped;
  }
  __syncwarp();
}

// A step's first part (read only): the transferring channels, their caps
// and the row's rate pool (disk_pool); the caps' total (summed lane by
// lane, then the butterfly) and largest in the cache, taken again when the
// caps are its own (cache.same).
template <int T>
__device__ __forceinline__ double row_load(const Channels<T>& c, const Link& link, bool (&tr)[T],
                                           double (&caps)[T], RowCache<T>& cache, int lane) {
  long long n_t = 0;
  bool eq = cache.valid;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    tr[t] = c.busy[t] && c.dead[t] <= kEps;
    caps[t] = tr[t] ? c.cap[t] : 0.0;
    n_t += __popc(__ballot_sync(kFull, tr[t]));
    eq = eq && bits(caps[t]) == bits(cache.caps[t * 32 + lane]);
  }
  cache.same = __all_sync(kFull, eq);
  if (!cache.same) {
    double total = 0.0, hi = 0.0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      total += caps[t];
      hi = fmax(hi, caps[t]);
      cache.caps[t * 32 + lane] = caps[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // the sum's and the max's butterflies, side by side
      total += __shfl_xor_sync(kFull, total, o);
      hi = fmax(hi, __shfl_xor_sync(kFull, hi, o));
    }
    cache.sh->total = total;
    cache.sh->hi = hi;
    cache.valid = false;
  }

  // ---- disk_pool ----
  double agg;
  if (n_t != cache.sh->n_t) {
    const long long over = n_t - link.sat_cc > 0 ? n_t - link.sat_cc : 0;
    agg = link.disk_rate / (1.0 + link.contention * (double)over);
    cache.sh->agg = agg;
    cache.sh->n_t = n_t;
  } else {
    agg = cache.sh->agg;
  }
  return n_t > 0 ? fmin(link.bw, agg) : 0.0;
}

// A step's water level: the level of the transferring caps under `pool`
// (the water-fill), the cached one when its caps and pool_eff are this
// step's bit for bit.
template <int T, int CW>
__device__ __forceinline__ double row_level(const double (&caps)[T], double pool,
                                            RowCache<T>& cache, double* col_f, int lane) {
  CacheSmem& sh = *cache.sh;
  const double pool_eff = fmax(fmin(pool, sh.total), 0.0);
  cache.hit = cache.same && bits(pool_eff) == bits(sh.pool_eff);
  if (cache.hit) {
    ++cache.reuses;
    return sh.level;
  }
  const double level = water_level<T, CW>(caps, sh.hi, pool_eff, col_f, lane);
  sh.level = level;
  sh.pool_eff = pool_eff;
  cache.valid = true;
  return level;
}

// A step's rates under `level` and their sum (the cached one with the
// cached level), and the row's horizon dt (event_horizon; 0 when not
// enabled).
template <int T>
__device__ __forceinline__ double row_horizon(const Channels<T>& c, const bool (&tr)[T],
                                              const double (&caps)[T], double level, bool enabled,
                                              double tick_dt, double (&rate)[T], double& rsum,
                                              RowCache<T>& cache) {
  double horizon = INFINITY;
  rsum = 0.0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    rate[t] = enabled ? fmin(caps[t], level) : 0.0;
    rsum += rate[t];
    // ---- event_horizon ----
    const double dead_evt = (c.busy[t] && c.dead[t] > kEps) ? c.dead[t] : INFINITY;
    const bool xcond = tr[t] && rate[t] > kEps;
    const double xfer_evt = xcond ? quot(c.rem[t], rate[t]) : INFINITY;
    horizon = fmin(horizon, fmin(dead_evt, xfer_evt));
  }
  // every horizon is a dead time > kEps, rem / rate with rem >= 0 and
  // rate > kEps, or inf: warp_min_nonneg is warp_min's value
  horizon = warp_min_nonneg(horizon);
  if (cache.hit && enabled) {
    rsum = cache.sh->rsum;
  } else {
    rsum = warp_sum(rsum);
    if (enabled) cache.sh->rsum = rsum;
  }
  const double dt = fmin(tick_dt, horizon);
  return enabled ? fmax(dt, 0.0) : 0.0;
}

// A step's advance (advance_channels): the channels advance by dt at
// `rate` in place, `moved` gets each column's moved bytes; returns whether
// a file finished.
template <int T>
__device__ __forceinline__ bool row_move(Channels<T>& c, const bool (&tr)[T],
                                         const double (&rate)[T], double dt, bool enabled,
                                         double (&moved)[T]) {
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
  return __any_sync(kFull, fin_any);
}

// One step of a row: the channels in `c` advance and are fed in place,
// `moved` gets each column's moved bytes, the chunk queues in `q` advance.
template <int T, int CW>
__device__ __forceinline__ Step row_step(Channels<T>& c, double (&moved)[T], bool enabled,
                                         double tick_dt, const Link& link, const Queues& q,
                                         const double* qsizes, long long Q, int K,
                                         const WarpSmem& sm, int lane) {
  bool tr[T];
  double caps[T], rate[T];
  double rsum;
  RowCache<T> cache(sm.cache, sm.col_c);
  const double pool = row_load<T>(c, link, tr, caps, cache, lane);
  const double level = row_level<T, CW>(caps, pool, cache, sm.col_f, lane);
  const double dt = row_horizon<T>(c, tr, caps, level, enabled, tick_dt, rate, rsum, cache);
  const bool fin = row_move<T>(c, tr, rate, dt, enabled, moved);
  feed_row<T>(c, enabled, q, qsizes, Q, K, sm, lane);
  return {dt, rsum, fin};
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

// Shared memory of one warp: the row cache's values, col_c and col_f (8
// bytes a padded column each), col_k and col_b (4 each), base (4 a chunk),
// rounded up to 8 bytes.
__host__ __device__ inline size_t step_warp_bytes(int T, int K) {
  return kCacheBytes + ((size_t)768 * T + (size_t)4 * K + 7) / 8 * 8;
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
  sm.cache = reinterpret_cast<CacheSmem*>(w);
  sm.col_c = reinterpret_cast<double*>(w + kCacheBytes);
  sm.col_f = sm.col_c + 32 * T;
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
  const bool* trivial_tick;
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
  long long* reuses;
  long long* cycles;  // the probe build's (S, kPhases) phase cycles, else unused
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
constexpr int kRoundOperands = 62;

// the driver's kind codes and the loop's stop codes (transition.STOP_*)
constexpr long long kKindCustom = -1, kKindSc = 2, kKindMc = 3;
constexpr long long kStopDone = 1, kStopCap = 2, kStopGuard = 3, kStopError = 4;
constexpr long long kStopCustom = 6;

// A row's per-chunk state in shared memory for the whole launch, and the
// handlers' per-chunk scratch.
struct ChunkSmem {
  long long *qoff, *qlen, *qptr, *pn;
  double *qb, *fsdt, *deliv, *dat, *rate, *cat, *capk, *avgfs, *brem, *eta, *egr;
  int *done, *nfiles, *order, *conc, *par, *nch, *grants, *comp, *ord;
};

// Per-chunk arrays of one warp: fifteen of 8 bytes, nine of 4 (with the
// feed's base); per column four of 8 bytes and three of 4; the row
// cache's values.
__host__ __device__ inline size_t round_warp_bytes(int T, int K) {
  return kCacheBytes + (size_t)8 * (128 * T + 15 * K) + (size_t)4 * (96 * T + 10 * K);
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
    const double r0 = fmin(ck.capk[k], quot(pool, (double)total));
    const double t_file = ck.fsdt[k] + quot(ck.avgfs[k], fmax(r0, 1e-9));
    const double pred = quot((double)nn * ck.avgfs[k], t_file);
    // controllers.chunk_eta
    const double r = ck.rate[k] > 0.0 ? ck.rate[k] : pred;
    const double e = r > 0.0 ? quot(br, r) : INFINITY;
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

// A row's scalar loop state, in registers for the whole launch.
struct RowLoop {
  double t, next_tick, finish_t, tl_last_t, tl_last_rate;
  long long n_events, cursor, streak, pair_fast, pair_slow, n_moves;
  long long tl_len, tl_stride, tl_seen, steps;
  bool fin_any;
};

// What a row's loop reads: its constants, its queues (per-chunk state in
// shared memory), its resume stack, timeline ring and profile.
struct RowEnv {
  RowConst rc;
  Queues q;
  double* psizes;
  double* tl_t;
  double* tl_rate;
  const double* prof_t;
  const double* prof_mult;
  const double* qsizes;
  long long Q;
  double period, max_time;
  bool record, trivial_tick, trivial_complete;
  int C, K, B, P, TL;
};

// Carve a warp's shared memory at `w` (round_warp_bytes(T, K) bytes), load
// row `row`'s per-chunk state into it and its channels into `c`.
template <int T>
__device__ __forceinline__ void setup_row(const RoundArgs& a, long long row, unsigned char* w,
                                          WarpSmem& sm, ChunkSmem& ck, Channels<T>& c,
                                          RowEnv& env, RowLoop& st, int lane) {
  const int C = a.C, K = a.K, B = a.B, P = a.P, TL = a.TL;
  const long long rc_ = row * C, rk = row * K, rb = row * B;

  // shared memory: the row cache's values, 8-byte arrays, then 4-byte ones
  sm.cache = reinterpret_cast<CacheSmem*>(w);
  double* f8 = reinterpret_cast<double*>(w + kCacheBytes);
  sm.col_c = f8;
  sm.col_f = sm.col_c + 32 * T;
  sm.col_g = sm.col_f + 32 * T;
  sm.col_h = sm.col_g + 32 * T;
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

  c = load_channels<T>(a.busy + rc_, a.dead + rc_, a.rem + rc_, a.cap + rc_, a.chunk_of + rc_, C,
                       lane);
  env.q = Queues{ck.qoff, ck.qlen, ck.fsdt, ck.qptr, ck.qb, ck.qptr, ck.qb, ck.pn,
                 a.prepend_sizes + rk * P, P};
  env.psizes = a.prepend_sizes + rk * P;
  env.tl_t = a.tl_t + row * TL;
  env.tl_rate = a.tl_rate + row * TL;
  env.prof_t = a.prof_t + rb;
  env.prof_mult = a.prof_mult + rb;
  env.qsizes = a.qsizes;
  env.Q = a.Q;
  env.rc = RowConst{a.kind[row], a.n_chunks[row], a.sat_cc[row], a.promc_patience[row],
                    a.bw[row], a.disk_rate[row], a.contention[row], a.setup_cost[row],
                    a.promc_ratio[row]};
  env.period = a.tick_period[row];
  env.max_time = a.max_time[row];
  env.record = a.record[row];
  env.trivial_tick = a.trivial_tick[row];
  env.trivial_complete = a.trivial_complete[row];
  env.C = C;
  env.K = K;
  env.B = B;
  env.P = P;
  env.TL = TL;
  st.t = a.t[row];
  st.next_tick = a.next_tick[row];
  st.finish_t = a.finish_t[row];
  st.n_events = a.n_events[row];
  st.cursor = a.sc_cursor[row];
  st.streak = a.streak[row];
  st.pair_fast = a.pair_fast[row];
  st.pair_slow = a.pair_slow[row];
  st.n_moves = a.n_moves[row];
  st.tl_len = a.tl_len[row];
  st.tl_stride = a.tl_stride[row];
  st.tl_seen = a.tl_seen[row];
  st.tl_last_t = a.tl_last_t[row];
  st.tl_last_rate = a.tl_last_rate[row];
  st.fin_any = a.fin_any[row];
  st.steps = 0;
}

// Write row `row`'s state back to the driver's tensors.
template <int T>
__device__ __forceinline__ void store_row(const RoundArgs& a, long long row, const Channels<T>& c,
                                          const ChunkSmem& ck, const RowLoop& st, bool row_done,
                                          long long stop, long long reuses, int lane) {
  const int C = a.C, K = a.K;
  const long long rc_ = row * C, rk = row * K;
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
    a.t[row] = st.t;
    a.n_events[row] = st.n_events;
    a.fin_any[row] = st.fin_any;
    a.next_tick[row] = st.next_tick;
    a.done[row] = a.done[row] || row_done;
    a.finish_t[row] = st.finish_t;
    a.sc_cursor[row] = st.cursor;
    a.streak[row] = st.streak;
    a.pair_fast[row] = st.pair_fast;
    a.pair_slow[row] = st.pair_slow;
    a.n_moves[row] = st.n_moves;
    a.tl_len[row] = st.tl_len;
    a.tl_stride[row] = st.tl_stride;
    a.tl_seen[row] = st.tl_seen;
    a.tl_last_t[row] = st.tl_last_t;
    a.tl_last_rate[row] = st.tl_last_rate;
    a.steps[row] = st.steps;
    a.stop[row] = stop;
    a.reuses[row] = reuses;
  }
}

// The error test: past max_time, or a live chunk holding no channel while
// no channel is busy.
template <int T, int CW>
__device__ __forceinline__ bool row_error(const Channels<T>& c, const ChunkSmem& ck,
                                          const WarpSmem& sm, const RowEnv& env,
                                          const RowLoop& st, int lane) {
  if (st.t > env.max_time) return true;
  bool any_busy = false;
#pragma unroll
  for (int tt = 0; tt < T; ++tt) any_busy = any_busy || c.busy[tt];
  if (!__any_sync(kFull, any_busy)) {
    count_open<T, CW>(c, ck, sm, env.K, lane);
    bool str = false;
    for (int k = lane; k < env.K; k += 32) str = str || (!ck.done[k] && ck.nch[k] == 0);
    if (__any_sync(kFull, str)) return true;
  }
  return false;
}

// The bandwidth profile at t: link.bw under the last step at or before t;
// returns the time of the next step (inf past the last). A lookup holds
// while t, which never decreases, stays below that next step: no step lies
// between, so the cached one is taken.
template <int T>
__device__ __forceinline__ double row_profile(const RowEnv& env, double t, Link& link,
                                              RowCache<T>& cache, int lane) {
  double next_prof = INFINITY;
  link.bw = env.rc.bw;
  if (env.B > 1 && cache.prof && t < cache.sh->prof_next) {
    link.bw = cache.sh->prof_bw;
    return cache.sh->prof_next;
  }
  if (env.B > 1) {
    int at = -1;
    for (int b0 = 0; b0 < env.B; b0 += 32) {
      const int b = b0 + lane;
      const double pt = b < env.B ? env.prof_t[b] : INFINITY;
      at += __popc(__ballot_sync(kFull, pt <= t));
      next_prof = fmin(next_prof, pt > t ? pt : INFINITY);
    }
    next_prof = warp_min(next_prof);
    const double mult = env.prof_mult[at < 0 ? 0 : at];
    link.bw = env.rc.bw * (at >= 0 ? mult : 1.0);
    cache.prof = true;
    cache.sh->prof_bw = link.bw;
    cache.sh->prof_next = next_prof;
  }
  return next_prof;
}

// What follows a step before its transition: the timeline ring
// (kernels.timeline_push) at the step's start, the clock and the event
// count, the moved bytes into the chunks' totals in column order, the
// chunks that complete, whether the tick is due, and the capacity guards.
// Returns true at a guard (the row stops with its transition pending for
// the host, which grows the axis).
template <int T, int CW>
__device__ __forceinline__ bool row_after_step(const Channels<T>& c, const double (&moved)[T],
                                               const Step& s, const RowEnv& env, RowLoop& st,
                                               const ChunkSmem& ck, const WarpSmem& sm,
                                               bool& comp_any, bool& tick_hit, int lane) {
  const int K = env.K, TL = env.TL;
  if (env.record) {
    const long long st_safe = st.tl_stride > 1 ? st.tl_stride : 1;
    if (st.tl_seen % st_safe == 0 && st.tl_len >= TL) {
      // keep every other sample; the stride doubles
      const int half = (TL + 1) / 2;
      for (int j0 = 0; j0 < half; j0 += 32) {
        const int j = j0 + lane;
        double vt = 0.0, vr = 0.0;
        if (j < half) {
          vt = env.tl_t[2 * j];
          vr = env.tl_rate[2 * j];
        }
        __syncwarp();
        if (j < half) {
          env.tl_t[j] = vt;
          env.tl_rate[j] = vr;
        }
        __syncwarp();
      }
      for (int j = half + lane; j < TL; j += 32) {
        env.tl_t[j] = 0.0;
        env.tl_rate[j] = 0.0;
      }
      __syncwarp();
      st.tl_len = (st.tl_len + 1) / 2;
      st.tl_stride = st_safe * 2;
    }
    const long long st2 = st.tl_stride > 1 ? st.tl_stride : 1;
    if (st.tl_seen % st2 == 0 && st.tl_len < TL) {
      if (lane == 0) {
        env.tl_t[st.tl_len] = st.t;
        env.tl_rate[st.tl_len] = s.rate_sum;
      }
      ++st.tl_len;
    }
    ++st.tl_seen;
    st.tl_last_t = st.t;
    st.tl_last_rate = s.rate_sum;
    __syncwarp();
  }
  st.t = st.t + s.dt;
  ++st.n_events;
  ++st.steps;
  st.fin_any = s.fin;
  // each chunk's moved bytes into its total, its columns in column order;
  // a chunk whose queue and stack are drained completes when none of its
  // columns is busy (read only when some chunk is drained)
  unsigned m_moved[T], m_busy[T];
#pragma unroll
  for (int tt = 0; tt < T; ++tt) {
    m_moved[tt] = __ballot_sync(kFull, moved[tt] != 0.0);
    m_busy[tt] = __ballot_sync(kFull, c.busy[tt]);
  }
  comp_any = false;
  bool full = false;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    double d = k < K ? ck.deliv[k] : 0.0;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      each_column(m_moved[tt], [&](int src) {
        const double x = __shfl_sync(kFull, moved[tt], src);
        if (__shfl_sync(kFull, c.ch[tt], src) == k) d += x;
      });
    }
    bool cmp = false;
    if (k < K) {
      ck.deliv[k] = d;
      cmp = !ck.done[k] && ck.qlen[k] - ck.qptr[k] + ck.pn[k] == 0;
      full = full || ck.pn[k] >= env.P;
    }
    if (__any_sync(kFull, cmp)) {
#pragma unroll
      for (int tt = 0; tt < T; ++tt) {
        each_column(m_busy[tt], [&](int src) {
          if (__shfl_sync(kFull, c.ch[tt], src) == k) cmp = false;
        });
      }
    }
    if (k < K) ck.comp[k] = cmp;
    comp_any = comp_any || cmp;
  }
  comp_any = __any_sync(kFull, comp_any);
  tick_hit = st.t >= st.next_tick - kEps;
  bool guard = tick_hit && env.rc.kind == kKindPromc && __any_sync(kFull, full);
  if (!guard && env.rc.kind == kKindSc && comp_any) {
    // SC's handlers walked over column counts: free columns at each open
    const int n_open = count_open<T, CW>(c, ck, sm, K, lane);
    int short_ = 0;
    if (lane == 0) {
      long long cur = st.cursor;
      long long free_ = env.C - n_open;
      for (int k = 0; k < K; ++k) {
        if (!ck.comp[k]) continue;
        free_ += ck.nch[k];
        ck.nch[k] = 0;
        cur = sc_advance(cur, ck, env.rc.n_chunks, K);
        if (cur < env.rc.n_chunks) {
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
  return guard;
}

// The transition (transition.post_transition): completions, each completed
// chunk's handler in index order with a re-feed after each, the tick (the
// rate EMA, then ProMC's check and move), and the done test. Returns true
// when the row is done (st.finish_t set).
template <int T, int CW>
__device__ __forceinline__ bool row_transition(Channels<T>& c, bool comp_any, bool tick_hit,
                                               const RowEnv& env, RowLoop& st,
                                               const ChunkSmem& ck, const WarpSmem& sm,
                                               int lane) {
  const RowConst& rc = env.rc;
  const Queues& q = env.q;
  const int C = env.C, K = env.K, P = env.P;
  if (comp_any && (env.trivial_complete || rc.kind >= kKindSc)) {
    for (int k = lane; k < K; k += 32) {
      if (ck.comp[k]) {
        ck.done[k] = 1;
        ck.qb[k] = 0.0;
        ck.cat[k] = st.t;
      }
    }
    __syncwarp();
  }
  const bool ctrl = comp_any && rc.kind >= kKindSc;
  if (ctrl && rc.kind == kKindPromc) {  // ProMC drops its streak evidence
    st.streak = 0;
    st.pair_fast = -1;
    st.pair_slow = -1;
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
      st.cursor = sc_advance(st.cursor, ck, rc.n_chunks, K);
      const long long cursor = st.cursor;
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
        st.n_moves += total;
        fed = true;
      }
    }
    if (fed) feed_row<T>(c, true, q, env.qsizes, env.Q, K, sm, lane);
  }
  // the tick: the rate EMA, then ProMC's check and move
  if (tick_hit) {
    for (int k = lane; k < K; k += 32) {
      const double inst = quot(ck.deliv[k] - ck.dat[k], env.period);
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
      const bool same = fast == st.pair_fast && slow == st.pair_slow;
      const long long upd = imb && same ? st.streak + 1 : (imb ? 1 : 0);
      const bool fire = !few && !wait_meas && imb && upd >= rc.patience;
      const bool reset = few || fire;
      const bool pair_ok = !wait_meas && !reset && imb;
      st.streak = wait_meas ? st.streak : (reset ? 0 : upd);
      st.pair_fast = wait_meas ? st.pair_fast : (pair_ok ? fast : -1);
      st.pair_slow = wait_meas ? st.pair_slow : (pair_ok ? slow : -1);
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
          env.psizes[(long long)src * P + d] = size;
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
        ++st.n_moves;
        feed_row<T>(c, true, q, env.qsizes, env.Q, K, sm, lane);
      }
    }
    st.next_tick = st.next_tick + env.period;
  }
  // the done test (the chunks' flags are read only on a step that
  // finished a file or completed a chunk)
  if (st.fin_any || comp_any) {
    bool all_done = true;
    for (int k = lane; k < K; k += 32) all_done = all_done && ck.done[k] != 0;
    if (__all_sync(kFull, all_done)) {
      st.finish_t = st.t;
      return true;
    }
  }
  return false;
}

// The loop's phases, in the order a step runs them: the probe build
// (fused_rounds_probe_f64) adds each phase's SM cycles into its row of
// RoundArgs::cycles.
enum Phase {
  kPhError, kPhProfile, kPhLoad, kPhLevel, kPhHorizon, kPhAdvance, kPhFeed, kPhAfter,
  kPhTransition, kPhases
};

// The probe's clock: mark(p) adds the cycles since the last mark to phase
// p of N. Every lane reads clock64() (warp-uniform control flow); lane 0's
// sums are written. A mark sits after the phase's last instruction in
// program order; a load still in flight there is waited for in the next
// phase.
template <bool On, int N = kPhases>
struct PhaseClock {
  long long last = 0, acc[N] = {};
  __device__ __forceinline__ void start() { last = clock64(); }
  __device__ __forceinline__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
  // mark(p) right after a barrier: the clock is read only under a
  // predicate on a shared load issued after the barrier (`dep` is never
  // INT_MIN), so that the compiler cannot read it ahead of the barrier.
  __device__ __forceinline__ void mark_after(int p, const volatile int* dep) {
    if (*dep != INT_MIN) mark(p);
  }
  __device__ __forceinline__ void store(long long* out, int lane) const {
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < N; ++p) out[p] = acc[p];
    }
  }
};

template <int N>
struct PhaseClock<false, N> {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void mark_after(int, const volatile int*) {}
  __device__ __forceinline__ void store(long long*, int) const {}
};

template <int T, int CW, bool Probe>
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
      a.reuses[row] = 0;
    }
    return;
  }
  WarpSmem sm;
  ChunkSmem ck;
  Channels<T> c;
  RowEnv env;
  RowLoop st;
  setup_row<T>(a, row, smem + warp * round_warp_bytes(T, a.K), sm, ck, c, env, st, lane);
  Link link{env.rc.bw, env.rc.disk_rate, env.rc.contention, env.rc.sat_cc};
  bool row_done = false;
  long long stop = 0;
  RowCache<T> cache(sm.cache, sm.col_c);
  PhaseClock<Probe> clk;
  clk.start();

  for (;;) {
    // (0) the error test
    if (row_error<T, CW>(c, ck, sm, env, st, lane)) {
      stop = kStopError;
      break;
    }
    clk.mark(kPhError);
    // (a) the bandwidth profile at t
    const double next_prof = row_profile<T>(env, st.t, link, cache, lane);
    clk.mark(kPhProfile);
    // (b) one step: the rate pool, the water level, the rates and the
    // horizon, the advance, then the feed with the resume stack
    bool tr[T];
    double caps[T], rate[T], moved[T];
    double rsum;
    const double pool = row_load<T>(c, link, tr, caps, cache, lane);
    clk.mark(kPhLoad);
    const double level = row_level<T, CW>(caps, pool, cache, sm.col_f, lane);
    clk.mark(kPhLevel);
    const double dt = row_horizon<T>(c, tr, caps, level, true,
                                     fmin(st.next_tick - st.t, next_prof - st.t), rate, rsum,
                                     cache);
    clk.mark(kPhHorizon);
    const bool fin = row_move<T>(c, tr, rate, dt, true, moved);
    clk.mark(kPhAdvance);
    feed_row<T>(c, true, env.q, env.qsizes, env.Q, env.K, sm, lane);
    clk.mark(kPhFeed);
    // (c)-(e) the timeline, the clock, the chunk totals and the guards
    const Step s{dt, rsum, fin};
    bool comp_any, tick_hit;
    if (row_after_step<T, CW>(c, moved, s, env, st, ck, sm, comp_any, tick_hit, lane)) {
      stop = kStopGuard;
      break;
    }
    clk.mark(kPhAfter);
    // a custom-scheduler row stops where an event calls its callbacks: its
    // transition runs on the host (transition.custom_events)
    if (env.rc.kind == kKindCustom &&
        ((comp_any && !env.trivial_complete) || (tick_hit && !env.trivial_tick))) {
      stop = kStopCustom;
      break;
    }
    // (f) the transition and (g) the done test, then the step cap
    if (row_transition<T, CW>(c, comp_any, tick_hit, env, st, ck, sm, lane)) {
      row_done = true;
      stop = kStopDone;
      break;
    }
    if (st.steps >= a.max_steps) {
      stop = kStopCap;
      break;
    }
    __syncwarp();
    clk.mark(kPhTransition);
  }
  __syncwarp();
  store_row<T>(a, row, c, ck, st, row_done, stop, cache.reuses, lane);
  clk.store(a.cycles + row * kPhases, lane);
}

// ---------------------------------------------------------------------------
// fused_rounds_coupled_f64: the loop for batches with shared fabrics
// ---------------------------------------------------------------------------

constexpr int kGroupRows = 8;    // rows (warps) a group may have
constexpr int kGroupLinks = 4;   // links a group may have
constexpr int kCoupledIters = 12;  // Jacobi sweeps (kernels.COUPLED_ITERS)
constexpr long long kStopGroup = 5;
// the solve's lanes are link x row (4 x 8); the exchange's reads take its 8 slots
static_assert(kGroupRows == 8 && kGroupLinks == 4, "a warp is 4 links x 8 rows");

// The fabric layout (kernels.fused_step.fabric_layout): one block a group.
struct CoupledArgs {
  const long long* rows;  // (G, R): the block's rows, -1 past them
  const long long* mask;  // (G, kGroupLinks): bit j = the block's row j rides the link
  const double* cap;      // (G, kGroupLinks): link capacities
  long long* counts;      // (2, G): the Jacobi sweeps each block ran, then the solves it reused
  long long G;
  int R;
};

constexpr int kLevelSlots = 8;   // inputs a member's level memory keeps

// A member's level memory (every row of the coupled loop keeps one, a row
// outside every group too): the last kLevelSlots distinct (caps, pool_eff)
// inputs of its steps in the launch (its caps a lane its own column), each
// with the level they give and its rate sum, and the member's step that
// last took or filled it (0: empty). A member's grant moves with the other
// members' demands and often returns to an earlier value, so the row
// cache's last input alone would send most group steps to some member's
// descent.
struct LevelSlots {
  double caps[kLevelSlots][32];
  double pool_eff[kLevelSlots], level[kLevelSlots], rsum[kLevelSlots];
  int stamp[kLevelSlots];
};

// A block's shared exchange: per member warp its flags (kFlag*) and demand,
// written before barrier A, and its horizon, written before barrier B. The
// slots of a block's warps past its rows (and past R) keep no flag and an
// infinite horizon, so the reads after a barrier take all kGroupRows slots.
// Then each member's level memory.
struct GroupSmem {
  double dem[kGroupRows], gdt[kGroupRows];
  int flags[kGroupRows];
  LevelSlots mem[kGroupRows];
};
constexpr size_t kGroupBytes = (sizeof(GroupSmem) + 7) / 8 * 8;
constexpr int kFlagErr = 1, kFlagLive = 2, kFlagGuard = 4;

// min and max of the solve's values by a compare and a select: where no
// value is NaN or -0 (levels, caps, demands and horizons are +0, positive
// or +inf) they give fmin's and fmax's bits, in less latency than fmin's
// on an H100: the solve's chains of mins run shorter.
__device__ __forceinline__ double dmin(double x, double y) { return y < x ? y : x; }
__device__ __forceinline__ double dmax(double x, double y) { return y > x ? y : x; }

// The least of four values as a tree: min is exact, so with no NaN or -0
// every order gives the same bits; a tree is two latencies deep where a
// chain is four.
__device__ __forceinline__ double min4(const double (&x)[4]) {
  return dmin(dmin(x[0], x[1]), dmin(x[2], x[3]));
}

__device__ __forceinline__ void cmpswap(double& x, double& y) {
  const bool swap = y < x;
  const double lo = swap ? y : x, hi = swap ? x : y;
  x = lo;
  y = hi;
}

// The coupled loop's phases of a group step, in the order a member warp
// runs them: the probe build (fused_rounds_coupled_probe_f64) adds each
// phase's SM cycles into its row of RoundArgs::cycles. kCpWait1 and
// kCpWait2 are the waits at barriers A and B (from a warp's arrival to its
// release); kCpFlags holds the reads of the members' flags and horizons
// after them; kCpSolve the solve's reuse test and its grant, and
// kCpExchange .. kCpTest its sweeps: the levels' exchange and the caps'
// shuffles, the sort, the prefix and candidates, the ballot and the
// fixed-point test.
enum CoupledPhase {
  kCpError, kCpProfile, kCpDemand, kCpWait1, kCpFlags, kCpSolve, kCpExchange, kCpSort,
  kCpPrefix, kCpTest, kCpLevel, kCpHorizon, kCpWait2, kCpAdvance, kCpFeed, kCpAfterStep,
  kCpTransition, kCpPhases
};

// The group's link grants (kernels.waterfill_coupled), on one warp: lane
// l * 8 + j holds link l and, in each sweep, the cap of the group's row j
// (demand dj) on it, then sorted position j. Per sweep each lane takes row
// j's lowest level among its other links (a shuffle a link), caps it at its
// demand (0 off the link), sorts link l's R caps (every lane of the link the
// same network), sums the sorted prefix before position j in order
// (cumsum's), and tests the candidate level (pool_eff - prefix) / (R - j)
// against the sorted cap (exactly, as _level_of_prefix does); the link's
// first valid position gives its level,
// +inf where the link's capacity covers the total. A lane past the rows
// (j >= R) divides by 1 (its candidate is never valid), and a zero dividend
// (a link without demand) takes quot's exact shortcut: no lane calls the
// division's slow routine. A sweep whose levels equal the last is the fixed
// point: the sweeps stop there, as 12 would end. Returns row w's grant,
// min(demand_w, the lowest level of its links), on every lane, and adds the
// sweeps run into `sweeps`; `clk` splits the sweeps (the probe build).
template <typename Clock>
__device__ __forceinline__ double coupled_grant(double dj, const long long (&m)[kGroupLinks],
                                                double capl, int R, int w, int lane,
                                                long long& sweeps, Clock& clk) {
  const int l = lane >> 3, j = lane & 7;
  const bool rowj = j < R;
  const bool mem = rowj && ((m[l] >> j) & 1);
  const double den = rowj ? (double)(R - j) : 1.0;
  double level = INFINITY;
  int it = 0;
  // the first sweep's levels are all +inf: each cap is the row's demand
  double cap = mem ? dj : 0.0;
  clk.mark(kCpSolve);
  for (;;) {
    double v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const double x = __shfl_sync(kFull, cap, (l << 3) + i);
      v[i] = i < R ? x : INFINITY;
    }
    clk.mark(kCpExchange);
    cmpswap(v[0], v[2]); cmpswap(v[1], v[3]); cmpswap(v[4], v[6]); cmpswap(v[5], v[7]);
    cmpswap(v[0], v[4]); cmpswap(v[1], v[5]); cmpswap(v[2], v[6]); cmpswap(v[3], v[7]);
    cmpswap(v[0], v[1]); cmpswap(v[2], v[3]); cmpswap(v[4], v[5]); cmpswap(v[6], v[7]);
    cmpswap(v[2], v[4]); cmpswap(v[3], v[5]);
    cmpswap(v[1], v[4]); cmpswap(v[3], v[6]);
    cmpswap(v[1], v[2]); cmpswap(v[3], v[4]); cmpswap(v[5], v[6]);
    clk.mark(kCpSort);
    double prev = 0.0, total = 0.0, vj = 0.0, vlast = 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < j) prev = prev + v[i];
      if (i < R) total = total + v[i];
      if (i == j) vj = v[i];
      if (i == R - 1) vlast = v[i];
    }
    const double pool_eff = dmax(dmin(capl, total), 0.0);
    const double lam = quot(pool_eff - prev, den);
    const bool valid = rowj && lam <= vj;
    clk.mark(kCpPrefix);
    const unsigned vb = (__ballot_sync(kFull, valid) >> (l << 3)) & 0xffu;
    const int k = vb ? __ffs(vb) - 1 : 0;
    const double lk = __shfl_sync(kFull, lam, (l << 3) + k);
    const double next = capl >= total ? INFINITY : (vb ? lk : vlast);
    const bool same = __all_sync(kFull, next == level);
    level = next;
    ++it;
    clk.mark(kCpTest);
    if (same || it == kCoupledIters) break;
    double lv[kGroupLinks];
#pragma unroll
    for (int l2 = 0; l2 < kGroupLinks; ++l2) {
      const double x = __shfl_sync(kFull, level, l2 * 8);
      lv[l2] = l2 != l && ((m[l2] >> j) & 1) ? x : INFINITY;
    }
    cap = mem ? dmin(dj, min4(lv)) : 0.0;
  }
  sweeps += it;
  double lv[kGroupLinks];
#pragma unroll
  for (int l2 = 0; l2 < kGroupLinks; ++l2) {
    const double x = __shfl_sync(kFull, level, l2 * 8);
    lv[l2] = (m[l2] >> j) & 1 ? x : INFINITY;
  }
  return __shfl_sync(kFull, dmin(dj, min4(lv)), w);  // lane w: l = 0, j = w
}

// A member's water level under its grant (row_level's, for one tile): the
// level its memory `mem` holds for this step's caps and pool_eff bit for
// bit, else the descent, which the least recently used slot (an empty one
// first, the lowest of equals) then keeps; `stamp` (> 0) is this step's.
// The level and its rate sum are functions of those inputs alone, so a
// step's results do not depend on the memory; `reuses` counts the steps it
// serves. The lookup runs across the lanes at once: each lane compares its
// own column of every slot's caps (one AND over the warp gives the slots
// whose caps are this step's), lane e slot e's stamp and pool_eff (one
// ballot); the victim is a min over the slots' stamps. Sets cache.hit
// (and, on a hit, cache.sh->rsum for row_horizon) and `slot`, the slot
// that served or took the level (its rate sum goes there on a miss). The
// row cache's caps and their sums stay row_load's (cache.valid).
template <int CW>
__device__ __forceinline__ double coupled_level(const double (&caps)[1], double grant,
                                                RowCache<1>& cache, LevelSlots& mem, int stamp,
                                                int& slot, double* col_f, int lane) {
  static_assert(kLevelSlots <= 32, "a lane a slot");
  CacheSmem& sh = *cache.sh;
  const double pool_eff = fmax(fmin(grant, sh.total), 0.0);
  unsigned cols = 0u;  // the slots whose caps hold this lane's column
#pragma unroll
  for (int e = 0; e < kLevelSlots; ++e) {
    cols |= (bits(mem.caps[e][lane]) == bits(caps[0]) ? 1u : 0u) << e;
  }
  const int own = lane < kLevelSlots ? mem.stamp[lane] : INT_MAX;
  const bool keyed = lane < kLevelSlots && own > 0 && bits(mem.pool_eff[lane]) == bits(pool_eff);
  const unsigned hits = __reduce_and_sync(kFull, cols) & __ballot_sync(kFull, keyed);
  cache.valid = true;
  cache.hit = hits != 0u;
  if (cache.hit) {
    const int e = __ffs(hits) - 1;
    ++cache.reuses;
    mem.stamp[e] = stamp;
    sh.rsum = mem.rsum[e];
    slot = e;
    return mem.level[e];
  }
  const double level = water_level<1, CW>(caps, sh.hi, pool_eff, col_f, lane);
  const int v = __ffs(__ballot_sync(kFull, own == __reduce_min_sync(kFull, own))) - 1;
  mem.caps[v][lane] = caps[0];
  mem.pool_eff[v] = pool_eff;
  mem.level[v] = level;
  mem.stamp[v] = stamp;
  slot = v;
  return level;
}

// One block a fabric group, one warp a member row (R warps, the widest
// group's; a block's warps past its rows take part in its barriers only).
// A group step has two barriers:
//   (1) each live member's error test, profile and demand, min(pool,
//       total), into the exchange with its flags (in error, live, at a
//       capacity guard in the last step); barrier A; every warp reads all
//       flags: a guard stops the group (the last step's transitions taken),
//       then the step cap, then a member in error (before the step), then a
//       group with no live member;
//   (2) every live member (and warp 0, which counts) takes the link grants
//       itself, the same code on the same demands giving the same grants
//       on every warp: the solve (coupled_grant), or, where every member's
//       demand is bit for bit the last solve's, the last solve's grant (the
//       solve is a function of the demands alone; `counts` gets the reused
//       solves beside the sweeps); then its rates under its grant (a row
//       outside every group: its pool), the level from its level memory
//       (coupled_level), and its own horizon; barrier B;
//   (3) each live member advances by the least horizon of the group's live
//       members, takes what follows the step and, unless it met a capacity
//       guard, its transition: a guard is seen by the others at the next
//       barrier A, after their transitions, as the plain version stops.
// A finished member stays in the block with zero demand. The group stops
// when every member is done or after max_steps group steps. Every loop
// condition after a barrier is read from shared memory written before it,
// so it is uniform across the block; a slot is written again only after
// the other barrier, which every reader of it has passed.
template <int CW, bool Probe>
__global__ void __launch_bounds__(32 * kGroupRows) fused_rounds_coupled_kernel(RoundArgs a,
                                                                               CoupledArgs f) {
  constexpr int T = 1;
  extern __shared__ __align__(8) unsigned char smem[];
  GroupSmem& gs = *reinterpret_cast<GroupSmem*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = blockIdx.x;
  const long long row = f.rows[g * f.R + warp];
  const bool act = row >= 0 && a.act[row];
  int nrows = 0;
  for (int i = 0; i < f.R; ++i) nrows += f.rows[g * f.R + i] >= 0 ? 1 : 0;
  long long m[kGroupLinks];
  bool has_links = false;
#pragma unroll
  for (int l = 0; l < kGroupLinks; ++l) {
    m[l] = f.mask[g * kGroupLinks + l];
    has_links = has_links || m[l] != 0;
  }
  const double capl = f.cap[g * kGroupLinks + (lane >> 3)];
  if (warp == 0 && lane >= f.R && lane < kGroupRows) {  // slots of no warp
    gs.flags[lane] = 0;
    gs.dem[lane] = 0.0;
    gs.gdt[lane] = INFINITY;
  }
  LevelSlots& mem = gs.mem[warp];
  if (lane < kLevelSlots) mem.stamp[lane] = 0;
  __syncwarp();

  WarpSmem sm{};
  ChunkSmem ck{};
  Channels<T> c{};
  RowEnv env{};
  RowLoop st{};
  if (act) {
    setup_row<T>(a, row, smem + kGroupBytes + warp * round_warp_bytes(T, a.K), sm, ck, c, env,
                 st, lane);
  }
  Link link{env.rc.bw, env.rc.disk_rate, env.rc.contention, env.rc.sat_cc};
  RowCache<T> cache(act ? sm.cache : nullptr, sm.col_c);
  bool live = act, row_done = false, guard = false;
  long long stop = 0, gsteps = 0, nsweeps = 0, nreused = 0;
  // the last solve's demand of the lane's row (lane & 7) and row warp's grant
  bool solved = false;
  double last_dj = 0.0, last_grant = 0.0;
  PhaseClock<Probe, kCpPhases> clk;
  clk.start();

  for (;;) {
    // (1) the error test, the profile and the demand
    int err = 0;
    bool tr[T];
    double caps[T];
    double pool = 0.0, next_prof = INFINITY;
    if (live && !guard) {
      err = row_error<T, CW>(c, ck, sm, env, st, lane) ? 1 : 0;
      clk.mark(kCpError);
      if (!err) {
        next_prof = row_profile<T>(env, st.t, link, cache, lane);
        clk.mark(kCpProfile);
        pool = row_load<T>(c, link, tr, caps, cache, lane);
      }
    }
    const bool steps_now = live && !guard && !err;
    if (lane == 0) {
      gs.flags[warp] =
          (err ? kFlagErr : 0) | (steps_now ? kFlagLive : 0) | (guard ? kFlagGuard : 0);
      gs.dem[warp] = steps_now ? fmin(pool, cache.sh->total) : 0.0;
    }
    clk.mark(kCpDemand);
    __syncthreads();  // barrier A
    clk.mark_after(kCpWait1, &gs.flags[warp]);
    int any = 0;
#pragma unroll
    for (int w = 0; w < kGroupRows; ++w) any |= gs.flags[w];
    clk.mark(kCpFlags);
    if (any & kFlagGuard) {
      if (live) stop = guard ? kStopGuard : kStopGroup;
      break;
    }
    if (gsteps >= a.max_steps) {
      if (live) stop = kStopCap;
      break;
    }
    if (any & kFlagErr) {
      if (live) stop = err ? kStopError : kStopGroup;
      break;
    }
    if (!(any & kFlagLive)) break;
    // (2) the group's link grants, then the rates under the grant and the
    // row's own horizon
    double grant = pool;
    if (has_links && (live || warp == 0)) {
      const double dj = (lane & 7) < nrows ? gs.dem[lane & 7] : 0.0;
      if (solved && __all_sync(kFull, bits(dj) == bits(last_dj))) {
        grant = last_grant;
        ++nreused;
      } else {
        grant = coupled_grant(dj, m, capl, nrows, warp, lane, nsweeps, clk);
        last_dj = dj;
        last_grant = grant;
        solved = true;
      }
    }
    clk.mark(kCpSolve);
    double rate[T];
    double rsum = 0.0, dt = 0.0;
    if (live) {
      int slot = 0;
      const double level =
          coupled_level<CW>(caps, grant, cache, mem, (int)gsteps + 1, slot, sm.col_f, lane);
      clk.mark(kCpLevel);
      dt = row_horizon<T>(c, tr, caps, level, true, fmin(st.next_tick - st.t, next_prof - st.t),
                          rate, rsum, cache);
      if (!cache.hit) mem.rsum[slot] = rsum;
    }
    if (lane == 0) gs.gdt[warp] = live ? dt : INFINITY;
    clk.mark(kCpHorizon);
    __syncthreads();  // barrier B
    clk.mark_after(kCpWait2, &gs.flags[warp]);
    const double gdt = dmin(min4({gs.gdt[0], gs.gdt[1], gs.gdt[2], gs.gdt[3]}),
                            min4({gs.gdt[4], gs.gdt[5], gs.gdt[6], gs.gdt[7]}));
    clk.mark(kCpFlags);
    // (3) the step at the group's dt, what follows it and the transition
    if (live) {
      double moved[T];
      const double dt_g = fmin(dt, gdt);
      const bool fin = row_move<T>(c, tr, rate, dt_g, true, moved);
      clk.mark(kCpAdvance);
      feed_row<T>(c, true, env.q, env.qsizes, env.Q, env.K, sm, lane);
      clk.mark(kCpFeed);
      const Step s{dt_g, rsum, fin};
      bool comp_any, tick_hit;
      guard = row_after_step<T, CW>(c, moved, s, env, st, ck, sm, comp_any, tick_hit, lane);
      clk.mark(kCpAfterStep);
      if (!guard && row_transition<T, CW>(c, comp_any, tick_hit, env, st, ck, sm, lane)) {
        row_done = true;
        live = false;
        stop = kStopDone;
      }
    }
    ++gsteps;
    __syncwarp();
    clk.mark(kCpTransition);
  }
  __syncwarp();
  if (warp == 0 && lane == 0) {
    f.counts[g] = nsweeps;
    f.counts[f.G + g] = nreused;
  }
  if (act) {
    store_row<T>(a, row, c, ck, st, row_done, stop, cache.reuses, lane);
    clk.store(a.cycles + row * kCpPhases, lane);
  } else if (row >= 0 && lane == 0) {
    a.steps[row] = 0;
    a.stop[row] = 0;
    a.reuses[row] = 0;
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
  return launch_rows(fused_rounds_kernel<T, CW, false>, a, round_warp_bytes(T, a.K), stream);
}

template <int T, int CW>
cudaError_t launch_probe(const RoundArgs& a, cudaStream_t stream) {
  return launch_rows(fused_rounds_kernel<T, CW, true>, a, round_warp_bytes(T, a.K), stream);
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

// The coupled loop over f.G blocks of f.R warps.
template <int CW, bool Probe = false>
cudaError_t launch_coupled(const RoundArgs& a, const CoupledArgs& f, cudaStream_t stream) {
  const size_t smem = kGroupBytes + (size_t)f.R * round_warp_bytes(1, a.K);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(fused_rounds_coupled_kernel<CW, Probe>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_rounds_coupled_kernel<CW, Probe><<<(unsigned)f.G, 32 * f.R, smem, stream>>>(a, f);
  return cudaGetLastError();
}

// Fill `a` from `ptrs`, the kRoundOperands operands in RoundArgs order;
// false if the count is off.
bool round_args(void* const* ptrs, RoundArgs& a) {
  int i = 0;
  auto next = [&]() { return ptrs[i++]; };
  a.act = static_cast<const bool*>(next());
  a.tick_period = static_cast<const double*>(next());
  a.max_time = static_cast<const double*>(next());
  a.record = static_cast<const bool*>(next());
  a.kind = static_cast<const long long*>(next());
  a.trivial_tick = static_cast<const bool*>(next());
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
  a.reuses = static_cast<long long*>(next());
  return i == kRoundOperands;
}

// Fill `a` for a loop launch over S rows; false on a bad shape or operand
// count.
bool rounds_setup(void* const* ptrs, RoundArgs& a, long long S, long long C, long long K,
                  long long B, long long Q, long long P, long long TL, long long max_steps) {
  if (C <= 0 || K <= 0 || K > 1024 || B <= 0 || Q <= 0 || P <= 0 || TL <= 0 || max_steps < 1 ||
      !round_args(ptrs, a)) {
    return false;
  }
  a.cycles = nullptr;
  a.S = S;
  a.Q = Q;
  a.max_steps = max_steps;
  a.C = (int)C;
  a.K = (int)K;
  a.B = (int)B;
  a.P = (int)P;
  a.TL = (int)TL;
  a.warps = 0;
  return true;
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
  RoundArgs a;
  if (!rounds_setup(ptrs, a, S, C, K, B, Q, P, TL, max_steps)) return (int)cudaErrorInvalidValue;
  FUSED_DISPATCH(launch_rounds, a, C, static_cast<cudaStream_t>(stream));
}

// The probe build of fused_rounds_f64 (rows of C <= 32): the same loop,
// results bit for bit, and `cycles` (S, kPhases) int64 receives each row's
// SM cycles by phase (enum Phase), summed over its steps in this launch.
extern "C" int fused_rounds_probe_f64(void* const* ptrs, void* cycles, long long S, long long C,
                                      long long K, long long B, long long Q, long long P,
                                      long long TL, long long max_steps, void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  RoundArgs a;
  if (C > 32 || !rounds_setup(ptrs, a, S, C, K, B, Q, P, TL, max_steps)) {
    return (int)cudaErrorInvalidValue;
  }
  a.cycles = static_cast<long long*>(cycles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // two instances (a row of C columns runs bit for bit alike in any tile
  // width >= C: the columns past C hold no chunk and the descent's sums add
  // their zeros exactly)
  if (C <= 16) return (int)launch_probe<1, 16>(a, st);
  return (int)launch_probe<1, 32>(a, st);
}

// The number of phases the probe build splits a step into.
extern "C" int fused_rounds_probe_phases() { return kPhases; }

namespace {

// Fill `a` and `f` for a coupled loop launch; false on a bad shape or
// operand count.
bool coupled_setup(void* const* ptrs, const void* rows, const void* mask, const void* cap,
                   void* counts, RoundArgs& a, CoupledArgs& f, long long S, long long C,
                   long long K, long long B, long long Q, long long P, long long TL, long long G,
                   long long R, long long max_steps) {
  // the level memory stamps a member's steps as int
  if (C > 32 || R <= 0 || R > kGroupRows || max_steps >= INT_MAX) return false;
  if (!rounds_setup(ptrs, a, S, C, K, B, Q, P, TL, max_steps)) return false;
  a.warps = (int)R;
  f.rows = static_cast<const long long*>(rows);
  f.mask = static_cast<const long long*>(mask);
  f.cap = static_cast<const double*>(cap);
  f.counts = static_cast<long long*>(counts);
  f.G = G;
  f.R = (int)R;
  return true;
}

}  // namespace

// `ptrs` as fused_rounds_f64's; `rows` (G, R) int64, `mask` (G, 4) int64
// and `cap` (G, 4) float64 the fabric layout, one block a group (R <= 8
// rows, C <= 32 columns); `counts` (2, G) int64 receives each block's
// Jacobi sweeps, then the group steps that reused the last solve. Each
// active row takes 0 to max_steps (< 2^31 - 1) steps, its group's steps in
// lockstep. Returns the launch's cudaError_t.
extern "C" int fused_rounds_coupled_f64(void* const* ptrs, const void* rows, const void* mask,
                                        const void* cap, void* counts, long long S, long long C,
                                        long long K, long long B, long long Q, long long P,
                                        long long TL, long long G, long long R,
                                        long long max_steps, void* stream) {
  if (S <= 0 || G <= 0) return (int)cudaSuccess;
  RoundArgs a;
  CoupledArgs f;
  if (!coupled_setup(ptrs, rows, mask, cap, counts, a, f, S, C, K, B, Q, P, TL, G, R,
                     max_steps)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 4) return (int)launch_coupled<4>(a, f, st);
  if (C <= 8) return (int)launch_coupled<8>(a, f, st);
  if (C <= 16) return (int)launch_coupled<16>(a, f, st);
  return (int)launch_coupled<32>(a, f, st);
}

// The probe build of fused_rounds_coupled_f64: the same loop, results bit
// for bit, and `cycles` (S, kCpPhases) int64 receives each active row's SM
// cycles by phase of its group steps (enum CoupledPhase), summed over the
// launch; two instances, as fused_rounds_probe_f64's.
extern "C" int fused_rounds_coupled_probe_f64(void* const* ptrs, const void* rows,
                                              const void* mask, const void* cap, void* counts,
                                              void* cycles, long long S, long long C, long long K,
                                              long long B, long long Q, long long P, long long TL,
                                              long long G, long long R, long long max_steps,
                                              void* stream) {
  if (S <= 0 || G <= 0) return (int)cudaSuccess;
  RoundArgs a;
  CoupledArgs f;
  if (!coupled_setup(ptrs, rows, mask, cap, counts, a, f, S, C, K, B, Q, P, TL, G, R,
                     max_steps)) {
    return (int)cudaErrorInvalidValue;
  }
  a.cycles = static_cast<long long*>(cycles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 16) return (int)launch_coupled<16, true>(a, f, st);
  return (int)launch_coupled<32, true>(a, f, st);
}

// The number of phases the coupled probe build splits a group step into.
extern "C" int fused_rounds_coupled_probe_phases() { return kCpPhases; }
