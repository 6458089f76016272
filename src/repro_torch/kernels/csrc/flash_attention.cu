// Flash-attention forward, fp32 arithmetic on the CUDA cores, register-tiled:
// one block of 8 warps per (query tile, head, batch row).
//
// Replaces the Pallas kernel _flash_kernel of
// src/repro/kernels/flash_attention.py. For q (B, H, S, D) and k, v
// (B, KV, T, D), head h reading KV head h / (H / KV), query i at position i
// and key j at position j:
//
//     s_ij = q_i . k_j * scale        scale = fp32(1 / sqrt(D))
//     s_ij = tanh(s_ij / cap) * cap   where a logit softcap is given
//     key j is kept when j <= i (causal) and j > i - window (a window)
//     o_i  = sum_j softmax_j(s_ij) v_j   over the kept keys, fp32
//
// with the Pallas kernel's online softmax: masked logits at -1e30,
// p = exp(s - m_new) zeroed where masked, alpha = exp(min(m_prev - m_new, 0)),
// and l == 0 -> 1 at the end, so a query that no key may attend gets zeros.
//
// The Pallas grid (B * KV, G, S / Bq, T / Bk) walks key blocks sequentially
// with m, l and acc in VMEM scratch, and skips blocks outside the mask with
// pl.when. Here each block owns BQ = 64 queries of one (b, h) and loops over
// key tiles of BK = 64 itself; the loop bounds are the block skipping (causal
// stops at the tile holding the last query, a window starts at the first key
// the first query may see). Tail rows and keys are masked, so any S, T >= 0
// work (the Pallas tiles must divide S and T).
//
// What bounds it on an H100: operations. A kept (query, key) pair costs 4 D
// flops (q . k and p v, 2 D fused multiply-adds); at (8, 4, 1, 512, 256)
// causal that is 4.30 GFLOP, 64.2 us at the CUDA cores' 67 TFLOP/s, against
// 21 MB (6.3 us) of bytes. What the design does about it:
//
// * Register tiles of 8 x 8, as an SGEMM microkernel. On the H100 a warp's
//   128-bit shared load took four cycles of the SM's shared-memory port
//   (a quarter warp a cycle) even where lanes share an address: p v with 8 x
//   8 lanes ran at the fma rate, q k^T with 4 x 4 lanes at about half of it.
//   The SM issues 128 fma a cycle, so a lane must do 4 fma a float it loads:
//   8 x 8 outer products, 16 floats for 64 fma. For o += p v a warp owns 32 rows x D / 4 columns of the (64, D)
//   accumulator and a lane 8 rows x 8 columns (at D = 256; in registers for
//   the whole block); it reads p transposed (two 128-bit loads for its 8
//   rows) and v row-major (two for its columns) a key. For s = q k^T the
//   (64, 64) logits would give a lane only 2 x 8 of them, so the head dim is
//   split in four: warp (dq, wr) sums quarter dq of d for rows 32 wr .. + 32
//   and every key, a lane 8 rows x 8 keys read as 128-bit loads along d (16
//   loads for 256 fma a step of 4); the partial sums cross through shared
//   memory (the k tile's region, 64 KB), each lane adds the four quarters of
//   2 of its rows in quarter order and finishes them: a row's 64 keys lie in
//   one warp, so its maximum and sum are shuffles. The first designs'
//   4-row x 2-key lanes (16 warps) and 4 x 4 lanes (8 warps) spent two to
//   three times the fma time on the q k^T loads.
// * Asynchronous loads. k and v tiles arrive by 16-byte cp.async, staggered
//   in one buffer each: v_t is in flight while s = q k_t^T is computed, and
//   k_{t+1} while o += p v_t is, with four barriers a tile. fp32 rows must be
//   16-byte aligned for this (D % 4 == 0 and 16-byte aligned pointers);
//   other fp32 inputs and bf16 inputs (upcast on load) take a plain load
//   path into the same buffers. Tile elements are walked as (row, column)
//   without a division, and the mask is tested in int relative to the tile
//   (skipped for tiles inside it).
// * Shared memory: q and k tiles (64 x (D + 4) floats each at D = 256), v
//   (64 x D), the transposed probabilities (64 x 68) and per-row values:
//   216,576 bytes at D = 256 (under the 232,448 a block may use), one block
//   of 256 threads an SM. The register file bounds the warps: 8 x 8 tiles of
//   both products take 254 registers a thread at D = 256 (no spills, ptxas;
//   chip_smoke.py prints each instance's report).
// * Heaviest-first order. Blocks are numbered in issue order (x, then y),
//   query tiles from the last (the longest causal walk) to the first, heads
//   and batch rows inside, so the causal triangle's long blocks start first
//   and the short ones fill the gaps. At (8, 4, 1, 512, 256) causal the 256
//   blocks hold 1 to 8 key tiles (36 tiles, 131,328 kept pairs a head); 132
//   SMs, one block each, take 1,152 tiles, 8.7 an SM on average (31,837
//   kept pairs an SM), and the longest-first greedy order ends after 9
//   tiles (at most 36,864 pairs, of which the kept ones fewer) on the
//   busiest SM.
//
// A second design, 3xTF32 products on mma.sync.m16n8k8 (q, k, p, v split
// into tf32 hi + lo, each product hi hi + hi lo + lo hi), ran slower on an
// H100 than these fp32 fma, and its p v does not return v exactly for a
// window of 1 (v = hi + lo loses v's last bits); it was not kept.
//
// Built with -fmad=false like every kernel of the port: the softmax update
// rounds each product and sum as written. The two products use explicit
// fmaf (one rounding a step), summing along each quarter of d and along keys
// in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;          // queries a block
constexpr int BK = 64;          // keys a tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
// the logits tile (BQ, BK): warp (dq, wr) of 4 x 2 sums quarter dq of the
// head dim for rows 32 wr .. + 32 and every key; lane (lr, lk) of its 4 x 8
// holds 8 rows x 8 keys of that partial sum and finishes 2 of the rows
constexpr int NDQ = 4;
constexpr int SR = 8, SK = 8;
// the accumulator (BQ, DMAX): OWR warps across rows, WARPS / OWR across
// columns; a lane (lo, lc) of a warp's 4 x 8 holds OR rows
constexpr int OWR = 2;
constexpr int OWC = WARPS / OWR;
constexpr int OR = BQ / OWR / 4;
constexpr int PLD = BK + 4;     // row stride of the transposed probabilities
constexpr float NEG_INF = -1e30f;
// the partial logits exchanged between the quarters of the head dim
constexpr int XCH = NDQ * 2 * SR * SK * 32;
static_assert(NDQ * 2 == WARPS && 2 * 4 * SR == BQ && 8 * SK == BK && OR == 8,
              "tile shapes");

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q and k row stride in floats: D rounded up to 32, plus 4 (4 mod 32: a
// quarter warp's 128-bit reads of consecutive rows hit distinct banks).
__host__ __device__ constexpr int qk_ld(int d) { return (d + 31) / 32 * 32 + 4; }

// the k tile's region also holds the exchanged partial logits
__host__ __device__ constexpr size_t k_region(int d) {
  return (size_t)BK * qk_ld(d) > (size_t)XCH ? (size_t)BK * qk_ld(d) : (size_t)XCH;
}

__host__ __device__ constexpr size_t smem_floats(int d, int dmax) {
  return (size_t)BQ * qk_ld(d) + k_region(d) + (size_t)BK * dmax + (size_t)BK * PLD + 2 * BQ;
}

// Copies rows [0, rows) of a tile (row stride D in src) into dst (row
// stride ld): 16-byte cp.async where `async` (fp32, D % 4 == 0, aligned),
// else element by element, upcast to fp32, with columns [D, width) zeroed.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int rows, int D,
                                          int width, bool async, int tid) {
  // element e = tid + THREADS n of the tile, walked as (row, column) without
  // a division a step
  const int per_row = async && sizeof(T) == 4 ? D / 4 : width;
  const int step_r = THREADS / per_row, step_c = THREADS % per_row;
  int r = tid / per_row, c = tid % per_row;
  if constexpr (sizeof(T) == 4) {
    if (async) {
      for (; r < rows; r += step_r, c += step_c) {
        if (c >= per_row) c -= per_row, ++r;
        if (r >= rows) break;
        cp_async16(dst + r * ld + 4 * c,
                   reinterpret_cast<const float*>(src) + (long long)r * D + 4 * c);
      }
      return;
    }
  }
  for (; r < rows; r += step_r, c += step_c) {
    if (c >= per_row) c -= per_row, ++r;
    if (r >= rows) break;
    dst[r * ld + c] = c < D ? load(src + (long long)r * D + c) : 0.f;
  }
}

// DMAX: the largest head dim this instantiation takes (D <= DMAX); a lane of
// the p v product owns OR rows x CO columns, in G groups of VW adjacent ones.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int H, int KV, long long BH, long long n_qt,
                     long long S, long long Tk, int D, int causal, int has_window,
                     long long window, float scale, float cap, int async) {
  constexpr int CO = DMAX / OWC / 8;      // accumulator columns a lane
  constexpr int VW = CO < 4 ? CO : 4;     // adjacent columns a group (one load)
  constexpr int G = CO / VW;              // column groups a lane
  extern __shared__ __align__(16) float smem[];
  const int ld = qk_ld(D);
  const int d4 = (D + 3) / 4 * 4;
  float* qs = smem;              // BQ x ld, row-major
  float* ks = qs + BQ * ld;      // BK x ld, row-major; or the exchange
  float* vs = ks + k_region(D);  // BK x DMAX, row-major
  float* ps = vs + BK * DMAX;    // BK x PLD: p transposed (key-major)
  float* l_s = ps + BK * PLD;    // BQ: the row sums at the end
  float* alpha_s = l_s + BQ;     // BQ: this tile's rescale of each row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // heaviest first: the last query tile (the longest causal walk) first
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (blk >= n_qt * BH) return;  // the last row of the grid's padding
  const long long qt = n_qt - 1 - blk / BH;
  const int bh = (int)(blk % BH);
  const int head = bh % H, b = bh / H;
  const int kv_head = head / (H / KV);
  const long long q0 = qt * BQ;
  const T* qb = q + ((long long)b * H + head) * S * D;
  const T* kb = k + ((long long)b * KV + kv_head) * Tk * D;
  const T* vb = v + ((long long)b * KV + kv_head) * Tk * D;
  T* ob = o + ((long long)b * H + head) * S * D;

  // the logits: warp (dq, wr), lane (lr, lk): rows srow + 4 i, keys lk + 8 j
  // over columns [d_lo, d_hi) of the head dim; it finishes rows i = 2 dq,
  // 2 dq + 1
  const int dq = warp >> 1, wr = warp & 1, lr = lane >> 3, lk = lane & 7;
  const int srow = 32 * wr + lr;
  const int dqw = (d4 / 4 + NDQ - 1) / NDQ * 4;
  const int d_lo = dq * dqw < d4 ? dq * dqw : d4, d_hi = d_lo + dqw < d4 ? d_lo + dqw : d4;
  // the accumulator: lane (lo, lc) of warp (wo, wc) rows orow .. + OR,
  // columns ocol + 8 VW g .. + VW
  const int wo = warp / OWC, wc = warp % OWC, lo = lane >> 3, lc = lane & 7;
  const int orow = BQ / OWR * wo + OR * lo, ocol = 8 * CO * wc + VW * lc;

  // the key range any query of the tile may see
  const long long q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
  long long k_begin = 0, k_end = Tk;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  if (has_window && q0 - window + 1 > 0) k_begin = q0 - window + 1;

  const int q_rows = (int)(S - q0 < BQ ? S - q0 : BQ);
  load_tile(qs, ld, qb + q0 * D, q_rows, D, d4, async, tid);
  if (k_begin < k_end) {
    const int rows = (int)(k_end - k_begin < BK ? k_end - k_begin : BK);
    load_tile(ks, ld, kb + k_begin * D, rows, D, d4, async, tid);
  }
  cp_async_commit();

  float m[2], l[2], acc[OR][CO];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < OR; ++r)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[r][c] = 0.f;

  for (long long k0 = k_begin; k0 < k_end; k0 += BK) {
    const int kn = (int)(k_end - k0 < BK ? k_end - k0 : BK);
    cp_async_wait<0>();  // this thread's copies of k_t (and q) have landed
    __syncthreads();     // everyone's have; the last tile's p v is done
    load_tile(vs, DMAX, vb + k0 * D, kn, D, D, async, tid);
    cp_async_commit();

    // ---- s = q k^T, this warp's quarter of the head dim ----
    float s[SR][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SK; ++j) s[i][j] = 0.f;
    const float* qrow = qs + srow * ld;
    const float* krow = ks + lk * ld;
    for (int d = d_lo; d < d_hi; d += 4) {
      float4 qa[SR], kb4[SK];
#pragma unroll
      for (int i = 0; i < SR; ++i) qa[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * ld + d);
#pragma unroll
      for (int j = 0; j < SK; ++j) kb4[j] = *reinterpret_cast<const float4*>(krow + 8 * j * ld + d);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          s[i][j] = fmaf(qa[i].x, kb4[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb4[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb4[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb4[j].w, s[i][j]);
        }
    }

    // ---- the quarters' partial sums, each row finished by one quarter ----
    __syncthreads();  // k_t is read: the exchange may overwrite it
    float* xch = ks;  // [quarter][row half][i][j][lane]
#pragma unroll
    for (int i = 0; i < SR; ++i)
      if ((i >> 1) != dq)
#pragma unroll
        for (int j = 0; j < SK; ++j) xch[(((dq * 2 + wr) * SR + i) * SK + j) * 32 + lane] = s[i][j];
    __syncthreads();
    float f[2][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      if ((i >> 1) == dq)
#pragma unroll
        for (int j = 0; j < SK; ++j) f[i & 1][j] = s[i][j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * dq + h;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        float x = 0.f;
#pragma unroll
        for (int src = 0; src < NDQ; ++src)
          x += src == dq ? f[h][j] : xch[(((src * 2 + wr) * SR + i) * SK + j) * 32 + lane];
        f[h][j] = x;
      }
    }

    // ---- scale, softcap, mask; p = exp(s - m_new), transposed ----
    // key c of the tile is kept for row r when lower < c - r <= upper (both
    // relative to the tile, clamped to int); a tile inside the mask for
    // every row skips the test
    const long long base = q0 - k0;
    const int upper = causal ? (int)(base < (1 << 30) ? base : (1 << 30)) : (1 << 30);
    const long long low_ll = has_window ? base - (window < (1LL << 40) ? window : (1LL << 40))
                                        : -(1LL << 30);
    const int lower = (int)(low_ll > -(1LL << 30) ? low_ll : -(1LL << 30));
    const bool inside = kn == BK && BK - 1 <= upper && -(BQ - 1) > lower;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = srow + 4 * (2 * dq + h);
      bool keep[SK];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const int c = lk + 8 * j;
        float x = f[h][j] * scale;
        if (cap != 0.f) x = tanhf(x / cap) * cap;
        keep[j] = inside || (c < kn && c - r <= upper && c - r > lower);
        f[h][j] = keep[j] ? x : NEG_INF;
        mx = fmaxf(mx, f[h][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const float p = keep[j] ? expf(f[h][j] - m_new) : 0.f;
        ps[(lk + 8 * j) * PLD + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(fminf(m[h] - m_new, 0.f));
      l[h] = alpha * l[h] + sum;
      m[h] = m_new;
      if (lk == 0) alpha_s[r] = alpha;
    }
    cp_async_wait<0>();  // this thread's copies of v_t have landed
    __syncthreads();     // everyone's have; p and alpha are complete; the exchange is read
    if (k0 + BK < k_end) {
      const int rows = (int)(k_end - k0 - BK < BK ? k_end - k0 - BK : BK);
      load_tile(ks, ld, kb + (k0 + BK) * D, rows, D, d4, async, tid);
    }
    cp_async_commit();

    // ---- o = alpha o + p v ----
#pragma unroll
    for (int r = 0; r < OR; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(alpha_s + orow + r);
      const float al[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[r + e][c] = al[e] * acc[r + e][c];
    }
#pragma unroll 2
    for (int j = 0; j < kn; ++j) {
      float pr[OR], vv[CO];
#pragma unroll
      for (int r = 0; r < OR; r += 4) {
        const float4 t = *reinterpret_cast<const float4*>(ps + j * PLD + orow + r);
        pr[r] = t.x, pr[r + 1] = t.y, pr[r + 2] = t.z, pr[r + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* vp = vs + j * DMAX + ocol + 8 * VW * g;
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          vv[4 * g] = t.x, vv[4 * g + 1] = t.y, vv[4 * g + 2] = t.z, vv[4 * g + 3] = t.w;
        } else if constexpr (VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          vv[2 * g] = t.x, vv[2 * g + 1] = t.y;
        } else {
          vv[g] = *vp;
        }
      }
#pragma unroll
      for (int r = 0; r < OR; ++r)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();

  // ---- o / l ----
  // (each row's sum is held by the lanes of one quarter)
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lk == 0) l_s[srow + 4 * (2 * dq + h)] = l[h];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < OR; ++r) {
    const int row = orow + r;
    const long long qp = q0 + row;
    if (qp >= S) continue;
    const float lsum = l_s[row];
    const float li = lsum == 0.f ? 1.f : lsum;
    T* orow_p = ob + qp * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = ocol + 8 * VW * g;
      if constexpr (sizeof(T) == 4 && VW == 4) {
        if (async && col < D) {
          const float4 t = {acc[r][4 * g] / li, acc[r][4 * g + 1] / li, acc[r][4 * g + 2] / li,
                            acc[r][4 * g + 3] / li};
          *reinterpret_cast<float4*>(orow_p + col) = t;
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < VW; ++e)
        if (col + e < D) store(orow_p + col + e, acc[r][VW * g + e] / li);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
           long long KV, long long S, long long Tk, int D, int causal, int has_window,
           long long window, float scale, float cap, int async, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, DMAX) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(smem_floats(DMAX, DMAX) * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  const long long n_qt = (S + BQ - 1) / BQ, blocks = n_qt * B * H;
  // blocks in x first, then y (the issue order); at most 2^30 a row
  const long long x = blocks < (1LL << 30) ? blocks : (1LL << 30);
  const dim3 grid((unsigned)x, (unsigned)((blocks + x - 1) / x));
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), (int)H, (int)KV, B * H, n_qt, S, Tk, D, causal, has_window, window,
      scale, cap, async);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
             long long KV, long long S, long long Tk, int D, int causal, int has_window,
             long long window, float scale, float cap, int async, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, Tk, D, causal, has_window, window, scale,
                         cap, async, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, KV, S, Tk, D, causal, has_window, window, scale,
                          cap, async, stream);
  return launch<T, 256>(q, k, v, o, B, H, KV, S, Tk, D, causal, has_window, window, scale, cap,
                        async, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

// q, o (B, H, S, D); k, v (B, KV, T, D); contiguous, on the current device,
// all float32 (bf16 == 0) or all bfloat16 (bf16 == 1); H % KV == 0,
// 1 <= D <= 256, H and B <= 65,535. ``window`` is read when has_window is
// set. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   long long B, long long H, long long KV, long long S,
                                   long long T, long long D, int bf16, int causal,
                                   int has_window, long long window, float cap,
                                   void* stream) {
  if (B * H * S == 0) return (int)cudaSuccess;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || H > 65535 || B > 65535 || T < 0 ||
      (S + BQ - 1) / BQ > (65535LL << 30) / (B * H))  // the grid's rows
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, T, (int)D, causal, has_window,
                                   window, scale, cap, 0, st);
  const int async = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  return dispatch<float>(q, k, v, o, B, H, KV, S, T, (int)D, causal, has_window, window, scale,
                         cap, async, st);
}
