// Flash-attention forward, fp32 arithmetic, one block per (query tile, head,
// batch row).
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
// key tiles of BK = 64 itself: m and l of its rows and the (64, D) fp32
// accumulator stay in registers, 4 rows x D / 16 columns a thread. The loop
// bounds are the block skipping: causal stops at the tile holding the last
// query, a window starts at the first key the first query may see. The
// Pallas tiles must divide S and T; here the tail rows and keys are masked,
// so any S, T >= 1 work.
//
// Shared memory, fp32: the query tile and a key tile with rows padded to
// D + 1 floats (a column read across 16 rows hits 16 banks), a value tile and
// the (64, 65) probability tile: 213,760 bytes at D = 256, one block an SM.
// Inputs are fp32 or bf16, read once a tile and upcast on load; the output is
// written in the input's type (bf16 rounds to nearest even).
//
// What bounds it on an H100: operations. At gemma3-1b's prefill shapes the
// kernel needs 4 D flops per kept (query, key) pair (4.30 GFLOP at
// (8, 4, 512, 256) causal) against ~21 MB of bytes; the tensor cores would
// take 4.3 us for that, the fp32 CUDA cores 64 us. This kernel runs on the
// CUDA cores with scalar shared-memory reads (8 reads a thread for 16 FMAs
// in q k^T, 20 for 64 in p v), so shared-memory issue, not the FMA rate,
// limits it. A wgmma / TMA version on bf16 tiles is later work.
//
// Built with -fmad=false like every kernel of the port: the softmax update
// rounds each product and sum as written. The two dot products use explicit
// fmaf (one rounding a step).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;                 // queries a block
constexpr int BK = 64;                 // keys a tile
constexpr int THREADS = 256;           // 16 x 16: ty owns 4 query rows, tx a column set
constexpr int ROWS = BQ / 16;          // query rows a thread
constexpr int KCOLS = BK / 16;         // keys a thread in the logits tile: tx + 16 j
constexpr int PLD = BK + 1;            // padded probability row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__host__ __device__ constexpr size_t smem_floats(int d) {
  return (size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d + (size_t)BQ * PLD;
}

// Row reductions over the 16 lanes (tx) that share a ty; every lane ends
// with the same value.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DMAX: the largest head dim this instantiation takes (D <= DMAX), which
// sizes the per-thread accumulator (DMAX / 16 columns a row).
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                     long long S, long long Tk, int D, int causal, int has_window,
                     long long window, float scale, float cap) {
  constexpr int DCOLS = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;            // BQ x ld
  float* ks = qs + BQ * ld;    // BK x ld
  float* vs = ks + BK * ld;    // BK x D
  float* ps = vs + BK * D;     // BQ x PLD

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (H / KV);
  const long long q0 = (long long)blockIdx.x * BQ;
  const T* qb = q + ((long long)b * H + head) * S * D;
  const T* kb = k + ((long long)b * KV + kv_head) * Tk * D;
  const T* vb = v + ((long long)b * KV + kv_head) * Tk * D;
  T* ob = o + ((long long)b * H + head) * S * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * ld + c] = q0 + r < S ? load(qb + (q0 + r) * D + c) : 0.f;
  }

  // the key range any query of the tile may see
  const long long q_last = (q0 + BQ < S ? q0 + BQ : S) - 1;
  long long k_begin = 0, k_end = Tk;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  if (has_window && q0 - window + 1 > 0) k_begin = q0 - window + 1;

  float m[ROWS], l[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Tk;
      ks[r * ld + c] = in ? load(kb + (k0 + r) * D + c) : 0.f;
      vs[r * D + c] = in ? load(vb + (k0 + r) * D + c) : 0.f;
    }
    __syncthreads();

    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(ty * ROWS + i) * ld + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long qp = q0 + ty * ROWS + i;
      bool keep[KCOLS];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const long long kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = tanhf(x / cap) * cap;
        keep[j] = kp < Tk && (!causal || kp <= qp) && (!has_window || kp > qp - window);
        s[i][j] = keep[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * ROWS + i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(fminf(m[i] - m_new, 0.f));
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) acc[i][c] = alpha * acc[i][c];
    }
    __syncthreads();  // the probability tile is complete

    const int kn = k_end - k0 < BK ? (int)(k_end - k0) : BK;
    for (int j = 0; j < kn; ++j) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(ty * ROWS + i) * PLD + j];
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = vs[j * D + d];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long qp = q0 + ty * ROWS + i;
    if (qp >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(ob + qp * D + d, acc[i][c] / li);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
           long long KV, long long S, long long Tk, int D, int causal, int has_window,
           long long window, float scale, float cap, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(smem_floats(DMAX) * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), (int)H, (int)KV, S, Tk, D, causal, has_window, window, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, long long B, long long H,
             long long KV, long long S, long long Tk, int D, int causal, int has_window,
             long long window, float scale, float cap, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, Tk, D, causal, has_window, window, scale,
                         cap, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, KV, S, Tk, D, causal, has_window, window, scale,
                          cap, stream);
  return launch<T, 256>(q, k, v, o, B, H, KV, S, Tk, D, causal, has_window, window, scale, cap,
                        stream);
}

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
      (S + BQ - 1) / BQ > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, T, (int)D, causal, has_window,
                                   window, scale, cap, st);
  return dispatch<float>(q, k, v, o, B, H, KV, S, T, (int)D, causal, has_window, window,
                         scale, cap, st);
}
