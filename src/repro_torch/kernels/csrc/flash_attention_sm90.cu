// Flash-attention forward for Hopper (sm_90a): bf16 inputs, tensor-core
// products with wgmma, K / V tiles brought in by TMA through an mbarrier
// ring, the online softmax in registers. One block per (128-query tile,
// head, batch row).
//
// Replaces the Pallas kernel _flash_kernel of
// src/repro/kernels/flash_attention.py, as the CUDA-core kernel
// flash_attention.cu does for fp32 inputs. For q (B, H, S, D) and k, v
// (B, KV, T, D) in bf16, head h reading KV head h / (H / KV), query i at
// position i and key j at position j:
//
//     s_ij = q_i . k_j * scale        scale = fp32(1 / sqrt(D)), fp32 sums
//     s_ij = tanh(s_ij / cap) * cap   where a logit softcap is given
//     key j is kept when j <= i (causal) and j > i - window (a window)
//     o_i  = sum_j softmax_j(s_ij) v_j   over the kept keys
//
// with the Pallas kernel's online softmax: masked logits at -1e30,
// p = exp(s - m_new) zeroed where masked, alpha = exp(min(m_prev - m_new, 0)),
// l summed over the fp32 p, and l == 0 -> 1 at the end, so that a query that
// no key may attend gets zeros. It runs in log2 units (scale log2(e) folded
// into one multiply, 2^x on the special-function unit), where a masked
// logit's p = 2^(-1e30 - m) is 0 without a test. p v runs as two bf16 products, p = hi + lo
// with hi = bf16(p) and lo = bf16(p - hi), which carries p to ~2^-18 of
// itself: p rounded once to bf16 (2^-9, one pass of the TPU's matrix unit)
// flipped bf16 roundings of the attention output often enough to move the
// models' block outputs past the card checks' limits.
//
// What bounds it on an H100: operations, 4 D flops a kept (query, key)
// pair on the bf16 tensor cores (989 TFLOP/s; the split p makes it 6 D
// issued), except at short sequences where the bytes of q, k, v and o are
// the larger bound.
//
// Design. 384 threads: warpgroups 0 and 1 each own 64 query rows of the
// block's 128 and run the products; warpgroup 2 is the producer, one thread
// of which issues every TMA copy. The producer gives back its registers
// (setmaxnreg 24) so that each consumer thread may hold 240: the fp32 output
// accumulator (64 x D_PAD a warpgroup, D_PAD / 2 registers a thread), the
// 64 x 64 logits tile (32) and the probabilities as two bf16 halves (2 x 16).
//
//   shared memory, 128-byte swizzled (what TMA writes and wgmma reads):
//     Q tile   2 x 64 rows x D_PAD, loaded once        64 KB at D_PAD 256
//     K, V     2 stages x 64 keys x D_PAD each          128 KB at D_PAD 256
//   each stored as column chunks of 64 bf16 (128 bytes a row, 8 KB a chunk),
//   the box that one TMA copy moves.
//
//   S = Q K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory, both
//     K-major, D_PAD / 16 steps.
//   O += P V: wgmma m64n{D_PAD}k16, A = P from registers (the logits'
//     accumulator layout is the A fragment layout, so P never goes to
//     shared memory), B = V from shared memory, MN-major (the transpose
//     bit), 4 steps of 16 keys, each for lo and for hi.
//
// The mbarrier ring: full barriers (K and V apart, so that S = Q K^T can
// start before V has landed) completed by the TMA's byte count, and an
// empty barrier a stage that all 256 consumer threads arrive at once their
// products on that stage are done. The loop bounds skip the key tiles that
// no query of the block may see (causal: up to the tile holding the last
// query; a window: from the first key the first query may see), a
// warpgroup skips a tile that none of its 64 rows may see, and the mask is
// applied only on tiles that cross the diagonal, the window's edge or T.
// Query tiles are issued longest first (the last tiles of a causal mask
// have the most keys), so the last wave is short.
//
// The two consumer warpgroups run in step: both on the tensor cores, then
// both on the softmax. Two ways to overlap them were measured slower on an
// H100 (PERF.md, PR 16): overlapping a tile's softmax with the previous
// tile's p v keeps two sets of p registers live, which with the split p
// spills at D_PAD 256; taking turns on the tensor cores through named
// barriers added more waiting than it hid.
//
// TMA copies a box of 64 x 64 from a 4-D map (D, S or T, heads, batch) with
// the caller's strides, so the model's (B, S, H, D) layout is read and
// written without a copy; the box fills the columns past D and the rows
// past S or T with zeros, so ragged edges need no masked loads. That needs
// 16-byte strides: D % 8 == 0 and the other strides multiples of 8
// elements, the data 16-byte aligned. Narrower heads instantiate D_PAD 64 or
// 128.
//
// Built with -fmad=false like every kernel of the port.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int BM = 128;       // queries a block
constexpr int WM = 64;        // queries a consumer warpgroup
constexpr int BN = 64;        // keys a tile
constexpr int STAGES = 2;     // K / V ring depth
constexpr int CHUNK = 64;     // bf16 columns a swizzled chunk (128 bytes)
constexpr int CHUNK_BYTES = 64 * CHUNK * 2;  // 64 rows of one chunk
constexpr int THREADS = 384;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int smem_bytes(int dpad) {
  // Q (2 x dpad/64 chunks), K and V (STAGES x dpad/64 chunks each), 7
  // barriers, and 1 KB to align the base to 1024 bytes
  return (2 + 2 * STAGES) * (dpad / CHUNK) * CHUNK_BYTES + 64 + 1024;
}

// ---- PTX wrappers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// wait: the registers are "rewritten" here, after it in program order.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Accumulator operands of an inline wgmma: registers d[i] .. d[i + 7] (or
// d[0] .. d[31]) as "+f" constraints, and the PTX list %0 .. %31.
#define ACC8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC32_LIST                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, fp32) = [d +] A (64 x 16) B (16 x 64); A and B bf16 in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64); A bf16 in registers (the
// m64k16 fragment), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128); as wgmma_rs, 128 columns.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16) B (16 x 256); as wgmma_rs, 256 columns.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56), ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88),
        ACC8(d, 96), ACC8(d, 104), ACC8(d, 112), ACC8(d, 120)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O (64 x DPAD) += P (64 x 16) V (16 x DPAD), one instruction for all of V's
// columns.
template <int DPAD>
__device__ __forceinline__ void wgmma_pv(float (&o)[DPAD / 2], const uint32_t* a, uint64_t dv) {
  if constexpr (DPAD == 64) wgmma_rs(o, a[0], a[1], a[2], a[3], dv);
  else if constexpr (DPAD == 128) wgmma_rs_n128(o, a[0], a[1], a[2], a[3], dv);
  else wgmma_rs_n256(o, a[0], a[1], a[2], a[3], dv);
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126, and x = -1e30, give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a (the low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Reductions over the quad of lanes that share a row of the accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;  // o's strides (elements) over b, h, s
  int H, G, S, T, D;           // G = H / KV
  int n_qt;                    // query tiles
  int causal, has_window, window;
  float scale, scale_log2, cap;  // scale_log2 = scale log2(e)
};

// DPAD: the head dim padded to a multiple of 64 (64, 128 or 256).
template <int DPAD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int NCH = DPAD / CHUNK;
  constexpr int TILE_BYTES = NCH * CHUNK_BYTES;  // one K or V stage, one Q half
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;                        // 2 x TILE_BYTES
  const uint32_t k_smem = q_smem + 2 * TILE_BYTES;     // STAGES x TILE_BYTES
  const uint32_t v_smem = k_smem + STAGES * TILE_BYTES;
  const uint32_t bars = v_smem + STAGES * TILE_BYTES;  // q, k[2], v[2], empty[2]
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  // the query tile is the slowest grid dim, counted down: longest tiles first
  const int head = blockIdx.x, b = blockIdx.y;
  const int qt = p.n_qt - 1 - (int)blockIdx.z;
  const int kv_head = head / p.G;
  const int q0 = qt * BM;

  // the key range any query of the block may see, in tiles of BN
  const int q_last = min(q0 + BM, p.S) - 1;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.has_window) {
    const int first = q0 - p.window + 1;
    k_begin = first > 0 ? first / BN * BN : 0;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      mbar_expect_tx(q_full, 2 * TILE_BYTES);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(q_smem + (w * NCH + c) * CHUNK_BYTES, &tm_q, q_full, c * CHUNK, q0 + w * WM,
                   head, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
        const int k0 = k_begin + j * BN;
        mbar_expect_tx(k_full(s), TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(k_smem + s * TILE_BYTES + c * CHUNK_BYTES, &tm_k, k_full(s), c * CHUNK, k0,
                   kv_head, b);
        mbar_expect_tx(v_full(s), TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(v_smem + s * TILE_BYTES + c * CHUNK_BYTES, &tm_v, v_full(s), c * CHUNK, k0,
                   kv_head, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int qw0 = q0 + wg * WM;                  // the warpgroup's first query
    const int r0 = qw0 + warp * 16 + lane / 4;     // this thread's two rows
    const int r1 = r0 + 8;
    const int cq = 2 * (lane % 4);                 // its first column in an 8-column group

    // element i of o sits at row (i / 2) % 2 ? r1 : r0, column 8 (i / 4) +
    // cq + i % 2, as in every accumulator below
    float o[DPAD / 2];
#pragma unroll
    for (int i = 0; i < DPAD / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    const uint32_t q_wg = q_smem + wg * TILE_BYTES;
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t par = (j / STAGES) & 1;
      const int k0 = k_begin + j * BN;
      // tiles none of this warpgroup's rows may see, and tiles that need the mask
      const bool skip = (p.causal && k0 > qw0 + WM - 1) ||
                        (p.has_window && k0 + BN - 1 <= qw0 - p.window);
      const bool masked = k0 + BN > p.T || (p.causal && k0 + BN - 1 > qw0) ||
                          (p.has_window && k0 <= qw0 + WM - 1 - p.window);
      // every consumer waits for every tile, so that the barriers' phases
      // stay in step and no copy is in flight when the block ends
      mbar_wait(k_full(s), par);
      if (skip) {
        mbar_wait(v_full(s), par);
      } else {
        // ---- S = Q K^T ----
        float sc[32];
        const uint32_t k_st = k_smem + s * TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DPAD / 16; ++kk) {
          const uint32_t off = (kk / 4) * CHUNK_BYTES + (kk % 4) * 32;
          wgmma_ss(sc, desc(q_wg + off, 16, 1024), desc(k_st + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        // ---- online softmax in log2 units (x = s scale log2(e), so that
        // p = 2^(x - m) = exp(s scale - m / log2(e))); element i sits at
        // row (i / 2) % 2 ? r1 : r0, column k0 + 8 (i / 4) + cq + i % 2 ----
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x;
          if (p.cap != 0.f) x = tanhf(sc[i] * p.scale / p.cap) * p.cap * LOG2E;
          else x = sc[i] * p.scale_log2;
          if (masked) {
            const int kp = k0 + 8 * (i / 4) + cq + i % 2;
            const int qp = (i / 2) % 2 ? r1 : r0;
            if (!(kp < p.T && (!p.causal || kp <= qp) && (!p.has_window || kp > qp - p.window)))
              x = NEG_INF;
          }
          sc[i] = x;
          if ((i / 2) % 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        // a masked logit gives p = 2^(-1e30 - m) = 0; a row no key has
        // reached yet (m still -1e30) subtracts 0 instead, for the same 0
        const float base0 = mn0 == NEG_INF ? 0.f : mn0, base1 = mn1 == NEG_INF ? 0.f : mn1;
        // p as the sum of two bf16 values, hi = bf16(p) and lo = bf16(p - hi)
        // (p - hi is exact), so that p v carries p to ~2^-18 of itself
        float sum0 = 0.f, sum1 = 0.f;
        uint32_t hi[16], lo[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float base = (i / 2) % 2 ? base1 : base0;
          const float pa = ex2(sc[i] - base), pb = ex2(sc[i + 1] - base);
          if ((i / 2) % 2) sum1 += pa + pb;
          else sum0 += pa + pb;
          const __nv_bfloat162 h = __floats2bfloat162_rn(pa, pb);
          const float2 hf = __bfloat1622float2(h);
          hi[i / 2] = *reinterpret_cast<const uint32_t*>(&h);
          lo[i / 2] = pack_bf16(pa - hf.x, pb - hf.y);
        }
        const float a0 = ex2(fminf(m0 - mn0, 0.f)), a1 = ex2(fminf(m1 - mn1, 0.f));
        l0 = a0 * l0 + quad_sum(sum0);
        l1 = a1 * l1 + quad_sum(sum1);
        m0 = mn0;
        m1 = mn1;
        // o *= alpha, skipped by a warp none of whose rows' maxima moved
        // (a multiply by exactly 1)
        if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
          for (int i = 0; i < DPAD / 2; ++i) o[i] *= (i / 2) % 2 ? a1 : a0;
        }

        // ---- O += P_lo V + P_hi V: keys 16 kk .. 16 kk + 15 are the P
        // registers 4 kk .. 4 kk + 3 (accumulator column groups 2 kk and
        // 2 kk + 1) ----
        mbar_wait(v_full(s), par);
        const uint32_t v_st = v_smem + s * TILE_BYTES;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          // keys 16 kk .. 16 kk + 15 of every chunk: N spans the chunks at
          // the leading byte offset, K steps 8 keys at the stride offset
          const uint64_t dv = desc(v_st + kk * 2048, CHUNK_BYTES, 1024);
          wgmma_pv<DPAD>(o, lo + 4 * kk, dv);
          wgmma_pv<DPAD>(o, hi + 4 * kk, dv);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
        fence_regs(hi);
        fence_regs(lo);
      }
      mbar_arrive(empty(s));
    }

    // ---- epilogue: O / l in bf16, rows < S and columns < D ----
    const float inv0 = l0 == 0.f ? 1.f : l0, inv1 = l1 == 0.f ? 1.f : l1;
    __nv_bfloat16* ob = p.o + (long long)b * p.o_sb + (long long)head * p.o_sh;
#pragma unroll
    for (int i = 0; i < DPAD / 2; i += 2) {
      const int row = (i / 2) % 2 ? r1 : r0;
      const int col = 8 * (i / 4) + cq;
      const float li = (i / 2) % 2 ? inv1 : inv0;
      if (row < p.S && col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * p.o_ss + col) =
            __floats2bfloat162_rn(o[i] / li, o[i + 1] / li);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (D, rows, heads, batch) of bf16 with the given element strides
// over rows, heads and batch; boxes of 64 columns x 64 rows, 128-byte swizzle,
// zeros outside.
bool encode(CUtensorMap* map, const void* ptr, long long D, long long rows, long long heads,
            long long batch, long long s_row, long long s_head, long long s_batch) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {CHUNK, 64, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DPAD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DPAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(DPAD));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)p.H, (unsigned)B, (unsigned)p.n_qt);
  flash_fwd_sm90_kernel<DPAD><<<grid, THREADS, smem_bytes(DPAD), stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, S, D), o (B, H, S, D), k and v (B, KV, T, D), bf16, each given by
// its pointer and its element strides over (b, head, row); the last dim is
// contiguous. Needs B, H, S, T >= 1, D % 8 == 0, D <= 256, H % KV == 0,
// every stride a multiple of 8 elements, the pointers 16-byte aligned,
// B <= 65,535, S and T < 2^31 - 128 and S <= 65,535 x 128. ``window`` is read when
// has_window is set. Returns the launch's cudaError_t (cudaErrorNotSupported
// when no tensor map could be encoded).
extern "C" int flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, long long B, long long H, long long KV,
    long long S, long long T, long long D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int has_window, long long window,
    float cap, void* stream) {
  if (B < 1 || H < 1 || S < 1 || T < 1 || D < 8 || D > 256 || D % 8 != 0 || KV < 1 ||
      H % KV != 0 || H > 0x7fffffffLL || B > 65535 || S > 0x7fffff00LL || T > 0x7fffff00LL ||
      (S + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (long long s : {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss})
    if (s % 8 != 0) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, (const void*)o})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, S, H, B, q_ss, q_sh, q_sb) ||
      !encode(&tk, k, D, T, KV, B, k_ss, k_sh, k_sb) ||
      !encode(&tv, v, D, T, KV, B, v_ss, v_sh, v_sb))
    return (int)cudaErrorNotSupported;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.H = (int)H;
  p.G = (int)(H / KV);
  p.S = (int)S;
  p.T = (int)T;
  p.D = (int)D;
  p.n_qt = (int)((S + BM - 1) / BM);
  p.causal = causal;
  // a window of S or more masks nothing; one of 0 or less masks every key
  p.has_window = has_window && window < S;
  p.window = window < 0 ? 0 : (int)(window < S ? window : S);
  p.scale = (float)(1.0 / std::sqrt((double)D));
  p.scale_log2 = (float)((double)p.scale * 1.4426950408889634);
  p.cap = cap;
  if (D <= 64) return launch<64>(tq, tk, tv, p, (int)B, st);
  if (D <= 128) return launch<128>(tq, tk, tv, p, (int)B, st);
  return launch<256>(tq, tk, tv, p, (int)B, st);
}
