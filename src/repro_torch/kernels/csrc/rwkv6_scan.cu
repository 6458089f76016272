// RWKV-6 WKV recurrence, float32, read and written in the caller's strides.
//
// Replaces the Pallas kernel _wkv_kernel of src/repro/kernels/rwkv6_scan.py.
// Per (b, h), with key index i and value index j over the head dim D:
//
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// The Pallas kernel walks time in chunks on a sequential grid axis and keeps
// S in VMEM scratch between chunks. Here the time loop runs inside a block
// and S stays in registers, so T needs no chunk that divides it.
//
// What bounds it on an H100: by the data sheet, bytes. Each input is read
// once and y written once (5 B H T D floats), u and the state in and out
// once: 220.2 MB, 65.7 us at 3.35 TB/s at (8, 40, 512, 64); at T = 1 the
// state is most of it (10.9 MB, 3.26 us). The arithmetic, 5 D^2 flops a
// step of a (b, h) (3.36 GFLOP there, ~15 flops a byte), is under the fp32
// CUDA cores' balance point of ~20, so no tensor-core form is called for.
// In practice the step loop bounds it, not the bytes: each state value
// costs three fp32 instructions a step (k v, r S, w S + k v), and the rows
// of r, k, w it needs come from shared memory, whose 128-bit reads take a
// quarter warp at a time whatever the address. The design:
//
// * Column j of S evolves on its own (y_t[j] needs only S[:, j]), so a
//   block holds 32 columns of one (b, h): 8 row groups of 8 rows, a thread
//   8 rows x 2 columns of S in registers, the threads of a row group on
//   adjacent lanes (one address a quarter warp). At (8, 40, 512, 64) that is
//   640 blocks of four warps.
// * The u term is folded out: y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] *
//   sum_i r_t[i] u[i] k_t[i], the last sum computed once a step for the
//   block; the products are written as fmaf.
// * r, k, w for CHUNK steps (and v of the block's columns) are copied into
//   shared memory with cp.async, double-buffered: the next chunk's copy runs
//   under this chunk's steps, and a chunk costs two barriers, not one a
//   step. Each thread's partial y goes to shared memory, and the chunk's y
//   is summed over the row groups and stored as float4 after the steps.
// * Below DIRECT_T steps (decode) a block per (b, h) has a thread per column
//   holding all D rows, so that warps read and write whole 128-byte rows of
//   the state, which is most of the bytes there.
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 16;         // time steps staged at a time
constexpr int STAGES = 2;         // chunks in the ring: one computed, one loading
constexpr int ACC = 4;            // independent partial sums of a column's y
constexpr int DIRECT_T = 4;       // T below which a launch takes the direct kernel

// element strides over (b, h, t) of r, k, v, w, y; the last dim is contiguous
struct Strides {
  long long b[5], h[5], t[5];
};

// A block holds COLS state columns of one (b, h): G = D / R row groups of R
// rows, LG = COLS / C threads a group, C columns a thread. A group's
// threads are consecutive lanes, so a quarter warp reads one row group.
template <int D, int R, int C, int COLS>
struct Shape {
  static constexpr int TILES = D / COLS;  // blocks of a (b, h)
  static constexpr int G = D / R;
  static constexpr int LG = COLS / C;
  static constexpr int NT = G * LG;       // threads of a block
  static constexpr int Q = D / 4;         // float4 of a row
  static constexpr int PR = D / 8;        // threads summing a step's r u k, 8 indices each
  static_assert(C <= 2, "a thread's columns, read one by one");
  static_assert(NT % PR == 0 && (NT >= 32 || NT == D), "r u k by whole groups of lanes");
};

template <int D, int R, int COLS>
struct Smem {
  float4 rkw[STAGES][3][CHUNK][D / 4];  // r, k, w rows of a chunk, a ring
  float4 v[STAGES][CHUNK][COLS / 4];    // v at the block's columns
  float4 u[D / 4];                 // u of the head
  float ruk[CHUNK];                // sum_i r u k, a step
  // partial y of each row group, [step][column]; 4 words of padding between
  // groups
  alignas(16) float part[D / R][CHUNK * COLS + 4];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int C>
__device__ __forceinline__ void load_cols(float (&dst)[C], const float* src) {
#pragma unroll
  for (int cc = 0; cc < C; ++cc) dst[cc] = src[cc];
}

template <int C>
__device__ __forceinline__ void store_cols(float* dst, const float (&src)[C]) {
#pragma unroll
  for (int cc = 0; cc < C; ++cc) dst[cc] = src[cc];
}

template <int D, int R, int C, int COLS>
__global__ void __launch_bounds__(Shape<D, R, C, COLS>::NT)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out, Strides st,
                int H, int T) {
  using S = Shape<D, R, C, COLS>;
  constexpr int G = S::G, NT = S::NT, Q = S::Q, PR = S::PR;
  // lanes of the r u k sums (below 32 only for D = 16)
  constexpr unsigned MASK = CHUNK * PR >= 32 ? 0xffffffffu : (1u << (CHUNK * PR)) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<D, R, COLS>& sm = *reinterpret_cast<Smem<D, R, COLS>*>(smem);

  const int tid = threadIdx.x;
  const int g = tid / S::LG;          // row group: rows g * R ..
  const int jl = (tid % S::LG) * C;   // first of the thread's columns in the tile
  const int tile = (int)(blockIdx.x % S::TILES);
  const long long bh = blockIdx.x / S::TILES;
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const int j0 = tile * COLS;

  // r, k, w, v of this (b, h) and their time strides (Strides order: r, k,
  // v, w, y)
  const float* src[4] = {r + b * st.b[0] + h * st.h[0], k + b * st.b[1] + h * st.h[1],
                         w + b * st.b[3] + h * st.h[3], v + b * st.b[2] + h * st.h[2] + j0};
  const long long str[4] = {st.t[0], st.t[1], st.t[3], st.t[2]};

  const int nchunks = (T + CHUNK - 1) / CHUNK;
  // stage chunk c (steps t0 .. t0 + n - 1) into its slot of the ring; a
  // chunk past the end commits an empty group, which keeps the count
  auto stage = [&](int c) {
    const int buf = c % STAGES;
    const int t0 = c * CHUNK;
    const int n = c < nchunks ? min(CHUNK, T - t0) : 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      for (int e = tid; e < CHUNK * Q; e += NT) {
        const int tt = e / Q, q = e % Q;
        if (tt < n) cp_async16(&sm.rkw[buf][m][tt][q], src[m] + (t0 + tt) * str[m] + 4 * q);
      }
    }
    for (int e = tid; e < CHUNK * COLS / 4; e += NT) {
      const int tt = e / (COLS / 4), q = e % (COLS / 4);
      if (tt < n) cp_async16(&sm.v[buf][tt][q], src[3] + (t0 + tt) * str[3] + 4 * q);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) stage(c);

  float s[R][C];
  const float* s_in = s0 + bh * D * D + (long long)g * R * D + j0 + jl;
#pragma unroll
  for (int i = 0; i < R; ++i) load_cols<C>(s[i], s_in + i * D);
  for (int q = tid; q < Q; q += NT) sm.u[q] = reinterpret_cast<const float4*>(u + h * D)[q];

  const long long y_base = b * st.b[4] + h * st.h[4] + j0;
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c % STAGES;
    const int t0 = c * CHUNK;
    const int n = min(CHUNK, T - t0);
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is staged; chunk c - 1's epilogue is done
    stage(c + STAGES - 1);  // into chunk c - 1's slot

    // sum_i r u k of each step: PR consecutive threads, 8 indices each
    for (int task = tid; task < CHUNK * PR; task += NT) {
      const int tt = task / PR, part = task % PR;
      const float4* rr = &sm.rkw[buf][0][tt][2 * part];
      const float4* kk = &sm.rkw[buf][1][tt][2 * part];
      const float4* uu = &sm.u[2 * part];
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 a = rr[q], bk = kk[q], cu = uu[q];
        acc = fmaf(a.x, cu.x * bk.x, acc);
        acc = fmaf(a.y, cu.y * bk.y, acc);
        acc = fmaf(a.z, cu.z * bk.z, acc);
        acc = fmaf(a.w, cu.w * bk.w, acc);
      }
#pragma unroll
      for (int off = 1; off < PR; off *= 2) acc += __shfl_xor_sync(MASK, acc, off);
      if (part == 0) sm.ruk[tt] = acc;
    }

    // one step: the state update, and this thread's partial y in `out`.
    // ACC independent sums a column keep the chain of adds short.
    auto step = [&](int tt, float (&out)[C]) {
      float vj[C];
      load_cols<C>(vj, reinterpret_cast<const float*>(&sm.v[buf][tt][0]) + jl);
      const float4* rr = &sm.rkw[buf][0][tt][g * (R / 4)];
      const float4* kk = &sm.rkw[buf][1][tt][g * (R / 4)];
      const float4* ww = &sm.rkw[buf][2][tt][g * (R / 4)];
      float acc[C][ACC];
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
#pragma unroll
        for (int m = 0; m < ACC; ++m) acc[cc][m] = 0.0f;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 a4 = rr[q], k4 = kk[q], w4 = ww[q];
        const float ra[4] = {a4.x, a4.y, a4.z, a4.w};
        const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wa[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            float& x = s[4 * q + e][cc];
            float& sum = acc[cc][(4 * q + e) % ACC];
            sum = fmaf(ra[e], x, sum);
            x = fmaf(wa[e], x, ka[e] * vj[cc]);
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        float total = acc[cc][0];
#pragma unroll
        for (int m = 1; m < ACC; ++m) total += acc[cc][m];
        out[cc] = total;
      }
    };
    if (n == CHUNK) {
#pragma unroll
      for (int tt = 0; tt < CHUNK; ++tt) {
        float part[C];
        step(tt, part);
        store_cols<C>(&sm.part[g][tt * COLS + jl], part);
      }
    } else {
      for (int tt = 0; tt < n; ++tt) {
        float part[C];
        step(tt, part);
        store_cols<C>(&sm.part[g][tt * COLS + jl], part);
      }
    }
    __syncthreads();  // partial sums and r u k of the chunk are in place

    // y = v * (r u k) + the row groups' partial sums, a float4 a thread
    for (int e = tid; e < CHUNK * COLS / 4; e += NT) {
      const int tt = e / (COLS / 4), q = e % (COLS / 4);
      if (tt < n) {
        float4 out = sm.v[buf][tt][q];
        const float ruk = sm.ruk[tt];
        out.x *= ruk;
        out.y *= ruk;
        out.z *= ruk;
        out.w *= ruk;
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float4 p = reinterpret_cast<const float4*>(&sm.part[gg][tt * COLS])[q];
          out.x += p.x;
          out.y += p.y;
          out.z += p.z;
          out.w += p.w;
        }
        *reinterpret_cast<float4*>(y + y_base + (t0 + tt) * st.t[4] + 4 * q) = out;
      }
    }
  }

  float* s_fin = s_out + bh * D * D + (long long)g * R * D + j0 + jl;
#pragma unroll
  for (int i = 0; i < R; ++i) store_cols<C>(s_fin + i * D, s[i]);
}

// A few steps (decode): a block per (b, h), a thread per column j holding
// all D rows of S[:, j], so that a warp reads and writes whole 128-byte rows
// of the state, which is most of the bytes at T = 1. Each step stages r, k,
// w (and u once) in shared memory, one barrier on each side.
template <int D>
__global__ void __launch_bounds__(D)
    wkv6_kernel_direct(const float* __restrict__ r, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       float* __restrict__ y, float* __restrict__ s_out, Strides st,
                       int H, int T) {
  __shared__ __align__(16) float rkwu[4][D];
  const int j = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long b = bh / H;
  const int h = (int)(bh % H);
  float x[D];
  const float* s_in = s0 + bh * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = s_in[i * D];
  rkwu[3][j] = u[h * D + j];
  for (int t = 0; t < T; ++t) {
    rkwu[0][j] = r[b * st.b[0] + h * st.h[0] + t * st.t[0] + j];
    rkwu[1][j] = k[b * st.b[1] + h * st.h[1] + t * st.t[1] + j];
    rkwu[2][j] = w[b * st.b[3] + h * st.h[3] + t * st.t[3] + j];
    const float vj = v[b * st.b[2] + h * st.h[2] + t * st.t[2] + j];
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 rr = reinterpret_cast<const float4*>(rkwu[0])[q];
      const float4 kk = reinterpret_cast<const float4*>(rkwu[1])[q];
      const float4 ww = reinterpret_cast<const float4*>(rkwu[2])[q];
      const float4 uu = reinterpret_cast<const float4*>(rkwu[3])[q];
      const float ra[4] = {rr.x, rr.y, rr.z, rr.w}, ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wa[4] = {ww.x, ww.y, ww.z, ww.w}, ua[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& xi = x[4 * q + e];
        const float kv = ka[e] * vj;
        acc[e] = fmaf(ra[e], fmaf(ua[e], kv, xi), acc[e]);
        xi = fmaf(wa[e], xi, kv);
      }
    }
    y[b * st.b[4] + h * st.h[4] + t * st.t[4] + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    __syncthreads();  // before the next step's r, k, w
  }
  float* s_fin = s_out + bh * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) s_fin[i * D] = x[i];
}

template <int D, int R, int C, int COLS>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, const Strides& st, long long B, long long H,
                   long long T, cudaStream_t stream) {
  using S = Shape<D, R, C, COLS>;
  const long long blocks = B * H * S::TILES;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int bytes = sizeof(Smem<D, R, COLS>);
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(wkv6_kernel<D, R, C, COLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_kernel<D, R, C, COLS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  wkv6_kernel<D, R, C, COLS><<<(unsigned)blocks, S::NT, bytes, stream>>>(
      r, k, v, w, u, s0, y, s_out, st, (int)H, (int)T);
  return cudaGetLastError();
}

// the kernel and shape each head dim and length are launched with
template <int D>
cudaError_t launch_d(const float* r, const float* k, const float* v,
                     const float* w, const float* u, const float* s0, float* y,
                     float* s_out, const Strides& st, long long B, long long H,
                     long long T, cudaStream_t stream) {
  if (T < DIRECT_T) {
    if (B * H > 0x7fffffffLL) return cudaErrorInvalidValue;
    wkv6_kernel_direct<D><<<(unsigned)(B * H), D, 0, stream>>>(r, k, v, w, u, s0, y, s_out,
                                                               st, (int)H, (int)T);
    return cudaGetLastError();
  }
  if constexpr (D == 64)
    return launch<64, 8, 2, 32>(r, k, v, w, u, s0, y, s_out, st, B, H, T, stream);
  else if constexpr (D == 32)
    return launch<32, 8, 2, 32>(r, k, v, w, u, s0, y, s_out, st, B, H, T, stream);
  else
    return launch<16, 8, 1, 16>(r, k, v, w, u, s0, y, s_out, st, B, H, T, stream);
}

}  // namespace

// r, k, v, w, y (B, H, T, D) float32 in the strides given (`strides`: 15
// element strides, (b, h, t) of r, k, v, w, y in turn; each a multiple of 4,
// the last dim contiguous); u (H, D) and s0, s_out (B, H, D, D) float32 and
// contiguous; r, k, v, w, y and u 16-byte aligned; all on the current device;
// 1 <= T < 2^31 and D in {16, 32, 64}. Returns the launch's cudaError_t.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* y,
                        void* s_out, long long B, long long H, long long T,
                        long long D, const long long* strides, void* stream) {
  if (B * H == 0) return (int)cudaSuccess;
  if (T < 1 || T > 0x7fffffffLL || H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int n = 0; n < 5; ++n) {
    st.b[n] = strides[3 * n];
    st.h[n] = strides[3 * n + 1];
    st.t[n] = strides[3 * n + 2];
    if (st.b[n] % 4 || st.h[n] % 4 || st.t[n] % 4) return (int)cudaErrorMisalignedAddress;
  }
  const void* const ptrs[6] = {r, k, v, w, y, u};
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16) return (int)cudaErrorMisalignedAddress;
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(s_out);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return (int)launch_d<16>(rp, kp, vp, wp, up, sp, yp, op, st, B, H, T, sm);
    case 32:
      return (int)launch_d<32>(rp, kp, vp, wp, up, sp, yp, op, st, B, H, T, sm);
    case 64:
      return (int)launch_d<64>(rp, kp, vp, wp, up, sp, yp, op, st, B, H, T, sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
