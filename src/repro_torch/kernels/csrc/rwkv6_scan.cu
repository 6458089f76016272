// RWKV-6 WKV recurrence, float32, one thread block per (batch, head).
//
// Replaces the Pallas kernel _wkv_kernel of src/repro/kernels/rwkv6_scan.py.
// Per (b, h), with key index i and value index j over the head dim D:
//
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// The Pallas kernel walks time in chunks on a sequential grid axis and keeps
// S in VMEM scratch between chunks. Here the whole time loop runs inside one
// block, so no state leaves the SM between steps and T needs no chunk that
// divides it: D threads, thread j holding column S[:, j] in registers (D
// floats), for T steps. At each step the block stages r_t, k_t, w_t in shared
// memory (double-buffered, so one barrier a step suffices), each thread reads
// its own v_t[j], and runs the D-term update of its column.
//
// What bounds it on an H100: the data-sheet bound is bytes (4 * B*H*T*D
// floats in, B*H*T*D out, the D x D state in and out once per (b, h):
// ~220 MB, ~66 us at (8, 40, 512, 64)). This first kernel is bound by the
// latency of its serial chain instead: T dependent steps, each a barrier and
// a D-long dependent sum per thread, with only B*H blocks of D threads on
// the card. The next step's r, k, v, w are loaded into registers before the
// current step computes, so the global-memory latency overlaps the
// arithmetic. A chunked matrix form on the tensor cores is later work.
#include <cuda_runtime.h>

namespace {

template <int D>
__global__ void __launch_bounds__(D)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ s_out, int H,
                long long T) {
  __shared__ float sr[2][D], sk[2][D], sw[2][D], su[D];
  const int j = threadIdx.x;
  const long long bh = blockIdx.x;
  const int h = (int)(bh % H);
  su[j] = u[h * D + j];

  float s[D];
  const float* s_in = s0 + bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = s_in[i * D + j];

  const long long base = bh * T * D + j;
  float rn = r[base], kn = k[base], vn = v[base], wn = w[base];
  for (long long t = 0; t < T; ++t) {
    const long long at = base + t * D;
    const float vt = vn;
    const int b = (int)(t & 1);
    sr[b][j] = rn;
    sk[b][j] = kn;
    sw[b][j] = wn;
    if (t + 1 < T) {
      rn = r[at + D];
      kn = k[at + D];
      vn = v[at + D];
      wn = w[at + D];
    }
    __syncthreads();
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float kv = sk[b][i] * vt;
      acc += sr[b][i] * (s[i] + su[i] * kv);
      s[i] = sw[b][i] * s[i] + kv;
    }
    y[at] = acc;
  }

  float* s_fin = s_out + bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) s_fin[i * D + j] = s[i];
}

template <int D>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, long long B, long long H, long long T,
                   cudaStream_t stream) {
  wkv6_kernel<D><<<(unsigned)(B * H), D, 0, stream>>>(r, k, v, w, u, s0, y,
                                                      s_out, (int)H, T);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, y (B, H, T, D); u (H, D); s0, s_out (B, H, D, D); all float32,
// contiguous, on the current device; T >= 1 and D in {16, 32, 64}. Returns
// the launch's cudaError_t.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* y,
                        void* s_out, long long B, long long H, long long T,
                        long long D, void* stream) {
  if (B * H == 0) return (int)cudaSuccess;
  if (T < 1 || B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return (int)launch<16>(rp, kp, vp, wp, up, sp, yp, op, B, H, T, st);
    case 32:
      return (int)launch<32>(rp, kp, vp, wp, up, sp, yp, op, B, H, T, st);
    case 64:
      return (int)launch<64>(rp, kp, vp, wp, up, sp, yp, op, B, H, T, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
