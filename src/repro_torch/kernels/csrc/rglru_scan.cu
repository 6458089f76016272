// RG-LRU diagonal linear recurrence, float32: a warp per 32 columns walks
// time step by step, with the steps ahead streamed into shared memory.
//
// Replaces the Pallas kernel _rglru_kernel of src/repro/kernels/rglru_scan.py.
// Per (b, w):
//
//     h_t = a_t * h_{t-1} + x_t,   t = 0 .. T-1,   h_{-1} = h0
//
// The Pallas kernel tiles width into VPU lanes and walks time in chunks on a
// sequential grid axis, with h in VMEM scratch between chunks (so a chunk
// must divide T). Here a lane owns one column and walks the whole time axis
// with h in a register, in the plain version's order: no state leaves the
// SM, and any T >= 1 and any W work.
//
// What bounds it on an H100: bytes. a and x are read once and h written once
// (h0 and h_T beside them): 151.0 MB, 45.1 us at 3.35 TB/s at (1, 3072,
// 4096); 201.6 MB, 60.2 us at (8, 512, 4096). The arithmetic is one multiply
// and one add an element, and the walk's dependent chain is two operations a
// step (~15 us for 3,072 steps), under the bound. To stream at 3.35 TB/s the
// card needs about 2 MB of loads in flight; a thread per column that loads a
// few steps ahead into registers keeps ~0.26 MB in flight at B = 1, and runs
// at a seventh of the rate. So each warp streams its 32 columns' a and x for
// the steps ahead into a ring of STAGES stages of SPAN steps in shared
// memory with cp.async, and walks one stage while the next STAGES - 1 are in
// flight (40 KB an SM at B = 1, W = 4096, where a warp has an SM to itself).
// A row of the warp's columns is copied as 8 pieces of 16 bytes by 8
// lanes, and a __syncwarp on each side of a stage's copy orders the lanes;
// so the ring takes W % 32 == 0 and 16-byte aligned a and x, which every
// model width and the model's fresh tensors give. Other inputs, and T <=
// DIRECT (decode), take a thread per column that loads STEPS steps at a
// time straight into registers: no ring.
//
// A parallel scan over chunks of time (chunk maps A h + X folded into each
// chunk's carry; its plain mirror is rglru_scan_chunked_plain in
// kernels/ref.py) would need no long walk, but its carries do not round as
// the walk does. With decays that contract fast it holds 1e-6 against the
// plain version. With a trained model's decays (a^8 in (0.9, 0.999) per
// channel) at (1, 3072, 4096), and with decays near 1 at T = 64, it lies
// outside 1e-6 of the plain version at every chunk size tried, while the
// plain version is itself outside 1e-6 of the exact (float64) answer
// (tests/test_torch_rglru_scan.py). The limit is below the fp32 walk's own
// rounding, so this walk keeps the plain version's order and equals it bit
// for bit.
//
// Built with -fmad=false: a * h + x rounds the product and then the sum, as
// the plain PyTorch version computes it.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;   // columns of a block: one warp
constexpr int SPAN = 32;    // time steps of a stage of the ring
constexpr int DIRECT = 16;  // T up to which a launch needs no ring
constexpr int DIRECT_THREADS = 64;  // threads of a block without a ring
constexpr int STEPS = 8;    // steps a thread without a ring loads ahead
constexpr int STAGES = 6;   // stages of the ring (48 KB)
constexpr int STAGE_BYTES = SPAN * 2 * LANES * 4;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A few steps (decode), or inputs the ring does not take: a thread per
// column, STEPS steps at a time loaded into registers before their
// dependent chain runs, no ring. The grid's y is the batch row.
__global__ void __launch_bounds__(DIRECT_THREADS)
    rglru_kernel_direct(const float* __restrict__ a, const float* __restrict__ x,
                        const float* __restrict__ h0, float* __restrict__ h_out,
                        float* __restrict__ h_fin, long long T, long long W) {
  const long long w = (long long)blockIdx.x * DIRECT_THREADS + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  const long long base = b * T * W + w;
  float h = h0[b * W + w];
  long long t = 0;
  for (; t + STEPS <= T; t += STEPS) {
    float av[STEPS], xv[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      av[i] = a[base + (t + i) * W];
      xv[i] = x[base + (t + i) * W];
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      h = av[i] * h + xv[i];
      h_out[base + (t + i) * W] = h;
    }
  }
  for (; t < T; ++t) {
    h = a[base + t * W] * h + x[base + t * W];
    h_out[base + t * W] = h;
  }
  h_fin[b * W + w] = h;
}

// A warp per 32 columns of one batch row (a block: `unit`) with its ring;
// W % 32 == 0 and a, x 16-byte aligned.
__global__ void __launch_bounds__(LANES)
    rglru_kernel(const float* __restrict__ a, const float* __restrict__ x,
                 const float* __restrict__ h0, float* __restrict__ h_out,
                 float* __restrict__ h_fin, long long T, long long W,
                 long long groups) {
  extern __shared__ float ring[];  // [stage][step][a or x][lane]
  const int lane = threadIdx.x;
  const long long unit = blockIdx.x;
  const long long b = unit / groups;
  const long long col = (unit % groups) * LANES + lane;
  const long long base = b * T * W + col;
  const long long row0 = base - lane;  // the warp's first column
  const long long stages = (T + SPAN - 1) / SPAN;
  float h = h0[b * W + col];
  auto fetch = [&](long long s) {  // copy stage s into its slot
    if (s < stages) {
      float* slot = ring + (s % STAGES) * (SPAN * 2 * LANES);
      const long long t0 = s * SPAN;
#pragma unroll
      for (int m = 0; m < SPAN * 2 * 8 / LANES; ++m) {  // 8 copies a row
        const int e = lane + LANES * m;
        const int i = e / 16, arr = (e / 8) % 2, q = e % 8;
        if (t0 + i < T)
          cp_async16(slot + (2 * i + arr) * LANES + 4 * q,
                     (arr ? x : a) + row0 + (t0 + i) * W + 4 * q);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (long long s = 0; s < stages; ++s) {
    __syncwarp();  // every lane is done with the slot refilled next
    fetch(s + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // stage s has landed
    __syncwarp();  // and the other lanes' copies with it
    const float* slot = ring + (s % STAGES) * (SPAN * 2 * LANES) + lane;
    const long long t0 = s * SPAN;
    if (t0 + SPAN <= T) {
#pragma unroll
      for (int i = 0; i < SPAN; ++i) {
        h = slot[(2 * i) * LANES] * h + slot[(2 * i + 1) * LANES];
        h_out[base + (t0 + i) * W] = h;
      }
    } else {
      for (int i = 0; t0 + i < T; ++i) {
        h = slot[(2 * i) * LANES] * h + slot[(2 * i + 1) * LANES];
        h_out[base + (t0 + i) * W] = h;
      }
    }
  }
  h_fin[b * W + col] = h;
}

}  // namespace

// a, x, h_out (B, T, W); h0, h_fin (B, W); all float32, contiguous, on the
// current device; T >= 1. Returns the launch's cudaError_t.
extern "C" int rglru_f32(const void* a, const void* x, const void* h0,
                         void* h_out, void* h_fin, long long B, long long T,
                         long long W, void* stream) {
  if (B * W == 0) return (int)cudaSuccess;
  const long long groups = (W + LANES - 1) / LANES;
  const long long units = B * groups;
  if (T < 1 || units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* ap = static_cast<const float*>(a);
  const float* xp = static_cast<const float*>(x);
  const float* hp = static_cast<const float*>(h0);
  float* op = static_cast<float*>(h_out);
  float* fp = static_cast<float*>(h_fin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = W % LANES == 0 && reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0;
  if (T <= DIRECT || !vec) {
    const long long blocks_w = (W + DIRECT_THREADS - 1) / DIRECT_THREADS;
    constexpr long long ROWS = 65535;  // batch rows a grid's y holds
    for (long long b0 = 0; b0 < B; b0 += ROWS) {
      const dim3 grid((unsigned)blocks_w, (unsigned)(B - b0 < ROWS ? B - b0 : ROWS));
      rglru_kernel_direct<<<grid, DIRECT_THREADS, 0, st>>>(
          ap + b0 * T * W, xp + b0 * T * W, hp + b0 * W, op + b0 * T * W, fp + b0 * W, T, W);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  // several blocks' rings share an SM
  static const cudaError_t carveout = cudaFuncSetAttribute(
      rglru_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return (int)carveout;
  rglru_kernel<<<(unsigned)units, LANES, STAGES * STAGE_BYTES, st>>>(
      ap, xp, hp, op, fp, T, W, groups);
  return (int)cudaGetLastError();
}
