// B3: fused YOLO stem, nodes 0 + 1 in one kernel:
//   P1 = SiLU(conv k3 s2 p1 (x, w0) + b0)     3 -> c0 channels
//   P2 = SiLU(conv k3 s2 p1 (P1, w1) + b1)    c0 -> c1 channels
//
// Replaces: realtime_analytics_tpu/ops/pallas_stem.py::_kernel (reached
// from fused_stem_p1p2, pallas_call at :283). The TPU version rebuilds both
// convs as block-Toeplitz [128, 128] matmul pieces over a space-to-depth
// input so that 16/32 channels fill the 128-lane MXU. None of that carries
// over: here each block owns a T x T tile of P2 outputs and computes, in
// order,
//   1. the (4T+3)^2 x 3 input patch the tile needs, loaded coalesced into
//      shared memory; pixels outside [0, H) x [0, W) are 0 (conv0's pad);
//   2. the (2T+1)^2 x c0 P1 tile with its one-row / one-column halo, into
//      shared memory: fp32 accumulation, bias and SiLU in fp32, then rounded
//      to the compute dtype, as the unfused chain materialises P1 in that
//      dtype. P1 positions outside [0, H/2) x [0, W/2) are 0 (conv1's pad);
//   3. the T x T x c1 P2 outputs from the shared P1 tile, fp32
//      accumulation, bias and SiLU in fp32, one rounding on the store.
// P1 never touches device memory. The halo is recomputed by neighbouring
// blocks (about 13% more conv0 work at T = 8) instead of being exchanged.
// The weights (27 c0 + 9 c0 c1 values, 432 + 4,608 for v8n) sit in shared
// memory as fp32 copies of the compute-dtype values, laid out once at
// engine build (HWIO: [ky][kx][ci][co]), so consecutive threads read
// consecutive output channels.
//
// What bounds it on the card: at N=32 and 640 input it must read 78.6 MB of
// bf16 input and write 52.4 MB (131 MB, ~39 us at 3.35 TB/s) and do 10.4
// GFLOP (~10.5 us on bf16 tensor cores), so the floor is the memory. This
// first version runs its MACs on the fp32 CUDA cores out of shared memory
// (67 TFLOP/s peak, ~155 us for the same FLOPs), so it sits well above the
// memory floor; moving both convs onto wgmma is later work.
//
// The kernel needs no relation between c0 and c1 (unlike the TPU kernel's
// c1 == 2*c0 invariant); the wrapper's geometry gate asks only for H and W
// divisible by 4 and for the shared-memory plan to fit one block.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 8;  // P2 tile edge (ops/stem.py STEM_TILE mirrors it)
constexpr int kP1 = 2 * kT + 1;       // P1 tile edge incl. halo (17)
constexpr int kIn = 4 * kT + 3;       // input patch edge (35)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w0,
            const float* __restrict__ b0, const float* __restrict__ w1,
            const float* __restrict__ b1, T* __restrict__ out, int H, int W,
            int c0, int c1) {
  extern __shared__ float smem[];
  float* s_in = smem;                        // kIn * kIn * 3
  float* s_p1 = s_in + kIn * kIn * 3;        // kP1 * kP1 * c0
  float* s_w0 = s_p1 + kP1 * kP1 * c0;       // 27 * c0
  float* s_w1 = s_w0 + 27 * c0;              // 9 * c0 * c1
  float* s_b0 = s_w1 + 9 * c0 * c1;          // c0
  float* s_b1 = s_b0 + c0;                   // c1

  const int H1 = H / 2, W1 = W / 2, H2 = H / 4, W2 = W / 4;
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * kT, ox0 = blockIdx.x * kT;  // P2 tile origin
  const int py0 = 2 * oy0 - 1, px0 = 2 * ox0 - 1;         // P1 tile origin
  const int iy0 = 2 * py0 - 1, ix0 = 2 * px0 - 1;         // input origin
  const int tid = threadIdx.x;

  for (int i = tid; i < 27 * c0; i += kThreads) s_w0[i] = w0[i];
  for (int i = tid; i < 9 * c0 * c1; i += kThreads) s_w1[i] = w1[i];
  for (int i = tid; i < c0; i += kThreads) s_b0[i] = b0[i];
  for (int i = tid; i < c1; i += kThreads) s_b1[i] = b1[i];

  // 1. input patch (NHWC: a patch row is 3 * kIn contiguous values)
  const T* xn = x + (int64_t)n * H * W * 3;
  for (int i = tid; i < kIn * kIn * 3; i += kThreads) {
    const int c = i % 3, pix = i / 3;
    const int gy = iy0 + pix / kIn, gx = ix0 + pix % kIn;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = to_f32(xn[((int64_t)gy * W + gx) * 3 + c]);
    }
    s_in[i] = v;
  }
  __syncthreads();

  // 2. P1 tile with halo, rounded to the compute dtype
  for (int i = tid; i < kP1 * kP1 * c0; i += kThreads) {
    const int co = i % c0, pix = i / c0;
    const int r = pix / kP1, q = pix % kP1;
    const int gy = py0 + r, gx = px0 + q;
    float v = 0.f;
    if (gy >= 0 && gy < H1 && gx >= 0 && gx < W1) {
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* px = s_in + ((2 * r + ky) * kIn + (2 * q + kx)) * 3;
          const float* wk = s_w0 + (ky * 3 + kx) * 3 * c0 + co;
          acc += px[0] * wk[0] + px[1] * wk[c0] + px[2] * wk[2 * c0];
        }
      }
      v = to_f32(from_f32<T>(silu(acc + s_b0[co])));
    }
    s_p1[i] = v;
  }
  __syncthreads();

  // 3. P2 outputs of this tile
  T* on = out + (int64_t)n * H2 * W2 * c1;
  for (int i = tid; i < kT * kT * c1; i += kThreads) {
    const int co = i % c1, pix = i / c1;
    const int r = pix / kT, q = pix % kT;
    const int oy = oy0 + r, ox = ox0 + q;
    if (oy >= H2 || ox >= W2) continue;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* p = s_p1 + ((2 * r + ky) * kP1 + (2 * q + kx)) * c0;
        const float* wk = s_w1 + (ky * 3 + kx) * c0 * c1 + co;
        for (int ci = 0; ci < c0; ++ci) acc += p[ci] * wk[ci * c1];
      }
    }
    on[((int64_t)oy * W2 + ox) * c1 + co] = from_f32<T>(silu(acc + s_b1[co]));
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1,
           const void* b1, void* out, int n, int H, int W, int c0, int c1,
           cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * ((size_t)kIn * kIn * 3 +
                                       (size_t)kP1 * kP1 * c0 + 27 * c0 +
                                       9 * (size_t)c0 * c1 + c0 + c1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int H2 = H / 4, W2 = W / 4;
  dim3 grid((W2 + kT - 1) / kT, (H2 + kT - 1) / kT, n);
  stem_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<T*>(out), H, W, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, H, W, 3] NHWC contiguous, bf16 or fp32 (is_bf16), pixel scale.
// w0: [3, 3, 3, c0], w1: [3, 3, c0, c1] HWIO fp32; b0 [c0], b1 [c1] fp32.
// out: [n, H/4, W/4, c1] NHWC contiguous, same dtype as x.
extern "C" int rva_fused_stem(int device, const void* x, const void* w0,
                              const void* b0, const void* w1, const void* b1,
                              void* out, int n, int H, int W, int c0, int c1,
                              int is_bf16, void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, w0, b0, w1, b1, out, n, H, W, c0, c1, s);
  }
  return launch<float>(x, w0, b0, w1, b1, out, n, H, W, c0, c1, s);
}
