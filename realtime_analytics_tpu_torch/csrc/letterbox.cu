// B4: bilinear letterbox / stretch resize of a uint8 BGR batch into the
// model's input canvas, one thread per output pixel.
//
// Replaces: realtime_analytics_tpu/ops/pallas_preprocess.py::_kernel
// (reached from pallas_letterbox and pallas_stretch_resize through
// _call_kernel, pallas_call at :207). The TPU version runs the resize of
// each (image, channel) plane as two dense bf16 MXU matmuls against
// [dst, src] interpolation matrices, with the H axis as a row pick or a
// 2-row mean for integer ratios. That is a tactic for the TPU's matrix
// unit; here each output pixel reads its four taps directly.
//
// What it computes, per output pixel (all three channels):
//   * outside the content window: the pad value 114/255;
//   * inside: half-pixel-centre, edge-clamped 2-tap bilinear, H first then
//     W, in fp32 — H(x) = (1-wy) p[y0, x] + wy p[y1, x], then
//     r = (1-wx) H(x0) + wx H(x1). The host builds the taps and weights
//     (y0, y1, wy per output row; x0, x1, wx per output column) from the
//     reference's bilinear_matrix geometry, so the select (wy = 0) and
//     mean2 (wy = 0.5) modes fall out of the tables. The plain version
//     (ops/letterbox.py) runs the same tables in the same order;
//   * round half up as cv2 does, floor(r + 0.5) clipped to 0..255, scale
//     by 1/255, BGR -> RGB, and write NHWC in the output dtype (fp32 or
//     bf16): the channels_last layout of the NCHW-logical model input.
// Weights and the H-pass intermediate stay fp32 (the TPU kernel rounds
// both to bf16 for its MXU).
//
// What bounds it on the card: bytes. It reads the source rows its taps
// touch (2 of every r source rows at a downscale ratio r, all of them at
// r <= 2) and writes the canvas once; the arithmetic is a dozen flops per
// output value. The design writes the whole canvas in one pass, the pad
// included, so no separate fill runs. Staging the source rows in shared
// memory and 16-byte loads and stores are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// taps: int32 [2*new_h + 2*new_w] = y0 | y1 | x0 | x1;
// weights: fp32 [new_h + new_w] = wy | wx (the weight of the second tap).
template <typename OutT>
__global__ void letterbox_kernel(const uint8_t* __restrict__ src,
                                 OutT* __restrict__ out,
                                 const int32_t* __restrict__ taps,
                                 const float* __restrict__ weights,
                                 int64_t total, int src_h, int src_w,
                                 int dst_h, int dst_w, int new_h, int new_w,
                                 int pad_top, int pad_left) {
  const float inv255 = 1.0f / 255.0f;
  const float pad = 114.0f * inv255;
  const int32_t* ty0 = taps;
  const int32_t* ty1 = taps + new_h;
  const int32_t* tx0 = taps + 2 * new_h;
  const int32_t* tx1 = tx0 + new_w;
  const float* twy = weights;
  const float* twx = weights + new_h;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int ox = (int)(i % dst_w);
    const int64_t rest = i / dst_w;
    const int oy = (int)(rest % dst_h);
    const int64_t n = rest / dst_h;
    OutT* o = out + i * 3;
    const int cy = oy - pad_top;
    const int cx = ox - pad_left;
    if (cy < 0 || cy >= new_h || cx < 0 || cx >= new_w) {
      store(o, pad);
      store(o + 1, pad);
      store(o + 2, pad);
      continue;
    }
    const float wy = twy[cy];
    const float wx = twx[cx];
    const uint8_t* img = src + n * src_h * (int64_t)src_w * 3;
    const uint8_t* r0 = img + (int64_t)ty0[cy] * src_w * 3;
    const uint8_t* r1 = img + (int64_t)ty1[cy] * src_w * 3;
    const int a = tx0[cx] * 3;
    const int b = tx1[cx] * 3;
    // explicit round-to-nearest products and sums: no FMA contraction, so
    // the result is bit-equal to the plain version's elementwise ops
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ha = __fadd_rn(__fmul_rn(1.0f - wy, (float)r0[a + c]),
                                 __fmul_rn(wy, (float)r1[a + c]));
      const float hb = __fadd_rn(__fmul_rn(1.0f - wy, (float)r0[b + c]),
                                 __fmul_rn(wy, (float)r1[b + c]));
      float r = __fadd_rn(__fmul_rn(1.0f - wx, ha), __fmul_rn(wx, hb));
      r = fminf(fmaxf(floorf(__fadd_rn(r, 0.5f)), 0.0f), 255.0f);
      store(o + (2 - c), __fmul_rn(r, inv255));  // BGR -> RGB
    }
  }
}

template <typename OutT>
int launch(const void* src, void* out, const void* taps, const void* weights,
           int n, int src_h, int src_w, int dst_h, int dst_w, int new_h,
           int new_w, int pad_top, int pad_left, cudaStream_t stream) {
  const int64_t total = (int64_t)n * dst_h * dst_w;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  letterbox_kernel<OutT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<OutT*>(out),
      static_cast<const int32_t*>(taps), static_cast<const float*>(weights),
      total, src_h, src_w, dst_h, dst_w, new_h, new_w, pad_top, pad_left);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [n, src_h, src_w, 3] uint8 BGR, contiguous; out: [n, dst_h, dst_w, 3]
// contiguous, bf16 (out_bf16) or fp32; taps and weights as above, on the
// same device. The content window is [pad_top, pad_top + new_h) x
// [pad_left, pad_left + new_w).
extern "C" int rva_letterbox(int device, const void* src, void* out,
                             const void* taps, const void* weights, int n,
                             int src_h, int src_w, int dst_h, int dst_w,
                             int new_h, int new_w, int pad_top, int pad_left,
                             int out_bf16, void* stream) {
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    return launch<__nv_bfloat16>(src, out, taps, weights, n, src_h, src_w,
                                 dst_h, dst_w, new_h, new_w, pad_top,
                                 pad_left, s);
  }
  return launch<float>(src, out, taps, weights, n, src_h, src_w, dst_h, dst_w,
                       new_h, new_w, pad_top, pad_left, s);
}
