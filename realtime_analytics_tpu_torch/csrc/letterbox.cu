// B4: bilinear letterbox / stretch resize of a uint8 BGR batch into the
// model's input canvas. A block owns a segment of one output row.
//
// Replaces: realtime_analytics_tpu/ops/pallas_preprocess.py::_kernel
// (reached from pallas_letterbox and pallas_stretch_resize through
// _call_kernel, pallas_call at :207). The TPU version runs the resize of
// each (image, channel) plane as two dense bf16 MXU matmuls against
// [dst, src] interpolation matrices, with the H axis as a row pick or a
// 2-row mean for integer ratios. That is a tactic for the TPU's matrix
// unit; here each output pixel reads its taps directly.
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
// both to bf16 for its MXU). A tap whose weight is exactly 0 is not read:
// (1 - 0) a + 0 b is a, bit for bit, for the uint8-valued a and b here.
//
// What bounds it on the card: bytes. It reads the source rows that a tap
// with a nonzero weight touches and writes the canvas once; the arithmetic
// is a dozen flops per output value. So the design moves bytes in 16-byte
// units and reads each tapped row once per block:
//   * wy is uniform over an output row, so the row's pad test, its one or
//     two source rows and whether the second is read at all are decided
//     once per block, with no division per pixel.
//   * The block stages the byte span of its segment's taps from the one
//     or two source rows into shared memory with 16-byte cp.async, where
//     the taps lie close (`dense`: at most 16 source bytes per output
//     pixel), so every 16-byte unit of the span is wanted. Where they lie apart (a
//     1080p row squeezed into 224 or 112 pixels) a staged span would read the
//     sectors between the taps for nothing: there the threads read their
//     taps from the source rows directly. ops/letterbox.py computes every
//     segment's span (`segs`) and sizes the shared memory from the
//     geometry.
//   * Threads compute a pixel each from the staged rows into a shared output
//     strip; the strip leaves in 16-byte stores. Pad columns go through
//     the same strip; a pad row is written directly. A block that reads
//     its taps in place uses no shared memory and stores each pixel as it
//     is computed.
//
// Two instantiations of the one kernel: 16-byte units (source rows of
// 3 * src_w bytes and output rows both multiples of 16 bytes, bases
// aligned) and element moves (any width). ops/letterbox.py picks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes [start, stop) of the source row `g` to the staged row `s`. kVec:
// start, stop and both bases are multiples of 16.
template <bool kVec>
__device__ __forceinline__ void stage(uint8_t* s, const uint8_t* g, int start,
                                      int stop, int first, int step) {
  if (kVec) {
    for (int b = start + first * 16; b < stop; b += step * 16) {
      cp_async16(s + (b - start), g + b);
    }
  } else {
    for (int b = start + first; b < stop; b += step) s[b - start] = g[b];
  }
}

// One output pixel a thread: the `len` pixels of a segment whose first is
// content column c0 (negative in the left pad), from the rows r0 and r1,
// whose byte 0 is the source rows' byte `start` (staged in shared memory, or
// the source rows themselves with start 0), into `strip` (the shared output
// strip, or the segment's place in the output row). A tap of weight 0 is
// not read: its address is replaced by its partner's (r1 by r0 where
// wy == 0, as the caller passes them; x1 by x0 where wx == 0), so that all
// twelve loads of a pixel are issued together, none behind a branch.
template <typename OutT>
__device__ __forceinline__ void resize_row(
    const uint8_t* r0, const uint8_t* r1, OutT* strip, const int32_t* tx0,
    const int32_t* tx1, const float* twx, float wy, int start, int c0, int len,
    int new_w) {
  const float inv255 = 1.0f / 255.0f;
  const float pad = 114.0f * inv255;
  const bool two_rows = wy != 0.0f;  // block-uniform
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const int c = c0 + p;
    OutT* o = strip + p * 3;
    if (c < 0 || c >= new_w) {
      store(o, pad);
      store(o + 1, pad);
      store(o + 2, pad);
      continue;
    }
    const float wx = twx[c];
    const int x1 = tx1[c];
    const int a = tx0[c] * 3 - start;
    const int b = wx != 0.0f ? x1 * 3 - start : a;
    uint8_t p0a[3], p0b[3], p1a[3], p1b[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      p0a[ch] = r0[a + ch];
      p0b[ch] = r0[b + ch];
      p1a[ch] = r1[a + ch];
      p1b[ch] = r1[b + ch];
    }
    // explicit round-to-nearest products and sums: no FMA contraction, so
    // the result is bit-equal to the plain version's elementwise ops
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float r = (float)p0a[ch], hb = (float)p0b[ch];
      if (two_rows) {
        r = __fadd_rn(__fmul_rn(1.0f - wy, r), __fmul_rn(wy, (float)p1a[ch]));
        hb = __fadd_rn(__fmul_rn(1.0f - wy, hb),
                       __fmul_rn(wy, (float)p1b[ch]));
      }
      if (wx != 0.0f) {
        r = __fadd_rn(__fmul_rn(1.0f - wx, r), __fmul_rn(wx, hb));
      }
      r = fminf(fmaxf(floorf(__fadd_rn(r, 0.5f)), 0.0f), 255.0f);
      store(o + (2 - ch), __fmul_rn(r, inv255));  // BGR -> RGB
    }
  }
}

// taps: int32 [2*new_h + 2*new_w] = y0 | y1 | x0 | x1;
// weights: fp32 [new_h + new_w] = wy | wx (the weight of the second tap);
// segs: int32 [segments, 2] = the first source-row byte a segment stages,
// and how many.
// grid: (segments of a row, dst_h, n). Dynamic shared memory, when dense:
// two staged rows of span_cap bytes, then the output strip of seg_w pixels.
template <typename OutT, bool kVec>
__global__ void letterbox_kernel(const uint8_t* __restrict__ src,
                                 OutT* __restrict__ out,
                                 const int32_t* __restrict__ taps,
                                 const float* __restrict__ weights,
                                 const int32_t* __restrict__ segs, int src_h,
                                 int src_w, int dst_h, int dst_w, int new_h,
                                 int new_w, int pad_top, int pad_left,
                                 int seg_w, int span_cap, int dense) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s0 = smem;
  uint8_t* s1 = smem + span_cap;
  OutT* strip = reinterpret_cast<OutT*>(smem + 2 * span_cap);

  const float inv255 = 1.0f / 255.0f;
  const float pad = 114.0f * inv255;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int seg = blockIdx.x, oy = blockIdx.y;
  const int64_t n = blockIdx.z;
  const int sx = seg * seg_w;                 // the segment's first pixel
  const int len = min(seg_w, dst_w - sx);     // and how many it has
  OutT* orow = out + ((n * dst_h + oy) * dst_w + sx) * 3;
  const int cy = oy - pad_top;
  // the segment's content columns [c_lo, c_hi), as indices into the tables
  const int c_lo = max(sx - pad_left, 0);
  const int c_hi = min(sx + len - pad_left, new_w);

  if (cy < 0 || cy >= new_h || c_lo >= c_hi) {  // pad, all of it
    if (kVec) {
      __align__(16) OutT lane[16 / sizeof(OutT)];
#pragma unroll
      for (int i = 0; i < (int)(16 / sizeof(OutT)); ++i) store(lane + i, pad);
      const uint4 q = *reinterpret_cast<const uint4*>(lane);
      uint4* o = reinterpret_cast<uint4*>(orow);
      const int units = len * 3 * (int)sizeof(OutT) / 16;
      for (int i = tid; i < units; i += nthreads) o[i] = q;
    } else {
      for (int i = tid; i < len * 3; i += nthreads) store(orow + i, pad);
    }
    return;
  }

  const int32_t* tx0 = taps + 2 * new_h;
  const int32_t* tx1 = tx0 + new_w;
  const float* twx = weights + new_h;
  const float wy = weights[cy];
  const bool two_rows = wy != 0.0f;  // block-uniform
  const uint8_t* img = src + n * src_h * (int64_t)src_w * 3;
  const uint8_t* g0 = img + (int64_t)taps[cy] * src_w * 3;
  // the second row only where it has weight: else the first stands in
  const uint8_t* g1 =
      two_rows ? img + (int64_t)taps[new_h + cy] * src_w * 3 : g0;
  if (!dense) {  // taps read in place, pixels stored as they are computed
    resize_row(g0, g1, orow, tx0, tx1, twx, wy, 0, sx - pad_left, len, new_w);
    return;
  }
  const int start = segs[2 * seg];
  const int stop = start + segs[2 * seg + 1];
  stage<kVec>(s0, g0, start, stop, tid, nthreads);
  if (two_rows) stage<kVec>(s1, g1, start, stop, tid, nthreads);
  if (kVec) cp_async_wait_all();
  __syncthreads();
  resize_row(s0, two_rows ? s1 : s0, strip, tx0, tx1, twx, wy, start,
             sx - pad_left, len, new_w);
  __syncthreads();

  if (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(strip);
    uint4* o = reinterpret_cast<uint4*>(orow);
    const int units = len * 3 * (int)sizeof(OutT) / 16;
    for (int i = tid; i < units; i += nthreads) o[i] = q[i];
  } else {
    for (int i = tid; i < len * 3; i += nthreads) orow[i] = strip[i];
  }
}

template <typename OutT, bool kVec>
int launch(const void* src, void* out, const void* taps, const void* weights,
           const void* segs, int n, int src_h, int src_w, int dst_h, int dst_w,
           int new_h, int new_w, int pad_top, int pad_left, int seg_w,
           int span_cap, int dense, int threads, cudaStream_t stream) {
  if (n == 0 || dst_h == 0 || dst_w == 0) return (int)cudaSuccess;
  const size_t strip = ((size_t)seg_w * 3 * sizeof(OutT) + 15) / 16 * 16;
  const size_t smem = dense ? 2 * (size_t)span_cap + strip : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        letterbox_kernel<OutT, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((dst_w + seg_w - 1) / seg_w), (unsigned)dst_h,
                  (unsigned)n);
  letterbox_kernel<OutT, kVec><<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<OutT*>(out),
      static_cast<const int32_t*>(taps), static_cast<const float*>(weights),
      static_cast<const int32_t*>(segs), src_h, src_w, dst_h, dst_w, new_h,
      new_w, pad_top, pad_left, seg_w, span_cap, dense);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [n, src_h, src_w, 3] uint8 BGR, contiguous; out: [n, dst_h, dst_w, 3]
// contiguous, bf16 (out_bf16) or fp32; taps, weights and segs as above, on
// the same device. The content window is [pad_top, pad_top + new_h) x
// [pad_left, pad_left + new_w). A block takes seg_w output pixels of a row
// with `threads` threads and stages at most span_cap bytes (a multiple of
// 16) of a source row; dense: it stages its span (else it reads the taps
// in place). vec: 16-byte units
// (3 * src_w, span starts and lengths, seg_w * 3 * the output's element
// size and the row of dst_w pixels all multiples of 16 bytes, src and out
// 16-byte aligned) or, 0, element moves.
extern "C" int rva_letterbox(int device, const void* src, void* out,
                             const void* taps, const void* weights,
                             const void* segs, int n, int src_h, int src_w,
                             int dst_h, int dst_w, int new_h, int new_w,
                             int pad_top, int pad_left, int seg_w,
                             int span_cap, int dense, int threads, int vec,
                             int out_bf16, void* stream) {
  if (seg_w < 1 || span_cap % 16 || threads < 32 || threads > 1024 ||
      dst_h > 65535 || n > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
#define RVA_LETTERBOX(OutT, kVec)                                          \
  launch<OutT, kVec>(src, out, taps, weights, segs, n, src_h, src_w,       \
                     dst_h, dst_w, new_h, new_w, pad_top, pad_left, seg_w, \
                     span_cap, dense, threads, s)
  if (out_bf16) {
    return vec ? RVA_LETTERBOX(__nv_bfloat16, true)
               : RVA_LETTERBOX(__nv_bfloat16, false);
  }
  return vec ? RVA_LETTERBOX(float, true) : RVA_LETTERBOX(float, false);
#undef RVA_LETTERBOX
}
