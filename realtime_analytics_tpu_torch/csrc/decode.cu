// B2: fused YOLOv8 head decode (DFL expectation + class max/argmax) of all
// levels of the head in one launch, four lanes per anchor.
//
// Replaces: realtime_analytics_tpu/ops/pallas_decode.py::_decode_kernel
// (reached from decode_v8_level, pallas_call at :135). The TPU version
// folds the 16-bin softmax numerators and denominators into one MXU matmul
// against a [64, 8] matrix and takes the argmax as a masked iota min, one
// call per level. Here an anchor is a group of four lanes and every level
// is served by the same grid.
//
// What bounds it on the card: bytes. Per anchor it reads 144 bf16 logits
// (288 B) and writes 24 B; the arithmetic (64 exp + 1 sigmoid + a few
// hundred flops) is far below the 295 flop/byte balance point. At N=32 and
// 640 input (268,800 anchors) that is ~84 MB, ~25 us at 3.35 TB/s. So the
// design is about keeping bytes in flight:
//   * Lane s of an anchor owns box side s: its 16 bins are 32 contiguous
//     bytes in bf16 (two 16-byte loads; four in fp32), so a warp reads the
//     1 KB of its 8 anchors' box rows and the softmax of a side needs no
//     shuffle.
//   * The class row's 16-byte chunks are dealt round-robin to the four
//     lanes (chunk c to lane c % 4). Each lane keeps a running (max, first
//     index) over its chunks; two __shfl_xor_sync steps merge the four, the
//     lower index winning an equal max, so the FIRST maximal class wins
//     (jnp.argmax / torch.argmax semantics). A NaN logit counts as the
//     greatest value, the first NaN winning, as torch.argmax has it.
//   * A thread issues its box loads and its first kClsBatch class loads
//     (all of them at nc = 80, bf16) before any arithmetic: ~80 B in flight
//     a thread, no shared memory, no __syncthreads(), full occupancy.
//   * The four lanes write the box as 4 x 4 contiguous bytes (a warp
//     writes 128 contiguous bytes); lane 0 writes conf, lane 1 the class.
//   * One launch for the whole head: a by-value table names each level's
//     pointers, grid and first block. Levels are padded to whole blocks, so
//     a block belongs to one level, and every thread writes straight into
//     the concatenated outputs at n * anchors + offset[level] + cell: the
//     order of torch.cat(dim=1) over the levels.
//
// Two instantiations of the one kernel: 16-byte loads (kVec = 8 bf16 or 4
// fp32 values; needs nc % kVec == 0 and 16-byte aligned bases) and element
// loads (kVec = 1; any nc, any alignment). ops/decode.py picks.
//
// Inputs are the head's NHWC ([N, h, w, C]-contiguous) logits: a
// channels_last NCHW conv output viewed with permute(0, 2, 3, 1).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "_common.cu"

constexpr int kMaxLevels = 4;

// The table of one launch, mirrored field for field by ops/decode.py.
struct RvaDecodeLevels {
  const void* box[kMaxLevels];   // [n, h, w, 64] logits of the level
  const void* cls[kMaxLevels];   // [n, h, w, nc]
  int32_t h[kMaxLevels];
  int32_t w[kMaxLevels];
  float stride[kMaxLevels];
  int32_t offset[kMaxLevels];    // the level's first anchor within an image
  int32_t block0[kMaxLevels + 1];  // its first block; [count] = all blocks
  int32_t count;                 // levels in use
  int32_t anchors;               // anchors of one image, all levels
  int32_t n;                     // images
};

namespace {

constexpr int kRegMax = 16;          // DFL bins per box side
constexpr int kLanes = 4;            // lanes per anchor = box sides
constexpr int kBoxCh = kLanes * kRegMax;
constexpr int kThreads = 256;
constexpr int kBlockAnchors = kThreads / kLanes;
constexpr int kClsBatch = 3;         // class loads a lane issues at once

// kVec consecutive logits at p, as fp32. p is aligned to kVec elements.
template <typename T, int kVec>
__device__ __forceinline__ void load_f32(const T* p, float* v);

template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t word[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its fp32
    v[2 * i] = __uint_as_float(word[i] << 16);
    v[2 * i + 1] = __uint_as_float(word[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void load_f32<float, 4>(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* v) {
  v[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_f32<float, 1>(const float* p, float* v) {
  v[0] = __ldg(p);
}

// Is class (ov, oi) ahead of (bv, bi)? The greater logit, NaN above all;
// on equal logits the lower index.
__device__ __forceinline__ bool ahead(float ov, int oi, float bv, int bi) {
  const bool on = ov != ov, bn = bv != bv;
  if (on || bn) return on && (!bn || oi < bi);
  return ov > bv || (ov == bv && oi < bi);
}

// The lane's chunks first, first + kLanes, ... (at most kClsBatch of them)
// of a class row of `chunks` chunks; a chunk past the row's end reads as
// -inf, which no scan takes.
template <typename T, int kVec>
__device__ __forceinline__ void load_classes(const T* row, int first,
                                             int chunks,
                                             float (&v)[kClsBatch][kVec]) {
#pragma unroll
  for (int j = 0; j < kClsBatch; ++j) {
    const int c = first + j * kLanes;
    if (c < chunks) {
      load_f32<T, kVec>(row + c * kVec, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[j][e] = -INFINITY;
    }
  }
}

// Strict `>` in index order: the lane's first maximal class stays.
template <int kVec>
__device__ __forceinline__ void scan_classes(float (&v)[kClsBatch][kVec],
                                             int first, float& best,
                                             int& arg) {
#pragma unroll
  for (int j = 0; j < kClsBatch; ++j) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = v[j][e];
      if (x > best || (x != x && best == best)) {
        best = x;
        arg = (first + j * kLanes) * kVec + e;
      }
    }
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
decode_v8_kernel(const __grid_constant__ RvaDecodeLevels lv,
                 float* __restrict__ boxes, float* __restrict__ conf,
                 int32_t* __restrict__ cid, int nc) {
  const int block = blockIdx.x;
  int l = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < lv.count && block >= lv.block0[i]) l = i;
  }
  const int w = lv.w[l];
  const int hw = lv.h[l] * w;
  const int64_t a = (int64_t)(block - lv.block0[l]) * kBlockAnchors +
                    (threadIdx.x / kLanes);  // anchor within the level
  if (a >= (int64_t)lv.n * hw) return;       // all four lanes of it leave
  const int s = threadIdx.x % kLanes;

  // every load of the thread, then the arithmetic
  const T* brow = static_cast<const T*>(lv.box[l]) + a * kBoxCh + s * kRegMax;
  float v[kRegMax];
#pragma unroll
  for (int i = 0; i < kRegMax / kVec; ++i) {
    load_f32<T, kVec>(brow + i * kVec, v + i * kVec);
  }
  const T* crow = static_cast<const T*>(lv.cls[l]) + a * nc;
  const int chunks = nc / kVec;
  float cv[kClsBatch][kVec];
  load_classes<T, kVec>(crow, s, chunks, cv);

  // side s: max-subtracted softmax expectation over the 16 bins, fp32
  float mx = v[0];
#pragma unroll
  for (int j = 1; j < kRegMax; ++j) mx = fmaxf(mx, v[j]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int j = 0; j < kRegMax; ++j) {
    const float e = exp2f((v[j] - mx) * 1.4426950408889634f);
    num += e * (float)j;
    den += e;
  }
  const float dist = num / den;

  const int img = (int)(a / hw);
  const int cell = (int)(a - (int64_t)img * hw);
  const int gy = cell / w;
  const int gx = cell - gy * w;
  const float g = (float)((s & 1) ? gy : gx) + 0.5f;
  const int64_t out = (int64_t)img * lv.anchors + lv.offset[l] + cell;
  boxes[out * 4 + s] = (s < 2 ? g - dist : g + dist) * lv.stride[l];

  // classes: the lane's own chunks, then the four lanes' results merged
  float best = -INFINITY;
  int arg = s < chunks ? s * kVec : INT_MAX;
  scan_classes<kVec>(cv, s, best, arg);
  for (int first = s + kClsBatch * kLanes; first < chunks;
       first += kClsBatch * kLanes) {
    load_classes<T, kVec>(crow, first, chunks, cv);
    scan_classes<kVec>(cv, first, best, arg);
  }
  const unsigned group = 0xFu << ((threadIdx.x % 32) & ~(kLanes - 1));
#pragma unroll
  for (int d = 1; d < kLanes; d *= 2) {
    const float ov = __shfl_xor_sync(group, best, d);
    const int oi = __shfl_xor_sync(group, arg, d);
    if (ahead(ov, oi, best, arg)) {
      best = ov;
      arg = oi;
    }
  }
  if (s == 0) conf[out] = 1.f / (1.f + expf(-best));
  if (s == 1) cid[out] = arg;
}

template <typename T, int kVec>
int launch(const RvaDecodeLevels& lv, void* boxes, void* conf, void* cid,
           int nc, cudaStream_t stream) {
  const int blocks = lv.block0[lv.count];
  if (blocks == 0) return (int)cudaSuccess;
  decode_v8_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lv, static_cast<float*>(boxes), static_cast<float*>(conf),
      static_cast<int32_t*>(cid), nc);
  return (int)cudaGetLastError();
}

}  // namespace

// levels: the table above, in host memory, its pointer fields unused: the
// entry copies it and fills in box0, cls0, box1, cls1, ... (the first
// levels->count pairs). Every box is [n, h, w, 64] and every cls
// [n, h, w, nc], contiguous, bf16 or fp32 (is_bf16). vec: 16-byte loads (nc
// a multiple of 8 in bf16, 4 in fp32, and every base pointer 16-byte
// aligned) or, 0, element loads. Outputs, over the A = levels->anchors
// anchors of an image in level order: boxes [n, A, 4] f32, conf [n, A] f32,
// cid [n, A] int32.
extern "C" int rva_decode_v8_levels(
    int device, const RvaDecodeLevels* levels, const void* box0,
    const void* cls0, const void* box1, const void* cls1, const void* box2,
    const void* cls2, const void* box3, const void* cls3, void* boxes,
    void* conf, void* cid, int nc, int is_bf16, int vec, void* stream) {
  if (levels->count < 1 || levels->count > kMaxLevels || nc < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RvaDecodeLevels lv = *levels;
  const void* const box[kMaxLevels] = {box0, box1, box2, box3};
  const void* const cls[kMaxLevels] = {cls0, cls1, cls2, cls3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.box[i] = i < lv.count ? box[i] : nullptr;
    lv.cls[i] = i < lv.count ? cls[i] : nullptr;
  }
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 8>(lv, boxes, conf, cid, nc, s)
               : launch<__nv_bfloat16, 1>(lv, boxes, conf, cid, nc, s);
  }
  return vec ? launch<float, 4>(lv, boxes, conf, cid, nc, s)
             : launch<float, 1>(lv, boxes, conf, cid, nc, s);
}
