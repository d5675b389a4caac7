// B2: fused YOLOv8 head decode for one level (DFL expectation + class
// max/argmax), one thread per anchor.
//
// Replaces: realtime_analytics_tpu/ops/pallas_decode.py::_decode_kernel
// (reached from decode_v8_level, pallas_call at :135). The TPU version
// folds the 16-bin softmax numerators and denominators into one MXU matmul
// against a [64, 8] matrix and takes the argmax as a masked iota min. Here
// each anchor is a thread: it reads its 64 DFL logits and nc class logits
// once, takes the max-subtracted softmax expectation of each side in fp32,
// and scans the classes with a strict `>` so the FIRST maximal index wins
// ties (jnp.argmax / torch.argmax semantics).
//
// What bounds it on the card: bytes. Per anchor it reads 144 bf16 logits
// (288 B) and writes 24 B; the arithmetic (64 exp + 1 sigmoid + a few
// hundred flops) is far below the 295 flop/byte balance point. At N=32 and
// 640 input (268,800 anchors) that is ~84 MB, ~25 us at 3.35 TB/s. The
// design keeps every read coalesced: a block stages the contiguous logit
// rows of its 64 anchors into shared memory with consecutive threads on
// consecutive addresses (rows padded by one float so the per-anchor reads
// that follow hit distinct banks), converts to fp32 once, and writes the
// box as one 16-byte store.
//
// Inputs are the head's NHWC ([N, h, w, C]-contiguous) logits: a
// channels_last NCHW conv output viewed with permute(0, 2, 3, 1).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRegMax = 16;
constexpr int kBoxCh = 4 * kRegMax;  // 64 DFL logits per anchor
constexpr int kTile = 64;            // anchors (and threads) per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void decode_v8_kernel(const T* __restrict__ box,
                                 const T* __restrict__ cls,
                                 float* __restrict__ boxes,
                                 float* __restrict__ conf,
                                 int32_t* __restrict__ cid, int64_t total,
                                 int h, int w, int nc, float stride) {
  extern __shared__ float smem[];
  float* sbox = smem;                          // kTile x (kBoxCh + 1)
  float* scls = smem + kTile * (kBoxCh + 1);   // kTile x (nc + 1)
  const int64_t a0 = (int64_t)blockIdx.x * kTile;
  const int cnt = (int)min((int64_t)kTile, total - a0);

  const T* gbox = box + a0 * kBoxCh;
  for (int e = threadIdx.x; e < cnt * kBoxCh; e += blockDim.x) {
    sbox[(e / kBoxCh) * (kBoxCh + 1) + e % kBoxCh] = to_f32(gbox[e]);
  }
  const T* gcls = cls + a0 * nc;
  for (int e = threadIdx.x; e < cnt * nc; e += blockDim.x) {
    scls[(e / nc) * (nc + 1) + e % nc] = to_f32(gcls[e]);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= cnt) return;
  const int64_t a = a0 + t;
  const int cell = (int)(a % ((int64_t)h * w));
  const float gx = (float)(cell % w) + 0.5f;
  const float gy = (float)(cell / w) + 0.5f;

  const float* row = sbox + t * (kBoxCh + 1);
  float dist[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* v = row + s * kRegMax;
    float mx = v[0];
#pragma unroll
    for (int j = 1; j < kRegMax; ++j) mx = fmaxf(mx, v[j]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < kRegMax; ++j) {
      const float e = expf(v[j] - mx);
      num += e * (float)j;
      den += e;
    }
    dist[s] = num / den;
  }
  reinterpret_cast<float4*>(boxes)[a] =
      make_float4((gx - dist[0]) * stride, (gy - dist[1]) * stride,
                  (gx + dist[2]) * stride, (gy + dist[3]) * stride);

  const float* crow = scls + t * (nc + 1);
  float best = crow[0];
  int arg = 0;
  for (int c = 1; c < nc; ++c) {
    if (crow[c] > best) {  // strict: the first maximal index wins ties
      best = crow[c];
      arg = c;
    }
  }
  conf[a] = 1.f / (1.f + expf(-best));
  cid[a] = arg;
}

template <typename T>
int launch(const void* box, const void* cls, void* boxes, void* conf,
           void* cid, int n, int h, int w, int nc, float stride,
           cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w;
  if (total == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * kTile * ((kBoxCh + 1) + (nc + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_v8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (total + kTile - 1) / kTile;
  decode_v8_kernel<T><<<(unsigned)blocks, kTile, smem, stream>>>(
      static_cast<const T*>(box), static_cast<const T*>(cls),
      static_cast<float*>(boxes), static_cast<float*>(conf),
      static_cast<int32_t*>(cid), total, h, w, nc, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// box: [n, h, w, 64], cls: [n, h, w, nc], both contiguous, bf16 or fp32
// (is_bf16). Outputs: boxes [n, h*w, 4] f32, conf [n, h*w] f32,
// cid [n, h*w] int32.
extern "C" int rva_decode_v8(int device, const void* box, const void* cls,
                             void* boxes, void* conf, void* cid, int n, int h,
                             int w, int nc, float stride, int is_bf16,
                             void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch<__nv_bfloat16>(box, cls, boxes, conf, cid, n, h, w, nc,
                                 stride, s);
  }
  return launch<float>(box, cls, boxes, conf, cid, n, h, w, nc, stride, s);
}
