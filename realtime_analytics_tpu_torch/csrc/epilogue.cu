// B7: a float conv's elementwise epilogue in one pass: bias, SiLU or ReLU and
// the shortcut add over the conv's channels_last (or channels_last_3d) output.
//
// Replaces: no Pallas kernel. On the TPU, XLA fuses the JAX package's conv
// bias and `x * sigmoid(x)` (models/layers.py::conv_act) into the conv's own
// fusion, so the conv's output is written once. PyTorch's cuDNN route runs
// the conv without its bias and then adds the bias in a second pass
// (`output.add_(bias.reshape(1, C, 1, 1))`: on a channels_last output a
// stride-0 operand, which takes TensorIterator's non-vectorised kernel), F.silu
// is a third pass and a bottleneck's `x + y` a fourth. This kernel is that
// chain as one read and one write of the output, after a conv run without
// its bias.
//
// Arithmetic, in this order, each step rounded to the output's type as the
// PyTorch passes round it, so the result is theirs bit for bit. act 0 or 1
// (YOLO's Conv, and its bottleneck's shortcut after the activation):
//   y = round(y + bias[c])
//   y = round(y / (1 + expf(-y)))      when act == 1: at::native's SiLU in fp32
//   y = round(residual + y)            when a residual is given
// act 2 (a ResNet conv, and its bottleneck's shortcut before the activation):
//   y = round(y + bias[c])
//   y = round(residual + y)            when a residual is given
//   y = relu(y)                        at::clamp_min's: NaN kept, else fmaxf
// The build has no fast-math flag, so expf and the division are the
// accurate ones that PyTorch's kernels use. The ReLU mode is an instantiation
// of its own (kRelu), so the SiLU modes' code is what it was before it.
//
// What bounds it on the card: bytes. Per element it reads the conv output
// (and the residual) and writes it once, with two dozen flops, far below the
// 295 flop/byte balance point. YOLOv8l at b32 puts 2.3 G elements a step
// through it (9.22 GB in bf16 without the residuals): ~2.75 ms at 3.35 TB/s.
// An in-place copy of the same bytes reaches about 90% of that; with SiLU
// off this kernel does too, and the SiLU and its roundings cost about a
// tenth more (PERF.md, §6). The design:
//   * One unit of work is 16 bytes (8 bf16 or 4 fp32 values). The grid is
//     as many blocks as the SMs hold at once (the occupancy API: 5 an SM at
//     44 registers), and it walks the units with a grid stride; each
//     thread keeps its unit's pixel and channel and advances them by the
//     stride, so no thread divides in the loop. (A grid of 8 blocks an SM
//     ran in two waves, the second at 3 blocks an SM: 7% slower.)
//   * The bias is converted to fp32 into shared memory once per block and
//     read 16 bytes at a time.
//   * Neighbouring values are rounded in pairs (one bf16x2 conversion), and
//     the last rounding is the store's own.
//   * The residual is a channel-slice view (C2f's `chunk` gives one): it is
//     addressed by its pixel stride, so it needs no copy.
// Loading two or four units before computing any (more bytes in flight)
// took 118 registers a thread and was slower; capping the registers at 32
// for a full SM spilled and was slower too (PERF.md, §6).
//
// A 5-d conv output in channels_last_3d ([N, D, H, W, C] contiguous) is the
// same [pixels, C] walk, its pixels counted over D, H and W.
//
// Two instantiations (ops/epilogue.py picks, as epilogue_instantiation
// says): `vec16`, 16-byte units within one pixel (C a multiple of the unit,
// a 16-byte aligned residual whose pixel stride is a multiple of the unit);
// `flat16`, 16-byte units over the flat output, each element finding its own
// channel, the last unit masked and the residual read element by element
// (any C). Both take a 16-byte aligned input and output, as every conv
// output and fresh copy is.
//
// In place when out == x. Allocates nothing, waits on nothing: safe inside a
// CUDA graph capture.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxChannels = 12288; // the bias in 48 KB of shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two values of T as floats, and two floats rounded to T (nearest even):
// one instruction a pair in bf16.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return make_float2(p[0], p[1]);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    p[0] = v.x;
    p[1] = v.y;
  }
  static __device__ __forceinline__ float2 round(float2 v) { return v; }
};
template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
  }
  static __device__ __forceinline__ float2 round(float2 v) {
    return __bfloat1622float2(__float22bfloat162_rn(v));
  }
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// at::clamp_min(v, 0) on the card: a NaN passes, else the max.
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// One element: the value to store (its last rounding is the store's).
template <typename T, bool kRelu>
__device__ __forceinline__ float epilogue(float v, float b, int act,
                                          const T* r) {
  v += b;
  if (kRelu) {
    v = to_f32(from_f32<T>(v));
    if (r != nullptr) v = to_f32(from_f32<T>(to_f32(*r) + v));
    return relu(v);
  }
  if (act || r != nullptr) v = to_f32(from_f32<T>(v));
  if (act) {
    v = silu(v);
    if (r != nullptr) v = to_f32(from_f32<T>(v));
  }
  if (r != nullptr) v = to_f32(*r) + v;
  return v;
}

// Two neighbouring elements, the same steps, rounded in pairs.
template <typename T, bool kRelu>
__device__ __forceinline__ float2 epilogue2(float2 v, float2 b, int act,
                                            const T* r) {
  v = make_float2(v.x + b.x, v.y + b.y);
  if (kRelu) {
    v = Pair<T>::round(v);
    if (r != nullptr) {
      const float2 rv = Pair<T>::load(r);
      v = Pair<T>::round(make_float2(rv.x + v.x, rv.y + v.y));
    }
    return make_float2(relu(v.x), relu(v.y));
  }
  if (act || r != nullptr) v = Pair<T>::round(v);
  if (act) {
    v = make_float2(silu(v.x), silu(v.y));
    if (r != nullptr) v = Pair<T>::round(v);
  }
  if (r != nullptr) {
    const float2 rv = Pair<T>::load(r);
    v = make_float2(rv.x + v.x, rv.y + v.y);
  }
  return v;
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// kVec (4 or 8) consecutive floats of the bias in shared memory from
// channel ch (a multiple of kVec, so 16-byte aligned).
template <int kVec>
__device__ __forceinline__ void load_bias(const float* bias_f, int ch,
                                          float* b) {
#pragma unroll
  for (int j = 0; j < kVec / 4; ++j) {
    const float4 q = reinterpret_cast<const float4*>(bias_f + ch)[j];
    b[4 * j] = q.x;
    b[4 * j + 1] = q.y;
    b[4 * j + 2] = q.z;
    b[4 * j + 3] = q.w;
  }
}

// x, out: [pixels, c] contiguous (out may be x); res: element (p, ch) at
// res[p * res_stride + ch], or null. kAligned: a unit lies within one pixel
// (c % kVec == 0), so its bias and residual are kVec neighbours; else each
// element finds its own channel and pixel, and the last unit is masked.
// kRelu: act 2 (ReLU after the shortcut add); act is read only without it.
template <typename T, int kVec, bool kAligned, bool kRelu>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const T* x, T* out, const T* __restrict__ bias,
                     const T* res, int64_t res_stride, int64_t elems, int c,
                     int act) {
  extern __shared__ float bias_f[];
  for (int i = threadIdx.x; i < c; i += kThreads) bias_f[i] = to_f32(bias[i]);
  __syncthreads();

  using V = Pack<T, kVec>;
  const int64_t units = (elems + kVec - 1) / kVec;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  // the unit's first element as (pixel, channel), advanced by the stride
  int64_t p = u * kVec / c;
  int ch = (int)(u * kVec - p * c);
  const int64_t step_p = step * kVec / c;
  const int step_c = (int)(step * kVec - step_p * c);
  for (; u < units; u += step) {
    const int64_t e = u * kVec;
    V in, o;
    if (kAligned) {
      in = *reinterpret_cast<const V*>(x + e);
      V r;
      if (res != nullptr) {
        r = *reinterpret_cast<const V*>(res + p * res_stride + ch);
      }
      float b[kVec];
      load_bias<kVec>(bias_f, ch, b);
#pragma unroll
      for (int i = 0; i < kVec; i += 2) {
        Pair<T>::store(&o.v[i], epilogue2<T, kRelu>(
            Pair<T>::load(&in.v[i]), make_float2(b[i], b[i + 1]), act,
            res != nullptr ? &r.v[i] : nullptr));
      }
      *reinterpret_cast<V*>(out + e) = o;
    } else {
      const int n = elems - e < kVec ? (int)(elems - e) : kVec;
      if (n == kVec) {
        in = *reinterpret_cast<const V*>(x + e);
      } else {
        for (int i = 0; i < n; ++i) in.v[i] = x[e + i];
      }
      int64_t pp = p;
      int cc = ch;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (i < n) {
          o.v[i] = from_f32<T>(epilogue<T, kRelu>(
              to_f32(in.v[i]), bias_f[cc], act,
              res != nullptr ? res + pp * res_stride + cc : nullptr));
        }
        if (++cc == c) {
          cc = 0;
          ++pp;
        }
      }
      if (n == kVec) {
        *reinterpret_cast<V*>(out + e) = o;
      } else {
        for (int i = 0; i < n; ++i) out[e + i] = o.v[i];
      }
    }
    ch += step_c;
    p += step_p;
    if (ch >= c) {
      ch -= c;
      ++p;
    }
  }
}

int sm_count(int device) {
  static int counts[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0) {
      n = 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

template <typename T, int kVec, bool kAligned, bool kRelu>
int launch(int device, const void* x, void* out, const void* bias,
           const void* res, int64_t res_stride, int64_t elems, int c, int act,
           cudaStream_t s) {
  const int64_t units = (elems + kVec - 1) / kVec;
  const int64_t want = (units + kThreads - 1) / kThreads;
  int per_sm = 0;  // the blocks an SM holds at once: one wave
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_epilogue_kernel<T, kVec, kAligned, kRelu>, kThreads,
          c * sizeof(float)) != cudaSuccess ||
      per_sm < 1) {
    (void)cudaGetLastError();
    per_sm = 1;
  }
  const int64_t most = (int64_t)sm_count(device) * per_sm;
  const int blocks = (int)(want < most ? want : most);
  conv_epilogue_kernel<T, kVec, kAligned, kRelu>
      <<<blocks, kThreads, c * sizeof(float), s>>>(
          static_cast<const T*>(x), static_cast<T*>(out),
          static_cast<const T*>(bias), static_cast<const T*>(res), res_stride,
          elems, c, act);
  return (int)cudaGetLastError();
}

template <typename T, int kVec>
int dispatch(int device, const void* x, void* out, const void* bias,
             const void* res, int64_t res_stride, int64_t elems, int c, int act,
             int mode, cudaStream_t s) {
  if (act == 2) {
    if (mode == 1) return launch<T, kVec, true, true>(device, x, out, bias, res, res_stride, elems, c, 0, s);
    return launch<T, kVec, false, true>(device, x, out, bias, res, res_stride, elems, c, 0, s);
  }
  if (mode == 1) return launch<T, kVec, true, false>(device, x, out, bias, res, res_stride, elems, c, act, s);
  return launch<T, kVec, false, false>(device, x, out, bias, res, res_stride, elems, c, act, s);
}

}  // namespace

// x, out: [pixels, c] contiguous, bf16 (is_bf16) or fp32; out may equal x.
// bias: [c] of the same type. res: null, or element (p, ch) at
// res[p * res_stride + ch]. act: 0 none, 1 SiLU (before the add), 2 ReLU
// (after the add). mode: 1 vec16, 0 flat16 (ops/epilogue.py decides; the
// entry refuses a mode the pointers do not allow). All on CUDA device
// `device`; the launch goes to `stream`.
extern "C" int rva_conv_epilogue(int device, const void* x, void* out,
                                 const void* bias, const void* res,
                                 int64_t res_stride, int64_t pixels, int c,
                                 int act, int is_bf16, int mode, void* stream) {
  if (c < 1 || c > kMaxChannels || pixels < 0 || mode < 0 || mode > 1 ||
      act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = is_bf16 ? 8 : 4;
  const uintptr_t bits = (uintptr_t)x | (uintptr_t)out;
  const uintptr_t rbits = res != nullptr ? (uintptr_t)res : 0;
  if (bits % 16 != 0) return (int)cudaErrorInvalidValue;
  if (mode == 1 && (c % vec != 0 || rbits % 16 != 0 ||
                    (res != nullptr && res_stride % vec != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int64_t elems = pixels * c;
  if (elems == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return dispatch<__nv_bfloat16, 8>(device, x, out, bias, res, res_stride, elems, c, act, mode, s);
  }
  return dispatch<float, 4>(device, x, out, bias, res, res_stride, elems, c, act, mode, s);
}
