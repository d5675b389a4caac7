// B1: batched row gather, out[n, j, :] = payload[n, idx[n, j], :].
//
// Replaces: realtime_analytics_tpu/ops/pallas_gather.py::_gather_kernel
// (reached from pallas_row_gather, pallas_call at :122). The TPU version
// moves the payload through the int8 MXU as raw bytes with a two-level
// one-hot contraction, because element gathers are serial there. On Hopper
// a direct load of the indexed row is the natural form, and it is exact by
// construction: every row is copied as 32-bit patterns (in groups of four,
// two or one), so NaN payloads, infinities, denormals and -0 survive
// unchanged.
//
// What bounds it on the card: nothing on the card. It must move the
// indices, the gathered rows and the output (about 0.6 MB for the first
// NMS call at N=32, K=512, P=4): well under a microsecond at 3.35 TB/s, and
// the kernel's device time is a few microseconds of launch latency. What a
// caller pays is the host's cost of making the launch, so the design keeps
// both sides short. The device side: a 2-D grid (blockIdx.y is the batch
// row, so no thread divides), one thread per gathered row, moved with the
// widest loads its width and the pointers' alignment allow (16 bytes at
// P=4, 8 at P=6, 4 otherwise). The host side: the entry reads the current
// device instead of setting it, and ops/gather.py calls a bound function
// with the raw stream (see ops/_cuda.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

constexpr int kThreads = 128;

// V: the unit a row is moved in; pv: units per row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const V* __restrict__ payload,
                  const int64_t* __restrict__ idx, V* __restrict__ out, int n,
                  int64_t m, int k, int pv) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= k) return;
  for (int64_t b = blockIdx.y; b < n; b += gridDim.y) {
    const V* src = payload + (b * m + idx[b * k + j]) * pv;
    V* dst = out + (b * k + j) * pv;
    for (int q = 0; q < pv; ++q) dst[q] = src[q];
  }
}

template <typename V>
void launch(const void* payload, const void* idx, void* out, int n, int64_t m,
            int k, int p, cudaStream_t stream) {
  const int pv = p * 4 / (int)sizeof(V);
  dim3 grid((k + kThreads - 1) / kThreads, n < 65535 ? n : 65535);
  row_gather_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(payload), static_cast<const int64_t*>(idx),
      static_cast<V*>(out), n, m, k, pv);
}

}  // namespace

// payload: [n, m, p] float32 (as bit patterns); idx: [n, k] int64 with
// 0 <= idx < m (the caller's contract); out: [n, k, p]. All contiguous, on
// CUDA device `device`; the launch goes to `stream`.
extern "C" int rva_row_gather(int device, const void* payload, const void* idx,
                              void* out, int n, int64_t m, int k, int p,
                              void* stream) {
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if ((int64_t)n * k * p == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t bits = (uintptr_t)payload | (uintptr_t)out;
  if (p % 4 == 0 && bits % 16 == 0) {
    launch<uint4>(payload, idx, out, n, m, k, p, s);
  } else if (p % 2 == 0 && bits % 8 == 0) {
    launch<uint2>(payload, idx, out, n, m, k, p, s);
  } else {
    launch<uint32_t>(payload, idx, out, n, m, k, p, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rva_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
