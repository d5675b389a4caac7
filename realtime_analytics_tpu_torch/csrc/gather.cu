// B1: batched row gather, out[n, j, :] = payload[n, idx[n, j], :].
//
// Replaces: realtime_analytics_tpu/ops/pallas_gather.py::_gather_kernel
// (reached from pallas_row_gather, pallas_call at :122). The TPU version
// moves the payload through the int8 MXU as raw bytes with a two-level
// one-hot contraction, because element gathers are serial there. On Hopper
// a direct load of the indexed row is the natural form, and it is exact by
// construction: every element is copied as its 32-bit pattern, so NaN
// payloads, infinities, denormals and -0 survive unchanged.
//
// What bounds it on the card: the bytes it must move — the indices, the
// gathered rows and the output (about 0.6 MB for the first NMS call at
// N=32, K=512, P=4). That is well under a microsecond at 3.35 TB/s, so the
// kernel is launch-bound. The design does the least that can be done about
// it: one thread per output element, one launch, no shared memory, no
// second pass; neighbouring threads write neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void row_gather_kernel(const uint32_t* __restrict__ payload,
                                  const int64_t* __restrict__ idx,
                                  uint32_t* __restrict__ out,
                                  int64_t m, int k, int p, int64_t total) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / p;        // n * k + j
    const int q = (int)(i - row * p);
    const int64_t n = row / k;
    out[i] = payload[(n * m + idx[row]) * p + q];
  }
}

}  // namespace

// payload: [n, m, p] float32 (as bit patterns); idx: [n, k] int64 with
// 0 <= idx < m (the caller's contract); out: [n, k, p]. All contiguous, on
// CUDA device `device`; the launch goes to `stream`. (Each entry selects the
// device itself: this library's runtime keeps its own current device.)
extern "C" int rva_row_gather(int device, const void* payload, const void* idx,
                              void* out, int n, int64_t m, int k, int p,
                              void* stream) {
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int64_t total = (int64_t)n * k * p;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  row_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(payload), static_cast<const int64_t*>(idx),
      static_cast<uint32_t*>(out), m, k, p, total);
  return (int)cudaGetLastError();
}

extern "C" const char* rva_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
