// B6: the greedy keep pass of batched NMS, one block per image.
//
// Replaces no TPU kernel: it is the counterpart of the jax.lax.while_loop
// of realtime_analytics_tpu/ops/nms.py::batched_nms (:143-156), which
// sweeps keep = valid & ~(overlap @ keep > 0) on the device until nothing
// changes. The port swept the same fixpoint from Python, and each sweep
// waited on the host to test for change (torch.equal): 14 of a step's 20
// host waits, and a loop whose length depends on the data, which
// torch.export cannot trace. This kernel computes the same keep mask in one
// launch with no host wait.
//
// The function. overlap [n, k, k] bool, where overlap[i][j] may be set only
// for j < i (j outranks i): candidate i overlaps the better candidate j.
// valid [n, k] bool. keep [n, k] bool is the greedy pass in rank order,
//     keep[i] = valid[i] && !any_{j < i} (overlap[i][j] && keep[j]),
// which is the unique fixpoint of the sweeps (a forward substitution:
// keep[i] depends only on keep[j], j < i), so the two agree bit for bit.
// Entries on or above the diagonal are never read as set: at rank i no
// keep bit of a rank >= i is set yet.
//
// What bounds it on the card: the bytes are few (the strict lower triangle
// of the bool matrix, 4.2 MB at n = 32, k = 512: 1.3 us at 3.35 TB/s) but
// the pass is a chain of k dependent decisions. The design keeps that chain
// short. Phase 1, the whole block: pack each row into ceil(k/32) words of
// bits (bit b of word q is column 32q + b; only the words left of the
// diagonal). Phase 2, one warp: for each valid rank i every lane ANDs its
// words of row i with the keep words, one vote (__any_sync) decides, and
// the lane owning word i/32 sets bit i. Phase 3: the keep bytes are
// written. Up to k = 1024 (nms_keep_small) the packed rows (128 KB) and the
// valid bytes live in shared memory and each lane holds its one keep word
// in a register. Above that (nms_keep_large) the rows live in a global
// scratch buffer the wrapper allocates, the keep words in shared memory,
// and lane l tests words l, l + 32, ...: any k whose matrix the card holds
// runs (the keep words of k = 1.8 million would fill shared memory).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kSmemRows = 1024;  // k up to which the packed rows live in shared memory
constexpr int kSmemLimit = 227 * 1024;  // a block's shared memory on sm_90

// Four bool bytes (each 0 or 1) -> four bits: byte b -> bit b.
__device__ __forceinline__ uint32_t bits4(uint32_t v) {
  uint32_t x = v & 0x01010101u;
  x |= x >> 7;   // byte 1 -> bit 1, byte 3 -> bit 17
  x |= x >> 14;  // bits 16, 17 -> bits 2, 3
  return x & 0xFu;
}

__device__ __forceinline__ uint32_t bits16(uint4 v) {
  return bits4(v.x) | (bits4(v.y) << 4) | (bits4(v.z) << 8) | (bits4(v.w) << 12);
}

// Columns [32q, 32q + 32) of one overlap row as a word. kVec: k % 16 == 0
// and the matrix 16-byte aligned, so the row is read in 16-byte units.
template <bool kVec>
__device__ __forceinline__ uint32_t pack_word(const uint8_t* row, int q, int k) {
  const int c0 = q * 32;
  if (kVec) {
    uint32_t w = bits16(*reinterpret_cast<const uint4*>(row + c0));
    if (c0 + 16 < k) w |= bits16(*reinterpret_cast<const uint4*>(row + c0 + 16)) << 16;
    return w;
  }
  uint32_t w = 0;
  for (int b = 0; b < 32 && c0 + b < k; ++b) w |= (uint32_t)(row[c0 + b] != 0) << b;
  return w;
}

// Phase 1: rows [0, k) of one image's matrix packed into `bits`, k * words
// words; row i's word q holds columns < i only when q <= i / 32, the others
// stay unwritten and unread.
template <bool kVec>
__device__ __forceinline__ void pack_rows(const uint8_t* ov, uint32_t* bits, int k, int words) {
  const long long total = (long long)k * words;
  for (long long p = threadIdx.x; p < total; p += kThreads) {
    const int i = (int)(p / words), q = (int)(p - (long long)i * words);
    if (q <= (i >> 5)) bits[(size_t)i * words + q] = pack_word<kVec>(ov + (size_t)i * k, q, k);
  }
}

// k <= 1024: the rows and the valid bytes in shared memory, one keep word a
// lane in a register.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
nms_keep_small(const uint8_t* __restrict__ overlap, const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ keep, int k) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int img = blockIdx.x;
  const int words = (k + 31) / 32;
  uint32_t* bits = smem;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(smem + k * words);
  pack_rows<kVec>(overlap + (size_t)img * k * k, bits, k, words);
  for (int i = threadIdx.x; i < k; i += kThreads) s_valid[i] = valid[(size_t)img * k + i];
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  uint32_t kept = 0u;  // keep word `lane`
  for (int i = 0; i < k; ++i) {
    if (!s_valid[i]) continue;  // the same for every lane
    const int qmax = i >> 5;
    const bool hit = lane <= qmax && (bits[(size_t)i * words + lane] & kept) != 0u;
    if (!__any_sync(0xffffffffu, hit) && qmax == lane) kept |= 1u << (i & 31);
  }
  const int c0 = lane * 32;
  for (int b = 0; b < 32 && c0 + b < k; ++b) {
    keep[(size_t)img * k + c0 + b] = (uint8_t)((kept >> b) & 1u);
  }
}

// k > 1024: the rows in the global scratch, the keep words in shared
// memory; lane l tests words l, l + 32, ... of each row.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
nms_keep_large(const uint8_t* __restrict__ overlap, const uint8_t* __restrict__ valid,
               uint8_t* __restrict__ keep, uint32_t* __restrict__ scratch, int k) {
  extern __shared__ __align__(16) uint32_t kept[];
  const int img = blockIdx.x;
  const int words = (k + 31) / 32;
  uint32_t* bits = scratch + (size_t)img * k * words;
  pack_rows<kVec>(overlap + (size_t)img * k * k, bits, k, words);
  for (int q = threadIdx.x; q < words; q += kThreads) kept[q] = 0u;
  __syncthreads();  // also makes the block's global writes to `bits` visible
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const uint8_t* v = valid + (size_t)img * k;
  for (int i = 0; i < k; ++i) {
    if (!v[i]) continue;  // the same for every lane
    const uint32_t* row = bits + (size_t)i * words;
    const int qmax = i >> 5;
    bool hit = false;
    for (int q = lane; q <= qmax; q += 32) hit |= (row[q] & kept[q]) != 0u;
    if (!__any_sync(0xffffffffu, hit) && (qmax & 31) == lane) kept[qmax] |= 1u << (i & 31);
    __syncwarp();  // the new bit is seen by every lane at the next rank
  }
  for (int c = lane; c < k; c += 32) {
    keep[(size_t)img * k + c] = (uint8_t)((kept[c >> 5] >> (c & 31)) & 1u);
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes`, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>* done, int device) {
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (tracked && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess && tracked) done[device].store(true, std::memory_order_release);
  return err;
}

template <bool kVec>
cudaError_t launch(const void* overlap, const void* valid, void* keep, void* scratch,
                   int n, int k, int device, cudaStream_t stream) {
  const int words = (k + 31) / 32;
  const uint8_t* ov = static_cast<const uint8_t*>(overlap);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  uint8_t* out = static_cast<uint8_t*>(keep);
  if (scratch == nullptr) {
    // the most a launch asks for (k = 1024: 128 KB of rows and the valid bytes)
    static std::atomic<bool> done[kMaxDevices];
    constexpr int kSmemMax = kSmemRows * (kSmemRows / 32) * 4 + kSmemRows;
    cudaError_t err = allow_smem(nms_keep_small<kVec>, kSmemMax, done, device);
    if (err != cudaSuccess) return err;
    const size_t smem = (size_t)k * words * 4 + ((k + 15) / 16) * 16;
    nms_keep_small<kVec><<<n, kThreads, smem, stream>>>(ov, va, out, k);
  } else {
    static std::atomic<bool> done[kMaxDevices];
    cudaError_t err = allow_smem(nms_keep_large<kVec>, kSmemLimit, done, device);
    if (err != cudaSuccess) return err;
    nms_keep_large<kVec><<<n, kThreads, (size_t)words * 4, stream>>>(
        ov, va, out, static_cast<uint32_t*>(scratch), k);
  }
  return cudaGetLastError();
}

}  // namespace

// overlap: [n, k, k] bool, valid and keep: [n, k] bool, all contiguous on
// CUDA device `device`. scratch: nullptr when k <= 1024, else n * k *
// ceil(k / 32) uint32 words of device memory. The launch goes to `stream`.
extern "C" int rva_nms_keep(int device, const void* overlap, const void* valid,
                            void* keep, void* scratch, int n, int k, void* stream) {
  if (n < 0 || k < 0 || (long long)(k + 31) / 32 * 4 > kSmemLimit ||
      (k > kSmemRows) != (scratch != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (n == 0 || k == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = k % 16 == 0 && (uintptr_t)overlap % 16 == 0;
  return (int)(vec ? launch<true>(overlap, valid, keep, scratch, n, k, device, s)
                   : launch<false>(overlap, valid, keep, scratch, n, k, device, s));
}
