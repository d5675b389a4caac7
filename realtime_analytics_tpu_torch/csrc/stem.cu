// B3: fused YOLO stem, nodes 0 + 1 in one kernel:
//   P1 = SiLU(conv k3 s2 p1 (x, w0) + b0)     3 -> c0 channels
//   P2 = SiLU(conv k3 s2 p1 (P1, w1) + b1)    c0 -> c1 channels
// fp32 accumulation, bias and SiLU in fp32, P1 and P2 rounded once each to
// the compute dtype; P1 never reaches device memory.
//
// Replaces: realtime_analytics_tpu/ops/pallas_stem.py::_kernel (reached
// from fused_stem_p1p2, pallas_call at :283). The TPU version rebuilds both
// convs as block-Toeplitz [128, 128] matmul pieces over a space-to-depth
// input so that 16/32 channels fill the 128-lane MXU. None of that carries
// over. Here a block owns an 8 x 16 tile of P2 pixels and keeps in shared
// memory the input patch the tile needs (35 rows), the 17 x 33 x c0 P1 tile
// with its one-pixel halo, and conv1's weights. The halo is recomputed by
// neighbouring blocks (under 10% more conv0 work) instead of exchanged.
// Input pixels outside the image are 0 (conv0's pad) and P1 positions
// outside [0, H/2) x [0, W/2) are 0 (conv1's pad).
//
// What bounds it on the card: at N=32 and 640 input it must read 78.6 MB of
// bf16 input and write 52.4 MB (131 MB, ~39 us at 3.35 TB/s) and do 10.4
// GFLOP (~10.5 us on the bf16 tensor cores, ~155 us on the fp32 cores), so
// the floor is the memory in bf16 and the fp32 cores in fp32. The first
// version of this kernel gave each thread one output and read two
// shared-memory words for every multiply-add: it ran at the rate of shared
// memory (16 FMA per clock per SM of 128), 36x above the floor. The two
// instantiations below are built against that. With them the bf16 kernel
// runs within 4x of its floor on an H100 (PERF.md has the times). What
// holds it there: each SiLU costs two special-function operations (ex2 and
// rcp, 16 a clock an SM), and the 13,072 SiLUs of a tile take longer than
// its memory traffic; the rest is the instruction rate, which is why the
// loops below avoid divisions, walk rows, and take SiLU's two operations
// bare.
//
// stem_mma_kernel (bf16, c0 % 16 == 0, c1 % 8 == 0, W % 8 == 0): both convs
// are implicit GEMMs on the tensor cores (mma.sync.m16n8k16, bf16 operands,
// fp32 sums). mma.sync and not wgmma: the work needs about a quarter of the
// tensor peak to reach the memory floor, and mma.sync takes A fragments that
// ldmatrix gathers straight from the strided P1 tile, where wgmma would
// want its operands laid out for a descriptor first.
//   * The patch arrives by 16-byte cp.async with zero fill. A patch row
//     starts 8 pixels (48 bytes) left of the tile's first input column, which
//     is 16-byte aligned whenever W % 8 == 0; image edges then fall on chunk
//     boundaries, so a chunk is either wholly inside or wholly zero.
//     conv1's weights follow as a second cp.async group that lands while
//     conv0 runs; co-resident blocks overlap one tile's loads with
//     another's arithmetic.
//   * conv0: M = the 561 P1 pixels of the tile (36 row tiles of 16), N = c0,
//     K = 48: one k-step of 16 per ky, holding [0, the nine (kx, ci) values
//     that are contiguous in the patch row, 0 x 6]. The leading 0 makes
//     every fragment word 4-byte aligned (a P1 pixel's window starts at
//     byte 30 + 12 j of the patch row). The packed w0 operand has zero rows
//     there and the A fragment masks them too. Epilogue: bias, SiLU, round
//     to bf16, zero outside the image, straight into the shared P1 tile.
//   * The P1 tile is split by column parity, each pixel c0 * 2 + 16 bytes:
//     the eight rows of an ldmatrix (pixels 2 columns apart) then lie 16-byte
//     slots apart with an odd stride, so no two share a bank.
//   * conv1: each warp owns one P2 row of 16 pixels (M = 16), N = c1 in
//     chunks of up to 32, K = 9 * c0 in k-steps of 16 (one tap, 16 input
//     channels). A by ldmatrix.x4 from the P1 tile, B by ldmatrix.x2.trans
//     from the [9 * c0][c1] weights (rows padded to an odd number of
//     16-byte slots). Epilogue: bias, SiLU, round, staged through shared
//     memory so that the tile's rows leave as 16-byte stores.
//
// stem_general_kernel (fp32, and bf16 at other widths): exact fp32 products
// on the fp32 cores (no TF32), with a register tile so that a shared-memory
// word feeds several FMAs: a thread owns 2 pixels x 8 channels in both
// convs, the lanes of a warp hold different pixels and the same channels,
// so two broadcast 16-byte weight loads and two activation words feed 16
// FMAs; the P1 tile is laid out so that those words fall in 32 different
// banks. It needs no relation between c0 and c1 and no alignment of W.
//
// Which instantiation a call takes is decided in ops/stem.py
// (stem_instantiation), whose shared-memory plans mirror the ones below.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

constexpr int kTH = 8, kTW = 16;      // P2 tile (ops/stem.py STEM_TILE)
constexpr int kP1H = 2 * kTH + 1;     // P1 tile rows incl. halo (17)
constexpr int kP1W = 2 * kTW + 1;     // P1 tile columns incl. halo (33)
constexpr int kP1 = kP1H * kP1W;      // P1 pixels of a tile (561)
constexpr int kInH = 4 * kTH + 3;     // input patch rows (35)
constexpr int kInW = 4 * kTW + 3;     // input patch columns (67)
constexpr int kHalfW = kTW + 1;       // P1 columns of one parity (17)
constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;    // bytes a Hopper block may use
constexpr int kMaxDevices = 64;

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
// SiLU as v / (1 + 2^(-v log2 e)): five instructions, two of them
// special-function operations (ex2.approx to 2^-22 relative, rcp.approx to
// 1 ulp). __expf and __fdividef wrap the same two in range handling that
// costs as much again and that SiLU does not need: a huge denominator
// (v below -87) gives v * 0, and its true value is below 1e-36.
__device__ __forceinline__ float silu_fast(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * v));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ---------------------------------------------------------------------------
// the general kernel: fp32 cores, register tiles
// ---------------------------------------------------------------------------
//
// In both convs a thread owns 2 pixels x 8 output channels. The 32 lanes of
// a warp hold 32 different pixels and the same 8 channels, so a weight load
// is one 16-byte broadcast and an activation load is one word a lane: 2 + 2
// shared-memory loads feed 16 FMAs.

// The fp32 patch: a row holds 68 pixels from input column 4 * ox0 - 4, one
// left of the first the tile needs. That start is 16-byte aligned in an
// fp32 image row (W % 4 == 0), so fp32 input arrives by 16-byte cp.async.
constexpr int kInRow = (kInW + 1) * 3;          // 204 floats
constexpr int kInRowChunks = kInRow / 4;        // 51 chunks of 16 bytes
constexpr int kInFloats = kInH * kInRow;        // 7140

// what the launch found aligned (stem_general_kernel's `flags`)
constexpr int kVecOut = 1;   // c1 % 8 == 0, out 16-byte aligned: 16-byte stores
constexpr int kAsyncIn = 2;  // fp32 x 16-byte aligned: cp.async of the patch
constexpr int kAsyncW0 = 4;  // c0 % 8 == 0, w0 aligned: cp.async of w0
constexpr int kAsyncW1 = 8;  // c1 % 8 == 0, w1 aligned: cp.async of w1

__host__ __device__ inline int pad8(int c) { return (c + 7) / 8 * 8; }

// The fp32 P1 tile: columns split by parity (a tap's 16 pixels of a row are
// then consecutive), a pixel every `s` floats with s odd (16 consecutive
// pixels in 16 different banks), a row every p1_row floats with p1_row = 8
// mod 16 (the next P2 row, two P1 rows on, falls in the other 16 banks).
__host__ __device__ inline int p1_pixel_floats(int c0) { return c0 | 1; }
__host__ __device__ inline int p1_row_floats(int c0) {
  const int base = 2 * kHalfW * p1_pixel_floats(c0);
  return base + (8 - base % 16 + 16) % 16;
}

inline size_t general_smem_bytes(int c0, int c1) {
  return sizeof(float) * ((size_t)kInFloats + 27 * pad8(c0) +
                          9 * (size_t)c0 * pad8(c1) + pad8(c0) + pad8(c1) +
                          (size_t)kP1H * p1_row_floats(c0));
}

__device__ __forceinline__ void fma8(float (&acc)[8], float v, const float4& a,
                                     const float4& b) {
  acc[0] = fmaf(v, a.x, acc[0]);
  acc[1] = fmaf(v, a.y, acc[1]);
  acc[2] = fmaf(v, a.z, acc[2]);
  acc[3] = fmaf(v, a.w, acc[3]);
  acc[4] = fmaf(v, b.x, acc[4]);
  acc[5] = fmaf(v, b.y, acc[5]);
  acc[6] = fmaf(v, b.z, acc[6]);
  acc[7] = fmaf(v, b.w, acc[7]);
}

// global floats -> shared, 16 bytes at a time (both 16-byte aligned)
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int floats, int tid) {
  for (int i = tid; i < floats / 4; i += kThreads) {
    cp_async16(smem_u32(dst + 4 * i), src + 4 * i, 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_general_kernel(const T* __restrict__ x, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, T* __restrict__ out, int H,
                    int W, int c0, int c1, int flags) {
  extern __shared__ __align__(16) float smem_f[];
  // weight rows are padded to a multiple of 8 channels (zeros) so that a
  // thread's 8 channels are two aligned 16-byte loads
  const int c0p = pad8(c0), c1p = pad8(c1);
  const int p1s = p1_pixel_floats(c0), p1r = p1_row_floats(c0);
  float* s_in = smem_f;                    // kInH * kInRow
  float* s_w0 = s_in + kInFloats;          // 27 * c0p
  float* s_w1 = s_w0 + 27 * c0p;           // 9 * c0 * c1p
  float* s_b0 = s_w1 + 9 * c0 * c1p;       // c0p
  float* s_b1 = s_b0 + c0p;                // c1p
  float* s_p1 = s_b1 + c1p;                // kP1H * p1r

  const int H1 = H / 2, W1 = W / 2, H2 = H / 4, W2 = W / 4;
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;  // P2 tile origin
  const int py0 = 2 * oy0 - 1, px0 = 2 * ox0 - 1;           // P1 tile origin
  const int iy0 = 2 * py0 - 1, ix0 = 2 * px0 - 1;           // input origin
  const int tid = threadIdx.x;

  // Weights and, for fp32 input, the patch arrive by 16-byte cp.async
  // where the launch found them aligned: nothing waits on a load until
  // all are in flight. Otherwise element by element.
  if (flags & kAsyncW0) {
    copy_async(s_w0, w0, 27 * c0, tid);
  } else {
    for (int i = tid; i < 27 * c0p; i += kThreads) {
      const int co = i % c0p;
      s_w0[i] = co < c0 ? w0[(i / c0p) * c0 + co] : 0.f;
    }
  }
  if (flags & kAsyncW1) {
    copy_async(s_w1, w1, 9 * c0 * c1, tid);
  } else {
    for (int i = tid; i < 9 * c0 * c1p; i += kThreads) {
      const int co = i % c1p;
      s_w1[i] = co < c1 ? w1[(i / c1p) * c1 + co] : 0.f;
    }
  }
  for (int i = tid; i < c0p; i += kThreads) s_b0[i] = i < c0 ? b0[i] : 0.f;
  for (int i = tid; i < c1p; i += kThreads) s_b1[i] = i < c1 ? b1[i] : 0.f;

  // 1. input patch: row r is input row iy0 + r from column ix0 - 1
  if (sizeof(T) == 4 && (flags & kAsyncIn)) {
    const unsigned char* xn =
        reinterpret_cast<const unsigned char*>(x) + (int64_t)n * H * W * 12;
    const int64_t col_byte0 = ((int64_t)ix0 - 1) * 12, row_bytes = (int64_t)W * 12;
    for (int i = tid; i < kInH * kInRowChunks; i += kThreads) {
      const int r = i / kInRowChunks, ch = i % kInRowChunks;
      const int gy = iy0 + r;
      const int64_t gb = col_byte0 + ch * 16;
      const bool ok = gy >= 0 && gy < H && gb >= 0 && gb < row_bytes;
      cp_async16(smem_u32(s_in + r * kInRow + ch * 4),
                 ok ? xn + gy * row_bytes + gb : xn, ok ? 16 : 0);
    }
  } else {
    const T* xn = x + (int64_t)n * H * W * 3;
    for (int i = tid; i < kInH * kInW * 3; i += kThreads) {
      const int c = i % 3, pix = i / 3;
      const int r = pix / kInW, q = pix % kInW;
      const int gy = iy0 + r, gx = ix0 + q;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = to_f32(xn[((int64_t)gy * W + gx) * 3 + c]);
      }
      s_in[r * kInRow + (q + 1) * 3 + c] = v;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. P1 tile with halo, rounded to the compute dtype. A thread owns P1
  //    pixels m and m + kPairs of the tile and 8 channels.
  constexpr int kPairs = (kP1 + 1) / 2;  // 281
  for (int item = tid; item < kPairs * (c0p / 8); item += kThreads) {
    const int co = 8 * (item / kPairs), m0 = item % kPairs;
    const float* px[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = min(m0 + i * kPairs, kP1 - 1);
      px[i] = s_in + 2 * (m / kP1W) * kInRow + (2 * (m % kP1W) + 1) * 3;
    }
    float acc[2][8] = {};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {  // (kx, ci): contiguous in the patch row
        const float* wk = s_w0 + (ky * 9 + k) * c0p + co;
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wb = *reinterpret_cast<const float4*>(wk + 4);
        fma8(acc[0], px[0][ky * kInRow + k], wa, wb);
        fma8(acc[1], px[1][ky * kInRow + k], wa, wb);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + i * kPairs;
      if (m >= kP1) continue;
      const int r = m / kP1W, j = m % kP1W;
      const int gy = py0 + r, gx = px0 + j;
      const bool inside = gy >= 0 && gy < H1 && gx >= 0 && gx < W1;
      float* dst = s_p1 + r * p1r + ((j & 1) * kHalfW + (j >> 1)) * p1s + co;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (co + c >= c0) continue;
        const float v = silu_fast(acc[i][c] + s_b0[co + c]);
        dst[c] = inside ? to_f32(from_f32<T>(v)) : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. P2 outputs of this tile. A thread owns pixels (r, q) and (r + 4, q)
  //    and 8 channels; a warp is two tile rows of 16 pixels.
  T* on = out + (int64_t)n * H2 * W2 * c1;
  constexpr int kHalf = kTH / 2 * kTW;  // 64 pixel pairs
  for (int item = tid; item < kHalf * (c1p / 8); item += kThreads) {
    const int co = 8 * (item / kHalf), pp = item % kHalf;
    const int r = pp / kTW, q = pp % kTW;
    float acc[2][8] = {};
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // tap (ky, kx) of pixel (r, q) is P1 (2 r + ky, 2 q + kx): parity
        // kx & 1, index q + (kx >> 1); pixel (r + 4, q) is 8 P1 rows on
        const float* p = s_p1 + (2 * r + ky) * p1r +
                         ((kx & 1) * kHalfW + q + (kx >> 1)) * p1s;
        const float* wk = s_w1 + (ky * 3 + kx) * c0 * c1p + co;
#pragma unroll 4
        for (int ci = 0; ci < c0; ++ci) {
          const float4 wa = *reinterpret_cast<const float4*>(wk + ci * c1p);
          const float4 wb = *reinterpret_cast<const float4*>(wk + ci * c1p + 4);
          fma8(acc[0], p[ci], wa, wb);
          fma8(acc[1], p[8 * p1r + ci], wa, wb);
        }
      }
    }
    const int ox = ox0 + q;
    if (ox >= W2) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = oy0 + r + (kTH / 2) * i;
      if (oy >= H2) continue;
      T* o = on + ((int64_t)oy * W2 + ox) * c1 + co;
      __align__(16) T v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        v[c] = from_f32<T>(silu_fast(acc[i][c] + s_b1[co + c]));
      }
      if (flags & kVecOut) {
#pragma unroll
        for (int c = 0; c < 8; c += 16 / (int)sizeof(T)) {
          *reinterpret_cast<uint4*>(o + c) = *reinterpret_cast<const uint4*>(v + c);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (co + c < c1) o[c] = v[c];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core kernel: bf16, mma.sync.m16n8k16
// ---------------------------------------------------------------------------

constexpr int kPatchPx = kInW + 5;          // 72: the patch row starts 8 px
                                            // left of the tile's 4*ox0
constexpr int kRowB = kPatchPx * 6;         // 432 bytes = 27 chunks of 16
constexpr int kRowChunks = kRowB / 16;      // 27
constexpr int kRowWords = kRowB / 4;        // 108
constexpr int kK0 = 48;                     // conv0's padded K: 16 per ky
constexpr int kMTiles = 2 * kP1H + 2;       // 36 row tiles of conv0
static_assert(kTW == 16, "conv0's row tiles and conv1's warp rows take 16 columns");

struct MmaPlan {
  int p1s;      // bytes of a P1 pixel: c0 * 2 + 16 (odd count of 16 B slots)
  int w1s;      // bytes of a w1 row: c1 * 2, plus 16 where that count is even
  int outs;     // bytes of a staged P2 pixel: c1 * 2 + 16
  int region0;  // patch, later the staged outputs
  int p1;       // the parity-split P1 tile
  int total;
};

__host__ __device__ inline MmaPlan mma_plan(int c0, int c1) {
  MmaPlan p;
  p.p1s = c0 * 2 + 16;
  p.w1s = c1 * 2 + ((c1 / 8) % 2 == 0 ? 16 : 0);
  p.outs = c1 * 2 + 16;
  const int patch = kInH * kRowB, staged = kTH * kTW * p.outs;
  p.region0 = patch > staged ? patch : staged;
  p.p1 = kP1H * 2 * kHalfW * p.p1s;
  p.total = p.region0 + p.p1 + 9 * c0 * p.w1s;
  return p;
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8; thread (g = l / 4, t = l % 4) receives M[g][2t], M[g][2t + 1] of each
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// two 8x8 matrices, transposed: thread (g, t) receives M[2t][g], M[2t + 1][g]
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}
// D += A (16x16, row) * B (16x8, col), bf16 operands, fp32 sums. Thread
// (g, t): a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g]; d0, d1 =
// D[g][2t], D[g][2t+1]; d2, d3 = D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(  // a pure function of its operands: the compiler may schedule it
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// w0p: [48][c0] bf16, row ky * 16 + 1 + kx * 3 + ci holds w0[ky][kx][ci][:],
// every other row 0; w1p: [9 * c0][c1] bf16, row (ky * 3 + kx) * c0 + ci.
__global__ void __launch_bounds__(kThreads)
stem_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w0p,
                const float* __restrict__ b0,
                const __nv_bfloat16* __restrict__ w1p,
                const float* __restrict__ b1, __nv_bfloat16* __restrict__ out,
                int H, int W, int c0, int c1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MmaPlan plan = mma_plan(c0, c1);
  unsigned char* s_in = smem;   // [kInH][kRowB]: the patch ...
  unsigned char* s_out = smem;  // ... and, after conv0, [kTH * kTW][outs]
  unsigned char* s_p1 = smem + plan.region0;  // [kP1H][2][kHalfW][p1s]
  unsigned char* s_w1 = s_p1 + plan.p1;       // [9 * c0][w1s]

  const int H1 = H / 2, W1 = W / 2, H2 = H / 4, W2 = W / 4;
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;  // P2 tile origin
  const int py0 = 2 * oy0 - 1, px0 = 2 * ox0 - 1;           // P1 tile origin
  const int iy0 = 2 * py0 - 1;                              // input row origin
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the patch: row r is input row iy0 + r, bytes from column 4 * ox0 - 8
  {
    const unsigned char* xn =
        reinterpret_cast<const unsigned char*>(x) + (int64_t)n * H * W * 6;
    const int64_t col_byte0 = ((int64_t)4 * ox0 - 8) * 6, row_bytes = (int64_t)W * 6;
    // a warp a row, its first 27 lanes a 16-byte chunk each: no division
    const int64_t gb = col_byte0 + lane * 16;
    const bool col_ok = gb >= 0 && gb < row_bytes;
    if (lane < kRowChunks) {
      for (int r = warp; r < kInH; r += kThreads / 32) {
        const int gy = iy0 + r;
        const bool ok = col_ok && gy >= 0 && gy < H;
        cp_async16(smem_u32(s_in + r * kRowB + lane * 16),
                   ok ? xn + gy * row_bytes + gb : xn, ok ? 16 : 0);
      }
    }
    cp_async_commit();
    const unsigned char* wg = reinterpret_cast<const unsigned char*>(w1p);
    const int cpr = c1 / 8;       // 16-byte chunks of a w1 row
    const int rows = 32 / cpr;    // rows a warp copies at a time
    const int sub = lane / cpr, ch = lane % cpr;
    if (sub < rows) {
      for (int k = warp * rows + sub; k < 9 * c0; k += kThreads / 32 * rows) {
        cp_async16(smem_u32(s_w1 + k * plan.w1s + ch * 16),
                   wg + ((int64_t)k * c1 + ch * 8) * 2, 16);
      }
    }
    cp_async_commit();
  }

  // conv0 -> the shared P1 tile. A row of the GEMM is P1 pixel (r, j) of the
  // tile; its k-step ky reads 16 bf16 from byte 28 + 12 j of patch row
  // 2 r + ky: [pad, 9 values, 6 x pad], the pads masked to 0.
  {
    const uint32_t* s_in32 = reinterpret_cast<const uint32_t*>(s_in);
    const unsigned short* w0u = reinterpret_cast<const unsigned short*>(w0p);
    for (int nc = 0; nc < c0; nc += 16) {  // 16 output channels a pass
      uint32_t bw[3][2][2];
      float bias[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nn = nc + j * 8 + g;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = ky * 16 + h * 8 + 2 * t;
            bw[ky][j][h] = (uint32_t)w0u[k * c0 + nn] |
                           ((uint32_t)w0u[(k + 1) * c0 + nn] << 16);
          }
        }
        bias[j][0] = b0[nc + j * 8 + 2 * t];
        bias[j][1] = b0[nc + j * 8 + 2 * t + 1];
      }
      if (nc == 0) {  // the loads above fly while the patch lands
        cp_async_wait<1>();  // the patch; w1 may still be in flight
        __syncthreads();
      }
      for (int mt = warp; mt < kMTiles; mt += kThreads / 32) {
        // Row tiles 0 .. 33: P1 row mt / 2, columns 0-15 or 16-31; a
        // fragment's second row (g + 8) is the pixel 8 columns on. Tiles 34
        // and 35: column 32 of rows 0-15 and 16-31 (only row 16 exists);
        // the second row is the pixel 8 rows on. `col` is one value a warp.
        const bool col = mt >= 2 * kP1H;
        const int r0 = col ? (mt - 2 * kP1H) * 16 + g : mt >> 1;
        const int j0 = col ? kP1W - 1 : (mt & 1) * 16 + g;
        const bool valid[2] = {r0 < kP1H, !col || r0 + 8 < kP1H};
        // a row that does not exist reads somewhere inside shared memory and
        // is dropped: a row of A only reaches its own row of the product
        const uint32_t* arow[2];
        arow[0] = s_in32 + 2 * min(r0, kP1H - 1) * kRowWords + 7 + 3 * j0 + t;
        arow[1] = arow[0] + (col ? 8 * 2 * kRowWords : 8 * 3);
        float acc[2][4] = {};
        uint32_t a[3][4];  // all three k-steps' loads before the first mma
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          a[ky][0] = arow[0][ky * kRowWords];
          a[ky][1] = arow[1][ky * kRowWords];
          a[ky][2] = 0u;
          a[ky][3] = 0u;
          if (t == 0) {  // k = 0 is the pad; k = 8, 9 are the last two values
            a[ky][0] &= 0xFFFF0000u;
            a[ky][1] &= 0xFFFF0000u;
            a[ky][2] = arow[0][ky * kRowWords + 4];
            a[ky][3] = arow[1][ky * kRowWords + 4];
          }
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          mma_bf16(acc[0], a[ky], bw[ky][0]);
          mma_bf16(acc[1], a[ky], bw[ky][1]);
        }
        // the second row's pixel: 8 rows down, or 8 columns on (4 entries of
        // the same parity plane)
        unsigned char* dst =
            s_p1 + ((r0 * 2 + (j0 & 1)) * kHalfW + (j0 >> 1)) * plan.p1s +
            (nc + 2 * t) * 2;
        const int dst_step = col ? 8 * 2 * kHalfW * plan.p1s : 4 * plan.p1s;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!valid[h]) continue;
          const int gy = py0 + r0 + (col ? 8 * h : 0);
          const int gx = px0 + j0 + (col ? 0 : 8 * h);
          const bool inside = (unsigned)gy < (unsigned)H1 && (unsigned)gx < (unsigned)W1;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const float v0 = silu_fast(acc[jn][2 * h] + bias[jn][0]);
            const float v1 = silu_fast(acc[jn][2 * h + 1] + bias[jn][1]);
            *reinterpret_cast<uint32_t*>(dst + h * dst_step + jn * 16) =
                inside ? pack_bf16(v0, v1) : 0u;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // w1
  __syncthreads();     // P1 complete; the patch is dead from here on

  // conv1: warp w owns P2 row w of the tile (16 pixels), all c1 channels in
  // chunks of up to 32
  {
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel this lane addresses
    const int akb = (lane >> 4) * 16;                     // bytes: k 0-7 or 8-15
    const uint32_t p1_base = smem_u32(s_p1), w1_base = smem_u32(s_w1);
    for (int nc = 0; nc < c1; nc += 32) {
      const int nt = min(4, (c1 - nc) / 8);  // 8-channel tiles in this chunk
      float acc[4][4] = {};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // tap (ky, kx) of pixel q is P1 (2 w + ky, 2 q + kx): parity kx & 1,
          // index q + (kx >> 1)
          const uint32_t a_addr =
              p1_base +
              (((2 * warp + ky) * 2 + (kx & 1)) * kHalfW + arow + (kx >> 1)) * plan.p1s +
              akb;
          const uint32_t b_addr =
              w1_base + ((ky * 3 + kx) * c0 + (lane & 15)) * plan.w1s + nc * 2;
          for (int kc = 0; kc < c0; kc += 16) {
            uint32_t a[4], b[4][2];  // every load of the k-step, then its mmas
            ldsm_x4(a_addr + kc * 2, a);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j < nt) ldsm_x2_trans(b_addr + kc * plan.w1s + j * 16, b[j]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j < nt) mma_bf16(acc[j], a, b[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nt) {
          const int ch = nc + j * 8 + 2 * t;
          const float bias0 = b1[ch], bias1 = b1[ch + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pix = warp * kTW + g + 8 * h;
            *reinterpret_cast<uint32_t*>(s_out + pix * plan.outs + ch * 2) =
                pack_bf16(silu_fast(acc[j][2 * h] + bias0),
                          silu_fast(acc[j][2 * h + 1] + bias1));
          }
        }
      }
    }
  }
  __syncthreads();

  // the staged tile -> P2, 16 bytes a thread: a tile row is contiguous
  {
    unsigned char* on = reinterpret_cast<unsigned char*>(out);
    const int cpp = c1 / 8;     // 16-byte chunks of a pixel
    const int pixels = 32 / cpp;  // pixels a warp stores at a time
    const int sub = lane / cpp, ch = lane % cpp;
    if (sub < pixels) {
      for (int pix = warp * pixels + sub; pix < kTH * kTW;
           pix += kThreads / 32 * pixels) {
        const int oy = oy0 + pix / kTW, ox = ox0 + pix % kTW;
        if (oy < H2 && ox < W2) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(s_out + pix * plan.outs + ch * 16);
          *reinterpret_cast<uint4*>(
              on + ((((int64_t)n * H2 + oy) * W2 + ox) * c1 + ch * 8) * 2) = v;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Raise the kernel's dynamic shared-memory limit once per device, not on
// every launch.
template <typename K>
cudaError_t allow_smem(K kernel, int device, std::atomic<bool>* done) {
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (tracked && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && tracked) {
    done[device].store(true, std::memory_order_release);
  }
  return err;
}

dim3 stem_grid(int n, int H, int W) {
  return dim3((W / 4 + kTW - 1) / kTW, (H / 4 + kTH - 1) / kTH, n);
}

template <typename T>
int launch_general(int device, const void* x, const void* w0, const void* b0,
                   const void* w1, const void* b1, void* out, int n, int H,
                   int W, int c0, int c1, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = general_smem_bytes(c0, c1);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stem_general_kernel<T>, device, done);
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int flags = (c1 % 8 == 0 && aligned(out) ? kVecOut : 0) |
                    (aligned(x) ? kAsyncIn : 0) |
                    (c0 % 8 == 0 && aligned(w0) ? kAsyncW0 : 0) |
                    (c1 % 8 == 0 && aligned(w1) ? kAsyncW1 : 0);
  stem_general_kernel<T><<<stem_grid(n, H, W), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<T*>(out), H, W, c0, c1,
      flags);
  return (int)cudaGetLastError();
}

int launch_mma(int device, const void* x, const void* w0p, const void* b0,
               const void* w1p, const void* b1, void* out, int n, int H, int W,
               int c0, int c1, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  if (c0 % 16 != 0 || c1 % 8 != 0 || c1 > 256 || W % 8 != 0 || w0p == nullptr ||
      w1p == nullptr || ((uintptr_t)x | (uintptr_t)w1p | (uintptr_t)out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = mma_plan(c0, c1).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stem_mma_kernel, device, done);
  if (err != cudaSuccess) return (int)err;
  stem_mma_kernel<<<stem_grid(n, H, W), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w0p), static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(w1p), static_cast<const float*>(b1),
      static_cast<__nv_bfloat16*>(out), H, W, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, H, W, 3] NHWC contiguous, bf16 or fp32 (is_bf16), pixel scale.
// w0: [3, 3, 3, c0], w1: [3, 3, c0, c1] HWIO fp32; b0 [c0], b1 [c1] fp32.
// w0p [48, c0], w1p [9 * c0, c1]: the packed bf16 operands of the
// tensor-core kernel (read only when use_mma; see stem_mma_kernel).
// out: [n, H/4, W/4, c1] NHWC contiguous, same dtype as x.
extern "C" int rva_fused_stem(int device, const void* x, const void* w0,
                              const void* b0, const void* w1, const void* b1,
                              const void* w0p, const void* w1p, void* out,
                              int n, int H, int W, int c0, int c1, int is_bf16,
                              int use_mma, void* stream) {
  cudaError_t dev_err = rva_use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_mma) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return launch_mma(device, x, w0p, b0, w1p, b1, out, n, H, W, c0, c1, s);
  }
  if (is_bf16) {
    return launch_general<__nv_bfloat16>(device, x, w0, b0, w1, b1, out, n, H,
                                         W, c0, c1, s);
  }
  return launch_general<float>(device, x, w0, b0, w1, b1, out, n, H, W, c0, c1,
                               s);
}
