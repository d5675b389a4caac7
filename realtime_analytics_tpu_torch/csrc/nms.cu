// B6: the greedy keep pass of batched NMS, computed from the boxes.
//
// Replaces no TPU kernel: it is the counterpart of the IoU matrix, the
// overlap masks and the jax.lax.while_loop of
// realtime_analytics_tpu/ops/nms.py::batched_nms (:134-156), which XLA fuses
// and sweeps on the device until nothing changes.
//
// The function. boxes [n, k, 4] f32 xyxy (already class-shifted where NMS
// is class-aware), valid [n, k] bool, in rank order. keep [n, k] bool is the
// greedy pass
//     keep[i] = valid[i] && !any_{j < i} (keep[j] && iou(j, i) > thr),
// the unique fixpoint of the reference's sweeps
//     keep = valid & ~(overlap @ keep > 0),
//     overlap = (iou > thr) & (j < i) & valid[j] & valid[i],
// so the two agree bit for bit. A second entry, rva_nms_keep, takes that
// overlap matrix itself ([n, k, k] bool, set only for j < i) instead of the
// boxes; it packs the matrix into the same words and runs the same chain.
//
// What bounds it on the card. The operations: k (k - 1) / 2 pairs an image
// at about 12 fp32 operations each (50 MFLOP at n = 32, k = 512: 0.75 us
// at 67 TFLOP/s); the bytes are fewer (the boxes, 262 KB). But the greedy
// pass is a chain of k dependent decisions, which no parallel pass can
// shorten: the design spends the card on the pairs and keeps the chain's
// steps cheap.
//
// Pass 1, the mask, across the card (nms_mask_kernel): one warp a 32 x 32
// tile of the upper triangle (row block b <= column block q), eight tiles a
// block, a grid of images x tiles. Lane t holds the better box i = 32b + t;
// the 32 column boxes j = 32q + s sit in shared memory, and the lane packs
// [iou(i, j) > thr] over s into one word, with no division and no branch
// (a multiply in double decides the test exactly: see Cut). The layout is
// the
// transposed one: row i holds the WORSE j that i suppresses, so the chain
// ORs the rows of the ranks it keeps and reads no row of a rank it drops.
// Only the words on and right of the diagonal exist: row block b stores its
// 32 rows' words q = b .. W-1 (W = ceil(k / 32)) contiguously, row after
// row, so a pass over the words of one row is coalesced; an image holds
// 32 W (W + 1) / 2 words (17 KB at k = 512, 4.4 MB at k = 8400). A
// diagonal word holds both sides of its row (the better ranks of the block
// that overlap it too). A tile without a valid row or column is skipped:
// sorted scores make the valid candidates a prefix, so at a usual
// confidence threshold most tiles are.
// Pass 2, the chain, one block an image (nms_chain_kernel), W steps of 32
// ranks. A `removed` word a column block starts as the ranks not valid (and
// those past k). Step b: one warp resolves the 32 ranks of block b from
// removed[b] and the diagonal words, lane t holding row t's: rounds of one
// vote each (a live rank stays kept while no kept better rank of the block
// overlaps it) until nothing changes, which takes the block's longest chain
// of suppressions plus one round; past four rounds, 32 bit steps in rank
// order. Then the kept ranks' words q > b are ORed into removed[q], all
// threads over q, four independent loads at a time. Up to k = 1024 the
// image's words are staged into shared memory (at most 66 KB) and one warp
// runs the whole chain, lane q holding removed[q] in a register: no
// __syncthreads between steps. Above that the words stay in the scratch
// buffer (a step reads only its kept rows, through the L2), removed and the
// kept words live in shared memory and 256 threads OR each step's rows: any
// k whose words fit the card runs. The wrapper sizes the scratch for a
// chunk of images and the entry runs the two passes chunk by chunk, so
// n = 32 at k = 8400 needs 71 MB, not 141 MB.
//
// Exactness. The IoU follows ops/boxes.py::iou_matrix operation by
// operation: tl = max, br = min, wh = clamp_min(br - tl, 0), inter = w h,
// area = (x2 - x1)(y2 - y1), union = (area_i + area_j) - inter,
// iou = inter / max(union, 1e-6f), all with explicit round-to-nearest
// intrinsics (no FMA contraction); the quotient's test is decided exactly
// (Cut), or by an IEEE division on the NaN-keeping path. torch.maximum,
// torch.minimum and clamp propagate NaN, fmaxf and fminf do not: a pair
// with a coordinate of 2^60 or more in magnitude (NaN and inf included)
// takes max and min that keep a NaN, so a NaN coordinate gives a NaN IoU and
// no overlap, as in PyTorch; below that no intermediate can be NaN or
// infinite and fmaxf and fminf give the same bits. The threshold arrives as
// a float and is compared in float, as PyTorch compares an f32 tensor with
// a Python number (at 0.3 a double compare would differ). Each operation is
// symmetric in i and j (max, min, products and sums commute), so iou(i, j)
// is iou(j, i) bit for bit and the transposed layout holds the same bits as
// the reference's matrix.

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

#include "_common.cu"

namespace {

constexpr int kTileWarps = 8;       // mask-pass tiles a block
constexpr int kChainThreads = 256;
constexpr int kStagedWords = 32;    // W up to which the chain stages an image's words
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 227 * 1024;  // a block's shared memory on sm_90
constexpr unsigned kAll = 0xffffffffu;

// Tiles (and words a row block) before row block b: b W - b (b - 1) / 2.
__host__ __device__ __forceinline__ long long tri_base(int b, int w) {
  return (long long)b * w - (long long)b * (b - 1) / 2;
}

// Words of one image: 32 rows a tile.
__host__ __device__ __forceinline__ long long image_words(int w) {
  return 32 * tri_base(w, w);
}

// torch.maximum / torch.minimum: a NaN operand gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr in ops/boxes.py::iou_matrix's operation order.
__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float w = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)), 0.0f);
  const float h = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, nan_max(uni, 1e-6f)) > thr;
}

// Coordinates under 2^60 in magnitude (so not NaN and not infinite): every
// intermediate of a pair of such boxes is finite (differences under 2^61,
// products under 2^122), so no NaN reaches a max or a min, and fmaxf and
// fminf agree with PyTorch's NaN-keeping ones.
__device__ __forceinline__ bool tame(float4 b) {
  constexpr float kBig = 1152921504606846976.0f;  // 2^60
  return fabsf(b.x) < kBig && fabsf(b.y) < kBig && fabsf(b.z) < kBig && fabsf(b.w) < kBig;
}

// The threshold test without a division. For inter >= 0 and union > 0
// (both finite), RN(inter / union) > thr exactly when inter / union passes
// the midpoint m of thr and the next float above it (or equals m, when a
// tie rounds up: that float's significand is even), that is when
// inter > m * union, a product that is exact in double (25 + 24 bits).
// A negative thr passes every such quotient; a NaN or infinite one none.
struct Cut {
  float thr;   // for the NaN-keeping path
  double mid;  // m, or +inf when nothing passes
  bool neg;    // thr < 0: everything passes
  bool tie;    // a quotient of exactly m rounds above thr
};

// iou_over for two tame boxes: fmaxf and fminf, the cut for the division;
// no branch, so the compiler interleaves the pairs.
__device__ __forceinline__ bool tame_iou_over(float4 a, float area_a, float4 b, float area_b,
                                              const Cut& cut) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-6f);
  const double x = (double)inter, p = __dmul_rn(cut.mid, (double)uni);
  return cut.neg | (x > p) | (cut.tie & (x == p));
}

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

// Box r of an image (4 floats, read one by one: a view may start anywhere);
// past k a NaN box, which overlaps nothing.
__device__ __forceinline__ float4 load_box(const float* boxes, int r, int k) {
  if (r >= k) {
    const float nan = __int_as_float(0x7fc00000);
    return make_float4(nan, nan, nan, nan);
  }
  const float* p = boxes + (size_t)r * 4;
  return make_float4(p[0], p[1], p[2], p[3]);
}

struct FromBoxes {
  const float* boxes;  // [n, k, 4]
  Cut cut;
};

struct FromOverlap {
  const uint8_t* overlap;  // [n, k, k], set only for j < i
};

// The row block of tile u of an image: the largest b with tri_base(b) <= u.
__device__ __forceinline__ int row_block(long long u, int w) {
  const double c = 2.0 * w + 1.0;
  int b = (int)((c - sqrt(c * c - 8.0 * (double)u)) * 0.5);
  b = max(0, min(b, w - 1));
  while (b > 0 && tri_base(b, w) > u) --b;
  while (b + 1 < w && tri_base(b + 1, w) <= u) ++b;
  return b;
}

// Pass 1: tile u = blockIdx.x * kTileWarps + warp of image blockIdx.y,
// row block b, column block q >= b; lane t writes row 32b + t's word q. A
// tile without a valid row or without a valid column is left unwritten:
// the chain reads the words of kept (so valid) rows only, and ORs a word
// into a column block only where every rank is already removed when the
// block has no valid rank.
template <class Src, bool kVec>
__global__ void __launch_bounds__(32 * kTileWarps)
nms_mask_kernel(Src src, const uint8_t* __restrict__ valid, uint32_t* __restrict__ words, int k,
                int w, long long tiles) {
  __shared__ float4 s_box[kTileWarps][32];
  __shared__ float s_area[kTileWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * kTileWarps + warp;
  if (u >= tiles) return;  // whole warps: no block-wide barrier follows
  const int img = blockIdx.y;
  const int b = row_block(u, w);
  const int q = b + (int)(u - tri_base(b, w));
  const int i = b * 32 + lane, j0 = q * 32;
  const uint8_t* v = valid + (size_t)img * k;
  const bool valid_i = i < k && v[i] != 0, valid_j = j0 + lane < k && v[j0 + lane] != 0;
  if (!__any_sync(kAll, valid_i) || !__any_sync(kAll, valid_j)) return;
  uint32_t word = 0u, mine_row = 0u;
  if constexpr (std::is_same_v<Src, FromBoxes>) {
    const float* boxes = src.boxes + (size_t)img * k * 4;
    const float4 bj = load_box(boxes, j0 + lane, k);
    s_box[warp][lane] = bj;
    s_area[warp][lane] = box_area(bj);
    const float4 bi = load_box(boxes, i, k);
    const float area_i = box_area(bi);
    __syncwarp();
    if (__all_sync(kAll, tame(bi) && tame(bj))) {  // the tile's 64 boxes: every pair tame
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        word |= (uint32_t)tame_iou_over(bi, area_i, s_box[warp][s], s_area[warp][s], src.cut)
                << s;
      }
    } else {
#pragma unroll 4
      for (int s = 0; s < 32; ++s) {
        word |= (uint32_t)iou_over(bi, area_i, s_box[warp][s], s_area[warp][s], src.cut.thr)
                << s;
      }
    }
  } else {
    // lane s reads row j = j0 + s (a worse rank) at the columns of block b:
    // bit t says j overlaps the better i = 32b + t; 32 ballots transpose
    // the tile so that lane t gets, over s, the j that row i suppresses
    const uint8_t* ov = src.overlap + (size_t)img * k * k;
    const int j = j0 + lane;
    const uint32_t mine = j < k ? pack_word<kVec>(ov + (size_t)j * k, b, k) : 0u;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t col = __ballot_sync(kAll, (mine >> t) & 1u);
      if (lane == t) word = col;
    }
    if (i >= k) word = 0u;
    mine_row = mine;  // on the diagonal tile, row i's own columns of block b
  }
  if (q == b) {
    // the diagonal tile holds both sides of row i: the later ranks that i
    // suppresses (j > i) and the better ranks that suppress i (j < i)
    if constexpr (std::is_same_v<Src, FromBoxes>) {
      word &= ~(1u << lane);  // iou(i, j) is iou(j, i): only i itself to clear
    } else {
      const uint32_t above = lane == 31 ? 0u : kAll << (lane + 1);
      word = (word & above) | (mine_row & ~above & ~(1u << lane));
    }
  }
  words[(size_t)img * image_words(w) + 32 * tri_base(b, w) + (size_t)lane * (w - b) + (q - b)] =
      word;
}

// Ranks [32q, 32q + 32) of one image that are valid (and below k), as a
// word: 32 independent byte loads.
__device__ __forceinline__ uint32_t live_word(const uint8_t* valid, int q, int k) {
  uint32_t word = 0u;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const int r = q * 32 + s;
    word |= (uint32_t)(r < k && valid[r] != 0) << s;
  }
  return word;
}

// The 32 ranks of one block, from removed word r (every lane the same) and
// lane t's diagonal word `sym` (the ranks of the block that overlap rank t,
// both sides). Returns the kept word, every lane the same. The kept set K is
// the unique fixpoint of K = live & {t : no rank of K before t overlaps t}:
// starting from K = live, each round is one vote, and the rounds reach it
// after (the longest chain of suppressions in the block) + 1 of them; a
// block that needs more than kRounds takes the 32 ranks in order, rank t
// kept when its bit is still clear and then ORing its word (the better
// ranks it overlaps are then removed already, so only later ranks change).
constexpr int kRounds = 4;

__device__ __forceinline__ uint32_t resolve(uint32_t r, uint32_t sym, int lane) {
  const uint32_t live = ~r;
  const bool mine = (live >> lane) & 1u;
  const uint32_t better = sym & ((1u << lane) - 1u);
  uint32_t kept = live;
  for (int round = 0; round < kRounds; ++round) {
    const uint32_t next = __ballot_sync(kAll, mine && !(better & kept));
    if (next == kept) return kept;
    kept = next;
  }
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const uint32_t d = __shfl_sync(kAll, sym, t);
    if (!(r & (1u << t))) r |= d;
  }
  return ~r;
}

// OR of rows[t * stride] over the set bits t of kept, four independent
// loads at a time (a repeated index loads a word already ORed).
__device__ __forceinline__ uint32_t or_rows(const uint32_t* rows, int stride, uint32_t kept) {
  uint32_t acc = 0u;
  while (kept) {
    int t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      t[u] = kept ? __ffs(kept) - 1 : t[0];
      kept &= kept - 1;
    }
    acc |= rows[t[0] * stride] | rows[t[1] * stride] | rows[t[2] * stride] |
           rows[t[3] * stride];
  }
  return acc;
}

// Pass 2: one block an image. kStaged: w <= 32, the words in shared memory,
// one warp; else the words in the scratch, the whole block.
template <bool kStaged>
__global__ void __launch_bounds__(kChainThreads)
nms_chain_kernel(const uint32_t* __restrict__ words, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int k, int w) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long per = image_words(w);
  const uint32_t* src = words + (size_t)img * per;
  const uint8_t* v = valid + (size_t)img * k;
  uint8_t* out = keep + (size_t)img * k;

  if constexpr (kStaged) {
    // per is a multiple of 32 words and each image's words start 128-byte
    // aligned (the scratch is), so the copy goes in 16-byte units
    __shared__ uint32_t s_live[kStagedWords];
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(smem);
#pragma unroll 4
    for (long long p = threadIdx.x; p < per / 4; p += kChainThreads) dst4[p] = src4[p];
    if (threadIdx.x < w) s_live[threadIdx.x] = live_word(v, threadIdx.x, k);
    __syncthreads();
    if (warp != 0) return;
    uint32_t removed = lane < w ? ~s_live[lane] : kAll;  // lane q: removed word q
    uint32_t kept = 0u;  // lane q: kept word q
    for (int b = 0; b < w; ++b) {
      const uint32_t r = __shfl_sync(kAll, removed, b);
      if (r == kAll) continue;  // every rank of the block gone: the same for every lane
      const uint32_t* blk = smem + 32 * tri_base(b, w);
      const int len = w - b;
      const uint32_t kb = resolve(r, blk[lane * len], lane);
      if (lane == b) kept = kb;
      if (lane > b && lane < w) removed |= or_rows(blk + (lane - b), len, kb);
    }
    for (int q = 0; q < w; ++q) {
      const uint32_t kw = __shfl_sync(kAll, kept, q);
      const int r = q * 32 + lane;
      if (r < k) out[r] = (uint8_t)((kw >> lane) & 1u);
    }
  } else {
    uint32_t* s_removed = smem;
    uint32_t* s_kept = smem + w;
    for (int q = threadIdx.x; q < w; q += kChainThreads) s_removed[q] = ~live_word(v, q, k);
    __syncthreads();
    uint32_t diag = warp == 0 ? src[lane * w] : 0u;  // block 0's diagonal words
    for (int b = 0; b < w; ++b) {
      const uint32_t* blk = src + 32 * tri_base(b, w);
      const int len = w - b;
      if (warp == 0) {
        const uint32_t r = s_removed[b];
        const uint32_t kb = r == kAll ? 0u : resolve(r, diag, lane);
        if (lane == 0) s_kept[b] = kb;
        // the next block's diagonal words, in flight across this step's ORs
        if (b + 1 < w) diag = blk[32 * len + lane * (len - 1)];
      }
      __syncthreads();
      const uint32_t kb = s_kept[b];
      if (kb) {
        for (int q = b + 1 + threadIdx.x; q < w; q += kChainThreads) {
          s_removed[q] |= or_rows(blk + (q - b), len, kb);
        }
      }
      __syncthreads();
    }
    for (int r = threadIdx.x; r < k; r += kChainThreads) {
      out[r] = (uint8_t)((s_kept[r >> 5] >> (r & 31)) & 1u);
    }
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

// The chain kernel may take `bytes` of dynamic shared memory (set once a
// device and instantiation).
template <bool kStaged>
cudaError_t allow_chain_smem(int bytes, int device) {
  static std::atomic<bool> done[kMaxDevices];
  return allow_smem(nms_chain_kernel<kStaged>, bytes, done, device);
}

// The two passes over images [0, n), `chunk` images at a time through
// `scratch` (chunk * image_words(w) words).
template <class Src, bool kVec>
cudaError_t run(Src src, size_t src_image, const uint8_t* valid, uint8_t* keep,
                uint32_t* scratch, int n, int k, int chunk, int device, cudaStream_t stream) {
  const int w = (k + 31) / 32;
  const long long tiles = tri_base(w, w);
  const bool staged = w <= kStagedWords;
  const size_t chain_smem = staged ? (size_t)image_words(w) * 4 : (size_t)w * 8;
  cudaError_t err = staged ? allow_chain_smem<true>((int)(image_words(kStagedWords) * 4), device)
                           : allow_chain_smem<false>(kSmemLimit, device);
  if (err != cudaSuccess) return err;
  const dim3 mask_block(32 * kTileWarps);
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int m = n - c0 < chunk ? n - c0 : chunk;
    Src part = src;
    if constexpr (std::is_same_v<Src, FromBoxes>) {
      part.boxes += (size_t)c0 * src_image;
    } else {
      part.overlap += (size_t)c0 * src_image;
    }
    const dim3 grid((unsigned)((tiles + kTileWarps - 1) / kTileWarps), (unsigned)m);
    const uint8_t* va = valid + (size_t)c0 * k;
    nms_mask_kernel<Src, kVec><<<grid, mask_block, 0, stream>>>(part, va, scratch, k, w, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    uint8_t* out = keep + (size_t)c0 * k;
    if (staged) {
      nms_chain_kernel<true><<<m, kChainThreads, chain_smem, stream>>>(scratch, va, out, k, w);
    } else {
      nms_chain_kernel<false><<<m, kChainThreads, chain_smem, stream>>>(scratch, va, out, k, w);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The cut of threshold thr (see Cut).
Cut cut_of(float thr) {
  Cut cut{thr, INFINITY, false, false};
  if (std::isnan(thr) || thr == INFINITY) return cut;  // nothing passes
  if (thr < 0.0f) {
    cut.neg = true;
    return cut;
  }
  const float t = std::fabs(thr);  // -0 compares as +0
  uint32_t bits;
  std::memcpy(&bits, &t, sizeof bits);
  const double ulp = t == FLT_MAX ? std::ldexp(1.0, 104)
                                  : (double)std::nextafter(t, INFINITY) - (double)t;
  cut.mid = (double)t + ulp / 2;
  cut.tie = (bits & 1u) != 0;  // the float above has the even significand
  return cut;
}

// What both entries check: shapes, the chunk, and the kernels' limits
// (grid rows, the chain's shared memory above the staged size).
bool bad_args(int n, int k, int chunk, const void* scratch) {
  if (n < 0 || k < 0) return true;
  if (n == 0 || k == 0) return false;
  const int w = (k + 31) / 32;
  return scratch == nullptr || (uintptr_t)scratch % 16 != 0 || chunk < 1 || chunk > 65535 ||
         (w > kStagedWords && (long long)w * 8 > kSmemLimit);
}

}  // namespace

// boxes: [n, k, 4] f32, valid and keep: [n, k] bool, all contiguous on CUDA
// device `device`; scratch: chunk * 32 W (W + 1) / 2 uint32 words (W =
// ceil(k / 32)), chunk >= 1 images a launch pair. thr is compared in
// float. The launches go to `stream`; nothing waits on the host.
extern "C" int rva_nms_keep_boxes(int device, const void* boxes, const void* valid, void* keep,
                                  void* scratch, int n, int k, float thr, int chunk,
                                  void* stream) {
  if (bad_args(n, k, chunk, scratch)) return (int)cudaErrorInvalidValue;
  cudaError_t err = rva_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || k == 0) return (int)cudaSuccess;
  FromBoxes src{static_cast<const float*>(boxes), cut_of(thr)};
  return (int)run<FromBoxes, false>(src, (size_t)k * 4, static_cast<const uint8_t*>(valid),
                                    static_cast<uint8_t*>(keep),
                                    static_cast<uint32_t*>(scratch), n, k, chunk, device,
                                    (cudaStream_t)stream);
}

// overlap: [n, k, k] bool, set only for j < i; valid and keep: [n, k] bool;
// scratch and chunk as above.
extern "C" int rva_nms_keep(int device, const void* overlap, const void* valid, void* keep,
                            void* scratch, int n, int k, int chunk, void* stream) {
  if (bad_args(n, k, chunk, scratch)) return (int)cudaErrorInvalidValue;
  cudaError_t err = rva_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || k == 0) return (int)cudaSuccess;
  FromOverlap src{static_cast<const uint8_t*>(overlap)};
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  uint8_t* out = static_cast<uint8_t*>(keep);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  const size_t per = (size_t)k * k;
  const bool vec = k % 16 == 0 && (uintptr_t)overlap % 16 == 0;
  return (int)(vec ? run<FromOverlap, true>(src, per, va, out, words, n, k, chunk, device,
                                            (cudaStream_t)stream)
                   : run<FromOverlap, false>(src, per, va, out, words, n, k, chunk, device,
                                             (cudaStream_t)stream));
}
