// B8: pooled attention with the decomposed relative-position bias of MViTv2
// (models/mvit.py), in one pass: softmax(q k^T * scale + bias) v + q.
//
// Replaces: no Pallas kernel (the JAX package has no MViT). The plain route
// (ops/attention.py::rel_pos_attention_plain, PySlowFast's own) materialises
// the logits [B, heads, Nq, Nk], adds the bias
//   bias[i, j] = rel_t[i, t(j)] + rel_h[i, h(j)] + rel_w[i, w(j)]
// (rows and columns past the cls token; (t, h, w) the key's place in the
// pooled k/v grid) as two broadcast passes, runs a softmax and a product,
// then adds the residual-pooling q. An MViTv2-S step at b32 has 2.4 G logits
// (75.2 M a clip): about 10 GB of device memory traffic a step that this
// kernel never makes. It reads q, k and v once, the three small per-query
// tables once (rel_t/h/w [B, heads, Nq - 1, k_t|k_h|k_w], made outside by
// small matmuls), and writes [B, Nq, heads * 96], ready for `proj`.
//
// Arithmetic (FlashAttention-2's forward): bf16 operands, fp32 sums on the
// tensor cores (mma.sync.m16n8k16), the logits scaled in fp32, an online
// softmax (exp2 of the logits times log2 e), P rounded to bf16 for the PV
// product, the output divided by the row sum, q added, rounded once.
//
// The bias is a product too: bias = A E, A = [rel_t | rel_h | rel_w] of a
// row (k_t + k_h + k_w values, zero-padded to a multiple of 16) and E the
// key tile's one-hot columns (E[j][t(j)] = E[j][k_t + h(j)] = E[j][k_t + k_h +
// w(j)] = 1; the cls key's row and the padding 0). It runs on the tensor
// cores into the logits' accumulator, after their scale: each sum holds the
// three table values exactly, added in fp32.
//
// What bounds it on the card: operations. Block 0 of MViTv2-S at b32 is
// 121 GFLOP against 160 MB read and written (about 750 flop/byte, above the
// 295 balance point); the later blocks are the same or denser. The design:
//   * A block owns 128 query rows of one (clip, head), 32 a warp (two
//     16-row tiles, so each K, V and E fragment a warp loads serves both);
//     it walks the keys in tiles of 64, K, V and E double-buffered in shared
//     memory (K and V by 16-byte cp.async with zero fill past the last key;
//     E written by the threads from each key's decoded (t, h, w)), so the
//     next tile lands while this one is multiplied.
//   * Every fragment comes by ldmatrix (x4: two 8-wide tiles a load; V's
//     transposed); shared rows are padded by 16 bytes, so the eight rows of
//     a load fall in distinct banks.
//   * P goes from the S accumulators to A fragments without shared memory.
//   * The residual q is read back from the Q tile.
// In an earlier form (64 rows a block, 16 a warp, the bias as three fp32
// shared loads a logit) the bias loads and the K/V fragments re-read by
// each 16-row warp held it near 10% of its bound (PERF.md, §6).
// Head dim 96 only (MViTv2's in every block), k_t + k_h + k_w <= 64.
//
// Allocates nothing, waits on nothing: safe inside a CUDA graph capture.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "_common.cu"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 96;              // head dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;              // 16-row tiles a warp
constexpr int kM = 16 * kMT * kWarps;  // query rows a block
constexpr int kN = 64;              // keys a tile
constexpr int kRow = kD + 8;        // shared row of q, k, v, in bf16 values
constexpr int kChunks = kD / 8;     // 16-byte chunks a row
constexpr int kMaxRel = 64;         // k_t + k_h + k_w at most
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned short kOne = 0x3F80;  // bf16 1.0
static_assert(kM == kThreads, "a thread stages one row of the tables");

// shared memory: Q [kM][kRow], K and V [2][kN][kRow], then the rows' tables
// A [kM][rrow] and the key tiles' one-hot E [2][kN][rrow] (rrow = the
// tables' width padded to 16, plus 8)
constexpr int kQBytes = kM * kRow * 2;
constexpr int kTileBytes = kN * kRow * 2;
constexpr int kFixedBytes = kQBytes + 4 * kTileBytes;
constexpr int smem_bytes(int rpad) { return kFixedBytes + (kM + 2 * kN) * (rpad + 8) * 2; }
constexpr int kSmemLimit = smem_bytes(kMaxRel);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 matrices; lane l gives the address of row l % 8 of matrix l / 8;
// thread (g, t) receives M[g][2t], M[g][2t + 1] of each
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// the same, transposed: thread (g, t) receives M[2t][g], M[2t + 1][g]
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// D += A (16x16, row) * B (16x8, col), bf16 operands, fp32 sums. Thread
// (g, t): a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g]; d0, d1 =
// D[g][2t], D[g][2t+1]; d2, d3 = D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [0, valid) of a tile of `rows` [*, 96] bf16 rows from src (row 0 of
// the tile, a valid address), the rest zero
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows, int valid,
                                          int tid) {
  const uint32_t base = smem_u32(dst);
  for (int c = tid; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const bool ok = r < valid;
    cp_async16(base + (uint32_t)(r * kRow + ch * 8) * 2, ok ? src + (size_t)r * kD + ch * 8 : src,
               ok ? 16 : 0);
  }
}

// the one-hot rows E[j] of keys j0 .. j0 + kN - 1, 8 columns a store: 1 at
// t, k_t + h and k_t + k_h + w of a key past the cls token, 0 elsewhere
__device__ __forceinline__ void build_onehot(bf16* e, int rrow, int rpad, int j0, int nk, int kt,
                                             int kh, int kw, int tid) {
  const int chunks = rpad / 8;
  for (int c = tid; c < kN * chunks; c += kThreads) {
    const int r = c / chunks, col0 = (c - r * chunks) * 8, j = j0 + r;
    int c0 = -1, c1 = -1, c2 = -1;
    if (j >= 1 && j < nk) {
      const int idx = j - 1, hw = kh * kw;
      const int t = idx / hw, rest = idx - t * hw;
      const int h = rest / kw;
      c0 = t;
      c1 = kt + h;
      c2 = kt + kh + (rest - h * kw);
    }
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = col0 + 2 * i, b = a + 1;
      const uint32_t lo = (a == c0 || a == c1 || a == c2) ? kOne : 0u;
      const uint32_t hi = (b == c0 || b == c1 || b == c2) ? kOne : 0u;
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(e + r * rrow + col0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// grid: (ceil(nq / kM), batch * heads); q [batch * heads, nq, 96], k and v
// [batch * heads, nk, 96], rt/rh/rw [batch * heads, nq - 1, k_t|k_h|k_w],
// out [batch, nq, heads * 96], all contiguous bf16
__global__ void __launch_bounds__(kThreads, 2)
rel_pos_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ rt,
                         const bf16* __restrict__ rh, const bf16* __restrict__ rw,
                         bf16* __restrict__ out, int heads, int nq, int nk, int kt, int kh,
                         int kw, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rel = kt + kh + kw, rpad = (rel + 15) & ~15, rrow = rpad + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kM * kRow;
  bf16* sv = sk + 2 * kN * kRow;
  bf16* sa = sv + 2 * kN * kRow;
  bf16* se = sa + kM * rrow;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // this lane's ldmatrix row
  const int bh = blockIdx.y, row0 = blockIdx.x * kM;
  const bf16* qb = q + (size_t)bh * nq * kD;
  const bf16* kb = k + (size_t)bh * nk * kD;
  const bf16* vb = v + (size_t)bh * nk * kD;
  const int tiles = (nk + kN - 1) / kN;

  load_rows(sq, qb + (size_t)row0 * kD, kM, nq - row0, tid);
  load_rows(sk, kb, kN, nk, tid);
  load_rows(sv, vb, kN, nk, tid);
  cp_async_commit();
  build_onehot(se, rrow, rpad, 0, nk, kt, kh, kw, tid);
  // the rows' tables: thread r stages row r, rel_t, rel_h, rel_w of query
  // row0 + r (0 for the cls row and past the last), zero-padded to rpad; the
  // loop is unrolled, so every load of the row is in flight before its
  // stores (a loop over the tile's elements waited on each load in turn)
  {
    const int row = row0 + tid;
    const bool live = row >= 1 && row < nq;
    const size_t tr = (size_t)bh * (nq - 1) + (live ? row - 1 : 0);
    bf16* dst = sa + tid * rrow;
#pragma unroll
    for (int c = 0; c < kMaxRel; ++c) {
      if (c < rpad) {
        bf16 x = __ushort_as_bfloat16(0);
        if (live && c < rel) {
          x = c < kt ? rt[tr * kt + c] : c < kt + kh ? rh[tr * kh + (c - kt)]
                                                     : rw[tr * kw + (c - kt - kh)];
        }
        dst[c] = x;
      }
    }
  }

  const int wrow = warp * 16 * kMT;  // this warp's first row in the block
  const float neg_inf = __int_as_float(0xff800000);
  float o[kMT][12][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < 12; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = neg_inf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // ldmatrix addresses: an A operand's rows (Q, the tables) and a B
  // operand's rows (K, E) for lane (mat, mr)
  const int a_row = mr + (mat & 1) * 8, a_col = (mat >> 1) * 8;
  const int b_row = mr + (mat >> 1) * 8, b_col = (mat & 1) * 8;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      const int j0 = (it + 1) * kN;
      load_rows(sk + (buf ^ 1) * kN * kRow, kb + (size_t)j0 * kD, kN, nk - j0, tid);
      load_rows(sv + (buf ^ 1) * kN * kRow, vb + (size_t)j0 * kD, kN, nk - j0, tid);
      cp_async_commit();
      build_onehot(se + (buf ^ 1) * kN * rrow, rrow, rpad, j0, nk, kt, kh, kw, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* skb = sk + buf * kN * kRow;
    const bf16* svb = sv + buf * kN * kRow;
    const bf16* seb = se + buf * kN * rrow;

    // S = Q K^T, 32 x 64 a warp; each K fragment serves both row tiles
    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldsm_x4(smem_u32(sq + (wrow + mt * 16 + a_row) * kRow + ks * 16 + a_col), a[mt]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // key tiles 2 np and 2 np + 1
        uint32_t b[4];
        ldsm_x4(smem_u32(skb + (np * 16 + b_row) * kRow + ks * 16 + b_col), b);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    // the scale, then the bias A E into the same sums
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] *= scale;
    for (int ks = 0; ks < rpad / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldsm_x4(smem_u32(sa + (wrow + mt * 16 + a_row) * rrow + ks * 16 + a_col), a[mt]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(smem_u32(seb + (np * 16 + b_row) * rrow + ks * 16 + b_col), b);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if ((it + 1) * kN > nk) {  // the last tile: keys past the end take no weight
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (it * kN + nt * 8 + 2 * t4 + e >= nk) {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) s[mt][nt][e] = s[mt][nt][2 + e] = neg_inf;
          }
    }
    // online softmax; P as A fragments (keys 16 kk .. 16 kk + 15 are S tiles
    // 2 kk and 2 kk + 1)
    uint32_t pf[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every tile holds a key that is not past the end: the maxima are finite
      const float c0 = exp2_approx((m[mt][0] - mx0) * kLog2e);
      const float c1 = exp2_approx((m[mt][1] - mx1) * kLog2e);
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      const float b0 = mx0 * kLog2e, b1 = mx1 * kLog2e;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2_approx(fmaf(s[mt][nt][0], kLog2e, -b0));
        const float p1 = exp2_approx(fmaf(s[mt][nt][1], kLog2e, -b0));
        const float p2 = exp2_approx(fmaf(s[mt][nt][2], kLog2e, -b1));
        const float p3 = exp2_approx(fmaf(s[mt][nt][3], kLog2e, -b1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pf[mt][nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
        pf[mt][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[mt][0] = l[mt][0] * c0 + sum0;
      l[mt][1] = l[mt][1] * c1 + sum1;
#pragma unroll
      for (int n = 0; n < 12; ++n) {
        o[mt][n][0] *= c0;
        o[mt][n][1] *= c0;
        o[mt][n][2] *= c1;
        o[mt][n][3] *= c1;
      }
    }
    // O += P V; V's B fragments by ldmatrix.trans, two 8-wide dim tiles a
    // load, each serving both row tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        uint32_t b[4];
        ldsm_x4_trans(smem_u32(svb + (kk * 16 + a_row) * kRow + p * 16 + a_col), b);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(o[mt][2 * p], pf[mt][kk], b[0], b[1]);
          mma_bf16(o[mt][2 * p + 1], pf[mt][kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is the next load's
  }

  const int b = bh / heads, h = bh - b * heads;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r_lo = wrow + mt * 16 + g;  // block rows r_lo and r_lo + 8
    const int g_lo = row0 + r_lo, g_hi = g_lo + 8;
    bf16* out_lo = out + ((size_t)b * nq + g_lo) * heads * kD + h * kD;
    bf16* out_hi = out_lo + (size_t)8 * heads * kD;
    const bf16* q_lo = sq + r_lo * kRow;
    const bf16* q_hi = q_lo + 8 * kRow;
#pragma unroll
    for (int n = 0; n < 12; ++n) {
      const int d = n * 8 + 2 * t4;
      float x0 = o[mt][n][0] * inv0, x1 = o[mt][n][1] * inv0;
      float x2 = o[mt][n][2] * inv1, x3 = o[mt][n][3] * inv1;
      if (g_lo >= 1) {  // residual pooling: every row but the cls token's
        x0 += __bfloat162float(q_lo[d]);
        x1 += __bfloat162float(q_lo[d + 1]);
      }
      x2 += __bfloat162float(q_hi[d]);
      x3 += __bfloat162float(q_hi[d + 1]);
      if (g_lo < nq) *reinterpret_cast<uint32_t*>(out_lo + d) = pack_bf16(x0, x1);
      if (g_hi < nq) *reinterpret_cast<uint32_t*>(out_hi + d) = pack_bf16(x2, x3);
    }
  }
}

}  // namespace

// q [batch_heads, nq, 96], k and v [batch_heads, nk, 96] (nk = 1 + k_t k_h
// k_w), rt/rh/rw [batch_heads, nq - 1, k_t|k_h|k_w], out [batch, nq,
// heads * 96]: contiguous bf16, q, k, v and out 16-byte aligned. scale: the
// logits' scale (head dim ** -0.5).
extern "C" int rva_rel_pos_attention(int device, const void* q, const void* k, const void* v,
                                     const void* rt, const void* rh, const void* rw, void* out,
                                     int batch_heads, int heads, int nq, int nk, int kt, int kh,
                                     int kw, float scale, void* stream) {
  if (batch_heads < 1 || batch_heads > 65535 || heads < 1 || batch_heads % heads != 0 ||
      nq < 1 || kt < 1 || kh < 1 || kw < 1 || kt + kh + kw > kMaxRel ||
      (long long)kt * kh * kw + 1 != nk) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = rva_use_device(device);
  if (err != cudaSuccess) return (int)err;
  static std::atomic<bool> done[kMaxDevices];
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (!tracked || !done[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(rel_pos_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (tracked) done[device].store(true, std::memory_order_release);
  }
  const int smem = smem_bytes((kt + kh + kw + 15) & ~15);
  const dim3 grid((nq + kM - 1) / kM, batch_heads);
  rel_pos_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(rt), static_cast<const bf16*>(rh), static_cast<const bf16*>(rw),
      static_cast<bf16*>(out), heads, nq, nk, kt, kh, kw, scale);
  return (int)cudaGetLastError();
}
