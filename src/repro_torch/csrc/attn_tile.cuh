// One online-softmax attention tile on Hopper's tensor cores, shared by K3
// (paged chunk attention, csrc/paged_chunk.cu) and K7 (flash prefill,
// csrc/flash_attention.cu).  Both kernels are the same arithmetic: a tile
// of Q.K^T, a mask, and P.V, carried through an online softmax.  They
// differ only in how a key row is found (block table or contiguous), in
// the mask (validity row, or causal and window), and in what they write
// (unnormalised partials, or the normalised output).  Those stay in the
// kernels; this header holds the tile body.
//
// The f32 contract on the tensor cores.  Both kernels promise what an f32
// computation gives.  The inputs that carry the work are exactly bf16:
// bf16 pages, int8 pages (integers in [-127, 127] are bf16 values), K7's
// bf16 q, k and v, and K3's q where the model upcast it from bf16.  So
// mma.sync.m16n8k16 on bf16 operands with f32 accumulation computes exact
// products summed in f32: only the order of the sum differs from the plain
// version.  Where an operand is a true f32 value it is split into three
// bf16 terms, x = x0 + x1 + x2, each the bf16 rounding of what the terms
// before it left (split3_pair below: 8 + 8 + 8 significant bits carry f32's
// 24), and each term takes its own mma into the same f32 accumulator:
//   * p in P.V is always split (int8 pages fold their v_scale into p
//     first, so p_j * v_scale_j * v_int8 stays exact);
//   * K3's f32 q is split too; a warp whose second and third terms are all
//     zero (a q upcast from bf16, as served) skips their products;
//   * int8's k_scale multiplies the score after the product: s_j =
//     k_scale_j * (q . k_int8_j).
// Masked keys get a score of -inf, so their p is exactly 0; a row whose
// keys are all masked keeps m = -1e30, l = 0 and acc = 0.
//
// Layout (the m16n8k16 fragments, FlashAttention-2's register scheme).  A
// warp owns 16 query rows.  A 64-key tile of K and of V sits in shared
// memory as bf16 rows of the head dim D (64, 80 or 128; every name below
// that depends on it is a member of Dims<D>), padded by 8 elements (144,
// 176 or 272 bytes, an odd number of 16-byte words), so the eight 16-byte
// rows one ldmatrix phase reads fall on distinct banks.  Scores S (16 x 64) and the
// output accumulator (16 x D) are m16n8 C fragments: a thread holds rows
// lane/4 and lane/4 + 8, columns 8 n + 2 (lane % 4) + {0, 1}.  K's B
// fragments come through ldmatrix, V's through ldmatrix.trans; the C
// fragments of two score tiles are the A fragment of one P.V step, so p
// never touches shared memory.  Q's A fragments come from registers (K7,
// QRegs) or through ldmatrix from the warp's rows in shared memory (K3 at
// d 128, QShared: three terms of D columns hold 12 D / 16 registers a
// thread, 96 at d 128; K3 keeps d 64's 48 and d 80's 60 in registers).
// Per warp and tile: 4 D / 8 mma for Q.K^T per q term, 12 D / 8 for P.V
// (three p terms).

// The f32 instances of K3 and K7 (f32 pages, the f32 model) keep their
// CUDA-core bodies: an f32 K or V would need its own three-term split on
// the other side of every product (nine terms to stay at f32's accuracy),
// and those instances serve only the f32 check fleets.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace attn_tile {

constexpr int kBK = 64;                 // keys per tile
constexpr int kKTiles = kBK / 8;        // n8 tiles of the scores

// the figures that follow the head dim D (64, 80 or 128; at d 80 10
// output tiles, 5 k-steps, rows of 88)
template <int D>
struct Dims {
  static_assert(D % 16 == 0, "whole m16n8k16 k-steps");
  static constexpr int kRow = D + 8;            // bf16 per shared row
  static constexpr int kTileElems = kBK * kRow; // one K or V tile
  static constexpr int kDTiles = D / 8;         // n8 tiles of the output
  static constexpr int kKSteps = D / 16;        // k16 steps of Q.K^T
};
constexpr float kNegInf = -1e30f;       // m of a row with no key
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, left in flight; when !pred the source is not
// read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes, likewise (the int8 pages' scales)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// C 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x = x0 + x1 + x2 for an f32 pair x = (lo, hi): each term the bf16
// rounding of what the terms before it left (the remainders are exact in
// f32), packed as three A-fragment registers, lo in the low half
__device__ __forceinline__ void split3_pair(float lo, float hi,
                                            uint32_t (&out)[3]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    out[t] = pack_bf16(b.x, b.y);
    const float2 f = __bfloat1622float2(b);
    lo = __fsub_rn(lo, f.x);
    hi = __fsub_rn(hi, f.y);
  }
}

// A fragments of a warp's 16 query rows, kTerms bf16 terms of each, in
// registers
template <int D, int kTerms>
struct QRegs {
  uint32_t a[kTerms][D / 16][4];
  __device__ __forceinline__ void frag(int t, int kk, int,
                                       uint32_t (&out)[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = a[t][kk][r];
  }
};

// ... or in shared memory: term t of the warp's 16 rows at base + t *
// 16 * kRow, rows kRow apart (A fragment r of lane l, k-step kk: row
// l/4 + 8 (r & 1), columns 16 kk + 2 (l % 4) + 8 (r >> 1) and + 1)
template <int D>
struct QShared {
  const __nv_bfloat16* base;
  __device__ __forceinline__ void frag(int t, int kk, int lane,
                                       uint32_t (&out)[4]) const {
    ldsm_x4(out, base + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            Dims<D>::kRow +
                     kk * 16 + (lane >> 4) * 8);
  }
  // where lane's A-fragment register r of k-step kk lies in term t
  __device__ __forceinline__ static int offset(int t, int kk, int lane,
                                               int r) {
    return (t * 16 + (lane >> 2) + 8 * (r & 1)) * Dims<D>::kRow + kk * 16 +
           2 * (lane & 3) + 8 * (r >> 1);
  }
};

// the online softmax of a warp's 16 rows: m and l of rows lane/4 and
// lane/4 + 8 (l is this thread's share, summed over its quad at the end)
// and the unnormalised output, as m16n8 C fragments over d
template <int D>
struct RowState {
  static constexpr int kDTiles = Dims<D>::kDTiles;
  float m[2];
  float l[2];
  float acc[kDTiles][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  }

  // the row sums, once every tile is in
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

// column and row (within the warp's 16 / the tile's 64) of C element c of
// n8 tile j
__device__ __forceinline__ int frag_col(int lane, int j, int c) {
  return 8 * j + 2 * (lane & 3) + (c & 1);
}
__device__ __forceinline__ int frag_row(int lane, int c) {
  return (lane >> 2) + 8 * (c >> 1);
}

// One 64-key tile for a warp's 16 rows.
//   q, q_live: the rows' A fragments (QRegs or QShared); the first q_live
//              of kQTerms terms take products
//   sK, sV:    the tile's 64 K and V rows, bf16, Dims<D>::kRow apart
//   score(col, s): the score of key col from the raw product s (scale,
//              int8 k_scale)
//   keep(row, col): whether key col counts for row (read only if kMask)
//   vfold(col): the factor folded into p before P.V (int8 v_scale, or 1)
//   live16:    the tile's first live16 groups of 16 keys may count; keep
//              masks every key past them (a causal diagonal, a ragged
//              end), so their products are skipped
template <int D, int kQTerms, bool kMask, class Q, class Score, class Keep,
          class VFold>
__device__ __forceinline__ void tile_step(RowState<D>& st, const Q& q,
                                          int q_live,
                                          const __nv_bfloat16* sK,
                                          const __nv_bfloat16* sV,
                                          const Score& score, const Keep& keep,
                                          const VFold& vfold, int live16,
                                          int lane) {
  constexpr int kRow = Dims<D>::kRow;
  constexpr int kDTiles = Dims<D>::kDTiles;
  float s[kKTiles][4];
#pragma unroll
  for (int j = 0; j < kKTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;

  // S = Q K^T: per 16-deep step of d, two key tiles per ldmatrix.x4
#pragma unroll
  for (int kk = 0; kk < Dims<D>::kKSteps; ++kk) {
    uint32_t qa[kQTerms][4];
#pragma unroll
    for (int t = 0; t < kQTerms; ++t)
      if (t < q_live) q.frag(t, kk, lane, qa[t]);
#pragma unroll
    for (int np = 0; np < kKTiles / 2; ++np) {
      if (np >= live16) continue;
      uint32_t b[4];
      ldsm_x4(b, sK + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kRow +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int t = 0; t < kQTerms; ++t) {
        if (t < q_live) {
          mma_bf16(s[2 * np], qa[t], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qa[t], b[2], b[3]);
        }
      }
    }
  }

  // scores, mask, the online-softmax update
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = frag_col(lane, j, c);
      float v = score(col, s[j][c]);
      if (kMask && !keep(frag_row(lane, c), col)) v = -CUDART_INF_F;
      s[j][c] = v;
      mx[c >> 1] = fmaxf(mx[c >> 1], v);
    }
  }
  float corr[2], mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(st.m[i], mx[i]);
    corr[i] = exp2f((st.m[i] - m_new) * kLog2e);
    st.m[i] = m_new;
    st.l[i] *= corr[i];
    mb[i] = m_new * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) st.acc[j][c] *= corr[c >> 1];
#pragma unroll
  for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // e^(s - m) as 2^(s log2 e - m log2 e); masked: 2^-inf = 0
      const float p = exp2f(fmaf(s[j][c], kLog2e, -mb[c >> 1]));
      st.l[c >> 1] += p;
      s[j][c] = p * vfold(frag_col(lane, j, c));
    }
  }

  // acc += P V: p in three bf16 terms, each its own product
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if (kk >= live16) continue;   // p is 0 there
    uint32_t a[3][4];
    {
      uint32_t t0[3], t1[3], t2[3], t3[3];
      split3_pair(s[2 * kk][0], s[2 * kk][1], t0);
      split3_pair(s[2 * kk][2], s[2 * kk][3], t1);
      split3_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], t2);
      split3_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], t3);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        a[t][0] = t0[t];
        a[t][1] = t1[t];
        a[t][2] = t2[t];
        a[t][3] = t3[t];
      }
    }
#pragma unroll
    for (int dp = 0; dp < kDTiles / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                kRow +
                           dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        mma_bf16(st.acc[2 * dp], a[t], b[0], b[1]);
        mma_bf16(st.acc[2 * dp + 1], a[t], b[2], b[3]);
      }
    }
  }
}

}  // namespace attn_tile
