// Single-query GQA decode of one (batch row, KV head, split), shared by K2
// (paged_decode.cu: positions read through a block table) and K6
// (flash_decode.cu: a contiguous cache).  Both kernels run this one
// function, so they differ only in where a position's K/V row lies and in
// whether p is rounded to the cache dtype before P.V.
//
// What bounds it on the H100: bytes.  R = 3 query rows per KV head give
// about 3 f32 operations per bf16 byte of K and V, far under the CUDA
// cores' ridge of about 20 (67 TFLOP/s over 3.35 TB/s), and the tensor
// cores would not change that.  So the design is about the bytes in
// flight: by Little's law the card needs about 3.35 TB/s x ~0.7 us, some
// 2.3 MB, in flight to run at its byte rate.  The grid is
// (B, KV, n_split) blocks of kWarps warps:
//   * split-KV: past 256 virtual positions a row is shared over n_split
//     blocks (kernels/split.py split_count: one per 256 positions, at most
//     8, which chip_smoke.py's k2-splits and k6-splits rows measure
//     against 4, 12 and 16; 320 blocks at B 8, 4096 positions).  Each
//     block finds the row's live range [first valid, last valid] and
//     takes its equal share of it (split.py split_ranges is the same
//     cut), not of the virtual row, so a ragged row's valid positions
//     spread over all its blocks and no block walks an invalid tail.  A
//     share with no position writes the empty partials (m = -1e30, l = 0,
//     o = 0); the launcher then runs the merge of split_merge.cuh.  Up to
//     256 positions n_split is 1: one launch, the block writes the output
//     itself, no merge;
//   * indices once: the block copies the row's validity flags (and K2
//     its block-table row) into shared memory in one coalesced pass, the
//     same pass that finds the live range.  A K/V load then waits on no
//     global index load;
//   * loads in flight: a position takes kLanes lanes, the most (a power
//     of two) that leave each lane 16 dims or more: 4 lanes of 16 dims at
//     d 64, 8 of 16 at d 128, 4 of 20 at d 80 (5 lanes of 16 would not
//     divide a warp); a warp holds 32 / kLanes positions a load (8, 4 or
//     8) and takes its positions in groups of U such loads (U = 4 /
//     sizeof(T): at d 64 and d 80 8 f32, 16 bf16 or 32 int8 positions,
//     half as many at d 128).  Each lane loads its dims in the widest
//     words that tile them: 16-byte words at d 64 and d 128 (a group is
//     128 bytes of K and V a lane, 4 KB a warp); at d 80 five words a
//     lane, of 16 bytes (f32), 8 (bf16) or 4 (int8), aligned at the rows'
//     320, 160 and 80-byte strides (80 bytes of K and V a lane a group).
//     Rows stay coalesced, and a lane's registers (R x 16 or R x 20 of q
//     and of the output) do not grow with d.  The next group's loads are
//     issued into registers before the current group is computed (a
//     register double buffer), so a group stays in flight while the warp
//     computes.  (A cp.async ring
//     in shared memory, tried first, held fewer registers but was not
//     faster for bf16 and f32 pages, whatever its depth.);
//   * one softmax correction per group and row: the warp takes the max of
//     the group's scores once (2 or 3 shuffles), then one exp2f per score,
//     and rescales its sums only when the running max moved (rarely, once
//     a few groups are in);
//   * invalid positions are never loaded (zeros) and weigh exactly zero,
//     so a row with no valid position returns m = -1e30, l = 0, o = 0;
//   * bf16 rows are upcast to f32 exactly; int8 rows are converted
//     exactly and their per-(position, head) scales multiply the score
//     (k) and fold into p (v); all arithmetic is f32;
//   * at the end the warps merge through shared memory, and the block
//     writes the UNNORMALISED partials (o, l, m) of its share.
// Instances (D, R): (64, 3), (128, 3), (128, 1) and (80, 1) (its
// registers and spills: build.log and PERF.md).  ptxas (build.log,
// sm_90a), no spill in any: at R 3 K2 219 registers (bf16), 255 (int8),
// 186 to 190 (f32), K6 218 to 220 (bf16), 186 to 190 (f32), at d 64 and
// d 128 alike; at R 1 K2 128, 162, 118 and K6 126, 105.  Static shared
// memory 16 R D + 32 R + 32 bytes (3,200 at (64, 3), 6,272 at (128, 3)),
// plus round16(n_pos) bytes of flags and K2's 4 nb bytes of table.  At R 3
// the registers hold an SM to two 4-warp blocks (8 warps); with one group
// in flight a warp, that keeps some 4 MB in flight on the card, above
// Little's 2.3 MB.  What is left at 4,096
// positions is fixed per call: the launch, the merge's launch, and each
// block's flag load before its first page load (PERF.md, PR 21).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a block's shared memory on the H100, dynamic and static together
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// A block's dynamic shared memory: the row's validity flags, then K2's
// block-table row.
__host__ __device__ constexpr int smem_bytes(int n_pos, int table_entries) {
  return round16(n_pos) + 4 * table_entries;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p rounded to the cache dtype, as the jnp path's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// one 32-bit piece of a row -> its elements in f32, exactly
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int kElems = 1;
  __device__ __forceinline__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kElems = 2;
  __device__ __forceinline__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);           // the low half first
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <>
struct Piece<int8_t> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void unpack(uint32_t w, float* out) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[b] = static_cast<float>(static_cast<int8_t>((w >> (8 * b)) & 0xffu));
  }
};

// the load type of a word of 16, 8 or 4 bytes, and its 32-bit pieces
template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
  __device__ __forceinline__ static void pieces(const uint4& u, uint32_t* w) {
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
};
template <>
struct Raw<8> {
  using type = uint2;
  __device__ __forceinline__ static void pieces(const uint2& u, uint32_t* w) {
    w[0] = u.x;
    w[1] = u.y;
  }
};
template <>
struct Raw<4> {
  using type = uint32_t;
  __device__ __forceinline__ static void pieces(uint32_t u, uint32_t* w) {
    w[0] = u;
  }
};

// one kBytes word of a row -> its elements in f32, exactly
template <typename T, int kBytes>
struct Word {
  using raw = typename Raw<kBytes>::type;
  static constexpr int kElems = kBytes / static_cast<int>(sizeof(T));
  __device__ __forceinline__ static void unpack(const raw& u, float* out) {
    uint32_t w[kBytes / 4];
    Raw<kBytes>::pieces(u, w);
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      Piece<T>::unpack(w[i], out + i * Piece<T>::kElems);
  }
};

// Lanes a position: the most, a power of two, that leave each lane 16
// dims or more (4 at d 64 and d 80, 8 at d 128).
__host__ __device__ constexpr int lanes_per_position(int d) {
  int n = 1;
  while (2 * n <= 32 && d % (2 * n) == 0 && d / (2 * n) >= 16) n *= 2;
  return n;
}

// The widest word (16, 8 or 4 bytes) that tiles a lane's `bytes`.
__host__ __device__ constexpr int word_bytes(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 4;
}

// The row of position p, in units of D elements of the K/V buffers (and
// of their scales): through the batch row's block table, staged in shared
// memory, into a page pool (P, KV, bs, D) ...
struct PagedRows {
  const int* __restrict__ table_row;  // the row's nb entries, global
  int nb, n_kv, kv, bs;
  int bs_shift;                       // log2(bs), or -1: bs no power of 2
  int* s_table;                       // their copy in shared memory
  __device__ __forceinline__ void stage(int tid, int* dst) {
    s_table = dst;
    for (int i = tid; i < nb; i += kThreads) s_table[i] = __ldg(table_row + i);
  }
  __device__ __forceinline__ size_t operator()(int p) const {
    const int blk = bs_shift >= 0 ? p >> bs_shift : p / bs;
    const int off = bs_shift >= 0 ? p & (bs - 1) : p % bs;
    return (static_cast<size_t>(s_table[blk]) * n_kv + kv) * bs + off;
  }
};

// ... or in the (batch row, KV head)'s own contiguous (S, D) cache.
struct DenseRows {
  size_t first;  // (row * KV + kv) * S
  __device__ __forceinline__ void stage(int, int*) {}
  __device__ __forceinline__ size_t operator()(int p) const {
    return first + static_cast<size_t>(p);
  }
};

// One block's decode of its share of a row: q the R query rows (R x D,
// contiguous), valid_row the n_pos validity flags, rows the addressing
// above; k_scale / v_scale are null unless T is int8.  The block is split
// blockIdx.z of gridDim.z.  With kRoundP, p is rounded to T before P.V
// against the running max of its warp and split (l sums the unrounded p).
// smem is the block's dynamic shared memory (smem_bytes).  Writes
// o (R x D), l (R) and m (R): the output, or with n_split > 1 this
// split's plane of the scratch.
template <typename T, typename QT, int D, int R, bool kRoundP, typename Rows>
__device__ __forceinline__ void attend(
    const QT* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const bool* __restrict__ valid_row,
    int n_pos, Rows rows, float scale, uint8_t* smem,
    float* __restrict__ o, float* __restrict__ l_out,
    float* __restrict__ m_out) {
  constexpr int kLanes = lanes_per_position(D);   // 4, 8 or 4 (d 80)
  constexpr int kRowsW = 32 / kLanes;          // positions a warp a load
  constexpr int kDpl = D / kLanes;             // dims per lane: 16 or 20
  static_assert(kLanes * kRowsW == 32 && kDpl * kLanes == D,
                "a warp holds whole positions");
  constexpr int kSliceBytes = kDpl * static_cast<int>(sizeof(T));
  constexpr int kWordBytes = word_bytes(kSliceBytes);
  using W = Word<T, kWordBytes>;
  using Raw_t = typename W::raw;
  constexpr int kVec = kSliceBytes / kWordBytes;   // words a lane a row
  static_assert(kVec * kWordBytes == kSliceBytes && (D * sizeof(T)) % 16 == 0,
                "a lane's slice of a row must be whole, aligned words");
  static_assert(W::kElems * kVec == kDpl, "word size");
  constexpr int U = 4 / static_cast<int>(sizeof(T));   // positions a lane
  constexpr int kGroup = kRowsW * U;            // positions a warp a group
  constexpr bool kScaled = sizeof(T) == 1;
  constexpr int kPerWord = W::kElems;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane / kLanes, qi = lane % kLanes;

  // ---- the row's flags (and K2's table) into shared memory, and its live
  // range, in one pass
  uint8_t* s_valid = smem;
  __shared__ int s_first[kWarps], s_last[kWarps];
  int first = INT_MAX, last = -1;
  const uint8_t* vrow = reinterpret_cast<const uint8_t*>(valid_row);
  if (n_pos % 16 == 0 && reinterpret_cast<uintptr_t>(vrow) % 16 == 0) {
    for (int c = tid; c < n_pos / 16; c += kThreads) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(vrow) + c);
      reinterpret_cast<uint4*>(s_valid)[c] = u;
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (w[i] == 0) continue;
        first = min(first, 16 * c + 4 * i + (__ffs(w[i]) - 1) / 8);
        last = max(last, 16 * c + 4 * i + (31 - __clz(w[i])) / 8);
      }
    }
  } else {
    for (int p = tid; p < n_pos; p += kThreads) {
      const uint8_t f = vrow[p] != 0;
      s_valid[p] = f;
      if (f) {
        first = min(first, p);
        last = max(last, p);
      }
    }
  }
  rows.stage(tid, reinterpret_cast<int*>(s_valid + round16(n_pos)));

  // the query rows in registers, in f32, pre-scaled by 1/sqrt(d) and by
  // log2(e): scores, m and the softmax run in base 2 (exp2f), and m is
  // brought back to base e when it is written
  float qr[R][kDpl];
  const float qscale = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const QT* qrow = q + r * D + qi * kDpl;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) qr[r][j] = to_float(qrow[j]) * qscale;
  }

  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) {
    s_first[warp] = first;
    s_last[warp] = last;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first = min(first, s_first[w]);
    last = max(last, s_last[w]);
  }
  // this block's share of the live range (split.py split_ranges)
  int lo = 0, hi = 0;
  if (last >= first) {
    const int n_split = gridDim.z;
    const int per = (last - first + n_split) / n_split;
    lo = first + static_cast<int>(blockIdx.z) * per;
    hi = min(lo + per, last + 1);
  }
  const int n_groups = hi > lo ? (hi - lo + kGroup - 1) / kGroup : 0;

  // ---- the warp's groups g = warp, warp + kWarps, ...: the lane's kDpl
  // dims of the group's K and V rows (and int8 scales) land in registers,
  // loaded one group ahead of the one it computes
  struct Slot {
    Raw_t k[U][kVec], v[U][kVec];
    float ks[U], vs[U];
  };
  auto issue = [&](int g, Slot& s) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = lo + g * kGroup + kRowsW * u + quad;
      const bool ok = p < hi && s_valid[p] != 0;
      // an invalid position reads nothing and stays zeros
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        s.k[u][c] = s.v[u][c] = Raw_t{};
      s.ks[u] = s.vs[u] = 0.f;
      if (ok) {
        const size_t row = rows(p);
        const Raw_t* kp =
            reinterpret_cast<const Raw_t*>(k + row * D + qi * kDpl);
        const Raw_t* vp =
            reinterpret_cast<const Raw_t*>(v + row * D + qi * kDpl);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          s.k[u][c] = __ldg(kp + c);
          s.v[u][c] = __ldg(vp + c);
        }
        if constexpr (kScaled) {
          s.ks[u] = __ldg(k_scale + row);
          s.vs[u] = __ldg(v_scale + row);
        }
      }
    }
  };

  float m_run[R], l_run[R], acc[R][kDpl];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[r][j] = 0.f;
  }

  auto consume = [&](int g, const Slot& s) {
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = lo + g * kGroup + kRowsW * u + quad;
      ok[u] = p < hi && s_valid[p] != 0;
    }
    // scores: each lane's kDpl-dim slice, summed over the position's lanes
    float sc[R][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[kDpl];
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        W::unpack(s.k[u][c], kf + c * kPerWord);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < kDpl; ++j) d = fmaf(qr[r][j], kf[j], d);
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if constexpr (kScaled) d *= s.ks[u];
        sc[r][u] = ok[u] ? d : kNegInf;
      }
    }
    // one max, one correction per row over the group's kRowsW U positions
    float pv[R][U];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float gm = sc[r][0];
#pragma unroll
      for (int u = 1; u < U; ++u) gm = fmaxf(gm, sc[r][u]);
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, off));
      // the running max moves rarely once a few groups are in: the
      // correction (warp-uniform) is skipped while it stays
      const float m_new = fmaxf(m_run[r], gm);
      const bool moved = m_new != m_run[r];
      const float corr = moved ? exp2f(m_run[r] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? exp2f(sc[r][u] - m_new) : 0.f;
        psum += p;
        float w = p;
        if constexpr (kRoundP) w = round_as<T>(p);
        if constexpr (kScaled) w *= s.vs[u];
        pv[r][u] = w;
      }
      l_run[r] = fmaf(l_run[r], corr, psum);
      if (moved) {
#pragma unroll
        for (int j = 0; j < kDpl; ++j) acc[r][j] *= corr;
        m_run[r] = m_new;
      }
    }
    // P.V: each lane's kDpl dims of the position's V row
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[kDpl];
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        W::unpack(s.v[u][c], vf + c * kPerWord);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < kDpl; ++j)
          acc[r][j] = fmaf(pv[r][u], vf[j], acc[r][j]);
    }
  };

  if (warp < n_groups) {
    Slot cur;
    issue(warp, cur);
    for (int g = warp; g < n_groups; g += kWarps) {
      Slot nxt;
      issue(g + kWarps, nxt);   // past the share: no load, zeros
      consume(g, cur);
      cur = nxt;
    }
  }

  // sum each position's partial l and acc over the warp's kRowsW
  // positions (m is warp-uniform), then merge the warps through shared
  // memory
  __shared__ float s_m[kWarps][R], s_l[kWarps][R], s_acc[kWarps][R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float l = l_run[r];
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      float a = acc[r][j];
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[r][j] = a;
    }
    if (lane < kLanes) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j) s_acc[warp][r][qi * kDpl + j] = acc[r][j];
    }
    if (lane == 0) {
      s_m[warp][r] = m_run[r];
      s_l[warp][r] = l;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    float m_tot = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, s_m[w][r]);
    float l_tot = 0.f, o_tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = exp2f(s_m[w][r] - m_tot);
      l_tot = fmaf(s_l[w][r], wgt, l_tot);
      o_tot = fmaf(s_acc[w][r][dd], wgt, o_tot);
    }
    o[r * D + dd] = o_tot;
    if (dd == 0) {
      l_out[r] = l_tot;
      m_out[r] = m_tot == kNegInf ? kNegInf : m_tot * kLn2;
    }
  }
}

// Dynamic shared memory for a kernel instance: set the attribute once past
// the default 48 KB; refuse what a block cannot hold.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& configured) {
  if (bytes > kMaxSmem - 8 * 1024) return cudaErrorInvalidValue;
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

}  // namespace decode
