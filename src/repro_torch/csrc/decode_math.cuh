// Single-query GQA decode of one (batch row, KV head), shared by K2
// (paged_decode.cu: positions read through a block table) and K6
// (flash_decode.cu: a contiguous cache).  Both kernels run this one
// function, so they differ only in where a position's K/V row lies and in
// whether p is rounded to the cache dtype before P.V.
//
// The block, kThreads threads working on one (row, KV head):
//   * its R query rows (the G heads sharing the KV head) sit in registers
//     in f32, pre-scaled by 1/sqrt(d);
//   * 8 warps split the positions in groups of 8; inside a warp 4 lanes
//     share one position, each loading d/4 contiguous elements with 16-
//     (or 8-) byte loads, so a warp reads 8 whole K rows (and 8 V rows) per
//     group, coalesced;
//   * bf16 rows are upcast to f32 after the load; int8 rows are multiplied
//     by their per-(position, head) scale after the load; all arithmetic
//     is f32;
//   * invalid positions are never loaded and contribute exactly zero, so a
//     row with no valid position returns m = -1e30, l = 0, o = 0;
//   * each warp keeps a running online softmax (m, l, acc) over its own
//     positions; warps merge through shared memory at the end, and the
//     block writes the UNNORMALISED partials (o, l, m).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

// N contiguous elements of type T -> f32 registers, in 16- or 8-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kPer; ++k) out[c * kPer + k] = to_float(e[k]);
    }
  } else {
    static_assert(kBytes % 8 == 0, "row slice must be a multiple of 8 bytes");
    constexpr int kPer = 8 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < kBytes / 8; ++c) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kPer; ++k) out[c * kPer + k] = to_float(e[k]);
    }
  }
}

// The row of position p, in units of D elements of the K/V buffers (and
// of their scales): through the batch row's block table into a page pool
// (P, KV, bs, D) ...
struct PagedRows {
  const int* __restrict__ table_row;
  int n_kv, kv, bs;
  __device__ __forceinline__ size_t operator()(int p) const {
    const int page = table_row[p / bs];
    return (static_cast<size_t>(page) * n_kv + kv) * bs + (p % bs);
  }
};

// ... or in the (batch row, KV head)'s own contiguous (S, D) cache.
struct DenseRows {
  size_t first;  // (row * KV + kv) * S
  __device__ __forceinline__ size_t operator()(int p) const {
    return first + static_cast<size_t>(p);
  }
};

// One block's decode: q the R query rows (R x D, contiguous), valid_row the
// n_pos validity flags, rows the addressing above; k_scale / v_scale are
// null unless T is int8.  With kRoundP, p is rounded to T before P.V (l
// sums the unrounded p).  Writes o (R x D), l (R) and m (R).
template <typename T, typename QT, int D, int R, bool kRoundP, typename Rows>
__device__ __forceinline__ void attend(
    const QT* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const bool* __restrict__ valid_row,
    int n_pos, Rows rows, float scale, float* __restrict__ o,
    float* __restrict__ l_out, float* __restrict__ m_out) {
  constexpr int kDpl = D / 4;  // dims per lane: 4 lanes share a position
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;

  float qr[R][kDpl];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const QT* qrow = q + r * D + qi * kDpl;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) qr[r][j] = to_float(qrow[j]) * scale;
  }
  float m_run[R], l_run[R], acc[R][kDpl];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[r][j] = 0.f;
  }

  for (int base = warp * 8; base < n_pos; base += kWarps * 8) {
    const int p = base + quad;
    const bool ok = p < n_pos && valid_row[p];
    float kf[kDpl], vf[kDpl];
#pragma unroll
    for (int j = 0; j < kDpl; ++j) kf[j] = vf[j] = 0.f;
    if (ok) {
      const size_t pos_row = rows(p);
      load_row<T, kDpl>(k + pos_row * D + qi * kDpl, kf);
      load_row<T, kDpl>(v + pos_row * D + qi * kDpl, vf);
      if (k_scale != nullptr) {
        const float ks = k_scale[pos_row], vs = v_scale[pos_row];
#pragma unroll
        for (int j = 0; j < kDpl; ++j) {
          kf[j] *= ks;
          vf[j] *= vs;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sc = 0.f;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) sc = fmaf(qr[r][j], kf[j], sc);
      sc += __shfl_xor_sync(0xffffffffu, sc, 1);
      sc += __shfl_xor_sync(0xffffffffu, sc, 2);
      if (!ok) sc = kNegInf;
      float gm = sc;
      gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 4));
      gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 8));
      gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 16));
      const float m_new = fmaxf(m_run[r], gm);
      const float corr = expf(m_run[r] - m_new);
      const float pr = ok ? expf(sc - m_new) : 0.f;
      float pv = pr;
      if constexpr (kRoundP) pv = round_as<T>(pr);
      l_run[r] = l_run[r] * corr + pr;
#pragma unroll
      for (int j = 0; j < kDpl; ++j)
        acc[r][j] = fmaf(acc[r][j], corr, pv * vf[j]);
      m_run[r] = m_new;
    }
  }

  // sum each quad's partial l and acc over the warp's 8 quads (m is
  // warp-uniform), then merge the warps through shared memory
  __shared__ float s_m[kWarps][R], s_l[kWarps][R], s_acc[kWarps][R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 8);
    l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      float a = acc[r][j];
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[r][j] = a;
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j) s_acc[warp][r][qi * kDpl + j] = acc[r][j];
    }
    if (lane == 0) {
      s_m[warp][r] = m_run[r];
      s_l[warp][r] = l;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, dd = idx % D;
    float m_tot = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, s_m[w][r]);
    float l_tot = 0.f, o_tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = expf(s_m[w][r] - m_tot);
      l_tot = fmaf(s_l[w][r], wgt, l_tot);
      o_tot = fmaf(s_acc[w][r][dd], wgt, o_tot);
    }
    o[r * D + dd] = o_tot;
    if (dd == 0) {
      l_out[r] = l_tot;
      m_out[r] = m_tot;
    }
  }
}

}  // namespace decode
