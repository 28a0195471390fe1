// Paged flash-decode: single-query GQA attention of every batch row
// against a shared pool of KV pages, read through the row's block table.
// Returns the UNNORMALISED online-softmax partials (o, l, m) so the caller
// folds in the current token's (k, v) before normalising.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:231
// paged_flash_decode (launcher _paged_attend :164, body _paged_kernel
// :113).  Plain PyTorch version: repro_torch/kernels/paged_decode.py
// paged_attend_plain.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its K and V pages
// once (2 x positions x d elements) for ~4 R d flops per position: about
// R/2 flops per bf16 byte, two orders of magnitude below the card's ridge.
// So the design is about moving each page byte once, coalesced, with
// enough loads in flight:
//   * one thread block per (batch row, KV head); its R query rows (the G
//     heads sharing the KV head; G x C rows for a prefill chunk later) are
//     held in registers in f32, pre-scaled by 1/sqrt(d);
//   * the TPU's scalar-prefetched block table becomes index loads inside
//     the block: each position looks up table[row, pos / bs] itself;
//   * 8 warps split the virtual positions in groups of 8; inside a warp 4
//     lanes share one position, each loading d/4 contiguous elements with
//     16-byte loads, so a warp reads 8 whole K rows (and 8 V rows) per
//     group, coalesced;
//   * bf16 pages are upcast to f32 after the load; int8 pages are
//     multiplied by their per-(position, head) scale after the load (the
//     same Pallas function's other branch); all arithmetic is f32;
//   * invalid positions (valid == false: unwritten tail, NULL or stale
//     table entries) are never loaded and contribute exactly zero, so a
//     row with no valid position returns m = -1e30, l = 0, o = 0;
//   * each warp keeps a running online softmax (m, l, acc) for its own
//     positions; warps merge through shared memory at the end.
// No split-KV over blocks, TMA or wgmma yet: the grid is B x KV blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const bool* __restrict__ valid, float* __restrict__ o,
                    float* __restrict__ l_out, float* __restrict__ m_out,
                    int n_kv, int bs, int nb, float scale) {
  constexpr int kDpl = D / 4;  // dims per lane: 4 lanes share a position
  const int row = blockIdx.x, kv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qi = lane % 4;
  const int n_pos = nb * bs;
  const size_t head = static_cast<size_t>(row) * n_kv + kv;

  float qr[R][kDpl];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* qrow = q + (head * R + r) * D + qi * kDpl;
#pragma unroll
    for (int k = 0; k < kDpl; ++k) qr[r][k] = qrow[k] * scale;
  }
  float m_run[R], l_run[R], acc[R][kDpl];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kDpl; ++k) acc[r][k] = 0.f;
  }

  const bool* valid_row = valid + static_cast<size_t>(row) * n_pos;
  const int* table_row = tables + static_cast<size_t>(row) * nb;
  for (int base = warp * 8; base < n_pos; base += kWarps * 8) {
    const int p = base + quad;
    const bool ok = p < n_pos && valid_row[p];
    float kf[kDpl], vf[kDpl];
#pragma unroll
    for (int k = 0; k < kDpl; ++k) kf[k] = vf[k] = 0.f;
    if (ok) {
      const int page = table_row[p / bs];
      const size_t pos_row =
          (static_cast<size_t>(page) * n_kv + kv) * bs + (p % bs);
      load_row<T, kDpl>(k_pages + pos_row * D + qi * kDpl, kf);
      load_row<T, kDpl>(v_pages + pos_row * D + qi * kDpl, vf);
      if (k_scale != nullptr) {
        const float ks = k_scale[pos_row], vs = v_scale[pos_row];
#pragma unroll
        for (int k = 0; k < kDpl; ++k) {
          kf[k] *= ks;
          vf[k] *= vs;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sc = 0.f;
#pragma unroll
      for (int k = 0; k < kDpl; ++k) sc = fmaf(qr[r][k], kf[k], sc);
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
      l_run[r] = l_run[r] * corr + pr;
#pragma unroll
      for (int k = 0; k < kDpl; ++k) acc[r][k] = fmaf(acc[r][k], corr, pr * vf[k]);
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
    for (int k = 0; k < kDpl; ++k) {
      float a = acc[r][k];
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[r][k] = a;
    }
    if (lane < 4) {
#pragma unroll
      for (int k = 0; k < kDpl; ++k) s_acc[warp][r][qi * kDpl + k] = acc[r][k];
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
    o[(head * R + r) * D + dd] = o_tot;
    if (dd == 0) {
      l_out[head * R + r] = l_tot;
      m_out[head * R + r] = m_tot;
    }
  }
}

template <typename T, int D, int R>
cudaError_t launch_typed(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* tables,
                         const void* valid, void* o, void* l, void* m, int B,
                         int n_kv, int bs, int nb, float scale,
                         cudaStream_t stream) {
  const dim3 grid(B, n_kv);
  paged_decode_kernel<T, D, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const bool*>(valid), static_cast<float*>(o),
      static_cast<float*>(l), static_cast<float*>(m), n_kv, bs, nb, scale);
  return cudaGetLastError();
}

// The one shape instantiated, and held against the plain version on the
// card: d_head 64 with 3 query rows per KV head (smollm-360m's 15 heads on 5
// KV heads).  Other shapes are refused until a slice that needs them checks
// them there.
constexpr int kHeadDim = 64;
constexpr int kRows = 3;

template <typename T>
cudaError_t launch_checked(int D, int R, const void* q, const void* kp,
                           const void* vp, const void* ks, const void* vs,
                           const void* tables, const void* valid, void* o,
                           void* l, void* m, int B, int n_kv, int bs, int nb,
                           float scale, cudaStream_t stream) {
  if (D != kHeadDim || R != kRows) return cudaErrorInvalidValue;
  return launch_typed<T, kHeadDim, kRows>(q, kp, vp, ks, vs, tables, valid, o,
                                          l, m, B, n_kv, bs, nb, scale,
                                          stream);
}

}  // namespace

// dtype codes: 0 = float32 pages, 1 = bfloat16 pages, 2 = int8 pages
// (k_scale / v_scale non-null).  Returns cudaGetLastError() after launch,
// or cudaErrorInvalidValue for a shape that is not instantiated.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* valid, void* o, void* l,
                                   void* m, int B, int n_kv, int R, int D,
                                   int bs, int nb, int dtype_code,
                                   float scale, void* stream) {
  if (B == 0 || n_kv == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0:
      err = launch_checked<float>(D, R, q, k_pages, v_pages, k_scale,
                                  v_scale, tables, valid, o, l, m, B, n_kv,
                                  bs, nb, scale, st);
      break;
    case 1:
      err = launch_checked<__nv_bfloat16>(D, R, q, k_pages, v_pages,
                                          k_scale, v_scale, tables, valid, o,
                                          l, m, B, n_kv, bs, nb, scale, st);
      break;
    case 2:
      err = launch_checked<int8_t>(D, R, q, k_pages, v_pages, k_scale,
                                   v_scale, tables, valid, o, l, m, B, n_kv,
                                   bs, nb, scale, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
