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
// enough loads in flight: one thread block per (batch row, KV head)
// running the decode body of decode_math.cuh, shared with K6
// (flash_decode.cu).  The TPU's scalar-prefetched block table becomes
// index loads inside the block: each position looks up
// table[row, pos / bs] itself.  Invalid positions (valid == false:
// unwritten tail, NULL or stale table entries) are never loaded, so a row
// with no valid position returns m = -1e30, l = 0, o = 0.  int8 pages are
// multiplied by their per-(position, head) scale after the load (the same
// Pallas function's other branch).
// No split-KV over blocks, TMA or wgmma yet: the grid is B x KV blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_math.cuh"

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(decode::kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const bool* __restrict__ valid, float* __restrict__ o,
                    float* __restrict__ l_out, float* __restrict__ m_out,
                    int n_kv, int bs, int nb, float scale) {
  const int row = blockIdx.x, kv = blockIdx.y;
  const int n_pos = nb * bs;
  const size_t head = static_cast<size_t>(row) * n_kv + kv;
  const decode::PagedRows rows{tables + static_cast<size_t>(row) * nb, n_kv,
                               kv, bs};
  decode::attend<T, float, D, R, false>(
      q + head * R * D, k_pages, v_pages, k_scale, v_scale,
      valid + static_cast<size_t>(row) * n_pos, n_pos, rows, scale,
      o + head * R * D, l_out + head * R, m_out + head * R);
}

template <typename T, int D, int R>
cudaError_t launch_typed(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* tables,
                         const void* valid, void* o, void* l, void* m, int B,
                         int n_kv, int bs, int nb, float scale,
                         cudaStream_t stream) {
  const dim3 grid(B, n_kv);
  paged_decode_kernel<T, D, R><<<grid, decode::kThreads, 0, stream>>>(
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
