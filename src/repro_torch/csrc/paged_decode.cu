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
// Bound on the H100: bytes.  Each (row, KV head) reads the K and V rows
// of its valid positions once (2 x d elements each, and two scales for
// int8 pages) for ~4 R d flops a position: about R/2 flops per bf16 byte,
// two orders of magnitude under the card's ridge.  So the design is about
// keeping enough page bytes in flight, coalesced, and the chain between
// loads short: the decode body of decode_math.cuh, shared with K6
// (flash_decode.cu), on a grid of (B, KV, n_split) blocks.  Past 256
// virtual positions a row's live range is shared over n_split blocks
// (split-KV, kernels/split.py split_count), each writing its partials to
// the wrapper's scratch, and this launcher then runs the merge of
// split_merge.cuh; up to 256 positions (every served shape) it is one
// launch with no merge.  The TPU's scalar-prefetched block table becomes
// one staging pass per block: the row's table and validity flags come into
// shared memory together, so a page load never waits on a table load, and
// each warp issues its next group of page rows before computing the
// current one.  Invalid positions (valid == false: unwritten tail, holes,
// NULL or stale table entries) are never loaded, so a row with no valid
// position returns m = -1e30, l = 0, o = 0.  int8 pages are converted
// exactly; k_scale multiplies the score and v_scale folds into p (the
// same Pallas function's other branch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_math.cuh"
#include "split_merge.cuh"

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
  extern __shared__ __align__(16) uint8_t smem[];
  const int row = blockIdx.x, kv = blockIdx.y;
  const int n_pos = nb * bs;
  const size_t head = static_cast<size_t>(row) * n_kv + kv;
  // this block's plane: the output, or split blockIdx.z of the scratch
  const size_t slot =
      static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y + head;
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  const decode::PagedRows rows{tables + static_cast<size_t>(row) * nb, nb,
                               n_kv, kv, bs, bs_shift, nullptr};
  decode::attend<T, float, D, R, false>(
      q + head * R * D, k_pages, v_pages, k_scale, v_scale,
      valid + static_cast<size_t>(row) * n_pos, n_pos, rows, scale, smem,
      o + slot * R * D, l_out + slot * R, m_out + slot * R);
}

template <typename T, int D, int R>
cudaError_t launch_typed(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* tables,
                         const void* valid, void* o, void* l, void* m,
                         void* o_part, void* l_part, void* m_part, int B,
                         int n_kv, int bs, int nb, int n_split, float scale,
                         cudaStream_t stream) {
  const int smem = decode::smem_bytes(nb * bs, nb);
  static int configured = 48 * 1024;
  cudaError_t err =
      decode::allow_smem(paged_decode_kernel<T, D, R>, smem, configured);
  if (err != cudaSuccess) return err;
  const bool split = n_split > 1;
  const dim3 grid(B, n_kv, n_split);
  paged_decode_kernel<T, D, R><<<grid, decode::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const bool*>(valid),
      static_cast<float*>(split ? o_part : o),
      static_cast<float*>(split ? l_part : l),
      static_cast<float*>(split ? m_part : m), n_kv, bs, nb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return split_merge::launch<D>(o_part, l_part, m_part, o, l, m, B * n_kv * R,
                             n_split, stream);
}

// One (head dim, query rows per KV head) instance of each page dtype.
template <int D, int R>
cudaError_t launch_instance(int dtype_code, const void* q, const void* kp,
                            const void* vp, const void* ks, const void* vs,
                            const void* tables, const void* valid, void* o,
                            void* l, void* m, void* o_part, void* l_part,
                            void* m_part, int B, int n_kv, int bs, int nb,
                            int n_split, float scale, cudaStream_t stream) {
  switch (dtype_code) {
    case 0:
      return launch_typed<float, D, R>(q, kp, vp, ks, vs, tables, valid, o,
                                       l, m, o_part, l_part, m_part, B, n_kv,
                                       bs, nb, n_split, scale, stream);
    case 1:
      return launch_typed<__nv_bfloat16, D, R>(
          q, kp, vp, ks, vs, tables, valid, o, l, m, o_part, l_part, m_part,
          B, n_kv, bs, nb, n_split, scale, stream);
    case 2:
      return launch_typed<int8_t, D, R>(q, kp, vp, ks, vs, tables, valid, o,
                                        l, m, o_part, l_part, m_part, B,
                                        n_kv, bs, nb, n_split, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32 pages, 1 = bfloat16 pages, 2 = int8 pages
// (k_scale / v_scale non-null).  n_split > 1 shares each row's positions
// over n_split blocks; o_part, l_part and m_part are then scratch of
// n_split times the shape of o, l and m, merged into them.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape that is not instantiated.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* valid, void* o, void* l,
                                   void* m, void* o_part, void* l_part,
                                   void* m_part, int B, int n_kv, int R,
                                   int D, int bs, int nb, int n_split,
                                   int dtype_code, float scale,
                                   void* stream) {
  if (B == 0 || n_kv == 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || (n_split > 1 && (o_part == nullptr ||
                                      l_part == nullptr || m_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instance set: kernels/paged_decode.py INSTANCES names the same
  // (D, R) pairs (tests/test_torch_d128.py holds the two lists equal)
#define DECODE_INSTANCE(DD, RR)                                               \
  if (D == DD && R == RR)                                                     \
    return static_cast<int>(launch_instance<DD, RR>(                          \
        dtype_code, q, k_pages, v_pages, k_scale, v_scale, tables, valid, o,  \
        l, m, o_part, l_part, m_part, B, n_kv, bs, nb, n_split, scale, st));
  DECODE_INSTANCE(64, 3)
  DECODE_INSTANCE(128, 3)
  DECODE_INSTANCE(128, 1)
  DECODE_INSTANCE(80, 1)
  DECODE_INSTANCE(64, 2)
  DECODE_INSTANCE(128, 4)
  DECODE_INSTANCE(128, 7)
#undef DECODE_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
