// Dense flash-decode: single-query GQA attention of every batch row against
// its own contiguous KV cache, masked by a validity row (unwritten tails,
// sliding-window rings, parked slots).  Returns the UNNORMALISED
// online-softmax partials (o, l, m) so the caller folds in the current
// token's (k, v) before normalising.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:78 flash_decode
// (body _kernel :44).  Numerics of the JAX jnp path the port served before
// (repro/models/attention.py:854 _decode_partial): q arrives already cast
// to the cache dtype, q, k and v are upcast to f32, every product and sum
// is f32, and p is rounded to the cache dtype before P.V (as both the jnp
// path and the Pallas body do; a no-op for f32 caches), against the
// running max of its warp and split; l sums the unrounded p.  Plain
// PyTorch version: repro_torch/kernels/flash_decode.py flash_decode_plain.
//
// Bound on the H100: bytes.  Each (row, KV head) reads the K and V rows
// of its valid positions once (2 x d elements each) for ~4 R d flops a
// position: about R/2 flops per bf16 byte, far below the card's ridge.
// So the design is K2's (csrc/paged_decode.cu) without the block table:
// the decode body of decode_math.cuh on a grid of (B, KV, n_split) blocks,
// with the row's own contiguous cache for addressing and p rounded before
// P.V.  Past 256 positions a row's live range (a window band or a ragged
// tail included) is shared over n_split blocks (kernels/split.py
// split_count) whose partials the merge of split_merge.cuh folds; up to
// 256 positions (the served fleets' 112, the harvest's) it is one launch
// with no merge.  Each block stages the row's validity flags in shared
// memory in one pass, and each warp issues its next group of K/V rows
// before computing the current one.  Invalid positions are never loaded,
// so a row with no valid position returns m = -1e30, l = 0, o = 0 (the jnp
// guard; the Pallas body returns l = S, o = sum V there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_math.cuh"
#include "split_merge.cuh"

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(decode::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const bool* __restrict__ valid,
                    float* __restrict__ o, float* __restrict__ l_out,
                    float* __restrict__ m_out, int n_kv, int S, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row = blockIdx.x, kv = blockIdx.y;
  const size_t head = static_cast<size_t>(row) * n_kv + kv;
  // this block's plane: the output, or split blockIdx.z of the scratch
  const size_t slot =
      static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y + head;
  decode::attend<T, T, D, R, true>(
      q + head * R * D, k, v, nullptr, nullptr,
      valid + static_cast<size_t>(row) * S, S,
      decode::DenseRows{head * static_cast<size_t>(S)}, scale, smem,
      o + slot * R * D, l_out + slot * R, m_out + slot * R);
}

template <typename T, int D, int R>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* valid, void* o, void* l, void* m,
                         void* o_part, void* l_part, void* m_part, int B,
                         int n_kv, int S, int n_split, float scale,
                         cudaStream_t stream) {
  const int smem = decode::smem_bytes(S, 0);
  static int configured = 48 * 1024;
  cudaError_t err = decode::allow_smem(flash_decode_kernel<T, D, R>, smem,
                                       configured);
  if (err != cudaSuccess) return err;
  const bool split = n_split > 1;
  const dim3 grid(B, n_kv, n_split);
  flash_decode_kernel<T, D, R><<<grid, decode::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const bool*>(valid),
      static_cast<float*>(split ? o_part : o),
      static_cast<float*>(split ? l_part : l),
      static_cast<float*>(split ? m_part : m), n_kv, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return split_merge::launch<D>(o_part, l_part, m_part, o, l, m, B * n_kv * R,
                             n_split, stream);
}

// One (head dim, query rows per KV head) instance of each cache dtype.
template <int D, int R>
cudaError_t launch_instance(int dtype_code, const void* q, const void* k,
                            const void* v, const void* valid, void* o,
                            void* l, void* m, void* o_part, void* l_part,
                            void* m_part, int B, int n_kv, int S,
                            int n_split, float scale, cudaStream_t st) {
  switch (dtype_code) {
    case 0:
      return launch_typed<float, D, R>(q, k, v, valid, o, l, m, o_part,
                                       l_part, m_part, B, n_kv, S, n_split,
                                       scale, st);
    case 1:
      return launch_typed<__nv_bfloat16, D, R>(q, k, v, valid, o, l, m,
                                               o_part, l_part, m_part, B,
                                               n_kv, S, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k and v alike).  n_split > 1
// shares each row's positions over n_split blocks; o_part, l_part and
// m_part are then scratch of n_split times the shape of o, l and m, merged
// into them.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or dtype that is not instantiated.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid, void* o,
                                   void* l, void* m, void* o_part,
                                   void* l_part, void* m_part, int B,
                                   int n_kv, int R, int D, int S,
                                   int n_split, int dtype_code, float scale,
                                   void* stream) {
  if (n_split < 1 ||
      (n_split > 1 &&
       (o_part == nullptr || l_part == nullptr || m_part == nullptr)))
    return cudaErrorInvalidValue;
  if (B == 0 || n_kv == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instance set: kernels/flash_decode.py INSTANCES names the same
  // (D, R) pairs (tests/test_torch_d128.py holds the two lists equal)
#define DECODE_INSTANCE(DD, RR)                                              \
  if (D == DD && R == RR)                                                    \
    return static_cast<int>(launch_instance<DD, RR>(                         \
        dtype_code, q, k, v, valid, o, l, m, o_part, l_part, m_part, B,      \
        n_kv, S, n_split, scale, st));
  DECODE_INSTANCE(64, 3)
  DECODE_INSTANCE(128, 3)
  DECODE_INSTANCE(128, 1)
  DECODE_INSTANCE(80, 1)
  DECODE_INSTANCE(64, 2)
  DECODE_INSTANCE(128, 4)
  DECODE_INSTANCE(128, 7)
  DECODE_INSTANCE(64, 5)
  DECODE_INSTANCE(64, 1)
#undef DECODE_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
