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
// path and the Pallas body do; a no-op for f32 caches).  Plain PyTorch
// version: repro_torch/kernels/flash_decode.py flash_decode_plain.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its K and V once
// (2 x positions x d elements) for ~4 R d flops per position: about R/2
// flops per bf16 byte, far below the card's ridge.  So the design is K2's
// (csrc/paged_decode.cu) without the block table: one thread block per
// (batch row, KV head) running the decode body of decode_math.cuh, which
// K2 runs too, with the row's own contiguous cache for addressing and p
// rounded before P.V.  Invalid positions are never loaded, so a row with
// no valid position returns m = -1e30, l = 0, o = 0 (the jnp guard; the
// Pallas body returns l = S, o = sum V there).
// No split-KV over blocks, TMA or wgmma yet: the grid is B x KV blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_math.cuh"

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(decode::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const bool* __restrict__ valid,
                    float* __restrict__ o, float* __restrict__ l_out,
                    float* __restrict__ m_out, int n_kv, int S, float scale) {
  const int row = blockIdx.x, kv = blockIdx.y;
  const size_t head = static_cast<size_t>(row) * n_kv + kv;
  decode::attend<T, T, D, R, true>(
      q + head * R * D, k, v, nullptr, nullptr,
      valid + static_cast<size_t>(row) * S, S, decode::DenseRows{head * S},
      scale, o + head * R * D, l_out + head * R, m_out + head * R);
}

// The one shape instantiated, and held against the plain version on the
// card: d_head 64 with 3 query rows per KV head (smollm-360m's 15 heads on 5
// KV heads).  Other shapes are refused (ROADMAP A7 brings them).
constexpr int kHeadDim = 64;
constexpr int kRows = 3;

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* valid, void* o, void* l, void* m, int B,
                         int n_kv, int S, float scale, cudaStream_t stream) {
  const dim3 grid(B, n_kv);
  flash_decode_kernel<T, kHeadDim, kRows>
      <<<grid, decode::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const bool*>(valid),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      n_kv, S, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k and v alike).  Returns
// cudaGetLastError() after launch, or cudaErrorInvalidValue for a shape or
// dtype that is not instantiated.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid, void* o,
                                   void* l, void* m, int B, int n_kv, int R,
                                   int D, int S, int dtype_code, float scale,
                                   void* stream) {
  if (D != kHeadDim || R != kRows) return cudaErrorInvalidValue;
  if (B == 0 || n_kv == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0:
      err = launch_typed<float>(q, k, v, valid, o, l, m, B, n_kv, S, scale,
                                st);
      break;
    case 1:
      err = launch_typed<__nv_bfloat16>(q, k, v, valid, o, l, m, B, n_kv, S,
                                        scale, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
