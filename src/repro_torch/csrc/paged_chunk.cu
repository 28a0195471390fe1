// Paged chunk attention: the query tokens of a prefill chunk, each against
// the KV pages of its own segment (request), read through that segment's
// block table.  Returns the UNNORMALISED online-softmax partials (o, l, m)
// per token, so the caller folds in the chunk's own keys (causal within a
// segment) before normalising.
//
// Replaces two TPU kernels with one launcher:
//   * repro/kernels/decode_attention.py:298 paged_flash_packed_chunk — N
//     tokens, a segment id per token, per-segment tables and validity rows;
//   * repro/kernels/decode_attention.py:265 paged_flash_prefill_chunk — B
//     requests of C tokens each: the same with N = B*C, segment = token / C
//     (``seg`` null, ``seg_div`` = C), tables and validity per request.
// Both Pallas functions run _paged_kernel (:113) through _paged_attend
// (:164).  Plain PyTorch versions: repro_torch/kernels/paged_chunk.py
// paged_packed_chunk_plain and paged_prefill_chunk_plain.
//
// Bound on the H100: f32 operations at the served shapes, with bytes
// close behind.  A segment's pages are needed once for all of its tokens
// (2 x positions x d elements), and each position costs ~4 d f32 flops per
// query row; the f32 contract keeps the products off the tensor cores, so
// with G x C = 192 rows per KV head a 64-token chunk does ~200 f32 flops
// per bf16 byte of pages, against the card's f32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 (the f32 q and partials bring the bytes close).  The
// design reads each page once per (segment, KV head, tile of 16 tokens),
// and computes only what it keeps: the Pallas version sends the whole
// chunk's q-block to every segment (decode_attention.py:340) and keeps one
// segment's partials per token, R times the work.
//   * one thread block per (tile of 16 query tokens, KV head, segment); a
//     block whose tile holds no token of its segment exits at once, so
//     every output row is written exactly once, by its own segment's block;
//   * a token's segment id is clamped into [0, R), as the JAX gather
//     clamps; padding tokens carry the last segment's id and so get its
//     partials, as in JAX;
//   * the tile's G x 16 query rows (the G heads sharing the KV head) sit in
//     shared memory in f32, pre-scaled by 1/sqrt(d);
//   * the segment's virtual positions are walked in tiles of 16: each
//     position looks up its page in the segment's table row, and the 256
//     threads stage K and V of the 16 positions in shared memory in f32
//     (bf16 upcast, int8 times its per-(position, head) scale) — 16 threads
//     per position, 4 contiguous elements each;
//   * a key tile with no valid position is skipped; invalid positions are
//     never loaded and count exactly zero, so a token whose segment has no
//     valid position returns m = -1e30, l = 0, o = 0;
//   * one half-warp per query token: for scores, lane j takes key j of the
//     tile (a full d-long dot product against shared memory); for the
//     output, lane j owns dims [4j, 4j + 4) of each of the token's G rows;
//     the online softmax (m, l, acc) of each row is carried in registers in
//     f32, the Pallas kernel's contract (_paged_kernel :140-155).
// What bounds this design in practice is latency, not either roofline: a
// block walks its key tiles one after another, and each tile waits on
// dependent global loads (validity, table entry, page) and two barriers
// (on an H100 about 0.044 ms at the served shape, a hundred times the
// bound; chip_smoke.py phase k3).  Wider key tiles, loads kept in flight
// across tiles, split-KV over blocks, TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTokens = 16;               // query tokens per block
constexpr int kThreads = kTokens * 16;    // one half-warp per token
constexpr int kKeys = 16;                 // key positions per shared tile
constexpr float kNegInf = -1e30f;

// 4 contiguous elements of type T -> f32
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&out)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = u.x;
  out[1] = u.y;
  out[2] = u.z;
  out[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p,
                                      float (&out)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = __bfloat162float(e[k]);
}
__device__ __forceinline__ void load4(const int8_t* __restrict__ p,
                                      float (&out)[4]) {
  const char4 u = __ldg(reinterpret_cast<const char4*>(p));
  out[0] = static_cast<float>(u.x);
  out[1] = static_cast<float>(u.y);
  out[2] = static_cast<float>(u.z);
  out[3] = static_cast<float>(u.w);
}

__device__ __forceinline__ int segment_of(const int* __restrict__ seg,
                                          int seg_div, int n, int n_seg) {
  const int s = seg != nullptr ? seg[n] : n / seg_div;
  return min(max(s, 0), n_seg - 1);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const float* __restrict__ q, const int* __restrict__ seg,
                   int seg_div, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const bool* __restrict__ valid, float* __restrict__ o,
                   float* __restrict__ l_out, float* __restrict__ m_out,
                   int n_tok, int n_seg, int n_kv, int bs, int nb,
                   float scale) {
  static_assert(D == 16 * 4, "a half-warp's 16 lanes own 4 dims each");
  constexpr int kQStride = D + 1;   // padded: the two half-warps of a warp
  constexpr int kKStride = D + 1;   // read other banks; lanes read K rows
  __shared__ float sQ[kTokens * G * kQStride];
  __shared__ float sK[kKeys * kKStride];
  __shared__ __align__(16) float sV[kKeys * D];
  __shared__ bool s_act[kTokens];
  __shared__ bool s_ok[kKeys];

  const int tile = blockIdx.x, kv = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;
  const int hw = tid / 16, lane = tid % 16;
  const int n_heads = n_kv * G;

  // the tile's tokens that belong to segment r
  bool mine = false;
  if (tid < kTokens) {
    const int n = tile * kTokens + tid;
    mine = n < n_tok && segment_of(seg, seg_div, n, n_seg) == r;
    s_act[tid] = mine;
  }
  if (!__syncthreads_or(mine)) return;

  for (int idx = tid; idx < kTokens * G * D; idx += kThreads) {
    const int i = idx / (G * D), g = (idx / D) % G, k = idx % D;
    const int n = tile * kTokens + i;
    sQ[(i * G + g) * kQStride + k] =
        s_act[i] ? q[(static_cast<size_t>(n) * n_heads + kv * G + g) * D + k] *
                       scale
                 : 0.f;
  }

  float m_run[G], l_run[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  }

  const int n_pos = nb * bs;
  const int* table_row = tables + static_cast<size_t>(r) * nb;
  const bool* valid_row = valid + static_cast<size_t>(r) * n_pos;
  const float* krow = sK + lane * kKStride;
  for (int base = 0; base < n_pos; base += kKeys) {
    __syncthreads();    // the previous tile's readers are done
    bool ok = false;
    if (tid < kKeys) {
      const int p = base + tid;
      ok = p < n_pos && valid_row[p];
      s_ok[tid] = ok;
    }
    if (!__syncthreads_or(ok)) continue;

    {   // stage the 16 positions' K and V, 16 threads a position
      const int pl = tid / 16, c = tid % 16;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (s_ok[pl]) {
        const int p = base + pl;
        const int page = table_row[p / bs];
        const size_t pos_row =
            (static_cast<size_t>(page) * n_kv + kv) * bs + (p % bs);
        load4(k_pages + pos_row * D + 4 * c, kf);
        load4(v_pages + pos_row * D + 4 * c, vf);
        if (k_scale != nullptr) {
          const float ks = k_scale[pos_row], vs = v_scale[pos_row];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            kf[j] *= ks;
            vf[j] *= vs;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sK[pl * kKStride + 4 * c + j] = kf[j];
      *reinterpret_cast<float4*>(&sV[pl * D + 4 * c]) =
          make_float4(vf[0], vf[1], vf[2], vf[3]);
    }
    __syncthreads();

    const bool ok_j = s_ok[lane];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* qrow = sQ + (hw * G + g) * kQStride;
      float s = 0.f;
#pragma unroll 16
      for (int k = 0; k < D; ++k) s = fmaf(qrow[k], krow[k], s);
      s = ok_j ? s : kNegInf;
      float mt = s;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
      const float m_new = fmaxf(m_run[g], mt);
      const float corr = expf(m_run[g] - m_new);
      const float p = ok_j ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off, 16);
      l_run[g] = fmaf(l_run[g], corr, ps);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j, 16);
        const float4 v =
            *reinterpret_cast<const float4*>(&sV[j * D + 4 * lane]);
        acc[g][0] = fmaf(pj, v.x, acc[g][0]);
        acc[g][1] = fmaf(pj, v.y, acc[g][1]);
        acc[g][2] = fmaf(pj, v.z, acc[g][2]);
        acc[g][3] = fmaf(pj, v.w, acc[g][3]);
      }
      m_run[g] = m_new;
    }
  }

  if (!s_act[hw]) return;
  const int n = tile * kTokens + hw;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t row = (static_cast<size_t>(n) * n_kv + kv) * G + g;
    *reinterpret_cast<float4*>(&o[row * D + 4 * lane]) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    if (lane == 0) {
      l_out[row] = l_run[g];
      m_out[row] = m_run[g];
    }
  }
}

// The one shape instantiated, and held against the plain version on the
// card: d_head 64 with 3 query heads per KV head (smollm-360m's 15 heads on
// 5 KV heads).  Other shapes are refused until they are instantiated and
// checked there too.
constexpr int kHeadDim = 64;
constexpr int kGroup = 3;

template <typename T>
cudaError_t launch_typed(const void* q, const void* seg, int seg_div,
                         const void* k_pages, const void* v_pages,
                         const void* k_scale, const void* v_scale,
                         const void* tables, const void* valid, void* o,
                         void* l, void* m, int n_tok, int n_seg, int n_kv,
                         int bs, int nb, float scale, cudaStream_t stream) {
  const dim3 grid((n_tok + kTokens - 1) / kTokens, n_kv, n_seg);
  paged_chunk_kernel<T, kHeadDim, kGroup><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(seg), seg_div,
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const bool*>(valid),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      n_tok, n_seg, n_kv, bs, nb, scale);
  return cudaGetLastError();
}

}  // namespace

// q (n_tok, n_kv * G, D) f32; seg (n_tok,) int32, or null with segment =
// token / seg_div; tables (n_seg, nb) int32; valid (n_seg, nb * bs) bool;
// pages (P, n_kv, bs, D); o (n_tok, n_kv, G, D), l and m (n_tok, n_kv, G)
// f32.  dtype codes: 0 = float32 pages, 1 = bfloat16 pages, 2 = int8 pages
// (k_scale / v_scale non-null).  Returns cudaGetLastError() after launch,
// or cudaErrorInvalidValue for a shape that is not instantiated.
extern "C" int paged_chunk_launch(const void* q, const void* seg, int seg_div,
                                  const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* tables, const void* valid,
                                  void* o, void* l, void* m, int n_tok,
                                  int n_seg, int n_kv, int G, int D, int bs,
                                  int nb, int dtype_code, float scale,
                                  void* stream) {
  if (n_tok == 0 || n_kv == 0) return static_cast<int>(cudaGetLastError());
  if (D != kHeadDim || G != kGroup || n_seg < 1 || nb < 1 || bs < 1 ||
      (seg == nullptr && seg_div < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return static_cast<int>(launch_typed<float>(
          q, seg, seg_div, k_pages, v_pages, k_scale, v_scale, tables, valid,
          o, l, m, n_tok, n_seg, n_kv, bs, nb, scale, st));
    case 1:
      return static_cast<int>(launch_typed<__nv_bfloat16>(
          q, seg, seg_div, k_pages, v_pages, k_scale, v_scale, tables, valid,
          o, l, m, n_tok, n_seg, n_kv, bs, nb, scale, st));
    case 2:
      return static_cast<int>(launch_typed<int8_t>(
          q, seg, seg_div, k_pages, v_pages, k_scale, v_scale, tables, valid,
          o, l, m, n_tok, n_seg, n_kv, bs, nb, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
