// The split-KV merge, shared by K2 (paged_decode.cu), K3 (paged_chunk.cu)
// and K6 (flash_decode.cu).
//
// Past 256 virtual positions each of those kernels shares a row's
// positions over n_split blocks (kernels/split.py split_count).  Each
// block writes the UNNORMALISED partials (o, l, m) of its share into
// scratch of n_split planes that the wrapper allocates:
//   o_p (n_split, rows, D), l_p and m_p (n_split, rows),
// where a row is one query row of one (token or batch row, KV head).  The
// launcher that ran the blocks then launches this kernel on the same
// stream.  It folds the planes by the log-sum-exp rule, as
// kernels/split.py merge_split_partials_plain does:
//   m = max_s m_s,  w_s = exp(m_s - m),  l = sum_s w_s l_s,  o = sum_s w_s o_s.
// An empty share has m = -1e30, l = 0, o = 0.  Its weight is exp(-1e30 - m),
// which is 0 beside any real m and 1 when every share is empty; either way
// it adds nothing, so a row with no valid position in any split keeps
// m = -1e30, l = 0, o = 0.
//
// Bound: bytes.  It reads n_split planes and writes one, in a single pass:
// 16 threads per row, each owning D / 16 of the head dim D: at d 64 and
// d 128 as D / 64 float4 words, at d 80 as five floats (16 threads of 5
// floats: 80 is no multiple of 64 float4 dims, and 20 threads a row would
// not tile a block's rows).  What a
// call waits on is latency, so the loads of 8 splits go out together.
// The kernel came here from K3's paged_chunk.cu with its arithmetic
// unchanged, so K3's split results are the same bits as before (at d 64
// each thread's one word is the one it always read).
#pragma once

#include <cuda_runtime.h>

namespace split_merge {
namespace {

constexpr float kNegInf = -1e30f;

// the split-KV merge: 16 threads per output row, D / 16 dims each (thread c
// owns words c, c + 16, ... of kF floats: float4 words where D is a
// multiple of 64, single floats otherwise).  The splits
// are read kChunk at a time, every load of a chunk issued before the
// chunk's arithmetic, which runs split by split in order (the same
// operations in the same order as one split at a time, so the same bits).
constexpr int kChunk = 8;

template <int D>
__global__ void __launch_bounds__(256)
merge_splits_kernel(const float* __restrict__ o_p,
                    const float* __restrict__ l_p,
                    const float* __restrict__ m_p, float* __restrict__ o,
                    float* __restrict__ l, float* __restrict__ m, int rows,
                    int n_split) {
  const int row = blockIdx.x * 16 + threadIdx.x / 16, c = threadIdx.x % 16;
  if (row >= rows) return;
  float mx = kNegInf;
  for (int s0 = 0; s0 < n_split; s0 += kChunk) {
    float ms[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      ms[j] = s0 + j < n_split
                  ? m_p[static_cast<size_t>(s0 + j) * rows + row]
                  : kNegInf;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (s0 + j < n_split) mx = fmaxf(mx, ms[j]);
  }
  constexpr int kF = D % 64 == 0 ? 4 : 1;   // floats a word
  constexpr int kVec = D / (16 * kF);        // words a thread
  float lsum = 0.f;
  float acc[kVec][kF];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
#pragma unroll
    for (int e = 0; e < kF; ++e) acc[v][e] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kChunk) {
    float ms[kChunk], ls[kChunk];
    float xs[kChunk][kVec][kF];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s0 + j >= n_split) continue;
      const size_t sr = static_cast<size_t>(s0 + j) * rows + row;
      ms[j] = m_p[sr];
      ls[j] = l_p[sr];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float* src = o_p + sr * D + kF * (c + 16 * v);
        if constexpr (kF == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          xs[j][v][0] = x.x;
          xs[j][v][1] = x.y;
          xs[j][v][2] = x.z;
          xs[j][v][3] = x.w;
        } else {
          xs[j][v][0] = *src;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s0 + j >= n_split) continue;
      const float w = expf(ms[j] - mx);   // an empty split: exp(-1e30 - mx)
      lsum = fmaf(w, ls[j], lsum);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
#pragma unroll
        for (int e = 0; e < kF; ++e)
          acc[v][e] = fmaf(w, xs[j][v][e], acc[v][e]);
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    float* dst = o + static_cast<size_t>(row) * D + kF * (c + 16 * v);
    if constexpr (kF == 4)
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
    else
      *dst = acc[v][0];
  }
  if (c == 0) {
    l[row] = lsum;
    m[row] = mx;
  }
}

// Merge n_split planes of `rows` partial rows (head dim D) into o, l, m.
template <int D>
cudaError_t launch(const void* o_part, const void* l_part, const void* m_part,
                   void* o, void* l, void* m, int rows, int n_split,
                   cudaStream_t stream) {
  static_assert(D % 16 == 0, "whole words for 16 threads a row");
  merge_splits_kernel<D><<<(rows + 15) / 16, 256, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(l_part),
      static_cast<const float*>(m_part), static_cast<float*>(o),
      static_cast<float*>(l), static_cast<float*>(m), rows, n_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace split_merge
