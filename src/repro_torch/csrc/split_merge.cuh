// The split-KV merge, shared by K2 (paged_decode.cu), K3 (paged_chunk.cu)
// and K6 (flash_decode.cu).
//
// Past 256 virtual positions each of those kernels shares a row's
// positions over n_split blocks (kernels/split.py split_count).  Each
// block writes the UNNORMALISED partials (o, l, m) of its share into
// scratch of n_split planes that the wrapper allocates:
//   o_p (n_split, rows, 64), l_p and m_p (n_split, rows),
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
// 16 threads per row, each owning 4 of the 64 dims as one float4.  What a
// call waits on is latency, so the loads of 8 splits go out together.
// The kernel came here from K3's paged_chunk.cu with its arithmetic
// unchanged, so K3's split results are the same bits as before.
#pragma once

#include <cuda_runtime.h>

namespace split_merge {
namespace {

constexpr int kHeadDim = 64;
constexpr float kNegInf = -1e30f;

// the split-KV merge: 16 threads per output row, 4 dims each.  The splits
// are read kChunk at a time, every load of a chunk issued before the
// chunk's arithmetic, which runs split by split in order (the same
// operations in the same order as one split at a time, so the same bits).
constexpr int kChunk = 8;

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
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_split; s0 += kChunk) {
    float ms[kChunk], ls[kChunk];
    float4 xs[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s0 + j >= n_split) continue;
      const size_t sr = static_cast<size_t>(s0 + j) * rows + row;
      ms[j] = m_p[sr];
      ls[j] = l_p[sr];
      xs[j] = *reinterpret_cast<const float4*>(o_p + sr * kHeadDim + 4 * c);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s0 + j >= n_split) continue;
      const float w = expf(ms[j] - mx);   // an empty split: exp(-1e30 - mx)
      lsum = fmaf(w, ls[j], lsum);
      acc.x = fmaf(w, xs[j].x, acc.x);
      acc.y = fmaf(w, xs[j].y, acc.y);
      acc.z = fmaf(w, xs[j].z, acc.z);
      acc.w = fmaf(w, xs[j].w, acc.w);
    }
  }
  *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * kHeadDim + 4 * c) =
      acc;
  if (c == 0) {
    l[row] = lsum;
    m[row] = mx;
  }
}

// Merge n_split planes of `rows` partial rows (head dim 64) into o, l, m.
cudaError_t launch(const void* o_part, const void* l_part, const void* m_part,
                   void* o, void* l, void* m, int rows, int n_split,
                   cudaStream_t stream) {
  merge_splits_kernel<<<(rows + 15) / 16, 256, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(l_part),
      static_cast<const float*>(m_part), static_cast<float*>(o),
      static_cast<float*>(l), static_cast<float*>(m), rows, n_split);
  return cudaGetLastError();
}

}  // namespace
}  // namespace split_merge
