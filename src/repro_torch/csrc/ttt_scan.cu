// Offline TTT scan: per trajectory, T sequential score-then-update steps of
// the probe's fast weights from that trajectory's own (W_i, b_i).
//
// Replaces the TPU kernel repro/kernels/ttt_probe.py:80 ttt_probe_batched
// (body _kernel :47; wrappers ttt_probe_scan :132, make_unroll_kernel
// :148).  Plain PyTorch version: repro_torch/kernels/ttt_scan.py
// ttt_probe_batched_plain, after repro/kernels/ref.py:37.
//
// Per step t of trajectory i (Algorithm 2 lines 8-16):
//   s_t  = sigmoid(zq_t . W + b)              scored with the CURRENT W
//   s_k  = sigmoid(zk_t . W + b)
//   g    = 2 (s_k - c_t) s_k (1 - s_k)        Brier gradient scale
//   W   -= eta m_t g zk_t ;  b -= eta m_t g   (m_t = 0 scores, no update)
//
// Bound on the H100: bytes.  The scan reads zq and zk once (N T f floats
// each) and does about 6 flops per element read, far below the ridge.  The
// Pallas grid walks (N, T / t_chunk) in order on one core; here the T
// recurrence is a loop inside one block per trajectory and the N
// trajectories run in parallel blocks.  The design:
//   * one block per trajectory; W_i lives in shared memory for the whole
//     chain (f floats, at most 28 KB at f = 7168), b_i in a register;
//   * thread j owns the features j, j + blockDim, ...: it reads zq_t and
//     zk_t there (coalesced), updates W there, and so never waits on
//     another thread's W;
//   * both dot products with the current W go through one block reduction
//     (warp shuffles, then a double-buffered cross-warp array), and every
//     thread sums the warp partials in the same order, so all threads hold
//     the same scalars and one __syncthreads per step suffices;
//   * s_t is written for every t, masked steps included; W_f and b_f once
//     at the end.
// eta is read from device memory (a learnable eta is a tensor): no host
// read.  w0 and b0 take a row stride, 0 for the shared meta-learned init.
// The loop of dependent steps, each one DRAM round trip plus a reduction,
// makes this latency-bound at small N.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
ttt_scan_kernel(const float* __restrict__ zq, const float* __restrict__ zk,
                const float* __restrict__ c, const float* __restrict__ m,
                const float* __restrict__ w0, const float* __restrict__ b0,
                const float* __restrict__ eta_p, float* __restrict__ scores,
                float* __restrict__ w_f, float* __restrict__ b_f, int T,
                int f, int w0_stride, int b0_stride) {
  extern __shared__ float w[];                     // (f,) fast weights
  __shared__ float red[2][2][kMaxWarps];           // [buf][q|k][warp]
  const int i = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  const size_t row = static_cast<size_t>(i) * T;
  const float* zq_i = zq + row * f;
  const float* zk_i = zk + row * f;
  const float eta = *eta_p;

  const float* w0_i = w0 + static_cast<size_t>(i) * w0_stride;
  for (int j = tid; j < f; j += nthr) w[j] = w0_i[j];
  float b = b0[static_cast<size_t>(i) * b0_stride];

  for (int t = 0; t < T; ++t) {
    const float* q = zq_i + static_cast<size_t>(t) * f;
    const float* k = zk_i + static_cast<size_t>(t) * f;
    float aq = 0.f, ak = 0.f;
    for (int j = tid; j < f; j += nthr) {
      const float wj = w[j];
      aq = fmaf(q[j], wj, aq);
      ak = fmaf(k[j], wj, ak);
    }
    aq = warp_sum(aq);
    ak = warp_sum(ak);
    const int buf = t & 1;
    if (lane == 0) {
      red[buf][0][warp] = aq;
      red[buf][1][warp] = ak;
    }
    // the one barrier of the step: it also orders this step's writes of
    // red[buf] after every thread's reads of red[buf] two steps ago
    __syncthreads();
    float dq = 0.f, dk = 0.f;
    for (int v = 0; v < nwarps; ++v) {
      dq += red[buf][0][v];
      dk += red[buf][1][v];
    }
    const float s_q = sigmoidf(dq + b);
    const float s_k = sigmoidf(dk + b);
    const float coeff = 2.0f * (s_k - c[row + t]) * s_k * (1.0f - s_k);
    const float upd = eta * m[row + t];
    if (tid == 0) scores[row + t] = s_q;
    for (int j = tid; j < f; j += nthr) w[j] = w[j] - upd * (coeff * k[j]);
    b = b - upd * coeff;
  }

  float* wf_i = w_f + static_cast<size_t>(i) * f;
  for (int j = tid; j < f; j += nthr) wf_i[j] = w[j];
  if (tid == 0) b_f[i] = b;
}

}  // namespace

extern "C" int ttt_scan_launch(const void* zq, const void* zk, const void* c,
                               const void* m, const void* w0, const void* b0,
                               const void* eta, void* scores, void* w_f,
                               void* b_f, int N, int T, int f, int w0_stride,
                               int b0_stride, void* stream) {
  if (N > 0) {
    int threads = ((f + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                          : threads);
    const size_t smem = static_cast<size_t>(f) * sizeof(float);
    ttt_scan_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(zq), static_cast<const float*>(zk),
        static_cast<const float*>(c), static_cast<const float*>(m),
        static_cast<const float*>(w0), static_cast<const float*>(b0),
        static_cast<const float*>(eta), static_cast<float*>(scores),
        static_cast<float*>(w_f), static_cast<float*>(b_f), T, f, w0_stride,
        b0_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
