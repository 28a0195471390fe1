// Fused ORCA serving probe step: score-then-update + ring smoothing +
// calibrated threshold test for every engine slot, in one launch.
//
// Replaces the TPU kernel repro/kernels/ttt_probe.py:368
// serving_probe_step (body _serving_kernel :175).  Plain PyTorch version:
// repro_torch/kernels/probe_step.py serving_probe_step_plain.
//
// Bound on the H100: bytes.  Per slot the step reads zq, zk and W (3 x f
// floats) and writes W back (f floats) for ~4 f flops: about one flop per
// 4 bytes, far below the card's ridge, and at serving widths (B = slots,
// f = 960) the whole step is ~60 KB — a few microseconds of launch and
// latency, not bandwidth.  The design keeps it to ONE launch for all slots
// and ONE pass over W per slot:
//   * one thread block per slot (blocks never communicate);
//   * the block reduces zq.W and zk.W over f in f32 (per-thread strided
//     sums, warp shuffles, then shared memory across warps);
//   * one thread runs the per-slot scalar logic (boundary mask, ring shift,
//     mean over min(n, win), threshold after burn-in, stop step);
//   * the block then writes W' = W - eta*m*(coeff*zk) in place, skipped on
//     rows whose update is masked (not at a boundary, stopped, or stopping
//     this very step: Algorithm 2 leaves (W, b) untouched on the stop).
// State (W, b, ring, n_scores, stopped, stop_step) is updated IN PLACE —
// the buffers the JAX engine donates; s and smoothed go to fresh outputs.
// Integer and boolean results follow _serving_kernel exactly: the stop
// decisions depend on them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
probe_step_kernel(const float* __restrict__ zq, const float* __restrict__ zk,
                  const bool* __restrict__ boundary, float* __restrict__ W,
                  float* __restrict__ b, float* __restrict__ ring,
                  int* __restrict__ n_scores, bool* __restrict__ stopped,
                  int* __restrict__ stop_step, float* __restrict__ s_out,
                  float* __restrict__ sm_out, float eta, float lam,
                  int burn_in, int f, int win) {
  const int i = blockIdx.x;
  const float* zq_i = zq + static_cast<size_t>(i) * f;
  const float* zk_i = zk + static_cast<size_t>(i) * f;
  float* W_i = W + static_cast<size_t>(i) * f;

  float aq = 0.f, ak = 0.f;
  for (int j = threadIdx.x; j < f; j += kThreads) {
    const float w = W_i[j];
    aq = fmaf(zq_i[j], w, aq);
    ak = fmaf(zk_i[j], w, ak);
  }
  aq = warp_sum(aq);
  ak = warp_sum(ak);
  __shared__ float red_q[kThreads / 32], red_k[kThreads / 32];
  __shared__ float s_upd, s_coeff;
  __shared__ int s_apply;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_q[warp] = aq;
    red_k[warp] = ak;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float dq = 0.f, dk = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      dq += red_q[w];
      dk += red_k[w];
    }
    const bool was_stopped = stopped[i];
    // a stopped slot is frozen compute: no boundary, no update, no scores
    const bool bnd = boundary[i] && !was_stopped;
    const float bi = b[i];
    const float s = sigmoidf(dq + bi);
    const float sk = sigmoidf(dk + bi);
    const float coeff = 2.0f * (sk - 0.0f) * sk * (1.0f - sk);
    const float upd = eta * (bnd ? 1.0f : 0.0f);

    float* ring_i = ring + static_cast<size_t>(i) * win;
    if (bnd) {
      for (int t = 0; t + 1 < win; ++t) ring_i[t] = ring_i[t + 1];
      ring_i[win - 1] = s;
    }
    const int n = n_scores[i] + (bnd ? 1 : 0);
    float total = 0.f;
    for (int t = 0; t < win; ++t) total += ring_i[t];
    const float denom = static_cast<float>(n < win ? n : win);
    const float smoothed = n > 0 ? total / fmaxf(denom, 1.0f) : 0.0f;
    // threshold test (Algorithm 2 line 11), after the burn-in
    const bool stop_now = bnd && (smoothed >= lam) && (n > burn_in);

    s_out[i] = s;
    sm_out[i] = smoothed;
    n_scores[i] = n;
    stopped[i] = was_stopped || stop_now;
    if (stop_now && stop_step[i] < 0) stop_step[i] = n;
    // the stopping step leaves the fast weights untouched
    const bool apply = bnd && !stop_now;
    if (apply) b[i] = bi - upd * coeff;
    s_upd = upd;
    s_coeff = coeff;
    s_apply = apply ? 1 : 0;
  }
  __syncthreads();

  if (s_apply) {
    const float upd = s_upd, coeff = s_coeff;
    for (int j = threadIdx.x; j < f; j += kThreads)
      W_i[j] = W_i[j] - upd * (coeff * zk_i[j]);
  }
}

}  // namespace

extern "C" int probe_step_launch(const void* zq, const void* zk,
                                 const void* boundary, void* W, void* b,
                                 void* ring, void* n_scores, void* stopped,
                                 void* stop_step, void* s_out, void* sm_out,
                                 float eta, float lam, int burn_in, int B,
                                 int f, int win, void* stream) {
  if (B > 0) {
    probe_step_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(zq), static_cast<const float*>(zk),
        static_cast<const bool*>(boundary), static_cast<float*>(W),
        static_cast<float*>(b), static_cast<float*>(ring),
        static_cast<int*>(n_scores), static_cast<bool*>(stopped),
        static_cast<int*>(stop_step), static_cast<float*>(s_out),
        static_cast<float*>(sm_out), eta, lam, burn_in, f, win);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
