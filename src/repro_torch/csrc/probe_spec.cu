// Masked multi-token serving probe step (speculative verify): T chained
// K1 steps per slot in one launch, gated by each slot's accepted length.
//
// Replaces the TPU kernel repro/kernels/ttt_probe.py:304
// serving_probe_spec_step (body _spec_kernel :236).  Plain PyTorch
// version: repro_torch/kernels/probe_spec.py serving_probe_spec_step_plain,
// K1's plain version chained T times, after repro/kernels/ref.py:80.
//
// Token t of slot i participates iff t < accept[i], its boundary flag is
// set and the slot is not stopped -- counting a stop that fired earlier in
// this chain.  A participating token runs K1's per-token math
// (csrc/probe_math.cuh): score-then-update, ring shift, mean over
// min(n, win), the threshold test after burn-in, the stop step; the W and b
// update is skipped on the token where the stop fires (Algorithm 2 order).
// Every token writes s (the score with the current W), the smoothed score
// and n; a token that does not participate repeats the carried smoothed
// score and n, as _spec_kernel stores them.
//
// Bound on the H100: bytes.  Per slot the chain reads T (zq, zk) rows and
// W once and writes W once, about 7 flops per feature and token, far below
// the ridge; at the served shape (4 slots, T 4, f 960) the call moves
// about 150 KB, so launch latency sets its time.  The Pallas kernel
// transposes to (T, B, f) and runs a fori_loop over T on one core; here
// blocks run in no order, so the design is:
//   * one block per slot (slots never communicate); W_i lives in shared
//     memory for the whole chain (f floats, at most 28 KB at f = 7168),
//     loaded once and stored once;
//   * per token, the step of probe_math.cuh -- the very function K1 runs --
//     on the shared W_i, with the token's boundary flag gated by t < accept.
// Since both kernels run one function per token, a chain of accept[i]
// tokens gives the state of accept[i] sequential K1 launches bit for bit.
// eta and lambda* arrive as scalar arguments: no host read.

#include <cuda_runtime.h>

#include "probe_math.cuh"

namespace {

__global__ void __launch_bounds__(probe::kThreads)
probe_spec_kernel(const float* __restrict__ zq, const float* __restrict__ zk,
                  const bool* __restrict__ boundary,
                  const int* __restrict__ accept, float* __restrict__ W,
                  float* __restrict__ b, float* __restrict__ ring,
                  int* __restrict__ n_scores, bool* __restrict__ stopped,
                  int* __restrict__ stop_step, float* __restrict__ s_out,
                  float* __restrict__ sm_out, int* __restrict__ n_out,
                  float eta, float lam, int burn_in, int T, int f, int win) {
  extern __shared__ float w[];                     // (f,) fast weights
  __shared__ probe::Scratch sh;
  const int i = blockIdx.x;
  float* W_i = W + static_cast<size_t>(i) * f;
  // thread j loads, updates and stores only its own features: no barrier
  for (int j = threadIdx.x; j < f; j += probe::kThreads) w[j] = W_i[j];
  const int acc = accept[i];
  float* ring_i = ring + static_cast<size_t>(i) * win;
  for (int t = 0; t < T; ++t) {
    const size_t o = static_cast<size_t>(i) * T + t;
    // the accepted-length mask composes with the frozen-stop mask that the
    // step applies: a rejected draft or a slot stopped earlier in this
    // chain contributes no boundary, no update, no score
    probe::step(zq + o * f, zk + o * f, w, f, boundary[o] && t < acc, i, b,
                ring_i, n_scores, stopped, stop_step, s_out + o, sm_out + o,
                n_out + o, eta, lam, burn_in, win, sh);
  }
  for (int j = threadIdx.x; j < f; j += probe::kThreads) W_i[j] = w[j];
}

}  // namespace

extern "C" int probe_spec_launch(const void* zq, const void* zk,
                                 const void* boundary, const void* accept,
                                 void* W, void* b, void* ring, void* n_scores,
                                 void* stopped, void* stop_step, void* s_out,
                                 void* sm_out, void* n_out, float eta,
                                 float lam, int burn_in, int B, int T, int f,
                                 int win, void* stream) {
  if (B > 0) {
    const size_t smem = static_cast<size_t>(f) * sizeof(float);
    probe_spec_kernel<<<B, probe::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(zq), static_cast<const float*>(zk),
        static_cast<const bool*>(boundary), static_cast<const int*>(accept),
        static_cast<float*>(W), static_cast<float*>(b),
        static_cast<float*>(ring), static_cast<int*>(n_scores),
        static_cast<bool*>(stopped), static_cast<int*>(stop_step),
        static_cast<float*>(s_out), static_cast<float*>(sm_out),
        static_cast<int*>(n_out), eta, lam, burn_in, T, f, win);
  }
  return static_cast<int>(cudaGetLastError());
}
