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
// and ONE pass over W per slot: one thread block per slot (blocks never
// communicate), running the step of probe_math.cuh on the slot's W in
// global memory: the block reduction of zq.W and zk.W, the scalar logic in
// one thread, then W' = W - eta*m*(coeff*zk) in place unless masked.
// State (W, b, ring, n_scores, stopped, stop_step) is updated IN PLACE —
// the buffers the JAX engine donates; s and smoothed go to fresh outputs.
// Integer and boolean results follow _serving_kernel exactly: the stop
// decisions depend on them.

#include <cuda_runtime.h>

#include "probe_math.cuh"

namespace {

__global__ void __launch_bounds__(probe::kThreads)
probe_step_kernel(const float* __restrict__ zq, const float* __restrict__ zk,
                  const bool* __restrict__ boundary, float* __restrict__ W,
                  float* __restrict__ b, float* __restrict__ ring,
                  int* __restrict__ n_scores, bool* __restrict__ stopped,
                  int* __restrict__ stop_step, float* __restrict__ s_out,
                  float* __restrict__ sm_out, float eta, float lam,
                  int burn_in, int f, int win) {
  __shared__ probe::Scratch sh;
  const int i = blockIdx.x;
  const size_t row = static_cast<size_t>(i) * f;
  probe::step(zq + row, zk + row, W + row, f, boundary[i], i, b,
              ring + static_cast<size_t>(i) * win, n_scores, stopped,
              stop_step, s_out + i, sm_out + i, nullptr, eta, lam, burn_in,
              win, sh);
}

}  // namespace

extern "C" int probe_step_launch(const void* zq, const void* zk,
                                 const void* boundary, void* W, void* b,
                                 void* ring, void* n_scores, void* stopped,
                                 void* stop_step, void* s_out, void* sm_out,
                                 float eta, float lam, int burn_in, int B,
                                 int f, int win, void* stream) {
  if (B > 0) {
    probe_step_kernel<<<B, probe::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
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
