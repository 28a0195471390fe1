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
// f = 960) the whole step is ~60 KB -- a few microseconds of launch and
// latency, not bandwidth.  K1 is K4's chain at T = 1: this launcher runs
// the kernel of probe_spec.cu (the step of probe_math.cuh) with one token
// a slot, every token accepted and no per-token counts, in the instance
// kernels/probe_step.py BANDS names for the width.  So one launch for all
// slots, one block a slot, every load issued at entry, one barrier, and a
// chain of K4 equals that many K1 launches bit for bit.  State (W, b,
// ring, n_scores, stopped, stop_step) is updated IN PLACE -- the buffers
// the JAX engine donates; s and smoothed go to fresh outputs.  Integer
// and boolean results follow _serving_kernel exactly: the stop decisions
// depend on them.

#include <cuda_runtime.h>

#include "probe_math.cuh"

extern "C" int probe_step_launch(const void* zq, const void* zk,
                                 const void* boundary, void* W, void* b,
                                 void* ring, void* n_scores, void* stopped,
                                 void* stop_step, void* s_out, void* sm_out,
                                 float eta, float lam, int burn_in, int B,
                                 int f, int win, int nt, int fpt, int same,
                                 int smem_ring, int vec, void* stream) {
  const probe::Args g{
      static_cast<const float*>(zq), static_cast<const float*>(zk),
      static_cast<const bool*>(boundary), nullptr, static_cast<float*>(W),
      static_cast<float*>(b), static_cast<float*>(ring),
      static_cast<int*>(n_scores), static_cast<bool*>(stopped),
      static_cast<int*>(stop_step), static_cast<float*>(s_out),
      static_cast<float*>(sm_out), nullptr, eta, lam, burn_in, B, 1, f, win,
      vec, static_cast<cudaStream_t>(stream)};
  return probe::chain_launch(g, probe::Figures{nt, fpt, same, smem_ring});
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
