// RWKV6 WKV recurrence (K8), per (batch row, head):
//   out_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T
// r, k, v, w (B, T, H, D) f32; u (H, D); s0 (B, H, D, D), row i = key
// channel, column j = value channel.  Returns out (B, T, H, D) and the
// final state, written to s_out, which may be s0 itself (every block reads
// its whole state before it writes any of it).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py:53 wkv_scan (body
// _kernel :23).  That kernel walks a (B, H, T/ct) grid in order with the
// state in VMEM scratch and pads T with w = 1; here a loop inside the block
// takes the place of the sequential grid axis, so there is neither chunking
// nor padding.  Plain PyTorch version: repro_torch/kernels/rwkv6_scan.py
// wkv_scan_plain (the loop of repro/models/rwkv6.py:90).
//
// Bound on the H100: bytes.  Each step reads 4 D floats and writes D for
// 4 D^2 flops; the state is read and written once.  At the served decode
// shape (T = 1) the state's 2 x D^2 floats a head are nearly all the bytes.
// The recurrence is sequential in T, so the design keeps the state out of
// device memory for the whole of T: one block of 256 threads per (row,
// head), thread (g, j) owning rows 16 g .. 16 g + 15 of column j in
// registers.  Step t's r, k, w and v sit in shared memory (double
// buffered, the next step's vectors loaded while this one computes), the
// four row groups' partial sums of out_t[j] meet in shared memory, and one
// barrier a step orders both.  No chunked (matrix-product) form yet: a
// long prefill walks its T steps one by one.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;                    // the head dim instantiated
constexpr int kGroups = 4;                // row groups of the state
constexpr int kThreads = kD * kGroups;    // one thread per (group, column)
constexpr int kRowsPerThread = kD / kGroups;

__global__ void __launch_bounds__(kThreads)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ out, float* s_out, int T, int H) {
  // vec[buf][0..3] = r, k, v, w of one step
  __shared__ float vec[2][4][kD];
  __shared__ float part[2][kGroups][kD];
  __shared__ float u_s[kD];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int j = tid % kD, g = tid / kD;
  const int i0 = g * kRowsPerThread;

  // the vector this thread stages each step: g picks r, k, v or w
  const float* src = g == 0 ? r : g == 1 ? k : g == 2 ? v : w;
  const size_t step_stride = static_cast<size_t>(H) * kD;
  const size_t base = (static_cast<size_t>(b) * T * H + h) * kD + j;

  const size_t state = (static_cast<size_t>(b) * H + h) * kD * kD;
  float S[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    S[i] = s0[state + static_cast<size_t>(i0 + i) * kD + j];
  if (g == 0) u_s[j] = u[static_cast<size_t>(h) * kD + j];
  if (T > 0) vec[0][g][j] = src[base];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    // next step's element, in flight while this step computes
    const float nxt = t + 1 < T ? src[base + (t + 1) * step_stride] : 0.f;
    const float vj = vec[cur][2][j];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = i0 + i;
      const float kv = vec[cur][1][row] * vj;
      acc += vec[cur][0][row] * (u_s[row] * kv + S[i]);
      S[i] = vec[cur][3][row] * S[i] + kv;
    }
    part[cur][g][j] = acc;
    if (t + 1 < T) vec[cur ^ 1][g][j] = nxt;
    // orders this step's partials before their sum, and the next step's
    // vectors before their use; the buffers written next step were last
    // read before the previous barrier
    __syncthreads();
    if (g == 0) {
      out[base + t * step_stride] =
          (part[cur][0][j] + part[cur][1][j]) +
          (part[cur][2][j] + part[cur][3][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    s_out[state + static_cast<size_t>(i0 + i) * kD + j] = S[i];
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head dim that is not instantiated.
extern "C" int wkv_scan_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* out, void* s_out, int B, int T, int H,
                               int D, void* stream) {
  if (D != kD) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  wkv_scan_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_out), T, H);
  return static_cast<int>(cudaGetLastError());
}
