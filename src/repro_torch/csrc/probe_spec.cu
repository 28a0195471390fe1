// Masked multi-token serving probe step (speculative verify): T chained
// probe steps per slot in one launch, gated by each slot's accepted length.
// The same kernel, at T = 1, is K1 (probe_step.cu).
//
// Replaces the TPU kernel repro/kernels/ttt_probe.py:304
// serving_probe_spec_step (body _spec_kernel :236).  Plain PyTorch
// version: repro_torch/kernels/probe_spec.py serving_probe_spec_step_plain,
// K1's plain version chained T times, after repro/kernels/ref.py:80.
//
// Token t of slot i participates iff t < accept[i], its boundary flag is
// set and the slot is not stopped -- counting a stop that fired earlier in
// this chain.  A participating token runs the step of probe_math.cuh:
// score-then-update, ring shift, mean over min(n, win), the threshold test
// after burn-in, the stop step; the W and b update is skipped on the token
// where the stop fires (Algorithm 2 order).  Every token writes s (the
// score with the current W), the smoothed score and n; a token that does
// not participate repeats the carried smoothed score and n, as
// _spec_kernel stores them.
//
// Bound on the H100: bytes.  Per slot the chain reads T (zq, zk) rows and
// W once and writes W once, about 7 flops per feature and token, far below
// the ridge; at the served shape (4 slots, T 4, f 960) the call moves
// about 150 KB (90 KB where zq is zk), so latency sets its time: what
// held each token back was a cold load of its rows after the previous
// token's second barrier, and the slot's scalar state making a round trip
// through global memory in one thread while the others waited.  The
// Pallas kernel transposes to (T, B, f) and runs a fori_loop over T on
// one core; here blocks run in no order, and the design is:
//   * one block per slot (slots never communicate); thread tid owns the
//     16-byte groups tid, tid + NT, ... of a row: W_i lives in its
//     registers for the whole chain, loaded once and stored once, and the
//     update reads nothing again;
//   * every load is issued at entry: W_i, the slot's scalar state, and the
//     rows and boundary flags of the first kRing tokens, into a ring of
//     kRing stages in shared memory filled by cp.async (the flags into
//     registers, the loop unrolled kRing times so that their index is
//     static).  Each thread reads back only the groups it copied, so the
//     ring needs no barrier.  A token's stage is refilled with token t +
//     kRing as soon as its rows are read.  A ring of two stages was the
//     fastest on the card at every width: faster than deeper rings and
//     than rings of registers, whose loads the chain then waited on
//     (PERF.md);
//   * one barrier a token: the warps' sums go to the buffer of the token's
//     parity, and every thread folds them and runs the scalar logic in
//     registers (probe_math.cuh); thread 0 writes the token's s, smoothed
//     and n, and the final state once, at the end;
//   * where zq is zk (the served no-QK view) one row is read and one dot
//     taken;
//   * NT and the features a thread are compile-time.
//     kernels/probe_step.py BANDS decides which instance a width takes and
//     passes its figures; the launcher only finds the instance of that
//     list (with_instance).  Rows move as float4 where f is a multiple of
//     4 and the tensors start on 16 bytes, else as floats, in the same
//     groups: the bits do not depend on it;
//   * a smoothing window of up to 16 scores is held in registers by every
//     thread; a wider one lies in shared memory past the rows' ring
//     (probe_math.cuh SmemRing), one more barrier at the end of the chain.
// eta and lambda* arrive as scalar arguments: no host read.

#include <cuda_runtime.h>

#include <type_traits>

#include "probe_math.cuh"

namespace {

using probe::Args;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes (4 bytes) global -> shared, left in flight; when !pred the
// source is not read and the bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The group of features j .. j + 3 of a row copied into shared memory by
// this thread, zero past f.
__device__ __forceinline__ void stage_group(float4* dst,
                                            const float* __restrict__ row,
                                            int j, int f, bool vec) {
  if (vec) {
    cp_async16(dst, j < f ? row + j : row, j < f);
    return;
  }
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    cp_async4(d + e, j + e < f ? row + j + e : row, j + e < f);
}

// The sum of NW warps' values by a pairwise tree, the same in every
// thread.
template <int NW>
__device__ __forceinline__ float fold(const float* rw) {
  float v[NW];
#pragma unroll
  for (int x = 0; x < NW; ++x) v[x] = rw[x];
  return probe::tree_sum(v);
}

// The dot of a thread's groups with its w: one sum for each lane of the
// float4 (four short chains), then (x + y) + (z + w).
template <int G>
__device__ __forceinline__ float dot_groups(const float4 (&z)[G],
                                            const float4 (&w)[G]) {
  float x = 0.f, y = 0.f, u = 0.f, v = 0.f;
#pragma unroll
  for (int p = 0; p < G; ++p) {
    x = fmaf(z[p].x, w[p].x, x);
    y = fmaf(z[p].y, w[p].y, y);
    u = fmaf(z[p].z, w[p].z, u);
    v = fmaf(z[p].w, w[p].w, v);
  }
  return (x + y) + (u + v);
}

// Tokens' rows in flight: the stages of the ring.
constexpr int kRing = 2;

// NT threads, FPT features a thread (FPT / 4 groups), SAME: zq is zk,
// SMEM_RING: the smoothing window in shared memory.
template <int NT, int FPT, bool SAME, bool SMEM_RING>
__global__ void __launch_bounds__(NT)
probe_chain_kernel(const Args g) {
  constexpr int G = FPT / 4;          // 16-byte groups a thread
  constexpr int NW = NT / 32;
  constexpr int ROWS = SAME ? 1 : 2;  // rows a token: zk (and zq)
  constexpr int R = kRing;
  using Ring = std::conditional_t<SMEM_RING, probe::SmemRing, probe::RegRing>;
  static_assert(FPT % 4 == 0 && NT % 32 == 0, "groups, whole warps");
  static_assert((NW & (NW - 1)) == 0, "a power-of-two count of warps");
  __shared__ __align__(16) float red[2][2 * NW];  // warp sums by parity
  // [R][ROWS][G][NT], then the window where SMEM_RING
  extern __shared__ __align__(16) float4 stage[];

  const int i = blockIdx.x, tid = threadIdx.x;
  const int T = g.T, f = g.f;
  const bool vec = g.vec != 0;
  const size_t first = static_cast<size_t>(i) * T;  // the slot's token 0
  const float* zk_i = g.zk + first * f;
  const float* zq_i = g.zq + first * f;
  float* W_i = g.W + static_cast<size_t>(i) * f;

  bool rb[R];
  // token t's rows into stage a and its boundary flag into rb[a] (a
  // static after unrolling); one cp.async group, empty past T
  auto load = [&](int a, int t) {
    if (t < T) {
      rb[a] = g.boundary[first + t];
      const float* k = zk_i + static_cast<size_t>(t) * f;
      const float* q = zq_i + static_cast<size_t>(t) * f;
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const int j = 4 * (tid + p * NT);
        stage_group(&stage[((a * ROWS) * G + p) * NT + tid], k, j, f, vec);
        if constexpr (!SAME)
          stage_group(&stage[((a * ROWS + 1) * G + p) * NT + tid], q, j, f,
                      vec);
      }
    }
    cp_async_commit();
  };

  float4 w[G];
#pragma unroll
  for (int p = 0; p < G; ++p) {
    const int j = 4 * (tid + p * NT);
    if (vec) {
      w[p] = j < f ? *reinterpret_cast<const float4*>(W_i + j)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      w[p] = make_float4(j < f ? W_i[j] : 0.f, j + 1 < f ? W_i[j + 1] : 0.f,
                         j + 2 < f ? W_i[j + 2] : 0.f,
                         j + 3 < f ? W_i[j + 3] : 0.f);
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) load(a, a);
  probe::State<Ring> st;
  st.b = g.b[i];
  st.n = g.n_scores[i];
  st.stopped = g.stopped[i];
  st.stop_step = g.stop_step[i];
  const int acc = g.accept != nullptr ? g.accept[i] : T;
  const int win = g.win;
  float* ring_i = g.ring + static_cast<size_t>(i) * win;
  st.ring.load(ring_i, win,
               reinterpret_cast<float*>(stage + R * ROWS * G * NT));

  const int lane = tid & 31, warp = tid >> 5;
  for (int t0 = 0; t0 < T; t0 += R) {
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int t = t0 + a;
      if (t >= T) break;
      float4 k[G], q[SAME ? 1 : G];
      cp_async_wait<R - 1>();  // token t's stage has landed
#pragma unroll
      for (int p = 0; p < G; ++p) {
        k[p] = stage[((a * ROWS) * G + p) * NT + tid];
        if constexpr (!SAME) q[p] = stage[((a * ROWS + 1) * G + p) * NT + tid];
      }
      const bool bd = rb[a];
      load(a, t + R);  // the slot's next token
      const probe::Pre pre = probe::prepare(st, bd && t < acc, win);

      const float ak = dot_groups(k, w);
      float aq = 0.f;
      if constexpr (!SAME) aq = dot_groups(q, w);
      float dk, dq;
      if constexpr (NW == 1) {
        dk = probe::warp_sum(ak);
        dq = SAME ? dk : probe::warp_sum(aq);
        if constexpr (SMEM_RING) __syncwarp();  // the window's last write
      } else {
        float* rw = red[t & 1];
        if constexpr (SAME) {
          const float v = probe::warp_sum(ak);
          if (lane == 0) rw[warp] = v;
        } else {
          // the first level trades halves: lanes below 16 go on with the
          // zk sums, the others with the zq sums (the same additions as
          // two butterflies)
          const bool hi = lane & 16;
          float v = (hi ? aq : ak) +
                    __shfl_xor_sync(0xffffffffu, hi ? ak : aq, 16);
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if ((lane & 15) == 0) rw[(hi ? NW : 0) + warp] = v;
        }
        // the one barrier of the token; the buffer of the other parity is
        // the next token's, and the token after that writes this one only
        // past the next barrier, when every thread has read it
        __syncthreads();
        dk = fold<NW>(rw);
        dq = SAME ? dk : fold<NW>(rw + NW);
      }

      float s, smoothed, uc;
      const bool apply =
          probe::scalar_step(st, pre, dq, dk, SAME, g.eta, g.lam,
                             g.burn_in, s, smoothed, uc);
#pragma unroll
      for (int p = 0; p < G; ++p) {
        w[p].x = apply ? fmaf(-uc, k[p].x, w[p].x) : w[p].x;
        w[p].y = apply ? fmaf(-uc, k[p].y, w[p].y) : w[p].y;
        w[p].z = apply ? fmaf(-uc, k[p].z, w[p].z) : w[p].z;
        w[p].w = apply ? fmaf(-uc, k[p].w, w[p].w) : w[p].w;
      }
      if (tid == 0) {
        g.s_out[first + t] = s;
        g.sm_out[first + t] = smoothed;
        if (g.n_out != nullptr) g.n_out[first + t] = st.n;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < G; ++p) {
    const int j = 4 * (tid + p * NT);
    if (vec) {
      if (j < f) *reinterpret_cast<float4*>(W_i + j) = w[p];
    } else {
      if (j < f) W_i[j] = w[p].x;
      if (j + 1 < f) W_i[j + 1] = w[p].y;
      if (j + 2 < f) W_i[j + 2] = w[p].z;
      if (j + 3 < f) W_i[j + 3] = w[p].w;
    }
  }
  if constexpr (SMEM_RING) __syncthreads();  // the last token's score
  st.ring.store(ring_i, win);
  if (tid == 0) {
    g.b[i] = st.b;
    g.n_scores[i] = st.n;
    g.stopped[i] = st.stopped;
    g.stop_step[i] = st.stop_step;
  }
}

template <int NT, int FPT, bool SAME>
constexpr size_t stage_bytes() {
  return static_cast<size_t>(kRing) * (SAME ? 1 : 2) * NT * FPT * 4;
}

// the rows' ring and, where SMEM_RING, the window
template <int NT, int FPT, bool SAME, bool SMEM_RING>
size_t dynamic_smem(int win) {
  return stage_bytes<NT, FPT, SAME>() +
         (SMEM_RING ? static_cast<size_t>(win) * 4 : 0);
}

struct Launch {
  const Args& g;
  template <int NT, int FPT, bool SAME, bool SMEM_RING>
  int run() const {
    if (g.f > NT * FPT || g.win < 1 ||
        (!SMEM_RING && g.win > probe::kMaxWindow) || (SAME && g.zq != g.zk))
      return cudaErrorInvalidValue;
    if (g.B == 0) return static_cast<int>(cudaGetLastError());
    auto kern = probe_chain_kernel<NT, FPT, SAME, SMEM_RING>;
    const size_t smem = dynamic_smem<NT, FPT, SAME, SMEM_RING>(g.win);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<g.B, NT, smem, g.stream>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Config {
  int* out;
  template <int NT, int FPT, bool SAME, bool SMEM_RING>
  int run() const {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(
        &a, probe_chain_kernel<NT, FPT, SAME, SMEM_RING>);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.sharedSizeBytes);
    out[2] = static_cast<int>(a.localSizeBytes);
    out[3] = static_cast<int>(stage_bytes<NT, FPT, SAME>());
    return 0;
  }
};

// The instances built, one for each view of each width band of
// kernels/probe_step.py BANDS, which chooses among them (the CPU tests
// hold this list to BANDS), each with its window in registers and in
// shared memory.  Figures that name none are refused.
template <class Visit>
int with_instance(const probe::Figures& x, const Visit& vis) {
#define PROBE_INSTANCE(NT, FPT, SAME)                                    \
  if (x.nt == NT && x.fpt == FPT && x.same == SAME)                      \
    return x.ring ? vis.template run<NT, FPT, SAME != 0, true>()         \
                  : vis.template run<NT, FPT, SAME != 0, false>();
  PROBE_INSTANCE(32, 4, 1)
  PROBE_INSTANCE(32, 4, 0)
  PROBE_INSTANCE(256, 4, 1)
  PROBE_INSTANCE(256, 4, 0)
  PROBE_INSTANCE(256, 8, 1)
  PROBE_INSTANCE(256, 8, 0)
  PROBE_INSTANCE(256, 16, 1)
  PROBE_INSTANCE(256, 16, 0)
  PROBE_INSTANCE(256, 20, 1)
  PROBE_INSTANCE(256, 20, 0)
  PROBE_INSTANCE(256, 28, 1)
  PROBE_INSTANCE(256, 28, 0)
#undef PROBE_INSTANCE
  return cudaErrorInvalidValue;
}

}  // namespace

namespace probe {

int chain_launch(const Args& g, const Figures& x) {
  return with_instance(x, Launch{g});
}

int chain_config(const Figures& x, int* out) {
  return with_instance(x, Config{out});
}

}  // namespace probe

extern "C" int probe_spec_launch(const void* zq, const void* zk,
                                 const void* boundary, const void* accept,
                                 void* W, void* b, void* ring, void* n_scores,
                                 void* stopped, void* stop_step, void* s_out,
                                 void* sm_out, void* n_out, float eta,
                                 float lam, int burn_in, int B, int T, int f,
                                 int win, int nt, int fpt, int same,
                                 int smem_ring, int vec, void* stream) {
  const Args g{static_cast<const float*>(zq), static_cast<const float*>(zk),
               static_cast<const bool*>(boundary),
               static_cast<const int*>(accept), static_cast<float*>(W),
               static_cast<float*>(b), static_cast<float*>(ring),
               static_cast<int*>(n_scores), static_cast<bool*>(stopped),
               static_cast<int*>(stop_step), static_cast<float*>(s_out),
               static_cast<float*>(sm_out), static_cast<int*>(n_out), eta,
               lam, burn_in, B, T, f, win, vec,
               static_cast<cudaStream_t>(stream)};
  return probe::chain_launch(g, probe::Figures{nt, fpt, same, smem_ring});
}

// The instance's registers, static shared bytes, spill bytes a thread and
// the rows' dynamic shared bytes (out[0..3]).
extern "C" int probe_chain_config(int nt, int fpt, int same, int smem_ring,
                                  int* out) {
  return probe::chain_config(probe::Figures{nt, fpt, same, smem_ring}, out);
}
