// Offline TTT scan: per trajectory, T sequential score-then-update steps of
// the probe's fast weights from that trajectory's own (W_i, b_i).
//
// Replaces the TPU kernel repro/kernels/ttt_probe.py:80 ttt_probe_batched
// (body _kernel :47; wrappers ttt_probe_scan :132, make_unroll_kernel
// :148).  Plain PyTorch version: repro_torch/kernels/ttt_scan.py
// ttt_probe_batched_plain, after repro/kernels/ref.py:37; the L-step form
// below is mirrored by ttt_probe_lookahead_plain there.
//
// Per step t of trajectory i (Algorithm 2 lines 8-16):
//   s_t  = sigmoid(zq_t . W + b)              scored with the CURRENT W
//   s_k  = sigmoid(zk_t . W + b)
//   g    = 2 (s_k - c_t) s_k (1 - s_k)        Brier gradient scale
//   W   -= eta m_t g zk_t ;  b -= eta m_t g   (m_t = 0 scores, no update)
//
// Bound on the H100: bytes.  The scan reads zq and zk once (N T f floats
// each) and does about 7 flops per element read, far below the ridge.  The
// Pallas grid walks (N, T / t_chunk) in order on one core; here the T
// recurrence is a loop inside one block per trajectory and the N
// trajectories run in parallel blocks.  What held the chain back was a
// block barrier and a load on every step; the design:
//   * the update is rank one, W_{t+1} = W_t - a_t zk_t with a_t = eta m_t
//     g_t, so from W = W_{t0} the dots of L steps follow from dots with W
//     and among the steps' own rows:
//       zk_{t0+a} . W_{t0+a} = zk_{t0+a} . W
//                              - sum_{b<a} a_b (zk_{t0+a} . zk_{t0+b})
//     (likewise for zq).  One block reduction of L + L(L-1)/2 sums (2L +
//     L(L-1) where zq is not zk) serves L steps: a warp folds its sums by
//     butterfly exchanges (warp_sums_to), one barrier, a thread per sum
//     adds the warps', a second barrier; every thread then runs the L
//     scalar steps in the same order on the same sums, and applies
//     W -= sum_a a_a zk_{t0+a} once.  Two barriers per L steps;
//   * thread j owns the features j, j + NT, ..., j + (FPT-1) NT: W lives in
//     its registers, and it reads zq and zk there (coalesced);
//   * the rows of the next PD L-blocks are loaded into registers while the
//     current block computes (a ring of PD + 1 register blocks, the loop
//     unrolled so that every index is static), and the current zk rows
//     stay there for the update: no load waits on the chain;
//   * c and m travel with the rows: lane a of every warp loads step
//     t0 + a's label and mask in the same ring, and the scalar steps take
//     them by shuffle.  Nothing is sized by T, so T is unbounded;
//   * NT, FPT, L and PD are compile-time.  kernels/ttt_scan.py BANDS
//     decides which instance a width takes and passes its figures; the
//     launcher only finds the instance of that list (with_instance);
//   * s_t is written for every t, masked steps included (a_t = 0); W_f and
//     b_f once at the end.  A short last block reads nothing past T.
// eta is read from device memory (a learnable eta is a tensor): no host
// read.  w0 and b0 take a row stride, 0 for the shared meta-learned init.
// Tried and measured (PERF.md, PR 22): a cp.async ring in shared memory
// instead of the register blocks was slower (each row read back from
// shared memory on the chain), a fast exponential and reciprocal in the
// scalar steps bought nothing, and the narrow band on one warp (no
// barrier) was slower than on four.

#include <cuda_runtime.h>

namespace {

// the scalar steps' sigmoid, on the chain of every L-block
__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The sums of one block of L steps: [0, L) zk_a . W; [L, L + P) zk_a .
// zk_b for b < a (at L + pair(a, b)); where zq is not zk also [L + P,
// 2L + P) zq_a . W and [2L + P, 2L + 2P) zq_a . zk_b.
template <int L, bool SAME>
struct Dots {
  static constexpr int P = L * (L - 1) / 2;
  static constexpr int V = SAME ? L + P : 2 * (L + P);
  static constexpr int Q = L + P;  // offset of the zq sums
  __host__ __device__ static constexpr int pair(int a, int b) {
    return a * (a - 1) / 2 + b;
  }
};

// the rows t0 .. t0 + L - 1 of this thread's features, zero past T and f;
// lane a < L also takes step t0 + a's label (cl) and mask (ml)
template <int NT, int FPT, int L, int LQ, bool SAME>
__device__ __forceinline__ void load_rows(float (&k)[L][FPT],
                                          float (&q)[LQ][FPT], float& cl,
                                          float& ml, const float* zk,
                                          const float* zq, const float* c,
                                          const float* m, int t0, int T,
                                          int f, int tid) {
  const int lane = tid & 31;
  const bool step = lane < L && t0 + lane < T;
  cl = step ? c[t0 + lane] : 0.f;
  ml = step ? m[t0 + lane] : 0.f;
#pragma unroll
  for (int a = 0; a < L; ++a) {
    const bool live = t0 + a < T;
    const size_t at = static_cast<size_t>(t0 + a) * f;
#pragma unroll
    for (int p = 0; p < FPT; ++p) {
      const int j = tid + p * NT;
      const bool ok = live && j < f;
      k[a][p] = ok ? zk[at + j] : 0.f;
      if constexpr (!SAME) q[a][p] = ok ? zq[at + j] : 0.f;
    }
  }
}

// Sums v[0..V) over the warp's lanes and writes the warp's totals to
// rw[x NW + warp].  K butterfly levels first (each lane trades half of its
// values with its partner, so every later level folds half as many),
// then plain xor folds of the V >> K values left; the lanes whose low
// 5 - K bits are 0 then hold distinct quarters (halves) of the totals.
template <int V, int NW>
__device__ __forceinline__ void warp_sums_to(float (&v)[V], float* rw,
                                             int warp, int lane) {
  constexpr int K = V % 4 == 0 ? 2 : (V % 2 == 0 ? 1 : 0);
  constexpr int N = V >> K;
  if constexpr (K >= 1) {
    const bool hi = lane & 16;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float send = hi ? v[i] : v[i + V / 2];
      const float keep = hi ? v[i + V / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  if constexpr (K >= 2) {
    const bool hi = lane & 8;
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float send = hi ? v[i] : v[i + V / 4];
      const float keep = hi ? v[i + V / 4] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
#pragma unroll
  for (int o = 16 >> K; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if ((lane & ((32 >> K) - 1)) == 0) {
    const int base = (lane >> (5 - K)) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) rw[(base + i) * NW + warp] = v[i];
  }
}

// PD: L-blocks of rows in flight ahead of the one computing (registers
// hold PD + 1 blocks).  MINB: blocks an SM must hold (register budget).
template <int NT, int FPT, int L, bool SAME, int MINB, int PD>
__global__ void __launch_bounds__(NT, MINB)
ttt_scan_kernel(const float* __restrict__ zq, const float* __restrict__ zk,
                const float* __restrict__ c, const float* __restrict__ m,
                const float* __restrict__ w0, const float* __restrict__ b0,
                const float* __restrict__ eta_p, float* __restrict__ scores,
                float* __restrict__ w_f, float* __restrict__ b_f, int T,
                int f, int w0_stride, int b0_stride) {
  using D = Dots<L, SAME>;
  constexpr int V = D::V, Q = D::Q;
  constexpr int NW = NT / 32;
  constexpr int LQ = SAME ? 1 : L;  // zq rows held (none used when SAME)
  static_assert(PD == 1 || PD == 2, "prefetch depth 1 or 2");
  static_assert(NT % 32 == 0 && NW > 1 && L <= 32, "warps, L a lane each");
  __shared__ float rw[V * NW];  // [V][NW] warp sums
  __shared__ float tot[V];      // [V] block sums

  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = static_cast<size_t>(i) * T;
  const float* zq_i = zq + row * f;
  const float* zk_i = zk + row * f;
  const float* c_i = c + row;
  const float* m_i = m + row;
  const float eta = *eta_p;

  float ka[L][FPT], qa[LQ][FPT], kb[L][FPT], qb[LQ][FPT];
  float kc[PD == 2 ? L : 1][FPT], qc[PD == 2 ? LQ : 1][FPT];
  float ca, ma, cb = 0.f, mb = 0.f, cc = 0.f, mc = 0.f;  // a lane a step
  load_rows<NT, FPT, L, LQ, SAME>(ka, qa, ca, ma, zk_i, zq_i, c_i, m_i, 0,
                                  T, f, tid);
  if constexpr (PD == 2)
    load_rows<NT, FPT, L, LQ, SAME>(kb, qb, cb, mb, zk_i, zq_i, c_i, m_i, L,
                                    T, f, tid);
  const float* w0_i = w0 + static_cast<size_t>(i) * w0_stride;
  float W[FPT];
#pragma unroll
  for (int p = 0; p < FPT; ++p) {
    const int j = tid + p * NT;
    W[p] = j < f ? w0_i[j] : 0.f;
  }
  float b = b0[static_cast<size_t>(i) * b0_stride];

  // one L-block from rows k (q), labels cl and masks ml; the rows PD
  // blocks ahead go into kn (qn), cn and mn
  auto block = [&](float (&k)[L][FPT], float (&q)[LQ][FPT], float cl,
                   float ml, float (&kn)[L][FPT], float (&qn)[LQ][FPT],
                   float& cn, float& mn, int t0) {
    if (t0 + PD * L < T)
      load_rows<NT, FPT, L, LQ, SAME>(kn, qn, cn, mn, zk_i, zq_i, c_i, m_i,
                                      t0 + PD * L, T, f, tid);
    float v[V];
#pragma unroll
    for (int x = 0; x < V; ++x) v[x] = 0.f;
#pragma unroll
    for (int p = 0; p < FPT; ++p) {
      const float wp = W[p];
#pragma unroll
      for (int a = 0; a < L; ++a) {
        v[a] = fmaf(k[a][p], wp, v[a]);
#pragma unroll
        for (int bb = 0; bb < a; ++bb)
          v[L + D::pair(a, bb)] =
              fmaf(k[a][p], k[bb][p], v[L + D::pair(a, bb)]);
        if constexpr (!SAME) {
          v[Q + a] = fmaf(q[a][p], wp, v[Q + a]);
#pragma unroll
          for (int bb = 0; bb < a; ++bb)
            v[Q + L + D::pair(a, bb)] =
                fmaf(q[a][p], k[bb][p], v[Q + L + D::pair(a, bb)]);
        }
      }
    }
    // the block reduction of the L steps: warp sums, a barrier, the V
    // block sums (a thread each), a barrier, every thread reads them.  The
    // second barrier keeps the first one's readers ahead of the next
    // block's writers, so one buffer of each serves every block.
    warp_sums_to<V, NW>(v, rw, warp, lane);
    __syncthreads();
    for (int x = tid; x < V; x += NT) {
      float s = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < NW; ++w2) s += rw[x * NW + w2];
      tot[x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < V; ++x) v[x] = tot[x];

    // the L scalar steps, the same in every thread
    float coef[L];
#pragma unroll
    for (int a = 0; a < L; ++a) {
      const int t = t0 + a;
      const float c_t = __shfl_sync(0xffffffffu, cl, a);
      const float m_t = __shfl_sync(0xffffffffu, ml, a);
      float ai = 0.f;
      if (t < T) {
        const float s_k = sigmoidf(v[a] + b);
        float s_q = s_k;
        if constexpr (!SAME) s_q = sigmoidf(v[Q + a] + b);
        const float g = 2.0f * (s_k - c_t) * s_k * (1.0f - s_k);
        ai = (eta * m_t) * g;
        b = b - ai;
        if (tid == 0) scores[row + t] = s_q;
      }
      coef[a] = ai;
      // the later steps' dots, corrected for this step's update
#pragma unroll
      for (int a2 = a + 1; a2 < L; ++a2) {
        v[a2] = fmaf(-ai, v[L + D::pair(a2, a)], v[a2]);
        if constexpr (!SAME)
          v[Q + a2] = fmaf(-ai, v[Q + L + D::pair(a2, a)], v[Q + a2]);
      }
    }
#pragma unroll
    for (int p = 0; p < FPT; ++p) {
      float wp = W[p];
#pragma unroll
      for (int a = 0; a < L; ++a) wp = fmaf(-coef[a], k[a][p], wp);
      W[p] = wp;
    }
  };

  // the ring of PD + 1 register blocks, unrolled so that every index is
  // static
  for (int t0 = 0; t0 < T;) {
    if constexpr (PD == 1) {
      block(ka, qa, ca, ma, kb, qb, cb, mb, t0);
      if ((t0 += L) >= T) break;
      block(kb, qb, cb, mb, ka, qa, ca, ma, t0);
      t0 += L;
    } else {
      block(ka, qa, ca, ma, kc, qc, cc, mc, t0);
      if ((t0 += L) >= T) break;
      block(kb, qb, cb, mb, ka, qa, ca, ma, t0);
      if ((t0 += L) >= T) break;
      block(kc, qc, cc, mc, kb, qb, cb, mb, t0);
      t0 += L;
    }
  }

  float* wf_i = w_f + static_cast<size_t>(i) * f;
#pragma unroll
  for (int p = 0; p < FPT; ++p) {
    const int j = tid + p * NT;
    if (j < f) wf_i[j] = W[p];
  }
  if (tid == 0) b_f[i] = b;
}

struct Args {
  const float *zq, *zk, *c, *m, *w0, *b0, *eta;
  float *scores, *w_f, *b_f;
  int N, T, f, w0_stride, b0_stride;
  cudaStream_t stream;
};

struct Launch {
  const Args& g;
  template <int NT, int FPT, int L, bool SAME, int MINB, int PD>
  int run() const {
    if (g.f > NT * FPT || (SAME && g.zq != g.zk))
      return cudaErrorInvalidValue;
    ttt_scan_kernel<NT, FPT, L, SAME, MINB, PD><<<g.N, NT, 0, g.stream>>>(
        g.zq, g.zk, g.c, g.m, g.w0, g.b0, g.eta, g.scores, g.w_f, g.b_f, g.T,
        g.f, g.w0_stride, g.b0_stride);
    return static_cast<int>(cudaGetLastError());
  }
};

// out: registers a thread, static shared bytes (the warp and block sums),
// local (spill) bytes a thread
struct Config {
  int* out;
  template <int NT, int FPT, int L, bool SAME, int MINB, int PD>
  int run() const {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(
        &a, ttt_scan_kernel<NT, FPT, L, SAME, MINB, PD>);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.sharedSizeBytes);
    out[2] = static_cast<int>(a.localSizeBytes);
    return 0;
  }
};

// An instance's figures: threads, features a thread, L, zq is zk, blocks
// an SM must hold, L-blocks of rows in flight.
struct Figures {
  int nt, fpt, l, same, minb, pd;
};

// The instances built, one for each view of each width band of
// kernels/ttt_scan.py BANDS, which chooses among them (the CPU tests hold
// this list to BANDS).  Figures that name none are refused.
template <class Visit>
int with_instance(const Figures& x, const Visit& vis) {
#define TTT_INSTANCE(NT, FPT, L, SAME, MINB, PD)                         \
  if (x.nt == NT && x.fpt == FPT && x.l == L && x.same == SAME &&        \
      x.minb == MINB && x.pd == PD)                                      \
    return vis.template run<NT, FPT, L, SAME != 0, MINB, PD>();
  TTT_INSTANCE(128, 1, 8, 1, 1, 2)
  TTT_INSTANCE(128, 1, 8, 0, 1, 2)
  TTT_INSTANCE(256, 4, 8, 1, 2, 1)
  TTT_INSTANCE(256, 4, 4, 0, 2, 1)
  TTT_INSTANCE(256, 8, 4, 1, 2, 1)
  TTT_INSTANCE(256, 8, 2, 0, 2, 1)
  TTT_INSTANCE(512, 8, 2, 1, 1, 1)
  TTT_INSTANCE(512, 8, 1, 0, 1, 1)
  TTT_INSTANCE(512, 10, 2, 1, 1, 1)
  TTT_INSTANCE(512, 10, 1, 0, 1, 1)
  TTT_INSTANCE(1024, 7, 2, 1, 1, 1)
  TTT_INSTANCE(1024, 7, 1, 0, 1, 1)
#undef TTT_INSTANCE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the instance the figures name (zq is zk only where zq and zk
// are one pointer).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for figures of no instance, or a width past the
// instance's threads times features a thread.
extern "C" int ttt_scan_launch(const void* zq, const void* zk, const void* c,
                               const void* m, const void* w0, const void* b0,
                               const void* eta, void* scores, void* w_f,
                               void* b_f, int N, int T, int f, int w0_stride,
                               int b0_stride, int nt, int fpt, int l,
                               int same, int minb, int pd, void* stream) {
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const Args g{static_cast<const float*>(zq), static_cast<const float*>(zk),
               static_cast<const float*>(c),  static_cast<const float*>(m),
               static_cast<const float*>(w0), static_cast<const float*>(b0),
               static_cast<const float*>(eta), static_cast<float*>(scores),
               static_cast<float*>(w_f),      static_cast<float*>(b_f),
               N, T, f, w0_stride, b0_stride,
               static_cast<cudaStream_t>(stream)};
  return with_instance(Figures{nt, fpt, l, same, minb, pd}, Launch{g});
}

// The instance's registers, shared and spill bytes (out[0..2], as Config).
extern "C" int ttt_scan_config(int nt, int fpt, int l, int same, int minb,
                               int pd, int* out) {
  return with_instance(Figures{nt, fpt, l, same, minb, pd}, Config{out});
}
