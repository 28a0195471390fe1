// RWKV6 WKV recurrence (K8), per (batch row, head):
//   out_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T
// r, k, v (B, T, H, D) f32 or bf16 (one dtype for the three, widened on
// load, exactly as a cast); w (B, T, H, D) f32; u (H, D) f32; s0 (B, H, D,
// D) f32, row i = key channel, column j = value channel.  Returns out (B,
// T, H, D) f32 and the final state, written to s_out, which may be s0
// itself (every block reads its own state slice before it writes it).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py:53 wkv_scan (body
// _kernel :23).  That kernel walks a (B, H, T/ct) grid in order with the
// state in VMEM scratch and pads T with w = 1; here a loop inside the block
// takes the place of the sequential grid axis, and a short last chunk
// takes the place of the padding.  Plain PyTorch version:
// repro_torch/kernels/rwkv6_scan.py wkv_scan_plain (the loop of
// repro/models/rwkv6.py:90); the schedule below is mirrored step for step
// by wkv_scan_blocked_plain there.
//
// Bound on the H100: bytes at the served decode step (T = 1: the state's
// 2 x D^2 floats a head are nearly all the bytes), f32 operations for a
// long prompt (7 D^2 a step and head).  The recurrence is sequential in T,
// and the design keeps every step off barriers and loads:
//   * grid (B H, n_col): a block owns all D rows of D / n_col value
//     columns, so a (1, T) prompt runs 128 blocks, not 32 (the state
//     update is elementwise and the columns are independent; n_col from
//     kernels/rwkv6_scan.py col_split, 1 where B H already fills the card);
//   * 256 threads; thread (g, j) holds rows g R .. g R + R - 1 of column j
//     in registers (R = 16 / n_col) and updates them in the plain
//     version's order: kv = k_i v_j, acc += r_i (u_i kv + S), S = w_i S +
//     kv;
//   * inputs are staged C steps at a time (r, k, w whole, v the block's
//     columns) through cp.async into a double-buffered ring: chunk c + 1 is
//     in flight while chunk c computes; the steps of a chunk are unrolled
//     (2 at 16 rows a thread, 8 at fewer) so that their shared loads
//     overlap;
//   * the output's sum over rows is taken off the chain: each thread writes
//     its partial of out_t[j] for every step of the chunk to shared memory,
//     and after the chunk's one barrier the partials of the previous chunk
//     are summed over the row groups (the same order for every t, whatever
//     chunk t falls in) and stored, coalesced.  One __syncthreads a chunk,
//     none a step.
// No chunked (matrix-product, GLA-style) form: it factors the decay into
// cumulative products over a chunk, which under- and overflow f32 for the
// decays near 0 that the model makes (w ~ 2e-9 at two standard deviations
// of chip_smoke.py's "near 0" inputs), and it needs a logarithm of a w that
// can be 0.  The step form above is bounded by the f32 issue rate instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // the head dim instantiated
constexpr int kMaxSmem = 227 * 1024;

// threads a block; a thread holds R = kD NC / kThreads rows of one of the
// block's NC = kD / n_col columns
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bf16 travels as its raw 16 bits: widening is a shift, exact as a cast
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ float lo_bf16(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// R consecutive values (R 2 or a multiple of 4; aligned to R values) from
// shared memory, as f32
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&o)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = x.x;
      o[4 * q + 1] = x.y;
      o[4 * q + 2] = x.z;
      o[4 * q + 3] = x.w;
    }
  } else {
    static_assert(R == 2, "rows a thread: 2 or a multiple of 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  }
}
template <int R>
__device__ __forceinline__ void load_rows(const uint16_t* p, float (&o)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      o[4 * q] = lo_bf16(x.x);
      o[4 * q + 1] = hi_bf16(x.x);
      o[4 * q + 2] = lo_bf16(x.y);
      o[4 * q + 3] = hi_bf16(x.y);
    }
  } else {
    static_assert(R == 2, "rows a thread: 2 or a multiple of 4");
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    o[0] = lo_bf16(x);
    o[1] = hi_bf16(x);
  }
}

// One stage of the ring: C steps of r, k (In), w (f32), v (In, the
// block's NC columns) and the partials (f32, one per thread and step).
// Every part's size is a multiple of 16 bytes.
template <int NCOL, typename In>
struct Stage {
  static constexpr int NC = kD / NCOL;
  __host__ __device__ static size_t bytes(int C) {
    return static_cast<size_t>(C) *
           (2 * kD * sizeof(In) + kD * sizeof(float) + NC * sizeof(In) +
            kThreads * sizeof(float));
  }
  In* r;
  In* k;
  float* w;
  In* v;
  float* part;
  __device__ Stage(unsigned char* base, int C) {
    r = reinterpret_cast<In*>(base);
    k = r + C * kD;
    w = reinterpret_cast<float*>(k + C * kD);
    v = reinterpret_cast<In*>(w + C * kD);
    part = reinterpret_cast<float*>(v + C * NC);
  }
};

template <int NCOL, typename In>
__global__ void __launch_bounds__(kThreads)
wkv_scan_kernel(const In* __restrict__ r, const In* __restrict__ k,
                const In* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ out, float* s_out, int T, int H, int C) {
  constexpr int NC = kD / NCOL;        // value columns of this block
  constexpr int NG = kThreads / NC;    // row groups
  constexpr int R = kD / NG;           // rows a thread holds
  constexpr int EV = 16 / sizeof(In);  // elements of r, k, v per 16 bytes
  constexpr int PR = kD / EV;          // 16-byte pieces of an r or k step
  constexpr int PW = kD / 4;           // of a w step
  constexpr int PV = NC / EV;          // of the block's v columns
  // steps unrolled: short rows leave registers to overlap steps
  constexpr int kUnroll = R >= 16 ? 2 : 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int col0 = blockIdx.y * NC;
  const int tid = threadIdx.x;
  const int jj = tid % NC, g = tid / NC, i0 = g * R;
  const size_t step_stride = static_cast<size_t>(H) * kD;
  const size_t head = (static_cast<size_t>(b) * T * H + h) * kD;
  const size_t stage_bytes = Stage<NCOL, In>::bytes(C);
  const int n_chunks = (T + C - 1) / C;

  // chunk c's inputs into stage s, left in flight: each vector a grid of
  // steps x 16-byte pieces
  auto stage_in = [&](int c, int s) {
    Stage<NCOL, In> st(smem + s * stage_bytes, C);
    const int steps = min(C, T - c * C);
    const size_t at = head + static_cast<size_t>(c) * C * step_stride;
    for (int p = tid; p < steps * PR; p += kThreads) {
      const int tl = p / PR, e = (p % PR) * EV;
      const size_t src = at + static_cast<size_t>(tl) * step_stride + e;
      cp_async16(st.r + tl * kD + e, r + src);
      cp_async16(st.k + tl * kD + e, k + src);
    }
    for (int p = tid; p < steps * PW; p += kThreads) {
      const int tl = p / PW, e = (p % PW) * 4;
      cp_async16(st.w + tl * kD + e,
                 w + at + static_cast<size_t>(tl) * step_stride + e);
    }
    for (int p = tid; p < steps * PV; p += kThreads) {
      const int tl = p / PV, e = (p % PV) * EV;
      cp_async16(st.v + tl * NC + e,
                 v + at + static_cast<size_t>(tl) * step_stride + col0 + e);
    }
    cp_async_commit();
  };

  // the sum over row groups of chunk c's partials (stage s), stored
  auto store_out = [&](int c, int s) {
    Stage<NCOL, In> st(smem + s * stage_bytes, C);
    const int t0 = c * C;
    const int steps = min(C, T - t0);
    for (int e = tid; e < steps * NC; e += kThreads) {
      const int tl = e / NC, j = e % NC;
      const float* p = st.part + tl * kThreads + j;
      float acc = p[0];
#pragma unroll
      for (int gg = 1; gg < NG; ++gg) acc += p[gg * NC];
      out[head + static_cast<size_t>(t0 + tl) * step_stride + col0 + j] =
          acc;
    }
  };

  if (n_chunks > 0) stage_in(0, 0);

  // the state slice and u, into registers while chunk 0 lands
  const size_t state =
      (static_cast<size_t>(b) * H + h) * kD * kD + col0 + jj;
  float S[R], uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    S[i] = s0[state + static_cast<size_t>(i0 + i) * kD];
    uu[i] = u[static_cast<size_t>(h) * kD + i0 + i];
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    // the chunk's one barrier: chunk c's inputs and chunk c - 1's partials
    // are visible; every thread is done with the stage written next (read
    // by chunk c - 1's steps and by chunk c - 2's sum)
    __syncthreads();
    if (c + 1 < n_chunks) stage_in(c + 1, (c + 1) & 1);
    if (c > 0) store_out(c - 1, (c - 1) & 1);

    Stage<NCOL, In> st(smem + (c & 1) * stage_bytes, C);
    const int steps = min(C, T - c * C);
#pragma unroll kUnroll
    for (int tl = 0; tl < steps; ++tl) {
      float rr[R], kk[R], ww[R];
      load_rows<R>(st.r + tl * kD + i0, rr);
      load_rows<R>(st.k + tl * kD + i0, kk);
      load_rows<R>(st.w + tl * kD + i0, ww);
      const float vj = widen(st.v[tl * NC + jj]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float kv = kk[i] * vj;
        acc += rr[i] * (uu[i] * kv + S[i]);
        S[i] = ww[i] * S[i] + kv;
      }
      st.part[tl * kThreads + tid] = acc;
    }
  }
  if (n_chunks > 0) {
    __syncthreads();
    store_out(n_chunks - 1, (n_chunks - 1) & 1);
  }

#pragma unroll
  for (int i = 0; i < R; ++i)
    s_out[state + static_cast<size_t>(i0 + i) * kD] = S[i];
}

template <int NCOL, typename In>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_out, int B,
           int T, int H, int C, cudaStream_t stream) {
  const size_t smem = (T > C ? 2 : 1) * Stage<NCOL, In>::bytes(C);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kern = wkv_scan_kernel<NCOL, In>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(B * H, NCOL), kThreads, smem, stream>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_out), T, H, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_cols(int n_col, const void* r, const void* k, const void* v,
                const void* w, const void* u, const void* s0, void* out,
                void* s_out, int B, int T, int H, int C,
                cudaStream_t stream) {
  switch (n_col) {
    case 1: return launch<1, In>(r, k, v, w, u, s0, out, s_out, B, T, H, C,
                                 stream);
    case 2: return launch<2, In>(r, k, v, w, u, s0, out, s_out, B, T, H, C,
                                 stream);
    case 4: return launch<4, In>(r, k, v, w, u, s0, out, s_out, B, T, H, C,
                                 stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename In>
const void* kernel_of(int n_col) {
  switch (n_col) {
    case 1: return reinterpret_cast<const void*>(wkv_scan_kernel<1, In>);
    case 2: return reinterpret_cast<const void*>(wkv_scan_kernel<2, In>);
    case 4: return reinterpret_cast<const void*>(wkv_scan_kernel<4, In>);
    default: return nullptr;
  }
}

template <typename In>
size_t ring_stage_bytes(int n_col, int chunk) {
  return n_col == 1   ? Stage<1, In>::bytes(chunk)
         : n_col == 2 ? Stage<2, In>::bytes(chunk)
                      : Stage<4, In>::bytes(chunk);
}

}  // namespace

// in_dtype: 0 f32, 1 bf16 (r, k and v); n_col in {1, 2, 4}; chunk the
// steps staged at a time (1 <= chunk, and the ring within 227 KB).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head dim, dtype, split or chunk that is not instantiated.
extern "C" int wkv_scan_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* out, void* s_out, int B, int T, int H,
                               int D, int in_dtype, int n_col, int chunk,
                               void* stream) {
  if (D != kD || chunk < 1) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return launch_cols<float>(n_col, r, k, v, w, u, s0, out, s_out, B, T, H,
                              chunk, s);
  if (in_dtype == 1)
    return launch_cols<uint16_t>(n_col, r, k, v, w, u, s0, out, s_out, B, T,
                                 H, chunk, s);
  return cudaErrorInvalidValue;
}

// The instance's figures: out[0] registers a thread, out[1] static shared
// bytes, out[2] local (spill) bytes a thread, out[3] dynamic shared bytes
// of a launch with `chunk` steps staged and more than one chunk.
extern "C" int wkv_scan_config(int in_dtype, int n_col, int chunk,
                               int* out) {
  const void* fn = in_dtype == 0   ? kernel_of<float>(n_col)
                   : in_dtype == 1 ? kernel_of<uint16_t>(n_col)
                                   : nullptr;
  if (fn == nullptr || chunk < 1) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(2 * (in_dtype == 0
                                     ? ring_stage_bytes<float>(n_col, chunk)
                                     : ring_stage_bytes<uint16_t>(n_col, chunk)));
  return 0;
}
