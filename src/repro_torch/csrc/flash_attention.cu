// Flash prefill attention: blockwise causal / sliding-window GQA attention
// of a (B, Sq, H, d) query block against (B, Sk, KV, d) keys and values,
// normalised, in the query's dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:64
// flash_attention (body _kernel :24) for any Sq and Sk (the Pallas launcher
// asserts Sq % bq == 0).  Its mask: query i sees key j iff j <= i (causal,
// from key 0 also when Sk != Sq) and j > i - window (sliding window).  The
// contract is f32 throughout, what the JAX package's served prefill computes
// (einsum, repro/models/attention.py:733 attn_prefill_einsum): q, k and v
// are upcast, scores, softmax and P.V run in f32, and the output is cast to
// q's dtype.  A query row that sees no key at all (a window that ends
// before key 0 can reach it) gets the einsum's answer, the mean of all Sk
// values.  Plain PyTorch version: repro_torch/kernels/flash_attention.py
// attn_prefill_einsum.
//
// Bound on the H100: f32 operations at the served prefill shapes (4 d
// flops per visible (query, key) pair against 2 d bytes per key and head).
// The design is the simplest tiled online softmax, without tensor cores:
//   * one thread block per (tile of 16 query rows, head, batch row); 4
//     warps own 4 rows each; the tile's q rows sit in shared memory in f32,
//     pre-scaled by 1/sqrt(d) (a power of two at d 64: exact);
//   * the block walks 64-key tiles from the window's first key to the
//     causal limit of its last row, as attn_prefill_blockwise does
//     (repro/models/attention.py:814-821), staging K and V in shared
//     memory in f32 (16-byte loads, K rows padded to 68 floats so that
//     each lane's float4 reads of its own key hit distinct banks);
//   * scores: lane j takes keys j and j + 32 of the tile for the warp's 4
//     rows at once, so each K read feeds 4 rows and each q read 2 keys;
//   * the online softmax (m, l, acc) of each row is carried in registers:
//     m warp-uniform, l per lane (summed at the end), acc as the lane's two
//     output dims; P.V takes each key's p from its lane by shuffle;
//   * masked keys count exactly zero.
// Tensor cores (the f32 contract rules out bf16 wgmma as it stands), loads
// kept in flight across tiles and wider tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 64;                     // keys per shared tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of type T at p -> f32 at out (4 or 8 values)
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p,
                                       float* __restrict__ out) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[i] = to_float(e[i]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int n_kv, int causal, int window,
                       float scale) {
  static_assert(D == 2 * 32, "a lane owns two output dims");
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kKStride = D + 4;
  __shared__ __align__(16) float s_q[kBQ][D];
  __shared__ __align__(16) float s_k[kBK][kKStride];
  __shared__ __align__(16) float s_v[kBK][D];

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / n_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_row = static_cast<size_t>(H) * D;     // between positions
  const size_t kv_row = static_cast<size_t>(n_kv) * D;
  const T* q_b = q + static_cast<size_t>(b) * Sq * q_row + h * D;
  const T* k_b = k + static_cast<size_t>(b) * Sk * kv_row + kvh * D;
  const T* v_b = v + static_cast<size_t>(b) * Sk * kv_row + kvh * D;

  for (int c = threadIdx.x; c < kBQ * D / kPer; c += kThreads) {
    const int r = c / (D / kPer), col = (c % (D / kPer)) * kPer;
    float tmp[kPer];
    if (q0 + r < Sq) {
      load16<T>(q_b + (q0 + r) * q_row + col, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) s_q[r][col + i] = tmp[i] * scale;
  }

  // keys any row of this tile can see
  const int k_hi = causal ? min(Sk, q0 + kBQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int r0 = warp * kRowsPerWarp;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done (and s_q set)
    for (int c = threadIdx.x; c < kBK * D / kPer; c += kThreads) {
      const int r = c / (D / kPer), col = (c % (D / kPer)) * kPer;
      float kt_[kPer], vt_[kPer];
      if (kt + r < Sk) {
        load16<T>(k_b + (kt + r) * kv_row + col, kt_);
        load16<T>(v_b + (kt + r) * kv_row + col, vt_);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) kt_[i] = vt_[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s_k[r][col + i] = kt_[i];
        s_v[r][col + i] = vt_[i];
      }
    }
    __syncthreads();

    // scores of keys (kt + lane, kt + lane + 32) for the warp's rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; dd += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&s_k[lane][dd]);
      const float4 kb = *reinterpret_cast<const float4*>(&s_k[lane + 32][dd]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&s_q[r0 + r][dd]);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kb, s[r][1]);
      }
    }

    float p[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + r0 + r;
      float mx = kNegInf;
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kt + lane + 32 * c;
        ok[c] = kpos < Sk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        if (!ok[c]) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float corr = expf(m_run[r] - m_new);
#pragma unroll
      for (int c = 0; c < 2; ++c) p[r][c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
      l_run[r] = l_run[r] * corr + p[r][0] + p[r][1];
      acc[r][0] *= corr;
      acc[r][1] *= corr;
      m_run[r] = m_new;
    }

    // P.V: lane owns output dims (2 lane, 2 lane + 1)
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float2 va = *reinterpret_cast<const float2*>(&s_v[j][2 * lane]);
      const float2 vb =
          *reinterpret_cast<const float2*>(&s_v[j + 32][2 * lane]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pa = __shfl_sync(0xffffffffu, p[r][0], j);
        const float pb = __shfl_sync(0xffffffffu, p[r][1], j);
        acc[r][0] = fmaf(pa, va.x, fmaf(pb, vb.x, acc[r][0]));
        acc[r][1] = fmaf(pa, va.y, fmaf(pb, vb.y, acc[r][1]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + r0 + r;
    float l = l_run[r];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (qpos >= Sq) continue;
    float o0, o1;
    if (l > 0.f) {
      o0 = acc[r][0] / l;
      o1 = acc[r][1] / l;
    } else {
      // no visible key: every score is the mask value, so the softmax is
      // uniform over all Sk keys (the einsum's and the Pallas body's answer)
      o0 = o1 = 0.f;
      for (int j = 0; j < Sk; ++j) {
        const T* vr = v_b + j * kv_row + 2 * lane;
        o0 += to_float(vr[0]);
        o1 += to_float(vr[1]);
      }
      o0 /= static_cast<float>(Sk);
      o1 /= static_cast<float>(Sk);
    }
    T* orow = out + (static_cast<size_t>(b) * Sq + qpos) * q_row + h * D;
    store(orow + 2 * lane, o0);
    store(orow + 2 * lane + 1, o1);
  }
}

// The one head dim instantiated, and held against the plain version on the
// card: d_head 64 (smollm-360m).  Other head dims are refused (ROADMAP A7
// brings them).
constexpr int kHeadDim = 64;

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int n_kv,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, kHeadDim><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, n_kv,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out alike); window
// 0 = none.  Returns cudaGetLastError() after launch, or
// cudaErrorInvalidValue for a shape or dtype that is not instantiated.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int n_kv, int D,
                                      int causal, int window, int dtype_code,
                                      float scale, void* stream) {
  if (D != kHeadDim || n_kv <= 0 || H % n_kv != 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0:
      err = launch_typed<float>(q, k, v, out, B, Sq, Sk, H, n_kv, causal,
                                window, scale, st);
      break;
    case 1:
      err = launch_typed<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, n_kv,
                                        causal, window, scale, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
