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
// What bounds it on the H100.  A causal prefill does 4 d flops of products
// per visible (query, key) pair and head against 2 d bytes per key and KV
// head: at the served lengths (16 to 160 tokens) the call is short and
// bounded by latency and launch; at 2,048 tokens it is the products.  On
// the CUDA cores in f32 those cost 67 TFLOP/s at best; the bf16 instance
// puts them on the tensor cores (attn_tile.cuh), where the f32 contract
// costs three P.V products per tile (p in three bf16 terms) and one Q.K^T
// (bf16 q is exact):
//   * one block of 4 warps per (64-row query tile, head, batch row), each
//     warp 16 rows, at most 168 registers a thread at d 64 so that 3
//     blocks share an SM (2 at d 128, whose output fragments take 32 more
//     registers and its K/V stages 68 KB of shared memory, and 2 at d 80,
//     whose 8 more registers of output and 4 of q would not fit 168
//     without spilling, at 44 KB of K/V stages); the G heads
//     of a KV head read its K/V tiles through L2.  One
//     block of 12 warps per KV head (each K/V tile loaded once for the G
//     heads) ran no faster on the card at any served shape and slower at
//     an admission's 16 rows: it fills a third as many SMs, and at 168
//     registers a thread only one such block fits an SM;
//   * query tiles are issued longest first (the last tile walks the most
//     keys), so the causal triangle's long blocks do not finish last;
//   * K and V tiles of 64 keys are double-buffered through cp.async (16
//     bytes a thread): the next tile is in flight while the current one is
//     computed; keys past Sk are zero-filled;
//   * the block walks 64-key tiles from the window's first key to the
//     causal limit of its last row, as attn_prefill_blockwise does
//     (repro/models/attention.py:814-821); a warp skips a tile none of its
//     rows sees, and the groups of 16 keys of a tile that none of its rows
//     sees (the causal diagonal, a ragged end); a tile all its rows see
//     fully skips the mask test;
//   * the online softmax (m, l, acc) of each row stays in f32 registers;
//     masked keys count exactly zero.
// What bounds it then is the tile body: per warp and tile 16 D / 8
// mma.sync (4 D / 8 for Q.K^T, 12 D / 8 for the three-term P.V, twice a
// bf16 flash kernel's), the exponentials and the splits, with the softmax
// between the two products.  Instances: d 64, d 128 and d 80
// (FLASH_INSTANCE below), each bf16 and f32, any G; their registers and spills stand in
// build.log (ptxas, sm_90a) and PERF.md.  The f32 instances (the f32
// check fleets only) keep the CUDA-core kernel below
// (flash_attention_f32_kernel); attn_tile.cuh says why.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

using attn_tile::Dims;
using attn_tile::kBK;       // keys per shared tile
using attn_tile::kNegInf;
constexpr int kMaxSmem = 227 * 1024;     // a block's shared memory on H100

// Dynamic shared memory past the default 48 KB: set the attribute once per
// kernel instance; refuse what a block cannot hold.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& configured) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

constexpr int kSlices = 4;                   // 16-row slices of a query tile
constexpr int kBQTC = 16 * kSlices;          // query rows per block
constexpr int kThreadsTC = 32 * kSlices;

template <int D>
__host__ __device__ constexpr int tc_smem_bytes() {
  return 2 * 2 * Dims<D>::kTileElems * 2;
}

// blocks an SM must hold: 3 at d 64 (168 registers a thread), 2 at d 80
// and d 128, whose output fragments and q take 12 and 48 registers more
template <int D>
__global__ void __launch_bounds__(kThreadsTC, D <= 64 ? 3 : 2)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                          int H, int n_kv, int causal, int window,
                          float scale) {
  using namespace attn_tile;
  constexpr int kRow = Dims<D>::kRow;
  constexpr int kTileElems = Dims<D>::kTileElems;
  constexpr int kWords = D / 8;          // 16-byte words of a bf16 row
  // two stages of a K and a V tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_kv = reinterpret_cast<__nv_bfloat16*>(smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQTC;   // longest first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (H / n_kv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qa = q0 + warp * 16;               // the warp's first row
  const int qb = min(qa + 15, Sq - 1);         // and its last real one
  const bool rows_ok = qa < Sq;
  const size_t q_row = static_cast<size_t>(H) * D;
  const size_t kv_row = static_cast<size_t>(n_kv) * D;
  const __nv_bfloat16* k_b = k + static_cast<size_t>(b) * Sk * kv_row +
                             kvh * D;
  const __nv_bfloat16* v_b = v + static_cast<size_t>(b) * Sk * kv_row +
                             kvh * D;

  // keys any row of this tile can see
  const int k_hi = causal ? min(Sk, q0 + kBQTC) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  auto stage_tile = [&](int kt, int st) {
    for (int i = tid; i < 2 * kBK * kWords; i += kThreadsTC) {
      const int which = i / (kBK * kWords), row = (i / kWords) % kBK;
      const int ch = i % kWords;
      const int key = kt + row;
      const bool ok = key < Sk;
      const size_t off = ok ? static_cast<size_t>(key) * kv_row + ch * 8 : 0;
      cp_async16(s_kv + (2 * st + which) * kTileElems + row * kRow + ch * 8,
                 (which ? v_b : k_b) + off, ok);
    }
  };

  int kt = k_lo;
  if (kt < k_hi) stage_tile(kt, 0);
  cp_async_commit();

  // the warp's 16 query rows as A fragments, straight from global
  QRegs<D, 1> qf;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = qa + (lane >> 2) + 8 * (reg & 1);
      const int col = kk * 16 + 2 * (lane & 3) + 8 * (reg >> 1);
      uint32_t x = 0u;
      if (row < Sq)
        x = __ldg(reinterpret_cast<const unsigned int*>(
            q + (static_cast<size_t>(b) * Sq + row) * q_row + head * D +
            col));
      qf.a[0][kk][reg] = x;
    }
  }

  RowState<D> st;
  st.init();
  auto score = [scale](int, float s) { return s * scale; };
  auto vfold = [](int) { return 1.f; };
  int stage = 0;
  for (; kt < k_hi; kt += kBK) {
    if (kt + kBK < k_hi) stage_tile(kt + kBK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile kt has landed (the next may be in flight)
    __syncthreads();
    const bool none = (causal && kt > qb) ||
                      (window > 0 && kt + kBK - 1 <= qa - window);
    if (rows_ok && !none) {
      const __nv_bfloat16* sK = s_kv + 2 * stage * kTileElems;
      const __nv_bfloat16* sV = sK + kTileElems;
      const bool full = kt + kBK <= Sk && (!causal || kt + kBK - 1 <= qa) &&
                        (window <= 0 || kt > qb - window);
      if (full) {
        auto keep = [](int, int) { return true; };
        tile_step<D, 1, false>(st, qf, 1, sK, sV, score, keep, vfold,
                               kBK / 16, lane);
      } else {
        const int k0 = kt;
        auto keep = [=](int row, int col) {
          const int kp = k0 + col, qp = qa + row;
          return kp < Sk && (!causal || kp <= qp) &&
                 (window <= 0 || kp > qp - window);
        };
        // groups of 16 keys past the warp's last row (causal) or past Sk
        // hold no key it sees
        const int last = causal ? min(qb, Sk - 1) : Sk - 1;
        const int live16 = min(kBK / 16, (last - kt) / 16 + 1);
        tile_step<D, 1, true>(st, qf, 1, sK, sV, score, keep, vfold, live16,
                              lane);
      }
    }
    __syncthreads();      // the stage is free for the tile after next
    stage ^= 1;
  }
  st.finish();
  if (!rows_ok) return;

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qa + (lane >> 2) + 8 * half;
    if (qpos >= Sq) continue;
    __nv_bfloat16* orow =
        out + (static_cast<size_t>(b) * Sq + qpos) * q_row + head * D;
    const float l = st.l[half];
#pragma unroll
    for (int j = 0; j < Dims<D>::kDTiles; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      float o0, o1;
      if (l > 0.f) {
        o0 = st.acc[j][2 * half] / l;
        o1 = st.acc[j][2 * half + 1] / l;
      } else {
        // no visible key: every score is the mask value, so the softmax is
        // uniform over all Sk keys (the einsum's and the Pallas body's answer)
        o0 = o1 = 0.f;
        for (int key = 0; key < Sk; ++key) {
          const __nv_bfloat16* vr = v_b + key * kv_row + c;
          o0 += __bfloat162float(vr[0]);
          o1 += __bfloat162float(vr[1]);
        }
        o0 /= static_cast<float>(Sk);
        o1 /= static_cast<float>(Sk);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
//   * one thread block per (tile of 16 query rows, head, batch row); 4
//     warps own 4 rows each; the tile's q rows sit in shared memory in f32,
//     pre-scaled by 1/sqrt(d);
//   * the block walks 64-key tiles as above, staging K and V in shared
//     memory (16-byte loads, K rows padded to D + 4 floats so that each
//     lane's float4 reads of its own key hit distinct banks), dynamic
//     shared memory: 37,888 bytes at d 64, 47,104 at d 80, 74,752 at
//     d 128;
//   * scores: lane j takes keys j and j + 32 of the tile for the warp's 4
//     rows at once; the online softmax (m, l, acc) of each row is carried
//     in registers: m warp-uniform, l per lane (summed at the end), acc as
//     the lane's output dims (F32Dims); P.V takes each key's p by shuffle.

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__host__ __device__ constexpr int f32_k_stride() { return D + 4; }

// The output dims a lane owns.  At d 64 and d 128 kDpl = D / 32 adjacent
// ones (2 or 4), read as float2 words; at d 80 (2.5 a lane) dims lane,
// lane + 32 and, for the half-warp of lanes under 16, lane + 64: one
// float a read, neighbouring lanes on neighbouring banks.
template <int D>
struct F32Dims {
  static constexpr bool kAdjacent = D % 64 == 0;
  static constexpr int kDpl = (D + 31) / 32;
  static_assert(kAdjacent ? kDpl == 2 || kDpl == 4 : D % 32 == 16,
                "a lane owns 2 or 4 adjacent dims, or two of 32 and half of "
                "16");
  __device__ __forceinline__ static int dim(int lane, int c) {
    return kAdjacent ? kDpl * lane + c : lane + 32 * c;
  }
  __device__ __forceinline__ static bool owns(int lane, int c) {
    return kAdjacent || lane + 32 * c < D;
  }
};

template <int D>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (kBQ * D + kBK * f32_k_stride<D>() + kBK * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Sk, int H,
                           int n_kv, int causal, int window, float scale) {
  using Lane = F32Dims<D>;
  constexpr int kDpl = Lane::kDpl;          // output dims a lane owns
  constexpr int kPer = 4;                   // floats per 16-byte load
  constexpr int kKStride = f32_k_stride<D>();
  extern __shared__ __align__(16) float fsmem[];
  float* s_q = fsmem;                       // [kBQ][D]
  float* s_k = s_q + kBQ * D;               // [kBK][kKStride]
  float* s_v = s_k + kBK * kKStride;        // [kBK][D]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / n_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_row = static_cast<size_t>(H) * D;     // between positions
  const size_t kv_row = static_cast<size_t>(n_kv) * D;
  const float* q_b = q + static_cast<size_t>(b) * Sq * q_row + h * D;
  const float* k_b = k + static_cast<size_t>(b) * Sk * kv_row + kvh * D;
  const float* v_b = v + static_cast<size_t>(b) * Sk * kv_row + kvh * D;

  for (int c = threadIdx.x; c < kBQ * D / kPer; c += kThreads) {
    const int r = c / (D / kPer), col = (c % (D / kPer)) * kPer;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq)
      t = __ldg(reinterpret_cast<const float4*>(q_b + (q0 + r) * q_row + col));
    s_q[r * D + col] = t.x * scale;
    s_q[r * D + col + 1] = t.y * scale;
    s_q[r * D + col + 2] = t.z * scale;
    s_q[r * D + col + 3] = t.w * scale;
  }

  // keys any row of this tile can see
  const int k_hi = causal ? min(Sk, q0 + kBQ) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int r0 = warp * kRowsPerWarp;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) acc[r][c] = 0.f;
  }

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done (and s_q set)
    for (int c = threadIdx.x; c < kBK * D / kPer; c += kThreads) {
      const int r = c / (D / kPer), col = (c % (D / kPer)) * kPer;
      float4 kt_ = make_float4(0.f, 0.f, 0.f, 0.f), vt_ = kt_;
      if (kt + r < Sk) {
        kt_ = __ldg(reinterpret_cast<const float4*>(k_b + (kt + r) * kv_row +
                                                    col));
        vt_ = __ldg(reinterpret_cast<const float4*>(v_b + (kt + r) * kv_row +
                                                    col));
      }
      *reinterpret_cast<float4*>(&s_k[r * kKStride + col]) = kt_;
      *reinterpret_cast<float4*>(&s_v[r * D + col]) = vt_;
    }
    __syncthreads();

    // scores of keys (kt + lane, kt + lane + 32) for the warp's rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; dd += 4) {
      const float4 ka =
          *reinterpret_cast<const float4*>(&s_k[lane * kKStride + dd]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&s_k[(lane + 32) * kKStride + dd]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&s_q[(r0 + r) * D + dd]);
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
#pragma unroll
      for (int c = 0; c < kDpl; ++c) acc[r][c] *= corr;
      m_run[r] = m_new;
    }

    // P.V: lane owns output dims Lane::dim(lane, c)
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      float va[kDpl], vb[kDpl];
      if constexpr (Lane::kAdjacent) {
#pragma unroll
        for (int c = 0; c < kDpl; c += 2) {
          const float2 x =
              *reinterpret_cast<const float2*>(&s_v[j * D + kDpl * lane + c]);
          const float2 y = *reinterpret_cast<const float2*>(
              &s_v[(j + 32) * D + kDpl * lane + c]);
          va[c] = x.x;
          va[c + 1] = x.y;
          vb[c] = y.x;
          vb[c + 1] = y.y;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kDpl; ++c) {
          const bool own = Lane::owns(lane, c);
          va[c] = own ? s_v[j * D + Lane::dim(lane, c)] : 0.f;
          vb[c] = own ? s_v[(j + 32) * D + Lane::dim(lane, c)] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pa = __shfl_sync(0xffffffffu, p[r][0], j);
        const float pb = __shfl_sync(0xffffffffu, p[r][1], j);
#pragma unroll
        for (int c = 0; c < kDpl; ++c)
          acc[r][c] = fmaf(pa, va[c], fmaf(pb, vb[c], acc[r][c]));
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
    float o[kDpl];
    if (l > 0.f) {
#pragma unroll
      for (int c = 0; c < kDpl; ++c) o[c] = acc[r][c] / l;
    } else {
      // no visible key: the mean of all Sk values, as above
#pragma unroll
      for (int c = 0; c < kDpl; ++c) o[c] = 0.f;
      for (int j = 0; j < Sk; ++j) {
        const float* vr = v_b + j * kv_row;
#pragma unroll
        for (int c = 0; c < kDpl; ++c)
          if (Lane::owns(lane, c)) o[c] += vr[Lane::dim(lane, c)];
      }
#pragma unroll
      for (int c = 0; c < kDpl; ++c) o[c] /= static_cast<float>(Sk);
    }
    float* orow = out + (static_cast<size_t>(b) * Sq + qpos) * q_row + h * D;
#pragma unroll
    for (int c = 0; c < kDpl; ++c)
      if (Lane::owns(lane, c)) orow[Lane::dim(lane, c)] = o[c];
  }
}

// One head-dim instance, both dtypes; any G (H a multiple of n_kv).
template <int D>
cudaError_t launch_instance(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Sk, int H,
                            int n_kv, int causal, int window, int dtype_code,
                            float scale, cudaStream_t st) {
  switch (dtype_code) {
    case 0: {
      static int configured = 48 * 1024;
      const cudaError_t err = allow_smem(flash_attention_f32_kernel<D>,
                                         f32_smem_bytes<D>(), configured);
      if (err != cudaSuccess) return err;
      const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
      flash_attention_f32_kernel<D>
          <<<grid, kThreads, f32_smem_bytes<D>(), st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H,
          n_kv, causal, window, scale);
      break;
    }
    case 1: {
      static int configured = 48 * 1024;
      const cudaError_t err = allow_smem(flash_attention_tc_kernel<D>,
                                         tc_smem_bytes<D>(), configured);
      if (err != cudaSuccess) return err;
      const dim3 grid((Sq + kBQTC - 1) / kBQTC, H, B);
      flash_attention_tc_kernel<D>
          <<<grid, kThreadsTC, tc_smem_bytes<D>(), st>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), Sq, Sk, H, n_kv, causal, window,
          scale);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
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
  if (n_kv <= 0 || H % n_kv != 0 || Sk <= 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instance set: kernels/flash_attention.py INSTANCES names the same
  // head dims (tests/test_torch_d128.py holds the two lists equal)
#define FLASH_INSTANCE(DD)                                                  \
  if (D == DD)                                                              \
    return static_cast<int>(launch_instance<DD>(q, k, v, out, B, Sq, Sk, H, \
                                                n_kv, causal, window,       \
                                                dtype_code, scale, st));
  FLASH_INSTANCE(64)
  FLASH_INSTANCE(128)
  FLASH_INSTANCE(80)
#undef FLASH_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
