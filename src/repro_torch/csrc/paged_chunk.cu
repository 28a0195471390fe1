// Paged chunk attention: the query tokens of a prefill chunk, each against
// the KV pages of its own segment (request), read through that segment's
// block table.  Returns the UNNORMALISED online-softmax partials (o, l, m)
// per token, so the caller folds in the chunk's own keys (causal within a
// segment) before normalising.
//
// Replaces two TPU kernels with one launcher:
//   * repro/kernels/decode_attention.py:298 paged_flash_packed_chunk — N
//     tokens, a segment id per token, per-segment tables and validity rows;
//   * repro/kernels/decode_attention.py:265 paged_flash_prefill_chunk — B
//     requests of C tokens each: the same with N = B*C, segment = token / C
//     (``seg`` null, ``seg_div`` = C), tables and validity per request.
// Both Pallas functions run _paged_kernel (:113) through _paged_attend
// (:164).  Plain PyTorch versions: repro_torch/kernels/paged_chunk.py
// paged_packed_chunk_plain and paged_prefill_chunk_plain (and
// merge_split_partials_plain for the split-KV merge).
//
// What bounds it on the H100.  A segment's pages are needed once for all
// of its tokens, and each position costs 4 d flops of products per query
// row: on the tensor cores (989 TFLOP/s in bf16) the served chunk's bound
// is its bytes, a fraction of a microsecond.  What a served call really
// waits on is latency: a few dozen blocks, each a chain of index lookups,
// page loads and products.  The design shortens that chain:
//   * one block per (tile of 16 query tokens, KV head, segment, split);
//     warp g owns the tile's 16 rows of query head g of the KV head (G = 3
//     for smollm-360m and llama3.2-3b: 3 warps; G = 1 for qwen1.5-32b and
//     stablelm-3b: 4 warps, the three beside the head's warp only staging
//     tiles).  A block whose tile holds no token of its segment exits at
//     once, so every output row is written exactly once, by its own
//     segment's block;
//   * index setup once per block: the segment's validity row and block-
//     table row come into shared memory in one coalesced pass; from them
//     the block marks the 64-position tiles holding a valid position (and
//     those holding only valid ones) and finds the first and last such
//     tile.  It walks only live tiles between them, never the whole row;
//   * loads in flight: the next live tile's K and V rows are issued with
//     cp.async (16 bytes a thread, addresses from the shared table, so no
//     dependent global load) before the current tile is computed, into a
//     double-buffered ring; invalid positions are zero-filled, not read;
//   * the tile body is attn_tile.cuh: Q.K^T and P.V on the tensor cores
//     (mma.sync m16n8k16, bf16 in, f32 accumulate), q and p split into
//     three bf16 terms so the result is the f32 one; at d 128 each warp's
//     three q terms sit in shared memory (ChunkQ: QShared), read through
//     ldmatrix a k-step at a time, so its registers hold the output
//     fragments and not 96 words of q (at d 64 and d 80 they stay in
//     registers, QRegs: 48 and 60 words).  int8 pages land raw in the ring
//     and are converted exactly to bf16 in shared memory after the wait;
//     k_scale multiplies the score, v_scale is folded into p;
//   * split-KV: past 256 virtual positions (kernels/paged_chunk.py
//     split_count; the wrapper passes n_split > 1) the live range is cut
//     into n_split equal runs of tiles, one block each, writing partials
//     to the wrapper's scratch; the same launcher then runs the merge
//     that K2 and K6 share (split_merge.cuh), by the log-sum-exp rule.  A
//     split with no live tile writes the empty partials, so a row with no
//     valid position in any split still comes out m = -1e30, l = 0,
//     o = 0.  At the served shapes (<= 256 positions) there is one launch
//     and no merge;
//   * a token's segment id is clamped into [0, R), as the JAX gather
//     clamps; padding tokens carry the last segment's id and so get its
//     partials, as in JAX.
// f32 pages (the f32 check fleets only) keep the CUDA-core kernel below
// (paged_chunk_f32_kernel), which walks the row in tiles of 16 positions
// with the products in f32; attn_tile.cuh says why.
// Instances: (d, G) = (64, 3), (128, 3), (128, 1), (80, 1), (64, 2),
// (128, 4) and (128, 7) (CHUNK_INSTANCE below), each for f32, bf16 and
// int8 pages.  Shared memory of a bf16 block: two stages of K and V tiles
// (36,864 bytes at d 64, 45,056 at d 80, 69,632 at d 128; int8 one bf16
// stage plus two raw stages and the scales), at d 128 G x 3 x 16 rows of
// q terms (13,056 bytes a warp: 91,392 at G 7, whose block of 7 warps
// then takes about 161 KB, set by cudaFuncSetAttribute in launch_tc), the
// validity row, table row and tile flags.  At d 80 a
// bf16 row is ten 16-byte words (an int8 row five), each cp.async word
// aligned at the 160-byte (80-byte) page row and the 176-byte shared
// row.  Registers and spills of every instance: build.log (ptxas,
// sm_90a) and PERF.md.  At the served chunk
// the block count and each block's chain of setup, first tile load and
// two tiles bound the call, not registers or occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"
#include "split_merge.cuh"

namespace {

using attn_tile::Dims;
using attn_tile::kBK;
using attn_tile::kNegInf;

constexpr int kTokens = 16;               // query tokens per block
constexpr int kMaxSmem = 227 * 1024;      // a block's shared memory on H100

__device__ __forceinline__ int segment_of(const int* __restrict__ seg,
                                          int seg_div, int n, int n_seg) {
  const int s = seg != nullptr ? seg[n] : n / seg_div;
  return min(max(s, 0), n_seg - 1);
}

// ---------------------------------------------------------------------------
// bf16 and int8 pages: the tensor-core kernel, one warp per query head of
// the KV head (G warps a block)

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Where a warp's three q terms live, per head dim: at d 64 and d 80 in
// registers (48 and 60 words a thread, beside 32 and 40 of output
// fragments: no ldmatrix of q on a tile's chain, no shared rows to fill),
// at d 128 in shared memory (in registers they would take 96, beside 64
// of output fragments).
template <int D>
struct ChunkQ {
  static constexpr bool kShared = D > 80;
  using type = typename std::conditional<kShared, attn_tile::QShared<D>,
                                         attn_tile::QRegs<D, 3>>::type;
};

// Warps a block: one a query head of the KV head; at G 1 four, the three
// beside the head's warp sharing the staging of the K/V tiles and the
// int8 conversion (they own no rows).
template <int G>
__host__ __device__ constexpr int chunk_warps() { return G == 1 ? 4 : G; }

// byte offsets into the dynamic shared memory of one block
struct ChunkSmem {
  int ring;     // bf16 K/V tiles: two stages (bf16 pages) or one (int8)
  int raw;      // int8: two stages of raw K/V rows, D bytes each
  int scales;   // int8: two stages of k_scale and v_scale, 64 each
  int q;        // d 128: each head warp's 16 query rows in three terms
  int valid;    // the segment's validity row, padded to whole tiles
  int table;    // the segment's block-table row
  int any;      // per 64-position tile: holds a valid position
  int all;      // per tile: every position valid
  int total;
};

template <int D, int G>
__host__ __device__ inline ChunkSmem chunk_smem(bool int8, int n_pos,
                                                int nb) {
  const int n_kt = (n_pos + kBK - 1) / kBK;
  const int tile_pair = 2 * Dims<D>::kTileElems * 2;   // K and V, bytes
  ChunkSmem s{};
  int off = 0;
  s.ring = off;
  off += (int8 ? 1 : 2) * tile_pair;
  s.raw = off;
  if (int8) off += 2 * 2 * kBK * D;
  s.scales = off;
  if (int8) off += 2 * 2 * kBK * 4;
  s.q = off;
  if (ChunkQ<D>::kShared) off += G * 3 * 16 * Dims<D>::kRow * 2;
  s.valid = off;
  off += n_kt * kBK;
  s.table = off;
  off += round16(nb * 4);
  s.any = off;
  off += round16(n_kt);
  s.all = off;
  off += round16(n_kt);
  s.total = off;
  return s;
}

template <int D, int G, bool kInt8>
__global__ void __launch_bounds__(32 * chunk_warps<G>())
paged_chunk_tc_kernel(const float* __restrict__ q, const int* __restrict__ seg,
                      int seg_div, const void* __restrict__ k_pages,
                      const void* __restrict__ v_pages,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,
                      const bool* __restrict__ valid, float* __restrict__ o,
                      float* __restrict__ l_out, float* __restrict__ m_out,
                      int n_tok, int n_seg, int n_kv, int bs, int nb,
                      int n_split, float scale) {
  using namespace attn_tile;
  constexpr int kThreads = 32 * chunk_warps<G>();
  constexpr int kRow = Dims<D>::kRow;
  constexpr int kTileElems = Dims<D>::kTileElems;
  constexpr int kWords = D / 8;          // 16-byte words of a bf16 row
  constexpr int kWords8 = D / 16;        // of an int8 row (5 at d 80)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool s_act[kTokens];
  __shared__ int s_first, s_last;

  const int tile = blockIdx.x, kv = blockIdx.y;
  const int r = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_pos = nb * bs, n_kt = (n_pos + kBK - 1) / kBK;
  const ChunkSmem L = chunk_smem<D, G>(kInt8, n_pos, nb);

  // the tile's tokens that belong to segment r
  bool mine = false;
  if (tid < kTokens) {
    const int n = tile * kTokens + tid;
    mine = n < n_tok && segment_of(seg, seg_div, n, n_seg) == r;
    s_act[tid] = mine;
  }
  if (tid == 0) {
    s_first = n_kt;
    s_last = -1;
  }
  if (!__syncthreads_or(mine)) return;

  // index setup: validity and table rows into shared memory, live tiles
  unsigned char* s_valid = smem + L.valid;
  int* s_table = reinterpret_cast<int*>(smem + L.table);
  unsigned char* s_any = smem + L.any;
  unsigned char* s_all = smem + L.all;
  {
    const bool* valid_row = valid + static_cast<size_t>(r) * n_pos;
    const int* table_row = tables + static_cast<size_t>(r) * nb;
    if (n_pos % 16 == 0 && reinterpret_cast<uintptr_t>(valid_row) % 16 == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(valid_row);
      for (int i = tid; i < n_pos / 16; i += kThreads)
        reinterpret_cast<uint4*>(s_valid)[i] = __ldg(src + i);
    } else {
      for (int i = tid; i < n_pos; i += kThreads)
        s_valid[i] = valid_row[i] ? 1 : 0;
    }
    for (int i = n_pos + tid; i < n_kt * kBK; i += kThreads) s_valid[i] = 0;
    for (int i = tid; i < nb; i += kThreads) s_table[i] = __ldg(table_row + i);
  }
  __syncthreads();
  for (int t = tid; t < n_kt; t += kThreads) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s_valid + t * kBK);
    uint32_t any = 0;
    bool all = true;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      any |= w[i];
      all = all && w[i] == 0x01010101u;
    }
    s_any[t] = any != 0;
    s_all[t] = all;
    if (any) {
      atomicMin(&s_first, t);
      atomicMax(&s_last, t);
    }
  }
  __syncthreads();

  // this split's run of tiles: the live range cut into n_split equal runs
  int lo = 0, hi = 0;
  if (s_last >= s_first) {
    const int per = (s_last - s_first + n_split) / n_split;
    lo = s_first + split * per;
    hi = min(lo + per, s_last + 1);
  }
  auto next_live = [&](int t) {
    while (t < hi && !s_any[t]) ++t;
    return t;
  };

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + L.raw);
  float* s_scale = reinterpret_cast<float*>(smem + L.scales);

  // issue the K and V rows of tile t into ring stage st, in flight
  auto stage_tile = [&](int t, int st) {
    const int base = t * kBK;
    if constexpr (!kInt8) {
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_pages);
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_pages);
      __nv_bfloat16* dst = ring + st * 2 * kTileElems;
      for (int i = tid; i < 2 * kBK * kWords; i += kThreads) {
        const int which = i / (kBK * kWords), row = (i / kWords) % kBK;
        const int ch = i % kWords;
        const int p = base + row;
        const bool ok = s_valid[p] != 0;
        size_t off = 0;
        if (ok)
          off = ((static_cast<size_t>(s_table[p / bs]) * n_kv + kv) * bs +
                 p % bs) * D + ch * 8;
        cp_async16(dst + which * kTileElems + row * kRow + ch * 8,
                   (which ? vp : kp) + off, ok);
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(k_pages);
      const int8_t* vp = static_cast<const int8_t*>(v_pages);
      int8_t* dst = raw + st * 2 * kBK * D;
      for (int i = tid; i < 2 * kBK * kWords8; i += kThreads) {
        const int which = i / (kBK * kWords8), row = (i / kWords8) % kBK;
        const int ch = i % kWords8;
        const int p = base + row;
        const bool ok = s_valid[p] != 0;
        size_t off = 0;
        if (ok)
          off = ((static_cast<size_t>(s_table[p / bs]) * n_kv + kv) * bs +
                 p % bs) * D + ch * 16;
        cp_async16(dst + which * kBK * D + row * D + ch * 16,
                   (which ? vp : kp) + off, ok);
      }
      float* sdst = s_scale + st * 2 * kBK;
      for (int i = tid; i < 2 * kBK; i += kThreads) {
        const int which = i / kBK, row = i % kBK;
        const int p = base + row;
        const bool ok = s_valid[p] != 0;
        size_t off = 0;
        if (ok)
          off = (static_cast<size_t>(s_table[p / bs]) * n_kv + kv) * bs +
                p % bs;
        cp_async4(sdst + i, (which ? v_scale : k_scale) + off, ok);
      }
    }
  };

  int t = next_live(lo);
  if (t < hi) stage_tile(t, 0);
  cp_async_commit();

  // every warp owns a query head unless the block has staging warps (G 1)
  const bool head_warp = chunk_warps<G>() == G || warp < G;
  // the warp's 16 query rows (head kv*G + warp), pre-scaled, in three bf16
  // terms, from global into its A fragments (in registers, or in its rows
  // of shared memory, each lane writing the words its own fragments read)
  // while tile t is in flight
  typename ChunkQ<D>::type qf;
  int q_live = 1;
  if (head_warp) {
    __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem + L.q) +
                         warp * 3 * 16 * kRow;
    const int n_heads = n_kv * G;
    bool nz1 = false, nz2 = false;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int tk = (lane >> 2) + 8 * (reg & 1);
        const int col = kk * 16 + 2 * (lane & 3) + 8 * (reg >> 1);
        float2 x = make_float2(0.f, 0.f);
        if (s_act[tk]) {
          const int n = tile * kTokens + tk;
          x = __ldg(reinterpret_cast<const float2*>(
              q + (static_cast<size_t>(n) * n_heads + kv * G + warp) * D +
              col));
        }
        uint32_t terms[3];
        split3_pair(x.x * scale, x.y * scale, terms);
#pragma unroll
        for (int tt = 0; tt < 3; ++tt) {
          if constexpr (ChunkQ<D>::kShared)
            *reinterpret_cast<uint32_t*>(
                s_q + QShared<D>::offset(tt, kk, lane, reg)) = terms[tt];
          else
            qf.a[tt][kk][reg] = terms[tt];
        }
        nz1 = nz1 || terms[1] != 0u;
        nz2 = nz2 || terms[2] != 0u;
      }
    }
    q_live = __any_sync(0xffffffffu, nz2) ? 3
             : __any_sync(0xffffffffu, nz1) ? 2 : 1;
    if constexpr (ChunkQ<D>::kShared) {
      __syncwarp();
      qf.base = s_q;
    }
  }

  RowState<D> st;
  st.init();
  int stage = 0;
  while (t < hi) {
    const int tn = next_live(t + 1);
    if (tn < hi) stage_tile(tn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed (tile tn may be in flight)
    __syncthreads();
    const unsigned char* vrow = s_valid + t * kBK;
    auto keep = [vrow](int, int col) { return vrow[col] != 0; };
    const bool full = s_all[t] != 0;
    if constexpr (!kInt8) {
      const __nv_bfloat16* sK = ring + stage * 2 * kTileElems;
      auto score = [](int, float s) { return s; };
      auto vfold = [](int) { return 1.f; };
      if (head_warp && full)
        tile_step<D, 3, false>(st, qf, q_live, sK, sK + kTileElems, score,
                               keep, vfold, kBK / 16, lane);
      else if (head_warp)
        tile_step<D, 3, true>(st, qf, q_live, sK, sK + kTileElems, score,
                              keep, vfold, kBK / 16, lane);
    } else {
      // int8 -> bf16 (exact) from the raw stage into the one bf16 tile
      const int8_t* src = raw + stage * 2 * kBK * D;
      for (int i = tid; i < 2 * kBK * kWords8; i += kThreads) {
        const int which = i / (kBK * kWords8), row = (i / kWords8) % kBK;
        const int ch = i % kWords8;
        const int4 u = *reinterpret_cast<const int4*>(
            src + which * kBK * D + row * D + ch * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&u);
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = pack_bf16(__float2bfloat16_rn(static_cast<float>(e[2 * j])),
                           __float2bfloat16_rn(
                               static_cast<float>(e[2 * j + 1])));
        uint4* dst = reinterpret_cast<uint4*>(ring + which * kTileElems +
                                              row * kRow + ch * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      const float* ks = s_scale + stage * 2 * kBK;
      const float* vs = ks + kBK;
      auto score = [ks](int col, float s) { return s * ks[col]; };
      auto vfold = [vs](int col) { return vs[col]; };
      if (head_warp && full)
        tile_step<D, 3, false>(st, qf, q_live, ring, ring + kTileElems,
                               score, keep, vfold, kBK / 16, lane);
      else if (head_warp)
        tile_step<D, 3, true>(st, qf, q_live, ring, ring + kTileElems,
                              score, keep, vfold, kBK / 16, lane);
    }
    __syncthreads();      // the stage is free for the tile after next
    t = tn;
    stage ^= 1;
  }
  if (!head_warp) return;
  st.finish();

  // the partials of this split (the output itself when n_split == 1)
  const size_t plane = static_cast<size_t>(n_tok) * n_kv * G;
  o += split * plane * D;
  l_out += split * plane;
  m_out += split * plane;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tk = (lane >> 2) + 8 * half;
    if (!s_act[tk]) continue;
    const size_t row =
        (static_cast<size_t>(tile * kTokens + tk) * n_kv + kv) * G + warp;
#pragma unroll
    for (int j = 0; j < Dims<D>::kDTiles; ++j)
      *reinterpret_cast<float2*>(o + row * D + 8 * j + 2 * (lane & 3)) =
          make_float2(st.acc[j][2 * half], st.acc[j][2 * half + 1]);
    if ((lane & 3) == 0) {
      l_out[row] = st.l[half];
      m_out[row] = st.m[half];
    }
  }
}

template <int D, int G, bool kInt8>
cudaError_t launch_tc(const void* q, const void* seg, int seg_div,
                      const void* k_pages, const void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* tables, const void* valid, void* o, void* l,
                      void* m, void* o_part, void* l_part, void* m_part,
                      int n_tok, int n_seg, int n_kv, int bs, int nb,
                      int n_split, float scale, cudaStream_t stream) {
  const ChunkSmem L = chunk_smem<D, G>(kInt8, nb * bs, nb);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (L.total > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_tc_kernel<D, G, kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    configured = L.total;
  }
  const bool split = n_split > 1;
  const dim3 grid((n_tok + kTokens - 1) / kTokens, n_kv, n_seg * n_split);
  paged_chunk_tc_kernel<D, G, kInt8>
      <<<grid, 32 * chunk_warps<G>(), L.total, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(seg), seg_div,
      k_pages, v_pages, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const bool*>(valid),
      static_cast<float*>(split ? o_part : o),
      static_cast<float*>(split ? l_part : l),
      static_cast<float*>(split ? m_part : m), n_tok, n_seg, n_kv, bs, nb,
      n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return split_merge::launch<D>(o_part, l_part, m_part, o, l, m,
                             n_tok * n_kv * G, n_split, stream);
}

// ---------------------------------------------------------------------------
// f32 pages: the CUDA-core kernel
//   * one block of 256 threads per (tile of 16 query tokens, KV head,
//     segment); the tile's G x 16 query rows sit in dynamic shared memory
//     in f32, pre-scaled by 1/sqrt(d);
//   * the segment's virtual positions are walked in tiles of 16; a tile
//     with no valid position is skipped; each position looks up its page
//     and the 256 threads stage K and V of the 16 positions in shared
//     memory, 16 threads a position;
//   * one half-warp per query token: for scores, lane j takes key j of the
//     tile; for the output, lane j owns dims [kDpl j, kDpl (j + 1)) of each
//     of the token's G rows (kDpl = D / 16: 4 at d 64, 8 at d 128, read as
//     float4 words; 5 at d 80, read one float at a time, the lanes' stride
//     of 5 floats on distinct banks); the online softmax is carried in
//     registers in f32.

constexpr int kThreadsF32 = kTokens * 16;   // one half-warp per token
constexpr int kKeysF32 = 16;                // key positions per shared tile

template <int D, int G>
__global__ void __launch_bounds__(kThreadsF32)
paged_chunk_f32_kernel(const float* __restrict__ q,
                       const int* __restrict__ seg, int seg_div,
                       const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const bool* __restrict__ valid, float* __restrict__ o,
                       float* __restrict__ l_out, float* __restrict__ m_out,
                       int n_tok, int n_seg, int n_kv, int bs, int nb,
                       float scale) {
  constexpr int kDpl = D / 16;      // dims a lane owns
  static_assert(kDpl * 16 == D, "a half-warp holds a row");
  constexpr bool kQuads = kDpl % 4 == 0;   // a lane's dims in float4 words
  constexpr int kWordsF = D / 4;           // float4 words of a K/V row
  constexpr int kQStride = D + 1;   // padded: the two half-warps of a warp
  constexpr int kKStride = D + 1;   // read other banks; lanes read K rows
  // the query rows in dynamic shared memory (f32_q_bytes<D, G>): at
  // (128, 4) they and the K/V tiles pass the 48 KB a block's static
  // shared memory may take (at (128, 7) the rows alone take 57,792
  // bytes)
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* sQ = reinterpret_cast<float*>(smem_f32);
  __shared__ float sK[kKeysF32 * kKStride];
  __shared__ __align__(16) float sV[kKeysF32 * D];
  __shared__ bool s_act[kTokens];
  __shared__ bool s_ok[kKeysF32];

  const int tile = blockIdx.x, kv = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;
  const int hw = tid / 16, lane = tid % 16;
  const int n_heads = n_kv * G;

  bool mine = false;
  if (tid < kTokens) {
    const int n = tile * kTokens + tid;
    mine = n < n_tok && segment_of(seg, seg_div, n, n_seg) == r;
    s_act[tid] = mine;
  }
  if (!__syncthreads_or(mine)) return;

  for (int idx = tid; idx < kTokens * G * D; idx += kThreadsF32) {
    const int i = idx / (G * D), g = (idx / D) % G, k = idx % D;
    const int n = tile * kTokens + i;
    sQ[(i * G + g) * kQStride + k] =
        s_act[i] ? q[(static_cast<size_t>(n) * n_heads + kv * G + g) * D + k] *
                       scale
                 : 0.f;
  }

  float m_run[G], l_run[G], acc[G][kDpl];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) acc[g][c] = 0.f;
  }

  const int n_pos = nb * bs;
  const int* table_row = tables + static_cast<size_t>(r) * nb;
  const bool* valid_row = valid + static_cast<size_t>(r) * n_pos;
  const float* krow = sK + lane * kKStride;
  for (int base = 0; base < n_pos; base += kKeysF32) {
    __syncthreads();    // the previous tile's readers are done
    bool ok = false;
    if (tid < kKeysF32) {
      const int p = base + tid;
      ok = p < n_pos && valid_row[p];
      s_ok[tid] = ok;
    }
    if (!__syncthreads_or(ok)) continue;

    // stage the 16 positions' K and V, 16 threads a position, float4
    // words c, c + 16, ... of the row each
    {
      const int pl = tid / 16, c = tid % 16;
      size_t pos_row = 0;
      if (s_ok[pl]) {
        const int p = base + pl;
        pos_row = (static_cast<size_t>(table_row[p / bs]) * n_kv + kv) * bs +
                  (p % bs);
      }
#pragma unroll
      for (int w = 0; w < (kWordsF + 15) / 16; ++w) {
        if (kWordsF % 16 != 0 && c + 16 * w >= kWordsF) break;
        const int col = 4 * (c + 16 * w);
        float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
        if (s_ok[pl]) {
          kf = __ldg(reinterpret_cast<const float4*>(k_pages + pos_row * D +
                                                     col));
          vf = __ldg(reinterpret_cast<const float4*>(v_pages + pos_row * D +
                                                     col));
        }
        sK[pl * kKStride + col] = kf.x;
        sK[pl * kKStride + col + 1] = kf.y;
        sK[pl * kKStride + col + 2] = kf.z;
        sK[pl * kKStride + col + 3] = kf.w;
        *reinterpret_cast<float4*>(&sV[pl * D + col]) = vf;
      }
    }
    __syncthreads();

    const bool ok_j = s_ok[lane];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* qrow = sQ + (hw * G + g) * kQStride;
      float s = 0.f;
#pragma unroll 16
      for (int k = 0; k < D; ++k) s = fmaf(qrow[k], krow[k], s);
      s = ok_j ? s : kNegInf;
      float mt = s;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
      const float m_new = fmaxf(m_run[g], mt);
      const float corr = expf(m_run[g] - m_new);
      const float p = ok_j ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off, 16);
      l_run[g] = fmaf(l_run[g], corr, ps);
#pragma unroll
      for (int c = 0; c < kDpl; ++c) acc[g][c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeysF32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j, 16);
        const float* vrow = &sV[j * D + kDpl * lane];
        if constexpr (kQuads) {
#pragma unroll
          for (int w = 0; w < kDpl / 4; ++w) {
            const float4 v = *reinterpret_cast<const float4*>(vrow + 4 * w);
            acc[g][4 * w] = fmaf(pj, v.x, acc[g][4 * w]);
            acc[g][4 * w + 1] = fmaf(pj, v.y, acc[g][4 * w + 1]);
            acc[g][4 * w + 2] = fmaf(pj, v.z, acc[g][4 * w + 2]);
            acc[g][4 * w + 3] = fmaf(pj, v.w, acc[g][4 * w + 3]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < kDpl; ++c)
            acc[g][c] = fmaf(pj, vrow[c], acc[g][c]);
        }
      }
      m_run[g] = m_new;
    }
  }

  if (!s_act[hw]) return;
  const int n = tile * kTokens + hw;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t row = (static_cast<size_t>(n) * n_kv + kv) * G + g;
    float* orow = o + row * D + kDpl * lane;
    if constexpr (kQuads) {
#pragma unroll
      for (int w = 0; w < kDpl / 4; ++w)
        *reinterpret_cast<float4*>(orow + 4 * w) =
            make_float4(acc[g][4 * w], acc[g][4 * w + 1], acc[g][4 * w + 2],
                        acc[g][4 * w + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < kDpl; ++c) orow[c] = acc[g][c];
    }
    if (lane == 0) {
      l_out[row] = l_run[g];
      m_out[row] = m_run[g];
    }
  }
}

// bytes of the f32 kernel's query rows, G x 16 rows of D + 1 floats
template <int D, int G>
constexpr int f32_q_bytes() { return kTokens * G * (D + 1) * 4; }

template <int D, int G>
cudaError_t launch_f32(const void* q, const void* seg, int seg_div,
                       const void* k_pages, const void* v_pages,
                       const void* tables, const void* valid, void* o,
                       void* l, void* m, int n_tok, int n_seg, int n_kv,
                       int bs, int nb, float scale, cudaStream_t stream) {
  constexpr int kBytes = f32_q_bytes<D, G>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_f32_kernel<D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((n_tok + kTokens - 1) / kTokens, n_kv, n_seg);
  paged_chunk_f32_kernel<D, G><<<grid, kThreadsF32, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const int*>(seg), seg_div,
      static_cast<const float*>(k_pages), static_cast<const float*>(v_pages),
      static_cast<const int*>(tables), static_cast<const bool*>(valid),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      n_tok, n_seg, n_kv, bs, nb, scale);
  return cudaGetLastError();
}

// One (head dim, query heads per KV head) instance: the f32 kernel and the
// tensor-core kernel for bf16 and int8 pages.
template <int D, int G>
cudaError_t launch_instance(const void* q, const void* seg, int seg_div,
                            const void* k_pages, const void* v_pages,
                            const void* k_scale, const void* v_scale,
                            const void* tables, const void* valid, void* o,
                            void* l, void* m, void* o_part, void* l_part,
                            void* m_part, int n_tok, int n_seg, int n_kv,
                            int bs, int nb, int n_split, int dtype_code,
                            float scale, cudaStream_t st) {
  switch (dtype_code) {
    case 0:
      return launch_f32<D, G>(q, seg, seg_div, k_pages, v_pages, tables,
                              valid, o, l, m, n_tok, n_seg, n_kv, bs, nb,
                              scale, st);
    case 1:
      return launch_tc<D, G, false>(
          q, seg, seg_div, k_pages, v_pages, k_scale, v_scale, tables, valid,
          o, l, m, o_part, l_part, m_part, n_tok, n_seg, n_kv, bs, nb,
          n_split, scale, st);
    case 2:
      return launch_tc<D, G, true>(
          q, seg, seg_div, k_pages, v_pages, k_scale, v_scale, tables, valid,
          o, l, m, o_part, l_part, m_part, n_tok, n_seg, n_kv, bs, nb,
          n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (n_tok, n_kv * G, D) f32; seg (n_tok,) int32, or null with segment =
// token / seg_div; tables (n_seg, nb) int32; valid (n_seg, nb * bs) bool;
// pages (P, n_kv, bs, D); o (n_tok, n_kv, G, D), l and m (n_tok, n_kv, G)
// f32.  dtype codes: 0 = float32 pages, 1 = bfloat16 pages, 2 = int8 pages
// (k_scale / v_scale non-null).  n_split > 1 (bf16 and int8 only) splits
// each segment's positions over n_split blocks; o_part, l_part and m_part
// are then scratch of n_split times the shape of o, l and m.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape that is not instantiated.
extern "C" int paged_chunk_launch(const void* q, const void* seg, int seg_div,
                                  const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* tables, const void* valid,
                                  void* o, void* l, void* m, void* o_part,
                                  void* l_part, void* m_part, int n_tok,
                                  int n_seg, int n_kv, int G, int D, int bs,
                                  int nb, int n_split, int dtype_code,
                                  float scale, void* stream) {
  if (n_tok == 0 || n_kv == 0) return static_cast<int>(cudaGetLastError());
  if (n_seg < 1 || nb < 1 || bs < 1 || n_split < 1 ||
      (seg == nullptr && seg_div < 1) ||
      (n_split > 1 && (dtype_code == 0 || o_part == nullptr ||
                       l_part == nullptr || m_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instance set: kernels/paged_chunk.py INSTANCES names the same
  // (D, G) pairs (tests/test_torch_d128.py holds the two lists equal)
#define CHUNK_INSTANCE(DD, GG)                                              \
  if (D == DD && G == GG)                                                   \
    return static_cast<int>(launch_instance<DD, GG>(                        \
        q, seg, seg_div, k_pages, v_pages, k_scale, v_scale, tables, valid, \
        o, l, m, o_part, l_part, m_part, n_tok, n_seg, n_kv, bs, nb,        \
        n_split, dtype_code, scale, st));
  CHUNK_INSTANCE(64, 3)
  CHUNK_INSTANCE(128, 3)
  CHUNK_INSTANCE(128, 1)
  CHUNK_INSTANCE(80, 1)
  CHUNK_INSTANCE(64, 2)
  CHUNK_INSTANCE(128, 4)
  CHUNK_INSTANCE(128, 7)
#undef CHUNK_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
