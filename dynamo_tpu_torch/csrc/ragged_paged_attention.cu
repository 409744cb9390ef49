// Ragged mixed prefill+decode attention over the paged pool, bf16 in/out,
// f32 math. Two entry points: a bf16 pool, and an int8 pool with in-row
// scales.
//
// Replaces: the Pallas kernel `_ragged_attn_kernel` under
// `ragged_paged_attention_pallas` (dynamo_tpu/engine/attention.py:1255),
// which the llama ragged forward calls once per layer.
//
// Contract (the global-window, uncapped case of the Pallas kernel): q
// [TT, H, Dh] bf16 flat token rows; one layer's pool k_cache/v_cache
// [NTOK, KVH*Dh] bf16 (token row = block id * block_size + offset);
// block_tables [S, M] int32; seq_starts, seq_counts, seq_lens [S] int32.
// Sequence s owns the rows [starts[s], starts[s] + counts[s]) at the
// consecutive positions pos0 .. seq_lens[s] - 1 (pos0 = seq_lens[s] -
// counts[s]); its row r attends the keys kv_pos <= pos0 + r. A count of 0
// skips the sequence. At most max_rows rows of a sequence are computed.
// Only owned rows are written: the caller zero-fills `out`, so a row no
// sequence owns reads as zeros. (The TPU kernel writes a static window of
// Lmax rows per sequence and relies on its sequential grid for the next
// sequence to overwrite the overhang; here the CTAs run in parallel, so
// that would be a race.)
//
// int8 mode (the Pallas kernel's `quant_lanes` mode, `dequant_tile`): pool
// rows are C + 128 int8 lanes (C = KVH*Dh): the values, then the row's
// scale as an exponent byte at lane C and a mantissa byte at C+1 (read
// & 0xFF), scale = 2^e * (1 + m/256), then 126 pad lanes that are never
// read. Each value is dequantized in f32 (value * scale, exact: the scale
// is built with ldexpf) and rounded to bf16 for the tensor cores, as the
// plain version dequantizes gathered rows to q's dtype.
//
// Bound on an H100. The work's floor is bytes at the serving shapes: every
// sequence's keys are read once for K and once for V (sum_s seq_len_s *
// KVH*Dh * 2 B * 2) plus q and out, against 4*H*Dh operations per visible
// (row, key) pair. A decode row does ~4 flop per KV byte and a 64-row
// chunk ~250, both under the card's ~295 flop/byte balance point. What the
// design does about it: the g = H/KVH query heads of a KV head and the R
// rows of a chunk share each K/V tile in shared memory, so a chunk of T
// rows reads its KV once per CTA instead of T times (the ragged win). Not
// yet done: loads are synchronous, then a barrier, then the MMAs (no
// cp.async/TMA double buffering, no wgmma); a decode row fills g of the 64
// MMA rows of its CTA (4 of 64 at g = 4); and one CTA walks a sequence's
// whole context, so a 2048-token row serialises 32 tiles (split-K is the
// fix). PERF.md has the times.
//
// Design: one CTA of 4 warps per (row tile, KV head, sequence). A CTA takes
// R = 64/g rows of one sequence times the g query heads of one KV head: 64
// (row, head) query vectors ordered row-major, 16 per warp, K1's layout
// (csrc/flash_prefill.cu). A CTA whose row tile starts at or past
// counts[s] exits at once. Each CTA reads its own starts/counts/seq_lens
// and block table (no scalar prefetch, no cross-sequence DMA chain). It
// streams the sequence's keys in 64-key tiles up to pos0 + its last row +
// 1: the tile's 64 pool rows are looked up once through the block table
// into shared memory, then K and V are gathered with 16-byte loads (all of
// a thread's loads issued before any is stored); keys past that bound are
// zero-filled, never loaded, so a stale or trash-block row cannot put a
// NaN into 0 * V. QK^T and PV run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 accumulate) with K1's FlashAttention-2 register
// layout; the mask is per (row, key): kv_pos <= pos0 + r and kv_pos <
// the tile bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // (row, head) query vectors per CTA
constexpr int kKeys = 64;      // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Gather one KV tile: the kKeys pool rows in `rows` (-1: zero-fill), lanes
// [lane0, lane0 + Dh) of each, into a shared tile of row stride Dh + 8 as
// bf16. Every load of the thread is issued before the first store.
template <int Dh, bool kInt8>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* smem, const void* __restrict__ cache,
                                             const long* rows, int C, int lane0) {
  constexpr int kVec = Dh / 8;  // 8-value vectors per row
  constexpr int kStride = Dh + 8;
  constexpr int kIters = kKeys * kVec / kThreads;
  if constexpr (kInt8) {
    uint2 raw[kIters];
    float sc[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kVec, c = (i % kVec) * 8;
      const long row = rows[r];
      raw[it] = make_uint2(0, 0);
      sc[it] = 0.f;
      if (row >= 0) {
        const int8_t* base = static_cast<const int8_t*>(cache) + row * (C + 128);
        raw[it] = *reinterpret_cast<const uint2*>(base + lane0 + c);
        const int ex = base[C];
        const int mant = static_cast<uint8_t>(base[C + 1]);
        sc[it] = ldexpf(1.f + mant * (1.f / 256.f), ex);
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kVec, c = (i % kVec) * 8;
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw[it]);
      uint4 val;
      val.x = pack_bf16(e[0] * sc[it], e[1] * sc[it]);
      val.y = pack_bf16(e[2] * sc[it], e[3] * sc[it]);
      val.z = pack_bf16(e[4] * sc[it], e[5] * sc[it]);
      val.w = pack_bf16(e[6] * sc[it], e[7] * sc[it]);
      *reinterpret_cast<uint4*>(smem + r * kStride + c) = val;
    }
  } else {
    uint4 raw[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kVec, c = (i % kVec) * 8;
      const long row = rows[r];
      raw[it] = make_uint4(0, 0, 0, 0);
      if (row >= 0)
        raw[it] = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(cache) +
                                                  row * C + lane0 + c);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kVec, c = (i % kVec) * 8;
      *reinterpret_cast<uint4*>(smem + r * kStride + c) = raw[it];
    }
  }
}

template <int Dh, bool kInt8>
__global__ void __launch_bounds__(kThreads)
ragged_attention_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                        const void* __restrict__ v_cache, const int* __restrict__ block_tables,
                        const int* __restrict__ seq_starts, const int* __restrict__ seq_counts,
                        const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
                        int H, int KVH, int M, int block_size, float scale_log2) {
  constexpr int kStride = Dh + 8;
  constexpr int kDSteps = Dh / 16;  // k-steps of the QK^T product
  constexpr int kDTiles = Dh / 8;   // n-tiles of the PV product
  constexpr int kKTiles = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * kStride;
  __nv_bfloat16* sV = sK + kKeys * kStride;
  __shared__ long sRow[kKeys];

  const int s = blockIdx.z, kvh = blockIdx.y;
  const int g = H / KVH;
  const int rows_per_cta = kRows / g;
  const int r0 = blockIdx.x * rows_per_cta;  // first row of the sequence's span
  const int L = seq_counts[s];
  if (r0 >= L) return;
  const int start = seq_starts[s];
  const int pos0 = seq_lens[s] - L;          // row r sits at position pos0 + r
  const int C = KVH * Dh;
  const int* table = block_tables + (long)s * M;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  // Q tile: vector v -> row r0 + v / g, head kvh*g + v % g
  {
    constexpr int kVec = Dh / 8;
    for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
      const int v = i / kVec, c = (i % kVec) * 8;
      const int r = r0 + v / g, h = kvh * g + v % g;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < L) val = *reinterpret_cast<const uint4*>(q + ((long)(start + r) * H + h) * Dh + c);
      *reinterpret_cast<uint4*>(sQ + v * kStride + c) = val;
    }
  }
  __syncthreads();

  // this warp's 16 vectors as A fragments, kept in registers for the loop
  uint32_t qf[kDSteps][4];
  {
    const __nv_bfloat16* base = sQ + (warp * 16) * kStride;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      const int c = ks * 16 + tig * 2;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(base + gid * kStride + c);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(base + (gid + 8) * kStride + c);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(base + gid * kStride + c + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(base + (gid + 8) * kStride + c + 8);
    }
  }

  // rows and absolute positions of this thread's two vectors
  const int V0 = warp * 16 + gid, V1 = V0 + 8;
  const int row0 = r0 + V0 / g, row1 = r0 + V1 / g;
  const int qpos0 = pos0 + row0, qpos1 = pos0 + row1;

  // keys this CTA can see: [0, pos0 + its last owned row + 1)
  const int last_row = min(r0 + rows_per_cta, L) - 1;
  const int n_keys = pos0 + last_row + 1;
  const int n_tiles = n_keys > 0 ? (n_keys + kKeys - 1) / kKeys : 0;

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    __syncthreads();  // previous tile fully consumed
    if (threadIdx.x < kKeys) {
      const int key = key0 + threadIdx.x;
      long row = -1;
      if (key < n_keys) {
        const int blk = key / block_size;
        if (blk < M) row = (long)table[blk] * block_size + key % block_size;
      }
      sRow[threadIdx.x] = row;
    }
    __syncthreads();
    load_kv_tile<Dh, kInt8>(sK, k_cache, sRow, C, kvh * Dh);
    load_kv_tile<Dh, kInt8>(sV, v_cache, sRow, C, kvh * Dh);
    __syncthreads();

    // S = Q K^T for this warp's 16 vectors x 64 keys
    float sc[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      const __nv_bfloat16* krow = sK + (j * 8 + gid) * kStride;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + tig * 2);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + tig * 2 + 8);
        mma_bf16_16816(sc[j], qf[ks], b0, b1);
      }
    }

    // per-(row, key) mask, scale into the log2 domain, online softmax
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + tig * 2 + e;
        const bool ok = key < n_keys;
        const float a = (ok && key <= qpos0) ? sc[j][e] * scale_log2 : -INFINITY;
        const float b = (ok && key <= qpos1) ? sc[j][2 + e] * scale_log2 : -INFINITY;
        sc[j][e] = a;
        sc[j][2 + e] = b;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, b);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    // a vector with no visible key so far (a row past the span) keeps
    // m = -inf; its p and alpha must come out 0, not NaN
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      sc[j][0] = exp2f(sc[j][0] - base0);
      sc[j][1] = exp2f(sc[j][1] - base0);
      sc[j][2] = exp2f(sc[j][2] - base1);
      sc[j][3] = exp2f(sc[j][3] - base1);
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

    // O += P V: P's accumulator layout is the A-fragment layout of the next
    // product (two 8-key n-tiles make one 16-key k-step)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = sV + (kk * 16 + tig * 2) * kStride;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const int d = j * 8 + gid;
        const uint32_t b0 = pack_bf16_raw(v0[d], v0[kStride + d]);
        const uint32_t b1 = pack_bf16_raw(v0[8 * kStride + d], v0[9 * kStride + d]);
        mma_bf16_16816(o[j], a, b0, b1);
      }
    }
  }

  // finish: the row sum is spread over the 4 threads of a quad; only owned
  // rows are written
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* out0 = out + ((long)(start + row0) * H + kvh * g + V0 % g) * Dh;
  __nv_bfloat16* out1 = out + ((long)(start + row1) * H + kvh * g + V1 % g) * Dh;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int c = j * 8 + tig * 2;
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(out0 + c) = pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(out1 + c) = pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int Dh, bool kInt8>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* starts, const int* counts, const int* lens, void* out, int S,
                   int H, int KVH, int M, int max_rows, int block_size, float scale,
                   cudaStream_t stream) {
  const int smem = (kRows + 2 * kKeys) * (Dh + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(ragged_attention_kernel<Dh, kInt8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_cta = kRows / (H / KVH);
  dim3 grid((max_rows + rows_per_cta - 1) / rows_per_cta, KVH, S);
  ragged_attention_kernel<Dh, kInt8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, tables, starts, counts, lens,
      static_cast<__nv_bfloat16*>(out), H, KVH, M, block_size, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <bool kInt8>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* block_tables,
             const void* seq_starts, const void* seq_counts, const void* seq_lens, void* out,
             int TT, int S, int H, int KVH, int Dh, int M, int max_rows, int block_size,
             float scale, void* stream) {
  if (TT <= 0 || S <= 0 || max_rows <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const int g = H / KVH;
  if (g != 1 && g != 2 && g != 4 && g != 8) return (int)cudaErrorInvalidValue;
  const int* tables = static_cast<const int*>(block_tables);
  const int* starts = static_cast<const int*>(seq_starts);
  const int* counts = static_cast<const int*>(seq_counts);
  const int* lens = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return (int)launch<64, kInt8>(q, k_cache, v_cache, tables, starts, counts, lens, out, S,
                                    H, KVH, M, max_rows, block_size, scale, st);
    case 128:
      return (int)launch<128, kInt8>(q, k_cache, v_cache, tables, starts, counts, lens, out, S,
                                     H, KVH, M, max_rows, block_size, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both return a cudaError_t (0 = launched). Head dims 64/128 and GQA group
// sizes 1/2/4/8 are compiled. `out` must be zero-filled by the caller (only
// owned rows are written). The int8 entry takes pools of KVH*Dh + 128 int8
// lanes per row.
extern "C" int dtt_ragged_paged_attention_bf16(const void* q, const void* k_cache,
                                               const void* v_cache, const void* block_tables,
                                               const void* seq_starts, const void* seq_counts,
                                               const void* seq_lens, void* out, int TT, int S,
                                               int H, int KVH, int Dh, int M, int max_rows,
                                               int block_size, float scale, void* stream) {
  return dispatch<false>(q, k_cache, v_cache, block_tables, seq_starts, seq_counts, seq_lens,
                         out, TT, S, H, KVH, Dh, M, max_rows, block_size, scale, stream);
}

extern "C" int dtt_ragged_paged_attention_int8(const void* q, const void* k_cache,
                                               const void* v_cache, const void* block_tables,
                                               const void* seq_starts, const void* seq_counts,
                                               const void* seq_lens, void* out, int TT, int S,
                                               int H, int KVH, int Dh, int M, int max_rows,
                                               int block_size, float scale, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, block_tables, seq_starts, seq_counts, seq_lens,
                        out, TT, S, H, KVH, Dh, M, max_rows, block_size, scale, stream);
}
