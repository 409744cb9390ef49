// Latent-row attention of MLA (DeepSeek-V2): decode (K3-MLA) and ragged
// mixed prefill+decode (K4-MLA) over a paged pool whose one row per token
// is both K and V, bf16 in/out, f32 math. Four entry points: decode and
// ragged, each over a bf16 pool and over a sectioned int8 pool.
//
// Replaces: the MLA modes (`v_lanes`, `quant_sections`) of the Pallas
// kernels `_paged_attn_kernel` (dynamo_tpu/engine/attention.py:743, its
// body at :877-885) and `_ragged_attn_kernel` (:1255, body :1369-1377),
// which the JAX MLA model calls once per layer (models/mla.py
// decode_forward and ragged_forward).
//
// Contract (attention.paged_attention / ragged_paged_attention with
// v_lanes, and quant_sections on an int8 pool): one latent "KV head" whose
// row is [c_kv (512) | k_pe (64) | pad], H = 16 query heads (G = 16),
// q [rows, 16, 640] bf16 = [q_lat (512) | q_pe (64) | pad (64)].
// - bf16 pool [NTOK, 640] bf16: score = q . row over all 640 lanes;
//   V = the row's first 512 lanes.
// - int8 pool [NTOK, 768] int8, the sectioned in-row encoding
//   (attention.quantize_kv_rows_sections): values at lanes [0, 576), the
//   two sections' scales as (exponent, mantissa) bytes at 576 + {0, 1}
//   (c_kv) and 576 + {2, 3} (k_pe), scale = 2^e * (1 + m/256), then pad
//   lanes that are never read. Dequantized rows are zero past 576 up to
//   the query's 640 lanes, so the query's pad lanes never meet a scale.
//   Each section's scale is taken out of its part of the dot: score =
//   s0 * (q[:512] . v[:512]) + s1 * (q[512:576] . v[512:576]), and V's
//   weight p * s0.
// Decode (K3-MLA): block_tables [B, M], seq_lens [B] int32 (the keys each
// row sees; 0 gives zeros); out [B, 16, 512]. Ragged (K4-MLA): tables
// [S, M], seq_starts / seq_counts / seq_lens [S] int32 as in
// ragged_paged_attention.cu (sequence s's row r sees pos0 + r + 1 keys,
// pos0 = seq_lens[s] - seq_counts[s]); only owned rows are written, the
// caller zero-fills out [TT, 16, 512]. Keys past M * block_size are not
// read. `scratch` is f32 workspace when the split plan below has more
// than one split (rows * splits * 16 * (512 + 2) floats: acc [rows, 1,
// splits, 16, 512], then m and l [rows, 1, splits, 16], the layout
// attention.split_scratch_views reads), else null.
//
// Bound on an H100. Bytes: each key a row sees is read once, 1280 bytes
// (bf16) or 580 (int8: 576 values and the 4 scale bytes), against 4 * 16 *
// 576 operations per (row, key) on the tensor cores' bf16 rate: a decode
// row does ~57 flop per bf16 byte, under the card's ~295 flop/byte balance
// point, so the floor is the latent rows' bytes (8 x 4096 keys: 41.9 MB,
// 12.5 us). A ragged prefill chunk of T rows reads each key for T rows:
// at T = 64 it is operations that bound it.
//
// Design:
// - The latent row is K and V at once: each 32-key tile crosses device
//   memory once per CTA, its 640 lanes feed the scores and its first 512
//   lanes feed P.V from the same shared-memory tile (the TPU kernel's
//   skipped V stream).
// - One CTA of 4 warps takes one query row (its 16 heads, the M of one
//   mma.sync m16n8k16 tile: attention.LATENT_TILE_ROWS) and one chunk of
//   its keys: K3's flash-decoding plan (128 keys rounded up to whole
//   blocks, attention.decode_split_plan), so a 4096-key row is 32 CTAs and
//   a full decode batch of 8 such rows fills the card. The grid is (splits,
//   B) for decode and (max_rows * splits, S) for ragged, sized on the host
//   from the table width and the row budget; a CTA whose row or chunk is
//   past what it sees exits after its scalars.
// - Scores: warp w computes the 16 x 8 scores of keys 8w .. 8w+7 over the
//   full depth (40 k-steps of 16 lanes, 36 for int8 rows, whose pad lanes
//   are zero), Q and K fragments by `ldmatrix` from shared memory. The 16 x
//   32 tile of scores meets in shared memory; every warp then takes the
//   online softmax of all 32 keys (the same bits in each warp: same inputs,
//   same order) and P.V for its 128 of the 512 output lanes (16 n-tiles, a
//   64-float accumulator per thread), V fragments by `ldmatrix.trans` from
//   the same tile.
// - Two 32-key tiles in flight (`cp.async`, 16 bytes a copy, keys past the
//   chunk zero-filled, never loaded) with Q in shared memory: 104 KB (bf16)
//   or 101 KB (int8: raw tiles of 592 bytes a key and one tile converted to
//   bf16, byte permutes, exact, no I2F), two CTAs per SM.
// - A row with one live chunk writes its output directly. Otherwise each
//   chunk writes its f32 partials (m in the exp2 domain, l, acc) to scratch
//   and a merge kernel of the same entry point, one CTA per row launched
//   with programmatic dependent launch, sums the live chunks in index order
//   (a chunk with m = -inf weighs 0). Every sum runs in a fixed order, no
//   float atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kG = 16;            // query heads per row: the MMA's M
constexpr int kDq = 640;          // query / bf16 row lanes
constexpr int kDv = 512;          // v_lanes: the c_kv section
constexpr int kRope = 64;         // the k_pe section
constexpr int kDc = kDv + kRope;  // value lanes of an int8 row
constexpr int kInt8Row = 768;     // pad128(576 + 128)
constexpr int kKeys = 32;         // keys per tile
constexpr int kStages = 2;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMergeThreads = 256;
constexpr int kChunkTarget = 128;  // attention.DECODE_CHUNK_TOKENS
constexpr int kStride = kDq + 8;   // bf16 per shared row (1296 bytes: no bank conflicts)
constexpr int kSStride = kKeys + 4;  // floats per row of the score tile
constexpr int kMaxDevices = 64;

__host__ __device__ inline int chunk_tokens(int block_size) {
  return block_size * ((kChunkTarget + block_size - 1) / block_size);
}

template <bool kInt8>
struct Layout {
  static constexpr int kPieces = kInt8 ? kDc / 16 + 1 : kDq * 2 / 16;  // 16-byte copies a key
  static constexpr int kRingRow = kInt8 ? kDc + 16 : kStride * 2;   // bytes
  static constexpr int kTile = kKeys * kRingRow;
  static constexpr int kQ = kG * kStride * 2;
  static constexpr int kConv = kInt8 ? kKeys * kStride * 2 : 0;
  static constexpr int kScores = kG * kSStride * 4;
  static constexpr int kScales = kInt8 ? 2 * kKeys * 4 : 0;
  static constexpr int kDSteps = kInt8 ? kDc / 16 : kDq / 16;  // k-steps of Q K^T
  static size_t bytes(int chunk) {
    return (size_t)kQ + (size_t)kStages * kTile + kConv + kScores + kScales + 4 * (size_t)chunk;
  }
};

// The row a CTA serves: its query row (and output / scratch row), the keys
// it sees and its block table; `live` false for a ragged row past its
// sequence's count.
struct LatentRow {
  int qrow, n_keys;
  const int* table;
  bool live;
};

template <bool kRagged>
__device__ __forceinline__ LatentRow latent_row(const int* tables, const int* starts,
                                                const int* counts, const int* lens, int r, int s,
                                                int M, int block_size) {
  LatentRow rd;
  if constexpr (kRagged) {
    const int count = counts[s];
    rd.live = r < count;
    rd.qrow = starts[s] + r;
    rd.n_keys = lens[s] - count + r + 1;
  } else {
    rd.live = true;
    rd.qrow = r;
    rd.n_keys = lens[r];
  }
  rd.n_keys = max(min(rd.n_keys, M * block_size), 0);
  rd.table = tables + (long)(kRagged ? s : r) * M;
  return rd;
}

// Scratch of one call (attention.split_scratch_views, KVH = 1, g = 16).
struct Scratch {
  float* acc;
  float* m;
  float* l;
  __device__ Scratch(float* base, int rows, int splits) {
    const long n = (long)rows * splits * kG;
    acc = base;
    m = base + n * kDv;
    l = m + n;
  }
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes from global to shared; the bytes past src_bytes are zero-filled
// (src_bytes 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two int8 lanes (bytes 0 and 2 of p) to bf16x2, exactly (as in
// ragged_paged_attention.cu): (128 + low7) - (128 + 128 * sign).
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t p) {
  const uint32_t a = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float row_scale(const uint8_t* s) {
  return ldexpf(1.f + s[1] * (1.f / 256.f), static_cast<int8_t>(s[0]));
}

// Issue the copies of chunk keys [t0, t0 + kKeys) into a ring tile: the
// row's 640 bf16 lanes, or an int8 row's 576 value lanes and its 16-byte
// scale chunk; keys at or past n_valid are zero-filled.
template <bool kInt8>
__device__ __forceinline__ void issue_tile(uint8_t* dst, const uint8_t* pool, const int* sRow,
                                           int t0, int n_valid) {
  using L = Layout<kInt8>;
  const long stride = kInt8 ? kInt8Row : kDq * 2;  // bytes per pool row
  for (int i = threadIdx.x; i < kKeys * L::kPieces; i += kThreads) {
    const int t = i / L::kPieces, p = i % L::kPieces;
    const bool ok = t0 + t < n_valid;
    const uint8_t* src = ok ? pool + (long)sRow[t0 + t] * stride + p * 16 : pool;
    cp_async16(dst + t * L::kRingRow + p * 16, src, ok ? 16 : 0);
  }
}

// int8 ring tile -> bf16 tile (lanes [0, 576), row stride kStride) and
// each key's two section scales
__device__ __forceinline__ void convert_tile(__nv_bfloat16* dst, float* scales,
                                             const uint8_t* src) {
  using L = Layout<true>;
  constexpr int kPieces = kDc / 16;
  for (int i = threadIdx.x; i < kKeys * kPieces; i += kThreads) {
    const int t = i / kPieces, p = i % kPieces;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + t * L::kRingRow + p * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = int8x2_to_bf16x2(__byte_perm(w[j], 0, 0x4140));
      o[2 * j + 1] = int8x2_to_bf16x2(__byte_perm(w[j], 0, 0x4342));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + t * kStride + p * 16);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
  if (threadIdx.x < kKeys) {
    const uint8_t* s = src + threadIdx.x * L::kRingRow + kDc;
    scales[threadIdx.x] = row_scale(s);
    scales[kKeys + threadIdx.x] = row_scale(s + 2);
  }
}

template <bool kInt8, bool kRagged>
__global__ void __launch_bounds__(kThreads, 2)
latent_split_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ pool,
                    const int* __restrict__ tables, const int* __restrict__ starts,
                    const int* __restrict__ counts, const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ scratch, int rows,
                    int M, int block_size, int splits, float scale_log2) {
  using L = Layout<kInt8>;
  // the merge kernel may be scheduled now: it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x % splits;
  const LatentRow rd = latent_row<kRagged>(tables, starts, counts, lens,
                                           kRagged ? blockIdx.x / splits : blockIdx.y,
                                           blockIdx.y, M, block_size);
  if (!rd.live) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  __nv_bfloat16* orow = out + (long)rd.qrow * kG * kDv;
  if (rd.n_keys == 0) {  // no key to see: split 0 writes the zeros
    if (!kRagged && split == 0)
      for (int i = tid; i < kG * kDv; i += kThreads) orow[i] = __float2bfloat16(0.f);
    return;
  }
  const int chunk = chunk_tokens(block_size);
  const int t0 = split * chunk;
  if (t0 >= rd.n_keys) return;
  const int n_tok = min(t0 + chunk, rd.n_keys) - t0;
  const int n_live = (rd.n_keys + chunk - 1) / chunk;

  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + L::kQ;
  __nv_bfloat16* sConv = reinterpret_cast<__nv_bfloat16*>(ring + kStages * L::kTile);
  float* sS = reinterpret_cast<float*>(ring + kStages * L::kTile + L::kConv);
  float* sScale = sS + kG * kSStride;
  int* sRow = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(sScale) + L::kScales);

  for (int t = tid; t < n_tok; t += kThreads) {
    const int key = t0 + t;
    sRow[t] = rd.table[key / block_size] * block_size + key % block_size;
  }
  {  // Q: 16 heads x 640 lanes, 80 pieces a head
    const __nv_bfloat16* qr = q + (long)rd.qrow * kG * kDq;
    for (int i = tid; i < kG * (kDq / 8); i += kThreads) {
      const int h = i / (kDq / 8), c = (i % (kDq / 8)) * 8;
      cp_async16(sQ + h * kStride + c, qr + h * kDq + c, 16);
    }
  }
  __syncthreads();  // sRow
  const int n_kt = (n_tok + kKeys - 1) / kKeys;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {  // Q rides in the first group
    if (st < n_kt) issue_tile<kInt8>(ring + st * L::kTile, pool, sRow, st * kKeys, n_tok);
    cp_async_commit();
  }

  // ldmatrix lane addresses: Q's A fragments (16 heads x 16 lanes); this
  // warp's 8 keys as B fragments of two k-steps; V's transposed B
  // fragments (16 keys x 16 lanes)
  const __nv_bfloat16* qa =
      sQ + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
  const int k_off = (warp * 8 + (lane & 7)) * kStride + (lane >> 3) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8 + warp * 128;

  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // heads gid, gid + 8

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    uint8_t* tile = ring + st * L::kTile;
    cp_async_wait<kStages - 1>();  // Q and this tile have landed
    __syncthreads();
    const __nv_bfloat16* sK;
    if constexpr (kInt8) {
      convert_tile(sConv, sScale, tile);
      __syncthreads();
      sK = sConv;
    } else {
      sK = reinterpret_cast<const __nv_bfloat16*>(tile);
    }

    // S = Q K^T for this warp's 8 keys: the c_kv section (and the rest of
    // a bf16 row) into c, an int8 row's k_pe section into c1
    float c[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < L::kDSteps; ks += 2) {
      uint32_t a0[4], a1[4], b[4];
      ldsm_x4(a0, qa + ks * 16);
      ldsm_x4(a1, qa + (ks + 1) * 16);
      ldsm_x4(b, sK + k_off + ks * 16);
      if (kInt8 && ks >= kDv / 16) {
        mma_bf16_16816(c1, a0, b[0], b[1]);
        mma_bf16_16816(c1, a1, b[2], b[3]);
      } else {
        mma_bf16_16816(c, a0, b[0], b[1]);
        mma_bf16_16816(c, a1, b[2], b[3]);
      }
    }
    // into the log2 domain (an int8 row's section scales), keys past the
    // chunk masked; the 16 x 32 tile meets in shared memory
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kl = warp * 8 + tig * 2 + e;
      const bool ok = it * kKeys + kl < n_tok;
      float a = c[e], b = c[2 + e];
      if constexpr (kInt8) {
        const float s0 = sScale[kl], s1 = sScale[kKeys + kl];
        a = a * s0 + c1[e] * s1;
        b = b * s0 + c1[2 + e] * s1;
      }
      sS[gid * kSStride + kl] = ok ? a * scale_log2 : -INFINITY;
      sS[(gid + 8) * kSStride + kl] = ok ? b * scale_log2 : -INFINITY;
    }
    __syncthreads();

    // online softmax over the tile's 32 keys, the same in every warp: this
    // thread's keys are kk * 16 + tig * 2 + {0, 1, 8, 9}
    float p0[8], p1[8];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = kk * 16 + hh * 8 + tig * 2;
        const float2 x0 = *reinterpret_cast<const float2*>(sS + gid * kSStride + col);
        const float2 x1 = *reinterpret_cast<const float2*>(sS + (gid + 8) * kSStride + col);
        p0[kk * 4 + hh * 2] = x0.x;
        p0[kk * 4 + hh * 2 + 1] = x0.y;
        p1[kk * 4 + hh * 2] = x1.x;
        p1[kk * 4 + hh * 2 + 1] = x1.y;
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, p0[i]);
      mx1 = fmaxf(mx1, p1[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    // a head with no visible key so far keeps m = -inf; its p and alpha
    // come out 0, not NaN
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p0[i] = exp2f(p0[i] - base0);
      p1[i] = exp2f(p1[i] - base1);
      rs0 += p0[i];
      rs1 += p1[i];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffff, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffff, rs1, off);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
    if constexpr (kInt8) {  // V's c_kv scale into the weights (l keeps them unscaled)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float vs = sScale[kk * 16 + (i / 2) * 8 + tig * 2 + i % 2];
          p0[kk * 4 + i] *= vs;
          p1[kk * 4 + i] *= vs;
        }
    }

    // O += P V over this warp's 128 lanes, V the same tile's first 512
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(p0[kk * 4], p0[kk * 4 + 1]);
      a[1] = pack_bf16(p1[kk * 4], p1[kk * 4 + 1]);
      a[2] = pack_bf16(p0[kk * 4 + 2], p0[kk * 4 + 3]);
      a[3] = pack_bf16(p1[kk * 4 + 2], p1[kk * 4 + 3]);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, sK + kk * 16 * kStride + v_off + j * 8);
        mma_bf16_16816(o[j], a, b[0], b[1]);
        mma_bf16_16816(o[j + 1], a, b[2], b[3]);
      }
    }

    // the stage, the scores and the converted tile are consumed: refill
    // the stage with the tile kStages ahead
    __syncthreads();
    const int nt = it + kStages;
    if (nt < n_kt) issue_tile<kInt8>(tile, pool, sRow, nt * kKeys, n_tok);
    cp_async_commit();
  }

  if (n_live == 1) {  // one chunk: the output directly
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = warp * 128 + j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(orow + gid * kDv + col) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      *reinterpret_cast<uint32_t*>(orow + (gid + 8) * kDv + col) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
    return;
  }
  Scratch part(scratch, rows, splits);
  const long slot = ((long)rd.qrow * splits + split) * kG;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = warp * 128 + j * 8 + tig * 2;
    *reinterpret_cast<float2*>(part.acc + (slot + gid) * kDv + col) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(part.acc + (slot + gid + 8) * kDv + col) =
        make_float2(o[j][2], o[j][3]);
  }
  if (warp == 0 && tig == 0) {
    part.m[slot + gid] = m0;
    part.l[slot + gid] = l0;
    part.m[slot + gid + 8] = m1;
    part.l[slot + gid + 8] = l1;
  }
}

// One CTA per row: the live chunks' partials merged in index order; a row
// with one live chunk was written by its chunk. Every chunk's (m, l) comes
// into shared memory in one load, the weights exp2(m_c - max m) and 1 /
// sum(w l) are formed once per head, then each thread sums float4s of acc
// over the chunks.
template <bool kRagged>
__global__ void __launch_bounds__(kMergeThreads)
latent_merge_kernel(const float* __restrict__ scratch, const int* __restrict__ tables,
                    const int* __restrict__ starts, const int* __restrict__ counts,
                    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int rows,
                    int M, int block_size, int splits) {
  extern __shared__ float sW[];  // [splits][16] m, then weights; [splits][16] l; [16] 1/den
  float* sL = sW + splits * kG;
  float* sInv = sL + splits * kG;
  const LatentRow rd = latent_row<kRagged>(tables, starts, counts, lens, blockIdx.x, blockIdx.y,
                                           M, block_size);
  const int chunk = chunk_tokens(block_size);
  const int n = (rd.n_keys + chunk - 1) / chunk;
  // launched early (programmatic dependent launch): every CTA waits here
  // for the split kernel's grid to finish and its writes to land, so that
  // what follows in the stream is ordered after both kernels
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (!rd.live || n <= 1) return;
  const int tid = threadIdx.x;
  Scratch part(const_cast<float*>(scratch), rows, splits);
  const long slot0 = (long)rd.qrow * splits * kG;
  for (int i = tid; i < n * kG; i += kMergeThreads) {
    sW[i] = part.m[slot0 + i];
    sL[i] = part.l[slot0 + i];
  }
  __syncthreads();
  if (tid < kG) {
    float mx = -INFINITY;
    for (int c = 0; c < n; ++c) mx = fmaxf(mx, sW[c * kG + tid]);
    float den = 0.f;
    for (int c = 0; c < n; ++c) {
      const float mc = sW[c * kG + tid];
      const float w = mc == -INFINITY ? 0.f : exp2f(mc - mx);
      sW[c * kG + tid] = w;
      den += w * sL[c * kG + tid];
    }
    sInv[tid] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  constexpr int kQuads = kDv / 4;
  const float4* acc = reinterpret_cast<const float4*>(part.acc + slot0 * kDv);
  __nv_bfloat16* o = out + (long)rd.qrow * kG * kDv;
  for (int i = tid; i < kG * kQuads; i += kMergeThreads) {
    const int h = i / kQuads;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const float4 a = acc[(long)c * kG * kQuads + i];
      const float w = sW[c * kG + h];
      r.x += w * a.x;
      r.y += w * a.y;
      r.z += w * a.z;
      r.w += w * a.w;
    }
    const float inv = sInv[h];
    *reinterpret_cast<uint2*>(o + 4 * i) =
        make_uint2(pack_bf16(r.x * inv, r.y * inv), pack_bf16(r.z * inv, r.w * inv));
  }
}

// Raise the instantiation's dynamic shared-memory limit on the current
// device once (to the largest size asked for so far), with the largest
// carveout so that two CTAs fit an SM.
template <bool kInt8, bool kRagged>
cudaError_t ensure_smem(size_t bytes) {
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(latent_split_kernel<kInt8, kRagged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(latent_split_kernel<kInt8, kRagged>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

// rows: B (decode) or TT (ragged); grid_rows x grid_seqs: (B, 1) or
// (max_rows, S)
template <bool kInt8, bool kRagged>
int launch(const void* q, const void* pool, const void* tables, const void* starts,
           const void* counts, const void* lens, void* out, void* scratch, int rows,
           int grid_rows, int grid_seqs, int H, int Dq, int lanes, int M, int block_size,
           int v_lanes, int rope, float scale, void* stream_ptr) {
  if (rows <= 0 || grid_rows <= 0 || grid_seqs <= 0) return 0;
  if (H != kG || Dq != kDq || v_lanes != kDv || lanes != (kInt8 ? kInt8Row : kDq) ||
      (kInt8 && rope != kRope) || M <= 0 || block_size <= 0 || grid_seqs > 65535 ||
      (!kRagged && grid_rows > 65535))
    return (int)cudaErrorInvalidValue;
  const int chunk = chunk_tokens(block_size);
  const int splits = (M * block_size + chunk - 1) / chunk;
  const size_t merge_smem = sizeof(float) * (2 * (size_t)splits * kG + kG);
  if ((long)grid_rows * splits > 0x7fffffffL ||
      (splits > 1 && (scratch == nullptr || merge_smem > 48 * 1024)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<kInt8>::bytes(chunk);
  cudaError_t err = ensure_smem<kInt8, kRagged>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* t = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const int* ln = static_cast<const int*>(lens);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* sc = static_cast<float*>(scratch);
  const dim3 grid = kRagged ? dim3(grid_rows * splits, grid_seqs) : dim3(splits, grid_rows);
  latent_split_kernel<kInt8, kRagged><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(pool), t, st, ct, ln, o,
      sc, rows, M, block_size, splits, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  // programmatic dependent launch: the merge's launch overlaps the split
  // kernel's tail instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = kRagged ? dim3(grid_rows, grid_seqs) : dim3(grid_rows, 1);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, latent_merge_kernel<kRagged>, static_cast<const float*>(sc), t,
                           st, ct, ln, o, rows, M, block_size, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// All four return a cudaError_t (0 = launched). Compiled for DeepSeek-V2's
// latent rows: 16 query heads, a 640-lane query, v_lanes 512 and, over an
// int8 pool of 768 lanes, the sections (512, 64). `scratch`: see the
// contract above.
extern "C" int dtt_latent_paged_attention_bf16(const void* q, const void* pool,
                                               const void* block_tables, const void* seq_lens,
                                               void* out, void* scratch, int B, int H, int Dq,
                                               int lanes, int M, int block_size, int v_lanes,
                                               int rope, float scale, void* stream) {
  return launch<false, false>(q, pool, block_tables, nullptr, nullptr, seq_lens, out, scratch, B,
                              B, 1, H, Dq, lanes, M, block_size, v_lanes, rope, scale, stream);
}

extern "C" int dtt_latent_paged_attention_int8(const void* q, const void* pool,
                                               const void* block_tables, const void* seq_lens,
                                               void* out, void* scratch, int B, int H, int Dq,
                                               int lanes, int M, int block_size, int v_lanes,
                                               int rope, float scale, void* stream) {
  return launch<true, false>(q, pool, block_tables, nullptr, nullptr, seq_lens, out, scratch, B,
                             B, 1, H, Dq, lanes, M, block_size, v_lanes, rope, scale, stream);
}

// `out` must be zero-filled by the caller (only owned rows are written).
extern "C" int dtt_latent_ragged_attention_bf16(const void* q, const void* pool,
                                                const void* block_tables, const void* seq_starts,
                                                const void* seq_counts, const void* seq_lens,
                                                void* out, void* scratch, int TT, int S,
                                                int max_rows, int H, int Dq, int lanes, int M,
                                                int block_size, int v_lanes, int rope,
                                                float scale, void* stream) {
  return launch<false, true>(q, pool, block_tables, seq_starts, seq_counts, seq_lens, out,
                             scratch, TT, max_rows, S, H, Dq, lanes, M, block_size, v_lanes, rope,
                             scale, stream);
}

extern "C" int dtt_latent_ragged_attention_int8(const void* q, const void* pool,
                                                const void* block_tables, const void* seq_starts,
                                                const void* seq_counts, const void* seq_lens,
                                                void* out, void* scratch, int TT, int S,
                                                int max_rows, int H, int Dq, int lanes, int M,
                                                int block_size, int v_lanes, int rope,
                                                float scale, void* stream) {
  return launch<true, true>(q, pool, block_tables, seq_starts, seq_counts, seq_lens, out,
                            scratch, TT, max_rows, S, H, Dq, lanes, M, block_size, v_lanes, rope,
                            scale, stream);
}
