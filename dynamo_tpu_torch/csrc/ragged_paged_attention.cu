// Ragged mixed prefill+decode attention over the paged pool, bf16 in/out,
// f32 math. Two entry points: a bf16 pool, and an int8 pool with in-row
// scales.
//
// Replaces: the Pallas kernel `_ragged_attn_kernel` under
// `ragged_paged_attention_pallas` (dynamo_tpu/engine/attention.py:1255),
// which the llama ragged forward calls once per layer.
//
// Contract (the Pallas kernel without its MLA modes, `v_lanes` and
// `quant_sections`): q [TT, H, Dh] bf16 flat token rows, Dh 64, 96, 128
// or 256, GQA group g = H / KVH of 1-8 at Dh 64 and 128, 1, 2, 4 or 8 at Dh
// 96 and 256 (the wrapper's table; the kernel takes g at run time); one
// layer's pool k_cache/v_cache [NTOK, KVH*Dh] bf16 (token row =
// block id * block_size + offset); block_tables [S, M] int32; seq_starts,
// seq_counts, seq_lens [S] int32; win_base [S] int32 or null (a global
// layer). Sequence s owns the rows [starts[s], starts[s] + counts[s]) at
// the consecutive positions pos0 .. seq_lens[s] - 1 (pos0 = seq_lens[s] -
// counts[s]); its row r attends the keys kv_pos <= pos0 + r (keys past M *
// block_size are not read) and, with win_base, kv_pos > win_base[s] + r (a
// global layer's sentinel, -2^30, never masks). softcap > 0: each score s
// (after the scale) becomes softcap * tanh(s / softcap) before the mask. A
// count of 0 skips the sequence. At most
// max_rows rows of a sequence are computed. Only owned rows are written:
// the caller zero-fills `out`, so a row no sequence owns reads as zeros.
// (The TPU kernel writes a static window of Lmax rows per sequence and
// relies on its sequential grid for the next sequence to overwrite the
// overhang; here the CTAs run in parallel, so that would be a race.)
// `scratch` and `tickets` are workspace the caller allocates when the
// split plan below has more than one split, else null: scratch is f32,
// TT*KVH*splits*G*(Dh + 2) floats (acc [TT, KVH, splits, G, Dh], then m and
// l [TT, KVH, splits, G], the layout of K3's scratch); tickets is int32,
// one per (sequence, KV head, row tile), zero before the first call and
// left zero by every call.
//
// int8 mode (the Pallas kernel's `quant_lanes` mode, `dequant_tile`): pool
// rows are C + 128 int8 lanes (C = KVH*Dh): the values, then the row's
// scale as an exponent byte at lane C and a mantissa byte at C+1 (read
// & 0xFF), scale = 2^e * (1 + m/256), then pad lanes that are never read.
// The scale is taken out of the dot, as in K3: score = s_t * (q . k_t) and
// V's weight p_t * s_t. Against the Pallas kernel's dequantize-first form
// only the order and rounding of the sums change.
//
// Bound on an H100. The work's floor is bytes at the serving shapes: every
// sequence's keys are read once for K and once for V (sum_s seq_len_s *
// KVH * row bytes * 2) plus q and out, against 4*H*Dh operations per
// visible (row, key) pair: a decode row does ~4 flop per KV byte and a
// 64-row chunk ~250, both under the card's ~295 flop/byte balance point.
// At the serving batches the bytes take a few microseconds, and what
// decides the time is latency: the first design (one CTA walking a row
// tile's whole context with synchronous loads) served a 2048-key decode
// row as 8 CTAs each walking 32 tiles in series, and sat at 17.9x / 87.6x
// its bound in bf16 / int8 (PERF.md).
//
// Design (split-K flash attention over the pool):
// - A work item is (row tile, KV head, sequence): R = floor(64 / g) rows of
//   one sequence times the g query heads of one KV head, R * g (row, head)
//   query vectors ordered row-major, 16 per warp (K1's register layout,
//   csrc/flash_prefill.cu). The g heads and R rows share each K/V tile in
//   shared memory, so a chunk of T rows reads its KV once per item.
// - Where g does not divide 64 (g = 3, 5, 6, 7) the tile's last 64 - R * g
//   vectors are pads: vector V maps to row r0 + V / g, which for a pad is
//   the next tile's first row, and this tile's key range ends at its own
//   last row. A vector is owned only if V < R * g and its row is one the
//   sequence has: a pad's Q is zero-filled and it writes no output, no
//   partial and no (m, l), or it would overwrite the next tile's row with
//   one that lacks its own key (a race with no error).
// - Each item's keys are cut into chunks, one CTA per chunk: K3's plan
//   (128 keys rounded up to whole blocks, attention.decode_split_plan) for
//   a tile of at most 16 live query vectors, twice that for a wider tile,
//   whose merge would otherwise move more partials than its chunk moves KV
//   (attention.ragged_row_plan is the same rule in Python). The grid is
//   (row tiles * splits, KVH, S), sized on the host from max_rows and the
//   table width, never from seq_lens (they live on the device). A CTA whose
//   row tile starts past the sequence's count, or whose chunk starts past
//   the keys its last row sees, exits after one load of the sequence's
//   scalars. A 2048-key decode row is 16 CTAs per KV head.
// - Loads are asynchronous. The CTA turns its chunk's table entries into
//   one pool row per key (shared memory) while its Q tile arrives as
//   16-byte `cp.async` copies, then keeps three 32-key tiles of K and V in
//   flight in a shared ring, K and V in separate commit groups: V lands
//   while the scores are computed, and the next tiles' copies are in
//   flight during this tile's MMAs. Keys past the chunk's bound are
//   zero-filled by the copy (source size 0), never loaded, so a stale or
//   trash-block row cannot put a NaN into 0 * V.
// - QK^T and PV run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//   f32 accumulate) with fragments from `ldmatrix` (V through its transposed
//   form); the mask is per (row, key): kv_pos <= pos0 + r.
// - int8: each key row's scale chunk comes as one extra 16-byte copy with
//   the row. Each tile is turned into bf16 once per CTA in shared memory
//   (byte permutes and one bf16x2 subtraction per two values, exact: no
//   I2F, no ldexpf per vector), the row scales once per key; the K scale
//   multiplies the score, the V scale the probability.
// - A row tile with one live chunk writes its output directly. Otherwise
//   each CTA writes its f32 partials (m in the exp2 domain, l, acc) for
//   every owned (row, head) to scratch, and the item's last CTA to finish
//   (an atomic ticket per item after a fence; it resets the ticket to 0
//   for the next call) merges the item's chunks in index order (a chunk
//   with m = -inf weighs 0), with 16 loads of partials in flight per
//   thread. The atomic decides who merges, never the order, so two calls
//   give the same bits, and the call stays one launch.
// - Sliding window: the first row of a tile has the lowest floor, so the
//   keys at or below win_base + r0 are dead for every row of the tile: the
//   chunks entirely below it exit at once (the Pallas kernel's wave skip,
//   computed here from win_base on the device), the chunk that straddles it
//   starts at its first 32-key tile with a live key, and the merge reads
//   only the live chunks. Each (row, key) is masked at its own floor.
// - Soft-cap in the log2 domain (softcap * log2(e) there), tanh from one
//   exp2 and one fast division, accurate to a few f32 ulps of the cap.
// - Shared memory at Dh 128: 17 KB of Q plus a 52 KB ring in bf16 (the int8
//   ring is 28 KB plus 17 KB of converted tiles): three CTAs of 4 warps
//   share an SM, at most 168 registers each (launch bounds). At Dh 256 the
//   output accumulator alone is 128 registers a thread and Q 33 KB: two
//   stages of K and V in flight (66 KB in bf16; 34 KB plus 33 KB of
//   converted tiles in int8), two CTAs per SM at up to 255 registers.
// - Head dim 96 (phi3) takes Dh 128's tiling (three stages, three CTAs an
//   SM): six k-steps, twelve n-tiles, 12 16-byte pieces a bf16 row (6 and a
//   scale chunk in int8). Every copy loop here walks its pieces with a
//   stride of the block (no row step that assumes Dh / 8 divides it), and
//   the 208-byte padded row keeps ldmatrix's 8 rows in 8 bank groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_cap.cuh"

namespace {

constexpr int kRows = 64;           // (row, head) query vectors per CTA
constexpr int kKeys = 32;           // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkTarget = 128;   // attention.DECODE_CHUNK_TOKENS
constexpr int kMaxDevices = 64;

// KV tiles in flight and the CTAs per SM the budget is sized for, by head
// dim (Dh 256: the accumulator takes 128 registers, Q 33 KB)
template <int Dh>
struct Tiling {
  static constexpr int kStages = Dh == 256 ? 2 : 3;
  static constexpr int kMinBlocks = Dh == 256 ? 2 : 3;
};

__host__ __device__ inline int chunk_tokens(int block_size) {
  return block_size * ((kChunkTarget + block_size - 1) / block_size);
}

// a row tile's chunk in units of chunk_tokens, from its live (row, head)
// query vectors (attention.ragged_row_plan)
__host__ __device__ inline int chunk_mult(int vectors) { return vectors > 16 ? 2 : 1; }
constexpr int kMaxChunkMult = 2;

// Shared-memory layout of one CTA: Q, the K/V ring, (int8) the converted
// bf16 tiles and the row scales, then the chunk's pool rows.
template <int Dh, bool kInt8>
struct Smem {
  static constexpr int kStride = Dh + 8;                           // bf16 per row
  static constexpr int kRingRow = kInt8 ? Dh + 16 : kStride * 2;   // bytes
  static constexpr int kTile = kKeys * kRingRow;
  static constexpr int kQ = kRows * kStride * 2;
  static constexpr int kConv = kInt8 ? 2 * kKeys * kStride * 2 : 0;
  static constexpr int kScales = kInt8 ? 2 * kKeys * 4 : 0;
  static size_t bytes(int chunk) {
    return (size_t)kQ + 2 * Tiling<Dh>::kStages * kTile + kConv + kScales + 4 * (size_t)chunk;
  }
};

// The scratch of one call: acc [TT, KVH, S, G, Dh], then m and l [TT, KVH,
// S, G], all f32 (attention.split_scratch_views reads the same layout).
struct Scratch {
  float* acc;
  float* m;
  float* l;
  __device__ Scratch(float* base, int TT, int KVH, int S, int G, int Dh) {
    const long n = (long)TT * KVH * S * G;
    acc = base;
    m = base + n * Dh;
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

// Two int8 lanes (bytes 0 and 2 of p, the other bytes ignored) to bf16x2,
// exactly: v = low7 - 128 * sign, taken as (128 + low7) - (128 + 128 *
// sign), two bf16 values that carry the bits as their mantissa and
// exponent; the difference is an integer of [-128, 127], exact in bf16.
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

// Issue the copies of chunk keys [t0, t0 + kKeys) into a ring tile: one KV
// head's slice of each pool row (and the 16-byte scale chunk at lane C in
// int8); keys at or past n_valid are zero-filled.
template <int Dh, bool kInt8>
__device__ __forceinline__ void issue_tile(uint8_t* dst, const void* cache, const int* sRow,
                                           int t0, int n_valid, int C, int kvh) {
  using L = Smem<Dh, kInt8>;
  constexpr int kValBytes = kInt8 ? Dh : Dh * 2;
  constexpr int kPieces = kValBytes / 16 + (kInt8 ? 1 : 0);
  const uint8_t* pool = static_cast<const uint8_t*>(cache);
  const long stride = kInt8 ? (long)C + 128 : (long)C * 2;  // bytes per pool row
  for (int i = threadIdx.x; i < kKeys * kPieces; i += kThreads) {
    const int t = i / kPieces, p = i % kPieces;
    const bool ok = t0 + t < n_valid;
    const uint8_t* src = pool;
    if (ok) {
      const uint8_t* row = pool + (long)sRow[t0 + t] * stride;
      src = (kInt8 && p == kPieces - 1) ? row + C : row + (long)kvh * kValBytes + p * 16;
    }
    cp_async16(dst + t * L::kRingRow + p * 16, src, ok ? 16 : 0);
  }
}

// int8 ring tile -> bf16 tile (row stride Dh + 8) and each key's scale
// times `mul`
template <int Dh>
__device__ __forceinline__ void convert_tile(__nv_bfloat16* dst, float* scales,
                                             const uint8_t* src, float mul) {
  using L = Smem<Dh, true>;
  constexpr int kPieces = Dh / 16;
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
    uint4* d = reinterpret_cast<uint4*>(dst + t * L::kStride + p * 16);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
  if (threadIdx.x < kKeys)
    scales[threadIdx.x] = row_scale(src + threadIdx.x * L::kRingRow + Dh) * mul;
}

template <int Dh, bool kInt8>
__global__ void __launch_bounds__(kThreads, Tiling<Dh>::kMinBlocks)
ragged_attention_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                        const void* __restrict__ v_cache, const int* __restrict__ block_tables,
                        const int* __restrict__ seq_starts, const int* __restrict__ seq_counts,
                        const int* __restrict__ seq_lens, const int* __restrict__ win_base,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ scratch,
                        int* __restrict__ tickets, int TT, int H, int KVH, int M, int block_size,
                        int splits, int row_tiles, float scale_log2, float cap_log2) {
  using L = Smem<Dh, kInt8>;
  constexpr int kStages = Tiling<Dh>::kStages;
  constexpr int kStride = L::kStride;
  constexpr int kDSteps = Dh / 16;  // k-steps of the QK^T product
  constexpr int kDTiles = Dh / 8;   // n-tiles of the PV product
  constexpr int kKTiles = kKeys / 8;

  const int s = blockIdx.z, kvh = blockIdx.y;
  const int tile = blockIdx.x / splits, split = blockIdx.x % splits;
  const int g = H / KVH;
  const int rows_per_cta = kRows / g;
  const int r0 = tile * rows_per_cta;  // first row of the sequence's span
  // the sequence's scalars in one round trip
  const int Ls = seq_counts[s], len = seq_lens[s], start = seq_starts[s];
  if (r0 >= Ls) return;
  const int bs = block_size;
  const int pos0 = len - Ls;           // row r sits at position pos0 + r
  // keys this row tile can see: [0, pos0 + its last owned row + 1)
  const int last_row = min(r0 + rows_per_cta, Ls) - 1;
  const int n_keys = min(pos0 + last_row + 1, M * bs);
  // the tile's live query vectors pick its chunk: K3's plan for up to 16,
  // twice that for more (fewer partials to merge where many rows share
  // each key)
  const int n_vec = min(rows_per_cta, Ls - r0) * g;
  const int chunk = chunk_tokens(bs) * chunk_mult(n_vec);
  // sliding window: each row r masks the keys at or below win_base + r, so
  // the keys below k_lo (above the tile's first row's floor) are dead for
  // the whole tile; a global layer's sentinel leaves k_lo at 0
  const bool windowed = win_base != nullptr;
  const int wb = windowed ? win_base[s] : 0;
  const int k_lo = windowed ? min(max(wb + r0 + 1, 0), n_keys - 1) : 0;
  // the live chunks [k_lo / chunk, ceil(n_keys / chunk)); a dead one exits
  const int c_first = k_lo / chunk;
  if (split < c_first || split * chunk >= n_keys) return;
  const int n_live = (n_keys + chunk - 1) / chunk - c_first;
  // the chunk from its first 32-key tile with a live key
  const int kt0 = max(k_lo - split * chunk, 0) / kKeys;
  const int key0 = split * chunk + kt0 * kKeys;
  const int n_chunk = min(split * chunk + chunk, n_keys) - key0;
  const int C = KVH * Dh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + L::kQ;
  __nv_bfloat16* sKb = reinterpret_cast<__nv_bfloat16*>(ring + 2 * kStages * L::kTile);
  __nv_bfloat16* sVb = sKb + kKeys * kStride;
  float* sScale = reinterpret_cast<float*>(ring + 2 * kStages * L::kTile + L::kConv);
  int* sRow = reinterpret_cast<int*>(ring + 2 * kStages * L::kTile + L::kConv + L::kScales);
  __shared__ int sLast;
  __shared__ float sMx[kRows], sInv[kRows];

  // Q tile: vector v -> row r0 + v / g, head kvh*g + v % g; pad vectors
  // and rows past the span are zero-filled
  const int n_own = rows_per_cta * g;  // the tile's vectors; the rest pads
  {
    constexpr int kVec = Dh / 8;
    for (int i = tid; i < kRows * kVec; i += kThreads) {
      const int v = i / kVec, c = (i % kVec) * 8;
      const int r = r0 + v / g;
      const bool ok = v < n_own && r < Ls;
      const __nv_bfloat16* src = ok ? q + ((long)(start + r) * H + kvh * g + v % g) * Dh + c : q;
      cp_async16(sQ + v * kStride + c, src, ok ? 16 : 0);
    }
    cp_async_commit();
  }
  const int* table = block_tables + (long)s * M;
  for (int t = tid; t < n_chunk; t += kThreads) {
    const int key = key0 + t;
    sRow[t] = table[key / bs] * bs + key % bs;
  }
  __syncthreads();
  const int n_kt = (n_chunk + kKeys - 1) / kKeys;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    uint8_t* tK = ring + 2 * st * L::kTile;
    if (st < n_kt) issue_tile<Dh, kInt8>(tK, k_cache, sRow, st * kKeys, n_chunk, C, kvh);
    cp_async_commit();
    if (st < n_kt) issue_tile<Dh, kInt8>(tK + L::kTile, v_cache, sRow, st * kKeys, n_chunk, C, kvh);
    cp_async_commit();
  }

  // rows, absolute positions and window floors (-1 on a global layer) of
  // this thread's two vectors
  const int V0 = warp * 16 + gid, V1 = V0 + 8;
  const int row0 = r0 + V0 / g, row1 = r0 + V1 / g;
  // what this thread may write: neither a pad nor a row past the span
  const bool own0 = V0 < n_own && row0 < Ls, own1 = V1 < n_own && row1 < Ls;
  const int qpos0 = pos0 + row0, qpos1 = pos0 + row1;
  const int wlo0 = windowed ? wb + row0 : -1, wlo1 = windowed ? wb + row1 : -1;

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // ldmatrix lane addresses: Q's A fragments (16 vectors x 16 d), K's B
  // fragments (16 keys x 16 d: two n-tiles), V's transposed B fragments
  // (16 keys x 16 d)
  const __nv_bfloat16* qa = sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                            (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    uint8_t* tK = ring + 2 * st * L::kTile;
    uint8_t* tV = tK + L::kTile;
    cp_async_wait<2 * kStages - 1>();   // Q and this tile's K have landed
    __syncthreads();
    const __nv_bfloat16* sK;
    if constexpr (kInt8) {
      convert_tile<Dh>(sKb, sScale, tK, scale_log2);
      __syncthreads();
      sK = sKb;
    } else {
      sK = reinterpret_cast<const __nv_bfloat16*>(tK);
    }

    // S = Q K^T for this warp's 16 vectors x 32 keys
    float sc[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, qa + ks * 16);
#pragma unroll
      for (int j = 0; j < kKTiles; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, sK + j * 8 * kStride + k_off + ks * 16);
        mma_bf16_16816(sc[j], a, b[0], b[1]);
        mma_bf16_16816(sc[j + 1], a, b[2], b[3]);
      }
    }

    // scale into the log2 domain, soft-cap, per-(row, key) mask (causal
    // and window floor), online softmax
    const int kend = key0 + n_chunk;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = it * kKeys + j * 8 + tig * 2 + e;  // key in the chunk
        const int key = key0 + kl;
        const bool ok = key < kend;
        const float mul = kInt8 ? sScale[kl - it * kKeys] : scale_log2;
        float a = sc[j][e] * mul, b = sc[j][2 + e] * mul;
        if (cap_log2 > 0.f) {
          a = soft_cap(a, cap_log2);
          b = soft_cap(b, cap_log2);
        }
        a = (ok && key <= qpos0 && key > wlo0) ? a : -INFINITY;
        b = (ok && key <= qpos1 && key > wlo1) ? b : -INFINITY;
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
    // a vector with no visible key so far keeps m = -inf; its p and alpha
    // must come out 0, not NaN
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

    cp_async_wait<2 * kStages - 2>();  // this tile's V has landed
    __syncthreads();
    const __nv_bfloat16* sV;
    if constexpr (kInt8) {
      convert_tile<Dh>(sVb, sScale + kKeys, tV, 1.f);
      __syncthreads();
      // V's row scales into the probabilities (l keeps them unscaled)
#pragma unroll
      for (int j = 0; j < kKTiles; ++j) {
        const float w0 = sScale[kKeys + j * 8 + tig * 2], w1 = sScale[kKeys + j * 8 + tig * 2 + 1];
        sc[j][0] *= w0;
        sc[j][1] *= w1;
        sc[j][2] *= w0;
        sc[j][3] *= w1;
      }
      sV = sVb;
    } else {
      sV = reinterpret_cast<const __nv_bfloat16*>(tV);
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
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, sV + kk * 16 * kStride + v_off + j * 8);
        mma_bf16_16816(o[j], a, b[0], b[1]);
        mma_bf16_16816(o[j + 1], a, b[2], b[3]);
      }
    }

    // the stage is consumed: refill it with the tile kStages ahead
    __syncthreads();
    const int nt = it + kStages;
    if (nt < n_kt) issue_tile<Dh, kInt8>(tK, k_cache, sRow, nt * kKeys, n_chunk, C, kvh);
    cp_async_commit();
    if (nt < n_kt) issue_tile<Dh, kInt8>(tV, v_cache, sRow, nt * kKeys, n_chunk, C, kvh);
    cp_async_commit();
  }

  // the row sum is spread over the 4 threads of a quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const int h0 = V0 % g, h1 = V1 % g;
  if (n_live == 1) {  // one chunk: the output directly, owned rows only
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __nv_bfloat16* out0 = out + ((long)(start + row0) * H + kvh * g + h0) * Dh;
    __nv_bfloat16* out1 = out + ((long)(start + row1) * H + kvh * g + h1) * Dh;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const int c = j * 8 + tig * 2;
      if (own0)
        *reinterpret_cast<uint32_t*>(out0 + c) = pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      if (own1)
        *reinterpret_cast<uint32_t*>(out1 + c) = pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
    return;
  }

  // several chunks: this chunk's partials for the owned rows, then a ticket
  Scratch part(scratch, TT, KVH, splits, g, Dh);
  const long slot0 = (((long)(start + row0) * KVH + kvh) * splits + split) * g + h0;
  const long slot1 = (((long)(start + row1) * KVH + kvh) * splits + split) * g + h1;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int c = j * 8 + tig * 2;
    if (own0)
      *reinterpret_cast<float2*>(part.acc + slot0 * Dh + c) = make_float2(o[j][0], o[j][1]);
    if (own1)
      *reinterpret_cast<float2*>(part.acc + slot1 * Dh + c) = make_float2(o[j][2], o[j][3]);
  }
  if (tig == 0) {
    if (own0) {
      part.m[slot0] = m0;
      part.l[slot0] = l0;
    }
    if (own1) {
      part.m[slot1] = m1;
      part.l[slot1] = l1;
    }
  }
  // the CTA's writes, then one thread's fence (cumulative over what the
  // barrier ordered before it) and the ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    int* ticket = tickets + ((long)s * KVH + kvh) * row_tiles + tile;
    const bool last = atomicAdd(ticket, 1) == n_live - 1;
    if (last) {
      *ticket = 0;  // every chunk of the item has counted
      __threadfence();
    }
    sLast = last;
  }
  __syncthreads();
  if (!sLast) return;

  // the last chunk to finish merges the item's live chunks (from c_first
  // on) in index order: per
  // live vector the max of the chunks' m and 1 / sum(w l) with w =
  // exp2(m_c - max); then acc summed over the chunks, each thread keeping
  // kMergeItems x kMergeSplits 16-byte loads from L2 in flight
  if (tid < n_vec) {
    const int r = r0 + tid / g;
    const long base = (((long)(start + r) * KVH + kvh) * splits + c_first) * g + tid % g;
    // (m, l) of all the chunks in flight at once, eight at a time; the
    // max and the sum are then taken in index order
    float mv[8], lv[8];
    float mx = -INFINITY, den = 0.f;
    for (int c0 = 0; c0 < n_live; c0 += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool ok = c0 + k < n_live;
        mv[k] = ok ? __ldcg(part.m + base + (long)(c0 + k) * g) : -INFINITY;
        lv[k] = ok ? __ldcg(part.l + base + (long)(c0 + k) * g) : 0.f;
      }
      float mn = mx;
#pragma unroll
      for (int k = 0; k < 8; ++k) mn = fmaxf(mn, mv[k]);
      if (mn == -INFINITY) continue;
      den *= exp2f(mx - mn);  // 0 while mx is -inf
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (mv[k] != -INFINITY) den += exp2f(mv[k] - mn) * lv[k];
      mx = mn;
    }
    sMx[tid] = mx;
    sInv[tid] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  constexpr int kQuads = Dh / 4;
  constexpr int kMergeItems = 4, kMergeSplits = 4;
  const int n_items = n_vec * kQuads;
  for (int i0 = tid; i0 < n_items; i0 += kThreads * kMergeItems) {
    float4 acc[kMergeItems];
    long base[kMergeItems];
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int v = min(i0 + u * kThreads, n_items - 1) / kQuads;
      base[u] = (((long)(start + r0 + v / g) * KVH + kvh) * splits + c_first) * g + v % g;
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c0 = 0; c0 < n_live; c0 += kMergeSplits) {
      float mc[kMergeItems][kMergeSplits];
      float4 a[kMergeItems][kMergeSplits];
#pragma unroll
      for (int u = 0; u < kMergeItems; ++u)
#pragma unroll
        for (int k = 0; k < kMergeSplits; ++k) {
          const int c = c0 + k, i = i0 + u * kThreads;
          mc[u][k] = -INFINITY;
          a[u][k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c < n_live && i < n_items) {
            mc[u][k] = __ldcg(part.m + base[u] + (long)c * g);
            a[u][k] = __ldcg(reinterpret_cast<const float4*>(
                                 part.acc + (base[u] + (long)c * g) * Dh) + i % kQuads);
          }
        }
#pragma unroll
      for (int u = 0; u < kMergeItems; ++u) {
        const float mx = sMx[min(i0 + u * kThreads, n_items - 1) / kQuads];
#pragma unroll
        for (int k = 0; k < kMergeSplits; ++k) {
          const float w = mc[u][k] == -INFINITY ? 0.f : exp2f(mc[u][k] - mx);
          acc[u].x += w * a[u][k].x;
          acc[u].y += w * a[u][k].y;
          acc[u].z += w * a[u][k].z;
          acc[u].w += w * a[u][k].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n_items) continue;
      const int v = i / kQuads, c4 = i % kQuads;
      const float inv = sInv[v];
      __nv_bfloat16* o4 =
          out + ((long)(start + r0 + v / g) * H + kvh * g + v % g) * Dh + 4 * c4;
      *reinterpret_cast<uint2*>(o4) = make_uint2(pack_bf16(acc[u].x * inv, acc[u].y * inv),
                                                 pack_bf16(acc[u].z * inv, acc[u].w * inv));
    }
  }
}

// Raise the instantiation's dynamic shared-memory limit on the current
// device once, and ask for the largest shared-memory carveout so that
// Tiling<Dh>::kMinBlocks CTAs fit an SM.
template <int Dh, bool kInt8>
cudaError_t ensure_smem(size_t bytes) {
  static size_t granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ragged_attention_kernel<Dh, kInt8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ragged_attention_kernel<Dh, kInt8>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

template <int Dh, bool kInt8>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* starts, const int* counts, const int* lens, const int* win_base,
                   void* out, void* scratch, void* tickets, int TT, int S, int H, int KVH, int M,
                   int max_rows, int block_size, float scale, float softcap,
                   cudaStream_t stream) {
  const int chunk = chunk_tokens(block_size);
  const int splits = (M * block_size + chunk - 1) / chunk;
  if (splits > 1 && (scratch == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  const int rows_per_cta = kRows / (H / KVH);
  const int row_tiles = (max_rows + rows_per_cta - 1) / rows_per_cta;
  if ((long)row_tiles * splits > 0x7fffffffL || S > 65535) return cudaErrorInvalidValue;
  const size_t smem = Smem<Dh, kInt8>::bytes(kMaxChunkMult * chunk);
  cudaError_t err = ensure_smem<Dh, kInt8>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(row_tiles * splits, KVH, S);
  ragged_attention_kernel<Dh, kInt8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, tables, starts, counts, lens, win_base,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch), static_cast<int*>(tickets),
      TT, H, KVH, M, block_size, splits, row_tiles, scale * kLog2e, softcap * kLog2e);
  return cudaGetLastError();
}

#define DTT_RAGGED_ARGS                                                                   \
  q, k_cache, v_cache, tables, starts, counts, lens, win, out, scratch, tickets, TT, S, H, \
      KVH, M, max_rows, block_size, scale, softcap, st

template <bool kInt8>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* block_tables,
             const void* seq_starts, const void* seq_counts, const void* seq_lens,
             const void* win_base, void* out, void* scratch, void* tickets, int TT, int S, int H,
             int KVH, int Dh, int M, int max_rows, int block_size, float scale, float softcap,
             void* stream) {
  if (TT <= 0 || S <= 0 || max_rows <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || M <= 0 || block_size <= 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  // any group of up to 64 heads runs (g is a runtime value); the wrapper
  // holds the table of the tested ones (kernels.GROUPS)
  if (H / KVH > kRows) return (int)cudaErrorInvalidValue;
  const int* tables = static_cast<const int*>(block_tables);
  const int* starts = static_cast<const int*>(seq_starts);
  const int* counts = static_cast<const int*>(seq_counts);
  const int* lens = static_cast<const int*>(seq_lens);
  const int* win = static_cast<const int*>(win_base);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return (int)launch<64, kInt8>(DTT_RAGGED_ARGS);
    case 96:
      return (int)launch<96, kInt8>(DTT_RAGGED_ARGS);
    case 128:
      return (int)launch<128, kInt8>(DTT_RAGGED_ARGS);
    case 256:
      return (int)launch<256, kInt8>(DTT_RAGGED_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef DTT_RAGGED_ARGS

}  // namespace

// Both return a cudaError_t (0 = launched). Head dims 64/96/128/256 are
// compiled; the wrapper takes GQA group sizes 1-8 at Dh 64 and 128 and
// 1/2/4/8 at Dh 96 and 256 (kernels.GROUPS). `out` must be zero-filled by the caller
// (only owned rows are written). The int8 entry takes pools of KVH*Dh + 128
// int8 lanes per row. `win_base`: [S] int32 or null (a global layer);
// `softcap`: 0 = off. `scratch`, `tickets`: see the contract above.
extern "C" int dtt_ragged_paged_attention_bf16(const void* q, const void* k_cache,
                                               const void* v_cache, const void* block_tables,
                                               const void* seq_starts, const void* seq_counts,
                                               const void* seq_lens, const void* win_base,
                                               void* out, void* scratch, void* tickets, int TT,
                                               int S, int H, int KVH, int Dh, int M,
                                               int max_rows, int block_size, float scale,
                                               float softcap, void* stream) {
  return dispatch<false>(q, k_cache, v_cache, block_tables, seq_starts, seq_counts, seq_lens,
                         win_base, out, scratch, tickets, TT, S, H, KVH, Dh, M, max_rows,
                         block_size, scale, softcap, stream);
}

extern "C" int dtt_ragged_paged_attention_int8(const void* q, const void* k_cache,
                                               const void* v_cache, const void* block_tables,
                                               const void* seq_starts, const void* seq_counts,
                                               const void* seq_lens, const void* win_base,
                                               void* out, void* scratch, void* tickets, int TT,
                                               int S, int H, int KVH, int Dh, int M,
                                               int max_rows, int block_size, float scale,
                                               float softcap, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, block_tables, seq_starts, seq_counts, seq_lens,
                        win_base, out, scratch, tickets, TT, S, H, KVH, Dh, M, max_rows,
                        block_size, scale, softcap, stream);
}
