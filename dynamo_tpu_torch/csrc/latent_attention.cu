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
// read. `partials` is null, or f32 room for every split's partial softmax
// (rows * S * 16 * (512 + 2) floats, S = 16 splits for decode and 8 for
// ragged: acc [rows, 1, S, 16, 512], then m and l [rows, 1, S, 16], the
// layout attention.split_scratch_views reads), which the kernel then writes
// besides its output, for the tests: the merge itself never leaves the
// cluster.
//
// Bound on an H100. A (row, key) pair costs 4 * 16 * 576 operations on the
// tensor cores (2 * 16 * 640 for the scores of a bf16 row, 2 * 16 * 512
// for P.V). Decode reads each key for one row: ~57 operations per bf16
// byte, under the card's ~295 operations-per-byte balance point, so
// K3-MLA's floor is the latent rows' bytes (8 x 4096 keys: 41.9 MB,
// 12.5 us). A ragged prefill chunk of T rows reads each key for T rows: at
// T = 64 K4-MLA's floor is operations (two 64-row chunks and 6 decode rows
// at up to 4096 keys: 0.0154 ms at 989 TFLOP/s). Both end up bound by
// latency and shared memory instead: a K3-MLA CTA is a chain of dependent
// steps per key tile, and a K4-MLA CTA's mma.sync fragments read each key
// tile from shared memory once per row (PERF.md).
//
// Design (one kernel body, two tilings; attention.latent_split_plan and
// attention.ragged_row_plan are the same plan in Python):
// - A CTA of 8 warps takes a tile of kRows consecutive query rows of one
//   sequence (K4-MLA: 4 rows x 16 heads = 64 query vectors, attention.
//   LATENT_TILE_ROWS; K3-MLA: one decode row) and kGroups consecutive
//   splits of the keys the tile's last owned row sees (K4-MLA one, K3-MLA
//   two: two key streams, so that two warps share each scheduler). A unit
//   is one row of one stream, with kWpu warps (2 for K4-MLA, 4 for K3-MLA).
//   Every 32-key tile that lands in shared memory feeds all of its
//   stream's rows: the 640 lanes the scores, the first 512 lanes P.V (the
//   TPU kernel's skipped V stream). A 64-row chunk therefore reads its keys
//   from L2 16 times, not 64.
// - The eight CTAs of a thread-block cluster hold all the splits of one
//   row tile (8 for K4-MLA, 16 for K3-MLA). The tile's 32-key tiles are
//   spread evenly over them, from the keys it sees (read on the device): a
//   129-key decode row is five one-tile splits, a 4096-key row sixteen of
//   256 keys. Each split keeps its partial softmax (m in the exp2 domain,
//   l, acc) in its CTA's shared memory; after a cluster barrier, CTA c
//   merges output lanes [64c, 64c + 64) of every owned row from all live
//   splits (distributed shared memory), in split order, and writes them. No
//   partial reaches device memory, there is no second kernel and no
//   ticket, and two calls give the same bits. The grid is (8 * row tiles,
//   S) for ragged and (8, B) for decode: a function of the tensors' shapes
//   alone, so a CUDA graph can capture it; a tile past its sequence's count
//   exits as a whole cluster.
// - The warps of a unit split the 640-deep (int8: 576) Q.K^T product by
//   depth, mma.sync m16n8k16 over all 32 keys of the tile with Q and K
//   fragments by `ldmatrix`, and sum their partial scores through shared
//   memory in warp order (a named barrier per unit); each then takes the
//   row's online softmax (the same bits in each: same inputs, same order)
//   and P.V for its 256 (K4-MLA) or 128 (K3-MLA) of the 512 output lanes, V
//   fragments by `ldmatrix.trans` from the same tile. A row the sequence
//   does not own (a pad of the tile's last rows) loads zeros and skips
//   every product, and it writes no output and no partial: its query row
//   belongs to the next sequence or to no one. A row that sees none of a
//   key tile skips that tile.
// - Loads: `cp.async` 16-byte copies, kStages key tiles in flight a stream
//   (3 or 4 for K4-MLA, 2 for K3-MLA's two streams), keys past the split
//   zero-filled, never loaded. The CTA's block-table entries are read once
//   into shared memory while Q is in flight (up to kMaxBlocks; past that,
//   in a long context, each key's entry is read from the table). One CTA
//   an SM (up to 225 KB of shared memory: Q 81 KB and three 40.5 KB key
//   tiles for K4-MLA).
// - int8 rows: each tile is turned into bf16 once per CTA for all its rows
//   (byte permutes, exact, no I2F), its two section scales once per key.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kG = 16;             // query heads per row: the MMA's M
constexpr int kDq = 640;           // query / bf16 row lanes
constexpr int kDv = 512;           // v_lanes: the c_kv section
constexpr int kRope = 64;          // the k_pe section
constexpr int kDc = kDv + kRope;   // value lanes of an int8 row
constexpr int kInt8Row = 768;      // pad128(576 + 128)
constexpr int kKeys = 32;          // keys per tile (attention.LATENT_KEY_TILE)
constexpr int kMaxClusters = 16;   // clusters of one decode row
constexpr int kStride = kDq + 8;   // bf16 per shared row (1296 bytes: no bank conflicts)
constexpr int kSStride = kKeys + 4;  // floats per row of a partial score tile
constexpr int kAccStride = kDv + 8;  // floats per merged vector in shared memory
constexpr int kMaxBlocks = 1024;   // block-table entries a CTA keeps in shared memory
constexpr int kMaxDevices = 64;

// One instantiation's tiling: kRows query rows of 16 heads and kGroups
// key streams a CTA (a unit is one row of one stream), kWpu warps a unit,
// kStages key tiles in flight a stream, and its shared memory: the key
// loop's (Q, the ring, the converted tiles and their scales, the warps'
// partial scores, the split's table entries) and, over it afterwards, the
// merge's (acc, m and l of every unit's vectors, which the cluster reads,
// then this CTA's split weights).
template <bool kInt8, bool kRagged>
struct Cfg {
  static constexpr int kRows = kRagged ? 4 : 1;    // attention.LATENT_TILE_ROWS
  static constexpr int kGroups = kRagged ? 1 : 2;  // key streams
  static constexpr int kUnits = kRows * kGroups;
  // CTAs of a cluster (attention.LATENT_SPLITS for K4-MLA,
  // LATENT_DECODE_CLUSTER for K3-MLA) and the splits they hold
  static constexpr int kCluster = kRagged ? 8 : 2;
  static constexpr int kSplitsC = kCluster * kGroups;
  static constexpr int kMaxP = kRagged ? 1 : kMaxClusters;  // clusters a row tile
  static constexpr int kWarps = 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kWpu = kWarps / kUnits;
  static constexpr int kStages = kRagged ? (kInt8 ? 4 : 3) : 2;
  static constexpr int kDSteps = kInt8 ? kDc / 16 : kDq / 16;  // k-steps of Q K^T
  static constexpr int kSteps = kDSteps / kWpu;                // a warp's share
  static constexpr int kNT = kDv / 8 / kWpu;                   // P.V n-tiles a warp
  static constexpr int kCopiers = kThreads / kGroups;          // threads copying a stream
  static constexpr int kTpk = kCopiers / kKeys;                // copying threads a key
  static constexpr int kPieces = kInt8 ? kDc / 16 + 1 : kDq * 2 / 16;  // 16-byte copies a key
  static constexpr int kRingRow = kInt8 ? kDc + 16 : kStride * 2;     // bytes
  static constexpr int kTile = kKeys * kRingRow;
  static constexpr int kVec = kRows * kG;    // output vectors
  static constexpr int kPVec = kUnits * kG;  // partial vectors
  static constexpr int kQ = kVec * kStride * 2;
  static constexpr int kRing = kStages * kGroups * kTile;
  static constexpr int kConvTile = kKeys * kStride;  // bf16
  static constexpr int kConv = kInt8 ? kGroups * kConvTile * 2 : 0;
  static constexpr int kScales = kInt8 ? kGroups * 2 * kKeys * 4 : 0;
  static constexpr int kPart = kWarps * kG * kSStride * 4;
  static constexpr int kLoop = kQ + kRing + kConv + kScales + kPart + 4 * kMaxBlocks;
  // the merge: acc, m and l of the partial vectors, then the weights of
  // the cluster's splits (or of the row's clusters), 1 / den, the
  // cluster's max and den, and the last-cluster flag
  static constexpr int kW = kSplitsC > kMaxP ? kSplitsC : kMaxP;
  static constexpr int kMerge = 4 * (kPVec * kAccStride + 2 * kPVec + kW * kVec + 3 * kVec + 4);
  static constexpr int kSmem = kLoop > kMerge ? kLoop : kMerge;
  static_assert(kDSteps % kWpu == 0 && kNT % 2 == 0, "the warps of a unit split evenly");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
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

// the warps of one row meet here (barrier 0 is __syncthreads)
__device__ __forceinline__ void row_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// int8 ring tile -> bf16 tile (lanes [0, 576), row stride kStride) and
// each key's two section scales
template <int kThreads>
__device__ __forceinline__ void convert_tile(__nv_bfloat16* dst, float* scales,
                                             const uint8_t* src) {
  constexpr int kRingRow = kDc + 16;
  constexpr int kPieces = kDc / 16;
  for (int i = threadIdx.x; i < kKeys * kPieces; i += kThreads) {
    const int t = i / kPieces, p = i % kPieces;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + t * kRingRow + p * 16);
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
    const uint8_t* s = src + threadIdx.x * kRingRow + kDc;
    scales[threadIdx.x] = row_scale(s);
    scales[kKeys + threadIdx.x] = row_scale(s + 2);
  }
}

// S += Q K^T over k-steps [lo, hi) for 16 heads x the tile's 32 keys (four
// n-tiles): c[n] holds keys 8n + 2 * tig + {0, 1} of heads gid (0, 1) and
// gid + 8 (2, 3)
__device__ __forceinline__ void qk_steps(float (&c)[4][4], const __nv_bfloat16* qa,
                                         const __nv_bfloat16* kb, int lo, int hi) {
#pragma unroll 2
  for (int ks = lo; ks < hi; ++ks) {
    uint32_t a[4], b0[4], b1[4];
    ldsm_x4(a, qa + ks * 16);
    ldsm_x4(b0, kb + ks * 16);
    ldsm_x4(b1, kb + 16 * kStride + ks * 16);
    mma_bf16_16816(c[0], a, b0[0], b0[1]);
    mma_bf16_16816(c[1], a, b0[2], b0[3]);
    mma_bf16_16816(c[2], a, b1[0], b1[1]);
    mma_bf16_16816(c[3], a, b1[2], b1[3]);
  }
}

template <bool kInt8, bool kRagged>
__global__ void __cluster_dims__(Cfg<kInt8, kRagged>::kCluster, 1, 1)
    __launch_bounds__(Cfg<kInt8, kRagged>::kThreads, 1)
latent_attention_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ pool,
                        const int* __restrict__ tables, const int* __restrict__ starts,
                        const int* __restrict__ counts, const int* __restrict__ lens,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ partials,
                        float* __restrict__ cross, int* __restrict__ tickets, int rows, int M,
                        int block_size, int n_clusters, float scale_log2) {
  using C = Cfg<kInt8, kRagged>;
  constexpr int kStages = C::kStages, kThreads = C::kThreads, kCluster = C::kCluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // ragged: this cluster's row tile of sequence blockIdx.y; decode: its
  // index p of the n_clusters clusters of row blockIdx.y
  const int cl = blockIdx.x / kCluster;
  const int p = kRagged ? 0 : cl;
  const int s = blockIdx.y;
  // the tile: its first query row, the rows the sequence owns, and pos0
  // such that its row i sees pos0 + i + 1 keys
  int qrow0, n_own, pos0;
  if constexpr (kRagged) {
    const int count = counts[s];
    const int r0 = cl * C::kRows;
    if (r0 >= count) return;  // the whole cluster: no row of the tile is owned
    n_own = min(C::kRows, count - r0);
    pos0 = lens[s] - count + r0;
    qrow0 = starts[s] + r0;
  } else {
    n_own = 1;
    pos0 = lens[s] - 1;
    qrow0 = s;
  }
  const int* table = tables + (long)s * M;
  const int max_keys = M * block_size;
  // the keys the tile's last owned row sees, spread over its n_splits
  // splits in whole 32-key tiles; split (p * kCluster + rank) * kGroups + gg
  // is stream gg of CTA rank of cluster p, so this CTA's splits are
  // consecutive, from key key0c, stream gg's keys [key0c + gg * chunk,
  // + tokens(gg))
  const int n_splits = C::kSplitsC * n_clusters;
  const int n_keys = max(min(pos0 + n_own, max_keys), 0);
  const int chunk = kKeys * ((max((n_keys + kKeys - 1) / kKeys, 1) + n_splits - 1) / n_splits);
  const int n_live = (n_keys + chunk - 1) / chunk;
  const int split0 = (p * kCluster + rank) * C::kGroups;  // this CTA's first split
  const int key0c = split0 * chunk;
  auto tokens = [&](int gg) {  // stream gg's keys
    const int k0 = key0c + gg * chunk;
    return max(min(k0 + chunk, n_keys) - k0, 0);
  };
  auto tiles = [&](int gg) { return (tokens(gg) + kKeys - 1) / kKeys; };
  const int n_all = max(min(key0c + C::kGroups * chunk, n_keys) - key0c, 0);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  // this warp's unit (its stream g and row wr) and its part of the unit
  const int u = warp / C::kWpu, wh = warp % C::kWpu;
  const int g = u / C::kRows, wr = u % C::kRows;
  const bool row_live = wr < n_own;
  const int row_keys = max(min(pos0 + wr + 1, max_keys), 0);
  const int key0 = key0c + g * chunk;  // this warp's stream's first key
  const int g_tok = tokens(g);

  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + C::kQ;
  __nv_bfloat16* sConv = reinterpret_cast<__nv_bfloat16*>(ring + C::kRing);
  float* sScale = reinterpret_cast<float*>(ring + C::kRing + C::kConv);
  float* sPart = reinterpret_cast<float*>(ring + C::kRing + C::kConv + C::kScales);
  int* sBlk = reinterpret_cast<int*>(sPart + C::kWarps * kG * kSStride);
  // the CTA's table entries: read once into shared memory where they fit
  // (kMaxBlocks), else each key's entry from the table (a long context)
  const int blk0 = key0c / block_size;
  const int n_blk = n_all > 0 ? (key0c + n_all - 1) / block_size - blk0 + 1 : 0;
  const bool blk_shared = n_blk <= kMaxBlocks;
  auto slot = [&](int st, int gg) { return ring + (st * C::kGroups + gg) * C::kTile; };

  // this thread's stream, key of a tile and first 16-byte piece in copies
  const int cs = tid / C::kCopiers;
  const int kk = (tid % C::kCopiers) / C::kTpk, sub = tid % C::kTpk;
  const int cs_tok = tokens(cs), cs_kt = tiles(cs);
  auto pool_row = [&](int t) -> long {  // key kk of stream cs's tile t: its pool row, or -1
    const int kl = t * kKeys + kk;
    if (kl >= cs_tok) return -1;
    const int key = key0c + cs * chunk + kl;
    const int b = key / block_size;
    return (long)(blk_shared ? sBlk[b - blk0] : __ldg(table + b)) * block_size + key % block_size;
  };
  auto issue = [&](uint8_t* dst, long prow) {
    constexpr long kRowBytes = kInt8 ? kInt8Row : kDq * 2;
    const uint8_t* src = prow >= 0 ? pool + prow * kRowBytes : pool;
    for (int pc = sub; pc < C::kPieces; pc += C::kTpk)
      cp_async16(dst + kk * C::kRingRow + pc * 16, src + pc * 16, prow >= 0 ? 16 : 0);
  };

  float o[C::kNT][4];
#pragma unroll
  for (int j = 0; j < C::kNT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // heads gid, gid + 8

  const int n_it = tiles(0);  // the first stream has the most tiles
  if (n_it > 0) {
    // Q: the tile's rows x 16 heads x 640 lanes; a row the sequence does
    // not own loads zeros (its query row is another sequence's, or none)
    for (int i = tid; i < C::kVec * (kDq / 8); i += kThreads) {
      const int v = i / (kDq / 8), c = (i % (kDq / 8)) * 8;
      const bool ok = v / kG < n_own;
      const __nv_bfloat16* src = ok ? q + ((long)(qrow0 + v / kG) * kG + v % kG) * kDq + c : q;
      cp_async16(sQ + v * kStride + c, src, ok ? 16 : 0);
    }
    cp_async_commit();
    // the CTA's table entries in one round trip, while Q is in flight
    if (blk_shared)
      for (int i = tid; i < n_blk; i += kThreads) sBlk[i] = __ldg(table + blk0 + i);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (st < cs_kt) issue(slot(st, cs), pool_row(st));
      cp_async_commit();
    }
  }

  // ldmatrix lane addresses: this row's Q A fragments (16 heads x 16
  // lanes); K's B fragments (16 keys x 16 lanes: two n-tiles); V's
  // transposed B fragments (16 keys x 16 lanes), from this warp's lanes
  const __nv_bfloat16* qa =
      sQ + (wr * kG + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8 +
                    wh * (kDv / C::kWpu);
  const int lo = wh * C::kSteps, hi = lo + C::kSteps;
  float* myPart = sPart + warp * kG * kSStride;
  const float* unitPart = sPart + u * C::kWpu * kG * kSStride;
  const float* scales = sScale + g * 2 * kKeys;  // int8: this stream's tile's

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    // Q and this iteration's tiles have landed (the group of each tile
    // after the first kStages holds it alone, issued one iteration after
    // its stage was consumed)
    if (it == 0)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();
    // every warp is past the previous iteration: refill its stage with
    // each stream's tile kStages after it
    if (it > 0) {
      const int pt = it - 1 + kStages;
      if (pt < cs_kt) issue(slot((it - 1) % kStages, cs), pool_row(pt));
      cp_async_commit();
    }
    const __nv_bfloat16* sK;
    if constexpr (kInt8) {
#pragma unroll
      for (int gg = 0; gg < C::kGroups; ++gg)
        if (it < tiles(gg))
          convert_tile<kThreads>(sConv + gg * C::kConvTile, sScale + gg * 2 * kKeys, slot(st, gg));
      __syncthreads();
      sK = sConv + g * C::kConvTile;
    } else {
      sK = reinterpret_cast<const __nv_bfloat16*>(slot(st, g));
    }
    // the keys of this stream's tile that this warp's row sees
    const int lim = min(row_keys, key0 + g_tok) - (key0 + it * kKeys);
    if (row_live && lim > 0) {
      // this warp's share of the depth; an int8 row's two sections apart,
      // each scaled by its key's section scale
      float c[4][4] = {};
      if constexpr (kInt8) {
        qk_steps(c, qa, sK + k_off, lo, min(hi, kDv / 16));
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] *= scales[n * 8 + tig * 2 + (e & 1)];
        if (hi > kDv / 16) {
          float d[4][4] = {};
          qk_steps(d, qa, sK + k_off, max(lo, kDv / 16), hi);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c[n][e] += d[n][e] * scales[kKeys + n * 8 + tig * 2 + (e & 1)];
        }
      } else {
        qk_steps(c, qa, sK + k_off, lo, hi);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(myPart + gid * kSStride + n * 8 + tig * 2) =
            make_float2(c[n][0], c[n][1]);
        *reinterpret_cast<float2*>(myPart + (gid + 8) * kSStride + n * 8 + tig * 2) =
            make_float2(c[n][2], c[n][3]);
      }
      row_barrier(1 + u, C::kWpu * 32);

      // the row's scores: the unit's warps' parts summed in warp order,
      // into the log2 domain, keys the row does not see masked. p0 / p1:
      // heads gid / gid + 8, keys 8n + 2 * tig + {0, 1} at 2n + {0, 1}
      float p0[8], p1[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float2 x0 = *reinterpret_cast<const float2*>(unitPart + gid * kSStride + n * 8 + tig * 2);
        float2 x1 =
            *reinterpret_cast<const float2*>(unitPart + (gid + 8) * kSStride + n * 8 + tig * 2);
#pragma unroll
        for (int w = 1; w < C::kWpu; ++w) {
          const float* pw = unitPart + w * kG * kSStride;
          const float2 y0 = *reinterpret_cast<const float2*>(pw + gid * kSStride + n * 8 + tig * 2);
          const float2 y1 =
              *reinterpret_cast<const float2*>(pw + (gid + 8) * kSStride + n * 8 + tig * 2);
          x0.x += y0.x;
          x0.y += y0.y;
          x1.x += y1.x;
          x1.y += y1.y;
        }
        const int key = n * 8 + tig * 2;
        p0[2 * n] = key < lim ? x0.x * scale_log2 : -INFINITY;
        p0[2 * n + 1] = key + 1 < lim ? x0.y * scale_log2 : -INFINITY;
        p1[2 * n] = key < lim ? x1.x * scale_log2 : -INFINITY;
        p1[2 * n + 1] = key + 1 < lim ? x1.y * scale_log2 : -INFINITY;
      }

      // online softmax over the tile's 32 keys
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
      // the row sees a key of this tile, so mx is finite
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p0[i] = exp2f(p0[i] - mx0);
        p1[i] = exp2f(p1[i] - mx1);
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
      for (int j = 0; j < C::kNT; ++j) {
        o[j][0] *= alpha0;
        o[j][1] *= alpha0;
        o[j][2] *= alpha1;
        o[j][3] *= alpha1;
      }
      if constexpr (kInt8) {  // V's c_kv scale into the weights (l keeps them unscaled)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float vs = scales[(i / 2) * 8 + tig * 2 + i % 2];
          p0[i] *= vs;
          p1[i] *= vs;
        }
      }

      // O += P V over this warp's output lanes, V the same tile's first 512
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t a[4];
        a[0] = pack_bf16(p0[k2 * 4], p0[k2 * 4 + 1]);
        a[1] = pack_bf16(p1[k2 * 4], p1[k2 * 4 + 1]);
        a[2] = pack_bf16(p0[k2 * 4 + 2], p0[k2 * 4 + 3]);
        a[3] = pack_bf16(p1[k2 * 4 + 2], p1[k2 * 4 + 3]);
#pragma unroll
        for (int j = 0; j < C::kNT; j += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, sK + k2 * 16 * kStride + v_off + j * 8);
          mma_bf16_16816(o[j], a, b[0], b[1]);
          mma_bf16_16816(o[j + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // each unit's partial into shared memory over Q and the ring (every copy
  // has landed and been read)
  cp_async_wait<0>();
  __syncthreads();
  float* sAcc = reinterpret_cast<float*>(smem);  // [kPVec][kAccStride]
  float* sM = sAcc + C::kPVec * kAccStride;
  float* sL = sM + C::kPVec;
  float* sW = sL + C::kPVec;  // [kW][kVec]: this CTA's own, never read by the cluster
  float* sInv = sW + C::kW * C::kVec;
  float* sMx = sInv + C::kVec;
  float* sDen = sMx + C::kVec;
  int* sLast = reinterpret_cast<int*>(sDen + C::kVec);
  const int v0 = u * kG + gid, v1 = v0 + 8;
  const int col0 = wh * (kDv / C::kWpu) + tig * 2;
  // (a CTA with no key reads none of this: its splits are not live)
#pragma unroll
  for (int j = 0; j < C::kNT && n_it > 0; ++j) {
    *reinterpret_cast<float2*>(sAcc + v0 * kAccStride + col0 + j * 8) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(sAcc + v1 * kAccStride + col0 + j * 8) = make_float2(o[j][2], o[j][3]);
  }
  if (wh == 0 && tig == 0) {
    sM[v0] = m0;
    sL[v0] = l0;
    sM[v1] = m1;
    sL[v1] = l1;
  }
  const int sp = split0 + g;  // this warp's split
  if (partials != nullptr && row_live && sp < n_live) {  // for the tests
    const long n = (long)rows * n_splits * kG;
    const long slot0 = ((long)(qrow0 + wr) * n_splits + sp) * kG + gid;
    float* acc = partials + slot0 * kDv + col0;
#pragma unroll
    for (int j = 0; j < C::kNT; ++j) {
      *reinterpret_cast<float2*>(acc + j * 8) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(acc + 8 * kDv + j * 8) = make_float2(o[j][2], o[j][3]);
    }
    if (wh == 0 && tig == 0) {
      partials[n * kDv + slot0] = m0;
      partials[n * kDv + slot0 + 8] = m1;
      partials[n * (kDv + 1) + slot0] = l0;
      partials[n * (kDv + 1) + slot0 + 8] = l1;
    }
  }
  cluster.sync();  // every split's partial is in its CTA's shared memory

  // this CTA merges output lanes [kSlice * rank, + kSlice) of every owned
  // row over the cluster's live splits: their weights exp2(m - max m) (0
  // for m = -inf) and 1 / sum(w l) per vector, then sum(w acc) in split
  // order. The cluster's split ls is stream ls % kGroups of CTA ls /
  // kGroups.
  constexpr int kSlice = kDv / kCluster;
  constexpr int kQuads = kSlice / 4;  // float4s of a vector's slice
  const int nl = min(max(n_live - p * C::kSplitsC, 0), C::kSplitsC);  // the cluster's live splits
  auto pvec = [](int ls, int v) { return ((ls % C::kGroups) * C::kRows + v / kG) * kG + v % kG; };
  if (tid < C::kVec) {
    float mv[C::kSplitsC], lv[C::kSplitsC];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < C::kSplitsC; ++c) {
      mv[c] = -INFINITY;
      lv[c] = 0.f;
      if (c < nl) {
        mv[c] = cluster.map_shared_rank(sM, c / C::kGroups)[pvec(c, tid)];
        lv[c] = cluster.map_shared_rank(sL, c / C::kGroups)[pvec(c, tid)];
      }
      mx = fmaxf(mx, mv[c]);
    }
    float den = 0.f;
#pragma unroll
    for (int c = 0; c < C::kSplitsC; ++c) {
      const float w = mv[c] == -INFINITY ? 0.f : exp2f(mv[c] - mx);
      sW[c * C::kVec + tid] = w;
      den += w * lv[c];
    }
    sInv[tid] = den > 0.f ? 1.f / den : 0.f;
    sMx[tid] = mx;
    sDen[tid] = den;
  }
  __syncthreads();
  // one cluster a row tile: the output; else (decode) the cluster's
  // partial, unnormalized, into `cross` [rows, n_clusters, 16, 512 + 2]
  const long nx = (long)rows * n_clusters * kG;
  for (int i = tid; i < C::kVec * kQuads; i += kThreads) {
    const int v = i / kQuads;
    if (v / kG >= n_own || (n_clusters > 1 && nl == 0)) continue;
    const int col = rank * kSlice + (i % kQuads) * 4;
    float4 a[C::kSplitsC];  // every live split's slice in flight at once
#pragma unroll
    for (int c = 0; c < C::kSplitsC; ++c)
      a[c] = c < nl ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(sAcc, c / C::kGroups) +
                                                       pvec(c, v) * kAccStride + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < C::kSplitsC; ++c) {
      const float w = sW[c * C::kVec + v];
      r.x += w * a[c].x;
      r.y += w * a[c].y;
      r.z += w * a[c].z;
      r.w += w * a[c].w;
    }
    const long row = qrow0 + v / kG;
    if (n_clusters == 1) {
      const float inv = sInv[v];
      *reinterpret_cast<uint2*>(out + (row * kG + v % kG) * kDv + col) =
          make_uint2(pack_bf16(r.x * inv, r.y * inv), pack_bf16(r.z * inv, r.w * inv));
    } else {
      *reinterpret_cast<float4*>(cross + ((row * n_clusters + p) * kG + v % kG) * kDv + col) = r;
    }
  }
  if (n_clusters == 1 || kRagged) {
    cluster.sync();  // no CTA leaves while another reads its shared memory
    return;
  }
  if (rank == 0 && tid < C::kVec && nl > 0) {  // decode: kVec is the row's 16 heads
    const long slot = ((long)qrow0 * n_clusters + p) * kG + tid;
    cross[nx * kDv + slot] = sMx[tid];
    cross[nx * (kDv + 1) + slot] = sDen[tid];
  }
  // the cluster's writes, one thread's fence a CTA (cumulative over what
  // the barrier ordered before it), then the row's ticket: the last of its
  // clusters to count merges them all (and resets the ticket to 0)
  __syncthreads();
  if (tid == 0) __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) {
    const bool last = atomicAdd(tickets + qrow0, 1) == n_clusters - 1;
    if (last) {
      tickets[qrow0] = 0;
      __threadfence();
    }
    *sLast = last;
  }
  cluster.sync();
  const bool last = *cluster.map_shared_rank(sLast, 0);
  cluster.sync();  // rank 0's flag is read: from here no CTA reads another's
  if (!last) return;

  // the row's clusters with a live split, merged in index order over this
  // CTA's lanes: weights exp2(m_p - max m) and 1 / sum(w l), then sum(w acc)
  const int nc = (n_live + C::kSplitsC - 1) / C::kSplitsC;
  if (tid < C::kVec) {
    const long slot = (long)qrow0 * n_clusters * kG + tid;
    float mx = -INFINITY;
    for (int c = 0; c < nc; ++c) mx = fmaxf(mx, __ldcg(cross + nx * kDv + slot + c * kG));
    float den = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float mc = __ldcg(cross + nx * kDv + slot + c * kG);
      const float w = mc == -INFINITY ? 0.f : exp2f(mc - mx);
      sW[c * C::kVec + tid] = w;
      den += w * __ldcg(cross + nx * (kDv + 1) + slot + c * kG);
    }
    sInv[tid] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < C::kVec * kQuads; i += kThreads) {
    const int v = i / kQuads;
    const int col = rank * kSlice + (i % kQuads) * 4;
    const float* base = cross + ((long)qrow0 * n_clusters * kG + v) * kDv + col;
    float4 a[kMaxClusters];
#pragma unroll
    for (int c = 0; c < kMaxClusters; ++c)
      a[c] = c < nc ? __ldcg(reinterpret_cast<const float4*>(base + (long)c * kG * kDv))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kMaxClusters; ++c) {
      if (c >= nc) break;
      const float w = sW[c * C::kVec + v];
      r.x += w * a[c].x;
      r.y += w * a[c].y;
      r.z += w * a[c].z;
      r.w += w * a[c].w;
    }
    const float inv = sInv[v];
    *reinterpret_cast<uint2*>(out + ((long)qrow0 * kG + v) * kDv + col) =
        make_uint2(pack_bf16(r.x * inv, r.y * inv), pack_bf16(r.z * inv, r.w * inv));
  }
}

// Raise the instantiation's dynamic shared-memory limit on the current
// device once, with the largest carveout (one CTA an SM).
template <bool kInt8, bool kRagged>
cudaError_t ensure_smem() {
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(latent_attention_kernel<kInt8, kRagged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<kInt8, kRagged>::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(latent_attention_kernel<kInt8, kRagged>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) granted[dev] = true;
  return err;
}

// rows: B (decode) or TT (ragged); grid_rows x grid_seqs: (B, 1) or
// (max_rows, S); n_clusters: the clusters of a decode row (ragged: 1)
template <bool kInt8, bool kRagged>
int launch(const void* q, const void* pool, const void* tables, const void* starts,
           const void* counts, const void* lens, void* out, void* partials, void* cross,
           void* tickets, int rows, int grid_rows, int grid_seqs, int n_clusters, int H, int Dq,
           int lanes, int M, int block_size, int v_lanes, int rope, float scale,
           void* stream_ptr) {
  using C = Cfg<kInt8, kRagged>;
  if (rows <= 0 || grid_rows <= 0 || grid_seqs <= 0) return 0;
  const long tiles = kRagged ? (grid_rows + C::kRows - 1) / C::kRows : n_clusters;
  const long max_keys = (long)M * block_size;
  if (H != kG || Dq != kDq || v_lanes != kDv || lanes != (kInt8 ? kInt8Row : kDq) ||
      (kInt8 && rope != kRope) || M <= 0 || block_size <= 0 || max_keys > (1L << 30) ||
      n_clusters < 1 || n_clusters > C::kMaxP ||
      (n_clusters > 1 && (cross == nullptr || tickets == nullptr)) ||
      (kRagged ? grid_seqs : grid_rows) > 65535 || tiles * C::kCluster > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem<kInt8, kRagged>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = dim3((unsigned)(tiles * C::kCluster), kRagged ? grid_seqs : grid_rows);
  latent_attention_kernel<kInt8, kRagged><<<grid, C::kThreads, C::kSmem,
                                            static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partials),
      static_cast<float*>(cross), static_cast<int*>(tickets), rows, M, block_size, n_clusters,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// How many of the instantiation's clusters the current device runs at
// once (cudaOccupancyMaxActiveClusters), or -1 on an error.
template <bool kInt8, bool kRagged>
int max_active_clusters() {
  if (ensure_smem<kInt8, kRagged>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  constexpr int kCluster = Cfg<kInt8, kRagged>::kCluster;
  cfg.gridDim = dim3(kCluster * 64, 1, 1);
  cfg.blockDim = dim3(Cfg<kInt8, kRagged>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = Cfg<kInt8, kRagged>::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, latent_attention_kernel<kInt8, kRagged>, &cfg) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// The clusters the device holds at once (8 CTAs for ragged, 2 for decode:
// ragged = 0), over a bf16 (int8 = 0) or int8 pool.
extern "C" int dtt_latent_max_active_clusters(int int8, int ragged) {
  if (int8)
    return ragged ? max_active_clusters<true, true>() : max_active_clusters<true, false>();
  return ragged ? max_active_clusters<false, true>() : max_active_clusters<false, false>();
}

// All four return a cudaError_t (0 = launched). Compiled for DeepSeek-V2's
// latent rows: 16 query heads, a 640-lane query, v_lanes 512 and, over an
// int8 pool of 768 lanes, the sections (512, 64). `partials`: see the
// contract above (null: not written). Decode: `n_clusters` (1 to 16)
// clusters a row; above 1, `cross` is f32 room for their partials (B *
// n_clusters * 16 * (512 + 2) floats) and `tickets` B int32, zero before
// the call and left zero by it.
extern "C" int dtt_latent_paged_attention_bf16(const void* q, const void* pool,
                                               const void* block_tables, const void* seq_lens,
                                               void* out, void* partials, void* cross,
                                               void* tickets, int B, int n_clusters, int H,
                                               int Dq, int lanes, int M, int block_size,
                                               int v_lanes, int rope, float scale, void* stream) {
  return launch<false, false>(q, pool, block_tables, nullptr, nullptr, seq_lens, out, partials,
                              cross, tickets, B, B, 1, n_clusters, H, Dq, lanes, M, block_size,
                              v_lanes, rope, scale, stream);
}

extern "C" int dtt_latent_paged_attention_int8(const void* q, const void* pool,
                                               const void* block_tables, const void* seq_lens,
                                               void* out, void* partials, void* cross,
                                               void* tickets, int B, int n_clusters, int H,
                                               int Dq, int lanes, int M, int block_size,
                                               int v_lanes, int rope, float scale, void* stream) {
  return launch<true, false>(q, pool, block_tables, nullptr, nullptr, seq_lens, out, partials,
                             cross, tickets, B, B, 1, n_clusters, H, Dq, lanes, M, block_size,
                             v_lanes, rope, scale, stream);
}

// `out` must be zero-filled by the caller (only owned rows are written).
extern "C" int dtt_latent_ragged_attention_bf16(const void* q, const void* pool,
                                                const void* block_tables, const void* seq_starts,
                                                const void* seq_counts, const void* seq_lens,
                                                void* out, void* partials, int TT, int S,
                                                int max_rows, int H, int Dq, int lanes, int M,
                                                int block_size, int v_lanes, int rope,
                                                float scale, void* stream) {
  return launch<false, true>(q, pool, block_tables, seq_starts, seq_counts, seq_lens, out,
                             partials, nullptr, nullptr, TT, max_rows, S, 1, H, Dq, lanes, M,
                             block_size, v_lanes, rope, scale, stream);
}

extern "C" int dtt_latent_ragged_attention_int8(const void* q, const void* pool,
                                                const void* block_tables, const void* seq_starts,
                                                const void* seq_counts, const void* seq_lens,
                                                void* out, void* partials, int TT, int S,
                                                int max_rows, int H, int Dq, int lanes, int M,
                                                int block_size, int v_lanes, int rope,
                                                float scale, void* stream) {
  return launch<true, true>(q, pool, block_tables, seq_starts, seq_counts, seq_lens, out,
                            partials, nullptr, nullptr, TT, max_rows, S, 1, H, Dq, lanes, M,
                            block_size, v_lanes, rope, scale, stream);
}
