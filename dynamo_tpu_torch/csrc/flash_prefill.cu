// Causal GQA flash attention for one prefill chunk, bf16 in/out, f32 math.
//
// Replaces: the Pallas kernel `_flash_prefill_kernel` under `flash_prefill`
// (dynamo_tpu/engine/attention.py), which the llama prefill path calls once
// per layer on the K/V it gathered from the paged pool.
//
// Contract (same as the Pallas kernel): q [T, H, Dh], k/v [S, KVH, Dh], all
// contiguous bf16, Dh 64, 96, 128 or 256. Query t sits at absolute position
// start_pos + t and sees key j iff j <= start_pos + t and j < seq_len, and
// on a sliding layer (window > 0: the caller passes the window only there)
// also j > start_pos + t - window. With cap > 0 each score s (after the
// scale) becomes cap * tanh(s / cap) before the mask (gemma2 soft-capping).
// Rows past the chunk's true length attend real keys and are discarded by
// the caller, so every row gets a finite output (a pad row that sees no key
// gets zeros). Returns out [T, H, Dh] bf16.
//
// Bound on an H100. The work's floor: at T = S = 2048, H = 32, Dh = 128 the
// causal half is 4*H*Dh*T*S/2 ~ 34 GFLOP against ~34 MB of q/k/v/out, so
// long chunks are floored by tensor-core operations; at T = 512 the floor
// is the bytes. The first design loaded each KV tile with plain
// synchronous loads, then a barrier, then the MMAs, so loads and
// tensor-core work never overlapped; built V's MMA fragments from four
// 16-bit shared loads each; masked every element of every tile; and issued
// the row blocks lightest first, so the CTAs with most tiles formed the
// tail (PERF.md: 1.26x SDPA's time on a prefix hit, 10x the operations
// floor on a 1900-token prompt).
//
// Design: one CTA of 4 warps per (64 query rows, KV head), three CTAs per
// SM (launch bounds cap the registers at 168). The rows of a CTA are
// (position, head) pairs ordered position-major over the g = H/KVH query
// heads that share the KV head, so each K/V tile is loaded once for all g
// heads. Each warp owns 16 rows. The TPU kernel's sequential KV grid axis
// becomes a loop over 64-key tiles from 0 to the last tile any row of the
// CTA can see (the causal diagonal, capped by seq_len), and the row blocks
// are issued last first, the ones with most tiles at the head of the
// grid.
// - cp.async copies in commit groups of one tile's K or V: at the top of
//   tile i the CTA starts V_i and K_{i+1} (two K buffers, one V buffer), so
//   the next tile's K is in flight for the whole of this tile and V_i
//   during QK^T and the softmax; a warp waits for V only before PV. Each
//   thread copies fixed 16-byte columns of every 8th (Dh 128) or 16th row.
// - QK^T and PV run on the tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate), the fragments of Q and K from ldmatrix and of V
//   from ldmatrix.trans. Q stays in shared memory and is read per k-step
//   (FlashAttention-2's default), which frees the registers its fragments
//   held (32 a thread), so K's fragments can be loaded ahead of their
//   MMAs.
//   The running max m, the sum l and the output accumulator live in
//   registers (FlashAttention-2 layout).
// - Only a tile that straddles a warp's causal diagonal or seq_len is
//   masked element by element; a tile past all of a warp's rows is
//   skipped by that warp (its scores would all be -inf: alpha 1, p 0).
// - Sliding window (gemma2's local layers): the key loop starts at the
//   first tile that is not entirely below every row's window (the CTA's
//   first row has the lowest floor), as the Pallas kernel starts at its
//   first live chunk; a warp skips a tile below all of its rows' windows as
//   it skips one past its diagonal, and only a tile that straddles a row's
//   floor is masked element by element.
// - Soft-cap: cap * tanh(s / cap) on each score in the log2 domain (the cap
//   times log2(e) there), tanh from one exp2 and one fast division: exact to
//   a few f32 ulps of the cap, where the MUFU tanh.approx (~2^-11 relative)
//   would move a score by up to 0.04 at a cap of 50.
// - Head dim 256 (gemma2): the f32 output accumulator of a warp's 16 rows
//   alone is 128 registers a thread, so the key tile narrows to 32 keys (16
//   score registers) and the CTAs per SM to two (launch bounds cap the
//   registers at 255): 82.5 KB of shared memory a CTA (Q 33 KB, two K tiles
//   and one V tile of 16.5 KB each).
// - Head dim 96 (phi3): the 64-key, three-CTA tiling of Dh 128, six
//   k-steps of QK^T and twelve n-tiles of PV. A row is 12 16-byte pieces,
//   which do not divide the 128 threads, so the tile and Q loads number
//   their pieces row-major (load_tile). The padded row stride is 104 bf16
//   (208 bytes: 13 16-byte units), so the 8 rows of an ldmatrix matrix
//   start in 8 different 16-byte bank groups, as at 136 bf16 for Dh 128.
// Measured on the card against this design (PERF.md, Findings): 8-warp
// CTAs, a 3-stage ring of K and V with Q's fragments in registers, two V
// buffers, and two m-tiles per warp (255 registers and a spill) were each
// slower on the causal cases. wgmma with warp specialisation
// (FlashAttention-3) is the next step.
//
// K2, the partial mode (the body's template flag Partial, launched as
// `flash_prefill_partial_kernel`; K1 is `flash_prefill_kernel`). Replaces
// the Pallas kernel under `flash_prefill_partial`
// (dynamo_tpu/engine/attention.py), K1's body run in partial mode: one hop
// of ring attention. Same inputs, but start_pos may be negative (queries
// before this KV chunk see nothing); returns the UNNORMALIZED f32
// accumulator acc [T, H, Dh] and the row state m, l [T, H] f32, which the
// caller merges across hops with the online-softmax recurrence. What differs from K1, and why:
// - m is returned in natural units (m_log2 * ln 2): the loop keeps it in
//   the base-2 domain of exp2f, but the merge computes exp(m_a - m_b).
// - A row that sees no key (qpos < 0, or key >= seq_len for all keys) gets
//   acc = 0, l = 0 and m = -1e30 exactly (JAX's NEG_INF). Its masked
//   scores are -inf and its base stays 0, so p = exp2f(-inf) = 0 and
//   alpha = 0; a warp whose rows see no key of a tile skips it, which
//   leaves the same zeros: the row stays zero whether its CTA walks tiles
//   for other, live rows or walks none (n_keys <= 0 makes n_tiles 0, and
//   every row is still written).
// - Bound: same work as K1 per visible (query, key) pair, plus 4 bytes
//   per output value instead of 2.
// - Global attention without a soft-cap only: the ring serves only such
//   models (window 0 and cap 0 here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_cap.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // query rows per CTA
constexpr float kLn2 = 0.6931471805599453f;

// keys per KV tile and CTAs per SM, by head dim: at Dh 256 the output
// accumulator takes 128 registers a thread, so the tile narrows to 32 keys
// and the SM holds two CTAs at up to 255 registers each
template <int Dh>
struct Tiling {
  static constexpr int kKeys = Dh == 256 ? 32 : 64;
  static constexpr int kMinBlocks = Dh == 256 ? 2 : 3;
};

constexpr float kNegInf = -1e30f;  // JAX's NEG_INF: the m of a row with no key

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

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

// Shared memory, in bf16 elements: Q [kRows x (Dh + 8)], two K tiles and
// one V tile [kKeys x (Dh + 8)] (rows padded by 8 bf16, so the 8 rows of
// an ldmatrix 8x8 matrix hit 32 banks).
template <int Dh>
struct Smem {
  static constexpr int kStride = Dh + 8;
  static constexpr int kTile = Tiling<Dh>::kKeys * kStride;
  static constexpr int kK = kRows * kStride;
  static constexpr int kV = kK + 2 * kTile;
  static constexpr int kBytes = (kV + kTile) * (int)sizeof(__nv_bfloat16);
};

// Copy kKeys rows of Dh bf16 (global row stride `gstride` elements) into a
// shared tile with row stride Dh + 8; rows at or past `valid` are
// zero-filled. Where Dh / 8 divides the threads (Dh 64, 128, 256), thread t
// copies 16-byte column t % (Dh / 8) of every (kThreads / (Dh / 8))-th row
// from row t / (Dh / 8) on. Otherwise (Dh 96: 12 pieces a row) the tile's
// pieces are numbered row-major and thread t copies pieces t, t +
// kThreads, ... (6 a thread); that general form costs the other head dims
// registers (a spill at Dh 128) and time, so they keep theirs.
template <int Dh>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          long gstride, int valid) {
  constexpr int kKeys = Tiling<Dh>::kKeys;
  constexpr int kVec = Dh / 8;
  if constexpr (kThreads % kVec == 0) {
    constexpr int kStep = kThreads / kVec;
    const int r0 = threadIdx.x / kVec, c = (threadIdx.x % kVec) * 8;
    const __nv_bfloat16* src = gmem + r0 * gstride + c;
    __nv_bfloat16* dst = smem + r0 * (Dh + 8) + c;
#pragma unroll
    for (int i = 0; i < kKeys / kStep; ++i) {
      const bool ok = r0 + i * kStep < valid;
      cp_async16(dst + i * kStep * (Dh + 8), ok ? src + i * kStep * gstride : gmem,
                 ok ? 16 : 0);
    }
  } else {
    static_assert(kKeys * kVec % kThreads == 0, "a tile's pieces must fill whole passes");
#pragma unroll
    for (int i = 0; i < kKeys * kVec / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kVec, c = (idx % kVec) * 8;
      const bool ok = r < valid;
      cp_async16(smem + r * (Dh + 8) + c, ok ? gmem + r * gstride + c : gmem, ok ? 16 : 0);
    }
  }
}

// out: bf16 [T, H, Dh] (K1), or f32 acc [T, H, Dh] with m_out/l_out
// [T, H] f32 (Partial, K2; K1 gets null pointers there)
template <int Dh, bool Partial>
__device__ __forceinline__ void flash_prefill_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, void* __restrict__ out_raw, float* __restrict__ m_out,
    float* __restrict__ l_out, int T, int H, int KVH, int S, int start_pos, int seq_len,
    int window, float scale_log2, float cap_log2) {
  using Sm = Smem<Dh>;
  constexpr int kKeys = Tiling<Dh>::kKeys;
  constexpr int kStride = Sm::kStride;
  constexpr int kDSteps = Dh / 16;  // k-steps of the QK^T product
  constexpr int kDTiles = Dh / 8;   // n-tiles of the PV product
  constexpr int kKTiles = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK0 = sQ + Sm::kK;
  __nv_bfloat16* sV = sQ + Sm::kV;

  const int g = H / KVH;
  const int kvh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest row blocks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wrow0 = row0 + warp * 16;  // this warp's first row

  // Q tile: row r -> position (row0 + r) / g, head kvh*g + (row0 + r) % g
  {
    constexpr int kVec = Dh / 8;
    if constexpr (kThreads % kVec == 0) {
      // a fixed column of every (kThreads / kVec)-th row
      constexpr int kStep = kThreads / kVec;
      const int c = (threadIdx.x % kVec) * 8;
#pragma unroll
      for (int r = threadIdx.x / kVec; r < kRows; r += kStep) {
        const int R = row0 + r;
        const int t = R / g, h = kvh * g + R % g;
        const bool ok = t < T;
        cp_async16(sQ + r * kStride + c, ok ? q + ((long)t * H + h) * Dh + c : q, ok ? 16 : 0);
      }
    } else {
      // row-major 16-byte pieces, as in load_tile
      static_assert(kRows * kVec % kThreads == 0, "Q's pieces must fill whole passes");
#pragma unroll
      for (int i = 0; i < kRows * kVec / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / kVec, c = (idx % kVec) * 8;
        const int R = row0 + r;
        const int t = R / g, h = kvh * g + R % g;
        const bool ok = t < T;
        cp_async16(sQ + r * kStride + c, ok ? q + ((long)t * H + h) * Dh + c : q, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }

  // keys this CTA can see: [0, min(last query position + 1, seq_len))
  int t_last = (row0 + kRows - 1) / g;
  if (t_last > T - 1) t_last = T - 1;
  int n_keys = start_pos + t_last + 1;
  if (n_keys > seq_len) n_keys = seq_len;
  if (n_keys > S) n_keys = S;
  const int n_tiles = n_keys > 0 ? (n_keys + kKeys - 1) / kKeys : 0;
  // sliding window: the tiles entirely below the CTA's first row's floor
  // (the lowest of its rows) are dead for every row
  int first_tile = 0;
  if (window > 0) {
    const int lo = start_pos + row0 / g - window + 1;  // lowest key a row sees
    if (lo > 0) first_tile = lo / kKeys;
  }

  const long kv_stride = (long)KVH * Dh;
  const __nv_bfloat16* kbase = k + kvh * Dh;
  const __nv_bfloat16* vbase = v + kvh * Dh;
  // tile `tile`'s K or V into its buffer, a commit group each (empty past
  // the last tile, so the group count stays fixed)
  auto issue_k = [&](int tile) {
    if (tile < n_tiles)
      load_tile<Dh>(sK0 + (tile & 1) * Sm::kTile, kbase + tile * kKeys * kv_stride, kv_stride,
                    S - tile * kKeys);
    cp_async_commit();
  };
  auto issue_v = [&](int tile) {
    if (tile < n_tiles)
      load_tile<Dh>(sV, vbase + tile * kKeys * kv_stride, kv_stride, S - tile * kKeys);
    cp_async_commit();
  };
  issue_k(first_tile);

  // absolute query positions of this thread's two rows (gid and gid + 8),
  // and the warp's range
  const int qpos[2] = {start_pos + (wrow0 + gid) / g, start_pos + (wrow0 + gid + 8) / g};
  const int qmin = start_pos + wrow0 / g;
  const int qmax = start_pos + (wrow0 + 15) / g;

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // ldmatrix lane offsets: Q (A of QK^T), K (B of QK^T, keys x d) and V
  // (B of PV, trans)
  const int q_row = warp * 16 + (lane & 15), q_col = (lane >> 4) * 8;
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  for (int tile = first_tile; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    // this tile's K (and Q) have landed, for every thread, and the previous
    // tile is consumed; then this tile's V and the next tile's K start
    cp_async_wait<0>();
    __syncthreads();
    issue_v(tile);
    issue_k(tile + 1);
    const __nv_bfloat16* sK = sK0 + (tile & 1) * Sm::kTile;

    // a warp skips a tile whose keys all lie after its rows or, on a
    // sliding layer, all at or below every row's window floor (qpos -
    // window; the warp's first row has the lowest)
    const bool live = key0 <= qmax && (window == 0 || key0 + kKeys - 1 > qmin - window);
    const bool full = key0 + kKeys <= seq_len && key0 + kKeys - 1 <= qmin &&
                      (window == 0 || key0 > qmax - window);
    float s[kKTiles][4];
    if (live) {
      // S = Q K^T for this warp's 16 rows x 64 keys; Q's fragments come
      // from shared memory at each k-step
#pragma unroll
      for (int j = 0; j < kKTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        uint32_t qa[4];
        ldmatrix_x4(qa, sQ + q_row * kStride + ks * 16 + q_col);
#pragma unroll
        for (int j = 0; j < kKTiles; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, sK + (j * 8 + k_row) * kStride + ks * 16 + k_col);
          mma_bf16_16816(s[j], qa, b[0], b[1]);
          mma_bf16_16816(s[j + 1], qa, b[2], b[3]);
        }
      }

      // scale into the log2 domain and soft-cap, then mask (only a tile
      // on the diagonal, at seq_len or at a window floor), online softmax;
      // element e of s[j] is row h = e / 2 (gid or gid + 8), key j * 8 +
      // tig * 2 + e % 2
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (cap_log2 > 0.f) x = soft_cap(x, cap_log2);
          if (!full) {
            const int key = key0 + j * 8 + tig * 2 + (e & 1);
            const int qp = qpos[e >> 1];
            if (key >= seq_len || key > qp || (window > 0 && key <= qp - window)) x = -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], off));
        // a row with no visible key so far keeps m = -inf; its p and alpha
        // must come out 0, not NaN
        const float base = mx[h] == -INFINITY ? 0.f : mx[h];
        const float alpha = exp2f(m[h] - base);
        m[h] = mx[h];
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kKTiles; ++j) {
          s[j][2 * h] = exp2f(s[j][2 * h] - base);
          s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - base);
          rs += s[j][2 * h] + s[j][2 * h + 1];
        }
        l[h] = l[h] * alpha + rs;
#pragma unroll
        for (int j = 0; j < kDTiles; ++j) {
          o[j][2 * h] *= alpha;
          o[j][2 * h + 1] *= alpha;
        }
      }
    }

    cp_async_wait<1>();  // this tile's V has landed (the next K may not)
    __syncthreads();
    if (!live) continue;
    // O += P V: P's accumulator layout is the A-fragment layout of the next
    // product (two 8-key n-tiles make one 16-key k-step)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (kk * 16 + v_row) * kStride + j * 8 + v_col);
        mma_bf16_16816(o[j], a, b[0], b[1]);
        mma_bf16_16816(o[j + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the row sum is spread over the 4 threads of a quad
    float lsum = l[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) lsum += __shfl_xor_sync(0xffffffff, lsum, off);
    const int R = wrow0 + gid + 8 * h;
    const int t = R / g;
    if (t >= T) continue;  // pad rows are not written
    const long i = (long)t * H + kvh * g + R % g;  // (position, head) of the row
    if constexpr (Partial) {
      // unnormalized f32 accumulator, m in natural units
      float* acc = static_cast<float*>(out_raw) + i * Dh;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        *reinterpret_cast<float2*>(acc + j * 8 + tig * 2) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
      if (tig == 0) {  // m and l are the same in the 4 threads of a quad
        m_out[i] = m[h] == -INFINITY ? kNegInf : m[h] * kLn2;
        l_out[i] = lsum;
      }
    } else {
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(out_raw) + i * Dh;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8 + tig * 2) =
            pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
  }
}

// K1 and K2 under names of their own, so a profile tells them apart;
// three CTAs per SM (two at Dh 256)
template <int Dh>
__global__ void __launch_bounds__(kThreads, Tiling<Dh>::kMinBlocks)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, void* __restrict__ out, float* m_out,
                     float* l_out, int T, int H, int KVH, int S, int start_pos, int seq_len,
                     int window, float scale_log2, float cap_log2) {
  flash_prefill_body<Dh, false>(q, k, v, out, m_out, l_out, T, H, KVH, S, start_pos, seq_len,
                                window, scale_log2, cap_log2);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, Tiling<Dh>::kMinBlocks)
flash_prefill_partial_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, void* __restrict__ acc,
                             float* m_out, float* l_out, int T, int H, int KVH, int S,
                             int start_pos, int seq_len, int window, float scale_log2,
                             float cap_log2) {
  flash_prefill_body<Dh, true>(q, k, v, acc, m_out, l_out, T, H, KVH, S, start_pos, seq_len,
                               window, scale_log2, cap_log2);
}

template <int Dh, bool Partial>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* m_out,
                   float* l_out, int T, int H, int KVH, int S, int start_pos, int seq_len,
                   int window, float scale, float softcap, cudaStream_t stream) {
  constexpr int smem = Smem<Dh>::kBytes;
  auto kernel = Partial ? flash_prefill_partial_kernel<Dh> : flash_prefill_kernel<Dh>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int g = H / KVH;
  dim3 grid((T * g + kRows - 1) / kRows, KVH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, m_out, l_out, T, H, KVH, S, start_pos,
      seq_len, window, scale * kLog2e, softcap * kLog2e);
  return cudaGetLastError();
}

template <bool Partial>
int dispatch(const void* q, const void* k, const void* v, void* out, float* m_out, float* l_out,
             int T, int H, int KVH, int Dh, int S, int start_pos, int seq_len, int window,
             float scale, float softcap, void* stream) {
  if (T <= 0) return 0;
  if (H % KVH != 0 || window < 0 || softcap < 0.f) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return (int)launch<64, Partial>(q, k, v, out, m_out, l_out, T, H, KVH, S, start_pos,
                                      seq_len, window, scale, softcap, st);
    case 96:
      return (int)launch<96, Partial>(q, k, v, out, m_out, l_out, T, H, KVH, S, start_pos,
                                      seq_len, window, scale, softcap, st);
    case 128:
      return (int)launch<128, Partial>(q, k, v, out, m_out, l_out, T, H, KVH, S, start_pos,
                                       seq_len, window, scale, softcap, st);
    case 256:
      return (int)launch<256, Partial>(q, k, v, out, m_out, l_out, T, H, KVH, S, start_pos,
                                       seq_len, window, scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Head dims 64, 96, 128 and 256 are
// compiled. window: the sliding window of this layer, 0 = global; softcap:
// the attention logit soft-cap, 0 = off.
extern "C" int dtt_flash_prefill_bf16(const void* q, const void* k, const void* v, void* out,
                                      int T, int H, int KVH, int Dh, int S, int start_pos,
                                      int seq_len, int window, float scale, float softcap,
                                      void* stream) {
  return dispatch<false>(q, k, v, out, nullptr, nullptr, T, H, KVH, Dh, S, start_pos, seq_len,
                         window, scale, softcap, stream);
}

// K2: acc [T, H, Dh], m and l [T, H], all f32; start_pos may be negative.
// seq_len is clipped to [0, S]: keys past S are zero-filled, not masked.
extern "C" int dtt_flash_prefill_partial_bf16(const void* q, const void* k, const void* v,
                                              void* acc, void* m, void* l, int T, int H,
                                              int KVH, int Dh, int S, int start_pos,
                                              int seq_len, float scale, void* stream) {
  seq_len = seq_len < 0 ? 0 : (seq_len > S ? S : seq_len);
  return dispatch<true>(q, k, v, acc, static_cast<float*>(m), static_cast<float*>(l), T, H,
                        KVH, Dh, S, start_pos, seq_len, 0, scale, 0.f, stream);
}
