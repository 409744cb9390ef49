// Paged decode attention: one query row per sequence against the KV its
// block table points to in the block-major pool, bf16 in/out, f32 math. Two
// entry points: a bf16 pool, and an int8 pool with in-row scales.
//
// Replaces: the Pallas kernel `_paged_attn_kernel` under
// `paged_attention_pallas` (dynamo_tpu/engine/attention.py), which the llama
// decode step calls once per layer.
//
// Contract (the Pallas kernel without its MLA modes, `v_lanes` and
// `quant_sections`): q [B, H, Dh] bf16, Dh 64, 96, 128 or 256, GQA group g =
// H / KVH of 1-8 at Dh 64 and 128, 1, 2, 4 or 8 at Dh 96 and 256 (a template
// argument: the score, softmax and P.V loops and the merge take any g; at
// Dh 128 in bf16 a CTA's shared memory is 72.7 KiB at g = 4, 75.8 at g = 7
// and 76.8 at g = 8, so three CTAs share an SM up to g = 6 and two at g = 7
// and 8, where 94 registers a thread at g = 8 allow two as well); one
// layer's pool
// k_cache/v_cache [NTOK, KVH*Dh] bf16 (token row = block id * block_size +
// offset); block_tables [B, M] int32; seq_lens [B] int32, the number of keys
// each sequence sees (the current token included; keys past M * block_size
// are not read); win_lo [B] int32 or null: on a sliding layer the keys at
// or below win_lo[b] are masked (null: a global layer). softcap > 0: each
// score s (after the scale) becomes softcap * tanh(s / softcap). A sequence
// that sees no key (seq_len 0, or its window above its last key) gets
// zeros; an inactive slot (position 0, zero table) reads the trash block's
// row 0 and stays finite. Returns [B, H, Dh]. `scratch` is f32 workspace
// the caller allocates when the plan below has more than one split
// (B*KVH*splits*G*(Dh + 2) floats, layout in `Scratch`), else null.
//
// int8 mode (the Pallas kernel's `quant_lanes` mode): pool rows are C + 128
// int8 lanes (C = KVH*Dh): the values, then the row's scale as an exponent
// byte at lane C and a mantissa byte at C+1 (read & 0xFF), scale = 2^e *
// (1 + m/256), then pad lanes that are never read. The scale is taken out
// of the dot: score = s_t * (q . k_t) and V's weight p_t * s_t. value *
// scale is exact in f32, so against the Pallas kernel's dequantize-first
// form only the order of the sums changes.
//
// Bound on an H100. The work's floor is bytes: every key of every sequence
// is read once for K and once for V (sum_b seq_len_b * KVH * row bytes *
// 2, row bytes Dh*2 in bf16 and Dh + 2 in int8) against ~4 flop per byte
// at g = 4, far below the card's ~295 flop/byte balance point; tensor
// cores would not shorten anything, so the dots are plain f32 FMAs. What
// keeps a decode kernel from that floor is latency: the block id must
// arrive before a row's address is known, and one CTA that walks a whole
// 2048-token context serially pays that round trip hundreds of times (the
// first design did, at 69x the floor on a mixed 8-slot batch; PERF.md).
//
// Design (flash-decoding):
// - Each sequence is cut into chunks of `chunk_tokens(block_size)` keys (128
//   rounded up to whole blocks; attention.decode_split_plan is the same
//   plan in Python; 64 and 256 measured slower). The grid is (KVH, B,
//   splits) with splits = ceil(M * block_size / chunk), sized on the host
//   from the table width, never from seq_lens (they live on the device). A
//   CTA whose chunk starts at or after seq_len exits at once; split 0 of a
//   zero-length sequence writes its zeros.
// - Sliding window: a CTA whose chunk lies entirely at or below win_lo[b]
//   exits at once too, as the Pallas kernel starts at its first in-window
//   chunk, and the chunk that straddles the floor loads and scores only its
//   keys above it, so no score is masked. The live splits of a sequence are
//   [(win_lo + 1) / chunk, ceil(seq_len / chunk)), computed in the kernel
//   from win_lo and seq_lens on the device (a CUDA graph replays the call
//   with new values); the merge reads only those.
// - Soft-cap in the log2 domain (softcap * log2(e) there), tanh from one
//   exp2 and one fast division, accurate to a few f32 ulps of the cap.
// - A CTA of 8 warps turns its chunk's table entries into one pool row per
//   token (shared memory) while it loads q, then issues every K row of the
//   chunk and then every V row as 16-byte `cp.async` copies (one KV head's
//   slice per token, plus the 16-byte scale chunk at lane C in int8), in
//   two commit groups. It waits on K alone, so V's copies stay in flight
//   while the scores and the chunk's softmax are computed: two memory round
//   trips per CTA in all, and the 16 chunks of a 2048-token slot run in
//   parallel. (One bulk TMA copy per row on an mbarrier measured slower.)
// - Scores: two threads per token, each over half of Dh, q broadcast from
//   shared memory; rows are stored with a 16-byte skew (scale chunk or pad)
//   so that neighbouring rows start in different banks. int8 values become
//   f32 by a byte permute and a subtraction (no I2F). P.V: Dh/8 threads per
//   row of 8 values each (at Dh 96 8 threads of 12 values, so that a row
//   group still divides a warp); the row groups of a warp meet by shuffles, the warps in shared
//   memory aliased on the K rows.
// - A (sequence, KV head) with one live split writes its output directly
//   and touches no scratch. Otherwise each split writes f32 (m, l,
//   acc[g][Dh]) to scratch and a second kernel of the same entry point,
//   one CTA per (KV head, sequence), merges the live splits in index order
//   (a split with m = -inf weighs 0, not NaN). Every sum runs in a fixed
//   order, no float atomics: two calls give the same bits. The merge is
//   launched from the same C call with programmatic dependent launch, so
//   its launch overlaps the split kernel's tail; it adds one device kernel
//   per call when splits > 1 and no Python.
// - Shared memory per CTA: 2 * chunk * (row bytes + 16) + f32 q and
//   probabilities, 74-78 KB at bf16 Dh 128 (dynamic, above 48 KB after
//   cudaFuncSetAttribute once per instantiation and device): 3 CTAs per
//   SM, each with a whole chunk's loads in flight; 137-148 KB at bf16 Dh
//   256 (one CTA per SM), 75-85 KB at int8 Dh 256. With the compute left
//   out the loads alone take ~90% of the full-batch time (PERF.md): the
//   remaining gap to the byte floor is in how the gathered 256-byte row
//   slices stream, not in the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_cap.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkTarget = 128;   // attention.DECODE_CHUNK_TOKENS
constexpr int kMaxDevices = 64;

// The live keys of sequence b: [lo, L), lo the first key above the window
// floor (0 on a global layer); lo == L when it sees none
struct Span {
  int lo, L;
  __device__ Span(const int* seq_lens, const int* win_lo, int b, int M, int block_size) {
    L = min(seq_lens[b], M * block_size);
    if (L < 0) L = 0;
    lo = win_lo == nullptr ? 0 : min(max(win_lo[b] + 1, 0), L);
  }
};

__host__ __device__ inline int chunk_tokens(int block_size) {
  return block_size * ((kChunkTarget + block_size - 1) / block_size);
}

// one token's slice of one KV head, in the pool and in shared memory
template <int Dh, bool kInt8>
struct Row {
  static constexpr int kValBytes = kInt8 ? Dh : Dh * 2;
  static constexpr int kPieces = kValBytes / 16 + (kInt8 ? 1 : 0);  // 16-byte copies
  static constexpr int kSmem = kValBytes + 16;                      // + scale chunk or pad
};

// The scratch of one call: acc [B, KVH, S, G, Dh], then m and l [B, KVH,
// S, G], all f32 (attention.split_scratch_views reads the same layout).
template <int Dh, int G>
struct Scratch {
  float* acc;
  float* m;
  float* l;
  __device__ Scratch(float* base, int B, int KVH, int S) {
    const long n = (long)B * KVH * S * G;
    acc = base;
    m = base + n * Dh;
    l = m + n;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 lanes of a word to f32, exactly: (b ^ 0x80) as the low byte
// of 2^23's mantissa, less 2^23 + 128 (a PRMT and an FADD, not an I2F).
__device__ __forceinline__ void int8x4_to_f32(unsigned w, float* f) {
  const unsigned x = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ float row_scale(const uint8_t* s) {
  return ldexpf(1.f + s[1] * (1.f / 256.f), static_cast<int8_t>(s[0]));
}

// Issue the copies of rows [0, n_tok) of the chunk, whose pool rows are
// `rows` (one KV head's slice, and the scale chunk in int8).
template <int Dh, bool kInt8>
__device__ __forceinline__ void issue_rows(uint8_t* dst, const void* cache, const int* rows,
                                           int n_tok, int C, int kvh) {
  using R = Row<Dh, kInt8>;
  const uint8_t* pool = static_cast<const uint8_t*>(cache);
  const long stride = kInt8 ? (long)C + 128 : (long)C * 2;  // bytes per pool row
  for (int i = threadIdx.x; i < n_tok * R::kPieces; i += kThreads) {
    const int t = i / R::kPieces, p = i % R::kPieces;
    const uint8_t* row = pool + rows[t] * stride;
    const uint8_t* src = (kInt8 && p == R::kPieces - 1) ? row + C
                                                         : row + (long)kvh * R::kValBytes + p * 16;
    cp_async16(dst + t * R::kSmem + p * 16, src);
  }
}

// Block-wide reduction of G values per thread, in a fixed order (the same
// bits every call); every thread gets the results.
template <int G, bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[G], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffff, v[h], off);
      v[h] = kMax ? fmaxf(v[h], o) : v[h] + o;
    }
    if (lane == 0) red[warp * G + h] = v[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float r = red[h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w * G + h]) : r + red[w * G + h];
    v[h] = r;
  }
  __syncthreads();
}

template <int Dh, int G, bool kInt8>
__host__ __device__ inline size_t kv_region_bytes(int chunk) {
  const size_t rows = (size_t)chunk * Row<Dh, kInt8>::kSmem;
  const size_t red = (size_t)kWarps * G * Dh * sizeof(float);  // P.V partials, aliased
  return rows > red ? rows : red;
}

template <int Dh, int G, bool kInt8>
inline size_t smem_bytes(int chunk, int block_size) {
  return kv_region_bytes<Dh, G, kInt8>(chunk) + (size_t)chunk * Row<Dh, kInt8>::kSmem +
         sizeof(float) * ((size_t)G * Dh + (size_t)G * chunk + kWarps * G + 2 * G) +
         sizeof(int) * (size_t)chunk;
}

template <int Dh, int G, bool kInt8>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_cache,
                             const void* __restrict__ v_cache,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ seq_lens,
                             const int* __restrict__ win_lo, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ scratch, int H, int KVH, int M, int block_size,
                             float scale_log2, float cap_log2) {
  using R = Row<Dh, kInt8>;
  // threads per row in P.V and values per thread: Dh / 8 threads of 8
  // values where that is a power of two (the rows of a warp then meet by
  // shuffles), else 8 threads of Dh / 8 values (Dh 96: 12)
  constexpr int kTpt = ((Dh / 8) & (Dh / 8 - 1)) == 0 ? Dh / 8 : 8;
  constexpr int kVpt = Dh / kTpt;
  constexpr int kSubs = kThreads / kTpt;
  static_assert(32 % kTpt == 0 && kVpt % 4 == 0, "P.V's row groups must tile a warp");
  // the merge kernel may be scheduled now: it waits for this grid itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunk = chunk_tokens(block_size);
  const Span sp(seq_lens, win_lo, b, M, block_size);
  const int t0 = split * chunk;
  __nv_bfloat16* o = out + ((long)b * H + kvh * G) * Dh;
  if (sp.lo >= sp.L) {  // no key to see: split 0 writes the zeros
    if (split == 0)
      for (int i = tid; i < G * Dh; i += kThreads) o[i] = __float2bfloat16(0.f);
    return;
  }
  // the live splits [lo / chunk, ceil(L / chunk)); a dead one exits
  if (t0 >= sp.L || t0 + chunk <= sp.lo) return;
  const int t_begin = max(t0, sp.lo);  // the chunk's first live key
  const int n_tok = min(t0 + chunk, sp.L) - t_begin;
  const int n_live = (sp.L + chunk - 1) / chunk - sp.lo / chunk;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sK = smem;
  uint8_t* sV = sK + kv_region_bytes<Dh, G, kInt8>(chunk);
  float* sQ = reinterpret_cast<float*>(sV + (size_t)chunk * R::kSmem);
  float* sP = sQ + G * Dh;      // [G][chunk]: scores, then probabilities
  float* sRed = sP + G * chunk;  // [kWarps][G]
  float* sML = sRed + kWarps * G;  // m[G], l[G]
  int* sRow = reinterpret_cast<int*>(sML + 2 * G);  // pool row of each token
  float* sAcc = reinterpret_cast<float*>(sK);  // [kWarps][G][Dh], after the scores

  const int* table = block_tables + (long)b * M;
  for (int t = tid; t < n_tok; t += kThreads) {
    const int key = t_begin + t;
    sRow[t] = table[key / block_size] * block_size + key % block_size;
  }
  const __nv_bfloat16* qb = q + ((long)b * H + kvh * G) * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) sQ[i] = __bfloat162float(qb[i]);
  __syncthreads();
  const int C = KVH * Dh;
  issue_rows<Dh, kInt8>(sK, k_cache, sRow, n_tok, C, kvh);
  cp_async_commit();
  issue_rows<Dh, kInt8>(sV, v_cache, sRow, n_tok, C, kvh);
  cp_async_commit();
  cp_async_wait<1>();  // K has landed, V is still in flight
  __syncthreads();

  // scores in the exp2 domain: two threads per token, each over half of
  // Dh, met by one shuffle; at Dh 128 bf16 the second half walks its
  // pieces rotated by a quarter row so that the halves of a row never
  // share a bank. At Dh 96 (rows of 13 16-byte units bf16, 7 int8) no
  // rotation keeps every step of a quarter-warp's 16-byte loads apart: the
  // rotations below leave 2 of 6 steps (bf16) and 1 of 3 (int8) with a
  // two-way conflict, where none leaves all 6 (3) of them
  constexpr int kVals = kInt8 ? 16 : 8;  // values per 16-byte piece
  constexpr int kHalf = Dh / kVals / 2;  // pieces per half row
  constexpr int kRot = kHalf % 8 == 0 ? kHalf / 2 : kHalf == 6 ? 4 : kHalf == 3 ? 1 : 0;
  const int half = tid & 1;
  for (int base = 0; base < n_tok; base += kThreads / 2) {  // warp-uniform trips
    const int t = base + tid / 2;
    const bool valid = t < n_tok;
    const uint8_t* kr = sK + t * R::kSmem;
    float dot[G];
#pragma unroll
    for (int h = 0; h < G; ++h) dot[h] = 0.f;
    if (valid) {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const int p = half * kHalf + (j + half * kRot) % kHalf;
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + p * 16);
        float kf[kVals];
        if constexpr (kInt8) {
          int8x4_to_f32(raw.x, kf);
          int8x4_to_f32(raw.y, kf + 4);
          int8x4_to_f32(raw.z, kf + 8);
          int8x4_to_f32(raw.w, kf + 12);
        } else {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int i = 0; i < kVals; ++i) kf[i] = __bfloat162float(e[i]);
        }
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float4* qh = reinterpret_cast<const float4*>(sQ + h * Dh + p * kVals);
#pragma unroll
          for (int i = 0; i < kVals / 4; ++i) {
            const float4 qq = qh[i];
            dot[h] += qq.x * kf[4 * i] + qq.y * kf[4 * i + 1] + qq.z * kf[4 * i + 2] +
                      qq.w * kf[4 * i + 3];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) dot[h] += __shfl_xor_sync(0xffffffff, dot[h], 1);
    if (valid && half == 0) {
      const float ks = kInt8 ? row_scale(kr + Dh) * scale_log2 : scale_log2;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float x = dot[h] * ks;
        sP[h * chunk + t] = cap_log2 > 0.f ? soft_cap(x, cap_log2) : x;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax: m, p = exp2(s - m), l
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    for (int t = tid; t < n_tok; t += kThreads) m[h] = fmaxf(m[h], sP[h * chunk + t]);
  }
  block_reduce<G, true>(m, sRed);
#pragma unroll
  for (int h = 0; h < G; ++h) {
    l[h] = 0.f;
    for (int t = tid; t < n_tok; t += kThreads) {
      const float p = exp2f(sP[h * chunk + t] - m[h]);
      sP[h * chunk + t] = p;
      l[h] += p;
    }
  }
  block_reduce<G, false>(l, sRed);
  if (tid < G) {
#pragma unroll
    for (int h = 0; h < G; ++h)
      if (tid == h) {
        sML[h] = m[h];
        sML[G + h] = l[h];
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (kInt8) {  // V's row scales into the probabilities (l has them unscaled)
    for (int t = tid; t < n_tok; t += kThreads) {
      const float vs = row_scale(sV + t * R::kSmem + Dh);
#pragma unroll
      for (int h = 0; h < G; ++h) sP[h * chunk + t] *= vs;
    }
    __syncthreads();
  }

  // P.V: kTpt threads per row, kVpt values each, kSubs rows at a time
  const int piece = tid % kTpt, sub = tid / kTpt;
  float acc[G][kVpt];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < kVpt; ++i) acc[h][i] = 0.f;
  for (int t = sub; t < n_tok; t += kSubs) {
    const uint8_t* vr = sV + t * R::kSmem;
    float vf[kVpt];
    if constexpr (kVpt == 8 && kInt8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(vr + piece * 8);
      int8x4_to_f32(raw.x, vf);
      int8x4_to_f32(raw.y, vf + 4);
    } else if constexpr (kVpt == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(vr + piece * 16);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) vf[i] = __bfloat162float(e[i]);
    } else if constexpr (kInt8) {  // kVpt int8 values as 4-byte words
#pragma unroll
      for (int w = 0; w < kVpt / 4; ++w)
        int8x4_to_f32(*reinterpret_cast<const unsigned*>(vr + piece * kVpt + 4 * w), vf + 4 * w);
    } else {  // kVpt bf16 values as 8-byte words
#pragma unroll
      for (int w = 0; w < kVpt / 4; ++w) {
        const uint2 raw = *reinterpret_cast<const uint2*>(vr + piece * kVpt * 2 + 8 * w);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) vf[4 * w + i] = __bfloat162float(e[i]);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float w = sP[h * chunk + t];
#pragma unroll
      for (int i = 0; i < kVpt; ++i) acc[h][i] += w * vf[i];
    }
  }
  // the row groups of a warp, then the warps, in a fixed order
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int i = 0; i < kVpt; ++i)
#pragma unroll
      for (int off = kTpt; off < 32; off <<= 1)
        acc[h][i] += __shfl_xor_sync(0xffffffff, acc[h][i], off);
  if (lane < kTpt) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < kVpt; ++i)
        sAcc[(warp * G + h) * Dh + piece * kVpt + i] = acc[h][i];
  }
  __syncthreads();

  if (n_live == 1) {
    for (int i = tid; i < G * Dh; i += kThreads) {
      float a = sAcc[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += sAcc[w * G * Dh + i];
      o[i] = __float2bfloat16(a / sML[G + i / Dh]);
    }
    return;
  }
  Scratch<Dh, G> sc(scratch, gridDim.y, KVH, gridDim.z);
  const long slot = (((long)b * KVH + kvh) * gridDim.z + split) * G;
  for (int i = tid; i < G * Dh; i += kThreads) {
    float a = sAcc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += sAcc[w * G * Dh + i];
    sc.acc[slot * Dh + i] = a;
  }
  if (tid < G) {
    sc.m[slot + tid] = sML[tid];
    sc.l[slot + tid] = sML[G + tid];
  }
}

// One CTA per (KV head, sequence): the live splits' partials merged in
// index order; sequences with one live split were written by their split,
// and a sliding layer's splits below the window wrote nothing.
// Every split's (m, l) comes into shared memory in one parallel load, the
// weights exp2(m_s - max m) and 1 / sum(w l) are formed once per head, and
// each thread then sums 4 lanes of acc over the splits with independent
// 16-byte loads.
template <int Dh, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ scratch, const int* __restrict__ seq_lens,
                             const int* __restrict__ win_lo, __nv_bfloat16* __restrict__ out,
                             int H, int KVH, int M, int block_size, int S) {
  extern __shared__ float sW[];  // [S][G] m, then weights; [S][G] l; [G] 1/den
  float* sL = sW + S * G;
  float* sInv = sL + S * G;
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int chunk = chunk_tokens(block_size);
  const Span sp(seq_lens, win_lo, b, M, block_size);
  const int s0 = sp.lo / chunk;  // the first live split
  const int n = sp.lo >= sp.L ? 0 : (sp.L + chunk - 1) / chunk - s0;
  // launched early (programmatic dependent launch): every CTA waits here
  // for the split kernel's grid to finish and its writes to land, so that
  // what follows in the stream is ordered after both kernels
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (n <= 1) return;
  Scratch<Dh, G> sc(const_cast<float*>(scratch), gridDim.y, KVH, S);
  // the live splits' partials, from split s0 on
  const long slot0 = (((long)b * KVH + kvh) * S + s0) * G;
  for (int i = tid; i < n * G; i += kThreads) {
    sW[i] = sc.m[slot0 + i];
    sL[i] = sc.l[slot0 + i];
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int s = 0; s < n; ++s) mx = fmaxf(mx, sW[s * G + tid]);
    float den = 0.f;
    for (int s = 0; s < n; ++s) {
      const float ms = sW[s * G + tid];
      const float w = ms == -INFINITY ? 0.f : exp2f(ms - mx);
      sW[s * G + tid] = w;
      den += w * sL[s * G + tid];
    }
    sInv[tid] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  constexpr int kQuads = Dh / 4;
  const float4* acc = reinterpret_cast<const float4*>(sc.acc + slot0 * Dh);
  __nv_bfloat16* o = out + ((long)b * H + kvh * G) * Dh;
  for (int i = tid; i < G * kQuads; i += kThreads) {
    const int h = i / kQuads;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float4 a = acc[(long)s * G * kQuads + i];
      const float w = sW[s * G + h];
      r.x += w * a.x;
      r.y += w * a.y;
      r.z += w * a.z;
      r.w += w * a.w;
    }
    const float inv = sInv[h];
    o[4 * i] = __float2bfloat16(r.x * inv);
    o[4 * i + 1] = __float2bfloat16(r.y * inv);
    o[4 * i + 2] = __float2bfloat16(r.z * inv);
    o[4 * i + 3] = __float2bfloat16(r.w * inv);
  }
}

// Raise the instantiation's dynamic shared-memory limit on the current
// device once (to the largest size asked for so far).
template <int Dh, int G, bool kInt8>
cudaError_t ensure_smem(size_t bytes) {
  static size_t granted[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_attention_split_kernel<Dh, G, kInt8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

template <int Dh, int G, bool kInt8>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* seq_lens, const int* win_lo, void* out, void* scratch, int B, int H,
                   int KVH, int M, int block_size, float scale, float softcap,
                   cudaStream_t stream) {
  const int chunk = chunk_tokens(block_size);
  const int splits = (M * block_size + chunk - 1) / chunk;
  const size_t merge_smem = sizeof(float) * (2 * (size_t)splits * G + G);
  if (splits > 1 && (scratch == nullptr || merge_smem > 48 * 1024)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<Dh, G, kInt8>(chunk, block_size);
  cudaError_t err = ensure_smem<Dh, G, kInt8>(smem);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* sc = static_cast<float*>(scratch);
  paged_attention_split_kernel<Dh, G, kInt8><<<dim3(KVH, B, splits), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, tables, seq_lens, win_lo, o, sc, H, KVH, M,
      block_size, scale * kLog2e, softcap * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  // programmatic dependent launch: the merge's launch overlaps the split
  // kernel's tail instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KVH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_attention_merge_kernel<Dh, G>,
                           static_cast<const float*>(sc), seq_lens, win_lo, o, H, KVH, M,
                           block_size, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define DTT_PAGED_ARGS                                                                     \
  q, k, v, tables, seq_lens, win_lo, out, scratch, B, H, KVH, M, block_size, scale, softcap, \
      stream

template <int Dh, bool kInt8>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v, const int* tables,
                     const int* seq_lens, const int* win_lo, void* out, void* scratch, int B,
                     int H, int KVH, int M, int block_size, float scale, float softcap,
                     cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch<Dh, 1, kInt8>(DTT_PAGED_ARGS);
    case 2:
      return launch<Dh, 2, kInt8>(DTT_PAGED_ARGS);
    case 4:
      return launch<Dh, 4, kInt8>(DTT_PAGED_ARGS);
    case 8:
      return launch<Dh, 8, kInt8>(DTT_PAGED_ARGS);
    default:
      break;
  }
  // the other groups of 1-8 at head dims 64 and 128 only (qwen2, Qwen2.5,
  // Llama-3.2-3B): no model on the queue needs them at 96 or 256
  if constexpr (Dh == 64 || Dh == 128) {
    switch (g) {
      case 3:
        return launch<Dh, 3, kInt8>(DTT_PAGED_ARGS);
      case 5:
        return launch<Dh, 5, kInt8>(DTT_PAGED_ARGS);
      case 6:
        return launch<Dh, 6, kInt8>(DTT_PAGED_ARGS);
      case 7:
        return launch<Dh, 7, kInt8>(DTT_PAGED_ARGS);
      default:
        break;
    }
  }
  return cudaErrorInvalidValue;
}

template <bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* block_tables,
             const void* lens, const void* win, void* out, void* scratch, int B, int H, int KVH,
             int Dh, int M, int block_size, float scale, float softcap, void* stream_ptr) {
  if (B <= 0) return 0;
  if (H % KVH != 0 || M <= 0 || block_size <= 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  const int g = H / KVH;
  const int* tables = static_cast<const int*>(block_tables);
  const int* seq_lens = static_cast<const int*>(lens);
  const int* win_lo = static_cast<const int*>(win);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (Dh) {
    case 64:
      return (int)launch_g<64, kInt8>(g, DTT_PAGED_ARGS);
    case 96:
      return (int)launch_g<96, kInt8>(g, DTT_PAGED_ARGS);
    case 128:
      return (int)launch_g<128, kInt8>(g, DTT_PAGED_ARGS);
    case 256:
      return (int)launch_g<256, kInt8>(g, DTT_PAGED_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef DTT_PAGED_ARGS

}  // namespace

// Both return a cudaError_t (0 = launched). Head dims 64/96/128/256 are
// compiled; GQA group sizes 1-8 at Dh 64 and 128, 1/2/4/8 at Dh 96 and 256
// (kernels.GROUPS). The int8 entry takes pools of KVH*Dh +
// 128 int8 lanes per row. `win_lo`: [B] int32 or null (a global layer);
// `softcap`: 0 = off. `scratch`: see the contract above.
extern "C" int dtt_paged_attention_bf16(const void* q, const void* k_cache, const void* v_cache,
                                        const void* block_tables, const void* seq_lens,
                                        const void* win_lo, void* out, void* scratch, int B,
                                        int H, int KVH, int Dh, int M, int block_size,
                                        float scale, float softcap, void* stream) {
  return dispatch<false>(q, k_cache, v_cache, block_tables, seq_lens, win_lo, out, scratch, B,
                         H, KVH, Dh, M, block_size, scale, softcap, stream);
}

extern "C" int dtt_paged_attention_int8(const void* q, const void* k_cache, const void* v_cache,
                                        const void* block_tables, const void* seq_lens,
                                        const void* win_lo, void* out, void* scratch, int B,
                                        int H, int KVH, int Dh, int M, int block_size,
                                        float scale, float softcap, void* stream) {
  return dispatch<true>(q, k_cache, v_cache, block_tables, seq_lens, win_lo, out, scratch, B, H,
                        KVH, Dh, M, block_size, scale, softcap, stream);
}
