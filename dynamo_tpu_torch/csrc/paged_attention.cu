// Paged decode attention: one query row per sequence against the KV its
// block table points to in the block-major pool, bf16 in/out, f32 math.
//
// Replaces: the Pallas kernel `_paged_attn_kernel` under
// `paged_attention_pallas` (dynamo_tpu/engine/attention.py), which the llama
// decode step calls once per layer.
//
// Contract (the bf16, global-window case of the Pallas kernel): q [B, H, Dh];
// one layer's pool k_cache/v_cache [NTOK, KVH*Dh] (token row = block id *
// block_size + offset); block_tables [B, M] int32; seq_lens [B] int32, the
// number of keys each sequence sees (the current token included). A
// sequence with seq_len 0 gets zeros; an inactive slot (position 0, zero
// table) reads the trash block's row 0 and stays finite. Returns [B, H, Dh].
//
// Bound on an H100. The work's floor is bytes: every key of every sequence
// is read once for K and once for V (sum_b seq_len_b * KVH*Dh * 2 B * 2)
// against ~4 flop per byte, far below the card's ~295 flop/byte balance
// point. This kernel is not near that floor: it is bound by load latency.
// Each thread has one dependent table-then-row load in flight per
// iteration (the block id must arrive before the row's address is known),
// a CTA has 8 tokens in flight, so a 2048-token slot takes 256 serial
// round trips to memory. At B = 8 with seq_lens up to 2048 it runs at
// ~1.5% of the byte floor (PERF.md). Not yet fixed: loading several tokens
// per thread before using them, and splitting long sequences across CTAs
// (split-K), are the next steps.
//
// Design: one CTA of 4 warps per (sequence, KV head); its g = H/KVH query
// heads share every K/V row the CTA reads, so the pool is streamed once per
// KV head, not once per query head. The CTA reads its own block table (no
// scalar prefetch or DMA waves as on the TPU). Dh/8 threads cover one
// token's row with one 16-byte load each; a warp walks 32/(Dh/8) tokens at
// a time and the 4 warps interleave over the sequence. Each such thread
// group keeps an f32 online softmax (m, l, acc) per query head in
// registers; the groups are merged through shared memory at the end. At
// B = 8 that is 64 CTAs, half the SMs: splitting a sequence across CTAs
// (flash-decoding) is left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int Dh, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_cache,
                       const __nv_bfloat16* __restrict__ v_cache,
                       const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                       __nv_bfloat16* __restrict__ out, int H, int KVH, int M, int block_size,
                       float scale_log2) {
  constexpr int kTpt = Dh / 8;            // threads per token row
  constexpr int kSubPerWarp = 32 / kTpt;  // tokens a warp reads at once
  constexpr int kSubs = kWarps * kSubPerWarp;
  __shared__ float sm_m[kSubs][G];
  __shared__ float sm_l[kSubs][G];
  __shared__ float sm_acc[kSubs][G][Dh];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = warp * kSubPerWarp + lane / kTpt;
  const int d0 = (lane % kTpt) * 8;
  const int L = seq_lens[b];
  const long C = (long)KVH * Dh;
  const int* table = block_tables + (long)b * M;

  float qv[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    uint4 raw = *reinterpret_cast<const uint4*>(q + ((long)b * H + kvh * G + h) * Dh + d0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[h][i] = __bfloat162float(e[i]);
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[h][i] = 0.f;
  }

  // warp-uniform trip count: every lane of a warp runs every iteration so
  // the shuffles below always see the full warp
  for (int base = warp * kSubPerWarp; base < L; base += kSubs) {
    const int t = base + lane / kTpt;
    const bool valid = t < L;
    float kf[8], vf[8];
    if (valid) {
      const long row = (long)table[t / block_size] * block_size + t % block_size;
      const long off = row * C + kvh * Dh + d0;
      uint4 kr = *reinterpret_cast<const uint4*>(k_cache + off);
      uint4 vr = *reinterpret_cast<const uint4*>(v_cache + off);
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kr);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        kf[i] = __bfloat162float(ke[i]);
        vf[i] = __bfloat162float(ve[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += qv[h][i] * kf[i];
#pragma unroll
      for (int off = kTpt / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffff, dot, off);
      if (valid) {
        const float s = dot * scale_log2;
        const float m_new = fmaxf(m[h], s);
        const float alpha = exp2f(m[h] - m_new);
        const float p = exp2f(s - m_new);
        l[h] = l[h] * alpha + p;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[h][i] = acc[h][i] * alpha + p * vf[i];
        m[h] = m_new;
      }
    }
  }

  // merge the kSubs partial softmaxes
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane % kTpt == 0) {
      sm_m[sub][h] = m[h];
      sm_l[sub][h] = l[h];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[sub][h][d0 + i] = acc[h][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dh; idx += kThreads) {
    const int h = idx / Dh, d = idx % Dh;
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kSubs; ++s) mx = fmaxf(mx, sm_m[s][h]);
    float res = 0.f;
    if (mx != -INFINITY) {
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        const float w = exp2f(sm_m[s][h] - mx);
        num += w * sm_acc[s][h][d];
        den += w * sm_l[s][h];
      }
      res = num / den;
    }
    out[((long)b * H + kvh * G + h) * Dh + d] = __float2bfloat16(res);
  }
}

template <int Dh, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* seq_lens, void* out, int B, int H, int KVH, int M,
                   int block_size, float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  paged_attention_kernel<Dh, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), tables, seq_lens,
      static_cast<__nv_bfloat16*>(out), H, KVH, M, block_size, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v, const int* tables,
                     const int* seq_lens, void* out, int B, int H, int KVH, int M,
                     int block_size, float scale, cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch<Dh, 1>(q, k, v, tables, seq_lens, out, B, H, KVH, M, block_size, scale, stream);
    case 2:
      return launch<Dh, 2>(q, k, v, tables, seq_lens, out, B, H, KVH, M, block_size, scale, stream);
    case 4:
      return launch<Dh, 4>(q, k, v, tables, seq_lens, out, B, H, KVH, M, block_size, scale, stream);
    case 8:
      return launch<Dh, 8>(q, k, v, tables, seq_lens, out, B, H, KVH, M, block_size, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Head dims 64/128 and GQA group sizes
// 1/2/4/8 are compiled.
extern "C" int dtt_paged_attention_bf16(const void* q, const void* k_cache, const void* v_cache,
                                        const void* block_tables, const void* seq_lens,
                                        void* out, int B, int H, int KVH, int Dh, int M,
                                        int block_size, float scale, void* stream) {
  if (B <= 0) return 0;
  if (H % KVH != 0) return (int)cudaErrorInvalidValue;
  const int g = H / KVH;
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return (int)launch_g<64>(g, q, k_cache, v_cache, tables, lens, out, B, H, KVH, M,
                               block_size, scale, st);
    case 128:
      return (int)launch_g<128>(g, q, k_cache, v_cache, tables, lens, out, B, H, KVH, M,
                                block_size, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
