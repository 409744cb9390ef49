// The int8 LM head: logits = x @ q * scale, bf16 activations, int8 weights
// with one f32 scale per vocab column, f32 accumulation and f32 logits.
//
// Replaces: the Pallas kernel `_kernel` under `lm_head_int8`
// (dynamo_tpu/engine/lm_head.py), which the llama `_logits` calls once per
// prefill (one row) and once per decode step (B rows) whenever the head is
// int8, under every weight-quantization mode. Like it, this kernel takes
// bf16 x times bf16(w) (exact: an int8 value is a bf16 value) with an f32
// accumulator, then the column's scale.
//
// Contract: x [B, D] bf16, q [D, V] int8 (row-major: column v of row d at
// d*V + v), scale [V] f32 → out [B, V] f32, out[b, v] = (sum_d x[b, d] *
// q[d, v]) * scale[v]. Any B, D and V: B is taken 16 rows per pass over
// the weights.
//
// Bound on an H100. The head is a weights read: at the Llama-3-8B shape
// (D = 4096, V = 128256) the int8 payload is 525 MB against 2*B*D*V flop,
// 32 flop per weight byte at B = 16, far below the card's ~295 flop/byte
// balance point, so the floor is the bytes (~0.16 ms at 3.35 TB/s) for
// every B <= 16. The first design spent one int8-to-float conversion and B
// f32 FMAs per weight byte on the CUDA cores (4.2 G FMAs at B = 8, ~0.13
// ms of the card's f32 rate alone) and held 8 x 16 accumulators in 176
// registers, one CTA per SM: 0.70 ms at B = 8 (PERF.md). Here the product
// runs on the tensor cores and the weights stream asynchronously.
//
// Design:
// - mma.sync m16n8k16, bf16 in, f32 accumulate, with vocab columns as M, d
//   as K and the batch rows as N: one n-tile holds a decode batch of 8, two
//   hold 16, and one pass over the weights serves them all.
// - One CTA of 4 warps owns a strip of 128 vocab columns (1002 CTAs at the
//   8B head); each warp owns 32 of them across all of D, so no warp
//   reduces with another. The strip's [64 x 128] int8 tiles and x's [B x
//   64] bf16 slices stream through a 4-stage `cp.async` ring (46 KB of
//   shared memory, 4 CTAs per SM: ~120 KB of copies in flight per SM).
// - A fragment register holds two consecutive d of one vocab column, so the
//   tile is transposed as it is converted: a thread reads the same 4-column
//   word of rows d and d + 1 (32-bit shared loads, rows padded to 144 bytes
//   so a warp's loads hit 32 banks), pairs the bytes of each column with a
//   byte permute, and maps each int8 pair to bf16x2 with two masks and one
//   bf16x2 subtraction (exact, no I2F). The MMA's row order within a warp
//   follows those words (row gid <- column 4 gid, row gid + 8 <- 4 gid + 1,
//   and the second m-tile the next two), so each thread ends with 4
//   consecutive columns of 2 batch rows per n-tile: one 16-byte store each.
// - The column scale is applied in f32 on the way out. A V that is not a
//   multiple of 16 (or a D not a multiple of 8) takes plain loads into the
//   same ring, with the ragged edge masked; a V not a multiple of 4 takes
//   scalar stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStrip = kWarps * 32;      // vocab columns per CTA, 32 per warp
constexpr int kTileD = 64;               // d rows per stage
constexpr int kStages = 4;
constexpr int kWRow = kStrip + 16;       // bytes per weight row in shared memory
constexpr int kXRow = kTileD * 2 + 16;   // bytes per x row in shared memory
constexpr int kMaxRows = 16;             // batch rows per pass (two n-tiles)

template <int NT>
struct Stage {
  static constexpr int kW = kTileD * kWRow;
  static constexpr int kBytes = kW + 8 * NT * kXRow;
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Stage the weight tile [d0, d0 + kTileD) x [col0, col0 + kStrip) and x's
// rows [0, 8 NT) x [d0, d0 + kTileD); what lies past D, V or nb is zero.
template <int NT>
__device__ __forceinline__ void load_stage(uint8_t* st, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ q, int nb, int D, int V,
                                           long col0, int d0, bool vec_w, bool vec_x) {
  constexpr int kWPieces = kTileD * kStrip / 16;
  for (int i = threadIdx.x; i < kWPieces; i += kThreads) {
    const int r = i / (kStrip / 16), p = i % (kStrip / 16);
    const int d = d0 + r;
    const long col = col0 + p * 16;
    uint8_t* dst = st + r * kWRow + p * 16;
    if (vec_w) {
      const bool ok = d < D && col < V;
      cp_async16(dst, ok ? q + (long)d * V + col : q, ok ? 16 : 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (d < D) {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (col + b < V)
            w[b / 4] |= (uint32_t)(uint8_t)q[(long)d * V + col + b] << (8 * (b % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  uint8_t* sx = st + Stage<NT>::kW;
  constexpr int kXPieces = 8 * NT * (kTileD / 8);
  for (int i = threadIdx.x; i < kXPieces; i += kThreads) {
    const int b = i / (kTileD / 8), p = i % (kTileD / 8);
    const int d = d0 + p * 8;
    uint8_t* dst = sx + b * kXRow + p * 16;
    if (vec_x) {
      const bool ok = b < nb && d < D;
      cp_async16(dst, ok ? x + (long)b * D + d : x, ok ? 16 : 0);
    } else {
      __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (b < nb && d + e < D) ? x[(long)b * D + d + e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
lm_head_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out, int nb, int D,
                    int V) {
  __shared__ __align__(16) uint8_t smem[kStages * Stage<NT>::kBytes];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long col0 = (long)blockIdx.x * kStrip;
  const bool vec_w = V % 16 == 0, vec_x = D % 8 == 0;
  const int n_kt = (D + kTileD - 1) / kTileD;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt)
      load_stage<NT>(smem + st * Stage<NT>::kBytes, x, q, nb, D, V, col0, st * kTileD, vec_w,
                     vec_x);
    cp_async_commit();
  }

  // this thread's word of the warp's 32 columns, and its x lanes
  const int wcol = warp * 32 + 4 * gid;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();
    // refill the stage consumed in the previous iteration
    const int nk = kt + kStages - 1;
    if (nk < n_kt)
      load_stage<NT>(smem + (nk % kStages) * Stage<NT>::kBytes, x, q, nb, D, V, col0,
                     nk * kTileD, vec_w, vec_x);
    cp_async_commit();

    const uint8_t* sw = smem + (kt % kStages) * Stage<NT>::kBytes;
    const uint8_t* sx = sw + Stage<NT>::kW;
#pragma unroll
    for (int ks = 0; ks < kTileD / 16; ++ks) {
      const int d = ks * 16 + tig * 2;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(sw + d * kWRow + wcol);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(sw + (d + 1) * kWRow + wcol);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(sw + (d + 8) * kWRow + wcol);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(sw + (d + 9) * kWRow + wcol);
      // column j of the word: byte j of rows d and d + 1 (and d + 8, d + 9)
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        lo[j] = int8x2_to_bf16x2(__byte_perm(w0, w1, sel));
        hi[j] = int8x2_to_bf16x2(__byte_perm(w8, w9, sel));
      }
      uint32_t b0[NT], b1[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr = sx + (nt * 8 + gid) * kXRow + d * 2;
        b0[nt] = *reinterpret_cast<const uint32_t*>(xr);
        b1[nt] = *reinterpret_cast<const uint32_t*>(xr + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t a[4] = {lo[2 * mt], lo[2 * mt + 1], hi[2 * mt], hi[2 * mt + 1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a, b0[nt], b1[nt]);
      }
    }
  }

  // thread (gid, tig) holds columns wcol .. wcol + 3 of batch rows nt*8 +
  // tig*2 + {0, 1}
  const long col = col0 + wcol;
  if (col >= V) return;
  const bool vec_out = V % 4 == 0 && col + 4 <= V;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = col + j < V ? scale[col + j] : 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = nt * 8 + tig * 2 + e;
      if (b >= nb) continue;
      const float v[4] = {acc[0][nt][e] * sc[0], acc[0][nt][2 + e] * sc[1],
                          acc[1][nt][e] * sc[2], acc[1][nt][2 + e] * sc[3]};
      float* o = out + (long)b * V + col;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < V) o[j] = v[j];
      }
    }
  }
}

template <int NT>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* q, const float* scale, float* out,
                   int nb, int D, int V, cudaStream_t stream) {
  const int grid = (V + kStrip - 1) / kStrip;
  lm_head_int8_kernel<NT><<<grid, kThreads, 0, stream>>>(x, q, scale, out, nb, D, V);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int dtt_lm_head_int8(const void* x, const void* q, const void* scale, void* out,
                                int B, int D, int V, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sb = static_cast<const float*>(scale);
  float* ob = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < B; r0 += kMaxRows) {
    const int nb = B - r0 < kMaxRows ? B - r0 : kMaxRows;
    const __nv_bfloat16* xr = xb + (long)r0 * D;
    float* outr = ob + (long)r0 * V;
    const cudaError_t err = nb <= 8 ? launch<1>(xr, qb, sb, outr, nb, D, V, st)
                                    : launch<2>(xr, qb, sb, outr, nb, D, V, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
