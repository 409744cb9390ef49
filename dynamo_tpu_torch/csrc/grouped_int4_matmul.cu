// Grouped-int4 matmul: out = x @ W for packed int4 weights with one f32
// scale per (128-row contraction group, output column); bf16 in and out,
// f32 accumulation.
//
// Replaces: the Pallas kernel `_kernel` under `grouped_int4_matmul`
// (dynamo_tpu/engine/quant_matmul.py), which every dense layer matmul of
// an int4-quantized llama calls: 7 launches per layer (wq, wk, wv, wo,
// gate, up, down).
//
// Contract: x [N, D] bf16; packed [D/2, F] int8, byte (d, f) holding
// weight rows 2d (low nibble) and 2d+1 (high nibble) of column f as signed
// 4-bit values; scale [D/128, F] f32 → out [N, F] bf16, where
// out[n, f] = sum_g (sum_{k in group g} x[n, k] * w[k, f]) * scale[g, f]:
// each group's partial product is formed in f32 and scaled before it joins
// the f32 sum, as the Pallas kernel does. Shapes: D % 256 == 0 (an even
// number of groups) and F % 128 == 0, the rule of `grouped_kernel_eligible`.
//
// Bound on an H100. At decode (N <= 8) the work is a weights read: 0.5 B
// per weight plus 4 B per group scale against 4N flop per weight, so the
// floor is the bytes (~116 MB per Llama-3-8B layer, ~35 us at 3.35 TB/s).
// At prefill (N = 128...2048) it is 4*N flop per packed byte, above the
// card's balance point from N of about 128 on, so long prefills are
// floored by tensor-core operations. This kernel is far from both floors
// (PERF.md, an H100 80GB HBM3 at 700 W): 7x (4096 -> 14336) to 80x
// (4096 -> 1024, 16 CTAs) the byte floor at N = 8, and 11-31x the
// operations floor at N = 512. A CTA has at most four groups of loads in
// flight and waits on them before its MMAs, narrow outputs leave most SMs
// idle, and every weight byte is unpacked from shared memory one at a
// time. Split-K over more CTAs, cp.async double buffering and wgmma are
// the next steps.
//
// Design: one CTA of 4 warps per (row tile, 64 output columns). Per group
// the CTA copies the group's 64 packed rows of its columns and the group's
// 128 columns of x into shared memory with 16-byte loads, then each warp
// splits nibbles with sign extension ((int8_t)(b << 4) >> 4 for row 2d,
// (int8_t)b >> 4 for row 2d+1) straight into the bf16 B fragments of
// mma.sync m16n8k16 (f32 accumulate), forms the group's partial over its 16
// rows x 64 columns, and adds partial * scale[g, col] to its accumulator.
// Two tilings, chosen from N: for N <= 16 (decode) the row tile is 16 rows
// padded with zeros and the 4 warps take every 4th group each, so 4 groups'
// bytes are loaded at once, and their sums meet in shared memory at the
// end, added in a fixed warp order (no atomics: a run gives the same bits
// every time, so a seeded sampled stream repeats); for larger N the row tile is 64 rows, one 16-row slice per warp,
// and the warps share each group's weight tile. Loads are plain and
// synchronous (no cp.async, TMA or wgmma yet), and the TPU kernel's even/odd
// split of x is not needed: nibbles are unpacked into natural row order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;           // contraction rows per scale group
constexpr int kPackedRows = kGroup / 2;
constexpr int kCols = 64;             // output columns per CTA
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWStride = kCols + 16;  // bytes per packed row in shared memory
constexpr int kXStride = kGroup + 8;  // bf16 per x row in shared memory

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One packed byte → bf16x2 (row 2d in the low half, row 2d+1 in the high).
__device__ __forceinline__ uint32_t unpack_pair(int8_t byte) {
  const int lo = static_cast<int8_t>(static_cast<uint8_t>(byte) << 4) >> 4;
  const int hi = byte >> 4;
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// WM warps along the rows (16 rows each), kWarps / WM warps along the groups.
template <int WM>
__global__ void __launch_bounds__(kThreads)
grouped_int4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int N,
                    int D, int F) {
  constexpr int WK = kWarps / WM;
  constexpr int kRows = 16 * WM;
  __shared__ __align__(16) int8_t sW[WK][kPackedRows * kWStride];
  __shared__ __align__(16) __nv_bfloat16 sX[WK][kRows * kXStride];
  static_assert(sizeof(float) * WK * 16 * kCols <= sizeof(sW),
                "the group slices' sums reuse the weight tiles' space");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % WM, wk = warp / WM;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  const int n_groups = D / kGroup;

  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int g0 = 0; g0 < n_groups; g0 += WK) {
    __syncthreads();  // the previous round's tiles are consumed
    // packed weights: WK groups x 64 rows x 4 vectors of 16 bytes
    for (int i = threadIdx.x; i < WK * kPackedRows * (kCols / 16); i += kThreads) {
      const int s = i / (kPackedRows * (kCols / 16));
      const int r = (i / (kCols / 16)) % kPackedRows;
      const int c = (i % (kCols / 16)) * 16;
      const int g = g0 + s;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (g < n_groups)
        v = *reinterpret_cast<const uint4*>(packed + (long)(g * kPackedRows + r) * F + col0 + c);
      *reinterpret_cast<uint4*>(&sW[s][r * kWStride + c]) = v;
    }
    // x: WK groups x kRows rows x 16 vectors of 8 bf16
    for (int i = threadIdx.x; i < WK * kRows * (kGroup / 8); i += kThreads) {
      const int s = i / (kRows * (kGroup / 8));
      const int r = (i / (kGroup / 8)) % kRows;
      const int c = (i % (kGroup / 8)) * 8;
      const int g = g0 + s;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (g < n_groups && row0 + r < N)
        v = *reinterpret_cast<const uint4*>(x + (long)(row0 + r) * D + g * kGroup + c);
      *reinterpret_cast<uint4*>(&sX[s][r * kXStride + c]) = v;
    }
    __syncthreads();

    const int g = g0 + wk;
    if (g >= n_groups) continue;
    const int8_t* w = sW[wk];
    const __nv_bfloat16* xs = sX[wk] + (wm * 16) * kXStride;
    float part[kCols / 8][4];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kGroup / 16; ++ks) {
      uint32_t a[4];
      const int c = ks * 16 + tig * 2;
      a[0] = *reinterpret_cast<const uint32_t*>(xs + gid * kXStride + c);
      a[1] = *reinterpret_cast<const uint32_t*>(xs + (gid + 8) * kXStride + c);
      a[2] = *reinterpret_cast<const uint32_t*>(xs + gid * kXStride + c + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(xs + (gid + 8) * kXStride + c + 8);
      // B[k][n] for k = ks*16 + tig*2 (+1) lives in packed row ks*8 + tig,
      // k + 8 in packed row ks*8 + tig + 4
      const int8_t* w0 = w + (ks * 8 + tig) * kWStride + gid;
      const int8_t* w1 = w0 + 4 * kWStride;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
        mma_bf16_16816(part[j], a, unpack_pair(w0[j * 8]), unpack_pair(w1[j * 8]));
    }
    const float* srow = scale + (long)g * F + col0 + tig * 2;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const float2 s = *reinterpret_cast<const float2*>(srow + j * 8);
      acc[j][0] += part[j][0] * s.x;
      acc[j][1] += part[j][1] * s.y;
      acc[j][2] += part[j][2] * s.x;
      acc[j][3] += part[j][3] * s.y;
    }
  }

  if (WK > 1) {
    // the group slices of the 16-row tile meet in shared memory (the
    // weight tiles' space, free now): each warp stores its slice, then the
    // slices are added in warp order
    __syncthreads();
    float* red = reinterpret_cast<float*>(&sW[0][0]);  // [WK][16][kCols]
    float* mine = red + wk * 16 * kCols;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int c = j * 8 + tig * 2;
      mine[gid * kCols + c] = acc[j][0];
      mine[gid * kCols + c + 1] = acc[j][1];
      mine[(gid + 8) * kCols + c] = acc[j][2];
      mine[(gid + 8) * kCols + c + 1] = acc[j][3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * (kCols / 2); i += kThreads) {
      const int r = i / (kCols / 2), c = (i % (kCols / 2)) * 2;
      if (row0 + r < N) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int sl = 0; sl < WK; ++sl) {
          a += red[(sl * 16 + r) * kCols + c];
          b += red[(sl * 16 + r) * kCols + c + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (long)(row0 + r) * F + col0 + c) =
            __floats2bfloat162_rn(a, b);
      }
    }
    return;
  }
  const int r0 = row0 + wm * 16 + gid, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int c = col0 + j * 8 + tig * 2;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (long)r0 * F + c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (long)r1 * F + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int WM>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int N,
                   int D, int F, cudaStream_t stream) {
  dim3 grid(F / kCols, (N + 16 * WM - 1) / (16 * WM));
  grouped_int4_kernel<WM><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), N, D, F);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int dtt_grouped_int4_matmul(const void* x, const void* packed, const void* scale,
                                       void* out, int N, int D, int F, void* stream) {
  if (N <= 0) return 0;
  if (D % (2 * kGroup) != 0 || F % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 16) return (int)launch<1>(x, packed, scale, out, N, D, F, st);
  return (int)launch<kWarps>(x, packed, scale, out, N, D, F, st);
}
