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
// Bound on an H100. At decode (N <= 16) the work is a weights read: 0.5 B
// per weight plus 4 B per group scale against 4N flop per weight, so the
// floor is the bytes (~116 MB per Llama-3-8B layer, ~35 us at 3.35 TB/s);
// what it takes is enough weight bytes in flight on every SM. At prefill
// (N = 128...2048) it is 4N flop per packed byte, above the card's balance
// point from N of about 128 on, so long prefills are floored by
// tensor-core operations. The first design (PERF.md: 3-5x slower than
// `torch._weight_int4pack_mm` at decode) launched one CTA per 64 columns
// with no split of the contraction (16-64 CTAs on 132 SMs for three of the
// four 8B shapes), kept at most four groups of plain synchronous loads in
// flight, and unpacked every byte with two int-to-float conversions.
//
// Design, two tilings chosen from N:
// - Nibbles to bf16 without I2F: a 32-bit word of 4 packed bytes (4
//   columns of one packed row) is XORed with 0x88 per byte, then each byte
//   is spread by one byte permute to bits 0-7 and 16-23 of its own
//   register, masked to its two nibbles and ORed with 0x4300 per half:
//   bf16 (0x4300 | (u ^ 8)) = 128 + n + 8 exactly for the signed nibble n,
//   so one bf16x2 subtraction of 136 gives the pair (w[2d], w[2d+1]) of
//   one column, which is one MMA register (k 2d, 2d+1) as it stands.
// - Decode (N <= 16), split-K. The host's plan (`int4_split_plan` in
//   engine/quant_matmul.py, passed in as `splits`) cuts the D/128 groups
//   into `splits` equal ranges of ceil(groups / splits) (the last may be
//   shorter, none empty) so that the grid of (F/128 column strips) x
//   splits reaches about 2 x 132 CTAs at every 8B shape (twice that
//   measured no faster). A CTA of 4 warps streams its strip's packed rows
//   through a 4-stage cp.async ring, one group (64 packed rows x 128
//   columns, x's 128 columns of the batch rows and the group's 128 scales)
//   per stage. mma.sync m16n8k16 takes the
//   output columns as M and the batch rows as N, so N <= 8 fills one n8
//   tile and N <= 16 two. Each warp owns 32 columns over two m-tiles in
//   K5's order (row gid <- column 4 gid, gid + 8 <- 4 gid + 1, the second
//   m-tile the next two): one 32-bit shared load of a packed row feeds
//   four MMA rows, and each thread ends with 4 consecutive columns of its
//   batch rows. Each group's partial is scaled into the f32 accumulator.
//   With one split the CTA writes bf16; with more, each CTA writes its f32
//   partial to scratch [splits, N, F], takes an atomic ticket for its
//   strip (the zeroed buffer the wrapper keeps per device and stream), and
//   the last of the strip's CTAs sums the splits in index order, writes
//   bf16 and resets the ticket. The ticket picks who sums, never the
//   order, so two calls give the same bits; no floating-point atomics.
// - Prefill (N > 16): a CTA of 8 warps per (128 rows, 128 columns), a
//   4-stage cp.async ring of one group per stage (x [128 x 128] bf16,
//   packed [64 x 128], the scales). Warps are 2 x 4 over rows x columns,
//   64 x 32 each; x fragments come through ldmatrix, the weights are the
//   B operand (one packed byte is one B register) with the same 32-bit
//   word per four n-tiles, and the per-group f32 partial is scaled into
//   the accumulator at each group's end; each thread stores 8 consecutive
//   columns of a row in one 16-byte store. Where its (row tile, strip)
//   CTAs would fill fewer than half the SMs, the plan splits the
//   contraction to about two CTAs per SM, reduced as in the decode tiling
//   with one ticket per (row tile, strip).
// The TPU kernel's even/odd split of x is not needed: nibbles are unpacked
// into natural row order. wgmma with the unpacked weights as the register
// A operand is the next step for the prefill tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;            // contraction rows per scale group
constexpr int kPackedRows = kGroup / 2;
constexpr int kStrip = 128;            // output columns per CTA
constexpr int kWRow = kStrip + 32;     // bytes per packed row in shared memory: rows tig
                                       // .. tig + 3 of one 32-bit column word hit 32 banks
constexpr int kXRow = kGroup * 2 + 16; // bytes per x row in shared memory
constexpr int kDecodeRows = 16;        // the decode tiling's largest N
constexpr int kStages = 4;

constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kPreWarps = 8;
constexpr int kPreThreads = kPreWarps * 32;
constexpr int kPreRows = 128;          // x rows per prefill CTA

// One ring stage: a group's packed rows of the strip, `rows` x rows, scales.
template <int Rows>
struct Stage {
  static constexpr int kW = kPackedRows * kWRow;
  static constexpr int kX = Rows * kXRow;
  static constexpr int kS = kStrip * 4;
  static constexpr int kBytes = kW + kX + kS;
};

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

// The 4 packed bytes of `w` (4 columns of one packed row) as 4 bf16x2
// registers, register j holding (w[2d], w[2d+1]) of column j, exactly.
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t x = w ^ 0x88888888u;  // each nibble u -> u ^ 8 = n + 8
  const uint32_t y = x >> 4;           // byte j's high nibble in its low bits
  const uint32_t bias = 0x43084308u;   // bf16x2 (136, 136)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of x to byte 0, byte j of y to byte 2
    const uint32_t p = __byte_perm(x, y, j | ((4 + j) << 8));
    const uint32_t v = (p & 0x000F000Fu) | 0x43004300u;
    __nv_bfloat162 b = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               *reinterpret_cast<const __nv_bfloat162*>(&bias));
    r[j] = *reinterpret_cast<uint32_t*>(&b);
  }
}

// Stage group g: its 64 packed rows of columns [col0, col0 + 128), x's
// rows [row0, row0 + Rows) of its 128 columns (rows past N zero) and its
// 128 scales, by Threads threads.
template <int Rows, int Threads>
__device__ __forceinline__ void load_stage(uint8_t* st, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ packed,
                                           const float* __restrict__ scale, int N, int D, int F,
                                           long col0, int row0, int g) {
  constexpr int kWPieces = kPackedRows * (kStrip / 16);
  for (int i = threadIdx.x; i < kWPieces; i += Threads) {
    const int r = i / (kStrip / 16), p = i % (kStrip / 16);
    cp_async16(st + r * kWRow + p * 16, packed + (long)(g * kPackedRows + r) * F + col0 + p * 16,
               16);
  }
  uint8_t* sx = st + Stage<Rows>::kW;
  constexpr int kXPieces = Rows * (kGroup / 8);
  for (int i = threadIdx.x; i < kXPieces; i += Threads) {
    const int r = i / (kGroup / 8), p = i % (kGroup / 8);
    const bool ok = row0 + r < N;
    cp_async16(sx + r * kXRow + p * 16,
               ok ? x + (long)(row0 + r) * D + g * kGroup + p * 8 : x, ok ? 16 : 0);
  }
  uint8_t* ss = sx + Stage<Rows>::kX;
  for (int i = threadIdx.x; i < kStrip / 4; i += Threads)
    cp_async16(ss + i * 16, scale + (long)g * F + col0 + i * 4, 16);
}

// After the CTA wrote its split's partial: its item's ticket (one thread,
// after a fence cumulative over what the barrier ordered before it).
// True in every thread of the item's last CTA, which resets the ticket.
__device__ __forceinline__ bool last_split(int* ticket, int splits) {
  __shared__ bool sLast;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(ticket, 1) == splits - 1;
    if (last) {
      *ticket = 0;  // every split of the item has counted
      __threadfence();
    }
    sLast = last;
  }
  __syncthreads();
  return sLast;
}

// The item's last CTA: rows [row0, row1) x columns [col0, col0 + 128) of
// the splits' f32 partials [splits, N, F] summed in index order, eight
// loads from L2 in flight per thread, written as bf16.
template <int Threads>
__device__ __forceinline__ void sum_splits(const float* __restrict__ partials,
                                           __nv_bfloat16* __restrict__ out, int N, int F,
                                           long col0, int row0, int row1, int splits) {
  const long plane = (long)N * F;
  for (int item = threadIdx.x; item < (row1 - row0) * (kStrip / 4); item += Threads) {
    const long off = (long)(row0 + item / (kStrip / 4)) * F + col0 + (item % (kStrip / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = s0 + k < splits
                   ? __ldcg(reinterpret_cast<const float4*>(partials + (s0 + k) * plane + off))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (s0 + k >= splits) break;
        sum.x += v[k].x;
        sum.y += v[k].y;
        sum.z += v[k].z;
        sum.w += v[k].w;
      }
    }
    __nv_bfloat162 v0 = __floats2bfloat162_rn(sum.x, sum.y);
    __nv_bfloat162 v1 = __floats2bfloat162_rn(sum.z, sum.w);
    *reinterpret_cast<uint2*>(out + off) =
        make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
  }
}

// Decode: one CTA per (column strip, split); NT batch n-tiles of 8 rows.
template <int NT>
__global__ void __launch_bounds__(kDecThreads)
int4_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ partials, int* __restrict__ tickets, int N, int D, int F,
                   int gps) {
  using St = Stage<8 * NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long col0 = (long)blockIdx.x * kStrip;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_groups = D / kGroup;
  const int g0 = split * gps;
  const int n_g = min(gps, n_groups - g0);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_g)
      load_stage<8 * NT, kDecThreads>(smem + s * St::kBytes, x, packed, scale, N, D, F, col0, 0,
                                      g0 + s);
    cp_async_commit();
  }

  const int wcol = warp * 32 + 4 * gid;  // this thread's column word in the strip
  for (int i = 0; i < n_g; ++i) {
    cp_async_wait<kStages - 2>();  // group i has landed
    __syncthreads();               // ... for every thread, and stage i - 1 is consumed
    const int ni = i + kStages - 1;
    if (ni < n_g)
      load_stage<8 * NT, kDecThreads>(smem + (ni % kStages) * St::kBytes, x, packed, scale, N,
                                      D, F, col0, 0, g0 + ni);
    cp_async_commit();

    const uint8_t* sw = smem + (i % kStages) * St::kBytes;
    const uint8_t* sx = sw + St::kW;
    float part[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kGroup / 16; ++ks) {
      // k pair tig of this k-step is packed row 8 ks + tig, pair tig + 4 row 8 ks + tig + 4
      uint32_t lo[4], hi[4];
      unpack4(*reinterpret_cast<const uint32_t*>(sw + (ks * 8 + tig) * kWRow + wcol), lo);
      unpack4(*reinterpret_cast<const uint32_t*>(sw + (ks * 8 + tig + 4) * kWRow + wcol), hi);
      uint32_t b0[NT], b1[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr = sx + (nt * 8 + gid) * kXRow + (ks * 16 + tig * 2) * 2;
        b0[nt] = *reinterpret_cast<const uint32_t*>(xr);
        b1[nt] = *reinterpret_cast<const uint32_t*>(xr + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t a[4] = {lo[2 * mt], lo[2 * mt + 1], hi[2 * mt], hi[2 * mt + 1]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(part[mt][nt], a, b0[nt], b1[nt]);
      }
    }
    // the group's scales of this thread's 4 columns
    const float4 sc = *reinterpret_cast<const float4*>(sx + St::kX + wcol * 4);
    const float s[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] += part[mt][nt][0] * s[2 * mt];
        acc[mt][nt][1] += part[mt][nt][1] * s[2 * mt];
        acc[mt][nt][2] += part[mt][nt][2] * s[2 * mt + 1];
        acc[mt][nt][3] += part[mt][nt][3] * s[2 * mt + 1];
      }
  }

  // thread (gid, tig) holds columns wcol .. wcol + 3 of batch rows
  // nt * 8 + tig * 2 + {0, 1}
  const long col = col0 + wcol;
  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = nt * 8 + tig * 2 + e;
        if (b >= N) continue;
        __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[0][nt][e], acc[0][nt][2 + e]);
        __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[1][nt][e], acc[1][nt][2 + e]);
        *reinterpret_cast<uint2*>(out + (long)b * F + col) =
            make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
      }
    return;
  }

  // several splits: this split's f32 partial, then the strip's ticket
  float* mine = partials + (long)split * N * F;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = nt * 8 + tig * 2 + e;
      if (b < N)
        *reinterpret_cast<float4*>(mine + (long)b * F + col) =
            make_float4(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e], acc[1][nt][2 + e]);
    }
  if (last_split(tickets + blockIdx.x, splits))
    sum_splits<kDecThreads>(partials, out, N, F, col0, 0, N, splits);
}

// Prefill: one CTA per (128 columns, 128 rows, split); warps 2 (rows) x 4
// (columns).
__global__ void __launch_bounds__(kPreThreads)
int4_prefill_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ partials, int* __restrict__ tickets, int N, int D, int F,
                    int gps) {
  using St = Stage<kPreRows>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const long col0 = (long)blockIdx.x * kStrip;
  const int row0 = blockIdx.y * kPreRows;
  const int split = blockIdx.z, splits = gridDim.z;
  const int g0 = split * gps;
  const int n_g = min(gps, D / kGroup - g0);

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_g)
      load_stage<kPreRows, kPreThreads>(smem + s * St::kBytes, x, packed, scale, N, D, F, col0,
                                        row0, g0 + s);
    cp_async_commit();
  }

  const int wcol = wn * 32 + 4 * gid;  // this thread's column word of the warp's 32 columns
  // ldmatrix row addresses: lane -> row (lane % 16) of an m-tile, k half lane / 16
  const int a_row = wm * 64 + (lane & 15), a_k = (lane >> 4) * 8;
  for (int i = 0; i < n_g; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ni = i + kStages - 1;
    if (ni < n_g)
      load_stage<kPreRows, kPreThreads>(smem + (ni % kStages) * St::kBytes, x, packed, scale, N,
                                        D, F, col0, row0, g0 + ni);
    cp_async_commit();

    const uint8_t* sw = smem + (i % kStages) * St::kBytes;
    const uint8_t* sx = sw + St::kW;
    float part[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kGroup / 16; ++ks) {
      // B of n-tile j, column gid = column word gid's byte j
      uint32_t lo[4], hi[4];
      unpack4(*reinterpret_cast<const uint32_t*>(sw + (ks * 8 + tig) * kWRow + wcol), lo);
      unpack4(*reinterpret_cast<const uint32_t*>(sw + (ks * 8 + tig + 4) * kWRow + wcol), hi);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, sx + (a_row + mt * 16) * kXRow + (ks * 16 + a_k) * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(part[mt][j], a, lo[j], hi[j]);
      }
    }
    // C (mt, j): columns 8 tig + j (c0, c2) and 8 tig + 4 + j (c1, c3)
    const float* ss = reinterpret_cast<const float*>(sx + St::kX) + wn * 32 + 8 * tig;
    const float4 s0 = *reinterpret_cast<const float4*>(ss);
    const float4 s1 = *reinterpret_cast<const float4*>(ss + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[mt][j][0] += part[mt][j][0] * s[j];
        acc[mt][j][1] += part[mt][j][1] * s[4 + j];
        acc[mt][j][2] += part[mt][j][2] * s[j];
        acc[mt][j][3] += part[mt][j][3] * s[4 + j];
      }
  }

  // each thread: rows (gid, gid + 8) of each m-tile, columns 8 tig .. 8 tig + 7
  const long col = col0 + wn * 32 + 8 * tig;
  float* mine = partials + (long)split * N * F;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * 64 + mt * 16 + gid + 8 * h;
      if (r >= N) continue;
      if (splits > 1) {
        float4* p = reinterpret_cast<float4*>(mine + (long)r * F + col);
        p[0] = make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                           acc[mt][3][2 * h]);
        p[1] = make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1],
                           acc[mt][3][2 * h + 1]);
        continue;
      }
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[mt][j][2 * h], acc[mt][j + 1][2 * h]);
        __nv_bfloat162 u =
            __floats2bfloat162_rn(acc[mt][j][2 * h + 1], acc[mt][j + 1][2 * h + 1]);
        w[j / 2] = *reinterpret_cast<uint32_t*>(&v);
        w[2 + j / 2] = *reinterpret_cast<uint32_t*>(&u);
      }
      *reinterpret_cast<uint4*>(out + (long)r * F + col) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  if (splits > 1 && last_split(tickets + blockIdx.y * gridDim.x + blockIdx.x, splits))
    sum_splits<kPreThreads>(partials, out, N, F, col0, row0, min(row0 + kPreRows, N), splits);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NT>
cudaError_t launch_decode(const __nv_bfloat16* x, const int8_t* packed, const float* scale,
                          __nv_bfloat16* out, float* partials, int* tickets, int N, int D, int F,
                          int splits, int gps, cudaStream_t stream) {
  constexpr int smem = kStages * Stage<8 * NT>::kBytes;
  const cudaError_t attr = allow_smem(int4_decode_kernel<NT>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(F / kStrip, splits);
  int4_decode_kernel<NT><<<grid, kDecThreads, smem, stream>>>(x, packed, scale, out, partials,
                                                              tickets, N, D, F, gps);
  return cudaGetLastError();
}

cudaError_t launch_prefill(const __nv_bfloat16* x, const int8_t* packed, const float* scale,
                           __nv_bfloat16* out, float* partials, int* tickets, int N, int D,
                           int F, int splits, int gps, cudaStream_t stream) {
  constexpr int smem = kStages * Stage<kPreRows>::kBytes;
  const cudaError_t attr = allow_smem(int4_prefill_kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(F / kStrip, (N + kPreRows - 1) / kPreRows, splits);
  int4_prefill_kernel<<<grid, kPreThreads, smem, stream>>>(x, packed, scale, out, partials,
                                                           tickets, N, D, F, gps);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). `splits`: the host's split count
// (`int4_split_plan`); with more than one, `partials` is f32 [splits, N,
// F] scratch and `tickets` int32 zeros, one per column strip (N <= 16) or
// per (128-row tile, column strip), which the launch leaves zero.
extern "C" int dtt_grouped_int4_matmul(const void* x, const void* packed, const void* scale,
                                       void* out, void* partials, void* tickets, int N, int D,
                                       int F, int splits, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || F <= 0 || D % (2 * kGroup) != 0 || F % kStrip != 0)
    return (int)cudaErrorInvalidValue;
  const int n_groups = D / kGroup;
  if (splits < 1 || splits > n_groups) return (int)cudaErrorInvalidValue;
  const int gps = (n_groups + splits - 1) / splits;
  if ((n_groups + gps - 1) / gps != splits) return (int)cudaErrorInvalidValue;  // an empty split
  if (splits > 1 && (partials == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* pb = static_cast<const int8_t*>(packed);
  const float* sb = static_cast<const float*>(scale);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  float* pp = static_cast<float*>(partials);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > kDecodeRows)
    return (int)launch_prefill(xb, pb, sb, ob, pp, tk, N, D, F, splits, gps, st);
  return N <= 8 ? (int)launch_decode<1>(xb, pb, sb, ob, pp, tk, N, D, F, splits, gps, st)
                : (int)launch_decode<2>(xb, pb, sb, ob, pp, tk, N, D, F, splits, gps, st);
}
