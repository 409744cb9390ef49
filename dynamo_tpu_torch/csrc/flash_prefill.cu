// Causal GQA flash attention for one prefill chunk, bf16 in/out, f32 math.
//
// Replaces: the Pallas kernel `_flash_prefill_kernel` under `flash_prefill`
// (dynamo_tpu/engine/attention.py), which the llama prefill path calls once
// per layer on the K/V it gathered from the paged pool.
//
// Contract (same as the Pallas kernel): q [T, H, Dh], k/v [S, KVH, Dh], all
// contiguous bf16. Query t sits at absolute position start_pos + t and sees
// key j iff j <= start_pos + t and j < seq_len. Rows past the chunk's true
// length attend real keys and are discarded by the caller, so every row
// gets a finite output. Returns out [T, H, Dh] bf16.
//
// Bound on an H100. The work's floor: at T = S = 2048, H = 32, Dh = 128 the
// causal half is 4*H*Dh*T*S/2 ~ 34 GFLOP against ~34 MB of q/k/v/out, so
// long chunks are floored by tensor-core operations; at T = 512 the floor
// is the bytes. This kernel is not near either floor: each KV tile is
// loaded with plain synchronous loads, then a barrier, then the MMAs, so
// loads and tensor-core work never overlap; at T = 512 it runs at ~8% of
// the floor (PERF.md). Not yet fixed: double-buffered cp.async/TMA loads
// and wgmma are the next steps.
//
// Design: one CTA of 4 warps per (64 query rows, KV head). The rows of a
// CTA are (position, head) pairs ordered position-major over the g = H/KVH
// query heads that share the KV head, so each K/V tile is loaded once for
// all g heads. Each warp owns 16 rows. The TPU kernel's sequential KV grid
// axis becomes a loop over 64-key tiles from 0 to the last tile any row of
// the CTA can see (the causal diagonal, capped by seq_len). QK^T and PV run
// on the tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate);
// the running max m, the sum l and the output accumulator live in
// registers (FlashAttention-2 layout). Q, K and V tiles sit in dynamic
// shared memory (3 x 64 x (Dh+8) bf16, the +8 pad spreads rows over banks).
// Loads are plain 16-byte vector loads; cp.async / TMA double buffering and
// wgmma are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per CTA
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

// Copy `n_rows` rows of Dh bf16 (global row stride `gstride` elements) into a
// shared tile with row stride Dh + 8; rows at or past `valid` are zero-filled.
template <int Dh>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          long gstride, int n_rows, int valid) {
  constexpr int kVec = Dh / 8;  // 16-byte vectors per row
  constexpr int kStride = Dh + 8;
  for (int i = threadIdx.x; i < n_rows * kVec; i += kThreads) {
    int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(gmem + r * gstride + c);
    *reinterpret_cast<uint4*>(smem + r * kStride + c) = val;
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int T, int H, int KVH, int S, int start_pos, int seq_len,
                     float scale_log2) {
  constexpr int kStride = Dh + 8;
  constexpr int kDSteps = Dh / 16;  // k-steps of the QK^T product
  constexpr int kDTiles = Dh / 8;   // n-tiles of the PV product
  constexpr int kKTiles = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * kStride;
  __nv_bfloat16* sV = sK + kKeys * kStride;

  const int g = H / KVH;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;  // first (position, head) row of the CTA
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  // Q tile: row r -> position (row0 + r) / g, head kvh*g + (row0 + r) % g
  {
    constexpr int kVec = Dh / 8;
    for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
      int r = i / kVec, c = (i % kVec) * 8;
      int R = row0 + r;
      int t = R / g, h = kvh * g + R % g;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t < T) val = *reinterpret_cast<const uint4*>(q + ((long)t * H + h) * Dh + c);
      *reinterpret_cast<uint4*>(sQ + r * kStride + c) = val;
    }
  }
  __syncthreads();

  // this warp's 16 rows as A fragments, kept in registers for the whole loop
  uint32_t qf[kDSteps][4];
  {
    const __nv_bfloat16* base = sQ + (warp * 16) * kStride;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
      int c = ks * 16 + tig * 2;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(base + gid * kStride + c);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(base + (gid + 8) * kStride + c);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(base + gid * kStride + c + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(base + (gid + 8) * kStride + c + 8);
    }
  }

  // absolute query positions of this thread's two rows
  const int qpos0 = start_pos + (row0 + warp * 16 + gid) / g;
  const int qpos1 = start_pos + (row0 + warp * 16 + gid + 8) / g;

  // keys this CTA can see: [0, min(last query position + 1, seq_len))
  int t_last = (row0 + kRows - 1) / g;
  if (t_last > T - 1) t_last = T - 1;
  int n_keys = start_pos + t_last + 1;
  if (n_keys > seq_len) n_keys = seq_len;
  if (n_keys > S) n_keys = S;
  const int n_tiles = n_keys > 0 ? (n_keys + kKeys - 1) / kKeys : 0;

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const long kv_stride = (long)KVH * Dh;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    __syncthreads();  // previous tile fully consumed
    load_tile<Dh>(sK, k + key0 * kv_stride + kvh * Dh, kv_stride, kKeys, S - key0);
    load_tile<Dh>(sV, v + key0 * kv_stride + kvh * Dh, kv_stride, kKeys, S - key0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kKTiles][4];
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      const __nv_bfloat16* krow = sK + (j * 8 + gid) * kStride;
#pragma unroll
      for (int ks = 0; ks < kDSteps; ++ks) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + tig * 2);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + tig * 2 + 8);
        mma_bf16_16816(s[j], qf[ks], b0, b1);
      }
    }

    // mask, scale into the log2 domain, online softmax
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int key = key0 + j * 8 + tig * 2 + e;
        bool ok = key < seq_len;
        float a = (ok && key <= qpos0) ? s[j][e] * scale_log2 : -INFINITY;
        float b = (ok && key <= qpos1) ? s[j][2 + e] * scale_log2 : -INFINITY;
        s[j][e] = a;
        s[j][2 + e] = b;
        mx0 = fmaxf(mx0, a);
        mx1 = fmaxf(mx1, b);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    // a row with no visible key so far keeps m = -inf; its p and alpha
    // must come out 0, not NaN
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKTiles; ++j) {
      s[j][0] = exp2f(s[j][0] - base0);
      s[j][1] = exp2f(s[j][1] - base0);
      s[j][2] = exp2f(s[j][2] - base1);
      s[j][3] = exp2f(s[j][3] - base1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
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
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = sV + (kk * 16 + tig * 2) * kStride;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        int d = j * 8 + gid;
        uint32_t b0 = pack_bf16_raw(v0[d], v0[kStride + d]);
        uint32_t b1 = pack_bf16_raw(v0[8 * kStride + d], v0[9 * kStride + d]);
        mma_bf16_16816(o[j], a, b0, b1);
      }
    }
  }

  // finish: the row sum is spread over the 4 threads of a quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int R0 = row0 + warp * 16 + gid, R1 = R0 + 8;
  const int t0 = R0 / g, t1 = R1 / g;
  __nv_bfloat16* out0 = out + ((long)t0 * H + kvh * g + R0 % g) * Dh;
  __nv_bfloat16* out1 = out + ((long)t1 * H + kvh * g + R1 % g) * Dh;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    int c = j * 8 + tig * 2;
    if (t0 < T)
      *reinterpret_cast<uint32_t*>(out0 + c) = pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (t1 < T)
      *reinterpret_cast<uint32_t*>(out1 + c) = pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

template <int Dh>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int T, int H,
                   int KVH, int S, int start_pos, int seq_len, float scale,
                   cudaStream_t stream) {
  const int smem = (kRows + 2 * kKeys) * (Dh + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int g = H / KVH;
  dim3 grid((T * g + kRows - 1) / kRows, KVH);
  flash_prefill_kernel<Dh><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, H, KVH, S,
      start_pos, seq_len, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). Head dims 64 and 128 are compiled.
extern "C" int dtt_flash_prefill_bf16(const void* q, const void* k, const void* v, void* out,
                                      int T, int H, int KVH, int Dh, int S, int start_pos,
                                      int seq_len, float scale, void* stream) {
  if (T <= 0) return 0;
  if (H % KVH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return (int)launch<64>(q, k, v, out, T, H, KVH, S, start_pos, seq_len, scale, st);
    case 128:
      return (int)launch<128>(q, k, v, out, T, H, KVH, S, start_pos, seq_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
