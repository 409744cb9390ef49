// The int8 LM head: logits = x @ q * scale, bf16 activations, int8 weights
// with one f32 scale per vocab column, f32 accumulation and f32 logits.
//
// Replaces: the Pallas kernel `_kernel` under `lm_head_int8`
// (dynamo_tpu/engine/lm_head.py), which the llama `_logits` calls once per
// prefill (one row) and once per decode step (B rows) whenever the head is
// int8, under every weight-quantization mode.
//
// Contract: x [B, D] bf16, q [D, V] int8 (row-major: column v of row d at
// d*V + v), scale [V] f32 → out [B, V] f32, out[b, v] = (sum_d x[b, d] *
// q[d, v]) * scale[v]. Any V and D; B is taken 8 rows per launch.
//
// Bound on an H100. The head is a weights read: at the Llama-3-8B shape
// (D = 4096, V = 128256) the int8 payload is 525 MB against 2*B*D*V flop,
// 16 flop per weight byte at B = 8, far below the card's ~295 flop/byte
// balance point, so the floor is the bytes (~0.16 ms at 3.35 TB/s) for
// every B <= 16. This kernel is near it at B = 1 (0.23 ms on an H100 80GB
// HBM3 at 700 W, PERF.md) but not at B = 8 (0.70 ms): its 8 x 16 f32
// accumulators take 176 registers, so one CTA of 8 warps fits an SM and
// the int8-to-float conversions and FMAs of 8 rows are not hidden behind
// the loads. Fewer accumulators per thread (more CTAs per SM), or the
// tensor cores, are the next steps.
//
// Design: the weights are streamed once. One CTA of 256 threads owns a strip
// of 256 vocab columns: 16 threads span the strip with one 16-byte load of
// 16 int8 columns each, and the 16 rows of threads split the D rows, so a
// warp reads two 256-byte row segments per load. x is staged in shared
// memory 256 rows of D at a time, in f32; each thread keeps B x 16 f32
// accumulators in registers, converts its int8 bytes in registers and
// accumulates all B rows at once. The 16 partial sums of a column meet in
// shared memory; the column's scale is applied on the way out. A V that is
// not a multiple of 16 takes byte loads on the ragged edge. No tensor cores,
// cp.async or TMA yet: the loads are plain and synchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 16;                       // threads across a strip
constexpr int kCols = 16;                             // columns per thread
constexpr int kStrip = kColThreads * kCols;           // columns per CTA
constexpr int kRowThreads = kThreads / kColThreads;   // D-slices per CTA
constexpr int kTileD = 256;                           // x rows staged at once
constexpr int kMaxRows = 8;                           // batch rows per launch

template <int NB>
__global__ void __launch_bounds__(kThreads)
lm_head_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out, int nb, int D,
                    int V) {
  __shared__ float sx[NB][kTileD];
  __shared__ float red[kRowThreads][kStrip];

  const int tid = threadIdx.x;
  const int cg = tid % kColThreads, dr = tid / kColThreads;
  const long col0 = (long)blockIdx.x * kStrip + cg * kCols;
  const bool vec = (V % 16 == 0) && (col0 + kCols <= V);

  float acc[NB][kCols];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[b][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kTileD) {
    const int nd = min(kTileD, D - d0);
    __syncthreads();  // the previous tile of x is consumed
    for (int i = tid; i < NB * kTileD; i += kThreads) {
      const int b = i / kTileD, d = i % kTileD;
      sx[b][d] = (b < nb && d < nd) ? __bfloat162float(x[(long)b * D + d0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = dr; d < nd; d += kRowThreads) {
      const int8_t* row = q + (long)(d0 + d) * V;
      int8_t w[kCols];
      if (vec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + col0);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < kCols; ++j) w[j] = e[j];
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) w[j] = (col0 + j < V) ? row[col0 + j] : 0;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float xv = sx[b][d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[b][j] += xv * static_cast<float>(w[j]);
      }
    }
  }

  // thread t finishes column col0(t % 16) + t / 16 of the strip; red is laid
  // out [slice][j * 16 + cg] so both the writes and the reads are
  // consecutive across a warp
  const int out_cg = tid % kColThreads, out_j = tid / kColThreads;
  const long out_col = (long)blockIdx.x * kStrip + out_cg * kCols + out_j;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[dr][j * kColThreads + cg] = acc[b][j];
    __syncthreads();
    if (b < nb && out_col < V) {
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kRowThreads; ++s) sum += red[s][tid];
      out[(long)b * V + out_col] = sum * scale[out_col];
    }
  }
}

template <int NB>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* q, const float* scale, float* out,
                   int nb, int D, int V, cudaStream_t stream) {
  const int grid = (V + kStrip - 1) / kStrip;
  lm_head_int8_kernel<NB><<<grid, kThreads, 0, stream>>>(x, q, scale, out, nb, D, V);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int dtt_lm_head_int8(const void* x, const void* q, const void* scale, void* out,
                                int B, int D, int V, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sb = static_cast<const float*>(scale);
  float* ob = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < B; r0 += kMaxRows) {
    const int nb = B - r0 < kMaxRows ? B - r0 : kMaxRows;
    const __nv_bfloat16* xr = xb + (long)r0 * D;
    float* outr = ob + (long)r0 * V;
    cudaError_t err;
    if (nb == 1)
      err = launch<1>(xr, qb, sb, outr, nb, D, V, st);
    else if (nb == 2)
      err = launch<2>(xr, qb, sb, outr, nb, D, V, st);
    else if (nb <= 4)
      err = launch<4>(xr, qb, sb, outr, nb, D, V, st);
    else
      err = launch<8>(xr, qb, sb, outr, nb, D, V, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
