// The attention logit soft-cap of K1, K3 and K4 (Gemma-2), shared by
// flash_prefill.cu, paged_attention.cu and ragged_paged_attention.cu.
#pragma once

constexpr float kLog2e = 1.4426950408889634f;

// cap * tanh(x / cap) for cap > 0, with tanh(z) = 1 - 2 / (e^{2z} + 1): an
// absolute error of a few f32 ulps of cap (an infinite e^{2z} gives cap),
// from one exp2 and a fast division rather than MUFU tanh.approx (a
// relative error near 2^-11). The kernels call it in the log2 domain (x
// and cap both scaled by log2(e)), which leaves the formula unchanged.
__device__ __forceinline__ float soft_cap(float x, float cap) {
  const float e = exp2f(x * (2.f * kLog2e / cap));
  return cap - __fdividef(2.f * cap, e + 1.f);
}
