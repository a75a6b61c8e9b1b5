// Eval BN's affine map and the activation after it, for one fp32 value: the
// epilogue that K9 (bn_act.cu) applies to each bf16 element and K10
// (edge_max.cu) to each fp32 value it forms.
//
// In fp32 with every operation rounded on its own (-fmad=false and the _rn
// intrinsics), as models/layers.py::DynamicBatchNorm and F.relu /
// F.leaky_relu compute it:
//   y = ((x - mean) * inv) * scale + bias,  inv = rsqrt(var + eps)
// (inv is torch's own [C] tensor, computed before the launch), y rounded to
// bf16 (RNE), then ReLU (ATen's clamp_min: NaN kept, else fmaxf(y, 0)) or
// LeakyReLU (y > 0 ? y : y * slope on the rounded y widened to fp32,
// rounded again). Returns the result's bf16 bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

template <bool kLeaky>
__device__ __forceinline__ uint32_t bn_act_f32(float x, float m, float inv, float s, float b,
                                               float slope) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), inv), s), b);
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(y));
  const float f = __uint_as_float(h << 16);
  if (kLeaky)
    return __bfloat16_as_ushort(__float2bfloat16_rn(f > 0.f ? f : __fmul_rn(f, slope)));
  return isnan(f) ? h : __float_as_uint(fmaxf(f, 0.f)) >> 16;  // exact: f or 0
}
