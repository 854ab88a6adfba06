// The numeric contract shared by the export kernels K3 (stft_export.cu) and
// K4b (stft_export_tiled.cu): the dB of one PSD value and the emission of a
// float32 result in the store dtype. One definition, so both paths round
// alike.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// db = max(LN10_INV_20 · ln(max(p, 1e-45) / safe), floor) where p > 0, else
// floor; safe = gmax > 0 ? gmax : 1. The 1e-45 clamp is subnormal: the
// kernels are built without --use_fast_math, which would flush it to zero.
__device__ __forceinline__ float psd_to_db(float pv, float safe,
                                           float ln10_inv_20, float db_floor) {
  return pv > 0.f
      ? fmaxf(ln10_inv_20 * logf(fmaxf(pv, 1e-45f) / safe), db_floor)
      : db_floor;
}

// float32 as is; bf16 round-to-nearest-even; int8 the affine dB code over
// [lo, lo + 255 / scale], half to even (rintf, like jnp.round), clamped.
__device__ __forceinline__ void emit(float* dst, float v, float, float) {
  *dst = v;
}
__device__ __forceinline__ void emit(__nv_bfloat16* dst, float v, float,
                                     float) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void emit(int8_t* dst, float v, float lo,
                                     float scale) {
  float q = rintf((v - lo) * scale);
  q = fminf(fmaxf(q, 0.f), 255.f);
  *dst = (int8_t)(int)(q - 128.f);
}

}  // namespace
