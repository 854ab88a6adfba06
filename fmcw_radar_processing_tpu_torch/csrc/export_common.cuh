// The numeric contract shared by the export kernels K2, K3, K5a, K5b
// (stft_export.cu) and K4a, K4b (stft_export_tiled.cu): one PSD value of a
// window, the dB of one PSD value, and the emission of a float32 result in
// the store dtype. One definition, so every path rounds alike: the recompute
// pair K5a/K5b reproduces K2/K3's outputs bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kStftTaps = 20;  // the STFT window length the kernels take

// p = (Σ_w ore[w]·x[w])² + (Σ_w oim[w]·x[w])²: the re and im rows of the
// folded operator (√(scale·dbl) folded in, kStftTaps floats each, 16-byte
// aligned), FMAs in tap order, then the square-add.
__device__ __forceinline__ float psd_value(const float (&xv)[kStftTaps],
                                           const float4* ore,
                                           const float4* oim) {
  float sr = 0.f, si = 0.f;
#pragma unroll
  for (int q = 0; q < kStftTaps / 4; ++q) {
    const float4 ar = ore[q];
    const float4 ai = oim[q];
    sr = fmaf(ar.x, xv[4 * q + 0], sr);
    sr = fmaf(ar.y, xv[4 * q + 1], sr);
    sr = fmaf(ar.z, xv[4 * q + 2], sr);
    sr = fmaf(ar.w, xv[4 * q + 3], sr);
    si = fmaf(ai.x, xv[4 * q + 0], si);
    si = fmaf(ai.y, xv[4 * q + 1], si);
    si = fmaf(ai.z, xv[4 * q + 2], si);
    si = fmaf(ai.w, xv[4 * q + 3], si);
  }
  return sr * sr + si * si;
}

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
__device__ __forceinline__ int8_t int8_code(float v, float lo, float scale) {
  float q = rintf((v - lo) * scale);
  q = fminf(fmaxf(q, 0.f), 255.f);
  return (int8_t)(int)(q - 128.f);
}
__device__ __forceinline__ void emit(int8_t* dst, float v, float lo,
                                     float scale) {
  *dst = int8_code(v, lo, scale);
}

// emit of 8 consecutive values (dst 16-byte aligned for float and bf16, 8
// for int8) as whole 16- or 8-byte streaming stores (st.global.cs): what
// nothing on the device reads again should not stay in L2.
__device__ __forceinline__ void emit8(float* dst, const float (&v)[8], float,
                                      float) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void emit8(__nv_bfloat16* dst, const float (&v)[8],
                                      float, float) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(v[2 * i]),
                                                __float2bfloat16_rn(v[2 * i + 1]));
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(dst), u);
}
__device__ __forceinline__ void emit8(int8_t* dst, const float (&v)[8],
                                      float lo, float scale) {
  uint2 u;
  int8_t* b = reinterpret_cast<int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = int8_code(v[i], lo, scale);
  __stcs(reinterpret_cast<uint2*>(dst), u);
}

}  // namespace
