// The numeric contract shared by the exact export kernels K3 and K5b
// (stft_export.cu) and K4a (which K2b and K5a launch), K4b and their
// recompute pair (stft_export_tiled.cu): the PSD values of windows, the dB
// of one PSD value, and the emission of float32 results in the store
// dtype. One definition, so every path rounds alike: the recompute pairs
// reproduce the materializing pairs' outputs bit for bit, and K4b
// reproduces K3's.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kStftTaps = 20;  // the STFT window length the kernels take

// The PSD of kCols adjacent columns from their kCols + 19 window samples x:
// p[c] = (Σ_w ore[w]·x[c + w])² + (Σ_w oim[w]·x[c + w])², with the re and
// im rows of the folded operator (√(scale·dbl) folded in, kStftTaps floats
// each, 16-byte aligned). Each column's chain is the same whatever kCols:
// FMAs in tap order, then re² rounded into an FMA with the rounded im²
// (written out, so no contraction choice of the compiler can differ
// between kernels). The columns share every operator load.
template <int kCols>
__device__ __forceinline__ void psd_values(
    const float (&x)[kCols + kStftTaps - 1], const float4* ore,
    const float4* oim, float (&p)[kCols]) {
  float sr[kCols], si[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) sr[c] = si[c] = 0.f;
#pragma unroll
  for (int q = 0; q < kStftTaps / 4; ++q) {
    const float4 ar = ore[q];
    const float4 ai = oim[q];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      sr[c] = fmaf(ar.x, x[c + 4 * q + 0], sr[c]);
      sr[c] = fmaf(ar.y, x[c + 4 * q + 1], sr[c]);
      sr[c] = fmaf(ar.z, x[c + 4 * q + 2], sr[c]);
      sr[c] = fmaf(ar.w, x[c + 4 * q + 3], sr[c]);
      si[c] = fmaf(ai.x, x[c + 4 * q + 0], si[c]);
      si[c] = fmaf(ai.y, x[c + 4 * q + 1], si[c]);
      si[c] = fmaf(ai.z, x[c + 4 * q + 2], si[c]);
      si[c] = fmaf(ai.w, x[c + 4 * q + 3], si[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    p[c] = __fmaf_rn(sr[c], sr[c], __fmul_rn(si[c], si[c]));
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// x = xs[lt .. lt + kN): whole float4 loads (lt a multiple of 4; xs holds
// at least lt + round4(kN) floats).
template <int kN>
__device__ __forceinline__ void load_window(const float* xs, int lt,
                                            float (&x)[kN]) {
  const float4* s = reinterpret_cast<const float4*>(xs + lt);
#pragma unroll
  for (int q = 0; q < (kN + 3) / 4; ++q) {
    const float4 v = s[q];
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * q + j < kN) x[4 * q + j] = w[j];
    }
  }
}

// The PSD of kCols adjacent columns t .. t + kCols − 1 of one operator row
// pair, zero at columns ≥ nv: the arithmetic K4a, K5b and the bin-blocked
// recompute share.
template <int kCols>
__device__ __forceinline__ void psd_group(
    const float (&x)[kCols + kStftTaps - 1], const float4* ore,
    const float4* oim, int t, int nv, float (&pv)[kCols]) {
  psd_values<kCols>(x, ore, oim, pv);
#pragma unroll
  for (int c = 0; c < kCols; ++c) pv[c] = t + c < nv ? pv[c] : 0.f;
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

// Physical float4 chunk of logical chunk c in a row of a dB tile in shared
// memory: the lanes of a row read chunks 2l and then 2l + 1, eight at a
// time, and this spreads those eight over all 32 banks.
__device__ __forceinline__ int tile_chunk(int c) { return c ^ ((c >> 3) & 1); }

// The int8 code of a dB value: the affine code over [lo, lo + 255 / scale],
// half to even (rintf, like jnp.round), clamped.
__device__ __forceinline__ int8_t int8_code(float v, float lo, float scale) {
  float q = rintf((v - lo) * scale);
  q = fminf(fmaxf(q, 0.f), 255.f);
  return (int8_t)(int)(q - 128.f);
}

// 8 consecutive values in the store dtype (dst 16-byte aligned for float
// and bf16, 8 for int8) as whole 16- or 8-byte streaming stores
// (st.global.cs: what nothing on the device reads again should not stay in
// L2): float32 as is, bf16 round-to-nearest-even, int8 int8_code.
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
