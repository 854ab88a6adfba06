// K2 and K3 — the fused spectrogram export (STFT → PSD → dB → 1024
// log-frequency bins) of a packed |slow-time| signal, hop 1.
//
// K2 psd_phase1 replaces ops/stft_pallas.py::_psd_kernel_b3 (production)
// and ::_psd_kernel (fidelity) of the JAX package:
//
//     s[b, t] = Σ_w A2[b, w] · sig[t + w]          (A2 = folded DFT operator,
//     p[b, t] = s[b, t]² + s[nb_pad + b, t]²         √(scale·dbl) in its rows)
//     p = 0 at columns t ≥ nv;   tmax[block] = max of the stored p
//
// It reads the sliding windows straight from the 1-D signal (the JAX
// package builds an im2col frame matrix only because Mosaic could not shift
// lanes in-kernel). Bound on an H100: the [nb_pad, t_pad] PSD write
// (604 MB at 65,536 frames, nfft 256) and about as many nanoseconds of
// float32 FMAs; the operator (≤ 82 KB) sits in shared memory and every
// thread keeps its 20 samples in registers, so each operator row costs five
// broadcast 16-byte loads per 40 FMAs. Writes are coalesced along t.
//
// K3 db_rescale replaces ops/stft_pallas.py::_db_rescale_kernel:
//
//     db = max(LN10_INV_20 · ln(max(p, 1e-45) / safe), floor) where p > 0,
//          else floor;                                  safe = gmax > 0 ? gmax : 1
//     out[o, t] = w0[o] · db[i0[o], t] + w1[o] · db[i0[o] + 1, t]
//
// The log-frequency matrix has two nonzeros per row, so the interpolation is
// a gather and a lerp at exact float32 (the TPU ran it as a dense bf16x3
// matmul because TPU gathers are slow). Bound: bytes — the PSD read, the dB
// store and the [1024, t_pad] intensity store (2.15 GB in bf16 at 65,536
// frames). A block turns a 128-column PSD tile into float32 dB in shared
// memory once, then streams the 1024 output rows with coalesced stores.
// Rounding: bf16 emission is round-to-nearest-even (__float2bfloat16_rn);
// int8 emission uses rintf (half to even, like jnp.round). Built without
// --use_fast_math: flush-to-zero would change the 1e-45 floor logic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "export_common.cuh"

namespace {

constexpr int kWl = 20;             // STFT window length
constexpr int kP1Threads = 256;
constexpr int kP1Cols = 4;          // columns per thread
constexpr int kP1Tile = kP1Threads * kP1Cols;  // 1024 columns per block
constexpr int kP2Threads = 256;
constexpr int kP2Tile = 128;        // columns per block
constexpr int kP2RowStep = kP2Threads / kP2Tile;

__global__ void __launch_bounds__(kP1Threads)
psd_phase1_kernel(const float* __restrict__ sig, int sig_len,
                  const float* __restrict__ a2, int nb_pad,
                  float* __restrict__ p, float* __restrict__ tmax,
                  int t_pad, int nv) {
  extern __shared__ float4 smem4[];
  float* ops = reinterpret_cast<float*>(smem4);  // [2·nb_pad][kWl]
  float* xs = ops + 2 * nb_pad * kWl;            // [kP1Tile + kWl − 1]
  __shared__ float warp_max[kP1Threads / 32];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kP1Tile;

  for (int i = tid; i < 2 * nb_pad * kWl / 4; i += kP1Threads) {
    smem4[i] = reinterpret_cast<const float4*>(a2)[i];
  }
  for (int i = tid; i < kP1Tile + kWl - 1; i += kP1Threads) {
    const int s = t0 + i;
    xs[i] = s < sig_len ? sig[s] : 0.f;
  }
  __syncthreads();

  float mx = 0.f;
  for (int c = 0; c < kP1Cols; ++c) {
    const int lt = c * kP1Threads + tid;
    const int t = t0 + lt;
    const bool valid = t < nv;
    float xv[kWl];
#pragma unroll
    for (int w = 0; w < kWl; ++w) xv[w] = xs[lt + w];
    for (int b = 0; b < nb_pad; ++b) {
      const float4* ore = reinterpret_cast<const float4*>(&ops[b * kWl]);
      const float4* oim = reinterpret_cast<const float4*>(&ops[(nb_pad + b) * kWl]);
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int q = 0; q < kWl / 4; ++q) {
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
      const float pv = valid ? sr * sr + si * si : 0.f;
      p[(size_t)b * t_pad + t] = pv;
      mx = fmaxf(mx, pv);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((tid & 31) == 0) warp_max[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = warp_max[0];
    for (int i = 1; i < kP1Threads / 32; ++i) m = fmaxf(m, warp_max[i]);
    tmax[blockIdx.x] = m;
  }
}

template <typename DbT, typename OutT>
__global__ void __launch_bounds__(kP2Threads)
db_rescale_kernel(const float* __restrict__ p, const float* __restrict__ gmax,
                  const int* __restrict__ i0, const float* __restrict__ w0,
                  const float* __restrict__ w1, int nb_pad, int t_pad,
                  int num_bins, DbT* __restrict__ db, OutT* __restrict__ out,
                  float ln10_inv_20, float db_floor, float int8_lo,
                  float int8_scale) {
  extern __shared__ float dbs[];  // [nb_pad][kP2Tile] float32 dB
  const int tid = threadIdx.x;
  const int col = tid % kP2Tile;
  const int row0 = tid / kP2Tile;
  const size_t t = (size_t)blockIdx.x * kP2Tile + col;
  const float g = *gmax;
  const float safe = g > 0.f ? g : 1.f;

  for (int b = row0; b < nb_pad; b += kP2RowStep) {
    const float d = psd_to_db(p[(size_t)b * t_pad + t], safe, ln10_inv_20,
                              db_floor);
    emit(&db[(size_t)b * t_pad + t], d, 0.f, 0.f);
    dbs[b * kP2Tile + col] = d;
  }
  __syncthreads();
  for (int o = row0; o < num_bins; o += kP2RowStep) {
    const int i = __ldg(&i0[o]);
    const float v = fmaf(__ldg(&w1[o]), dbs[(i + 1) * kP2Tile + col],
                         __ldg(&w0[o]) * dbs[i * kP2Tile + col]);
    emit(&out[(size_t)o * t_pad + t], v, int8_lo, int8_scale);
  }
}

template <typename DbT, typename OutT>
int launch_db_rescale(const float* p, const float* gmax, const int* i0,
                      const float* w0, const float* w1, int nb_pad, int t_pad,
                      int num_bins, void* db, void* out, float ln10_inv_20,
                      float db_floor, float int8_lo, float int8_scale,
                      cudaStream_t stream) {
  const int smem = nb_pad * kP2Tile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      db_rescale_kernel<DbT, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  db_rescale_kernel<DbT, OutT><<<t_pad / kP2Tile, kP2Threads, smem, stream>>>(
      p, gmax, i0, w0, w1, nb_pad, t_pad, num_bins,
      reinterpret_cast<DbT*>(db), reinterpret_cast<OutT*>(out), ln10_inv_20,
      db_floor, int8_lo, int8_scale);
  return (int)cudaGetLastError();
}

template <typename DbT>
int dispatch_out(int out_dtype, const float* p, const float* gmax,
                 const int* i0, const float* w0, const float* w1, int nb_pad,
                 int t_pad, int num_bins, void* db, void* out,
                 float ln10_inv_20, float db_floor, float int8_lo,
                 float int8_scale, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch_db_rescale<DbT, float>(p, gmax, i0, w0, w1, nb_pad, t_pad,
                                           num_bins, db, out, ln10_inv_20,
                                           db_floor, int8_lo, int8_scale,
                                           stream);
    case 1:
      return launch_db_rescale<DbT, __nv_bfloat16>(
          p, gmax, i0, w0, w1, nb_pad, t_pad, num_bins, db, out, ln10_inv_20,
          db_floor, int8_lo, int8_scale, stream);
    case 2:
      return launch_db_rescale<DbT, int8_t>(p, gmax, i0, w0, w1, nb_pad,
                                            t_pad, num_bins, db, out,
                                            ln10_inv_20, db_floor, int8_lo,
                                            int8_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sig [sig_len] f32; a2 [2·nb_pad, 20] f32; p [nb_pad, t_pad] f32;
// tmax [t_pad / 1024] f32. t_pad must be a multiple of 1024 and nb_pad of 2.
extern "C" int psd_phase1_launch(const float* sig, int sig_len,
                                 const float* a2, int nb_pad, float* p,
                                 float* tmax, int t_pad, int nv,
                                 void* stream) {
  const int smem = (2 * nb_pad * kWl + kP1Tile + kWl - 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      psd_phase1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  psd_phase1_kernel<<<t_pad / kP1Tile, kP1Threads, smem,
                      (cudaStream_t)stream>>>(sig, sig_len, a2, nb_pad, p,
                                              tmax, t_pad, nv);
  return (int)cudaGetLastError();
}

// p [nb_pad, t_pad] f32; gmax: one f32 on the device; i0/w0/w1 [num_bins];
// db [nb_pad, t_pad] (db_dtype 0 = f32, 1 = bf16); out [num_bins, t_pad]
// (out_dtype 0 = f32, 1 = bf16, 2 = int8). t_pad must be a multiple of 128.
extern "C" int db_rescale_launch(const float* p, const float* gmax,
                                 const int* i0, const float* w0,
                                 const float* w1, int nb_pad, int t_pad,
                                 int num_bins, void* db, int db_dtype,
                                 void* out, int out_dtype, float ln10_inv_20,
                                 float db_floor, float int8_lo,
                                 float int8_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (db_dtype) {
    case 0:
      return dispatch_out<float>(out_dtype, p, gmax, i0, w0, w1, nb_pad,
                                 t_pad, num_bins, db, out, ln10_inv_20,
                                 db_floor, int8_lo, int8_scale, s);
    case 1:
      return dispatch_out<__nv_bfloat16>(out_dtype, p, gmax, i0, w0, w1,
                                         nb_pad, t_pad, num_bins, db, out,
                                         ln10_inv_20, db_floor, int8_lo,
                                         int8_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
