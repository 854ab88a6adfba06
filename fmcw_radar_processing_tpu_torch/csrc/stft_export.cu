// K2, K3, K5a and K5b — the fused spectrogram export (STFT → PSD → dB →
// 1024 log-frequency bins) of a packed |slow-time| signal, hop 1, for
// nb_pad ≤ 272 (the untiled pair; stft_export_tiled.cu takes larger nb_pad).
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
//
// K5a psd_tmax and K5b db_rescale_recompute replace the recompute pair
// ops/stft_pallas.py::_tmax_kernel and ::_db_rescale_recompute_kernel: the
// [nb_pad, t_pad] PSD is never stored. K5a is K2 without the PSD store (one
// max per 1024-column tile); K5b gives a block 128 columns, stages their
// 147 signal samples and the whole folded operator in shared memory,
// recomputes the PSD with K2's psd_value, and then runs K3's dB,
// interpolation and emission on the tile. Same operands, same arithmetic
// (export_common.cuh): db and intensity are bit-equal to K2 → K3's. Bound:
// K5b trades K3's PSD read (0.57 GB at 65,536 frames, nb_pad 136) for
// 2·nb_pad·20 FMAs a column (11 GFLOP there, about 0.2 ms of the float32
// peak); its shared memory (the operator plus a 128-column dB tile, 183 KB
// at nb_pad 272) allows one block per SM at nb_pad 272, two at 136.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "export_common.cuh"

namespace {

constexpr int kWl = kStftTaps;      // STFT window length
constexpr int kP1Threads = 256;
constexpr int kP1Cols = 4;          // columns per thread
constexpr int kP1Tile = kP1Threads * kP1Cols;  // 1024 columns per block
constexpr int kP2Threads = 256;
constexpr int kP2Tile = 128;        // columns per block
constexpr int kP2RowStep = kP2Threads / kP2Tile;

// kStore = true is K2; false is K5a (tmax only, p untouched).
template <bool kStore>
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
      const float pv = valid ? psd_value(xv, ore, oim) : 0.f;
      if (kStore) p[(size_t)b * t_pad + t] = pv;
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

// The interpolation and emission of a dB tile dbs [rows][kP2Tile] held in
// shared memory: out[o, t] = w0[o]·dbs[i0[o]] + w1[o]·dbs[i0[o] + 1] for the
// rows o = row0, row0 + kP2RowStep, ... (K3 and K5b).
template <typename OutT>
__device__ __forceinline__ void emit_log_rows(
    const float* dbs, int col, int row0, size_t t, int t_pad, int num_bins,
    const int* __restrict__ i0, const float* __restrict__ w0,
    const float* __restrict__ w1, OutT* __restrict__ out, float int8_lo,
    float int8_scale) {
  for (int o = row0; o < num_bins; o += kP2RowStep) {
    const int i = __ldg(&i0[o]);
    const float v = fmaf(__ldg(&w1[o]), dbs[(i + 1) * kP2Tile + col],
                         __ldg(&w0[o]) * dbs[i * kP2Tile + col]);
    emit(&out[(size_t)o * t_pad + t], v, int8_lo, int8_scale);
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
  emit_log_rows(dbs, col, row0, t, t_pad, num_bins, i0, w0, w1, out, int8_lo,
                int8_scale);
}

// Signal samples a K5b block stages: its 128 columns' windows, padded to a
// whole float4 so the dB tile after them stays 16-byte aligned.
constexpr int kRcSamples = (kP2Tile + kWl - 1 + 3) / 4 * 4;

// K5b: the PSD of a 128-column tile recomputed from the signal (K2's
// psd_value on the same operator rows and samples), then K3's dB and
// emission. db is float32 only, as in the JAX recompute kernel.
template <typename OutT>
__global__ void __launch_bounds__(kP2Threads)
db_rescale_recompute_kernel(const float* __restrict__ sig, int sig_len,
                            const float* __restrict__ a2, int nb_pad, int nv,
                            const float* __restrict__ gmax,
                            const int* __restrict__ i0,
                            const float* __restrict__ w0,
                            const float* __restrict__ w1, int t_pad,
                            int num_bins, float* __restrict__ db,
                            OutT* __restrict__ out, float ln10_inv_20,
                            float db_floor, float int8_lo, float int8_scale) {
  extern __shared__ float4 smem4[];
  float* ops = reinterpret_cast<float*>(smem4);  // [2·nb_pad][kWl]
  float* xs = ops + 2 * nb_pad * kWl;            // [kRcSamples]
  float* dbs = xs + kRcSamples;                  // [nb_pad][kP2Tile]
  const int tid = threadIdx.x;
  const int col = tid % kP2Tile;
  const int row0 = tid / kP2Tile;
  const int t0 = blockIdx.x * kP2Tile;
  const size_t t = (size_t)t0 + col;
  const float g = *gmax;
  const float safe = g > 0.f ? g : 1.f;

  for (int i = tid; i < 2 * nb_pad * kWl / 4; i += kP2Threads) {
    smem4[i] = reinterpret_cast<const float4*>(a2)[i];
  }
  for (int i = tid; i < kRcSamples; i += kP2Threads) {
    const int s = t0 + i;
    xs[i] = s < sig_len ? sig[s] : 0.f;
  }
  __syncthreads();

  const bool valid = t0 + col < nv;
  float xv[kWl];
#pragma unroll
  for (int w = 0; w < kWl; ++w) xv[w] = xs[col + w];
  for (int b = row0; b < nb_pad; b += kP2RowStep) {
    const float4* ore = reinterpret_cast<const float4*>(&ops[b * kWl]);
    const float4* oim = reinterpret_cast<const float4*>(&ops[(nb_pad + b) * kWl]);
    const float pv = valid ? psd_value(xv, ore, oim) : 0.f;
    const float d = psd_to_db(pv, safe, ln10_inv_20, db_floor);
    db[(size_t)b * t_pad + t] = d;
    dbs[b * kP2Tile + col] = d;
  }
  __syncthreads();
  emit_log_rows(dbs, col, row0, t, t_pad, num_bins, i0, w0, w1, out, int8_lo,
                int8_scale);
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

template <bool kStore>
int launch_psd_phase1(const float* sig, int sig_len, const float* a2,
                      int nb_pad, float* p, float* tmax, int t_pad, int nv,
                      cudaStream_t stream) {
  const int smem = (2 * nb_pad * kWl + kP1Tile + kWl - 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      psd_phase1_kernel<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  psd_phase1_kernel<kStore><<<t_pad / kP1Tile, kP1Threads, smem, stream>>>(
      sig, sig_len, a2, nb_pad, p, tmax, t_pad, nv);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_recompute(const float* sig, int sig_len, const float* a2,
                     int nb_pad, int nv, const float* gmax, const int* i0,
                     const float* w0, const float* w1, int t_pad, int num_bins,
                     float* db, void* out, float ln10_inv_20, float db_floor,
                     float int8_lo, float int8_scale, cudaStream_t stream) {
  const int smem = (2 * nb_pad * kWl + kRcSamples + nb_pad * kP2Tile) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      db_rescale_recompute_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  db_rescale_recompute_kernel<OutT>
      <<<t_pad / kP2Tile, kP2Threads, smem, stream>>>(
          sig, sig_len, a2, nb_pad, nv, gmax, i0, w0, w1, t_pad, num_bins, db,
          reinterpret_cast<OutT*>(out), ln10_inv_20, db_floor, int8_lo,
          int8_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// sig [sig_len] f32; a2 [2·nb_pad, 20] f32; p [nb_pad, t_pad] f32;
// tmax [t_pad / 1024] f32. t_pad must be a multiple of 1024 and nb_pad of 2.
extern "C" int psd_phase1_launch(const float* sig, int sig_len,
                                 const float* a2, int nb_pad, float* p,
                                 float* tmax, int t_pad, int nv,
                                 void* stream) {
  return launch_psd_phase1<true>(sig, sig_len, a2, nb_pad, p, tmax, t_pad, nv,
                                 (cudaStream_t)stream);
}

// K5a: psd_phase1_launch's tmax without the PSD store.
extern "C" int psd_tmax_launch(const float* sig, int sig_len, const float* a2,
                               int nb_pad, float* tmax, int t_pad, int nv,
                               void* stream) {
  return launch_psd_phase1<false>(sig, sig_len, a2, nb_pad, nullptr, tmax,
                                  t_pad, nv, (cudaStream_t)stream);
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

// K5b. sig, a2, nv as psd_phase1_launch; gmax, i0/w0/w1, out, out_dtype as
// db_rescale_launch; db [nb_pad, t_pad] f32. t_pad must be a multiple of
// 128.
extern "C" int db_rescale_recompute_launch(
    const float* sig, int sig_len, const float* a2, int nb_pad, int nv,
    const float* gmax, const int* i0, const float* w0, const float* w1,
    int t_pad, int num_bins, float* db, void* out, int out_dtype,
    float ln10_inv_20, float db_floor, float int8_lo, float int8_scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case 0:
      return launch_recompute<float>(sig, sig_len, a2, nb_pad, nv, gmax, i0,
                                     w0, w1, t_pad, num_bins, db, out,
                                     ln10_inv_20, db_floor, int8_lo,
                                     int8_scale, s);
    case 1:
      return launch_recompute<__nv_bfloat16>(sig, sig_len, a2, nb_pad, nv,
                                             gmax, i0, w0, w1, t_pad,
                                             num_bins, db, out, ln10_inv_20,
                                             db_floor, int8_lo, int8_scale, s);
    case 2:
      return launch_recompute<int8_t>(sig, sig_len, a2, nb_pad, nv, gmax, i0,
                                      w0, w1, t_pad, num_bins, db, out,
                                      ln10_inv_20, db_floor, int8_lo,
                                      int8_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
