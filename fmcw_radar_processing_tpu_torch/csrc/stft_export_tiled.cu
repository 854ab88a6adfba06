// K4a and K4b — the bin-blocked spectrogram export for any nfft: what the
// fidelity profile (nfft = 2^nextpow2(L)) runs once the untiled pair K2/K3
// no longer fits (nb_pad > 272, nfft > 512).
//
// K4a psd_phase1_tiled replaces ops/stft_pallas.py::_psd_kernel_tiled:
//
//     p[b, t] = (Σ_w A2[b, w]·sig[t + w])² + (Σ_w A2[nb_pad + b, w]·sig[t + w])²
//     p = 0 at columns t ≥ nv;   tmax[k, i] = max of the stored p of
//     column tile i and bin block k (the caller reduces it on the device)
//
// The grid is column tiles × 128-bin blocks: a block stages its [2·128, 20]
// slice of the folded operator (20 KB) and its 1043 signal samples in
// shared memory, and each thread keeps a column's 20 window samples in
// registers — K2's inner loop (psd_value, export_common.cuh) with an outer
// bin-block index, so the
// operator no longer has to fit whole. Bound on an H100: the PSD write
// (nb_pad·t_pad·4 bytes, 0.54 GB at nfft 16,384 and 16,384 columns) and
// as many nanoseconds of float32 FMAs (2·nb_pad·20 per column, 5.4e9 there).
//
// K4b db_rescale_tiled replaces ops/stft_pallas.py::_db_rescale_kernel_tiled:
//
//     db = K3's dB (export_common.cuh);  out[o, t] = w0[o]·db[i0[o], t]
//                                                   + w1[o]·db[i0[o] + 1, t]
//
// The TPU accumulated a dense bf16x3 contraction over bin blocks in VMEM;
// here the interpolation is the exact float32 gather-and-lerp over the two
// nonzeros of each row. One block owns 32 columns and walks the bin blocks
// in order: it turns kb + 1 PSD rows (one halo row, so i0 + 1 is always in
// shared memory) into dB, stores its kb own rows, then emits the output
// rows whose i0 falls in the block. i0 is nondecreasing, so those rows are
// the contiguous range [o_start[k], o_start[k + 1]), built on the host.
// Blocks do not own bin blocks: at nb 8,193 about 551 of the 1,024 output
// rows fall in the first 128 bins. Bound: bytes — the PSD read, the dB
// store and the [1024, t_pad] intensity store (1.14 GB at nfft 16,384 and
// 16,384 columns, float32).
//
// Offsets into [nb_pad, t_pad] arrays are 64-bit: at nfft 65,536 and
// 65,536 columns nb_pad·t_pad is 2.15e9 > 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "export_common.cuh"

namespace {

constexpr int kWl = kStftTaps;                // STFT window length
constexpr int kKb = 128;                      // bins per bin block
constexpr int kAThreads = 256;
constexpr int kACols = 4;                     // columns per thread
constexpr int kATile = kAThreads * kACols;    // 1024 columns per K4a block
constexpr int kBThreads = 256;
constexpr int kBTile = 32;                    // columns per K4b block
constexpr int kBRowStep = kBThreads / kBTile;

__global__ void __launch_bounds__(kAThreads)
psd_tiled_kernel(const float* __restrict__ sig, int sig_len,
                 const float* __restrict__ a2, int nb_pad,
                 float* __restrict__ p, float* __restrict__ tmax, int t_pad,
                 int nv) {
  __shared__ float4 ops4[2 * kKb * kWl / 4];  // re rows [kKb][kWl], im rows
  __shared__ float xs[kATile + kWl - 1];
  __shared__ float warp_max[kAThreads / 32];
  const float* ops = reinterpret_cast<const float*>(ops4);
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kATile;
  const int r0 = blockIdx.y * kKb;
  const int rows = min(kKb, nb_pad - r0);  // the last block may be partial

  // Rows are 80 bytes and r0, nb_pad are whole rows: 16-byte aligned.
  const float4* are = reinterpret_cast<const float4*>(a2 + (size_t)r0 * kWl);
  const float4* aim =
      reinterpret_cast<const float4*>(a2 + (size_t)(nb_pad + r0) * kWl);
  for (int i = tid; i < rows * kWl / 4; i += kAThreads) {
    ops4[i] = are[i];
    ops4[kKb * kWl / 4 + i] = aim[i];
  }
  for (int i = tid; i < kATile + kWl - 1; i += kAThreads) {
    const int s = t0 + i;
    xs[i] = s < sig_len ? sig[s] : 0.f;
  }
  __syncthreads();

  float mx = 0.f;
  for (int c = 0; c < kACols; ++c) {
    const int lt = c * kAThreads + tid;
    const int t = t0 + lt;
    const bool valid = t < nv;
    float xv[kWl];
#pragma unroll
    for (int w = 0; w < kWl; ++w) xv[w] = xs[lt + w];
    for (int b = 0; b < rows; ++b) {
      const float4* ore = reinterpret_cast<const float4*>(&ops[b * kWl]);
      const float4* oim =
          reinterpret_cast<const float4*>(&ops[(kKb + b) * kWl]);
      const float pv = valid ? psd_value(xv, ore, oim) : 0.f;
      p[(size_t)(r0 + b) * t_pad + t] = pv;
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
    for (int i = 1; i < kAThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
    tmax[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = m;
  }
}

template <typename DbT, typename OutT>
__global__ void __launch_bounds__(kBThreads)
db_rescale_tiled_kernel(const float* __restrict__ p,
                        const float* __restrict__ gmax,
                        const int* __restrict__ i0,
                        const float* __restrict__ w0,
                        const float* __restrict__ w1,
                        const int* __restrict__ o_start, int nb_pad,
                        int t_pad, DbT* __restrict__ db,
                        OutT* __restrict__ out, float ln10_inv_20,
                        float db_floor, float int8_lo, float int8_scale) {
  __shared__ float dbs[(kKb + 1) * kBTile];  // kb own rows + the halo row
  const int tid = threadIdx.x;
  const int col = tid % kBTile;
  const int row0 = tid / kBTile;
  const size_t t = (size_t)blockIdx.x * kBTile + col;
  const float g = *gmax;
  const float safe = g > 0.f ? g : 1.f;
  const int n_blocks = (nb_pad + kKb - 1) / kKb;

  for (int k = 0; k < n_blocks; ++k) {
    const int r0 = k * kKb;
    const int own = min(kKb, nb_pad - r0);
    // The halo row r0 + own exists except after the last block, where no
    // output row needs it (i0 + 1 ≤ nb − 1 < nb_pad).
    const int rows = min(own + 1, nb_pad - r0);
    for (int r = row0; r < rows; r += kBRowStep) {
      const size_t off = (size_t)(r0 + r) * t_pad + t;
      const float d = psd_to_db(p[off], safe, ln10_inv_20, db_floor);
      if (r < own) emit(&db[off], d, 0.f, 0.f);
      dbs[r * kBTile + col] = d;
    }
    __syncthreads();
    const int o_end = __ldg(&o_start[k + 1]);
    for (int o = __ldg(&o_start[k]) + row0; o < o_end; o += kBRowStep) {
      const int i = __ldg(&i0[o]) - r0;
      const float v = fmaf(__ldg(&w1[o]), dbs[(i + 1) * kBTile + col],
                           __ldg(&w0[o]) * dbs[i * kBTile + col]);
      emit(&out[(size_t)o * t_pad + t], v, int8_lo, int8_scale);
    }
    __syncthreads();  // the next block overwrites dbs
  }
}

template <typename DbT, typename OutT>
int launch_db_rescale_tiled(const float* p, const float* gmax, const int* i0,
                            const float* w0, const float* w1,
                            const int* o_start, int nb_pad, int t_pad,
                            void* db, void* out, float ln10_inv_20,
                            float db_floor, float int8_lo, float int8_scale,
                            cudaStream_t stream) {
  db_rescale_tiled_kernel<DbT, OutT><<<t_pad / kBTile, kBThreads, 0, stream>>>(
      p, gmax, i0, w0, w1, o_start, nb_pad, t_pad, reinterpret_cast<DbT*>(db),
      reinterpret_cast<OutT*>(out), ln10_inv_20, db_floor, int8_lo,
      int8_scale);
  return (int)cudaGetLastError();
}

template <typename DbT>
int dispatch_tiled_out(int out_dtype, const float* p, const float* gmax,
                       const int* i0, const float* w0, const float* w1,
                       const int* o_start, int nb_pad, int t_pad, void* db,
                       void* out, float ln10_inv_20, float db_floor,
                       float int8_lo, float int8_scale, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch_db_rescale_tiled<DbT, float>(
          p, gmax, i0, w0, w1, o_start, nb_pad, t_pad, db, out, ln10_inv_20,
          db_floor, int8_lo, int8_scale, stream);
    case 1:
      return launch_db_rescale_tiled<DbT, __nv_bfloat16>(
          p, gmax, i0, w0, w1, o_start, nb_pad, t_pad, db, out, ln10_inv_20,
          db_floor, int8_lo, int8_scale, stream);
    case 2:
      return launch_db_rescale_tiled<DbT, int8_t>(
          p, gmax, i0, w0, w1, o_start, nb_pad, t_pad, db, out, ln10_inv_20,
          db_floor, int8_lo, int8_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sig [sig_len] f32; a2 [2·nb_pad, 20] f32; p [nb_pad, t_pad] f32;
// tmax [ceil(nb_pad / 128) · t_pad / 1024] f32, bin block major.
// t_pad must be a multiple of 1024.
extern "C" int psd_phase1_tiled_launch(const float* sig, int sig_len,
                                       const float* a2, int nb_pad, float* p,
                                       float* tmax, int t_pad, int nv,
                                       void* stream) {
  const dim3 grid(t_pad / kATile, (nb_pad + kKb - 1) / kKb);
  psd_tiled_kernel<<<grid, kAThreads, 0, (cudaStream_t)stream>>>(
      sig, sig_len, a2, nb_pad, p, tmax, t_pad, nv);
  return (int)cudaGetLastError();
}

// p [nb_pad, t_pad] f32; gmax: one f32 on the device; i0/w0/w1 [num_bins];
// o_start [ceil(nb_pad / 128) + 1] int32, o_start[last] = num_bins;
// db [nb_pad, t_pad] (db_dtype 0 = f32, 1 = bf16); out [num_bins, t_pad]
// (out_dtype 0 = f32, 1 = bf16, 2 = int8). t_pad must be a multiple of 32.
extern "C" int db_rescale_tiled_launch(const float* p, const float* gmax,
                                       const int* i0, const float* w0,
                                       const float* w1, const int* o_start,
                                       int nb_pad, int t_pad, void* db,
                                       int db_dtype, void* out, int out_dtype,
                                       float ln10_inv_20, float db_floor,
                                       float int8_lo, float int8_scale,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (db_dtype) {
    case 0:
      return dispatch_tiled_out<float>(out_dtype, p, gmax, i0, w0, w1,
                                       o_start, nb_pad, t_pad, db, out,
                                       ln10_inv_20, db_floor, int8_lo,
                                       int8_scale, s);
    case 1:
      return dispatch_tiled_out<__nv_bfloat16>(out_dtype, p, gmax, i0, w0, w1,
                                               o_start, nb_pad, t_pad, db, out,
                                               ln10_inv_20, db_floor, int8_lo,
                                               int8_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
