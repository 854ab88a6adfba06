// K3 and K5b — phase 2 of the fused spectrogram export (PSD → dB → 1024
// log-frequency bins) of a packed |slow-time| signal, hop 1, for
// nb_pad ≤ 272 (the untiled kernels; stft_export_tiled.cu takes larger
// nb_pad). Phase 1 is K2a (stft_psd_b3.cu, bf16x3 on the tensor cores) or,
// exact, K4a's kernel (stft_export_tiled.cu), which K2b and K5a launch:
// one kernel for the exact PSD at every nb_pad.
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
// store and the [1024, t_pad] intensity store (0.604 + 0.302 + 2.147 GB at
// 65,536 frames, nb_pad 144, bf16 stores: 0.911 ms at 3.35 TB/s). The
// design moves those bytes in whole 16-byte transactions and keeps one
// tile's loads in flight while the previous tile is emitted: a persistent
// grid (as many blocks as fit) walks 128-column tiles (64 above nb_pad
// 208, where two 128-column buffers would not fit); the next tile's PSD
// [nb_pad, 128] comes in by 16-byte cp.async into the
// second of two shared-memory buffers while the current one is turned into
// float32 dB in place (vectorised dB stores) and then emitted. Each thread
// owns 8 consecutive columns of an output row: one 16-byte store in bf16,
// two in float32, one 8-byte store in int8, all streaming (st.global.cs:
// nothing on the device reads the intensity again). i0/w0/w1 (12 KB) are
// staged in shared memory once per block; the 16-byte chunks of a dB tile
// row are XOR-swizzled so the eight lanes reading one row hit distinct
// banks. Shared memory: two float32 dB tiles (147 KB at nb_pad 144, 139 KB
// of 64-column tiles at nb_pad 272; one block per SM) plus the tables.
// 128-column tiles write 256 contiguous bytes of each bf16 output row per
// tile, twice the run of 64-column tiles. The arithmetic
// is psd_to_db, fmaf(w1, db[i + 1], w0 · db[i]) and the emission rounding
// of export_common.cuh, so the outputs equal K5b's bit for bit.
// Rounding: bf16 emission is round-to-nearest-even (__float2bfloat16_rn);
// int8 emission uses rintf (half to even, like jnp.round). Built without
// --use_fast_math: flush-to-zero would change the 1e-45 floor logic.
//
// K5b db_rescale_recompute replaces ops/stft_pallas.py::
// _db_rescale_recompute_kernel, the second kernel of the recompute pair
// (the first, K5a, is K4a's kernel without its store): the [nb_pad, t_pad]
// PSD is never stored. K5b gives a block 128 columns, stages their 147
// signal samples and the whole folded operator in shared memory,
// recomputes the PSD with psd_value (the chain K4a computes every column
// with), and then runs K3's dB, interpolation and emission arithmetic on
// the tile (its own loop, one column per thread). Same operands, same
// arithmetic (export_common.cuh): db and intensity are bit-equal to
// K2b → K3's. Bound: K5b trades K3's PSD read (0.57 GB at 65,536 frames,
// nb_pad 136) for 2·nb_pad·20 FMAs a column (11 GFLOP there, about 0.2 ms
// of the float32 peak); its shared memory (the operator plus a 128-column
// dB tile, 183 KB at nb_pad 272) allows one block per SM at nb_pad 272,
// two at 136.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "export_common.cuh"

namespace {

constexpr int kWl = kStftTaps;      // STFT window length
constexpr int kP2Threads = 256;
constexpr int kP2Tile = 128;        // columns per K5b block
constexpr int kP2RowStep = kP2Threads / kP2Tile;

// The interpolation and emission of a dB tile dbs [rows][kP2Tile] held in
// shared memory: out[o, t] = w0[o]·dbs[i0[o]] + w1[o]·dbs[i0[o] + 1] for the
// rows o = row0, row0 + kP2RowStep, ... (K5b).
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

constexpr int kP3Threads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// kTile columns per tile: 128, or 64 where two 128-column buffers and the
// tables exceed a block's shared memory (nb_pad above 208).
template <int kTile, typename DbT, typename OutT>
__global__ void __launch_bounds__(kP3Threads)
db_rescale_kernel(const float* __restrict__ p, const float* __restrict__ gmax,
                  const int* __restrict__ i0, const float* __restrict__ w0,
                  const float* __restrict__ w1, int nb_pad, int t_pad,
                  int num_bins, DbT* __restrict__ db, OutT* __restrict__ out,
                  float ln10_inv_20, float db_floor, float int8_lo,
                  float int8_scale) {
  constexpr int kChunks = kTile / 4;             // float4 chunks per row
  constexpr int kRowThreads = kTile / 8;         // threads per output row
  constexpr int kRowStep = kP3Threads / kRowThreads;
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);  // 2 × [nb_pad][kTile]
  int* s_i0 = reinterpret_cast<int*>(bufs + 2 * nb_pad * kTile);
  float* s_w0 = reinterpret_cast<float*>(s_i0 + num_bins);
  float* s_w1 = s_w0 + num_bins;
  const int tid = threadIdx.x;
  const int tiles = t_pad / kTile;
  const float g = *gmax;
  const float safe = g > 0.f ? g : 1.f;

  auto load_tile = [&](float* buf, int tile) {
    const float* src = p + (size_t)tile * kTile;
    for (int i = tid; i < nb_pad * kChunks; i += kP3Threads) {
      const int b = i / kChunks;
      const int c = i % kChunks;
      cp_async16(buf + b * kTile + tile_chunk(c) * 4,
                 src + (size_t)b * t_pad + c * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int tile = blockIdx.x;
  if (tile < tiles) load_tile(bufs, tile);
  for (int o = tid; o < num_bins; o += kP3Threads) {
    s_i0[o] = i0[o];
    s_w0[o] = w0[o];
    s_w1[o] = w1[o];
  }
  const int lc = tid % kRowThreads;  // this thread's 8 columns: 8·lc ..
  const int row0 = tid / kRowThreads;
  int s = 0;
  for (; tile < tiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the tile is in; the other buffer is free
    const int next = tile + gridDim.x;
    if (next < tiles) load_tile(bufs + (s ^ 1) * nb_pad * kTile, next);
    float* buf = bufs + s * nb_pad * kTile;
    const size_t t0 = (size_t)tile * kTile;

    // PSD → float32 dB in place, stored 8 columns at a time.
    for (int i = tid; i < nb_pad * kRowThreads; i += kP3Threads) {
      const int b = i / kRowThreads;
      const int m = i % kRowThreads;
      float4* r = reinterpret_cast<float4*>(buf + b * kTile);
      float4 a = r[tile_chunk(2 * m)];
      float4 c = r[tile_chunk(2 * m + 1)];
      float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = psd_to_db(v[q], safe, ln10_inv_20, db_floor);
      }
      r[tile_chunk(2 * m)] = make_float4(v[0], v[1], v[2], v[3]);
      r[tile_chunk(2 * m + 1)] = make_float4(v[4], v[5], v[6], v[7]);
      emit8(db + (size_t)b * t_pad + t0 + 8 * m, v, 0.f, 0.f);
    }
    __syncthreads();

    // The 1024 output rows, kRowStep at a time, 8 columns per thread.
    const int c0 = tile_chunk(2 * lc);
    const int c1 = tile_chunk(2 * lc + 1);
    for (int o = row0; o < num_bins; o += kRowStep) {
      const int i = s_i0[o];
      const float a0 = s_w0[o];
      const float a1 = s_w1[o];
      const float4* lo = reinterpret_cast<const float4*>(buf + i * kTile);
      const float4* hi = lo + kChunks;
      const float4 x0 = lo[c0], x1 = lo[c1], y0 = hi[c0], y1 = hi[c1];
      const float v[8] = {
          fmaf(a1, y0.x, a0 * x0.x), fmaf(a1, y0.y, a0 * x0.y),
          fmaf(a1, y0.z, a0 * x0.z), fmaf(a1, y0.w, a0 * x0.w),
          fmaf(a1, y1.x, a0 * x1.x), fmaf(a1, y1.y, a0 * x1.y),
          fmaf(a1, y1.z, a0 * x1.z), fmaf(a1, y1.w, a0 * x1.w)};
      emit8(out + (size_t)o * t_pad + t0 + 8 * lc, v, int8_lo, int8_scale);
    }
    s ^= 1;
  }
}

// Signal samples a K5b block stages: its 128 columns' windows, padded to a
// whole float4 so the dB tile after them stays 16-byte aligned.
constexpr int kRcSamples = (kP2Tile + kWl - 1 + 3) / 4 * 4;

// K5b: the PSD of a 128-column tile recomputed from the signal (K4a's
// psd_value chain on the same operator rows and samples), then K3's dB and
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

template <int kTile, typename DbT, typename OutT>
int launch_db_rescale_tile(const float* p, const float* gmax, const int* i0,
                           const float* w0, const float* w1, int nb_pad,
                           int t_pad, int num_bins, void* db, void* out,
                           float ln10_inv_20, float db_floor, float int8_lo,
                           float int8_scale, int smem, cudaStream_t stream) {
  auto kernel = db_rescale_kernel<kTile, DbT, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kP3Threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = t_pad / kTile;
  int blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > tiles) blocks = tiles;
  kernel<<<blocks, kP3Threads, smem, stream>>>(
      p, gmax, i0, w0, w1, nb_pad, t_pad, num_bins,
      reinterpret_cast<DbT*>(db), reinterpret_cast<OutT*>(out), ln10_inv_20,
      db_floor, int8_lo, int8_scale);
  return (int)cudaGetLastError();
}

// The widest tile whose two buffers and tables fit a block's shared memory.
template <typename DbT, typename OutT>
int launch_db_rescale(const float* p, const float* gmax, const int* i0,
                      const float* w0, const float* w1, int nb_pad, int t_pad,
                      int num_bins, void* db, void* out, float ln10_inv_20,
                      float db_floor, float int8_lo, float int8_scale,
                      cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int tables = num_bins * 12;
  const int smem128 = 2 * nb_pad * 128 * 4 + tables;
  if (smem128 <= optin && t_pad % 128 == 0) {
    return launch_db_rescale_tile<128, DbT, OutT>(
        p, gmax, i0, w0, w1, nb_pad, t_pad, num_bins, db, out, ln10_inv_20,
        db_floor, int8_lo, int8_scale, smem128, stream);
  }
  return launch_db_rescale_tile<64, DbT, OutT>(
      p, gmax, i0, w0, w1, nb_pad, t_pad, num_bins, db, out, ln10_inv_20,
      db_floor, int8_lo, int8_scale, 2 * nb_pad * 64 * 4 + tables, stream);
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

// p [nb_pad, t_pad] f32; gmax: one f32 on the device; i0/w0/w1 [num_bins];
// db [nb_pad, t_pad] (db_dtype 0 = f32, 1 = bf16); out [num_bins, t_pad]
// (out_dtype 0 = f32, 1 = bf16, 2 = int8). t_pad must be a multiple of 64.
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

// K5b. sig, a2, nv as psd_phase1_tiled_launch; gmax, i0/w0/w1, out,
// out_dtype as db_rescale_launch; db [nb_pad, t_pad] f32. t_pad must be a
// multiple of 128.
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
