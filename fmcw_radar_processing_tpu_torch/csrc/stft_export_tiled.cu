// K4a, K4b and their recompute pair — the bin-blocked spectrogram export
// for any nfft: what the fidelity profile (nfft = 2^nextpow2(L)) runs once
// the untiled K3 no longer fits (nb_pad > 272, nfft > 512). K4a's kernel is
// also the exact phase 1 below that: K2b (psd_phase1) and K5a (psd_tmax)
// launch it and reduce its maxima to one per 1024 columns (at nb_pad 136
// and 144 it took 0.29-0.30 ms where K2's own kernel took 0.45, by
// tools/time_psd_phase1.py on an H100). kRound is the bf16 PSD store.
//
// K4a psd_phase1_tiled replaces ops/stft_pallas.py::_psd_kernel_tiled:
//
//     p[b, t] = (Σ_w A2[b, w]·sig[t + w])² + (Σ_w A2[nb_pad + b, w]·sig[t + w])²
//     p = 0 at columns t ≥ nv;   tmax[k, i] = max of the stored p of
//     1024-column tile i and 128-bin block k (reduced on the device after)
//
// Bound on an H100: the PSD write (nb_pad·t_pad·4 bytes, 0.54 GB at nfft
// 16,384 and 16,384 columns: 0.16 ms) and, as long, the float32 FMAs (40 a
// value, 5.4e9 there: 0.16 ms at 128 a clock on 132 SMs). The FMAs are the
// wall: without its store the kernel takes about as long, so the design
// spends as few other instructions per FMA as it can. The grid is
// 1024-column tiles × 128-bin blocks; a block stages its [2·128, 20]
// operator slice and 1044 samples in shared memory. Each of its 128
// threads owns 8 adjacent columns, whose windows share all but 7 of their
// 27 samples (kept in registers), and computes them together
// (psd_values<8>): each operator float4, a broadcast load, feeds 32 FMAs,
// and a row's 8 values leave as two 16-byte streaming stores (a warp
// writes 1 KB contiguous). A group of columns wholly past nv computes
// nothing.
//
// K4b db_rescale_tiled replaces ops/stft_pallas.py::_db_rescale_kernel_tiled:
//
//     db = K3's dB (export_common.cuh);  out[o, t] = w0[o]·db[i0[o], t]
//                                                   + w1[o]·db[i0[o] + 1, t]
//
// The TPU accumulated a dense bf16x3 contraction over bin blocks in VMEM;
// here the interpolation is the exact float32 gather-and-lerp over the two
// nonzeros of each row. Bound: bytes — the PSD read, the dB store and the
// [1024, t_pad] intensity store (1.14 GB at nfft 16,384 and 16,384 columns,
// float32: 0.34 ms), nearly all of it the elementwise PSD → dB stream. Each
// output row needs rows i0 and i0 + 1 of one bin block and its halo row
// (the next block's first), so the work splits into independent items
// (64-column tile, 128-bin block); the rows of block k are the contiguous
// range [o_start[k], o_start[k + 1]) since i0 is nondecreasing. One block
// takes one item, bin block major, so the heavy first block (at nb 8,193
// it owns 551 of the 1,024 output rows) launches first. Its 256 threads
// each own one 16-byte chunk of the tile's rows: they issue their PSD
// loads three rows at a time (streaming, straight into registers), turn
// them into dB, store the block's own rows (16-byte streaming stores) and
// keep all 129 in a swizzled shared-memory slab (33 KB, tile_chunk), from
// which the output rows are interpolated, 8 columns a thread. Four blocks
// fit on an SM: their loads stay in flight while the others convert and
// emit, which is what hides the memory latency here (no staging buffer).
//
// The recompute pair, for 272 < nb_pad ≤ 512 (past K5's shared memory),
// replaces ops/stft_pallas.py::_tmax_kernel and
// ::_db_rescale_recompute_kernel there: psd_tmax_tiled is K4a without the
// PSD store, and db_rescale_recompute_tiled is K4b with each row chunk
// computed from the signal windows by K4a's arithmetic (psd_values, 4
// columns a thread) instead of loaded. A block of it takes 8 consecutive
// column tiles of one bin block, so it stages the block's 129 operator row
// pairs once for them, and each tile's 84 samples. The same kernels with
// template flags, so db and intensity are bit-equal to K4a → K4b's.
//
// Offsets into [nb_pad, t_pad] arrays are 64-bit: at nfft 65,536 and
// 65,536 columns nb_pad·t_pad is 2.15e9 > 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "export_common.cuh"

namespace {

constexpr int kWl = kStftTaps;              // STFT window length
constexpr int kKb = 128;                    // bins per bin block
constexpr int kAThreads = 128;
constexpr int kACols = 8;                   // adjacent columns per thread
constexpr int kATile = kAThreads * kACols;  // 1024 columns per K4a block

constexpr int kASamples = round4(kATile + kWl);  // a K4a block's samples
constexpr int kBThreads = 256;
constexpr int kBTile = 64;                  // columns per K4b work item
constexpr int kBChunks = kBTile / 4;        // a row's 16-byte chunks
constexpr int kBRows = kKb + 1;             // a bin block and its halo row
constexpr int kBRowsPerPass = kBThreads / kBChunks;  // rows a pass covers
constexpr int kBPasses = (kBRows + kBRowsPerPass - 1) / kBRowsPerPass;
constexpr int kBWave = 3;                   // PSD loads a thread keeps in flight
constexpr int kRcCols = 4;                  // recompute: columns a thread
constexpr int kRcTiles = 8;                 // recompute: column tiles a block
constexpr int kBSamples = round4(kBTile + kWl);  // a recompute tile's samples

// kStore = true is K4a; false is psd_tmax_tiled (tmax only, p untouched).
// kRound: every value rounded to bf16 (round to nearest even) before the
// max and the store, the bf16 PSD store's values in a float32 array.
template <bool kStore, bool kRound>
__global__ void __launch_bounds__(kAThreads, 4)
psd_tiled_kernel(const float* __restrict__ sig, int sig_len,
                 const float* __restrict__ a2, int nb_pad,
                 float* __restrict__ p, float* __restrict__ tmax, int t_pad,
                 int nv) {
  __shared__ float4 ops4[2 * kKb * kWl / 4];  // re rows [kKb][kWl], im rows
  __shared__ float4 xs4[kASamples / 4];
  __shared__ float warp_max[kAThreads / 32];
  float* xs = reinterpret_cast<float*>(xs4);
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
  for (int i = tid; i < kASamples; i += kAThreads) {
    const int s = t0 + i;
    xs[i] = s < sig_len ? sig[s] : 0.f;
  }
  __syncthreads();

  const int lt = kACols * tid;
  const int t = t0 + lt;
  float4* dst = reinterpret_cast<float4*>(p + (size_t)r0 * t_pad + t);
  const size_t row4 = (size_t)t_pad / 4;
  float mx = 0.f;
  if (t < nv) {
    float x[kACols + kWl - 1];
    load_window(xs, lt, x);
    for (int b = 0; b < rows; ++b) {
      float pv[kACols];
      psd_group<kACols>(x, &ops4[b * kWl / 4], &ops4[(kKb + b) * kWl / 4], t,
                        nv, pv);
#pragma unroll
      for (int c = 0; c < kACols; ++c) {
        if (kRound) pv[c] = __bfloat162float(__float2bfloat16_rn(pv[c]));
        mx = fmaxf(mx, pv[c]);
      }
      if (kStore) {
        __stcs(dst + b * row4, make_float4(pv[0], pv[1], pv[2], pv[3]));
        __stcs(dst + b * row4 + 1, make_float4(pv[4], pv[5], pv[6], pv[7]));
      }
    }
  } else if (kStore) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < rows; ++b) {
      __stcs(dst + b * row4, zero);
      __stcs(dst + b * row4 + 1, zero);
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

// The operands of K4b and of the recompute's second kernel: K4b reads the
// PSD p, the recompute sig, a2 and nv instead.
struct Phase2Args {
  const float* p;
  const float* sig;
  const float* a2;
  int sig_len, nv;
  const float* gmax;
  const int* i0;
  const float* w0;
  const float* w1;
  const int* o_start;
  int nb_pad, t_pad;
  void* db;
  void* out;
  float ln10_inv_20, db_floor, int8_lo, int8_scale;
};

// Four dB values of one row chunk in the dB store dtype, as one streaming
// store (16 bytes in float32, 8 in bf16, rounded as emit rounds).
__device__ __forceinline__ void store4(float* dst, float4 v) {
  __stcs(reinterpret_cast<float4*>(dst), v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x),
                                               __float2bfloat16_rn(v.y));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z),
                                               __float2bfloat16_rn(v.w));
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(dst), u);
}

// Shared memory of the phase-2 kernel in floats: the dB slab, then the
// recompute's operator rows [2][kBRows][kWl] and samples.
template <bool kRecompute>
constexpr int phase2_smem_floats() {
  return kBRows * kBTile + (kRecompute ? 2 * kBRows * kWl + kBSamples : 0);
}

// kRecompute = false is K4b (one item a block); true is
// db_rescale_recompute_tiled (kRcTiles items of one bin block, db float32).
template <bool kRecompute, typename DbT, typename OutT>
__global__ void __launch_bounds__(kBThreads, 4)
db_rescale_tiled_kernel(const Phase2Args a) {
  constexpr int kTiles = kRecompute ? kRcTiles : 1;
  constexpr int kRowThreads = kBTile / 8;  // threads per output row
  constexpr int kRowStep = kBThreads / kRowThreads;
  extern __shared__ float4 smem4[];
  float4* dbs4 = smem4;                            // [kBRows][kBChunks]
  float4* ops4 = smem4 + kBRows * kBChunks;        // recompute only
  float* xs = reinterpret_cast<float*>(ops4 + 2 * kBRows * kWl / 4);
  const int tid = threadIdx.x;
  const int tiles = a.t_pad / kBTile;
  const int groups = (tiles + kTiles - 1) / kTiles;
  const int k = blockIdx.x / groups;  // bin block major
  const int tile0 = blockIdx.x % groups * kTiles;
  const int tile_end = min(tiles, tile0 + kTiles);
  const int r0 = k * kKb;
  const int own = min(kKb, a.nb_pad - r0);
  // The halo row r0 + own exists except after the last block, where no
  // output row needs it (i0 + 1 ≤ nb − 1 < nb_pad).
  const int rows = min(own + 1, a.nb_pad - r0);
  const float g = *a.gmax;
  const float safe = g > 0.f ? g : 1.f;
  DbT* db = reinterpret_cast<DbT*>(a.db);
  OutT* out = reinterpret_cast<OutT*>(a.out);
  const int c = tid % kBChunks;   // this thread's chunk: columns 4c .. 4c + 3
  const int rb = tid / kBChunks;  // and rows rb, rb + kBRowsPerPass, ...
  const int pc = tile_chunk(c);
  const int lc = tid % kRowThreads;  // emission: columns 8·lc .. 8·lc + 7
  const int row0 = tid / kRowThreads;
  const int c0 = tile_chunk(2 * lc);
  const int c1 = tile_chunk(2 * lc + 1);
  const size_t row4 = (size_t)a.t_pad / 4;

  if constexpr (kRecompute) {  // the block's operator rows, once
    const float4* are =
        reinterpret_cast<const float4*>(a.a2 + (size_t)r0 * kWl);
    const float4* aim =
        reinterpret_cast<const float4*>(a.a2 + (size_t)(a.nb_pad + r0) * kWl);
    for (int i = tid; i < rows * kWl / 4; i += kBThreads) {
      ops4[i] = are[i];
      ops4[kBRows * kWl / 4 + i] = aim[i];
    }
  }
  for (int tile = tile0; tile < tile_end; ++tile) {
    const size_t t0 = (size_t)tile * kBTile;
    __syncthreads();  // the previous tile is done with dbs4 and xs
    float x[kRcCols + kWl - 1];  // the recompute's window samples
    const float4* src = nullptr;   // K4b's PSD chunks
    DbT* dst = db + (size_t)r0 * a.t_pad + t0 + 4 * c;
    if constexpr (kRecompute) {
      for (int i = tid; i < kBSamples; i += kBThreads) {
        const size_t s = t0 + i;
        xs[i] = s < (size_t)a.sig_len ? a.sig[s] : 0.f;
      }
      __syncthreads();
      load_window(xs, kRcCols * c, x);
    } else {
      src = reinterpret_cast<const float4*>(a.p + (size_t)r0 * a.t_pad + t0)
            + c;
    }
    // PSD → float32 dB, into the slab; the block's own rows stored.
#pragma unroll 1  // one wave's registers at a time: no spills
    for (int j0 = 0; j0 < kBPasses; j0 += kBWave) {
      float4 v[kBWave];
      if constexpr (!kRecompute) {
#pragma unroll
        for (int j = 0; j < kBWave; ++j) {
          const int b = rb + (j0 + j) * kBRowsPerPass;
          if (j0 + j < kBPasses && b < rows) v[j] = __ldcs(src + b * row4);
        }
      }
#pragma unroll
      for (int j = 0; j < kBWave; ++j) {
        const int b = rb + (j0 + j) * kBRowsPerPass;
        if (j0 + j >= kBPasses || b >= rows) continue;
        if constexpr (kRecompute) {
          float pv[kRcCols];
          psd_group<kRcCols>(x, &ops4[b * kWl / 4],
                             &ops4[(kBRows + b) * kWl / 4],
                             (int)t0 + kRcCols * c, a.nv, pv);
          v[j] = make_float4(pv[0], pv[1], pv[2], pv[3]);
        }
        const float4 d =
            make_float4(psd_to_db(v[j].x, safe, a.ln10_inv_20, a.db_floor),
                        psd_to_db(v[j].y, safe, a.ln10_inv_20, a.db_floor),
                        psd_to_db(v[j].z, safe, a.ln10_inv_20, a.db_floor),
                        psd_to_db(v[j].w, safe, a.ln10_inv_20, a.db_floor));
        dbs4[b * kBChunks + pc] = d;
        if (b < own) store4(dst + (size_t)b * a.t_pad, d);
      }
    }
    __syncthreads();

    // The output rows whose i0 falls in this bin block, kRowStep at a time.
    const int o_end = __ldg(&a.o_start[k + 1]);
    for (int o = __ldg(&a.o_start[k]) + row0; o < o_end; o += kRowStep) {
      const int i = __ldg(&a.i0[o]) - r0;
      const float a0 = __ldg(&a.w0[o]);
      const float a1 = __ldg(&a.w1[o]);
      const float4* lo = dbs4 + i * kBChunks;
      const float4* hi = lo + kBChunks;
      const float4 x0 = lo[c0], x1 = lo[c1], y0 = hi[c0], y1 = hi[c1];
      const float v[8] = {
          fmaf(a1, y0.x, a0 * x0.x), fmaf(a1, y0.y, a0 * x0.y),
          fmaf(a1, y0.z, a0 * x0.z), fmaf(a1, y0.w, a0 * x0.w),
          fmaf(a1, y1.x, a0 * x1.x), fmaf(a1, y1.y, a0 * x1.y),
          fmaf(a1, y1.z, a0 * x1.z), fmaf(a1, y1.w, a0 * x1.w)};
      emit8(out + (size_t)o * a.t_pad + t0 + 8 * lc, v, a.int8_lo,
            a.int8_scale);
    }
  }
}

template <bool kStore, bool kRound>
int launch_psd_tiled(const float* sig, int sig_len, const float* a2,
                     int nb_pad, float* p, float* tmax, int t_pad, int nv,
                     cudaStream_t stream) {
  const dim3 grid(t_pad / kATile, (nb_pad + kKb - 1) / kKb);
  psd_tiled_kernel<kStore, kRound><<<grid, kAThreads, 0, stream>>>(
      sig, sig_len, a2, nb_pad, p, tmax, t_pad, nv);
  return (int)cudaGetLastError();
}

template <bool kRecompute, typename DbT, typename OutT>
int launch_phase2(const Phase2Args& a, cudaStream_t stream) {
  auto kernel = db_rescale_tiled_kernel<kRecompute, DbT, OutT>;
  constexpr int smem = phase2_smem_floats<kRecompute>() * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = a.t_pad / kBTile;
  const int tiles_per_block = kRecompute ? kRcTiles : 1;
  const int groups = (tiles + tiles_per_block - 1) / tiles_per_block;
  kernel<<<groups * ((a.nb_pad + kKb - 1) / kKb), kBThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kRecompute, typename DbT>
int dispatch_phase2_out(int out_dtype, const Phase2Args& a,
                        cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch_phase2<kRecompute, DbT, float>(a, stream);
    case 1:
      return launch_phase2<kRecompute, DbT, __nv_bfloat16>(a, stream);
    case 2:
      return launch_phase2<kRecompute, DbT, int8_t>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sig [sig_len] f32; a2 [2·nb_pad, 20] f32; p [nb_pad, t_pad] f32;
// tmax [ceil(nb_pad / 128) · t_pad / 1024] f32, bin block major.
// t_pad must be a multiple of 1024; round_bf16 != 0 rounds every value to
// bf16.
extern "C" int psd_phase1_tiled_launch(const float* sig, int sig_len,
                                       const float* a2, int nb_pad, float* p,
                                       float* tmax, int t_pad, int nv,
                                       int round_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return round_bf16
      ? launch_psd_tiled<true, true>(sig, sig_len, a2, nb_pad, p, tmax, t_pad,
                                     nv, s)
      : launch_psd_tiled<true, false>(sig, sig_len, a2, nb_pad, p, tmax,
                                      t_pad, nv, s);
}

// psd_tmax_tiled: psd_phase1_tiled_launch's tmax without the PSD store.
extern "C" int psd_tmax_tiled_launch(const float* sig, int sig_len,
                                     const float* a2, int nb_pad, float* tmax,
                                     int t_pad, int nv, void* stream) {
  return launch_psd_tiled<false, false>(sig, sig_len, a2, nb_pad, nullptr,
                                        tmax, t_pad, nv, (cudaStream_t)stream);
}

// p [nb_pad, t_pad] f32; gmax: one f32 on the device; i0/w0/w1 [num_bins];
// o_start [ceil(nb_pad / 128) + 1] int32, o_start[last] = num_bins;
// db [nb_pad, t_pad] (db_dtype 0 = f32, 1 = bf16); out [num_bins, t_pad]
// (out_dtype 0 = f32, 1 = bf16, 2 = int8). t_pad must be a multiple of 64.
extern "C" int db_rescale_tiled_launch(const float* p, const float* gmax,
                                       const int* i0, const float* w0,
                                       const float* w1, const int* o_start,
                                       int nb_pad, int t_pad, void* db,
                                       int db_dtype, void* out, int out_dtype,
                                       float ln10_inv_20, float db_floor,
                                       float int8_lo, float int8_scale,
                                       void* stream) {
  const Phase2Args a{p,      nullptr, nullptr, 0,      0,
                     gmax,   i0,      w0,      w1,     o_start,
                     nb_pad, t_pad,   db,      out,    ln10_inv_20,
                     db_floor, int8_lo, int8_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (db_dtype) {
    case 0:
      return dispatch_phase2_out<false, float>(out_dtype, a, s);
    case 1:
      return dispatch_phase2_out<false, __nv_bfloat16>(out_dtype, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// db_rescale_recompute_tiled. sig, a2, nv as psd_phase1_tiled_launch; the
// rest as db_rescale_tiled_launch, with db [nb_pad, t_pad] f32 only.
extern "C" int db_rescale_recompute_tiled_launch(
    const float* sig, int sig_len, const float* a2, int nb_pad, int nv,
    const float* gmax, const int* i0, const float* w0, const float* w1,
    const int* o_start, int t_pad, float* db, void* out, int out_dtype,
    float ln10_inv_20, float db_floor, float int8_lo, float int8_scale,
    void* stream) {
  const Phase2Args a{nullptr, sig,     a2,      sig_len, nv,
                     gmax,    i0,      w0,      w1,      o_start,
                     nb_pad,  t_pad,   db,      out,     ln10_inv_20,
                     db_floor, int8_lo, int8_scale};
  return dispatch_phase2_out<true, float>(out_dtype, a,
                                          (cudaStream_t)stream);
}
