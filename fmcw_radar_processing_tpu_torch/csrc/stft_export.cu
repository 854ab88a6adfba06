// K3 and K5b — phase 2 of the fused spectrogram export (PSD → dB → 1024
// log-frequency bins) of a packed |slow-time| signal, hop 1, for
// nb_pad ≤ 272 (the untiled kernels; stft_export_tiled.cu takes larger
// nb_pad). Phase 1 is K2a (stft_psd_b3.cu, bf16x3 on the tensor cores) or,
// exact, K4a's kernel (stft_export_tiled.cu), which K2b and K5a launch:
// one kernel for the exact PSD at every nb_pad. K3 and K5b are one kernel,
// K5b its recompute flag.
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
// tile, twice the run of 64-column tiles.
//
// K5b db_rescale_recompute replaces ops/stft_pallas.py::
// _db_rescale_recompute_kernel, the second kernel of the recompute pair
// (the first, K5a, is K4a's kernel without its store): the [nb_pad, t_pad]
// PSD is never stored, so K5b trades K3's PSD read (0.57 GB at 65,536
// frames, nb_pad 136) for 2·nb_pad·20 FMAs a column (11 GFLOP there, 0.17
// ms of the 67 TFLOP/s float32 peak, under the 0.81 ms its bytes take: the
// 570 MB float32 dB map, the 2,147 MB bf16 intensity, 4 MB of samples). It
// is K3's kernel with the PSD load swapped for its computation: the same
// persistent grid and 128-column tiles (one float32 dB tile, the folded
// operator [2·nb_pad, 20] and the tables fit at every nb_pad up to 272: 105
// KB at 136, two blocks an SM; 196 KB at 272), the operator (22-44 KB) and
// i0/w0/w1 staged once per block, and per tile the next tile's 148 window
// samples brought in by cp.async while the current tile is computed and
// emitted. A thread computes its 8 columns of a bin row at once with
// psd_group<8>, the chain K4a computes every column with (its 27 samples
// in registers for all its bins), takes K3's dB in place and stores the dB
// map 8 columns at a time; the emission is K3's. Same operands, same
// arithmetic (export_common.cuh): db and intensity are bit-equal to
// K2b → K3's.
//
// The arithmetic is psd_to_db, fmaf(w1, db[i + 1], w0 · db[i]) and the
// emission rounding of export_common.cuh. Rounding: bf16 emission is
// round-to-nearest-even (__float2bfloat16_rn); int8 emission uses rintf
// (half to even, like jnp.round). Built without --use_fast_math:
// flush-to-zero would change the 1e-45 floor logic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "export_common.cuh"

namespace {

constexpr int kWl = kStftTaps;      // STFT window length
constexpr int kP3Threads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}

// The operands of K3 and K5b: K3 reads the PSD p; K5b sig, a2 and nv.
struct Phase2Args {
  const float* p;
  const float* sig;
  const float* a2;
  int sig_len, nv;
  const float* gmax;
  const int* i0;
  const float* w0;
  const float* w1;
  int nb_pad, t_pad, num_bins;
  void* db;
  void* out;
  float ln10_inv_20, db_floor, int8_lo, int8_scale;
};

// Shared memory of a block: K3 two dB tiles, K5b one plus the folded
// operator and two tiles' samples; then the tables i0/w0/w1.
template <bool kRecompute>
int smem_bytes(int tile, int nb_pad, int num_bins) {
  const int floats = kRecompute
      ? nb_pad * tile + 2 * nb_pad * kWl + 2 * round4(tile + kWl - 1)
      : 2 * nb_pad * tile;
  return floats * 4 + num_bins * 12;
}

// kTile columns per tile: 128, or 64 where a block's shared memory would
// not hold K3's two 128-column tiles (above nb_pad 208). kRecompute = true
// is K5b (db float32, always 128 columns).
template <int kTile, typename DbT, typename OutT, bool kRecompute>
__global__ void __launch_bounds__(kP3Threads)
db_rescale_kernel(const Phase2Args a) {
  constexpr int kChunks = kTile / 4;             // float4 chunks per row
  constexpr int kRowThreads = kTile / 8;         // threads per output row
  constexpr int kRowStep = kP3Threads / kRowThreads;
  // The window samples K5b stages per tile: kTile + 19, whole float4s.
  constexpr int kSamples = round4(kTile + kWl - 1);
  static_assert(!kRecompute || sizeof(DbT) == 4, "K5b stores a float32 dB map");
  extern __shared__ float4 smem4[];
  const int nb_pad = a.nb_pad, t_pad = a.t_pad, num_bins = a.num_bins;
  // K3: 2 × [nb_pad][kTile] dB tiles; K5b: one, then the operator
  // [2·nb_pad][kWl] and 2 × [kSamples] samples.
  float* bufs = reinterpret_cast<float*>(smem4);
  const float4* ops4 =
      reinterpret_cast<const float4*>(bufs + nb_pad * kTile);
  float* xs = bufs + nb_pad * kTile + 2 * nb_pad * kWl;
  int* s_i0 = reinterpret_cast<int*>(
      bufs + (kRecompute ? nb_pad * kTile + 2 * nb_pad * kWl + 2 * kSamples
                         : 2 * nb_pad * kTile));
  float* s_w0 = reinterpret_cast<float*>(s_i0 + num_bins);
  float* s_w1 = s_w0 + num_bins;
  DbT* const db = reinterpret_cast<DbT*>(a.db);
  OutT* const out = reinterpret_cast<OutT*>(a.out);
  const int tid = threadIdx.x;
  const int tiles = t_pad / kTile;
  const float g = *a.gmax;
  const float safe = g > 0.f ? g : 1.f;

  // K3: the tile's PSD [nb_pad, kTile] into dB buffer s; K5b: its window
  // samples into sample buffer s (zeros past the signal).
  auto load_tile = [&](int s, int tile) {
    if constexpr (kRecompute) {
      const int s0 = tile * kTile;
      for (int i = tid; i < kSamples / 4; i += kP3Threads) {
        const int left = a.sig_len - (s0 + 4 * i);
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
        cp_async16(xs + s * kSamples + 4 * i, bytes ? a.sig + s0 + 4 * i : a.sig,
                   bytes);
      }
    } else {
      float* buf = bufs + s * nb_pad * kTile;
      const float* src = a.p + (size_t)tile * kTile;
      for (int i = tid; i < nb_pad * kChunks; i += kP3Threads) {
        const int b = i / kChunks;
        const int c = i % kChunks;
        cp_async16(buf + b * kTile + tile_chunk(c) * 4,
                   src + (size_t)b * t_pad + c * 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int tile = blockIdx.x;
  if (tile < tiles) load_tile(0, tile);
  if constexpr (kRecompute) {  // the folded operator, once: 80-byte rows
    float4* dst = reinterpret_cast<float4*>(bufs + nb_pad * kTile);
    const float4* src = reinterpret_cast<const float4*>(a.a2);
    for (int i = tid; i < 2 * nb_pad * kWl / 4; i += kP3Threads) dst[i] = src[i];
  }
  for (int o = tid; o < num_bins; o += kP3Threads) {
    s_i0[o] = a.i0[o];
    s_w0[o] = a.w0[o];
    s_w1[o] = a.w1[o];
  }
  const int lc = tid % kRowThreads;  // this thread's 8 columns: 8·lc ..
  const int row0 = tid / kRowThreads;
  int s = 0;
  for (; tile < tiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the tile is in; the other buffer is free
    const int next = tile + gridDim.x;
    if (next < tiles) load_tile(s ^ 1, next);
    float* buf = bufs + (kRecompute ? 0 : s * nb_pad * kTile);
    const size_t t0 = (size_t)tile * kTile;

    // The PSD (K3 loaded, K5b computed) → float32 dB in place, stored 8
    // columns at a time.
    float x[8 + kWl - 1];
    if constexpr (kRecompute) load_window(xs + s * kSamples, 8 * lc, x);
    for (int b = row0; b < nb_pad; b += kRowStep) {
      float4* r = reinterpret_cast<float4*>(buf + b * kTile);
      float v[8];
      if constexpr (kRecompute) {
        psd_group<8>(x, ops4 + b * (kWl / 4), ops4 + (nb_pad + b) * (kWl / 4),
                     (int)t0 + 8 * lc, a.nv, v);
      } else {
        const float4 p0 = r[tile_chunk(2 * lc)];
        const float4 p1 = r[tile_chunk(2 * lc + 1)];
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = pv[q];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = psd_to_db(v[q], safe, a.ln10_inv_20, a.db_floor);
      }
      r[tile_chunk(2 * lc)] = make_float4(v[0], v[1], v[2], v[3]);
      r[tile_chunk(2 * lc + 1)] = make_float4(v[4], v[5], v[6], v[7]);
      emit8(db + (size_t)b * t_pad + t0 + 8 * lc, v, 0.f, 0.f);
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
      emit8(out + (size_t)o * t_pad + t0 + 8 * lc, v, a.int8_lo, a.int8_scale);
    }
    s ^= 1;
  }
}

template <int kTile, typename DbT, typename OutT, bool kRecompute>
int launch_tile(const Phase2Args& a, int smem, cudaStream_t stream) {
  auto kernel = db_rescale_kernel<kTile, DbT, OutT, kRecompute>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kP3Threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = a.t_pad / kTile;
  int blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > tiles) blocks = tiles;
  kernel<<<blocks, kP3Threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// K3: the widest tile whose buffers and tables fit a block's shared memory.
// K5b: 128 columns, which fit at every nb_pad up to 272 (196 KB there).
template <typename DbT, typename OutT, bool kRecompute>
int launch_db_rescale(const Phase2Args& a, cudaStream_t stream) {
  const int smem128 = smem_bytes<kRecompute>(128, a.nb_pad, a.num_bins);
  if constexpr (kRecompute) {
    return launch_tile<128, DbT, OutT, true>(a, smem128, stream);
  } else {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem128 <= optin && a.t_pad % 128 == 0) {
      return launch_tile<128, DbT, OutT, false>(a, smem128, stream);
    }
    return launch_tile<64, DbT, OutT, false>(
        a, smem_bytes<false>(64, a.nb_pad, a.num_bins), stream);
  }
}

template <typename DbT, bool kRecompute>
int dispatch_out(int out_dtype, const Phase2Args& a, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch_db_rescale<DbT, float, kRecompute>(a, stream);
    case 1:
      return launch_db_rescale<DbT, __nv_bfloat16, kRecompute>(a, stream);
    case 2:
      return launch_db_rescale<DbT, int8_t, kRecompute>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  const Phase2Args a{p,  nullptr, nullptr, 0,      0,   gmax,
                     i0, w0,      w1,      nb_pad, t_pad, num_bins,
                     db, out,     ln10_inv_20, db_floor, int8_lo, int8_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (db_dtype) {
    case 0:
      return dispatch_out<float, false>(out_dtype, a, s);
    case 1:
      return dispatch_out<__nv_bfloat16, false>(out_dtype, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5b. sig [sig_len] and a2 [2·nb_pad, 20] f32 (16-byte aligned), nv the
// valid column count, as psd_phase1_tiled_launch; gmax, i0/w0/w1, out,
// out_dtype as db_rescale_launch; db [nb_pad, t_pad] f32. t_pad must be a
// multiple of 128.
extern "C" int db_rescale_recompute_launch(
    const float* sig, int sig_len, const float* a2, int nb_pad, int nv,
    const float* gmax, const int* i0, const float* w0, const float* w1,
    int t_pad, int num_bins, float* db, void* out, int out_dtype,
    float ln10_inv_20, float db_floor, float int8_lo, float int8_scale,
    void* stream) {
  const Phase2Args a{nullptr, sig, a2, sig_len, nv, gmax, i0, w0, w1, nb_pad,
                     t_pad,   num_bins, db, out, ln10_inv_20, db_floor,
                     int8_lo, int8_scale};
  return dispatch_out<float, true>(out_dtype, a, (cudaStream_t)stream);
}
