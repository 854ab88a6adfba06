// K1 and K6 — fused fast-time range DFT + magnitude + max over chirps.
//
// K1 replaces the Pallas kernels ops/fast_time_pallas.py::_profile_kernel_b3
// (production, bf16x3) and ::_profile_kernel (fidelity, HIGHEST) of the JAX
// package. Computes, for flat pair rows x [F·PN, 2·NTS] (interleaved re, im
// samples) and the BLOCKED packed weight W [2·NTS, 2·K] (columns [0, K)
// give the real part of each bin, [K, 2K) the imaginary part):
//
//     y = x·W − off;   prof[f, k] = max over the PN chirps of frame f of
//                                   sqrt(y[r, k]² + y[r, K + k]²)
//
// K1 writes only prof [F, K]; the range-FFT values live in registers.
//
// K6 replaces ops/fast_time_pallas.py::_kernel (fast_time_pallas, the
// materializing stage of impl "pallas"): the same kernel, instantiated to
// store the range FFT as well, rf [F·PN, K, 2] with (re, im) interleaved —
// the layout the frame chain's Doppler gather reads. Its profile comes from
// the same registers as K1's, so the two are bit-equal. Each thread stores
// per row four bins × (re, im): 32 contiguous bytes, two 16-byte stores.
// The store adds 2 GiB at 65,536 frames (F·PN·K·8 bytes, about 0.7 ms of
// HBM time if it overlaps the arithmetic); its offsets are 64-bit, since
// F·PN·K·2 passes 2^31 at 262,144 frames.
//
// What bounds it on an H100: arithmetic. The product is 2·F·PN·128·512
// flops (137 GFLOP at 65,536 frames) against 512 MiB of input, about 256
// flop per byte — far above the ~20 flop/byte where float32 CUDA cores stop
// being memory-bound. Exact float32 FMAs on CUDA cores meet both precision
// classes of the TPU kernels (tighter than bf16x3); tensor cores (3xTF32 or
// a bf16x3 split on wgmma) are later work.
//
// Design: a block owns a 64-bin slice of W (64 real + 64 imaginary columns,
// 64 KiB, held in shared memory for the block's whole life) and walks over
// 64-row tiles of x (four frames of 16 chirps). Each thread accumulates a
// 4-row × 4-bin register tile of both parts (32 FMAs per three 16-byte
// shared loads). The four threads holding one frame's 16 rows are
// neighbouring lanes, so the max over chirps is two warp shuffles; one lane
// in four writes four bins with one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPn = 16;          // chirps per frame
constexpr int kIn = 128;         // 2·NTS interleaved samples per row
constexpr int kRows = 64;        // rows per tile: four frames
constexpr int kBins = 64;        // bins per block slice
constexpr int kThreads = 256;
constexpr int kXStride = kRows + 4;  // padded row of the transposed x tile
constexpr int kSmemBytes = (kIn * 2 * kBins + kIn * kXStride) * 4;

// kStoreRf = false is K1; true is K6 (rf [rows, k, 2] stored too).
template <bool kStoreRf>
__global__ void __launch_bounds__(kThreads, 2)
profile_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ off, float* __restrict__ prof,
               float* __restrict__ rf, int rows, int k, int row_tiles) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [kIn][2·kBins]
  float* xs = ws + kIn * 2 * kBins;             // [kIn][kXStride], x transposed
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBins;

  // W slice, loaded once: ws[j][c] = W[j][k0 + c] (real), W[j][K + k0 + c - 64].
  for (int i = tid; i < kIn * (2 * kBins / 4); i += kThreads) {
    const int j = i / (2 * kBins / 4);
    const int c4 = (i % (2 * kBins / 4)) * 4;
    const int col = c4 < kBins ? k0 + c4 : k + k0 + (c4 - kBins);
    *reinterpret_cast<float4*>(&ws[j * 2 * kBins + c4]) =
        *reinterpret_cast<const float4*>(&w[(size_t)j * 2 * k + col]);
  }

  // Lane layout: tid = tx·16 + ty. ty (0..15) picks rows ty·4 .. ty·4+3, so
  // frame ty/4 sits on four neighbouring lanes; tx (0..15) picks bins tx·4..+3.
  const int tx = tid >> 4;
  const int ty = tid & 15;
  float off_re[4], off_im[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    off_re[c] = off[k0 + tx * 4 + c];
    off_im[c] = off[k + k0 + tx * 4 + c];
  }

  for (int tile = blockIdx.y; tile < row_tiles; tile += gridDim.y) {
    const int r0 = tile * kRows;
    __syncthreads();  // ws is ready; the previous tile's readers are done
    // Transposed x tile: xs[j][r] = x[r0 + r][j]; consecutive lanes take
    // consecutive rows, so the scalar shared stores are conflict-free.
    for (int i = tid; i < kRows * (kIn / 4); i += kThreads) {
      const int r = i % kRows;
      const int j4 = (i / kRows) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows) {
        v = *reinterpret_cast<const float4*>(&x[(size_t)(r0 + r) * kIn + j4]);
      }
      xs[(j4 + 0) * kXStride + r] = v.x;
      xs[(j4 + 1) * kXStride + r] = v.y;
      xs[(j4 + 2) * kXStride + r] = v.z;
      xs[(j4 + 3) * kXStride + r] = v.w;
    }
    __syncthreads();

    float acc_re[4][4], acc_im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_re[i][c] = 0.f;
        acc_im[i][c] = 0.f;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kIn; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[j * kXStride + ty * 4]);
      const float4 wr = *reinterpret_cast<const float4*>(&ws[j * 2 * kBins + tx * 4]);
      const float4 wi = *reinterpret_cast<const float4*>(&ws[j * 2 * kBins + kBins + tx * 4]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wra[4] = {wr.x, wr.y, wr.z, wr.w};
      const float wia[4] = {wi.x, wi.y, wi.z, wi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_re[i][c] = fmaf(xa[i], wra[c], acc_re[i][c]);
          acc_im[i][c] = fmaf(xa[i], wia[c], acc_im[i][c]);
        }
      }
    }

    if (kStoreRf) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
        if (r < rows) {
          float4* dst = reinterpret_cast<float4*>(
              &rf[((size_t)r * k + k0 + tx * 4) * 2]);
          dst[0] = make_float4(acc_re[i][0] - off_re[0], acc_im[i][0] - off_im[0],
                               acc_re[i][1] - off_re[1], acc_im[i][1] - off_im[1]);
          dst[1] = make_float4(acc_re[i][2] - off_re[2], acc_im[i][2] - off_im[2],
                               acc_re[i][3] - off_re[3], acc_im[i][3] - off_im[3]);
        }
      }
    }

    float mx[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[c] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float yr = acc_re[i][c] - off_re[c];
        const float yi = acc_im[i][c] - off_im[c];
        mx[c] = fmaxf(mx[c], sqrtf(yr * yr + yi * yi));
      }
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 1));
      mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], 2));
    }
    const int frame = tile * (kRows / kPn) + (ty >> 2);
    if ((ty & 3) == 0 && (size_t)frame * kPn < (size_t)rows) {
      *reinterpret_cast<float4*>(&prof[(size_t)frame * k + k0 + tx * 4]) =
          make_float4(mx[0], mx[1], mx[2], mx[3]);
    }
  }
}

template <bool kStoreRf>
int launch(const float* x, const float* w, const float* off, float* prof,
           float* rf, int rows, int k, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      profile_kernel<kStoreRf>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = (rows + kRows - 1) / kRows;
  int tiles_y = 2 * sms;
  if (tiles_y > row_tiles) tiles_y = row_tiles;
  if (tiles_y < 1) tiles_y = 1;
  dim3 grid(k / kBins, tiles_y);
  profile_kernel<kStoreRf><<<grid, kThreads, kSmemBytes, stream>>>(
      x, w, off, prof, rf, rows, k, row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, 128] f32, w [128, 2k] f32 (blocked), off [2k] f32, prof [rows/16, k].
// rows must be a multiple of 16 and k of 64; pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fast_time_profile_launch(const float* x, const float* w,
                                        const float* off, float* prof,
                                        int rows, int k, void* stream) {
  return launch<false>(x, w, off, prof, nullptr, rows, k,
                       (cudaStream_t)stream);
}

// K6: fast_time_profile_launch's prof, plus rf [rows, k, 2] f32.
extern "C" int fast_time_launch(const float* x, const float* w,
                                const float* off, float* prof, float* rf,
                                int rows, int k, void* stream) {
  return launch<true>(x, w, off, prof, rf, rows, k, (cudaStream_t)stream);
}
