// K2a — the spectrogram export's phase 1 at bf16x3 on the tensor cores
// (AlgorithmConfig.stft_psd_precision "high", the production profile).
//
// Replaces ops/stft_pallas.py::_psd_kernel_b3 of the JAX package. For the
// folded DFT operator A [2·nb_pad, 20] (√(scale·dbl) in its rows, re rows
// then im rows), split A_hi = bf16(A), A_lo = bf16(A − A_hi), and the
// sliding windows X[w, t] = sig[t + w] split x_hi = bf16(x), x_lo =
// bf16(x − x_hi):
//
//     s[r, t] = Σ_{w<20} A_hi[r,w]·X_hi[w,t] + A_hi[r,w]·X_lo[w,t]
//                        + A_lo[r,w]·X_hi[w,t]        (float32 sums)
//     p[b, t] = s[b, t]² + s[nb_pad + b, t]²,   p = 0 at columns t ≥ nv
//     kRound: p rounded to bf16 (round to nearest even) and stored widened
//     tmax[i] = max of the stored p of 32-column tile i (the wrapper
//               reduces them to one per 1024 columns)
//
// the TPU kernel's arithmetic: every product of two bf16 values is exact in
// float32, the dropped A_lo·X_lo term is about 2^-18 of |s|. kRound is the
// bf16 PSD store (stft_psd_store "bfloat16"): the values are JAX's bf16
// PSD, kept in a float32 array so that K3 and K4b read them unchanged.
//
// What bounds it on an H100, at 65,536 frames × 16 chirps, nfft 256
// (nb_pad 144): the PSD write, 604 MB = 0.18 ms at 3.35 TB/s. The products
// are 3 · 2·(2·nb_pad)·20 flops a column, 35 GFLOP (0.035 ms at 989 TFLOP/s
// bf16); on the CUDA cores the exact form's 40 float32 FMAs a value take
// about as long as the write. So the products go to the tensor cores, and
// the design keeps everything else from getting in the way of the stores.
//
// Design. mma.sync m16n8k16 plus m16n8k8 (K = 20 padded to 24 with zeros,
// not to 32: a quarter fewer products), bf16 operands, float32
// accumulators. A warp computes a 32-column tile (four n8 tiles) for all
// bins, one 16-row m-tile at a time:
//  - A: each m-tile holds 8 bins, their 8 re rows in rows 0-7 and their 8
//    im rows in rows 8-15. A thread's accumulator fragment holds rows g and
//    g + 8, so it holds re and im of the same bin and the square-add is
//    thread-local. The block stages A_hi and A_lo once, in shared memory in
//    fragment order (per m-tile and lane, three 16-byte words: the k16
//    fragments of A_hi and of A_lo, then both k8 fragments), so a thread
//    loads its fragments of an m-tile with three conflict-free 16-byte
//    loads; 1.5 KB an m-tile, 27 KB at nb_pad 144, 96 KB at nb_pad 512.
//  - B: the Hankel window matrix is read straight from the signal: the B
//    fragment of column n holds X[k, n] = sig[n + k] at two adjacent k, so
//    each thread loads its 20 samples of the tile (read-only cache), splits
//    them and keeps the 24 bf16 pairs of its four n8 tiles in registers
//    for all m-tiles. No im2col exists in memory.
//  - Store: the columns of the four n8 tiles are permuted (B column n of
//    tile j is physical column 16·(j/2) + 4·(n/2) + 2·(j%2) + n%2), so a
//    thread's accumulators hold four adjacent columns twice: each bin row
//    leaves as two 16-byte streaming stores (st.global.cs), and a quad of
//    threads writes 64 contiguous bytes, two whole sectors, per store. No
//    shared-memory staging.
//  - The grid is persistent (as many 256-thread blocks as fit), and each
//    warp walks the 32-column tiles on its own, the eight warps of a block
//    on adjacent tiles: no block barrier after the staging and one max per
//    warp tile (a variant with 1,024-column block tiles and a block max
//    took the same time). One warp's stores overlap the others' products.
//    A warp tile wholly past nv stores zeros without products.
//
// Measured on an H100 (PERF.md, tools/time_psd_phase1.py): about 0.29 ms
// at nb_pad 144, the same as K4a's float32 kernel and under a bf16
// matmul writing the same bytes: the write rate, not the products, sets
// the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 20;        // STFT window length
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 32;    // columns per warp tile: four n8 tiles
constexpr int kFragWords = 3;    // 16-byte words per lane and m-tile

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 halves of v: hi = bf16(v), lo = bf16(v − hi), round to nearest even.
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// The bf16 pairs (element k in the low half, k + 1 in the high half) of
// the hi and lo halves of two adjacent values.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat16 ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  hi = pack_bf16(ah, bh);
  lo = pack_bf16(al, bl);
}

// d += a·b: m16n8k16, A 16×16 row-major, B 16×8 column-major, bf16.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint4& a,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// d += a·b: m16n8k8, A 16×8 row-major, B 8×8 column-major, bf16.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kRound>
__global__ void __launch_bounds__(kThreads, 2)
psd_b3_kernel(const float* __restrict__ sig, int sig_len,
              const float* __restrict__ a2, int nb_pad,
              float* __restrict__ p, float* __restrict__ tmax, int t_pad,
              int nv) {
  extern __shared__ uint4 frag[];  // [m_tiles][kFragWords][32]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int m_tiles = nb_pad / 8;
  const int tiles = t_pad / kWarpCols;

  // The operator in fragment order, once. Word w of m-tile m for lane l:
  // w 0, 1: the m16n8k16 A fragment of A_hi, A_lo at k 0..15 — rows g and
  // g + 8 of the m-tile (re and im of bin 8m + g), k 2t, 2t + 1 and
  // 2t + 8, 2t + 9; w 2: the m16n8k8 fragments at k 16..23 of A_hi (x, y)
  // and A_lo (z, w). Taps past 19 are zero.
  for (int i = tid; i < m_tiles * kFragWords * 32; i += kThreads) {
    const int l = i & 31;
    const int w = (i >> 5) % kFragWords;
    const int m = (i >> 5) / kFragWords;
    const int lg = l >> 2, lt = l & 3;
    const float* re = a2 + (size_t)(8 * m + lg) * kTaps;
    const float* im = a2 + (size_t)(nb_pad + 8 * m + lg) * kTaps;
    auto tap = [](const float* row, int k) { return k < kTaps ? row[k] : 0.f; };
    uint32_t hi[4], lo[4];
    if (w < 2) {
      const int k0 = 2 * lt;
      split_pair(tap(re, k0), tap(re, k0 + 1), hi[0], lo[0]);
      split_pair(tap(im, k0), tap(im, k0 + 1), hi[1], lo[1]);
      split_pair(tap(re, k0 + 8), tap(re, k0 + 9), hi[2], lo[2]);
      split_pair(tap(im, k0 + 8), tap(im, k0 + 9), hi[3], lo[3]);
      frag[i] = w == 0 ? make_uint4(hi[0], hi[1], hi[2], hi[3])
                       : make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      const int k0 = 16 + 2 * lt;
      split_pair(tap(re, k0), tap(re, k0 + 1), hi[0], lo[0]);
      split_pair(tap(im, k0), tap(im, k0 + 1), hi[1], lo[1]);
      frag[i] = make_uint4(hi[0], hi[1], lo[0], lo[1]);
    }
  }
  __syncthreads();

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t row4 = (size_t)t_pad / 4;
  for (int tile = blockIdx.x * kWarps + warp; tile < tiles;
       tile += gridDim.x * kWarps) {
    const int c0 = tile * kWarpCols;
    // This thread's output columns: c0 + 4t + 0..3 and c0 + 16 + 4t + 0..3.
    float4* dst = reinterpret_cast<float4*>(p + (size_t)g * t_pad + c0 + 4 * t);
    float mx = 0.f;
    if (c0 >= nv) {  // the whole warp tile is past the valid columns
      for (int m = 0; m < m_tiles; ++m) {
        __stcs(dst + 8 * m * row4, zero);
        __stcs(dst + 8 * m * row4 + 4, zero);
      }
    } else {
      // B fragments of the four n8 tiles: column n = g of tile j is
      // physical column c0 + 16·(j/2) + 4·(g/2) + 2·(j%2) + g%2, and its
      // samples at k = 2t, 2t + 1 (+ 8, + 16) follow it.
      const int base = c0 + 4 * (g >> 1) + (g & 1) + 2 * t;
      auto sample = [&](int o) {
        const int s = base + o;
        return s < sig_len ? __ldg(sig + s) : 0.f;
      };
      uint32_t bh[4][3], bl[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = 16 * (j >> 1) + 2 * (j & 1);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          split_pair(sample(o + 8 * s), sample(o + 8 * s + 1), bh[j][s],
                     bl[j][s]);
        }
      }
      // Valid-column masks of the thread's eight columns.
      bool ok[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        ok[c] = c0 + 16 * (c >> 2) + 4 * t + (c & 3) < nv;
      }
#pragma unroll 1
      for (int m = 0; m < m_tiles; ++m) {
        const uint4* f = frag + m * kFragWords * 32 + lane;
        const uint4 ah = f[0];
        const uint4 al = f[32];
        const uint4 a8 = f[64];
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          mma_k16(acc[j], ah, bh[j][0], bh[j][1]);
          mma_k16(acc[j], ah, bl[j][0], bl[j][1]);
          mma_k16(acc[j], al, bh[j][0], bh[j][1]);
          mma_k8(acc[j], a8.x, a8.y, bh[j][2]);
          mma_k8(acc[j], a8.x, a8.y, bl[j][2]);
          mma_k8(acc[j], a8.z, a8.w, bh[j][2]);
        }
        // acc[j][c] is re of bin 8m + g at column 2t + c of tile j,
        // acc[j][2 + c] its im: v[c'] holds the thread's column c'.
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int k = 4 * (j >> 1) + 2 * (j & 1) + c;
            float pv = __fmaf_rn(acc[j][c], acc[j][c],
                                 __fmul_rn(acc[j][2 + c], acc[j][2 + c]));
            pv = ok[k] ? pv : 0.f;
            if (kRound) pv = round_bf16(pv);
            mx = fmaxf(mx, pv);
            v[k] = pv;
          }
        }
        __stcs(dst + 8 * m * row4, make_float4(v[0], v[1], v[2], v[3]));
        __stcs(dst + 8 * m * row4 + 4, make_float4(v[4], v[5], v[6], v[7]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) tmax[tile] = mx;
  }
}

template <bool kRound>
int launch_psd_b3(const float* sig, int sig_len, const float* a2, int nb_pad,
                  float* p, float* tmax, int t_pad, int nv,
                  cudaStream_t stream) {
  auto kernel = psd_b3_kernel<kRound>;
  const int smem = nb_pad / 8 * kFragWords * 32 * 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks_needed = (t_pad / kWarpCols + kWarps - 1) / kWarps;
  int blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > blocks_needed) blocks = blocks_needed;
  kernel<<<blocks, kThreads, smem, stream>>>(sig, sig_len, a2, nb_pad, p, tmax,
                                             t_pad, nv);
  return (int)cudaGetLastError();
}

}  // namespace

// sig [sig_len] f32; a2 [2·nb_pad, 20] f32 (the exact folded operator, split
// here); p [nb_pad, t_pad] f32; tmax [t_pad / 32] f32, one per 32 columns.
// nb_pad a multiple of 8 up to 512, t_pad of 32; round_bf16 != 0 rounds
// every stored value to bf16. Returns cudaGetLastError() after the launch.
extern "C" int psd_phase1_b3_launch(const float* sig, int sig_len,
                                    const float* a2, int nb_pad, float* p,
                                    float* tmax, int t_pad, int nv,
                                    int round_bf16, void* stream) {
  if (nb_pad % 8 || nb_pad > 512 || t_pad % kWarpCols) {
    return (int)cudaErrorInvalidValue;
  }
  return round_bf16
      ? launch_psd_b3<true>(sig, sig_len, a2, nb_pad, p, tmax, t_pad, nv,
                            (cudaStream_t)stream)
      : launch_psd_b3<false>(sig, sig_len, a2, nb_pad, p, tmax, t_pad, nv,
                             (cudaStream_t)stream);
}
