// K1a, K1b, K1c and K6 — the fast-time kernels on the tensor cores: fused
// range DFT, magnitude and max over chirps as bf16 wgmma products. K1a, K1b
// and K6 are one template on the number of passes (and, for K6, on storing
// the range FFT); K1c, one pass, is a persistent kernel fed by TMA.
//
// K1a (three passes) replaces the Pallas kernel
// ops/fast_time_pallas.py::_profile_kernel_b3 of the JAX package (impl
// "pallas_profile_high", the accelerator default); K1c (one pass) replaces
// ops/fast_time_pallas.py::_profile_kernel at Precision.DEFAULT (impl
// "pallas_profile_bf16"); K1b (six passes) replaces the same kernel at
// Precision.HIGHEST (impl "pallas_profile"), and K6, the six passes with
// the range FFT stored, replaces ops/fast_time_pallas.py::_kernel (impl
// "pallas", HIGHEST too). For flat pair rows x [F·PN, 128] (interleaved re,
// im samples) and the BLOCKED packed weight W [128, 2·K]:
//
//     K1a: x_hi = bf16(x), x_lo = bf16(x − x_hi); W split once per chain
//          into w_hi = bf16(W), w_lo = bf16(W − w_hi);
//          y = x_hi·w_hi + x_lo·w_hi + x_hi·w_lo − off
//     K1c: y = x_hi·w_hi − off
//     K1b, K6: x = x1 + x2 + x3 with x1 = bf16(x), x2 = bf16(x − x1),
//          x3 = bf16(x − x1 − x2), and W = w1 + w2 + w3 likewise (split
//          here, from the float32 W); y = x1·w2 + x2·w1 + x1·w3 + x2·w2 +
//          x3·w1 + x1·w1 − off — the six bf16 passes of the TPU's HIGHEST
//     prof[f, k] = max over the PN chirps of frame f of
//                  sqrt(y[r, k]² + y[r, K + k]²);   K6 also rf[r, k] = y
//
// with float32 sums. Every product of two bf16 values is exact in float32.
// K1a drops x_lo·w_lo (about 2^-18 of |y|), K1c keeps bf16's 8-bit operands
// (about 2^-9); the three terms of K1b/K6 hold all 24 bits of x and of W, so
// only the dropped x2·w3, x3·w2, x3·w3 (about 2^-27) and the float32 sums
// part them from the exact product. The five correction products go into
// the accumulator before the main x1·w1 ones: while they are summed it
// holds about 2^-8 of |y|, so only the last eight of its 48 roundings per
// row tile are at the scale of |y|.
//
// What bounds them on an H100, at 65,536 frames (one product is
// 2·F·16·128·512 flops, 137.4 GFLOP): K1a operations — three passes take
// 0.417 ms at the 989 TFLOP/s bf16 peak, the x read (537 MB) alone 0.16 ms
// at 3.35 TB/s. K1c bytes — its one product (0.139 ms) is under the 537 MB
// of x and 67 MB of profile (0.180 ms). K1b operations — six passes, 824
// GFLOP, take 0.834 ms. K6 the same 0.834 ms of operations against 0.821 ms
// of bytes (x, the 2,147 MB range FFT and the profile): its rf store has to
// overlap the products. So the products go to the tensor cores through
// wgmma, and everything else hides under them.
//
// K1a, K1b, K6: profile_wgmma_kernel. A block owns a slice of 64 bins: 128
// columns of W (64 re, then 64 im), its bf16 terms (w_hi and w_lo for K1a;
// w1, w2, w3 for K1b/K6) 32 KiB each, resident in shared memory for the
// block's life in wgmma's K-major core-matrix layout (8 columns × 8 K values
// per 128-byte core matrix, no swizzle). Its warpgroups (three; two for six
// passes, whose fragments need 96 registers) walk 64-row tiles of x (four
// frames) independently, each with one x buffer (rows padded to 136
// floats, so the fragment loads hit 32 distinct banks). Per 16-deep K step
// a warpgroup loads its A fragments from shared memory straight into the
// register layout of wgmma's A operand, splitting each float pair into bf16
// pairs on the way, and issues that step's m64n128k16 products into one
// float32 accumulator (A from registers, B from shared memory), so the
// split of one step overlaps the products of the previous one. Once all
// fragments are in registers, cp.async refills the buffer with the
// warpgroup's next tile while the products and the epilogue run. The x
// tiles of the four bin slices are read by four blocks that walk the rows
// in step, so the second to fourth reads come from L2.
//
// K1c: profile_bf16_tma_kernel. One pass is bound by the x read, so x has
// to cross from HBM once and be converted to bf16 once: a block owns a
// group of up to 256 bins (all of K at K 256; ⌈K/256⌉ groups for a wider
// K, the last the 64-multiple remainder, which runs as a second launch
// with a grid of its own, so that each launch fills the card), its w_hi staged once as four
// 32 KiB slices in the layout above (128 KiB; each 8 × 8 block of W
// transposed in registers into 16-byte stores), and the grid is
// persistent, one block per SM walking 64-row tiles. One producer thread
// keeps a ring of three 32 KiB stages filled by TMA (cp.async.bulk.tensor,
// four 32-float boxes a tile in 128-byte swizzle, a full/empty mbarrier
// pair a stage); three consumer warpgroups take the tiles in turn. A
// consumer converts its tile's A fragments to bf16 once (32 registers, two
// 16-byte loads a K step), releases the stage, and reuses them for the
// group's slices: per slice eight m64n128k16 products, then the epilogue.
// The epilogue on the CUDA cores is the longest part of a consumer's tile
// (measured: the kernel without it ran at the x read's pace), so three
// consumers keep the tensor cores and the copies busy while the others
// are in theirs; setmaxnreg gives them the producer's registers (160 a
// thread). The swizzle puts row r's 16-byte chunk c at c ^ (r % 8). Two
// freedoms of the product make the fragment loads conflict-free: the K
// order is permuted (lane t's fragment columns 2t, 2t+1, 2t+8, 2t+9 of a K
// step are the contiguous x columns 4t..4t+3, and W's rows are staged in
// the same order), and the rows within a warp's frame are permuted (row
// group g reads x row (g >> 1) | (g & 1) << 2, so the two row groups of a
// quarter warp sit in opposite halves of the swizzle and its eight 16-byte
// loads hit 32 banks). The max over the frame's 16 chirps does not see the
// row order.
//
// The accumulator layout puts the re column of a bin (j < 8) and its im
// column (j + 8) in the same thread, and the 16 rows of one frame in one
// warp: the epilogue (profile_epilogue, shared by both kernels) subtracts
// off, takes re² + im², folds the thread's two rows, finishes the max over
// the frame's 16 chirps with a transposing shuffle butterfly that leaves
// each lane two bins, and stores their square roots (a float2; the warp
// writes its frame's 256-byte profile slice at once). K6's epilogue first
// stores y: a thread holds (re, im) of bins 8j + 2t and 8j + 2t + 1 for two
// rows, one 16-byte store each per (j, row), so a warp writes whole 32-byte
// sectors, eight 64-byte runs per instruction; the offsets are 64-bit
// (F·PN·K·2 passes 2^31 at 262,144 frames). The profile comes from the same
// registers with or without that store, so K1b's and K6's are bit-equal.

#include <cuda.h>  // CUtensorMap and its enums (no libcuda: see encode_tiled)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kPn = 16;             // chirps per frame
constexpr int kIn = 128;            // 2·NTS: the K of the product
constexpr int kRows = 64;           // rows per warpgroup tile: four frames
constexpr int kSliceBins = 64;      // bins per block slice
constexpr int kSliceCols = 2 * kSliceBins;  // W columns per slice: re | im
constexpr int kKSteps = kIn / 16;   // wgmma k16 steps
constexpr int kXStride = kIn + 8;   // floats per padded x row in shared memory
constexpr int kXFloats = kRows * kXStride;
// W core-matrix layout: element (n, k) at (n/8)·kSbo + (k/8)·kLbo +
// (n%8)·16 + (k%8)·2 bytes. kLbo steps along K, kSbo along N.
constexpr int kLbo = 128;
constexpr int kSbo = (kIn / 8) * kLbo;
constexpr int kWBytes = kSliceCols * kIn * 2;  // one bf16 slice: 32 KiB

// bf16 terms of W staged: w_hi and w_lo for three passes, w1, w2, w3 for
// six.
__host__ __device__ constexpr int weight_terms(int passes) {
  return passes == 6 ? 3 : 2;
}
// Warpgroups a block: three, or two where six passes' fragments would not
// fit three warpgroups' registers.
__host__ __device__ constexpr int warpgroups(int passes) {
  return passes == 6 ? 2 : 3;
}
__host__ __device__ constexpr int smem_bytes(int passes) {
  return weight_terms(passes) * kWBytes + warpgroups(passes) * kXFloats * 4 +
         kSliceCols * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a K-major, unswizzled operand at smem address a.
__device__ __forceinline__ uint64_t make_desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Keeps the compiler from moving reads or writes of r across the
// asynchronous wgmma window (the asm statements stay in order).
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (+)= a·B for a 64×16 bf16 A in registers and a 16×128 bf16 B at desc;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A float pair → its bf16 pair (round to nearest even; low half = first
// value, as wgmma's A fragment packs them).
__device__ __forceinline__ uint32_t bf16_pair(float2 v) {
  return as_u32(__floats2bfloat162_rn(v.x, v.y));
}

// A float pair → its bf16 hi pair and the bf16 pair of the remainders.
__device__ __forceinline__ void split_pair(float2 v, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = bf16_pair(make_float2(v.x - hf.x, v.y - hf.y));
}

// A float pair → its three bf16 terms: t1 = bf16(v), t2 = bf16(v − t1),
// t3 = bf16(v − t1 − t2) (each remainder exact in float32).
__device__ __forceinline__ void split3_pair(float2 v, uint32_t& t1,
                                            uint32_t& t2, uint32_t& t3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f1 = __bfloat1622float2(h1);
  const float2 r1 = make_float2(v.x - f1.x, v.y - f1.y);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(r1.x, r1.y);
  const float2 f2 = __bfloat1622float2(h2);
  t1 = as_u32(h1);
  t2 = as_u32(h2);
  t3 = bf16_pair(make_float2(r1.x - f2.x, r1.y - f2.y));
}

// re² + im², rounded the same way wherever it is computed (no contraction
// choice of the compiler can differ between instantiations).
__device__ __forceinline__ float sq_mag(float re, float im) {
  return __fmaf_rn(re, re, __fmul_rn(im, im));
}

// The profile of one 64-bin slice from its accumulator (acc[4j + e]:
// column 8j + 2t + (e & 1), row g + 8·(e >> 1); j < 8 are re columns of
// bins 8j + 2t + c, j + 8 their im columns) and its offsets offs[128] (re
// of the slice's 64 bins, then im): the max over the warp's 16 rows of
// re² + im² (sqrt is monotonic, so the result is the same), its square
// root stored for bins 8g + 2t and + 1 at dst (the slice's first bin of
// the warp's frame) when ``store``. The thread's two rows first, then the
// eight row groups of the warp by a transposing butterfly — at each of the
// three steps a lane keeps half of its bins and receives the other lane's
// maxima of them — which leaves lane (g, t) with bins 8g + 2t + c in 14
// shuffles instead of 48.
__device__ __forceinline__ void profile_epilogue(const float (&acc)[64],
                                                 const float* offs, int g,
                                                 int t, bool store,
                                                 float* dst) {
  float sq[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int b = 8 * j + 2 * t + c;
      const float ore = offs[b];
      const float oim = offs[kSliceBins + b];
      sq[j][c] = fmaxf(sq_mag(acc[4 * j + c] - ore, acc[4 * (j + 8) + c] - oim),
                       sq_mag(acc[4 * j + 2 + c] - ore,
                              acc[4 * (j + 8) + 2 + c] - oim));
    }
  }
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int half = 4 >> step;           // bins kept: 4, 2, 1 j-values
    const bool upper = (g >> (2 - step)) & 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < half) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float lo = sq[q][c];
          const float hi = sq[q + half][c];
          const float mine = upper ? hi : lo;
          const float send = upper ? lo : hi;
          sq[q][c] = fmaxf(mine, __shfl_xor_sync(0xffffffffu, send, 16 >> step));
        }
      }
    }
  }
  if (store) {
    *reinterpret_cast<float2*>(dst + 8 * g + 2 * t) =
        make_float2(sqrtf(sq[0][0]), sqrtf(sq[0][1]));
  }
}

// kPasses 3: K1a (bf16x3 from w_hi/w_lo); 6: K1b, or
// with kStoreRf K6 (W split here into three terms; rf [rows, k, 2] stored).
template <int kPasses, bool kStoreRf>
__global__ void __launch_bounds__(128 * warpgroups(kPasses), 1)
profile_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ w_hi,
                     const __nv_bfloat16* __restrict__ w_lo,
                     const float* __restrict__ off, float* __restrict__ prof,
                     float* __restrict__ rf, int rows, int k, int row_tiles) {
  static_assert(kPasses == 3 || kPasses == 6, "bf16x3 or six passes");
  static_assert(!kStoreRf || kPasses == 6, "K6 is the six-pass form");
  constexpr int kTerms = weight_terms(kPasses);
  constexpr int kWarpgroups = warpgroups(kPasses);
  constexpr int kThreads = 128 * kWarpgroups;
  extern __shared__ __align__(1024) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem + kTerms * kWBytes);
  float* offs = xs + kWarpgroups * kXFloats;            // [kSliceCols]
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread in group
  const int k0 = blockIdx.x * kSliceBins;
  float* const xwg = xs + wg * kXFloats;  // this warpgroup's x tile

  // 64 rows × 32 sixteen-byte chunks of x; rows past the end read zeros.
  auto load_tile = [&](float* buf, int tile) {
#pragma unroll 4
    for (int i = wtid; i < kRows * (kIn / 4); i += 128) {
      const int r = i >> 5;
      const int c4 = (i & 31) * 4;
      const int gr = tile * kRows + r;
      const bool valid = gr < rows;
      cp_async16(buf + r * kXStride + c4, x + (size_t)(valid ? gr : 0) * kIn + c4,
                 valid);
    }
    cp_async_commit();
  };

  int tile = blockIdx.y * kWarpgroups + wg;
  const int stride = gridDim.y * kWarpgroups;
  if (tile < row_tiles) load_tile(xwg, tile);

  // The W slice, once: eight columns (16 bytes of bf16) of one K row per
  // item, scattered into the core-matrix layout of each term.
  constexpr int kChunks = kIn * (kSliceCols / 8);
  for (int i = tid; i < (kPasses == 6 ? 1 : kTerms) * kChunks; i += kThreads) {
    const int term = i / kChunks;
    const int j = i % kChunks;
    const int kk = j / (kSliceCols / 8);
    const int n8 = (j % (kSliceCols / 8)) * 8;
    const int col = n8 < kSliceBins ? k0 + n8 : k + k0 + (n8 - kSliceBins);
    const int at = (n8 / 8) * kSbo + (kk / 8) * kLbo + (kk % 8) * 2;
    if constexpr (kPasses == 6) {
      const float4* src = reinterpret_cast<const float4*>(w + (size_t)kk * 2 * k + col);
      const float4 lo4 = src[0], hi4 = src[1];
      const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const __nv_bfloat16 b1 = __float2bfloat16_rn(v[q]);
        const float r1 = v[q] - __bfloat162float(b1);
        const __nv_bfloat16 b2 = __float2bfloat16_rn(r1);
        const __nv_bfloat16 b3 = __float2bfloat16_rn(r1 - __bfloat162float(b2));
        *reinterpret_cast<__nv_bfloat16*>(smem + at + q * 16) = b1;
        *reinterpret_cast<__nv_bfloat16*>(smem + kWBytes + at + q * 16) = b2;
        *reinterpret_cast<__nv_bfloat16*>(smem + 2 * kWBytes + at + q * 16) = b3;
      }
    } else {
      const __nv_bfloat16* src = (term ? w_lo : w_hi) + (size_t)kk * 2 * k + col;
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        *reinterpret_cast<uint16_t*>(smem + term * kWBytes + at + q * 16) = e[q];
      }
    }
  }
  for (int i = tid; i < kSliceCols; i += kThreads) {
    offs[i] = off[i < kSliceBins ? k0 + i : k + k0 + (i - kSliceBins)];
  }
  // W was written by the generic proxy and is read by wgmma (async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Descriptors of the staged terms: w_hi/w1, w_lo/w2, w3.
  const uint64_t desc1 = make_desc(smem_addr(smem));
  const uint64_t desc2 = make_desc(smem_addr(smem + kWBytes));
  const uint64_t desc3 = make_desc(smem_addr(smem + 2 * kWBytes));
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (; tile < row_tiles; tile += stride) {
    cp_async_wait_all();
    warpgroup_sync(wg);  // the tile is in

    // Per K step: the A fragments of the warp's 16 rows, rounded to bf16
    // (K1a: split into hi and lo; six passes: into three terms), then that
    // step's products, so the split of step ks + 1 overlaps the tensor
    // cores' work on step ks.
    const float* xr0 = xwg + (warp * 16 + g) * kXStride + 2 * t;
    const float* xr1 = xr0 + 8 * kXStride;
    uint32_t a1[kKSteps][4], a2[kKSteps][4], a3[kKSteps][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const float2 v[4] = {*reinterpret_cast<const float2*>(xr0 + 16 * ks),
                           *reinterpret_cast<const float2*>(xr1 + 16 * ks),
                           *reinterpret_cast<const float2*>(xr0 + 16 * ks + 8),
                           *reinterpret_cast<const float2*>(xr1 + 16 * ks + 8)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kPasses == 6) {
          split3_pair(v[q], a1[ks][q], a2[ks][q], a3[ks][q]);
        } else {
          split_pair(v[q], a1[ks][q], a2[ks][q]);
        }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // Two core matrices (256 bytes) per K step: +16 in the address field.
      const uint64_t step = static_cast<uint64_t>(ks * (2 * kLbo >> 4));
      const int scale = ks > 0 ? 1 : 0;
      if constexpr (kPasses == 6) {
        // The corrections; the main products follow after the last step.
        wgmma_m64n128k16(acc, a1[ks], desc2 + step, scale);
        wgmma_m64n128k16(acc, a2[ks], desc1 + step, 1);
        wgmma_m64n128k16(acc, a1[ks], desc3 + step, 1);
        wgmma_m64n128k16(acc, a2[ks], desc2 + step, 1);
        wgmma_m64n128k16(acc, a3[ks], desc1 + step, 1);
      } else {
        wgmma_m64n128k16(acc, a1[ks], desc1 + step, scale);
        wgmma_m64n128k16(acc, a2[ks], desc1 + step, 1);
        wgmma_m64n128k16(acc, a1[ks], desc2 + step, 1);
      }
    }
    if constexpr (kPasses == 6) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        wgmma_m64n128k16(acc, a1[ks],
                         desc1 + static_cast<uint64_t>(ks * (2 * kLbo >> 4)), 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // The fragments are in registers: the buffer takes the next tile while
    // the products and the epilogue run.
    warpgroup_sync(wg);
    if (tile + stride < row_tiles) load_tile(xwg, tile + stride);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fence_reg(a1[ks][q]);
        fence_reg(a2[ks][q]);
        if constexpr (kPasses == 6) fence_reg(a3[ks][q]);
      }
    }

    // Epilogue. acc[4j + e]: column 8j + 2t + (e & 1), row g + 8·(e >> 1);
    // j < 8 are re columns of bins 8j + 2t + c, j + 8 their im columns.
    if constexpr (kStoreRf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tile * kRows + warp * 16 + g + 8 * h;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int b = 8 * j + 2 * t;
            *reinterpret_cast<float4*>(&rf[((size_t)r * k + k0 + b) * 2]) =
                make_float4(acc[4 * j + 2 * h] - offs[b],
                            acc[4 * (j + 8) + 2 * h] - offs[kSliceBins + b],
                            acc[4 * j + 2 * h + 1] - offs[b + 1],
                            acc[4 * (j + 8) + 2 * h + 1] - offs[kSliceBins + b + 1]);
          }
        }
      }
    }
    const int frame = tile * (kRows / kPn) + warp;
    profile_epilogue(acc, offs, g, t, (size_t)frame * kPn < (size_t)rows,
                     prof + (size_t)frame * k + k0);
  }
}

template <int kPasses, bool kStoreRf = false>
int launch_profile(const float* x, const float* w, const __nv_bfloat16* w_hi,
                   const __nv_bfloat16* w_lo, const float* off, float* prof,
                   float* rf, int rows, int k, void* stream) {
  auto kernel = profile_wgmma_kernel<kPasses, kStoreRf>;
  constexpr int smem = smem_bytes(kPasses);
  constexpr int kWarpgroups = warpgroups(kPasses);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int slices = k / kSliceBins;
  const int row_tiles = (rows + kRows - 1) / kRows;
  // One block per SM (shared memory and registers allow no second), the
  // slices of a row tile side by side.
  int tiles_y = sms / slices;
  const int need = (row_tiles + kWarpgroups - 1) / kWarpgroups;
  if (tiles_y > need) tiles_y = need;
  if (tiles_y < 1) tiles_y = 1;
  kernel<<<dim3(slices, tiles_y), 128 * kWarpgroups, smem,
           (cudaStream_t)stream>>>(x, w, w_hi, w_lo, off, prof, rf, rows, k,
                                   row_tiles);
  return (int)cudaGetLastError();
}

// --- K1c: one bf16 pass, persistent, x by a TMA ring -------------------

constexpr int kGroupSlices = 4;                     // 64-bin slices a group
constexpr int kGroupBins = kGroupSlices * kSliceBins;  // 256
constexpr int kStages = 3;                          // x tiles in the ring
constexpr int kTileBytes = kRows * kIn * 4;         // 32 KiB
constexpr int kBoxFloats = 32;                      // the 128-byte swizzle span
constexpr int kBoxBytes = kRows * kBoxFloats * 4;   // 8 KiB: 64 rows × 128 B
constexpr int kConsumers = 3;                       // consumer warpgroups
constexpr int kBf16Threads = 128 * (1 + kConsumers);  // and the producer's
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
// Shared memory: the ring (1024-byte aligned stages), W's four slices, the
// group's offsets, then the full and empty barriers.
constexpr int kWAt = kStages * kTileBytes;                     // 98,304
constexpr int kOffAt = kWAt + kGroupSlices * kWBytes;          // 229,376
constexpr int kBarAt = kOffAt + kGroupSlices * kSliceCols * 4;  // 231,424
constexpr int kBf16Smem = kBarAt + 2 * kStages * 8;            // 231,472
static_assert(kBf16Smem <= 232448, "K1c exceeds a block's shared memory");
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "the register split exceeds the SM's file");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 64-row tile of x into a ring stage: four 32-float boxes (128-byte
// swizzle), completion counted in bytes on the stage's full barrier. Rows
// past the end arrive as zeros and count all the same.
__device__ __forceinline__ void load_x_tile(const CUtensorMap* map,
                                            uint32_t stage_at, uint32_t full,
                                            int tile) {
  mbar_expect_tx(full, kTileBytes);
#pragma unroll
  for (int b = 0; b < kIn / kBoxFloats; ++b) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(stage_at + b * kBoxBytes),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(full), "r"(b * kBoxFloats),
        "r"(tile * kRows)
        : "memory");
  }
}

// The x column that the product's K index kk reads: within each 16-deep K
// step (j = kk mod 16), fragment columns 2t, 2t+1 (j < 8) and 2t+8, 2t+9
// (j ≥ 8) of lane t are x columns 4t..4t+3, so a lane's fragment is one
// 16-byte load.
__device__ __forceinline__ int x_col(int kk) {
  return (kk & ~15) + 4 * ((kk & 7) >> 1) + 2 * ((kk >> 3) & 1) + (kk & 1);
}

// d = a·B over the eight K steps of one slice (B's descriptor desc).
__device__ __forceinline__ void slice_products(float (&d)[64],
                                               const uint32_t (&a)[kKSteps][4],
                                               uint64_t desc) {
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(d[i]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    wgmma_m64n128k16(d, a[ks], desc + static_cast<uint64_t>(ks * (2 * kLbo >> 4)),
                     ks > 0 ? 1 : 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// K1c on groups of kSlices·64 bins. Grid (blocks, groups): blockIdx.y is
// the bin group (from bin bin0 + blockIdx.y·kSlices·64), blockIdx.x walks
// the row tiles blockIdx.x + i·gridDim.x, i = 0, 1, ...; tile i goes to ring
// stage i % 3 and to consumer warpgroup 1 + i % 3, so each consumer has a
// stage of its own, refilled while it computes. The slice count is a
// template parameter so that the products and epilogues are straight-line
// code: where it varied at run time, ptxas serialized the products.
template <int kSlices>
__global__ void __launch_bounds__(kBf16Threads, 1)
profile_bf16_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __nv_bfloat16* __restrict__ w_hi,
                        const float* __restrict__ off, float* __restrict__ prof,
                        int rows, int k, int bin0, int row_tiles) {
  static_assert(kSlices >= 1 && kSlices <= kGroupSlices, "1 to 4 slices");
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int g0 = bin0 + blockIdx.y * kSlices * kSliceBins;  // the group's first bin
  const int stride = gridDim.x;
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = smem_addr(smem + kBarAt);  // kStages barriers each
  const uint32_t empty = full + kStages * 8;

  if (tid == 0) {
    if (ring & 1023) __trap();  // the swizzle needs 1024-byte aligned stages
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every thread of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // The first tiles travel while W is staged.
    for (int i = 0; i < kStages; ++i) {
      const int tile = blockIdx.x + i * stride;
      if (tile < row_tiles) load_x_tile(&xmap, ring + i * kTileBytes, full + 8 * i, tile);
    }
  }

  // The group's w_hi, once, in each slice's core-matrix layout with the K
  // rows in x_col order: per item an 8 × 8 block (eight K rows of eight
  // columns, eight 16-byte loads) transposed in registers into the eight
  // columns' 16-byte K runs.
  constexpr int kItems = (kSliceCols / 8) * (kIn / 8);  // 8 × 8 blocks a slice
  for (int i = tid; i < kSlices * kItems; i += kBf16Threads) {
    const int s = i / kItems;
    const int kb = i % (kIn / 8);               // K rows 8kb..8kb+7
    const int n8 = (i % kItems) / (kIn / 8) * 8;  // columns n8..n8+7
    const int b0 = g0 + s * kSliceBins;
    const int col = n8 < kSliceBins ? b0 + n8 : k + b0 + (n8 - kSliceBins);
    uint4 rv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rv[r] = *reinterpret_cast<const uint4*>(w_hi + (size_t)x_col(8 * kb + r) * 2 * k +
                                              col);
    }
    uint8_t* const at = smem + kWAt + s * kWBytes + (n8 / 8) * kSbo + kb * kLbo;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // Column q of the block: element q of each row, K row r at byte 2r.
      uint32_t e[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t word = (&rv[r].x)[q >> 1];
        e[r] = (q & 1) ? word >> 16 : word & 0xffffu;
      }
      *reinterpret_cast<uint4*>(at + q * 16) =
          make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                     e[6] | e[7] << 16);
    }
  }
  float* const offs = reinterpret_cast<float*>(smem + kOffAt);  // [slices][128]
  for (int i = tid; i < kSlices * kSliceCols; i += kBf16Threads) {
    const int b0 = g0 + (i / kSliceCols) * kSliceBins;
    const int c = i % kSliceCols;
    offs[i] = off[c < kSliceBins ? b0 + c : k + b0 + (c - kSliceBins)];
  }
  // W was written by the generic proxy and is read by wgmma (async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread refills each stage once its consumer has
    // released it (the release of tile i − 3 is the empty barrier's
    // (i / 3)-th phase).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      for (int i = kStages;; ++i) {
        const int tile = blockIdx.x + i * stride;
        if (tile >= row_tiles) break;
        const int stage = i % kStages;
        mbar_wait(empty + 8 * stage, ((i / kStages) - 1) & 1);
        load_x_tile(&xmap, ring + stage * kTileBytes, full + 8 * stage, tile);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wtid = tid & 127;
    const int warp = wtid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    // Row group g reads x rows rg and rg + 8 of the warp's frame; the two
    // row groups of a quarter warp then sit in opposite halves of the
    // swizzle (rg % 8 = rg).
    const int rg = (g >> 1) | ((g & 1) << 2);
    const int row_at = (warp * 16 + rg) * (kBoxFloats * 4);
    const uint32_t w_at = smem_addr(smem + kWAt);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int i = wg - 1;; i += kConsumers) {
      const int tile = blockIdx.x + i * stride;
      if (tile >= row_tiles) break;
      const int stage = i % kStages;
      mbar_wait(full + 8 * stage, (i / kStages) & 1);
      // The tile's A fragments in bf16, once: per K step two 16-byte loads
      // (rows rg and rg + 8, x columns 16ks + 4t..+3) through the swizzle.
      const uint8_t* xs = smem + stage * kTileBytes + row_at;
      uint32_t a[kKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint8_t* p =
            xs + (ks >> 1) * kBoxBytes + ((((ks & 1) * 4 + t) ^ rg) << 4);
        const float4 v0 = *reinterpret_cast<const float4*>(p);
        const float4 v1 = *reinterpret_cast<const float4*>(p + 8 * kBoxFloats * 4);
        a[ks][0] = bf16_pair(make_float2(v0.x, v0.y));
        a[ks][1] = bf16_pair(make_float2(v1.x, v1.y));
        a[ks][2] = bf16_pair(make_float2(v0.z, v0.w));
        a[ks][3] = bf16_pair(make_float2(v1.z, v1.w));
      }
      mbar_arrive(empty + 8 * stage);  // the stage is free for tile i + 3

      // Per slice its eight products, then its epilogue; the other
      // consumers' products and the copies run meanwhile.
      const int frame = tile * (kRows / kPn) + warp;
      const bool store = (size_t)frame * kPn < (size_t)rows;
      float* const dst = prof + (size_t)frame * k + g0;
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
        slice_products(acc, a, make_desc(w_at + s * kWBytes));
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < 64; ++q) fence_reg(acc[q]);
        profile_epilogue(acc, offs + s * kSliceCols, g, t, store, dst + s * kSliceBins);
      }
      // The fragments stay untouched until the last products are done.
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_reg(a[ks][q]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime, so the library
// links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Raises the kernel's dynamic shared-memory limit, once per instantiation
// and device (bit d of done: device d; a device past 31 sets it each time).
template <int kSlices>
cudaError_t allow_smem() {
  static std::atomic<uint32_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(profile_bf16_tma_kernel<kSlices>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int kSlices>
int launch_slices(const CUtensorMap& xmap, const __nv_bfloat16* w_hi,
                  const float* off, float* prof, int rows, int k, int bin0,
                  int groups, int blocks, int row_tiles, cudaStream_t stream) {
  const cudaError_t err = allow_smem<kSlices>();
  if (err != cudaSuccess) return (int)err;
  profile_bf16_tma_kernel<kSlices><<<dim3(blocks, groups), kBf16Threads, kBf16Smem,
                                     stream>>>(
      xmap, w_hi, off, prof, rows, k, bin0, row_tiles);
  return (int)cudaGetLastError();
}

int launch_groups(int slices, const CUtensorMap& xmap, const __nv_bfloat16* w_hi,
                  const float* off, float* prof, int rows, int k, int bin0,
                  int groups, int blocks, int row_tiles, cudaStream_t stream) {
  switch (slices) {
    case 1:
      return launch_slices<1>(xmap, w_hi, off, prof, rows, k, bin0, groups,
                              blocks, row_tiles, stream);
    case 2:
      return launch_slices<2>(xmap, w_hi, off, prof, rows, k, bin0, groups,
                              blocks, row_tiles, stream);
    case 3:
      return launch_slices<3>(xmap, w_hi, off, prof, rows, k, bin0, groups,
                              blocks, row_tiles, stream);
    default:
      return launch_slices<4>(xmap, w_hi, off, prof, rows, k, bin0, groups,
                              blocks, row_tiles, stream);
  }
}

int launch_profile_bf16(const float* x, const __nv_bfloat16* w_hi,
                        const float* off, float* prof, int rows, int k, int bin0,
                        int group_bins, int groups, int blocks, void* stream) {
  if (rows <= 0 || rows % kPn || k <= 0 || k % kSliceBins || bin0 < 0 ||
      bin0 % kSliceBins || group_bins <= 0 || group_bins % kSliceBins ||
      group_bins > kGroupBins || groups < 1 || blocks < 1 ||
      bin0 + (long long)groups * group_bins > k) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)kIn, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kIn * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxFloats, (cuuint32_t)kRows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_groups(group_bins / kSliceBins, xmap, w_hi, off, prof, rows, k,
                       bin0, groups, blocks, (rows + kRows - 1) / kRows,
                       (cudaStream_t)stream);
}

}  // namespace

// x [rows, 128] f32; w_hi, w_lo [128, 2k] bf16 (blocked, split); off [2k]
// f32; prof [rows/16, k] f32. rows must be a multiple of 16 and k of 64;
// pointers 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int fast_time_profile_b3_launch(const float* x,
                                           const __nv_bfloat16* w_hi,
                                           const __nv_bfloat16* w_lo,
                                           const float* off, float* prof,
                                           int rows, int k, void* stream) {
  return launch_profile<3>(x, nullptr, w_hi, w_lo, off, prof, nullptr, rows, k,
                           stream);
}

// K1c: x, w_hi, off, prof, rows, k as above, one bf16 pass; one launch of
// the caller's geometry (ops/fast_time_cuda.py::k1c_geometry): groups bin
// groups of group_bins bins (a multiple of 64, at most 256) from bin bin0
// (a multiple of 64), each walked by blocks blocks. x must be 16-byte
// aligned (the TMA tensor map's rule).
extern "C" int fast_time_profile_bf16_launch(const float* x,
                                             const __nv_bfloat16* w_hi,
                                             const float* off, float* prof,
                                             int rows, int k, int bin0,
                                             int group_bins, int groups,
                                             int blocks, void* stream) {
  return launch_profile_bf16(x, w_hi, off, prof, rows, k, bin0, group_bins,
                             groups, blocks, stream);
}

// K1b: six bf16 passes of the float32 blocked weight w [128, 2k] (split in
// the kernel); x, off, prof, rows, k as fast_time_profile_b3_launch.
extern "C" int fast_time_profile_launch(const float* x, const float* w,
                                        const float* off, float* prof,
                                        int rows, int k, void* stream) {
  return launch_profile<6>(x, w, nullptr, nullptr, off, prof, nullptr, rows, k,
                           stream);
}

// K6: fast_time_profile_launch's prof, plus rf [rows, k, 2] f32.
extern "C" int fast_time_launch(const float* x, const float* w,
                                const float* off, float* prof, float* rf,
                                int rows, int k, void* stream) {
  return launch_profile<6, true>(x, w, nullptr, nullptr, off, prof, rf, rows, k,
                                 stream);
}
