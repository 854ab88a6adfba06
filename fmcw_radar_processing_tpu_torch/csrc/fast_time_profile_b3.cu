// K1a and K1c — the profile kernels on the tensor cores: fused fast-time
// range DFT, magnitude and max over chirps as bf16 wgmma products, one
// template on the number of passes.
//
// K1a (three passes) replaces the Pallas kernel
// ops/fast_time_pallas.py::_profile_kernel_b3 of the JAX package (impl
// "pallas_profile_high", the accelerator default); K1c (one pass) replaces
// ops/fast_time_pallas.py::_profile_kernel at Precision.DEFAULT (impl
// "pallas_profile_bf16"). For flat pair rows x [F·PN, 128] (interleaved
// re, im samples) and the BLOCKED packed weight W [128, 2·K] split once per
// chain into bf16 halves w_hi = bf16(W), w_lo = bf16(W − w_hi):
//
//     x_hi = bf16(x);  x_lo = bf16(x − x_hi)
//     K1a: y = x_hi·w_hi + x_lo·w_hi + x_hi·w_lo − off   (float32 sums)
//     K1c: y = x_hi·w_hi − off                            (float32 sums)
//     prof[f, k] = max over the PN chirps of frame f of
//                  sqrt(y[r, k]² + y[r, K + k]²)
//
// the TPU kernels' arithmetic: every product of two bf16 values is exact in
// float32; K1a's dropped x_lo·w_lo term is about 2^-18 of |y|, K1c keeps
// bf16's 8-bit operands (about 2^-9 relative).
//
// What bounds them on an H100, at 65,536 frames: K1a operations — three
// bf16 products of 2·F·16·128·512 flops (412 GFLOP) take 0.417 ms at the
// 989 TFLOP/s bf16 peak, the x read (537 MB) alone 0.16 ms at 3.35 TB/s.
// K1c bytes — its one product (137 GFLOP, 0.139 ms) is under the 537 MB of
// x and 67 MB of profile (0.180 ms). So the products go to the tensor
// cores through wgmma, and everything else hides under them; at one pass
// the reads of x set the pace.
//
// Design. A block owns a slice of 64 bins: 128 columns of W (64 re, then
// 64 im), w_hi (and for K1a w_lo) 32 KiB of bf16 each, resident in shared
// memory for the block's life in wgmma's K-major core-matrix layout (8
// columns × 8 K values per 128-byte core matrix, no swizzle). Its three
// warpgroups walk 64-row tiles of x (four frames) independently, each with
// one x buffer (rows padded to 136 floats, so the fragment loads below hit
// 32 distinct banks). Per 16-deep K step a warpgroup loads its A fragments
// from shared memory straight into the register layout of wgmma's A
// operand, rounding each float pair to a bf16 pair on the way (K1a splits
// it into hi and lo pairs), and issues that step's m64n128k16 products —
// K1a x_hi·w_hi, x_lo·w_hi and x_hi·w_lo, K1c x_hi·w_hi — into one float32
// accumulator (A from registers, B from shared memory), so the conversion
// of one step overlaps the products of the previous one. Once all
// fragments are in registers, cp.async refills the buffer with the
// warpgroup's next tile while the products and the epilogue run. wgmma and
// not mma.sync: one warpgroup instruction covers 64 rows × 128 columns,
// reads B once per instruction for all four warps (mma.sync would load
// each warp's B fragments itself, at more shared-memory traffic than the
// SM has for this ratio), and runs asynchronously, so one warpgroup's
// split and epilogue overlap the others' products (a fourth warpgroup
// would not fit K1a's register file).
// The accumulator layout puts the re column of a bin (j < 8) and its im
// column (j + 8) in the same thread, and the 16 rows of one frame in one
// warp: the epilogue subtracts off, takes re² + im², folds the thread's
// two rows, finishes the max over the frame's 16 chirps with a transposing
// shuffle butterfly that leaves each lane two bins, and stores their
// square roots (a float2; the warp writes its frame's 256-byte profile
// slice at once).
//
// The x tiles of the four bin slices are read by four blocks that walk the
// rows in step, so the second to fourth reads come from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPn = 16;             // chirps per frame
constexpr int kIn = 128;            // 2·NTS: the K of the product
constexpr int kRows = 64;           // rows per warpgroup tile: four frames
constexpr int kSliceBins = 64;      // bins per block slice
constexpr int kSliceCols = 2 * kSliceBins;  // W columns per slice: re | im
constexpr int kWarpgroups = 3;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kKSteps = kIn / 16;   // wgmma k16 steps
constexpr int kXStride = kIn + 8;   // floats per padded x row in shared memory
constexpr int kXFloats = kRows * kXStride;
// W core-matrix layout: element (n, k) at (n/8)·kSbo + (k/8)·kLbo +
// (n%8)·16 + (k%8)·2 bytes. kLbo steps along K, kSbo along N.
constexpr int kLbo = 128;
constexpr int kSbo = (kIn / 8) * kLbo;
constexpr int kWBytes = kSliceCols * kIn * 2;  // one bf16 slice: 32 KiB

// Weight halves staged: w_hi and w_lo for three passes, w_hi for one.
__host__ __device__ constexpr int weight_halves(int passes) {
  return passes == 3 ? 2 : 1;
}
__host__ __device__ constexpr int smem_bytes(int passes) {
  return weight_halves(passes) * kWBytes + kWarpgroups * kXFloats * 4 +
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

// A float pair → its bf16 hi pair and the bf16 pair of the remainders
// (low half = first value, as wgmma's A fragment packs them).
__device__ __forceinline__ void split_pair(float2 v, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A float pair → its bf16 pair (round to nearest even), packed as above.
__device__ __forceinline__ uint32_t bf16_pair(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// kPasses 3: K1a (bf16x3); 1: K1c (one bf16 pass, w_lo unused).
template <int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
profile_wgmma_kernel(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w_hi,
                     const __nv_bfloat16* __restrict__ w_lo,
                     const float* __restrict__ off, float* __restrict__ prof,
                     int rows, int k, int row_tiles) {
  static_assert(kPasses == 1 || kPasses == 3, "one bf16 pass or bf16x3");
  constexpr int kHalves = weight_halves(kPasses);
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* whs = smem;                                   // w_hi slice
  uint8_t* wls = smem + kWBytes;                         // w_lo slice (K1a)
  float* xs = reinterpret_cast<float*>(smem + kHalves * kWBytes);
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

  // The W slice, once: eight columns (16 bytes) of one K row per load,
  // scattered into the core-matrix layout.
  for (int i = tid; i < kHalves * kIn * (kSliceCols / 8); i += kThreads) {
    const int half = i / (kIn * (kSliceCols / 8));
    const int j = i % (kIn * (kSliceCols / 8));
    const int kk = j / (kSliceCols / 8);
    const int n8 = (j % (kSliceCols / 8)) * 8;
    const int col = n8 < kSliceBins ? k0 + n8 : k + k0 + (n8 - kSliceBins);
    const __nv_bfloat16* src = (half ? w_lo : w_hi) + (size_t)kk * 2 * k + col;
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
    uint8_t* dst = (half ? wls : whs) + (n8 / 8) * kSbo + (kk / 8) * kLbo +
                   (kk % 8) * 2;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<uint16_t*>(dst + q * 16) = e[q];
    }
  }
  for (int i = tid; i < kSliceCols; i += kThreads) {
    offs[i] = off[i < kSliceBins ? k0 + i : k + k0 + (i - kSliceBins)];
  }
  // W was written by the generic proxy and is read by wgmma (async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t desc_hi = make_desc(smem_addr(whs));
  const uint64_t desc_lo = make_desc(smem_addr(wls));
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (; tile < row_tiles; tile += stride) {
    cp_async_wait_all();
    warpgroup_sync(wg);  // the tile is in

    // Per K step: the A fragments of the warp's 16 rows, rounded to bf16
    // (K1a: split into hi and lo), then that step's products, so the
    // conversion of step ks + 1 overlaps the tensor cores' work on step ks.
    const float* xr0 = xwg + (warp * 16 + g) * kXStride + 2 * t;
    const float* xr1 = xr0 + 8 * kXStride;
    uint32_t ah[kKSteps][4], al[kKSteps][4];
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
        if constexpr (kPasses == 3) {
          split_pair(v[q], ah[ks][q], al[ks][q]);
        } else {
          ah[ks][q] = bf16_pair(v[q]);
        }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // Two core matrices (256 bytes) per K step: +16 in the address field.
      const uint64_t step = static_cast<uint64_t>(ks * (2 * kLbo >> 4));
      wgmma_m64n128k16(acc, ah[ks], desc_hi + step, ks > 0 ? 1 : 0);
      if constexpr (kPasses == 3) {
        wgmma_m64n128k16(acc, al[ks], desc_hi + step, 1);
        wgmma_m64n128k16(acc, ah[ks], desc_lo + step, 1);
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
        fence_reg(ah[ks][q]);
        if constexpr (kPasses == 3) fence_reg(al[ks][q]);
      }
    }

    // Epilogue. acc[4j + e]: column 8j + 2t + (e & 1), row g + 8·(e >> 1);
    // j < 8 are re columns of bins 8j + 2t + c, j + 8 their im columns.
    // The max over the frame's 16 rows is taken on squared magnitudes
    // (sqrt is monotonic, so the result is the same): the thread's two
    // rows, then the eight row groups of the warp by a transposing
    // butterfly — at each of the three steps a lane keeps half of its
    // bins and receives the other lane's maxima of them — which leaves
    // lane (g, t) with bins 8g + 2t + c in 14 shuffles instead of 48.
    float sq[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = 8 * j + 2 * t + c;
        const float ore = offs[b];
        const float oim = offs[kSliceBins + b];
        const float yr0 = acc[4 * j + c] - ore;
        const float yi0 = acc[4 * (j + 8) + c] - oim;
        const float yr1 = acc[4 * j + 2 + c] - ore;
        const float yi1 = acc[4 * (j + 8) + 2 + c] - oim;
        sq[j][c] = fmaxf(yr0 * yr0 + yi0 * yi0, yr1 * yr1 + yi1 * yi1);
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
            sq[q][c] = fmaxf(mine, __shfl_xor_sync(0xffffffffu, send,
                                                    16 >> step));
          }
        }
      }
    }
    const int frame = tile * (kRows / kPn) + warp;
    if ((size_t)frame * kPn < (size_t)rows) {
      *reinterpret_cast<float2*>(&prof[(size_t)frame * k + k0 + 8 * g + 2 * t]) =
          make_float2(sqrtf(sq[0][0]), sqrtf(sq[0][1]));
    }
  }
}

template <int kPasses>
int launch_profile(const float* x, const __nv_bfloat16* w_hi,
                   const __nv_bfloat16* w_lo, const float* off, float* prof,
                   int rows, int k, void* stream) {
  auto kernel = profile_wgmma_kernel<kPasses>;
  constexpr int smem = smem_bytes(kPasses);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int slices = k / kSliceBins;
  const int row_tiles = (rows + kRows - 1) / kRows;
  // One block per SM (the registers allow no second), the slices of a row
  // tile side by side.
  int tiles_y = sms / slices;
  const int need = (row_tiles + kWarpgroups - 1) / kWarpgroups;
  if (tiles_y > need) tiles_y = need;
  if (tiles_y < 1) tiles_y = 1;
  kernel<<<dim3(slices, tiles_y), kThreads, smem, (cudaStream_t)stream>>>(
      x, w_hi, w_lo, off, prof, rows, k, row_tiles);
  return (int)cudaGetLastError();
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
  return launch_profile<3>(x, w_hi, w_lo, off, prof, rows, k, stream);
}

// K1c: as above with w_hi alone (one bf16 pass).
extern "C" int fast_time_profile_bf16_launch(const float* x,
                                             const __nv_bfloat16* w_hi,
                                             const float* off, float* prof,
                                             int rows, int k, void* stream) {
  return launch_profile<1>(x, w_hi, nullptr, off, prof, rows, k, stream);
}
