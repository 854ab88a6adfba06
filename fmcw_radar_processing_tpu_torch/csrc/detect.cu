// K7 — vectorized peak search (the reference's f_search_peak).
//
// Replaces ops/detect_pallas.py::_kernel (search_peaks_pallas, the peak
// search of impl "pallas") of the JAX package. Per frame f of the profile
// [F, K]:
//
//     eligible[k] = p[k] ≥ p[k−1] and p[k] ≥ p[k+1] (−inf outside [0, K))
//                   and gate[k] > 0 and p[k] > threshold
//     masked = eligible ? p : −inf
//     T rounds: best = max(masked); idx = lowest k with masked[k] == best;
//               masked[idx] = −inf
//     valid = isfinite(best); mag = valid ? best : 0
//
// On a round with nothing eligible left, best is −inf and every bin ties,
// so idx is 0 (the Pallas kernel's choice, which the Doppler gather and the
// strongest-chirp gather read). Ties go to the lowest bin; both bins of a
// plateau are eligible.
//
// What bounds it on an H100: latency, not bytes — 64 MiB of profile read
// at 65,536 frames of K 256 (about 20 µs of HBM time). The TPU kernel laid
// frames on lanes and wrote [T_pad, F]; here one warp owns one frame, each
// lane K/32 neighbouring bins read with 16-byte loads (a warp reads the
// row's 1 KiB in one coalesced sweep), the neighbour test across lane edges
// takes two shuffles, and each round's max and lowest-bin argmax are five
// shuffles each. Lane 0 writes idx, mag and valid [F, T].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // frames per block
constexpr unsigned kFull = 0xffffffffu;

template <int kVpl>  // values per lane: K = 32·kVpl
__global__ void __launch_bounds__(kThreads)
search_peaks_kernel(const float* __restrict__ prof,
                    const float* __restrict__ gate, float threshold,
                    int frames, int num_targets, int* __restrict__ idx,
                    float* __restrict__ mag, uint8_t* __restrict__ valid) {
  constexpr int k = 32 * kVpl;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f >= frames) return;  // the whole warp leaves together
  const float neg = -INFINITY;

  float p[kVpl], g[kVpl];
  const float4* row =
      reinterpret_cast<const float4*>(prof + (size_t)f * k + lane * kVpl);
  const float4* grow = reinterpret_cast<const float4*>(gate + lane * kVpl);
#pragma unroll
  for (int q = 0; q < kVpl / 4; ++q) {
    const float4 v = row[q];
    const float4 gv = __ldg(&grow[q]);
    p[4 * q + 0] = v.x;
    p[4 * q + 1] = v.y;
    p[4 * q + 2] = v.z;
    p[4 * q + 3] = v.w;
    g[4 * q + 0] = gv.x;
    g[4 * q + 1] = gv.y;
    g[4 * q + 2] = gv.z;
    g[4 * q + 3] = gv.w;
  }
  // The neighbours across lane edges: lane − 1's last bin, lane + 1's first.
  float left = __shfl_up_sync(kFull, p[kVpl - 1], 1);
  float right = __shfl_down_sync(kFull, p[0], 1);
  if (lane == 0) left = neg;
  if (lane == 31) right = neg;

  float m[kVpl];
#pragma unroll
  for (int j = 0; j < kVpl; ++j) {
    const float l = j == 0 ? left : p[j - 1];
    const float r = j == kVpl - 1 ? right : p[j + 1];
    const bool ok = p[j] >= l && p[j] >= r && g[j] > 0.f && p[j] > threshold;
    m[j] = ok ? p[j] : neg;
  }

  for (int t = 0; t < num_targets; ++t) {
    float best = m[0];
#pragma unroll
    for (int j = 1; j < kVpl; ++j) best = fmaxf(best, m[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
    }
    int bi = k;
#pragma unroll
    for (int j = kVpl - 1; j >= 0; --j) {
      if (m[j] == best) bi = lane * kVpl + j;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bi = min(bi, __shfl_xor_sync(kFull, bi, o));
    }
    if (lane == 0) {
      const size_t slot = (size_t)f * num_targets + t;
      const bool ok = isfinite(best);
      idx[slot] = bi < k ? bi : 0;
      mag[slot] = ok ? best : 0.f;
      valid[slot] = ok ? 1 : 0;
    }
#pragma unroll
    for (int j = 0; j < kVpl; ++j) {
      if (lane * kVpl + j == bi) m[j] = neg;
    }
  }
}

template <int kVpl>
int launch(const float* prof, const float* gate, float threshold, int frames,
           int num_targets, int* idx, float* mag, uint8_t* valid,
           cudaStream_t stream) {
  search_peaks_kernel<kVpl><<<(frames + kWarps - 1) / kWarps, kThreads, 0,
                              stream>>>(prof, gate, threshold, frames,
                                        num_targets, idx, mag, valid);
  return (int)cudaGetLastError();
}

}  // namespace

// prof [frames, k] f32, gate [k] f32 (> 0 = inside the distance gate);
// idx int32, mag f32 and valid uint8 (0/1), each [frames, num_targets].
// k is 128, 256, 512 or 1024; pointers 16-byte aligned.
extern "C" int search_peaks_launch(const float* prof, const float* gate,
                                   float threshold, int frames, int k,
                                   int num_targets, int* idx, float* mag,
                                   uint8_t* valid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 128:
      return launch<4>(prof, gate, threshold, frames, num_targets, idx, mag,
                       valid, s);
    case 256:
      return launch<8>(prof, gate, threshold, frames, num_targets, idx, mag,
                       valid, s);
    case 512:
      return launch<16>(prof, gate, threshold, frames, num_targets, idx, mag,
                        valid, s);
    case 1024:
      return launch<32>(prof, gate, threshold, frames, num_targets, idx, mag,
                        valid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
