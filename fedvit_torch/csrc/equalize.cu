// Histogram equalization of each (sample, channel) (K8): RandAugment's
// Equalize.
//
// Replaces the TPU kernel fedvit_tpu/ops/randaugment.py::_eq_kernel (launched
// by equalize :261 through pl.pallas_call :297). It computes the exact
// formula of the XLA branch _equalize_xla (:161), torchvision's
// _scale_channel, on fp32 NHWC (B, H, W, C) in [0, 1], per (b, c) over the
// P = H*W pixels:
//
//   v = clip(floor(255 x), 0, 255)           256-bin histogram hist of v
//   last = the last non-empty bin            step = floor((P - hist[last]) / 255)
//   cum = inclusive cumulative sum of hist   step_safe = step, or 1 if step == 0
//   lut[0] = 0, lut[k] = clip(floor((cum[k-1] + floor(step / 2)) / step_safe), 0, 255)
//   out = lut[v] / 255, or x itself where step == 0
//
// Counts are integers, and every fp32 value above is an integer below 2^24,
// so the sums are exact in any order and the two divisions are correctly
// rounded IEEE divisions, as XLA's: the output is the plain version's, bit
// for bit. (The TPU kernel sums its histogram on the MXU and may land one LUT
// step off; this kernel does not follow it.)
//
// Design: one block per (sample, channel), reading the channel's strided
// pixels (stride C floats).
//   1. Each warp counts into its own 256-bin integer histogram in shared
//      memory (shared-memory atomics, which give the same counts in any
//      order); then one thread per bin adds the warps' counts.
//   2. Warp 0 builds the LUT: lane l owns bins 8l .. 8l+7, finds the last
//      non-empty bin with a max over the warp and the cumulative sum with a
//      scan over the lanes' totals, and writes the shifted LUT to shared
//      memory.
//   3. Every thread writes lut[v] / 255, or x where step == 0, reading x a
//      second time.
//
// Bound on an H100 SXM: bytes, the image read once and the output written
// once: a ViT-B/16@224 macro batch of 128 (128, 224, 224, 3) moves 2 x 77 MB,
// 0.046 ms at 3.35 TB/s. A SwinV2-L@384 macro batch of 16 gives 48 blocks for
// 132 SMs; splitting a channel across blocks is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__device__ __forceinline__ int bin_of(float x) {
  const float f = floorf(x * 255.0f);
  return static_cast<int>(fminf(fmaxf(f, 0.f), 255.f));
}

__global__ void __launch_bounds__(kThreads)
equalize_kernel(const float* __restrict__ img, float* __restrict__ out, int p,
                int c) {
  __shared__ int warp_hist[kWarps][kBins];
  __shared__ int hist[kBins];
  __shared__ float lut[kBins];
  __shared__ float step_s;

  const int row = blockIdx.x;  // b * C + channel
  const int64_t b = row / c;
  const int ch = row - static_cast<int>(b) * c;
  const float* src = img + b * p * c + ch;
  float* dst = out + b * p * c + ch;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&warp_hist[0][0])[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += kThreads)
    atomicAdd(&warp_hist[warp][bin_of(__ldg(src + static_cast<int64_t>(i) * c))], 1);
  __syncthreads();
  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += warp_hist[wi][k];
    hist[k] = sum;
  }
  __syncthreads();

  if (warp == 0) {
    int cnt[8];
    int last = -1, run = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cnt[j] = hist[8 * lane + j];
      if (cnt[j] > 0) last = 8 * lane + j;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    const float step =
        floorf((static_cast<float>(p) - static_cast<float>(hist[last])) / 255.0f);
    const float step_safe = step == 0.f ? 1.f : step;
    const float half = floorf(step / 2.0f);
    // exclusive scan of the lanes' totals
#pragma unroll
    for (int j = 0; j < 8; ++j) run += cnt[j];
    int before = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += up;
    }
    int cum = before - run;  // bins before this lane's first
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * lane + j;
      cum += cnt[j];  // inclusive cumulative count of bin k
      if (k + 1 < kBins) {
        const float l = floorf((static_cast<float>(cum) + half) / step_safe);
        lut[k + 1] = fminf(fmaxf(l, 0.f), 255.f);
      }
    }
    if (lane == 0) {
      lut[0] = 0.f;
      step_s = step;
    }
  }
  __syncthreads();

  const bool pass = step_s == 0.f;
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const int64_t at = static_cast<int64_t>(i) * c;
    const float x = __ldg(src + at);
    dst[at] = pass ? x : lut[bin_of(x)] / 255.0f;
  }
}

}  // namespace

// img and out contiguous fp32 (b, h, w, c). Returns a cudaError_t (0 on
// success); the caller checks device, type, shape and contiguity.
extern "C" int equalize_fwd(const void* img, void* out, int b, int h, int w,
                            int c, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 ||
      static_cast<int64_t>(h) * w >= (int64_t{1} << 24) ||
      static_cast<int64_t>(b) * c > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  equalize_kernel<<<b * c, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), h * w, c);
  return static_cast<int>(cudaGetLastError());
}
