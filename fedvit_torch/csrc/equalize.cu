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
// Design: one thread-block cluster a sample, over all C channels (C = 1, 3 or
// 4 as a template parameter; any other C takes a cluster a (sample, channel),
// its pixels C floats apart). The cluster's k blocks own contiguous spans of
// the sample's pixels; k is the least power of two up to 16 that gives every
// SM kBlocksPerSm blocks, since each block pays the cluster's exchange once:
// 8 at ViT-B/16@224's 128 samples (1,024 blocks), 16 at SwinV2-L@384's 16.
//   1. Tiles of the span (at most kTile bytes) land in two staging buffers
//      in shared memory by 16-byte cp.async (4-byte at a tile's ends; a view
//      at an odd storage offset keeps its phase: a tile starts at the
//      16-byte boundary below it), one tile in flight while the other is
//      counted. Thread t takes pixels t, t + kThreads, ... and adds runs of
//      one bin in registers, so a flat region (a rotation's zero fill, a
//      constant channel) costs one shared-memory atomic a run, not one a
//      pixel; random pixels cost one each, and those atomics bound the count.
//      Each float's bin is kept, a byte, in the span's bin array, 16-byte
//      slots aligned as the image's (up to kMaxHeld bytes: a quarter of the
//      floats' size, so the whole span stays on chip).
//   2. The cluster's sums: rank r owns bins [r per, (r + 1) per) of the C
//      x 256, and every block adds its counts of them into the owner's
//      shared memory with distributed-shared-memory atomics (integers, so
//      exact in any order); one cluster barrier; then four warps a channel
//      each read 64 sums from their owners, scan them, find the last
//      non-empty bin, and build the LUT with the formula above in the same
//      fp32 operations as the plain version, storing lut[k] / 255.
//   3. Every thread maps four floats at a time from their four bins (one
//      32-bit shared load) and writes them with one 16-byte streaming store:
//      the image is read once. A channel whose step is 0 reads its floats
//      again, to pass them through. The barrier that zeroes the owners'
//      sums before the atomics and the one that keeps a block's sums alive
//      until every block has read them are split (arrive early, wait late).
// A span whose bins pass kMaxHeld (more than ~33,000 pixels of C = 3 a
// block: images above ~730 x 730 at 16 blocks) is counted from the staging
// tiles alone and read a second time from device memory for the map.
//
// Bound on an H100 SXM: bytes, the image read once and the output written
// once: a ViT-B/16@224 macro batch of 128 (128, 224, 224, 3) moves 2 x 77 MB,
// 0.046 ms at 3.35 TB/s; a SwinV2-L@384 macro batch of 16 (16, 384, 384, 3)
// 2 x 28 MB, 0.017 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxCluster = 16;             // non-portable; the card's limit
constexpr int kBlocksPerSm = 6;             // blocks an SM, at least (4 fit at once)
constexpr int kUnroll = 2;                  // 16-byte loads a thread has in flight
constexpr int kTile = 12 * 1024;            // bytes of each of two staging tiles
constexpr int kMaxHeld = 96 * 1024;         // bytes of bins a block holds, at most
static_assert(4 * 4 <= kWarps, "the LUTs take four warps a channel");

struct Eq {
  const float* img;
  float* out;
  int p;             // pixels a sample, H * W
  int c;             // the image's channels
  int span;          // pixels a block: ceil(P / cluster size)
  int tile;          // pixels a staging tile
  int tile_floats;   // floats of a staging tile, a multiple of 4
  bool held;         // the span's bins stay in shared memory
};

__device__ __forceinline__ int bin_of(float x) {
  const float f = floorf(x * 255.0f);
  return static_cast<int>(fminf(fmaxf(f, 0.f), 255.f));
}

__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// floats from the previous 16-byte boundary to p + g
__device__ __forceinline__ int phase(const float* p, long long g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) + g) & 3;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int C>
__global__ void __launch_bounds__(kThreads, 4) equalize_kernel(const Eq e) {
  constexpr int kCh = C ? C : 1;             // channels a cluster counts
  constexpr int kAll = kCh * kBins;
  extern __shared__ int4 smem[];
  const auto buf = [&](int t) {              // staging tile t % 2
    return reinterpret_cast<float*>(smem) + (t & 1) * e.tile_floats;
  };
  int* hist = reinterpret_cast<int*>(buf(0) + 2 * e.tile_floats);
  int* total = hist + kAll;                  // this block's slice of the sums
  float* lut = reinterpret_cast<float*>(total + kAll);         // lut[k] / 255
  int* pass = reinterpret_cast<int*>(lut + kAll);              // step == 0
  uint8_t* bins = reinterpret_cast<uint8_t*>(hist + (3 * kAll + kCh + 3) / 4 * 4);

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long group = blockIdx.x / k;
  long long base, stride;   // float of the group's first pixel; between pixels
  if constexpr (C != 0) {
    base = group * e.p * C;
    stride = C;
  } else {                  // group = b * c + channel
    const long long b = group / e.c;
    base = b * e.p * e.c + (group - b * e.c);
    stride = e.c;
  }
  const int p0 = min(e.p, rank * e.span), p1 = min(e.p, p0 + e.span);
  const int tiles = (p1 - p0 + e.tile - 1) / e.tile;
  // the span's floats in 16-byte slots: slot s holds floats g0 - ph + 4 s + j
  const long long g0 = base + static_cast<long long>(p0) * (C ? C : 1);
  const int ph = C ? phase(e.img, g0) : 0, len = (p1 - p0) * kCh;

  // 1. count: tile t of the span lands in staging buffer t % 2 (cp.async)
  // while tile t - 1 is counted a pixel at a time from the other; each
  // float's bin is kept, a byte, where the span's bins fit
  const auto fill = [&](int t) {
    if (t >= tiles) return;
    const int t0 = p0 + t * e.tile, t1 = min(p1, t0 + e.tile);
    float* to = buf(t);
    if constexpr (C != 0) {
      const long long f0 = base + static_cast<long long>(t0) * C;
      const int n = (t1 - t0) * C, fp = phase(e.img, f0);
      const float* src = e.img + f0 - fp;
      for (int s = threadIdx.x; 4 * s < fp + n; s += kThreads) {
        const int j0 = 4 * s;
        if (j0 >= fp && j0 + 4 <= fp + n) {
          cp_async16(smem_u32(to + j0), src + j0, true);
        } else {
          for (int j = max(j0, fp); j < min(j0 + 4, fp + n); ++j)
            cp_async4(smem_u32(to + j), src + j, true);
        }
      }
    } else {
      for (int q = threadIdx.x; q < t1 - t0; q += kThreads)
        cp_async4(smem_u32(to + q), e.img + base + (t0 + q) * stride, true);
    }
  };
  for (int i = threadIdx.x; i < kAll; i += kThreads) hist[i] = total[i] = 0;
  cluster_arrive();                          // this block's sums are zero
  int cur[kCh], run[kCh];
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) cur[ch] = run[ch] = 0;
  fill(0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    fill(t + 1);
    cp_async_commit();
    cp_async_wait<1>();                      // tile t is in
    __syncthreads();
    const int t0 = p0 + t * e.tile, n = min(p1, t0 + e.tile) - t0;
    const float* px = buf(t) +
        (C ? phase(e.img, base + static_cast<long long>(t0) * C) : 0);
    uint8_t* kept = bins + ph + (t0 - p0) * kCh;
    for (int q = threadIdx.x; q < n; q += kThreads) {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const int v = bin_of(px[q * kCh + ch]), idx = ch * kBins + v;
        if (e.held) kept[q * kCh + ch] = static_cast<uint8_t>(v);
        if (idx != cur[ch]) {
          if (run[ch]) atomicAdd(hist + cur[ch], run[ch]);
          cur[ch] = idx;
          run[ch] = 0;
        }
        ++run[ch];
      }
    }
    __syncthreads();                         // buffer t % 2 may be refilled
  }
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch)
    if (run[ch]) atomicAdd(hist + cur[ch], run[ch]);

  // 2. the cluster's sums: block r owns bins [r per, (r + 1) per), and every
  // block adds its counts of them into the owner's total (integer atomics:
  // exact in any order); then every block reads its channels' sums
  __syncthreads();                           // this block's counts are in
  cluster_wait();                            // every block's sums are zero
  const int per = (kAll + k - 1) / k;
  for (int i = threadIdx.x; i < kAll; i += kThreads)
    if (hist[i]) {
      const int owner = i / per;
      atomicAdd(cluster.map_shared_rank(total, owner) + (i - owner * per), hist[i]);
    }
  cluster.sync();                            // every count is summed
  // the LUTs: warp w < 4 C takes 64 bins, lane l bins 64 (w % 4) + l and
  // + 32 of channel w / 4: its scan, its last non-empty bin, then the
  // channel's from its four warps
  __shared__ int seg_sum[kWarps], seg_last[kWarps], seg_last_count[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch = warp / 4, seg = warp % 4;
  int cnt[2], incl[2], last = -1;
  if (warp < 4 * kCh) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int bin = ch * kBins + 64 * seg + 32 * j + lane, owner = bin / per;
      cnt[j] = cluster.map_shared_rank(total, owner)[bin - owner * per];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      incl[j] = cnt[j];                      // inclusive scan over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl[j], o);
        if (lane >= o) incl[j] += up;
      }
      if (cnt[j] > 0) last = 64 * seg + 32 * j + lane;
    }
    incl[1] += __shfl_sync(0xffffffffu, incl[0], 31);
    const int mine = last;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if (lane == 31) seg_sum[warp] = incl[1];
    if (lane == 0) seg_last[warp] = last;
    if (last >= 0 && mine == last)
      seg_last_count[warp] = (last >> 5) & 1 ? cnt[1] : cnt[0];
  }
  __syncthreads();
  if (warp < 4 * kCh) {
    int before = 0, last_seg = 0;            // bins of the channel below
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w < seg) before += seg_sum[4 * ch + w];
      if (seg_last[4 * ch + w] >= 0) last_seg = w;
    }
    const float step = floorf((static_cast<float>(e.p) -
                               static_cast<float>(seg_last_count[4 * ch + last_seg])) /
                              255.0f);
    const float step_safe = step == 0.f ? 1.f : step;
    const float half = floorf(step / 2.0f);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int bin = 64 * seg + 32 * j + lane;
      if (bin + 1 < kBins) {
        const float l = floorf((static_cast<float>(before + incl[j]) + half) / step_safe);
        lut[ch * kBins + bin + 1] = fminf(fmaxf(l, 0.f), 255.f) / 255.0f;
      }
    }
    if (seg == 0 && lane == 0) {
      lut[ch * kBins] = 0.f;
      pass[ch] = step == 0.f;
    }
  }
  cluster_arrive();                          // no more reads of other blocks
  __syncthreads();

  // 3. map: each float's bin from shared memory where the span is held, else
  // the span read again; a channel whose step is 0 passes its floats through
  const auto map = [&](float x, int v, int ch) {
    return pass[ch] ? x : lut[ch * kBins + v];
  };
  if constexpr (C != 0) {
    float* dst = e.out + g0 - ph;
    const bool vec = phase(e.out, g0) == ph;
    const auto put = [&](int s, float4 y) {
      const int j0 = 4 * s;
      if (vec && j0 >= ph && j0 + 4 <= ph + len) {
        __stcs(reinterpret_cast<float4*>(dst + j0), y);
      } else {
        for (int j = max(j0, ph); j < min(j0 + 4, ph + len); ++j)
          dst[j] = at(y, j - j0);
      }
    };
    const float* src = e.img + g0 - ph;
    const int slots = (ph + len + 3) / 4;
    if (e.held) {
      bool any_pass = false;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) any_pass |= pass[ch] != 0;
      for (int s = threadIdx.x; s < slots; s += kThreads) {
        const uint32_t v = reinterpret_cast<const uint32_t*>(bins)[s];
        const int j0 = 4 * s;
        int ch = (j0 + 4 * C - ph) % C;      // channel of float j0
        float4 y;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = j0 + j >= ph && j0 + j < ph + len;
          at(y, j) = map(any_pass && in ? __ldg(src + j0 + j) : 0.f,
                         (v >> (8 * j)) & 255, ch);
          if (++ch == C) ch = 0;
        }
        put(s, y);
      }
    } else {                                 // the span again, kUnroll slots
      for (int s0 = threadIdx.x; s0 < slots; s0 += kUnroll * kThreads) {
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = s0 + u * kThreads, j0 = 4 * s;
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s >= slots) continue;
          if (j0 >= ph && j0 + 4 <= ph + len) {
            x[u] = __ldg(reinterpret_cast<const float4*>(src + j0));
          } else {
            for (int j = max(j0, ph); j < min(j0 + 4, ph + len); ++j)
              at(x[u], j - j0) = __ldg(src + j);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = s0 + u * kThreads;
          if (s >= slots) continue;
          int ch = (4 * s + 4 * C - ph) % C;
          float4 y;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            at(y, j) = map(at(x[u], j), bin_of(at(x[u], j)), ch);
            if (++ch == C) ch = 0;
          }
          put(s, y);
        }
      }
    }
  } else {
    for (int q = threadIdx.x; q < p1 - p0; q += kThreads) {
      const long long a = base + (p0 + q) * stride;
      const float x = pass[0] || !e.held ? __ldg(e.img + a) : 0.f;
      e.out[a] = map(x, e.held ? bins[q] : bin_of(x), 0);
    }
  }
  cluster_wait();                            // no block leaves while read
}

// A cluster of k blocks a group on stream s, each holding the bins of its
// span where they fit in kMaxHeld bytes, else reading the span a second time
// for the map; cudaErrorNotSupported if the card cannot hold one such
// cluster.
template <int C>
cudaError_t launch_k(const float* img, float* out, int p, int c,
                     long long groups, int k, cudaStream_t s) {
  constexpr int kCh = C ? C : 1;
  const int span = (p + k - 1) / k;
  const int tile = min(span, (kTile / static_cast<int>(sizeof(float)) - 8) / kCh);
  const long long held = (static_cast<long long>(span) * kCh + 6 + 15) / 16 * 16;
  const Eq e{img, out, p, c, span, tile,
             (tile * kCh + 6 + 3) / 4 * 4, held <= kMaxHeld};
  const size_t smem = 2 * e.tile_floats * sizeof(float) +
                      (3 * kCh * kBins + kCh + 3) / 4 * 16 + (e.held ? held : 0);
  cudaError_t err = cudaFuncSetAttribute(
      equalize_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, equalize_kernel<C>, &cfg) !=
          cudaSuccess || clusters < 1)
    return cudaErrorNotSupported;
  return cudaLaunchKernelEx(&cfg, equalize_kernel<C>, e);
}

// k: the least power of two up to 16 that gives every SM kBlocksPerSm
// blocks (fewer, larger blocks pay the cluster's exchange less often), then
// halved while the blocks would average fewer than kThreads pixels or the
// grid would pass 2^31 - 1 blocks, and while the card cannot hold one such
// cluster
template <int C>
cudaError_t launch(const float* img, float* out, int b, int h, int w, int c,
                   cudaStream_t s) {
  const int p = h * w;
  const long long groups = C ? b : static_cast<long long>(b) * c;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(equalize_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  int k = 1;
  while (k < kMaxCluster && groups * k < static_cast<long long>(kBlocksPerSm) * sms)
    k *= 2;
  while (k > 1 && (static_cast<long long>(k) * kThreads > p ||
                   groups * k > 0x7fffffffLL))
    k /= 2;
  for (;; k /= 2) {
    err = launch_k<C>(img, out, p, c, groups, k, s);
    if (err != cudaErrorNotSupported || k == 1) return err;
    (void)cudaGetLastError();
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
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return static_cast<int>(launch<1>(in, o, b, h, w, c, s));
    case 3: return static_cast<int>(launch<3>(in, o, b, h, w, c, s));
    case 4: return static_cast<int>(launch<4>(in, o, b, h, w, c, s));
    default: return static_cast<int>(launch<0>(in, o, b, h, w, c, s));
  }
}
