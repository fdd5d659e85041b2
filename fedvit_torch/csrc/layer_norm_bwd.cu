// LayerNorm backward over the last axis (K4).
//
// Replaces the TPU kernel fedvit_tpu/ops/layer_norm.py::_ln_bwd_kernel
// (launched by _ln_bwd_pallas through pl.pallas_call, under the custom VJP
// _ln_bwd_rule). Same arithmetic, per row of D:
//
//   mu = mean(x), var = max(mean(x^2) - mu^2, 0), r = rsqrt(var + eps)
//   xhat = (x - mu) r, g = dy * gamma
//   dx = r (g - mean(g) - xhat mean(g xhat))        in x's type
//   dgamma = sum_rows dy xhat, dbeta = sum_rows dy   fp32
//
//   x, dy (rows, D) fp32 or bf16, gamma (D,) fp32; D a multiple of 8 (bf16)
//   or 4 (fp32), at most 2048: a lane holds up to 64 elements of a row, 8
//   16-byte vectors of bf16 or 16 of fp32 (ViT-Ti/S/B/L have D <= 1024,
//   SwinV2-L 192 to 1536).
//
// The TPU kernel accumulates dgamma and dbeta in resident (1, D) outputs
// across its sequential grid; Hopper's blocks run in no order, so here:
//   1. a warp takes kR consecutive rows (1 to 8) and holds them in registers
//      as loaded, all in flight at once (16-byte loads, lane l takes vectors
//      l, l + 32, ...; bf16 stays packed, two values a register); it reduces
//      each row's four sums with shuffles, writes dx, and writes the sums
//      over its rows of dy xhat and of dy to its own row of shared memory.
//      gamma waits in shared memory and is read 16 bytes a lane in the
//      layout x is loaded in (one float a lane at 32-byte strides would be
//      an 8-way bank conflict). A block of 8 warps sums its warps' rows in warp
//      order; the 8 blocks of a thread-block cluster then sum their 8
//      column sums through distributed shared memory, block rank by rank,
//      each block one eighth of the columns, and write one fp32 row of
//      partial dgamma and one of partial dbeta for the cluster's 64 kR rows;
//   2. the partial rows are summed in a fixed order: each block of 32 x
//      `slices` threads takes 32 columns, thread row s the partial rows s,
//      s + slices, ... in order, and the slices are added in order (slices:
//      one for each 8 partial rows, at most 32).
// Both passes take their sums in one order, so every run gives the same bits.
//
// A fixed 64 rows a block would give 18 blocks at 1,152 rows (SwinV2-L's
// last stage, 8 images) for 132 SMs, and column sums kept in registers
// across a warp's rows would spill at D = 1536. Here a lane keeps only its
// rows' x and dy, and kR is the most (up to kR x vectors a lane <= 8, so x
// and dy take at most 64 registers) that still gives every SM 16 blocks
// (rows_per_warp), so the blocks follow the row count: 144 at 1,152 rows of
// D 1536 (kR 1), 576 at 4,608 of D 768 (1), 1,576 at ViT-B's 12,608 (1),
// 2,304 at SwinV2-L's 73,728 of D 192 (4). The cluster keeps the partial
// rows to one per 64 rows at most (layer_norm_bwd_workspace_rows) without
// an atomic. Both passes are programmatic dependent launches, each scheduled
// while the kernel before it drains.
//
// Bound on an H100 SXM (3.35 TB/s), bf16, from x and dy read and dx
// written (gamma read, dgamma and dbeta written: 12 D bytes more): the
// ~16 fp32 operations an element are nothing beside them, so bytes bound it.
//   ViT-B/16@224 micro-batch (12,608 x 768): 58.1 MB -> 17.3 us
//   SwinV2-L@384, 8 images: D 192 (73,728 rows) 84.9 MB -> 25.4 us;
//   D 384 (18,432) 42.5 MB -> 12.7 us; D 768 (4,608) 21.2 MB -> 6.3 us;
//   D 1536 (1,152) 10.6 MB -> 3.2 us.
// The partial rows add 2 * D * 4 bytes a 64 kR rows, written and read back
// (4% of the bytes at D = 768 bf16 with kR = 1).
//
// Rows whose size is a multiple of 4 bytes but not of 16, or over 2048, up to
// D 4096, take ln_bwd_ragged_kernel (layer_norm_bwd_ragged) for pass 1: the
// same arithmetic, a block of 128 threads a row in 4-byte words, rows in
// turn, one partial row a block (about 8 blocks an SM); pass 2 as above.
// EVA-02-L's SwiGLU norm, D 2,730 in bf16 at a micro-batch of 32 (32,800
// rows): 537.3 MB -> 160.4 us. Every row the kernels above take keeps them.

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "ln_ragged.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                       // warps of a block, kR rows each
constexpr int kThreads = kWarps * 32;
constexpr int kCluster = 8;                     // blocks of a cluster
constexpr int kRowsPerPart = kWarps * kCluster; // warps of a cluster: its
                                                // partial row sums 64 kR rows
constexpr int kMaxPerLane = 64;                 // elements of a row a lane holds
constexpr int kMaxPerWarpVecs = 8;              // 16-byte vectors of x a lane
                                                // holds over a warp's rows
constexpr int kSlices = 32;                     // row slices of pass 2
// blocks an SM below which a warp takes no more rows: two waves of the 8
// blocks of 256 threads an SM holds (at 4 the fewer, longer blocks of 2 or
// 4 rows a warp read slower, on the card, than one row a warp)
constexpr int kBlocksPerSm = 16;

// Pass 1: rows (blockIdx.x * 8 + warp) * kR .. +kR-1, one warp; each cluster
// of 8 blocks writes partial row blockIdx.x / 8 of part_g and part_b.
template <typename T, int kPer, int kR>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ gamma, T* __restrict__ dx,
                   float* __restrict__ part_g, float* __restrict__ part_b,
                   int rows, int d, float eps) {
  constexpr int kVec = Io<T>::kVec;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                 // gamma, d
  float* red = smem + d;             // per warp: dy xhat (d), then dy (d)
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d / kVec;
  const float inv_d = 1.f / static_cast<float>(d);
  // launched as a programmatic dependent of the stream's last kernel: wait
  // for its writes (x, dy) before reading them
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // gamma of vector v as float4s, read in the layout x is loaded in (16
  // bytes a lane, lanes on consecutive addresses)
  auto gamma_of = [&](int v, float* f) {
#pragma unroll
    for (int j = 0; j < kVec; j += 4) {
      const float4 g4 = *reinterpret_cast<const float4*>(w_s + v * kVec + j);
      f[j] = g4.x; f[j + 1] = g4.y; f[j + 2] = g4.z; f[j + 3] = g4.w;
    }
  };

  // this warp's kR rows, all in flight at once; a row past the rows reads
  // row 0 and adds zeros
  const int r0 = (blockIdx.x * kWarps + warp) * kR;
  Raw<T> xr[kR][kPer], gr[kR][kPer];
  size_t base[kR];
  bool real[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    real[i] = r0 + i < rows;
    base[i] = static_cast<size_t>(real[i] ? r0 + i : 0) * d;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        xr[i][k].load(x + base[i] + v * kVec);
        gr[i][k].load(dy + base[i] + v * kVec);
      }
    }
  }
  // gamma to shared memory while the rows are on their way
  for (int c = threadIdx.x; c < d; c += kThreads) w_s[c] = gamma[c];
  float mu[kR], rs[kR], m1[kR], m2[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (lane + 32 * k < nvec) {
        float xv[kVec];
        xr[i][k].get(xv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s1 += xv[j];
          s2 += xv[j] * xv[j];
        }
      }
    }
    mu[i] = warp_sum(s1) * inv_d;
    const float var = fmaxf(warp_sum(s2) * inv_d - mu[i] * mu[i], 0.f);
    rs[i] = rsqrtf(var + eps);
  }
  __syncthreads();                   // gamma is staged
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float xv[kVec], gv[kVec], wv[kVec];
        xr[i][k].get(xv);
        gr[i][k].get(gv);
        gamma_of(v, wv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = (xv[j] - mu[i]) * rs[i];
          const float g = gv[j] * wv[j];
          a += g;
          b += g * xhat;
        }
      }
    }
    m1[i] = warp_sum(a) * inv_d;
    m2[i] = warp_sum(b) * inv_d;
  }
  float* mine = red + warp * 2 * d;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = lane + 32 * k;
    if (v < nvec) {
      float wv[kVec], ag[kVec], ab[kVec];
      gamma_of(v, wv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) ag[j] = ab[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kR; ++i) {   // the warp's rows, in order
        float xv[kVec], gv[kVec], o[kVec];
        xr[i][k].get(xv);
        gr[i][k].get(gv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = (xv[j] - mu[i]) * rs[i];
          o[j] = rs[i] * (gv[j] * wv[j] - m1[i] - xhat * m2[i]);
          if (real[i]) {
            ag[j] += gv[j] * xhat;
            ab[j] += gv[j];
          }
        }
        if (real[i]) Io<T>::template store<kVec>(dx + base[i] + v * kVec, o);
      }
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(mine + v * kVec + j) =
            make_float4(ag[j], ag[j + 1], ag[j + 2], ag[j + 3]);
        *reinterpret_cast<float4*>(mine + d + v * kVec + j) =
            make_float4(ab[j], ab[j + 1], ab[j + 2], ab[j + 3]);
      }
    }
  }
  __syncthreads();
  // the block's column sums, warps in order, into warp 0's row
  for (int c = threadIdx.x; c < 2 * d; c += kThreads) {
    float sum = red[c];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) sum += red[wi * 2 * d + c];
    red[c] = sum;
  }
  cluster.sync();                    // every block's column sums are ready
  // this block's eighth of the columns, summed over the cluster's blocks in
  // rank order
  const int part = blockIdx.x / kCluster;
  const int per = 2 * d / kCluster;  // d is a multiple of 4
  const int c0 = static_cast<int>(cluster.block_rank()) * per;
  for (int c = c0 + threadIdx.x; c < c0 + per; c += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < kCluster; ++b) sum += cluster.map_shared_rank(red, b)[c];
    if (c < d)
      part_g[static_cast<size_t>(part) * d + c] = sum;
    else
      part_b[static_cast<size_t>(part) * d + c - d] = sum;
  }
  // pass 2 may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  cluster.sync();                    // no block leaves while its red is read
}

// Pass 2: out[c] = sum_p part[p, c] for c < 2d, the dgamma and dbeta rows
// side by side; 32 columns a block of 32 x `slices` threads, thread (tx, s)
// the partial rows s, s + slices, ... of column tx in order, the slices
// then summed in order
__global__ void __launch_bounds__(32 * kSlices)
ln_bwd_columns_kernel(const float* __restrict__ part_g,
                      const float* __restrict__ part_b, float* __restrict__ dgamma,
                      float* __restrict__ dbeta, int parts, int d) {
  __shared__ float sums[kSlices][33];
  asm volatile("griddepcontrol.wait;" ::: "memory");   // pass 1's partial rows
  const int slices = blockDim.x / 32;
  const int tx = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float sum = 0.f;
  if (c < 2 * d) {
    const float* src = c < d ? part_g + c : part_b + (c - d);
    for (int p = s; p < parts; p += slices) sum += src[static_cast<size_t>(p) * d];
  }
  sums[s][tx] = sum;
  __syncthreads();
  if (s == 0 && c < 2 * d) {
    float total = sums[0][tx];
    for (int i = 1; i < slices; ++i) total += sums[i][tx];
    (c < d ? dgamma : dbeta)[c < d ? c : c - d] = total;
  }
}

// partial rows: one a cluster of 64 kR rows
int parts_of(int rows, int r) {
  return (rows + kRowsPerPart * r - 1) / (kRowsPerPart * r);
}

// Rows a warp (kR): the most, doubling from 1 while kR x vectors a lane <= 8
// (64 registers for x and dy), that still gives every SM kBlocksPerSm
// blocks; 0 on a CUDA error.
int rows_per_warp(int rows, int per) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  int r = 1;
  while (2 * r * per <= kMaxPerWarpVecs &&
         rows >= static_cast<long long>(kBlocksPerSm * sms) * kWarps * 2 * r)
    r *= 2;
  return r;
}

template <typename T, int kPer, int kR>
int launch_rows(const T* x, const T* dy, const float* gamma, T* dx, float* pg,
                float* pb, int rows, int d, float eps, cudaStream_t s) {
  const size_t smem = (1 + 2 * kWarps) * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_rows_kernel<T, kPer, kR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      static_cast<long long>(parts_of(rows, kR)) * kCluster;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dependent(
      ln_bwd_rows_kernel<T, kPer, kR>, dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), smem, s, x, dy, gamma, dx, pg, pb, rows, d, eps));
}

// kPer vectors a lane, kR rows a warp
template <typename T, int kPer>
int launch_per(const T* x, const T* dy, const float* gamma, T* dx, float* pg,
               float* pb, int rows, int d, float eps, int r, cudaStream_t s) {
  if constexpr (8 * kPer <= kMaxPerWarpVecs)
    if (r == 8) return launch_rows<T, kPer, 8>(x, dy, gamma, dx, pg, pb, rows, d, eps, s);
  if constexpr (4 * kPer <= kMaxPerWarpVecs)
    if (r == 4) return launch_rows<T, kPer, 4>(x, dy, gamma, dx, pg, pb, rows, d, eps, s);
  if constexpr (2 * kPer <= kMaxPerWarpVecs)
    if (r == 2) return launch_rows<T, kPer, 2>(x, dy, gamma, dx, pg, pb, rows, d, eps, s);
  return launch_rows<T, kPer, 1>(x, dy, gamma, dx, pg, pb, rows, d, eps, s);
}

template <typename T>
int launch(const void* x, const void* dy, const void* gamma, void* dx,
           void* part_g, void* part_b, void* dgamma, void* dbeta, int rows, int d,
           float eps, cudaStream_t s) {
  constexpr int kVec = Io<T>::kVec;
  if (d % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (d / kVec + 31) / 32;
  const int r = rows_per_warp(rows, per);
  if (r < 1) return static_cast<int>(cudaErrorUnknown);
  const T* xx = static_cast<const T*>(x);
  const T* gg = static_cast<const T*>(dy);
  const float* w = static_cast<const float*>(gamma);
  T* o = static_cast<T*>(dx);
  float* pg = static_cast<float*>(part_g);
  float* pb = static_cast<float*>(part_b);
  int err = static_cast<int>(cudaErrorInvalidValue);
  static_assert(kMaxPerLane == 64, "one case below for each kPer up to 64 / 4");
  // kPer 16-byte vectors a lane: up to 8 of bf16, 16 of fp32
  switch (per) {
#define FEDVIT_LN_CASE(P)                                                       \
  case P:                                                                       \
    if constexpr (P * kVec <= kMaxPerLane)                                      \
      err = launch_per<T, P>(xx, gg, w, o, pg, pb, rows, d, eps, r, s);         \
    break;
    FEDVIT_LN_CASE(1) FEDVIT_LN_CASE(2) FEDVIT_LN_CASE(3) FEDVIT_LN_CASE(4)
    FEDVIT_LN_CASE(5) FEDVIT_LN_CASE(6) FEDVIT_LN_CASE(7) FEDVIT_LN_CASE(8)
    FEDVIT_LN_CASE(9) FEDVIT_LN_CASE(10) FEDVIT_LN_CASE(11) FEDVIT_LN_CASE(12)
    FEDVIT_LN_CASE(13) FEDVIT_LN_CASE(14) FEDVIT_LN_CASE(15) FEDVIT_LN_CASE(16)
#undef FEDVIT_LN_CASE
    default: break;
  }
  if (err != 0) return err;
  const int parts = parts_of(rows, r);
  const int slices = std::min(kSlices, (parts + 7) / 8);
  return static_cast<int>(launch_dependent(
      ln_bwd_columns_kernel, dim3((2 * d + 31) / 32), dim3(32 * slices), 0, s,
      static_cast<const float*>(pg), static_cast<const float*>(pb),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), parts, d));
}

// Rows whose size is a multiple of 4 bytes but not of 16 (EVA-02-L's SwiGLU
// norm, D 2,730 in bf16), up to D 4096. Pass 1: block b, 128 threads, takes
// rows rows_per_block b .. +rows_per_block - 1 in turn; thread t the row's
// 4-byte words t, t + 128, ... (kPer at most), x's and dy's all in flight at
// once; each row's sums by shuffles and then across the block's 4 warps in
// order (ln_ragged::block_sum2), dx written, and the thread's own columns of
// dy xhat and dy summed over the block's rows in registers and written as
// partial row b of part_g and part_b. Pass 2 is ln_bwd_columns_kernel, as
// for the rows above. The arithmetic is ln_bwd_rows_kernel's; its own name,
// so that a reader of K4's pass 1 does not count it.
template <typename T, int kPer>
__global__ void __launch_bounds__(ln_ragged::kThreads)
ln_bwd_ragged_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ gamma, T* __restrict__ dx,
                     float* __restrict__ part_g, float* __restrict__ part_b,
                     int rows, int d, float eps, int rows_per_block) {
  using W = ln_ragged::Word<T>;
  using U = typename W::U;
  constexpr int kN = W::kN;
  constexpr int kThreads = ln_ragged::kThreads;
  __shared__ float2 red[ln_ragged::kWarps];
  const int words = d / kN;
  const float inv_d = 1.f / static_cast<float>(d);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float ag[kPer][kN], ab[kPer][kN];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int j = 0; j < kN; ++j) ag[k][j] = ab[k][j] = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * d;
    const U* xw = reinterpret_cast<const U*>(x + base);
    const U* gw = reinterpret_cast<const U*>(dy + base);
    U xr[kPer], gr[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + kThreads * k;
      if (i < words) {
        xr[k] = xw[i];
        gr[k] = gw[i];
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (threadIdx.x + kThreads * k < words) {
        float f[kN];
        W::get(xr[k], f);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          s1 += f[j];
          s2 += f[j] * f[j];
        }
      }
    }
    const float2 s = ln_ragged::block_sum2(s1, s2, red);
    const float mu = s.x * inv_d;
    const float rs = rsqrtf(fmaxf(s.y * inv_d - mu * mu, 0.f) + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + kThreads * k;
      if (i < words) {
        float xv[kN], gv[kN], wv[kN];
        W::get(xr[k], xv);
        W::get(gr[k], gv);
        ln_ragged::load_floats<kN>(gamma + i * kN, wv);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float xhat = (xv[j] - mu) * rs;
          const float g = gv[j] * wv[j];
          a += g;
          b += g * xhat;
        }
      }
    }
    const float2 m = ln_ragged::block_sum2(a, b, red);
    const float m1 = m.x * inv_d, m2 = m.y * inv_d;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + kThreads * k;
      if (i < words) {
        float xv[kN], gv[kN], wv[kN], o[kN];
        W::get(xr[k], xv);
        W::get(gr[k], gv);
        ln_ragged::load_floats<kN>(gamma + i * kN, wv);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float xhat = (xv[j] - mu) * rs;
          o[j] = rs * (gv[j] * wv[j] - m1 - xhat * m2);
          ag[k][j] += gv[j] * xhat;
          ab[k][j] += gv[j];
        }
        ln_ragged::store_word<T, kN>(dx + base + i * kN, o);
      }
    }
  }
  const size_t part = static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < words) {
      ln_ragged::store_floats<kN>(part_g + part + i * kN, ag[k]);
      ln_ragged::store_floats<kN>(part_b + part + i * kN, ab[k]);
    }
  }
  // pass 2 may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// rows a block of the ragged pass 1: enough that the blocks are about 8 an
// SM, and so the partial rows about 8 an SM too; 0 on a CUDA error
int ragged_rows_per_block(int rows) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  const long long want = 8LL * sms;
  return static_cast<int>(std::max(1LL, (rows + want - 1) / want));
}

int ragged_parts(int rows) {
  const int r = ragged_rows_per_block(rows);
  return r < 1 ? 0 : (rows + r - 1) / r;
}

template <typename T, int kPer>
int launch_ragged_rows(const T* x, const T* dy, const float* gamma, T* dx,
                       float* pg, float* pb, int rows, int d, float eps,
                       int per_block, int parts, cudaStream_t s) {
  return static_cast<int>(launch_dependent(
      ln_bwd_ragged_kernel<T, kPer>, dim3(parts), dim3(ln_ragged::kThreads), 0,
      s, x, dy, gamma, dx, pg, pb, rows, d, eps, per_block));
}

// pass 1 with kPer words a thread: the fewest of 4, 8, 12, 16, 24, 32 that
// hold the row
template <typename T>
int ragged_rows_pass(const T* x, const T* dy, const float* gamma, T* dx,
                     float* pg, float* pb, int rows, int d, float eps,
                     int per_block, int parts, cudaStream_t s) {
  constexpr int kN = ln_ragged::Word<T>::kN;
  const int per = (d / kN + ln_ragged::kThreads - 1) / ln_ragged::kThreads;
#define FEDVIT_LN_RAGGED(P)                                                   \
  if (per <= P)                                                               \
  return launch_ragged_rows<T, P>(x, dy, gamma, dx, pg, pb, rows, d, eps,     \
                                  per_block, parts, s)
  FEDVIT_LN_RAGGED(4);
  FEDVIT_LN_RAGGED(8);
  FEDVIT_LN_RAGGED(12);
  FEDVIT_LN_RAGGED(16);
  FEDVIT_LN_RAGGED(24);
  FEDVIT_LN_RAGGED(32);
#undef FEDVIT_LN_RAGGED
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_ragged(const void* x, const void* dy, const void* gamma, void* dx,
                  void* part_g, void* part_b, void* dgamma, void* dbeta, int rows,
                  int d, float eps, cudaStream_t s) {
  constexpr int kN = ln_ragged::Word<T>::kN;
  if (d % kN != 0 || d > ln_ragged::kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = ragged_rows_per_block(rows);
  if (per_block < 1) return static_cast<int>(cudaErrorUnknown);
  const int parts = (rows + per_block - 1) / per_block;
  float* pg = static_cast<float*>(part_g);
  float* pb = static_cast<float*>(part_b);
  const int err = ragged_rows_pass<T>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(gamma), static_cast<T*>(dx), pg, pb, rows, d,
      eps, per_block, parts, s);
  if (err != 0) return err;
  const int slices = std::min(kSlices, (parts + 7) / 8);
  return static_cast<int>(launch_dependent(
      ln_bwd_columns_kernel, dim3((2 * d + 31) / 32), dim3(32 * slices), 0, s,
      static_cast<const float*>(pg), static_cast<const float*>(pb),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), parts, d));
}

}  // namespace

// rows of D in each of the fp32 workspaces part_g and part_b: one for each
// 64 rows, the most pass 1 writes
extern "C" int layer_norm_bwd_workspace_rows(int rows) { return parts_of(rows, 1); }

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx; gamma and the sums are
// fp32). Returns a cudaError_t (0 on success). The caller checks shapes,
// contiguity and 16-byte alignment and allocates the fp32 workspaces part_g
// and part_b, workspace_rows rows of D each; a count short of
// layer_norm_bwd_workspace_rows(rows) is refused.
extern "C" int layer_norm_bwd(const void* x, const void* dy, const void* gamma,
                              void* dx, void* part_g, void* part_b, void* dgamma,
                              void* dbeta, int rows, int d, int dtype, float eps,
                              int workspace_rows, void* stream) {
  if (rows <= 0 || d <= 0 || workspace_rows < layer_norm_bwd_workspace_rows(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dy, gamma, dx, part_g, part_b, dgamma, dbeta, rows, d,
                         eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, gamma, dx, part_g, part_b, dgamma, dbeta,
                                 rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the largest D the kernel takes for a dtype (0 = float32, 1 = bfloat16)
extern "C" int layer_norm_bwd_max_d(int /*dtype*/) { return 32 * kMaxPerLane; }

// rows of D in each of the fp32 workspaces of layer_norm_bwd_ragged: one a
// block of its pass 1 (about 8 an SM); 0 on a CUDA error
extern "C" int layer_norm_bwd_ragged_workspace_rows(int rows) {
  return rows <= 0 ? 0 : ragged_parts(rows);
}

// layer_norm_bwd for rows of any size that is a multiple of 4 bytes, D up to
// 4096 (ops/layer_norm.py::_LN_RAGGED_MAX_D), x, dy and dx 4-byte aligned;
// the caller takes layer_norm_bwd wherever it can. The workspaces hold
// layer_norm_bwd_ragged_workspace_rows(rows) rows of D; fewer are refused.
extern "C" int layer_norm_bwd_ragged(const void* x, const void* dy,
                                     const void* gamma, void* dx, void* part_g,
                                     void* part_b, void* dgamma, void* dbeta,
                                     int rows, int d, int dtype, float eps,
                                     int workspace_rows, void* stream) {
  if (rows <= 0 || d <= 0 || workspace_rows < ragged_parts(rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ragged<float>(x, dy, gamma, dx, part_g, part_b, dgamma, dbeta,
                                rows, d, eps, s);
  if (dtype == 1)
    return launch_ragged<__nv_bfloat16>(x, dy, gamma, dx, part_g, part_b, dgamma,
                                        dbeta, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
