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
//   1. one block per 64 rows, one warp per row at a time: the warp holds its
//      row in registers (16-byte loads, lane l takes vectors l, l + 32, ...),
//      reduces the four row sums with shuffles, writes dx, and adds dy xhat and
//      dy into per-lane column sums; the block's 8 warps then add theirs in
//      shared memory in a fixed order and write one fp32 row of partial dgamma
//      and one of partial dbeta;
//   2. one thread per column sums the partial rows in order.
// Both passes take their sums in one order, so every run gives the same bits.
//
// Bound on an H100 SXM at the ViT-B/16@224 training micro-batch (rows
// 64 * 197 = 12,608, D = 768, bf16): x, dy read and dx written, 19.4 MB each,
// 58.1 MB / 3.35 TB/s = 17 us; the ~10 operations per element are nothing
// beside that, so bytes bound it. The partial rows add 2 * 197 * 768 * 4 B =
// 1.2 MB written and read back.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;
constexpr int kMaxPerLane = 64;  // elements of a row a lane holds

template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ gamma, T* __restrict__ dx,
                   float* __restrict__ part_g, float* __restrict__ part_b,
                   int rows, int d, float eps) {
  constexpr int kVec = Io<T>::kVec;
  extern __shared__ __align__(16) float red[];  // 2 * d: dgamma, dbeta
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d / kVec;
  const float inv_d = 1.f / static_cast<float>(d);

  float w[kPer][kVec], ag[kPer][kVec], ab[kPer][kVec];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = lane + 32 * k;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      w[k][j] = v < nvec ? gamma[v * kVec + j] : 0.f;
      ag[k][j] = ab[k][j] = 0.f;
    }
  }

  const int r_end = min(rows, (blockIdx.x + 1) * kRowsPerBlock);
  for (int r = blockIdx.x * kRowsPerBlock + warp; r < r_end; r += kWarps) {
    const size_t base = static_cast<size_t>(r) * d;
    float xv[kPer][kVec], gv[kPer][kVec];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        Io<T>::load(x + base + v * kVec, xv[k]);
        Io<T>::load(dy + base + v * kVec, gv[k]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) xv[k][j] = gv[k][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s1 += xv[k][j];
        s2 += xv[k][j] * xv[k][j];
      }
    }
    const float mu = warp_sum(s1) * inv_d;
    const float var = fmaxf(warp_sum(s2) * inv_d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = (xv[k][j] - mu) * rs;
        const float g = gv[k][j] * w[k][j];
        m1 += g;
        m2 += g * xhat;
        ag[k][j] += gv[k][j] * xhat;
        ab[k][j] += gv[k][j];
        xv[k][j] = xhat;  // x is not needed again
      }
    m1 = warp_sum(m1) * inv_d;
    m2 = warp_sum(m2) * inv_d;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float o[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          o[j] = rs * (gv[k][j] * w[k][j] - m1 - xv[k][j] * m2);
        Io<T>::template store<kVec>(dx + base + v * kVec, o);
      }
    }
  }

  // the block's column sums, warp by warp in a fixed order
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int v = lane + 32 * k;
        if (v < nvec) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const int c = v * kVec + j;
            red[c] = wi == 0 ? ag[k][j] : red[c] + ag[k][j];
            red[d + c] = wi == 0 ? ab[k][j] : red[d + c] + ab[k][j];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d; c += kThreads) {
    part_g[static_cast<size_t>(blockIdx.x) * d + c] = red[c];
    part_b[static_cast<size_t>(blockIdx.x) * d + c] = red[d + c];
  }
}

// out[c] = sum_r part[r, c] for c < 2d, the dgamma and dbeta rows side by side
__global__ void __launch_bounds__(kThreads)
ln_bwd_columns_kernel(const float* __restrict__ part_g,
                      const float* __restrict__ part_b, float* __restrict__ dgamma,
                      float* __restrict__ dbeta, int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= 2 * d) return;
  const float* src = c < d ? part_g : part_b;
  const int col = c < d ? c : c - d;
  float sum = 0.f;
  for (int r = 0; r < blocks; ++r) sum += src[static_cast<size_t>(r) * d + col];
  (c < d ? dgamma : dbeta)[col] = sum;
}

template <typename T, int kPer>
int launch_rows(const T* x, const T* dy, const float* gamma, T* dx, float* pg,
                float* pb, int rows, int d, float eps, int blocks, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_rows_kernel<T, kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ln_bwd_rows_kernel<T, kPer><<<blocks, kThreads, smem, s>>>(x, dy, gamma, dx, pg,
                                                             pb, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dy, const void* gamma, void* dx,
           void* part_g, void* part_b, void* dgamma, void* dbeta, int rows, int d,
           float eps, cudaStream_t s) {
  constexpr int kVec = Io<T>::kVec;
  if (d % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (d / kVec + 31) / 32;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
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
      err = launch_rows<T, P>(xx, gg, w, o, pg, pb, rows, d, eps, blocks, s);   \
    break;
    FEDVIT_LN_CASE(1) FEDVIT_LN_CASE(2) FEDVIT_LN_CASE(3) FEDVIT_LN_CASE(4)
    FEDVIT_LN_CASE(5) FEDVIT_LN_CASE(6) FEDVIT_LN_CASE(7) FEDVIT_LN_CASE(8)
    FEDVIT_LN_CASE(9) FEDVIT_LN_CASE(10) FEDVIT_LN_CASE(11) FEDVIT_LN_CASE(12)
    FEDVIT_LN_CASE(13) FEDVIT_LN_CASE(14) FEDVIT_LN_CASE(15) FEDVIT_LN_CASE(16)
#undef FEDVIT_LN_CASE
    default: break;
  }
  if (err != 0) return err;
  ln_bwd_columns_kernel<<<(2 * d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      pg, pb, static_cast<float*>(dgamma), static_cast<float*>(dbeta), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows of D in each of the fp32 workspaces part_g and part_b
extern "C" int layer_norm_bwd_workspace_rows(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

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
