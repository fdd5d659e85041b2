// LayerNorm forward over the last axis.
//
// Replaces no TPU kernel: fedvit_tpu/ops/layer_norm.py leaves the forward
// to XLA, which fuses it into one pass over the row, where PyTorch runs each
// op of the plain version (ops/layer_norm.py::layer_norm_plain) as a kernel
// of its own: 14 launches and about 60 bytes of device memory an element on
// a bf16 row. The same arithmetic as layer_norm_plain and as K4's
// recomputation of the statistics, per row of D:
//
//   mu = mean(x), var = max(mean(x^2) - mu^2, 0)                  fp32
//   y = (x - mu) rsqrt(var + eps) gamma + beta                     fp32,
//   rounded once to y's type
//
//   x (rows, D) fp32 or bf16, gamma and beta (D,) fp32, y fp32 or bf16; D a
//   multiple of 8 (bf16 x) or 4 (fp32 x), at most 2048 (K4's cap).
//
// Bytes bound it: x read once and y written once, 4 bytes an element for
// bf16, against ~8 fp32 operations. On an H100 SXM (3.35 TB/s), bf16:
//   SwinV2-L@384, a batch of 32: D 192 (294,912 rows) 226.5 MB -> 67.6 us;
//   D 384 (73,728) 113.2 MB -> 33.8 us; D 768 (18,432) 56.6 MB -> 16.9 us;
//   D 1536 (4,608) 28.3 MB -> 8.5 us.
//   ViT-B/16@224, a micro-batch of 128 (25,216 x 768): 77.5 MB -> 23.1 us.
//
// Design: a row is read once, 16 bytes a lane with the lanes of a row on
// consecutive vectors (lane l of the row's kLanes takes vectors l,
// l + kLanes, ...), and held in registers as loaded (bf16 packed, two values a
// register); its two sums are taken in fp32 by shuffles within the row's
// lanes, and it is written once with 16-byte stores (8 bytes for fp32 x to
// bf16 y). kLanes is chosen from D so that a lane holds 3 or 4 vectors where
// a row has 12 or more: 8 lanes a row (4 rows a warp) at D 192, 16 at 384, 32
// at 768; a row of more than 128 vectors (D over 1024 in bf16, 512 in fp32)
// keeps 32 lanes and gives each more vectors, 6 at D 1536 in bf16. gamma and
// beta wait in shared memory, staged while the rows are on their way, and
// are read 16 bytes a lane in the layout x is loaded in (one float a lane at
// 32-byte strides would be an 8-way bank conflict). A block is 8 warps, one
// row group each, and the blocks follow the row count: 9,216 at 294,912 rows
// of D 192, 576 at 4,608 rows of D 1536, 144 at 1,152. No atomics and one
// summation order: the same bits on every run. The launch is a programmatic
// dependent launch, scheduled while the kernel before it drains.
//
// Rows whose size is a multiple of 4 bytes but not of 16, or over 2048, up to
// D 4096, take ln_fwd_ragged_kernel (layer_norm_fwd_ragged): the same
// arithmetic, a row read and written in 4-byte words by a block of 128
// threads. EVA-02-L's SwiGLU norm, D 2,730 in bf16 at a micro-batch of 32
// (32,800 rows): 358.2 MB -> 106.9 us. Every row the kernel above takes
// keeps it.

#include "common.cuh"
#include "ln_ragged.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 2048;   // K4's cap (layer_norm_bwd_max_d)

// y's 16 bytes (or 8) of one vector of x: kN values rounded to To
template <typename To, int kN>
__device__ __forceinline__ void store_vec(To* p, const float* f) {
  if constexpr (sizeof(To) == 4 && kN == 8) {   // bf16 x, fp32 y
    Io<float>::template store<4>(p, f);
    Io<float>::template store<4>(p + 4, f + 4);
  } else {
    Io<To>::template store<kN>(p, f);
  }
}

// a sum over the kLanes lanes of a row, in one order for every row
template <int kLanes>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ((x - mu) rs) gamma + beta, each product and sum rounded as the plain
// version rounds them (no fused multiply-add)
__device__ __forceinline__ float affine(float x, float mu, float rs, float g,
                                        float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mu, rs), g), b);
}

// Rows (blockIdx.x * 8 + warp) * (32 / kLanes) + lane / kLanes; kPer vectors a
// lane at most
template <typename Ti, typename To, int kLanes, int kPer>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const Ti* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, To* __restrict__ y, int rows,
              int d, float eps) {
  constexpr int kVec = Io<Ti>::kVec;
  constexpr int kRows = 32 / kLanes;              // rows of a warp
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;                              // gamma, d
  float* b_s = smem + d;                          // beta, d
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % kLanes;                  // lane within its row
  const int row = (blockIdx.x * kWarps + warp) * kRows + lane / kLanes;
  const int nvec = d / kVec;
  const float inv_d = 1.f / static_cast<float>(d);
  // launched as a programmatic dependent of the stream's last kernel: wait
  // for its writes (x) before reading
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // this lane's vectors of its row, all in flight at once; a row past the
  // rows reads row 0 and writes nothing (every lane takes the shuffles)
  const bool real = row < rows;
  const size_t base = static_cast<size_t>(real ? row : 0) * d;
  Raw<Ti> xr[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = sub + kLanes * k;
    if (v < nvec) xr[k].load(x + base + v * kVec);
  }
  // gamma and beta to shared memory while the rows are on their way (d is a
  // multiple of 4)
  for (int c = 4 * threadIdx.x; c < d; c += 4 * kThreads) {
    *reinterpret_cast<float4*>(g_s + c) = *reinterpret_cast<const float4*>(gamma + c);
    *reinterpret_cast<float4*>(b_s + c) = *reinterpret_cast<const float4*>(beta + c);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (sub + kLanes * k < nvec) {
      float xv[kVec];
      xr[k].get(xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s1 += xv[j];
        s2 += xv[j] * xv[j];
      }
    }
  }
  // the plain version's roundings, in its order: only the sums' order differs
  const float mu = row_sum<kLanes>(s1) * inv_d;
  const float var =
      fmaxf(__fsub_rn(row_sum<kLanes>(s2) * inv_d, __fmul_rn(mu, mu)), 0.f);
  const float rs = rsqrtf(var + eps);
  __syncthreads();                                // gamma and beta are staged
  if (!real) return;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = sub + kLanes * k;
    if (v < nvec) {
      float xv[kVec], o[kVec];
      xr[k].get(xv);
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(g_s + v * kVec + j);
        const float4 b4 = *reinterpret_cast<const float4*>(b_s + v * kVec + j);
        o[j] = affine(xv[j], mu, rs, g4.x, b4.x);
        o[j + 1] = affine(xv[j + 1], mu, rs, g4.y, b4.y);
        o[j + 2] = affine(xv[j + 2], mu, rs, g4.z, b4.z);
        o[j + 3] = affine(xv[j + 3], mu, rs, g4.w, b4.w);
      }
      store_vec<To, kVec>(y + base + v * kVec, o);
    }
  }
}

template <typename Ti, typename To, int kLanes, int kPer>
int launch_with(const Ti* x, const float* gamma, const float* beta, To* y,
                int rows, int d, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kWarps * (32 / kLanes);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  return static_cast<int>(launch_dependent(
      ln_fwd_kernel<Ti, To, kLanes, kPer>, dim3(blocks), dim3(kThreads), smem,
      s, x, gamma, beta, y, rows, d, eps));
}

// Lanes a row: the fewest, from 4 up to 32, that leave a lane at most 4
// vectors; then vectors a lane: 4 at 4 lanes (a row of up to 16 vectors, D 128
// in bf16, 64 in fp32, which no LayerNorm of the port has), 3 or 4 at 8 and 16
// lanes, and at 32 rounded up to 3, 4, 6, 8, 12 or 16 (up to 128 fp32 or 256
// bf16 vectors a row)
template <typename Ti, typename To>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           int rows, int d, float eps, cudaStream_t s) {
  constexpr int kVec = Io<Ti>::kVec;
  if (d % kVec != 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const Ti* xx = static_cast<const Ti*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  To* yy = static_cast<To*>(y);
  const int nvec = d / kVec;
  int lanes = 4;
  while (lanes < 32 && 4 * lanes < nvec) lanes *= 2;
  const int per = (nvec + lanes - 1) / lanes;
#define FEDVIT_LN_FWD(L, P) \
  return launch_with<Ti, To, L, P>(xx, g, b, yy, rows, d, eps, s)
  switch (lanes) {
    case 4:
      FEDVIT_LN_FWD(4, 4);
    case 8:
      if (per == 3) FEDVIT_LN_FWD(8, 3);
      FEDVIT_LN_FWD(8, 4);
    case 16:
      if (per == 3) FEDVIT_LN_FWD(16, 3);
      FEDVIT_LN_FWD(16, 4);
    default:
      if (per <= 3) FEDVIT_LN_FWD(32, 3);
      if (per <= 4) FEDVIT_LN_FWD(32, 4);
      if (per <= 6) FEDVIT_LN_FWD(32, 6);
      if (per <= 8) FEDVIT_LN_FWD(32, 8);
      if (per <= 12) FEDVIT_LN_FWD(32, 12);
      FEDVIT_LN_FWD(32, 16);
  }
#undef FEDVIT_LN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rows whose size is a multiple of 4 bytes but not of 16 (EVA-02-L's SwiGLU
// norm, D 2,730 in bf16: 5,460 bytes), up to D 4096: one block of 128
// threads a row, thread t the row's 4-byte words t, t + 128, ... (two bf16
// values or one fp32 a word, kPer at most), all in flight at once; the two
// sums by shuffles, then across the block's 4 warps in order; gamma and beta
// read from global memory (L1) in x's layout. The arithmetic and roundings
// are ln_fwd_kernel's. Its own name, so that a reader of ln_fwd_kernel's
// time does not count it.
template <typename Ti, typename To, int kPer>
__global__ void __launch_bounds__(ln_ragged::kThreads)
ln_fwd_ragged_kernel(const Ti* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, To* __restrict__ y, int d,
                     float eps) {
  using W = ln_ragged::Word<Ti>;
  constexpr int kN = W::kN;
  constexpr int kThreads = ln_ragged::kThreads;
  __shared__ float2 red[ln_ragged::kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int words = d / kN;
  const float inv_d = 1.f / static_cast<float>(d);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const typename W::U* xw = reinterpret_cast<const typename W::U*>(x + base);
  typename W::U xr[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < words) xr[k] = xw[i];
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
  const float var = fmaxf(__fsub_rn(s.y * inv_d, __fmul_rn(mu, mu)), 0.f);
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < words) {
      float f[kN], g[kN], b[kN], o[kN];
      W::get(xr[k], f);
      ln_ragged::load_floats<kN>(gamma + i * kN, g);
      ln_ragged::load_floats<kN>(beta + i * kN, b);
#pragma unroll
      for (int j = 0; j < kN; ++j) o[j] = affine(f[j], mu, rs, g[j], b[j]);
      ln_ragged::store_word<To, kN>(y + base + i * kN, o);
    }
  }
}

template <typename Ti, typename To, int kPer>
int launch_ragged_with(const Ti* x, const float* gamma, const float* beta,
                       To* y, int rows, int d, float eps, cudaStream_t s) {
  return static_cast<int>(launch_dependent(
      ln_fwd_ragged_kernel<Ti, To, kPer>, dim3(rows), dim3(ln_ragged::kThreads),
      0, s, x, gamma, beta, y, d, eps));
}

// kPer words a thread: the fewest of 4, 8, 12, 16, 24, 32 that hold the row
// (D 2,730 in bf16: 1,365 words, 12 a thread)
template <typename Ti, typename To>
int launch_ragged(const void* x, const void* gamma, const void* beta, void* y,
                  int rows, int d, float eps, cudaStream_t s) {
  constexpr int kN = ln_ragged::Word<Ti>::kN;
  if (d % kN != 0 || d > ln_ragged::kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Ti* xx = static_cast<const Ti*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  To* yy = static_cast<To*>(y);
  const int per = (d / kN + ln_ragged::kThreads - 1) / ln_ragged::kThreads;
#define FEDVIT_LN_RAGGED(P) \
  if (per <= P) return launch_ragged_with<Ti, To, P>(xx, g, b, yy, rows, d, eps, s)
  FEDVIT_LN_RAGGED(4);
  FEDVIT_LN_RAGGED(8);
  FEDVIT_LN_RAGGED(12);
  FEDVIT_LN_RAGGED(16);
  FEDVIT_LN_RAGGED(24);
  FEDVIT_LN_RAGGED(32);
#undef FEDVIT_LN_RAGGED
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype, y_dtype: 0 = float32, 1 = bfloat16; gamma and beta fp32. Returns a
// cudaError_t (0 on success); D over 2048 (ops/layer_norm.py::_LN_MAX_D) is
// refused. The caller checks shapes, contiguity and 16-byte alignment.
extern "C" int layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                              void* y, int rows, int d, int x_dtype, int y_dtype,
                              float eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && y_dtype == 0)
    return launch<float, float>(x, gamma, beta, y, rows, d, eps, s);
  if (x_dtype == 0 && y_dtype == 1)
    return launch<float, bf16>(x, gamma, beta, y, rows, d, eps, s);
  if (x_dtype == 1 && y_dtype == 0)
    return launch<bf16, float>(x, gamma, beta, y, rows, d, eps, s);
  if (x_dtype == 1 && y_dtype == 1)
    return launch<bf16, bf16>(x, gamma, beta, y, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same for rows of any size that is a multiple of 4 bytes, D up to 4096
// (ops/layer_norm.py::_LN_RAGGED_MAX_D), x and y 4-byte aligned (8 for fp32 y
// of bf16 x); the caller takes the kernel above wherever it can.
extern "C" int layer_norm_fwd_ragged(const void* x, const void* gamma,
                                     const void* beta, void* y, int rows, int d,
                                     int x_dtype, int y_dtype, float eps,
                                     void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && y_dtype == 0)
    return launch_ragged<float, float>(x, gamma, beta, y, rows, d, eps, s);
  if (x_dtype == 0 && y_dtype == 1)
    return launch_ragged<float, bf16>(x, gamma, beta, y, rows, d, eps, s);
  if (x_dtype == 1 && y_dtype == 0)
    return launch_ragged<bf16, float>(x, gamma, beta, y, rows, d, eps, s);
  if (x_dtype == 1 && y_dtype == 1)
    return launch_ragged<bf16, bf16>(x, gamma, beta, y, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
