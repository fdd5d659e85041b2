// Helpers shared by the kernels in this directory: 16-byte loads of fp32 or
// bf16 into fp32 registers, rounding to the storage type, warp reductions,
// the in-order column sum of an fp32 workspace, and the row normalisation of
// the scaled-cosine attention (K12).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements in one 16-byte load
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void load2(const float* p, float* f) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  }
  __device__ static float round(float x) { return x; }
  template <int kN>
  __device__ static void store(float* p, const float* f) {
    if constexpr (kN == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (kN == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) p[i] = f[i];
    }
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);          // element 0 is the low half
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unpack(v.x, f); unpack(v.y, f + 2); unpack(v.z, f + 4); unpack(v.w, f + 6);
  }
  __device__ static void load2(const __nv_bfloat16* p, float* f) {
    unpack(*reinterpret_cast<const uint32_t*>(p), f);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  template <int kN>
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    if constexpr (kN == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(
          pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
    } else if constexpr (kN == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack(f[0], f[1]), pack(f[2], f[3]));
    } else if constexpr (kN == 2) {
      *reinterpret_cast<uint32_t*>(p) = pack(f[0], f[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) p[i] = __float2bfloat16(f[i]);
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[c] = sum_r partial[r, c] over `rows` rows in order, rounded to T; one
// thread a column
template <typename T>
__global__ void column_sum_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float sum = 0.f;
  for (int r = 0; r < rows; ++r) sum += partial[static_cast<size_t>(r) * cols + c];
  Io<T>::template store<1>(out + c, &sum);
}

// SwinV2's cosine attention: rows [0, count) of a staged fp32 tile (rows
// `stride` floats apart) become x * (r * mul) rounded to T, with r =
// 1 / max(||x||, kCosEps) and ||x|| the root of the row's D squares summed
// in order; a row of zeros stays zeros. The intrinsics pin every rounding, so
// each kernel that stages a tile gets the same bits. One thread a row,
// threads `threads` apart; with `norms`, row r's ||x|| goes to norms[r].
constexpr float kCosEps = 1e-6f;

template <typename T, int D>
__device__ __forceinline__ void normalize_rows(float* tile, int stride,
                                               int count, float mul,
                                               int threads, float* norms) {
  for (int r = threadIdx.x; r < count; r += threads) {
    float* x = tile + r * stride;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) ss = __fmaf_rn(x[c], x[c], ss);
    const float norm = __fsqrt_rn(ss);
    const float m = __fmul_rn(__fdiv_rn(1.f, fmaxf(norm, kCosEps)), mul);
#pragma unroll
    for (int c = 0; c < D; ++c) x[c] = Io<T>::round(__fmul_rn(x[c], m));
    if (norms != nullptr) norms[r] = norm;
  }
}
