// Helpers of the LayerNorm kernels for rows whose size is a multiple of 4
// bytes but not of 16 (ln_fwd_ragged_kernel in layer_norm_fwd.cu,
// ln_bwd_ragged_kernel in layer_norm_bwd.cu): a row read and written in
// 4-byte words, one block of kRaggedThreads a row, and the block's sums.

#pragma once

#include "common.cuh"

namespace ln_ragged {

constexpr int kThreads = 128;     // a block: one row (forward) or rows in turn
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 4096;       // ops/layer_norm.py::_LN_RAGGED_MAX_D

// a 4-byte word of a row: two bf16 values or one fp32
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kN = 1;
  using U = float;
  __device__ static void get(U w, float* f) { f[0] = w; }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 2;
  using U = uint32_t;
  __device__ static void get(U w, float* f) { Io<__nv_bfloat16>::unpack(w, f); }
};

// kN fp32 values (one word of x's row) at a 4 kN-byte aligned p
template <int kN>
__device__ __forceinline__ void load_floats(const float* p, float* f) {
  if constexpr (kN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  } else {
    f[0] = *p;
  }
}

template <int kN>
__device__ __forceinline__ void store_floats(float* p, const float* f) {
  if constexpr (kN == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

// kN values rounded to To at p: one word of bf16 (or an fp32), or 8 bytes
// of fp32 for a bf16 word
template <typename To, int kN>
__device__ __forceinline__ void store_word(To* p, const float* f) {
  if constexpr (sizeof(To) == 4) {
    store_floats<kN>(reinterpret_cast<float*>(p), f);
  } else if constexpr (kN == 2) {
    *reinterpret_cast<uint32_t*>(p) = Io<__nv_bfloat16>::pack(f[0], f[1]);
  } else {
    *p = __float2bfloat16(f[0]);
  }
}

// (sum of a, sum of b) over the block's threads, warps summed in order; red
// holds kWarps pairs of shared memory and is free again on return
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    r.x += red[w].x;
    r.y += red[w].y;
  }
  __syncthreads();
  return r;
}

}  // namespace ln_ragged
