// The matrix products of K11 (xqkv_attention.cu, xqkv_attention_bwd.cu):
// C(m, n) = sum_k A(m, k) B(k, n) with fp32 accumulation, one 64 x 64 tile of
// C a block, each C element summed by one thread over k in one fixed order
// (so every run gives the same bits), then handed to the epilogue
//
//   out[m * ldo + n] = round_T(C(m, n) + bias[n])   (bias optional, in T)
//
// for m < M, n < N. The operands are read from device memory in their own
// layout: A(m, k) is a[m * lda + k] when kAk (k contiguous), else
// a[k * lda + m]; B(k, n) is b[n * ldb + k] when kBk, else b[k * ldb + n].
// The contiguous extent and the leading dimension must be multiples of 8 and
// the pointers 16-byte aligned (the caller checks): 16-byte loads along the
// contiguous dimension, rows past the edge staged as zeros.
//
// Design. Each k step stages a 64 x 32 slice of A and of B in shared memory,
// both k-contiguous whatever their layout in device memory (the transposed
// operands are written to shared memory one element at a time), then:
// - bf16: 4 warps in 2 x 2, each a 32 x 32 piece of C as 2 x 4 tensor-core
//   products mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fragments read
//   from shared memory as 32-bit pairs along k;
// - fp32: plain fp32 FMAs on the fp32 cores, each thread an 8 x 4 piece.
// No cp.async pipeline, no ldmatrix, no swizzle: a first version, right and
// simple, well below the tensor cores' rate (PERF.md).

#pragma once

#include <type_traits>

#include "common.cuh"

namespace gemm {

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;

// shared-memory row of one k slice: bf16 pads to 40 (80 bytes: the 32-bit
// fragment reads of 8 rows x 4 pairs fall in 32 different banks), fp32 to 33
template <typename T>
constexpr int kLdS = std::is_same_v<T, float> ? kBK + 1 : kBK + 8;

// rows [o0, o0 + 64) of the outer index (m or n) by k in [k0, k0 + 32) of an
// operand into s[outer][k]; kK: k is the contiguous dimension in memory
template <typename T, bool kK>
__device__ void stage(T* s, const T* __restrict__ src, int ld, int o0,
                      int outer_n, int k0, int k_n) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kLd = kLdS<T>;
  if constexpr (kK) {        // memory rows are outer, 32 / kVec vectors each
    constexpr int kPer = kBK / kVec;
    for (int i = threadIdx.x; i < kBM * kPer; i += kThreads) {
      const int r = i / kPer;
      const int c = (i % kPer) * kVec;
      const bool in = o0 + r < outer_n && k0 + c < k_n;
      const T* p = src + static_cast<size_t>(o0 + r) * ld + k0 + c;
      if constexpr (std::is_same_v<T, float>) {
        const float4 v = in ? *reinterpret_cast<const float4*>(p)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        T* d = s + r * kLd + c;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      } else {
        const uint4 v = in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(s + r * kLd + c) = v;   // 80-byte rows: aligned
      }
    }
  } else {                   // memory rows are k, 64 / kVec vectors each
    constexpr int kPer = kBM / kVec;
    for (int i = threadIdx.x; i < kBK * kPer; i += kThreads) {
      const int kr = i / kPer;
      const int c = (i % kPer) * kVec;
      const bool in = k0 + kr < k_n && o0 + c < outer_n;
      const T* p = src + static_cast<size_t>(k0 + kr) * ld + o0 + c;
      if constexpr (std::is_same_v<T, float>) {
        const float4 v = in ? *reinterpret_cast<const float4*>(p)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        s[(c + 0) * kLd + kr] = v.x; s[(c + 1) * kLd + kr] = v.y;
        s[(c + 2) * kLd + kr] = v.z; s[(c + 3) * kLd + kr] = v.w;
      } else {
        const uint4 v = in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[(c + j) * kLd + kr] = h[j];
      }
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ void put(T* __restrict__ out, int ldo,
                                    const T* __restrict__ bias, int m, int n,
                                    int M, int N, float v) {
  if (m >= M || n >= N) return;
  if (bias != nullptr) {
    float bv;
    if constexpr (std::is_same_v<T, float>) bv = bias[n];
    else bv = __bfloat162float(bias[n]);
    v += bv;
  }
  Io<T>::template store<1>(out + static_cast<size_t>(m) * ldo + n, &v);
}

template <typename T, bool kAk, bool kBk>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ a, int lda, const T* __restrict__ b, int ldb,
            T* __restrict__ out, int ldo, const T* __restrict__ bias, int M,
            int N, int K) {
  constexpr int kLd = kLdS<T>;
  __shared__ __align__(16) T a_s[kBM * kLd];
  __shared__ __align__(16) T b_s[kBN * kLd];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  if constexpr (std::is_same_v<T, float>) {
    const int tx = threadIdx.x % 16;   // columns tx + 16j
    const int ty = threadIdx.x / 16;   // rows ty + 8i
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      stage<T, kAk>(a_s, a, lda, m0, M, k0, K);
      stage<T, kBk>(b_s, b, ldb, n0, N, k0, K);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = a_s[(ty + 8 * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * kLd + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(out, ldo, bias, m0 + ty + 8 * i, n0 + tx + 16 * j, M, N, acc[i][j]);
  } else {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2;
    const int g = lane / 4, t = lane % 4;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      stage<T, kAk>(a_s, a, lda, m0, M, k0, K);
      stage<T, kBk>(b_s, b, ldb, n0, N, k0, K);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const T* p = a_s + (wm * 32 + i * 16 + g) * kLd + kk + 2 * t;
          af[i][0] = *reinterpret_cast<const uint32_t*>(p);
          af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
          af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* p = b_s + (wn * 32 + j * 8 + g) * kLd + kk + 2 * t;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + wm * 32 + i * 16 + g;
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        put(out, ldo, bias, m, n, M, N, acc[i][j][0]);
        put(out, ldo, bias, m, n + 1, M, N, acc[i][j][1]);
        put(out, ldo, bias, m + 8, n, M, N, acc[i][j][2]);
        put(out, ldo, bias, m + 8, n + 1, M, N, acc[i][j][3]);
      }
  }
}

// One product on `stream`; returns a cudaError_t (0 on success).
template <typename T, bool kAk, bool kBk>
int launch(const T* a, int lda, const T* b, int ldb, T* out, int ldo,
           const T* bias, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (M <= 0 || N <= 0 || K <= 0 || grid.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  gemm_kernel<T, kAk, kBk><<<grid, kThreads, 0, stream>>>(a, lda, b, ldb, out,
                                                         ldo, bias, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
