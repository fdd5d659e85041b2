// Helpers shared by the kernels in this directory: 16-byte loads of fp32 or
// bf16 into fp32 registers or kept as loaded, rounding to the storage type,
// Hopper's cp.async, ldmatrix and mma.sync for bf16, the mma fragments of
// row-major shared-memory tiles and of accumulators, ex2 and bf16x2 adds,
// warp reductions, the in-order column sum of an fp32 workspace, the row
// normalisation of the scaled-cosine attention (K12), and the programmatic
// dependent launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

template <typename T>
struct Raw;   // a 16-byte vector as loaded, bf16 kept packed

template <>
struct Raw<float> {
  float4 v;
  __device__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ void get(float* f) const { f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w; }
};

template <>
struct Raw<__nv_bfloat16> {
  uint4 v;
  __device__ void load(const __nv_bfloat16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ void get(float* f) const {
    Io<__nv_bfloat16>::unpack(v.x, f);
    Io<__nv_bfloat16>::unpack(v.y, f + 2);
    Io<__nv_bfloat16>::unpack(v.z, f + 4);
    Io<__nv_bfloat16>::unpack(v.w, f + 6);
  }
};

// Hopper's data movement and tensor-core instructions for bf16, as used by
// attention_fwd.cuh, attention_bwd.cuh, window_attention_bwd.cu and gemm.cuh.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with !in nothing is
// read and the 16 bytes become zeros (the source size is 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way (one fp32 row statistic)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives element (l / 4, 2 (l % 4) .. +1) of each (.trans: the
// elements (2 (l % 4) .. +1, l / 4))
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, a 16 x 16 (row) and b 16 x 8 (col) bf16, c fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of mma_bf16 from row-major bf16 tiles in shared memory (rows
// `ld` elements apart), as the attention backwards take them. Lane l's
// fragment row is g = l / 4 and its column pair 2t, t = l % 4.
//
// A (16 x 16): rows row0 .. +15, columns col0 .. +15 (the k index)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int ld, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_u32(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                          col0 + (lane >> 4) * 8));
}

// B of two n8 blocks whose n index is the tile's row: rows n0 .. +7 in
// b[0..1], n0 + 8 .. +15 in b[2..3]; columns col0 .. +15 are the k index
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                       int ld, int n0, int col0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, smem_u32(tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + col0 +
                          ((lane >> 3) & 1) * 8));
}

// B of two n8 blocks whose k index is the tile's row (rows k0 .. +15) and n
// index its column: columns n0 .. +7 in b[0..1], n0 + 8 .. +15 in b[2..3]
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* tile, int ld,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, smem_u32(tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                                n0 + (lane >> 4) * 8));
}

// the A fragment (16 x 16) of two n8 accumulator blocks side by side,
// rounded to bf16: the accumulator layout of one product is the A layout of
// the next
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = Io<__nv_bfloat16>::pack(c0[0], c0[1]);
  a[1] = Io<__nv_bfloat16>::pack(c0[2], c0[3]);
  a[2] = Io<__nv_bfloat16>::pack(c1[0], c1[1]);
  a[3] = Io<__nv_bfloat16>::pack(c1[2], c1[3]);
}

// c (two n8 blocks side by side, 16 x 16) += a b for the B fragments f of
// load_b or load_b_trans
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&f)[4]) {
  const uint32_t b0[2] = {f[0], f[1]};
  const uint32_t b1[2] = {f[2], f[3]};
  mma_bf16(c0, a, b0);
  mma_bf16(c1, a, b1);
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a + b on two packed bf16 pairs, each sum rounded once to bf16: the bits of
// rounding the fp32 sum, since the fp32 sum of two bf16 values is exact
// unless their exponents differ by more than 16, when both round to the
// larger operand
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const __nv_bfloat162 r = __hadd2(x, y);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

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

// A programmatic dependent launch on stream s: the kernel's blocks may be
// scheduled while the stream's previous kernel drains, and wait in
// griddepcontrol.wait for its writes, so a launch's own latency hides
// behind the kernel before it (the LayerNorm kernels)
template <typename... Params, typename... Args>
static cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                                    dim3 block, size_t smem, cudaStream_t s,
                                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
