// The matrix products of K11 (xqkv_attention.cu, xqkv_attention_bwd.cu):
// C(m, n) = sum_k A(m, k) B(k, n) with fp32 accumulation, handed to the
// epilogue
//
//   out[m * ldo + n] = round_T(C(m, n) + bias[n])   (bias optional, in T)
//
// for m < M, n < N. The operands are read from device memory in their own
// layout: A(m, k) is a[m * lda + k] when kAk (k contiguous), else
// a[k * lda + m]; B(k, n) is b[n * ldb + k] when kBk, else b[k * ldb + n].
// M, N, K and every leading dimension must be multiples of 8 and the
// pointers 16-byte aligned (the caller checks): 16-byte loads along the
// contiguous dimension, rows past the edge staged as zeros. Each C element is
// summed in one fixed order, with no atomics, so every run gives the same
// bits.
//
// bf16 (wgmma_kernel): Hopper's warpgroup products. The products are bound
// by operations (K11's projection is 178.5 GFLOP at the ViT-B serving shape),
// so the design is the tensor cores' own:
// - one block a 128 x 128 tile of C, two warpgroups of 64 rows each, each
//   issuing wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate in
//   registers) with both operands read from shared memory; the blocks walk
//   n fastest, so those in flight share A's rows in L2 (K11's x is 77 MB at
//   the serving shape, W 3.5 MB);
// - k slices of 64 pass through a 5-stage ring in shared memory filled by
//   cp.async (16 bytes a thread; three slices in flight while the products
//   of two more run), each operand in its natural major-ness: a k-contiguous
//   operand as 128-byte rows (K-major), an m- or n-contiguous one as 64-wide
//   column blocks of 64 k rows (MN-major, wgmma's transpose flag), both in
//   the 128-byte swizzle (the 16-byte chunk c of row r lands at chunk
//   c ^ (r % 8)), so no operand is transposed by threads and the tensor
//   cores read without bank conflicts;
// - the epilogue adds the fp32 bias, rounds once to bf16 and stages the tile
//   in shared memory for 16-byte stores.
//
// fp32 (simt_kernel): plain FMAs on the fp32 cores, one 64 x 64 tile a block
// of 128 threads, each an 8 x 4 piece; each k step stages a 64 x 32 slice of
// A and of B k-contiguous in shared memory (a transposed operand one element
// at a time). Right and simple; no model path runs it at a size that matters.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace gemm {

// --- fp32: SIMT ---------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;

constexpr int kLdS = kBK + 1;   // shared-memory row of one k slice, floats

// rows [o0, o0 + 64) of the outer index (m or n) by k in [k0, k0 + 32) of an
// operand into s[outer][k]; kK: k is the contiguous dimension in memory
template <bool kK>
__device__ void stage(float* s, const float* __restrict__ src, int ld, int o0,
                      int outer_n, int k0, int k_n) {
  if constexpr (kK) {        // memory rows are outer, 8 vectors each
    for (int i = threadIdx.x; i < kBM * kBK / 4; i += kThreads) {
      const int r = i / (kBK / 4);
      const int c = (i % (kBK / 4)) * 4;
      const bool in = o0 + r < outer_n && k0 + c < k_n;
      const float* p = src + static_cast<size_t>(o0 + r) * ld + k0 + c;
      const float4 v = in ? *reinterpret_cast<const float4*>(p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      float* d = s + r * kLdS + c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
  } else {                   // memory rows are k, 16 vectors each
    for (int i = threadIdx.x; i < kBK * kBM / 4; i += kThreads) {
      const int kr = i / (kBM / 4);
      const int c = (i % (kBM / 4)) * 4;
      const bool in = k0 + kr < k_n && o0 + c < outer_n;
      const float* p = src + static_cast<size_t>(k0 + kr) * ld + o0 + c;
      const float4 v = in ? *reinterpret_cast<const float4*>(p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      s[(c + 0) * kLdS + kr] = v.x; s[(c + 1) * kLdS + kr] = v.y;
      s[(c + 2) * kLdS + kr] = v.z; s[(c + 3) * kLdS + kr] = v.w;
    }
  }
}

template <bool kAk, bool kBk>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b,
            int ldb, float* __restrict__ out, int ldo,
            const float* __restrict__ bias, int M, int N, int K) {
  __shared__ __align__(16) float a_s[kBM * kLdS];
  __shared__ __align__(16) float b_s[kBN * kLdS];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % 16;   // columns tx + 16j
  const int ty = threadIdx.x / 16;   // rows ty + 8i
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    stage<kAk>(a_s, a, lda, m0, M, k0, K);
    stage<kBk>(b_s, b, ldb, n0, N, k0, K);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a_s[(ty + 8 * i) * kLdS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * kLdS + k];
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
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 8 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      out[static_cast<size_t>(m) * ldo + n] = v;
    }
}

// --- bf16: wgmma --------------------------------------------------------------

constexpr int kTileM = 128, kTileN = 128, kTileK = 64;
constexpr int kStages = 5;
constexpr int kWgThreads = 256;                      // two warpgroups
constexpr int kOperandBytes = 128 * kTileK * 2;      // one operand's k slice
constexpr int kStageBytes = 2 * kOperandBytes;
constexpr int kBlockBytes = 64 * 128;                // 64 rows of 128 bytes
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + room to align
constexpr int kEpiLd = kTileN + 8;                   // staged output row, bf16

// one operand's k slice [k0, k0 + 64) x outer [o0, o0 + 128) into the
// swizzled layout at shared address s. kK (K-major): outer row r at r * 128
// bytes; MN-major: k row kr of column block o / 64 at (o / 64) * 8 KB +
// kr * 128 bytes. The 16-byte chunk c of a 128-byte row r goes to chunk
// c ^ (r % 8). Rows or columns past the edge are zero-filled.
template <bool kK>
__device__ __forceinline__ void load_operand(uint32_t s,
                                             const __nv_bfloat16* __restrict__ src,
                                             int ld, int o0, int outer_n,
                                             int k0, int k_n) {
#pragma unroll
  for (int j = 0; j < 1024 / kWgThreads; ++j) {
    const int i = threadIdx.x + j * kWgThreads;
    if constexpr (kK) {
      const int r = i >> 3, c = i & 7;
      const bool in = o0 + r < outer_n && k0 + 8 * c < k_n;
      const __nv_bfloat16* p =
          src + (in ? static_cast<size_t>(o0 + r) * ld + k0 + 8 * c : 0);
      cp_async16(s + r * 128 + ((c ^ (r & 7)) << 4), p, in);
    } else {
      const int kr = i >> 4, cc = i & 15;
      const int c = cc & 7;
      const bool in = k0 + kr < k_n && o0 + 8 * cc < outer_n;
      const __nv_bfloat16* p =
          src + (in ? static_cast<size_t>(k0 + kr) * ld + o0 + 8 * cc : 0);
      cp_async16(s + (cc >> 3) * kBlockBytes + kr * 128 + ((c ^ (kr & 7)) << 4),
                 p, in);
    }
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units. K-major: the stride
// offset steps 8 rows (1 KB), the leading one is unused (1). MN-major: the
// leading offset steps a 64-wide column block (8 KB), the stride one 8 k rows
// (1 KB).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the descriptor of k16 step kk of an operand slice at s (64 or 128 outer)
template <bool kK>
__device__ __forceinline__ uint64_t operand_desc(uint32_t s, int kk) {
  if constexpr (kK) return smem_desc(s + kk * 32, 16, 1024);
  else return smem_desc(s + kk * 16 * 128, kBlockBytes, 1024);
}

// d += A B over one k16 step: A 64 x 16, B 16 x 128, from shared memory;
// kTransA / kTransB: the operand is MN-major
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <bool kAk, bool kBk>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_kernel(const __nv_bfloat16* __restrict__ a, int lda,
             const __nv_bfloat16* __restrict__ b, int ldb,
             __nv_bfloat16* __restrict__ out, int ldo,
             const __nv_bfloat16* __restrict__ bias, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms on 1 KB
  const int tiles_n = (N + kTileN - 1) / kTileN;
  const int m0 = (blockIdx.x / tiles_n) * kTileM;   // n fastest: the blocks in
  const int n0 = (blockIdx.x % tiles_n) * kTileN;   // flight share A's rows in L2
  const int slices = (K + kTileK - 1) / kTileK;
  const int wg = threadIdx.x >> 7;

  auto load_slice = [&](int slot, int i) {
    const uint32_t sa = base + slot * kStageBytes;
    const int k0 = i * kTileK;
    load_operand<kAk>(sa, a, lda, m0, M, k0, K);
    load_operand<kBk>(sa + kOperandBytes, b, ldb, n0, N, k0, K);
  };
  // slices kAhead ahead are in flight; the slot refilled at step i held
  // slice i - 2, whose products every warpgroup has waited for, so the
  // products of slices i - 1 and i may run while it fills
  constexpr int kAhead = kStages - 2;
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < slices) load_slice(i, i);
    cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<kAhead - 1>();    // slice i has landed (this thread's part)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                // ... every thread's; slice i - 2 is consumed
    if (i + kAhead < slices) load_slice((i + kAhead) % kStages, i + kAhead);
    cp_async_commit();
    const uint32_t sa = base + (i % kStages) * kStageBytes + wg * kBlockBytes;
    const uint32_t sb = base + (i % kStages) * kStageBytes + kOperandBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_m64n128k16<kAk ? 0 : 1, kBk ? 0 : 1>(
          acc, operand_desc<kAk>(sa, kk), operand_desc<kBk>(sb, kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // slice i - 1's
    fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // accumulator element 4j + 2r + c: row 16 w + lane / 4 + 8 r of the
  // warpgroup's 64, column 8 j + 2 (lane % 4) + c
  const int lane = threadIdx.x & 31;
  const int row = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: stage the bf16 tile there
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw));
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + col;
    float bx[2] = {0.f, 0.f};
    if (bias != nullptr && n < N) Io<__nv_bfloat16>::load2(bias + n, bx);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(st + (row + 8 * r) * kEpiLd + 8 * j + col) =
          Io<__nv_bfloat16>::pack(acc[4 * j + 2 * r] + bx[0],
                                  acc[4 * j + 2 * r + 1] + bx[1]);
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < kTileM * kTileN / 8; i += kWgThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * ldo + n0 + c) =
          *reinterpret_cast<const uint4*>(st + r * kEpiLd + c);
  }
}

// One product on `stream`; returns a cudaError_t (0 on success). static, as
// attention_fwd.cuh's launch_mma: each library sets the shared-memory
// attribute on its own copy of the kernel.
template <typename T, bool kAk, bool kBk>
static int launch(const T* a, int lda, const T* b, int ldb, T* out, int ldo,
                  const T* bias, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same_v<T, float>) {
    const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    simt_kernel<kAk, kBk><<<grid, kThreads, 0, stream>>>(a, lda, b, ldb, out,
                                                        ldo, bias, M, N, K);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        wgmma_kernel<kAk, kBk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);  // once per instantiation and library
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long tiles = static_cast<long long>((N + kTileN - 1) / kTileN) *
                            ((M + kTileM - 1) / kTileM);
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    wgmma_kernel<kAk, kBk><<<static_cast<unsigned>(tiles), kWgThreads,
                             kSmemBytes, stream>>>(
        a, lda, b, ldb, out, ldo, bias, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
