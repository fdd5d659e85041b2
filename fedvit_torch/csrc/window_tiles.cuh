// The tiles of the windowed attention on the tensor cores, shared by its
// forward (window_attention.cu: K5, K12) and its backward
// (window_attention_bwd.cu: K6, K12's): bf16 tiles of 64 (or 32) rows of
// one head slice (d = 32) copied by cp.async, the rows' fp32 statistics, the fp32
// bias and mask tiles of the scores, and the normalisation of K12's q and k.
// The forward and the backward normalise a row with the same code
// (normalize_row), so K12's normalised operands have the same bits in both
// and the forward's log-sum-exp holds in the backward.
//
// Everything here is in an anonymous namespace: each kernel library keeps
// its own copy.

#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kD = 32;                  // head width (every SwinV2 built)
constexpr int kMmaWarps = 4;            // 16 rows of a 64-row tile each
constexpr int kMmaThreads = kMmaWarps * 32;  // the threads of one row's tiles
constexpr int kPair = 2;                // rows of one window a block takes
constexpr int kPairThreads = kPair * kMmaThreads;
constexpr int kTile = 64;               // rows of every bf16 tile
constexpr int kLd = kD + 8;             // padded bf16 row, elements (80 bytes)
constexpr int kT = kTile * kLd;         // elements of a tile
constexpr int kChunks = kD / 8;         // 16-byte chunks a row
constexpr int kRing = 3;                // streamed tiles in a ring
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int mma_tiles(int n) { return (n + kTile - 1) / kTile; }

// rows [row0, row0 + kRows) of a head slice (rows e elements apart) into a
// bf16 tile, asynchronously, by the kMmaThreads threads tid of one row;
// rows past n are zero-filled
template <int kRows = kTile>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int e,
                                          int row0, int n, int tid) {
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool in = row0 + r < n;
    cp_async16(smem_u32(dst + r * kLd + c),
               src + static_cast<size_t>(in ? row0 + r : 0) * e + c, in);
  }
}

// lse and delta of rows [row0, row0 + kTile) of one (r, h) into rows[0, 64)
// and rows[64, 128), asynchronously, thread tid < 128 one value; rows past n
// read 0
__device__ __forceinline__ void load_rows(float* rows, const float* lse,
                                          const float* delta, int row0, int n,
                                          int tid) {
  const int i = tid % kTile;
  const bool in = row0 + i < n;
  cp_async4(smem_u32(rows + tid), (tid < kTile ? lse : delta) + (in ? row0 + i : 0),
            in);
}

// One slot of the backward's rings: for each of the block's two rows two
// streamed bf16 tiles (q and dout, or k and v) and the lse and delta rows;
// and the fp32 bias and mask tiles of the 64 x 64 scores, rows kAddLd floats
// apart, which the two rows share.
constexpr int kAddLd = kTile + 4;
struct Slot {
  bf16 a[kPair][kT];
  bf16 b[kPair][kT];
  float rows[kPair][2 * kTile];
  float bias[kTile * kAddLd];
  float mask[kTile * kAddLd];
};
static_assert(sizeof(Slot) % 16 == 0, "slot alignment");

// bias[i][j] and mask[i][j] for queries row0 .. +63 and keys col0 ..
// +kCols-1 into bias_dst and mask_dst (rows ld floats apart), asynchronously,
// by the block's kPairThreads threads, 16 bytes a copy when N allows it;
// cells past n, and the whole mask when mask_w is null (no mask), read 0 and
// move no bytes. A null mask_dst stages the bias alone.
template <int kCols = kTile>
__device__ void load_add(float* bias_dst, float* mask_dst, int ld,
                         const float* bias_h, const float* mask_w, int row0,
                         int col0, int n) {
  const bool masked = mask_w != nullptr;
  if (n % 4 == 0) {
    for (int i = threadIdx.x; i < kTile * kCols / 4; i += kPairThreads) {
      const int r = i / (kCols / 4);
      const int c = (i % (kCols / 4)) * 4;
      const bool in = row0 + r < n && col0 + c < n;
      const size_t at = in ? static_cast<size_t>(row0 + r) * n + col0 + c : 0;
      cp_async16(smem_u32(bias_dst + r * ld + c), bias_h + at, in);
      if (mask_dst != nullptr)
        cp_async16(smem_u32(mask_dst + r * ld + c), masked ? mask_w + at : bias_h,
                   in && masked);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kCols; i += kPairThreads) {
      const int r = i / kCols;
      const int c = i % kCols;
      const bool in = row0 + r < n && col0 + c < n;
      const size_t at = in ? static_cast<size_t>(row0 + r) * n + col0 + c : 0;
      cp_async4(smem_u32(bias_dst + r * ld + c), bias_h + at, in);
      if (mask_dst != nullptr)
        cp_async4(smem_u32(mask_dst + r * ld + c), masked ? mask_w + at : bias_h,
                  in && masked);
    }
  }
}

// kCosine: a staged row (d = 32, bf16) becomes round(x * (r * mul)) with
// r = 1 / max(||x||, 1e-6), ||x|| the root of the row's 32 squares summed in
// order (the TPU kernel's order; the intrinsics pin every rounding); returns
// ||x||.
__device__ float normalize_row(bf16* row_ptr, float mul) {
  uint4* row = reinterpret_cast<uint4*>(row_ptr);
  float x[kD];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint4 u = row[c];
    Io<bf16>::unpack(u.x, x + 8 * c);
    Io<bf16>::unpack(u.y, x + 8 * c + 2);
    Io<bf16>::unpack(u.z, x + 8 * c + 4);
    Io<bf16>::unpack(u.w, x + 8 * c + 6);
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) ss = __fmaf_rn(x[c], x[c], ss);
  const float norm = __fsqrt_rn(ss);
  const float m = __fmul_rn(__fdiv_rn(1.f, fmaxf(norm, kCosEps)), mul);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    row[c] = make_uint4(
        Io<bf16>::pack(__fmul_rn(x[8 * c], m), __fmul_rn(x[8 * c + 1], m)),
        Io<bf16>::pack(__fmul_rn(x[8 * c + 2], m), __fmul_rn(x[8 * c + 3], m)),
        Io<bf16>::pack(__fmul_rn(x[8 * c + 4], m), __fmul_rn(x[8 * c + 5], m)),
        Io<bf16>::pack(__fmul_rn(x[8 * c + 6], m), __fmul_rn(x[8 * c + 7], m)));
  return norm;
}

// kCosine: every row of a staged 64-row tile through normalize_row; row r's
// norm to norms[r] when given. One thread a row, of the kMmaThreads threads
// tid of one row.
__device__ void normalize_tile(bf16* tile, float mul, float* norms, int tid) {
  for (int r = tid; r < kTile; r += kMmaThreads) {
    const float norm = normalize_row(tile + r * kLd, mul);
    if (norms != nullptr) norms[r] = norm;
  }
}

}  // namespace
