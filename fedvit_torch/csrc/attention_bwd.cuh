// Backward of the multi-head attention on q, k and v read in place, with two
// compile-time flags: kBias adds the projection bias on load, kSum sums the
// bias gradient. K3 takes both, K10's and K9's backwards neither, and the
// attention half of K11's backward (xqkv_attention_bwd.cu) kSum alone, for
// its db. The sources qkvb_attention_bwd.cu and xqkv_attention_bwd.cu hold
// the entry points and their design notes.
//
//   inputs   q, k, v (B, N, *) at row stride ld, as attention_fwd.cuh takes
//            them (the packed (B, N, 3E) projection output at ld = 3E, or
//            three flat (B, N, E) tensors at ld = E); bias (3E,) in their
//            type (kBias only); out and dout (B, N, E); lse (B, H, N) fp32
//   outputs  dq, dk, dv in the inputs' type and layout: three base pointers
//            at the same row stride ld (the thirds of a packed dqkv, or three
//            flat tensors)
//            kSum: dbias (3E,) fp32 = sum over the B*N rows of [dq | dk | dv]
//            rounded to their type
//
//   P = exp(s - lse), s = (q + b_q)(k + b_k)^T / sqrt(d)
//   delta_i = sum_c dout_ic out_ic              (= sum_j dP_ij P_ij)
//   dS = P * (dout (v + b_v)^T - delta)
//   dq = dS (k + b_k) / sqrt(d),  dk = dS^T (q + b_q) / sqrt(d),  dv = P^T dout
//
// Launches, in order on the caller's stream:
//   1. delta: one warp per (b, row, head), fp32.
//   2. dk, dv: one block per (b, h, 64-key tile); it walks the query tiles and
//      keeps its 64 x d dk and dv sums in registers.
//   3. dq: one block per (b, h, 64-query tile); it walks the key tiles.
//      Two passes instead of fp32 atomics on dq, so the sums are taken in one
//      order and every run gives the same bits.
//   4. kSum only, dbias: passes 2 and 3 write, per (b, 64-row tile), the
//      column sums of the dqkv they stored (rounded to its type) into an fp32
//      (B * tiles, 3E) buffer; this pass sums its rows. The TPU kernel instead
//      carried dbias in a resident block across its sequential grid, which
//      Hopper's unordered blocks cannot do.
// Rows and keys past N (the ragged last tile at N = 197 = 3*64 + 5 and
// 577 = 9*64 + 1) are zero-filled and get P = 0 and dS = 0; their lse and
// delta read 0, so no inf - inf appears.
//
// bf16 (dkdv_mma_kernel, dq_mma_kernel): FlashAttention-2's backward on the
// tensor cores, replacing the TPU kernels named in qkvb_attention_bwd.cu.
// The kernel is bound by bytes (qkv, dout and dqkv once: 0.040 ms at the ViT-B
// micro-batch of 64 on an H100; 10 B H N^2 d operations take 0.019 ms at the
// bf16 peak), so mma.sync gives it tensor-core rate enough, as for the
// forward (attention_fwd.cuh), and the design recomputes S in both passes
// rather than move dq partials through device memory:
// - 128 threads a block, warp w owning rows 16w .. +15 of the block's 64-row
//   tile (keys in pass 2, queries in pass 3); the streamed tiles (q and dout,
//   or k and v) pass through a 3-slot cp.async ring of bf16 tiles, rows padded
//   to D + 8 elements, copies two tiles ahead, one barrier a tile; pass 2's
//   slots also carry the tile's lse and delta (4-byte cp.async);
// - pass 2 computes S^T = K Q^T and dP^T = V dO^T (mma.sync.m16n8k16, bf16
//   in, fp32 sums; K and V A-fragments by ldmatrix, Q and dO B-fragments by
//   ldmatrix), so P^T and dS^T come out in the accumulator layout, which is
//   the A layout of dV += P^T dO and dK += dS^T Q: they are rounded to bf16
//   there, in registers, and dO and Q are read transposed (ldmatrix.trans);
// - pass 3 keeps its Q and dO fragments in registers, computes S = Q K^T and
//   dP = dO V^T and dQ += dS K with K read transposed;
// - P and dS are rounded to bf16 before their products and every sum is
//   fp32, as the TPU kernel does (the SIMT kernels below keep them fp32);
//   d = 80 takes five k16 steps of 16 columns;
// - kBias: the bias slices wait in shared memory and are added to the Q, K
//   and V fragments as they are read, by bf16x2 adds rounded once (the bits
//   of round(x + b));
// - the output tile is staged through the block's own tile (K, V or Q, in
//   registers or consumed by then) and stored 16 bytes a thread; kSum sums
//   the staged, rounded columns in row order.
//
// fp32 (dkdv_kernel, dq_kernel): plain SIMT code on the fp32 cores, written to
// be right and readable; no model path runs fp32 attention at a size that
// matters. Scores, P, dP and dS stay fp32. It recomputes S in both passes
// (7 N^2 d products per (b, h) instead of 5). Each block stages its own tile
// and the streamed tiles as padded fp32 rows in dynamic shared memory; 256
// threads (16 x 16) each own a 4 x (d/16) piece of every 64 x d product
// (4 x 4 at d = 64, 4 x 5 at d = 80) and a 4 x 4 piece of every 64 x 64
// score tile, with the streamed-row index interleaved (thread column tx
// takes rows tx, tx+16, ...) so that neighbouring threads read neighbouring
// rows without bank conflicts.

#pragma once

#include <math.h>

#include "common.cuh"

namespace attn_bwd {

constexpr int kTile = 64;            // rows of a query or key tile
constexpr int kThreads = 256;
constexpr int kPStride = kTile + 1;  // padded fp32 row of P and dS

template <int D>
constexpr int kStrideOf = D + 4;  // padded fp32 row of q, k, v, dout

// rows [row0, row0 + kTile) of a head slice (src points at row 0 of it, rows
// ld elements apart; plus the bias slice rounded to T when `bias` is given)
// into fp32 shared memory; rows past n are zeros
template <typename T, int D>
__device__ void stage(float* dst, const T* __restrict__ src,
                      const T* __restrict__ bias, int ld, int row0, int n) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float x[kVec];
    if (row0 + r < n) {
      Io<T>::load(src + static_cast<size_t>(row0 + r) * ld + c, x);
      if (bias != nullptr) {
        float bv[kVec];
        Io<T>::load(bias + c, bv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = Io<T>::round(x[j] + bv[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * kStrideOf<D> + c);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      d4[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// kC consecutive floats of shared memory (16-byte reads when kC is 4)
template <int kC>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[kC]) {
  if constexpr (kC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = p[c];
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// For the 64x64 tile pair (query rows i = ty + 16a, key rows j = tx + 16b):
// P = exp(s * scale - lse_i) and dS = P * (dP - delta_i), into p_s / ds_s
// (p_s may be null when only dS is needed). Masked entries get 0.
template <int D>
__device__ void scores(const float* q_s, const float* k_s, const float* do_s,
                       const float* v_s, const float* lse_s, const float* dl_s,
                       float* p_s, float* ds_s, int nq, int nk, float scale) {
  constexpr int kStride = kStrideOf<D>;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 kb[4], vb[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * b) * kStride + c);
      vb[b] = *reinterpret_cast<const float4*>(v_s + (tx + 16 * b) * kStride + c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + (ty + 16 * a) * kStride + c);
      const float4 da = *reinterpret_cast<const float4*>(do_s + (ty + 16 * a) * kStride + c);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] += dot4(qa, kb[b]);
        dp[a][b] += dot4(da, vb[b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      const bool valid = i < nq && j < nk;
      const float p = valid ? __expf(s[a][b] * scale - lse_s[i]) : 0.f;
      if (p_s != nullptr) p_s[i * kPStride + j] = p;
      ds_s[i * kPStride + j] = p * (dp[a][b] - dl_s[i]);
    }
  }
}

// lse and delta of query rows [q0, q0 + kTile) of (b, h) into shared memory
__device__ void stage_rows(float* lse_s, float* dl_s, const float* __restrict__ lse,
                           const float* __restrict__ delta, size_t bh, int q0, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = q0 + i < n;
    lse_s[i] = in ? lse[bh * n + q0 + i] : 0.f;
    dl_s[i] = in ? delta[bh * n + q0 + i] : 0.f;
  }
}

// Write rows ty + 16a (< n - row0) of a 64 x D fp32 tile, times `mul`, to
// the head slice at dst (row 0 of it; rows ld elements apart), rounded to T;
// with kSum also the column sums of the rounded values to partial[c], the
// tile's slice of its row of the workspace. red is kTile*16 floats of shared
// memory (at least D*16).
template <typename T, int D, bool kSum>
__device__ void write_tile(const float (&acc)[4][D / 16], float mul,
                           T* __restrict__ dst, float* __restrict__ partial,
                           float* red, int ld, int row0, int n) {
  constexpr int kC = D / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float colsum[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) colsum[c] = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty + 16 * a;
    if (r < n) {
      float v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        v[c] = Io<T>::round(acc[a][c] * mul);
        colsum[c] += v[c];
      }
      Io<T>::template store<kC>(dst + static_cast<size_t>(r) * ld + tx * kC, v);
    }
  }
  if constexpr (kSum) {
    __syncthreads();  // red is free
#pragma unroll
    for (int c = 0; c < kC; ++c) red[(tx * kC + c) * 16 + ty] = colsum[c];
    __syncthreads();
    if (threadIdx.x < D) {
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) sum += red[threadIdx.x * 16 + t];
      partial[threadIdx.x] = sum;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int n, int e, int heads, int total) {
  const int w = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= total) return;
  const int h = w % heads;
  const int row = (w / heads) % n;
  const int b = w / (heads * n);
  const size_t at = (static_cast<size_t>(b) * n + row) * e + h * D;
  float s = 0.f;
  for (int c = lane * 2; c < D; c += 64) {
    float o[2], g[2];
    Io<T>::load2(out + at + c, o);
    Io<T>::load2(dout + at + c, g);
    s += o[0] * g[0] + o[1] * g[1];
  }
  s = warp_sum(s);
  if (lane == 0) delta[(static_cast<size_t>(b) * heads + h) * n + row] = s;
}

// the head-h slices of one batch row's operands, and of the bias (kBias) and
// of the tile's row of the dbias workspace (kSum), which are null otherwise
template <typename T>
struct Slices {
  const T* q; const T* k; const T* v; const T* dout;
  const T* bq; const T* bk; const T* bv;
  float* pq; float* pk; float* pv;
};

template <typename T, int D, bool kBias, bool kSum>
__device__ Slices<T> slices(const T* q, const T* k, const T* v, int ld,
                            const T* bias, const T* dout, float* partial,
                            int n, int e, int b, int h, int tile) {
  const size_t at = static_cast<size_t>(b) * n * ld + h * D;
  const int col = h * D;
  // one workspace row of 3E per (b, tile), as workspace_rows counts them
  float* prow = kSum ? partial + (static_cast<size_t>(b) * gridDim.x + tile) * 3 * e
                     : nullptr;
  return {q + at, k + at, v + at, dout + static_cast<size_t>(b) * n * e + col,
          kBias ? bias + col : nullptr, kBias ? bias + e + col : nullptr,
          kBias ? bias + 2 * e + col : nullptr,
          kSum ? prow + col : nullptr, kSum ? prow + e + col : nullptr,
          kSum ? prow + 2 * e + col : nullptr};
}

template <typename T, int D, bool kBias, bool kSum>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, int ld, const T* __restrict__ bias,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk,
            T* __restrict__ dv, float* __restrict__ partial, int n, int e,
            float scale) {
  constexpr int kStride = kStrideOf<D>;
  constexpr int kC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * kStride;
  float* q_s = v_s + kTile * kStride;
  float* do_s = q_s + kTile * kStride;
  float* p_s = do_s + kTile * kStride;
  float* ds_s = p_s + kTile * kPStride;
  float* lse_s = ds_s + kTile * kPStride;
  float* dl_s = lse_s + kTile;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const size_t bh = static_cast<size_t>(b) * gridDim.y + h;
  const Slices<T> sl = slices<T, D, kBias, kSum>(q, k, v, ld, bias, dout,
                                                 partial, n, e, b, h, blockIdx.x);
  const T* no_bias = nullptr;

  stage<T, D>(k_s, sl.k, sl.bk, ld, k0, n);
  stage<T, D>(v_s, sl.v, sl.bv, ld, k0, n);
  const int nk = min(kTile, n - k0);

  float gk[4][kC], gv[4][kC];  // dk, dv: key rows ty + 16a, columns tx*kC + c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) gk[a][c] = gv[a][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    stage<T, D>(q_s, sl.q, sl.bq, ld, q0, n);
    stage<T, D>(do_s, sl.dout, no_bias, e, q0, n);
    stage_rows(lse_s, dl_s, lse, delta, bh, q0, n);
    __syncthreads();
    const int nq = min(kTile, n - q0);
    // S^T would be the natural layout here; scores() writes P[i][j] with the
    // query row first, and the loop below reads its column j
    scores<D>(q_s, k_s, do_s, v_s, lse_s, dl_s, p_s, ds_s, nq, nk, scale);
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      float g[kC], x[kC];
      load_cols<kC>(do_s + i * kStride + tx * kC, g);
      load_cols<kC>(q_s + i * kStride + tx * kC, x);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = p_s[i * kPStride + ty + 16 * a];
        const float ds = ds_s[i * kPStride + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          gv[a][c] += p * g[c];
          gk[a][c] += ds * x[c];
        }
      }
    }
  }

  const size_t at = static_cast<size_t>(b) * n * ld + h * D;
  write_tile<T, D, kSum>(gk, scale, dk + at, sl.pk, p_s, ld, k0, n);
  write_tile<T, D, kSum>(gv, 1.f, dv + at, sl.pv, p_s, ld, k0, n);
}

template <typename T, int D, bool kBias, bool kSum>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, int ld, const T* __restrict__ bias,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq,
          float* __restrict__ partial, int n, int e, float scale) {
  constexpr int kStride = kStrideOf<D>;
  constexpr int kC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * kStride;
  float* k_s = do_s + kTile * kStride;
  float* v_s = k_s + kTile * kStride;
  float* ds_s = v_s + kTile * kStride;
  float* lse_s = ds_s + kTile * kPStride;
  float* dl_s = lse_s + kTile;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const size_t bh = static_cast<size_t>(b) * gridDim.y + h;
  const Slices<T> sl = slices<T, D, kBias, kSum>(q, k, v, ld, bias, dout,
                                                 partial, n, e, b, h, blockIdx.x);
  const T* no_bias = nullptr;

  stage<T, D>(q_s, sl.q, sl.bq, ld, q0, n);
  stage<T, D>(do_s, sl.dout, no_bias, e, q0, n);
  stage_rows(lse_s, dl_s, lse, delta, bh, q0, n);
  const int nq = min(kTile, n - q0);

  float gq[4][kC];  // dq: query rows ty + 16a, columns tx*kC + c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) gq[a][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    stage<T, D>(k_s, sl.k, sl.bk, ld, k0, n);
    stage<T, D>(v_s, sl.v, sl.bv, ld, k0, n);
    __syncthreads();
    const int nk = min(kTile, n - k0);
    scores<D>(q_s, k_s, do_s, v_s, lse_s, dl_s, nullptr, ds_s, nq, nk, scale);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float x[kC];
      load_cols<kC>(k_s + j * kStride + tx * kC, x);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = ds_s[(ty + 16 * a) * kPStride + j];
#pragma unroll
        for (int c = 0; c < kC; ++c) gq[a][c] += ds * x[c];
      }
    }
  }

  write_tile<T, D, kSum>(gq, scale, dq + static_cast<size_t>(b) * n * ld + h * D,
                         sl.pq, ds_s, ld, q0, n);
}

// --- bf16: FlashAttention-2's backward on the tensor cores -------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;  // 16 rows of the block's tile a warp
constexpr int kRing = 3;                     // streamed tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of dkdv_mma_kernel and dq_mma_kernel: the block's own two
// tiles, the ring's pairs of streamed tiles (rows of D + 8 bf16), the ring's
// lse and delta rows (dkdv only; dq reads its rows' into registers) and the
// bias slices
template <int D>
constexpr int mma_smem_bytes() {
  return (2 + 2 * kRing) * kTile * (D + 8) * 2 + kRing * 2 * kTile * 4 + 3 * D * 2;
}

// The block's state over one (batch row, head): the head slices of q, k, v
// and dout, the bias slices staged in shared memory, and the tile loaders.
template <int D, bool kBias>
struct MmaBlock {
  using bf16 = __nv_bfloat16;
  static constexpr int kLd = D + 8;    // padded row, elements
  static constexpr int kChunks = D / 8;
  const bf16* q; const bf16* k; const bf16* v; const bf16* dout;
  int ld, e, n;
  const bf16* bias_s;                  // [b_q | b_k | b_v] of head h (kBias)

  // rows [row0, row0 + kTile) of a head slice (rows `stride` apart) into a
  // tile; rows past n are zero-filled
  __device__ void load(bf16* dst, const bf16* src, int stride, int row0) const {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool in = row0 + r < n;
      cp_async16(smem_u32(dst + r * kLd + c),
                 src + static_cast<size_t>(in ? row0 + r : 0) * stride + c, in);
    }
  }
  // kBias: b[c] and b[c + 1] of bias part `part` as one bf16 pair, and b[c]
  // twice
  __device__ uint32_t bias2(int part, int c) const {
    return *reinterpret_cast<const uint32_t*>(bias_s + part * D + c);
  }
  __device__ uint32_t bias_twice(int part, int c) const {
    const uint32_t x = *reinterpret_cast<const uint16_t*>(bias_s + part * D + c);
    return x | (x << 16);
  }
  // A fragment of rows row0 .. +15 and head columns 16 kk .. +15 of a tile,
  // with bias part `part` added (part < 0: none)
  __device__ void frag_a(uint32_t (&a)[4], const bf16* tile, int row0, int kk,
                         int part) const {
    load_a(a, tile, kLd, row0, kk * 16);
    if (kBias && part >= 0) {
      const int t = threadIdx.x & 3;
      const uint32_t b0 = bias2(part, kk * 16 + 2 * t);
      const uint32_t b1 = bias2(part, kk * 16 + 8 + 2 * t);
      a[0] = add_bf16x2(a[0], b0); a[1] = add_bf16x2(a[1], b0);
      a[2] = add_bf16x2(a[2], b1); a[3] = add_bf16x2(a[3], b1);
    }
  }
  // B fragments of tile rows n0 .. +15 (the n index) and head columns
  // 16 kk .. +15 (the k index), with bias part `part` added
  __device__ void frag_b(uint32_t (&f)[4], const bf16* tile, int n0, int kk,
                         int part) const {
    load_b(f, tile, kLd, n0, kk * 16);
    if (kBias && part >= 0) {
      const int t = threadIdx.x & 3;
      const uint32_t b0 = bias2(part, kk * 16 + 2 * t);
      const uint32_t b1 = bias2(part, kk * 16 + 8 + 2 * t);
      f[0] = add_bf16x2(f[0], b0); f[1] = add_bf16x2(f[1], b1);
      f[2] = add_bf16x2(f[2], b0); f[3] = add_bf16x2(f[3], b1);
    }
  }
  // B fragments of tile rows k0 .. +15 (the k index) and head columns
  // 16 dp .. +15 (the n index), with bias part `part` added
  __device__ void frag_bt(uint32_t (&f)[4], const bf16* tile, int k0, int dp,
                          int part) const {
    load_b_trans(f, tile, kLd, k0, dp * 16);
    if (kBias && part >= 0) {
      const int g = (threadIdx.x & 31) >> 2;
      const uint32_t b0 = bias_twice(part, dp * 16 + g);
      const uint32_t b1 = bias_twice(part, dp * 16 + 8 + g);
      f[0] = add_bf16x2(f[0], b0); f[1] = add_bf16x2(f[1], b0);
      f[2] = add_bf16x2(f[2], b1); f[3] = add_bf16x2(f[3], b1);
    }
  }
};

// Write a warp's 16 x D fp32 accumulator tile (rows row0 .. +15 of the
// block's 64-row tile), times `mul` and rounded to bf16, into the staging
// tile `st`; after the block's barrier, write_staged stores its rows below
// n - base and (kSum) their column sums.
template <int D>
__device__ void stage_acc(__nv_bfloat16* st, const float (&acc)[D / 8][4],
                          float mul, int row0) {
  constexpr int kLd = D + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(st + (row0 + g) * kLd + j * 8 + 2 * t) =
        Io<__nv_bfloat16>::pack(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(st + (row0 + g + 8) * kLd + j * 8 + 2 * t) =
        Io<__nv_bfloat16>::pack(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// The staged 64 x D tile's rows r < count to dst (row r at dst + r * ld),
// 16 bytes a thread; kSum: the fp32 column sums of those rounded rows, in
// row order, to partial[c]
template <int D, bool kSum>
__device__ void write_staged(const __nv_bfloat16* st, __nv_bfloat16* dst,
                             float* partial, int ld, int count) {
  constexpr int kLd = D + 8;
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (r < count)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + c) =
          *reinterpret_cast<const uint4*>(st + r * kLd + c);
  }
  if constexpr (kSum) {
    for (int c = threadIdx.x; c < D; c += kMmaThreads) {
      float sum = 0.f;
      for (int r = 0; r < count; ++r) sum += __bfloat162float(st[r * kLd + c]);
      partial[c] = sum;
    }
  }
}

// dk and dv of one (64-key tile, head, batch row). Warp w owns keys
// 16w .. +15 of the tile. For each query tile of the ring it computes
// S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in the accumulator
// layout, which is the A layout of dV += P^T dO and dK += dS^T Q (dO and Q
// read transposed by ldmatrix.trans). P^T and dS^T are rounded to bf16 there,
// as the TPU kernel rounds P and dS before its products.
template <int D, bool kBias, bool kSum>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, int ld,
                const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ partial, int n, int e, float scale) {
  using bf16 = __nv_bfloat16;
  using Blk = MmaBlock<D, kBias>;
  constexpr int kLd = Blk::kLd;
  constexpr int kKd = D / 16;   // k16 steps over the head width
  constexpr int kNd = D / 8;    // n8 blocks of dk and dv
  constexpr int kT = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kT;
  bf16* q_ring = v_s + kT;                 // kRing tiles
  bf16* do_ring = q_ring + kRing * kT;     // kRing tiles
  float* row_ring = reinterpret_cast<float*>(do_ring + kRing * kT);  // kRing x (lse, delta)
  bf16* bias_s = reinterpret_cast<bf16*>(row_ring + kRing * 2 * kTile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const size_t at = static_cast<size_t>(b) * n * ld + h * D;
  const size_t at_o = static_cast<size_t>(b) * n * e + h * D;
  const size_t bh = (static_cast<size_t>(b) * gridDim.y + h) * n;
  const Blk blk{q + at, k + at, v + at, dout + at_o, ld, e, n, bias_s};

  // query tile `it` of q, dout and its lse and delta into ring slot `slot`
  auto load_tile = [&](int it, int slot) {
    const int q0 = it * kTile;
    blk.load(q_ring + slot * kT, blk.q, ld, q0);
    blk.load(do_ring + slot * kT, blk.dout, e, q0);
    float* rows = row_ring + slot * 2 * kTile;
    const int i = tid % kTile;
    const bool in = q0 + i < n;
    const float* src = (tid < kTile ? lse : delta) + bh + (in ? q0 + i : 0);
    cp_async4(smem_u32(rows + tid), src, in);   // tid < 2 kTile = kMmaThreads
  };

  const int tiles = (n + kTile - 1) / kTile;
  blk.load(k_s, blk.k, ld, k0);
  blk.load(v_s, blk.v, ld, k0);
  if constexpr (kBias) {
    if (tid < 3 * Blk::kChunks) {
      const int part = tid / Blk::kChunks, c = (tid % Blk::kChunks) * 8;
      cp_async16(smem_u32(bias_s + part * D + c), bias + part * e + h * D + c, true);
    }
  }
  load_tile(0, 0);
  cp_async_commit();
  if (tiles > 1) load_tile(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();   // K, V, the bias and query tile 0 have landed

  const int w0 = warp * 16;             // this warp's first key in the tile
  const bool active = k0 + w0 < n;      // a warp of keys past n only waits
  const float scale2 = scale * kLog2e;  // P = 2^(s scale2 - lse log2 e)
  float acc_k[kNd][4], acc_v[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  // Query tile `it` is visible to every warp when step `it` starts; the step
  // starts tile it + 2's copies into the slot tile it - 1 left.
  for (int it = 0; it < tiles; ++it) {
    const int slot = it % kRing;
    const bf16* qt = q_ring + slot * kT;
    const bf16* dot = do_ring + slot * kT;
    const float* lse_t = row_ring + slot * 2 * kTile;
    const float* dl_t = lse_t + kTile;
    if (it + 2 < tiles) load_tile(it + 2, (it + 2) % kRing);
    cp_async_commit();
    if (active) {
      const int q0 = it * kTile;
      // 16-query chunks of this tile that hold a query below n
      const int chunks = min(kTile, n - q0 + 15) / 16;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk) {
        uint32_t ka[4], va[4];
        blk.frag_a(ka, k_s, w0, kk, 1);
        blk.frag_a(va, v_s, w0, kk, 2);
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (j2 >= chunks) break;
          uint32_t f[4];
          blk.frag_b(f, qt, j2 * 16, kk, 0);
          mma_pair(s[2 * j2], s[2 * j2 + 1], ka, f);
          blk.frag_b(f, dot, j2 * 16, kk, -1);
          mma_pair(dp[2 * j2], dp[2 * j2 + 1], va, f);
        }
      }
      // P^T and dS^T: element c of block j is key g (+8 for c >= 2), query
      // 8j + 2t (+1 for odd c); queries past n get P = 0 and dS = 0
      const bool tail = q0 + kTile > n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = j * 8 + 2 * t + (c & 1);
          float p = exp2_ftz(fmaf(s[j][c], scale2, -lse_t[i] * kLog2e));
          if (tail && q0 + i >= n) p = 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - dl_t[i]);
        }
      // dV += P^T dO and dK += dS^T Q over the tile's 16-query chunks
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= chunks) break;
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < kKd; ++d2) {
          uint32_t f[4];
          blk.frag_bt(f, dot, kk * 16, d2, -1);
          mma_pair(acc_v[2 * d2], acc_v[2 * d2 + 1], pa, f);
          blk.frag_bt(f, qt, kk * 16, d2, 0);
          mma_pair(acc_k[2 * d2], acc_k[2 * d2 + 1], da, f);
        }
      }
    }
    cp_async_wait<1>();   // this thread's copies of tile it + 1 have landed
    __syncthreads();      // ... every thread's; tile it is consumed
  }

  // K and V are consumed: their tiles stage dk and dv
  stage_acc<D>(k_s, acc_k, scale, w0);
  stage_acc<D>(v_s, acc_v, 1.f, w0);
  __syncthreads();
  // one workspace row of 3E per (b, tile), as workspace_rows counts them
  float* prow = kSum ? partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 3 * e + h * D
                     : nullptr;
  const int count = min(kTile, n - k0);
  write_staged<D, kSum>(k_s, dk + at + static_cast<size_t>(k0) * ld,
                        kSum ? prow + e : nullptr, ld, count);
  write_staged<D, kSum>(v_s, dv + at + static_cast<size_t>(k0) * ld,
                        kSum ? prow + 2 * e : nullptr, ld, count);
}

// dq of one (64-query tile, head, batch row). Warp w owns queries 16w .. +15
// of the tile, their Q and dO fragments in registers; key and value tiles
// pass through the ring. S = Q K^T and dP = dO V^T give dS in the
// accumulator layout, rounded to bf16 into the A fragment of dQ += dS K (K
// read transposed).
template <int D, bool kBias, bool kSum>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, int ld,
              const __nv_bfloat16* __restrict__ bias,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, float* __restrict__ partial, int n,
              int e, float scale) {
  using bf16 = __nv_bfloat16;
  using Blk = MmaBlock<D, kBias>;
  constexpr int kLd = Blk::kLd;
  constexpr int kKd = D / 16;
  constexpr int kNd = D / 8;
  constexpr int kT = kTile * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kT;
  bf16* k_ring = do_s + kT;
  bf16* v_ring = k_ring + kRing * kT;
  bf16* bias_s = reinterpret_cast<bf16*>(
      reinterpret_cast<float*>(v_ring + kRing * kT) + kRing * 2 * kTile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const size_t at = static_cast<size_t>(b) * n * ld + h * D;
  const size_t at_o = static_cast<size_t>(b) * n * e + h * D;
  const size_t bh = (static_cast<size_t>(b) * gridDim.y + h) * n;
  const Blk blk{q + at, k + at, v + at, dout + at_o, ld, e, n, bias_s};

  auto load_tile = [&](int it, int slot) {
    blk.load(k_ring + slot * kT, blk.k, ld, it * kTile);
    blk.load(v_ring + slot * kT, blk.v, ld, it * kTile);
  };

  const int tiles = (n + kTile - 1) / kTile;
  blk.load(q_s, blk.q, ld, q0);
  blk.load(do_s, blk.dout, e, q0);
  if constexpr (kBias) {
    if (tid < 3 * Blk::kChunks) {
      const int part = tid / Blk::kChunks, c = (tid % Blk::kChunks) * 8;
      cp_async16(smem_u32(bias_s + part * D + c), bias + part * e + h * D + c, true);
    }
  }
  load_tile(0, 0);
  cp_async_commit();
  if (tiles > 1) load_tile(1, 1);
  cp_async_commit();

  const int w0 = warp * 16;
  const bool active = q0 + w0 < n;
  // this thread's query rows g and g + 8: lse (times log2 e) and delta;
  // rows past n read 0 and are not stored
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w0 + g + 8 * r;
    lse2[r] = row < n ? lse[bh + row] * kLog2e : 0.f;
    dl[r] = row < n ? delta[bh + row] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();   // Q, dO, the bias and key tile 0 have landed

  uint32_t qa[kKd][4], oa[kKd][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kKd; ++kk) {
      blk.frag_a(qa[kk], q_s, w0, kk, 0);
      blk.frag_a(oa[kk], do_s, w0, kk, -1);
    }
  }
  const float scale2 = scale * kLog2e;
  float acc[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int slot = it % kRing;
    const bf16* kt = k_ring + slot * kT;
    const bf16* vt = v_ring + slot * kT;
    if (it + 2 < tiles) load_tile(it + 2, (it + 2) % kRing);
    cp_async_commit();
    if (active) {
      const int k0 = it * kTile;
      const int chunks = min(kTile, n - k0 + 15) / 16;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (j2 >= chunks) break;
          uint32_t f[4];
          blk.frag_b(f, kt, j2 * 16, kk, 1);
          mma_pair(s[2 * j2], s[2 * j2 + 1], qa[kk], f);
          blk.frag_b(f, vt, j2 * 16, kk, 2);
          mma_pair(dp[2 * j2], dp[2 * j2 + 1], oa[kk], f);
        }
      // dS: element c of block j is query g (+8 for c >= 2), key 8j + 2t
      // (+1 for odd c); keys past n get P = 0
      const bool tail = k0 + kTile > n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float p = exp2_ftz(fmaf(s[j][c], scale2, -lse2[c >> 1]));
          if (tail && k0 + j * 8 + 2 * t + (c & 1) >= n) p = 0.f;
          dp[j][c] = p * (dp[j][c] - dl[c >> 1]);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= chunks) break;
        uint32_t da[4];
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < kKd; ++d2) {
          uint32_t f[4];
          blk.frag_bt(f, kt, kk * 16, d2, 1);
          mma_pair(acc[2 * d2], acc[2 * d2 + 1], da, f);
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();
  }

  stage_acc<D>(q_s, acc, scale, w0);   // Q is in registers: its tile stages dq
  __syncthreads();
  float* prow = kSum ? partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 3 * e + h * D
                     : nullptr;
  write_staged<D, kSum>(q_s, dq + at + static_cast<size_t>(q0) * ld, prow, ld,
                        min(kTile, n - q0));
}

template <int D>
constexpr size_t dkdv_smem() {
  return (4 * kTile * kStrideOf<D> + 2 * kTile * kPStride + 2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * kStrideOf<D> + kTile * kPStride + 2 * kTile) * sizeof(float);
}

// rows of 3E in the fp32 workspace `partial` that kSum needs: one per
// (b, 64-row tile)
inline int workspace_rows(int batch, int n) {
  return batch * ((n + kTile - 1) / kTile);
}

// The bf16 dk/dv and dq passes. static: each library that includes this
// header keeps its own `attr`s (attention_fwd.cuh's launch_mma says why).
template <int D, bool kBias, bool kSum>
static int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, int ld, const __nv_bfloat16* bias,
                      const __nv_bfloat16* dout, const float* lse,
                      const float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
                      __nv_bfloat16* dv, float* partial, int n, int e,
                      float scale, dim3 grid, cudaStream_t stream) {
  constexpr int kSmem = mma_smem_bytes<D>();
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      dkdv_mma_kernel<D, kBias, kSum>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);  // once per instantiation and library
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      dq_mma_kernel<D, kBias, kSum>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr_dkdv != cudaSuccess) return static_cast<int>(attr_dkdv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  dkdv_mma_kernel<D, kBias, kSum><<<grid, kMmaThreads, kSmem, stream>>>(
      q, k, v, ld, bias, dout, lse, delta, dk, dv, partial, n, e, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_mma_kernel<D, kBias, kSum><<<grid, kMmaThreads, kSmem, stream>>>(
      q, k, v, ld, bias, dout, lse, delta, dq, partial, n, e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kBias, bool kSum>
int launch_d(const void* q, const void* k, const void* v, int ld,
             const void* bias, const void* out, const void* dout,
             const void* lse, void* delta, void* partial, void* dq, void* dk,
             void* dv, void* dbias, int batch, int n, int e, int heads,
             float scale, cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* bb = static_cast<const T*>(bias);
  const T* o = static_cast<const T*>(out);
  const T* g = static_cast<const T*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(partial);
  cudaError_t err;

  const int total = batch * n * heads;
  delta_kernel<T, D><<<(total + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                       0, stream>>>(o, g, dl, n, e, heads, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  if constexpr (sizeof(T) == 2) {
    err = static_cast<cudaError_t>(launch_mma<D, kBias, kSum>(
        qq, kk, vv, ld, bb, g, l, dl, static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), part, n, e, scale, grid, stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    constexpr size_t kDkdvSmem = dkdv_smem<D>();
    err = cudaFuncSetAttribute(dkdv_kernel<T, D, kBias, kSum>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<T, D, kBias, kSum><<<grid, kThreads, kDkdvSmem, stream>>>(
        qq, kk, vv, ld, bb, g, l, dl, static_cast<T*>(dk), static_cast<T*>(dv),
        part, n, e, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    constexpr size_t kDqSmem = dq_smem<D>();
    err = cudaFuncSetAttribute(dq_kernel<T, D, kBias, kSum>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<T, D, kBias, kSum><<<grid, kThreads, kDqSmem, stream>>>(
        qq, kk, vv, ld, bb, g, l, dl, static_cast<T*>(dq), part, n, e, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }

  if constexpr (kSum) {
    const int e3 = 3 * e;
    column_sum_kernel<float><<<(e3 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        part, static_cast<float*>(dbias), batch * static_cast<int>(grid.x), e3);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

// The backward on one stream: q, k, v and dq, dk, dv at row stride ld
// (elements); d = e / heads must be 64 or 80, dtype 0 = float32,
// 1 = bfloat16. kBias reads `bias`; kSum needs `partial` with
// workspace_rows(B, N) rows of 3E and writes dbias. A pointer a flag does not
// ask for may be null. Returns a cudaError_t (0 on success). The caller
// checks shapes, contiguity and 16-byte alignment (of the pointers and of
// ld's rows).
template <bool kBias, bool kSum>
int launch(const void* q, const void* k, const void* v, int ld,
           const void* bias, const void* out, const void* dout,
           const void* lse, void* delta, void* partial, void* dq, void* dk,
           void* dv, void* dbias, int batch, int n, int e, int heads, int dtype,
           float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || e % heads != 0 || batch > 65535 ||
      heads > 65535 || dtype < 0 || dtype > 1 || ld < e)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = e / heads;
  if (d == 64 && dtype == 0)
    return launch_d<float, 64, kBias, kSum>(q, k, v, ld, bias, out, dout, lse,
                                            delta, partial, dq, dk, dv, dbias,
                                            batch, n, e, heads, scale, s);
  if (d == 64)
    return launch_d<__nv_bfloat16, 64, kBias, kSum>(
        q, k, v, ld, bias, out, dout, lse, delta, partial, dq, dk, dv, dbias,
        batch, n, e, heads, scale, s);
  if (d == 80 && dtype == 0)
    return launch_d<float, 80, kBias, kSum>(q, k, v, ld, bias, out, dout, lse,
                                            delta, partial, dq, dk, dv, dbias,
                                            batch, n, e, heads, scale, s);
  if (d == 80)
    return launch_d<__nv_bfloat16, 80, kBias, kSum>(
        q, k, v, ld, bias, out, dout, lse, delta, partial, dq, dk, dv, dbias,
        batch, n, e, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward on the packed (B, N, 3E) projection output: q, k and v are
// the thirds of qkv and dq, dk and dv those of dqkv, at row stride 3E.
template <bool kBias, bool kSum>
int launch_packed(const void* qkv, const void* bias, const void* out,
                  const void* dout, const void* lse, void* delta,
                  void* partial, void* dqkv, void* dbias, int batch, int n,
                  int e, int heads, int dtype, float scale, void* stream) {
  const size_t third = static_cast<size_t>(e) * (dtype == 0 ? 4 : 2);  // bytes
  const char* p = static_cast<const char*>(qkv);
  char* dp = static_cast<char*>(dqkv);
  return launch<kBias, kSum>(p, p + third, p + 2 * third, 3 * e, bias, out,
                             dout, lse, delta, partial, dp, dp + third,
                             dp + 2 * third, dbias, batch, n, e, heads, dtype,
                             scale, stream);
}

}  // namespace attn_bwd
