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
// Scores, P, dP and dS stay fp32 (the TPU kernel rounds P and dS to the
// type of dout before its products). Rows and keys past N (the ragged last
// tile at N=197) are staged as zeros and get P = 0.
//
// Design. Plain SIMT code on the fp32 cores, written to be right and
// readable: it recomputes S in both passes (7 N^2 d products per (b, h)
// instead of 5). Each block stages its own tile and the streamed tiles as
// padded fp32 rows in dynamic shared memory; 256 threads (16 x 16) each own a
// 4 x (d/16) piece of every 64 x d product (4 x 4 at d = 64, 4 x 5 at d = 80)
// and a 4 x 4 piece of every 64 x 64 score tile, with the streamed-row index
// interleaved (thread column tx takes rows tx, tx+16, ...) so that
// neighbouring threads read neighbouring rows without bank conflicts.

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
