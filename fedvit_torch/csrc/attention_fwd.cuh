// Multi-head softmax attention on q, k and v read in place, with or without
// the projection bias added on load: the forward of K1 (no grad), K2 (the
// forward under grad, which also writes each row's log-sum-exp), K10 (no
// bias), the attention half of K11 (xqkv_attention.cu) and K9 (flat q, k, v).
// The sources qkvb_attention.cu and xqkv_attention.cu hold the entry points
// and their design notes.
//
//   q, k, v  (B, N, *)  three base pointers and one row stride `ld`: the
//                    packed projection output (B, N, 3E) is qkv, qkv + E and
//                    qkv + 2E at ld = 3E; three flat (B, N, E) tensors are
//                    read at ld = E. Heads head-major within each: head h is
//                    columns [h*d, (h+1)*d), d = E/H = 64 (ViT-Ti/S/B/L) or
//                    80 (ViT-H)
//   bias (3E,)       kBias only: the projection bias [b_q | b_k | b_v],
//                    already in the operands' type
//   out  (B, N, E)   head h writes its column slice [h*d, (h+1)*d)
//   lse  (B, H, N)   kLse only: log sum_j exp(s_ij), s = (q.k) / sqrt(d), fp32
//
//   out_h = softmax((q_h + b_q)(k_h + b_k)^T / sqrt(d)) (v_h + b_v)
//
// With kBias the biased q/k/v are rounded to the input type, as the reference
// adds the bias in that type. Scores, the running max and the running sum are
// fp32. The kLse variant is the same code with one more store, so its output
// is bit-identical to the plain forward's; and the operand layout changes
// only addresses, so the packed and the flat layouts give the same bits on
// the same values.
//
// Design. Plain SIMT code on the fp32 cores, written to be right and
// readable. One block takes one (batch, head, 32-query tile). Its 32 query
// rows are staged once in shared memory as fp32; the keys and values pass
// through shared memory in tiles of 64 rows (32 at d = 80, which keeps the
// static shared memory under 48 KB), so any N works and nothing is re-read
// from device memory within a block. Each of the 4 warps owns 8 query rows.
// For a chunk of 32 keys a lane holds one key row in registers and scores it
// against the warp's 8 queries (the query rows are read as shared-memory
// broadcasts), then the warp runs the online-softmax update and accumulates
// P.V with lane l owning the output columns l, l + 32, l + 64 below d (d/32
// need not be whole). Rows past N (the ragged last tile at N=197) are staged
// as zeros and masked with a score of -inf. Nothing is written but the output
// (and lse), and no transposed copy of q, k or v is made.

#pragma once

#include <math.h>

#include "common.cuh"

namespace attn_fwd {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryTile = kWarps * kRowsPerWarp;  // query rows per block

template <typename T, int D, bool kBias, bool kLse>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, int ld, const T* __restrict__ bias,
           T* __restrict__ out, float* __restrict__ lse, int n, int e,
           float scale) {
  constexpr int kKeyTile = D <= 64 ? 64 : 32;  // key rows per staged tile
  constexpr int kVec = Io<T>::kVec;
  constexpr int kVecPerRow = D / kVec;
  constexpr int kStride = D + 4;  // padded fp32 row: conflict-free 16-byte reads
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  constexpr int kR = kRowsPerWarp;
  static_assert(D % kVec == 0 && D % 4 == 0, "head width");

  __shared__ __align__(16) float q_s[kQueryTile * kStride];
  __shared__ __align__(16) float k_s[kKeyTile * kStride];
  __shared__ __align__(16) float v_s[kKeyTile * D];
  __shared__ __align__(16) float p_s[kWarps * kR * 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kQueryTile;
  const size_t at = static_cast<size_t>(b) * n * ld + h * D;  // (b, row 0, head h)

  // rows [row0, row0 + count) of head h of `src` (its bias slice `bsrc`
  // added and rounded to T with kBias) to fp32 shared memory; rows past n
  // become zeros
  auto stage = [&](float* dst, int stride, const T* src, const T* bsrc,
                   int row0, int count) {
    for (int i = tid; i < count * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      float x[kVec];
      if (row0 + r < n) {
        Io<T>::load(src + at + static_cast<size_t>(row0 + r) * ld + c, x);
        if constexpr (kBias) {
          float bx[kVec];
          Io<T>::load(bsrc + c, bx);
#pragma unroll
          for (int j = 0; j < kVec; ++j) x[j] = Io<T>::round(x[j] + bx[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = 0.f;
      }
      float4* d4 = reinterpret_cast<float4*>(dst + r * stride + c);
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j)
        d4[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    }
  };

  // kBias only: the bias slices of head h in q, k and v
  const T* b_q = kBias ? bias + h * D : nullptr;
  const T* b_k = kBias ? bias + e + h * D : nullptr;
  const T* b_v = kBias ? bias + 2 * e + h * D : nullptr;
  stage(q_s, kStride, q, b_q, q0, kQueryTile);

  float m[kR], l[kR], o[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] = 0.f;
  }
  float* p_w = p_s + warp * kR * 32;
  const float* q_w = q_s + warp * kR * kStride;

  for (int t0 = 0; t0 < n; t0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    stage(k_s, kStride, k, b_k, t0, kKeyTile);
    stage(v_s, D, v, b_v, t0, kKeyTile);
    __syncthreads();
    const int nk = min(kKeyTile, n - t0);

    for (int c0 = 0; c0 < nk; c0 += 32) {
      const int key = c0 + lane;
      float kr[D];
      const float4* k4 = reinterpret_cast<const float4*>(k_s + key * kStride);
#pragma unroll
      for (int u = 0; u < D / 4; ++u) {
        const float4 t = k4[u];
        kr[4 * u] = t.x; kr[4 * u + 1] = t.y; kr[4 * u + 2] = t.z; kr[4 * u + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4* q4 = reinterpret_cast<const float4*>(q_w + r * kStride);
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < D / 4; ++u) {
          const float4 t = q4[u];
          acc = fmaf(t.x, kr[4 * u], acc);
          acc = fmaf(t.y, kr[4 * u + 1], acc);
          acc = fmaf(t.z, kr[4 * u + 2], acc);
          acc = fmaf(t.w, kr[4 * u + 3], acc);
        }
        const float s = key < nk ? acc * scale : -INFINITY;
        // lane 0 always holds a real key, so the chunk max is finite
        const float m_new = fmaxf(m[r], warp_max(s));
        const float corr = __expf(m[r] - m_new);
        const float p = __expf(s - m_new);
        m[r] = m_new;
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[r][c] *= corr;
        p_w[r * 32 + lane] = p;
      }
      __syncwarp();
      // keys past nk have p = 0 and zero-staged values
      const int kend = min(32, nk - c0);
      for (int kk = 0; kk < kend; kk += 4) {
        float vv[4][kCols];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int col = lane + 32 * c;
            vv[j][c] = col < D ? v_s[(c0 + kk + j) * D + col] : 0.f;
          }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_w + r * 32 + kk);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            o[r][c] += p4.x * vv[0][c] + p4.y * vv[1][c] + p4.z * vv[2][c] +
                       p4.w * vv[3][c];
        }
      }
      __syncwarp();  // p_w is rewritten by the next chunk
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float sum = warp_sum(l[r]);
    const float inv = 1.f / sum;
    const int row = q0 + warp * kR + r;
    if (kLse && row < n && lane == 0)
      lse[(static_cast<size_t>(b) * gridDim.y + h) * n + row] = m[r] + logf(sum);
    if (row < n) {
      T* dst = out + (static_cast<size_t>(b) * n + row) * e + h * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float res = o[r][c] * inv;
          Io<T>::template store<1>(dst + col, &res);
        }
      }
    }
  }
}

template <typename T, int D, bool kBias, bool kLse>
int launch_d(const void* q, const void* k, const void* v, int ld,
             const void* bias, void* out, float* lse, int batch, int n, int e,
             int heads, float scale, cudaStream_t stream) {
  const dim3 grid((n + kQueryTile - 1) / kQueryTile, heads, batch);
  fwd_kernel<T, D, kBias, kLse><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ld, static_cast<const T*>(bias),
      static_cast<T*>(out), lse, n, e, scale);
  return static_cast<int>(cudaGetLastError());
}

// The forward on one stream, q, k and v at row stride ld (elements); d =
// e / heads must be 64 or 80, dtype 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 on success). The caller checks shapes, contiguity and
// 16-byte alignment (of the pointers and of ld's rows).
template <bool kBias, bool kLse>
int launch(const void* q, const void* k, const void* v, int ld,
           const void* bias, void* out, float* lse, int batch, int n, int e,
           int heads, int dtype, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || e % heads != 0 || batch > 65535 ||
      heads > 65535 || dtype < 0 || dtype > 1 || ld < e)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = e / heads;
  if (d == 64 && dtype == 0)
    return launch_d<float, 64, kBias, kLse>(q, k, v, ld, bias, out, lse, batch,
                                            n, e, heads, scale, s);
  if (d == 64)
    return launch_d<__nv_bfloat16, 64, kBias, kLse>(q, k, v, ld, bias, out, lse,
                                                    batch, n, e, heads, scale, s);
  if (d == 80 && dtype == 0)
    return launch_d<float, 80, kBias, kLse>(q, k, v, ld, bias, out, lse, batch,
                                            n, e, heads, scale, s);
  if (d == 80)
    return launch_d<__nv_bfloat16, 80, kBias, kLse>(q, k, v, ld, bias, out, lse,
                                                    batch, n, e, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward on the packed (B, N, 3E) projection output: its q, k and v
// thirds at row stride 3E.
template <bool kBias, bool kLse>
int launch_packed(const void* qkv, const void* bias, void* out, float* lse,
                  int batch, int n, int e, int heads, int dtype, float scale,
                  void* stream) {
  const size_t third = static_cast<size_t>(e) * (dtype == 0 ? 4 : 2);  // bytes
  const char* p = static_cast<const char*>(qkv);
  return launch<kBias, kLse>(p, p + third, p + 2 * third, 3 * e, bias, out,
                             lse, batch, n, e, heads, dtype, scale, stream);
}

}  // namespace attn_fwd
