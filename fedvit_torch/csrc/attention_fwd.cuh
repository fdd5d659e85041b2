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
// the same values. No atomics: every run gives the same bits.
//
// bf16 (fwd_kernel): a FlashAttention-2 forward on the tensor cores. The
// kernel is bound by bytes at every shape the models give it (qkv is read
// once, out written once; qkvb_attention.cu has the numbers), so mma.sync
// gives it tensor-core rate enough and the design aims at reading q, k and v
// once at the memory rate:
// - one block a (128-query tile, head, batch row), 4 warps of 32 query rows
//   (two m16 row tiles, so each K and V fragment read from shared memory
//   serves two products, and each head's K and V are read from L2 once for
//   every 128 queries);
// - q, k and v are staged in bf16 by cp.async, 16 bytes a thread, rows
//   padded to D + 8 elements (144 or 176 bytes, so ldmatrix's 8 row
//   addresses fall in 8 different 16-byte bank groups); keys and values pass
//   through a ring of 64-row tiles, copies two tiles ahead in flight while
//   the current one is computed; rows past N are zero-filled
//   (source size 0); one barrier a tile;
// - with kBias the bias slices wait in shared memory and are added to the
//   Q, K and V fragments as they are read, by bf16x2 adds rounded once (the
//   bits of rounding the fp32 sum, as the SIMT version does): no pass over
//   the staged tiles and no barrier of their own;
// - S = Q K^T by mma.sync.m16n8k16 (bf16 in, fp32 accumulate), Q's fragments
//   held in registers for the whole row of key tiles, K's and V's read by
//   ldmatrix (V's by ldmatrix.trans); keys past N get a score of -inf;
// - the online softmax in registers: the row max of q.k and the row sum are
//   shared by the 4 lanes of a row with two shfl_xor steps, and
//   p = 2^(s c - m c) with c = log2(e) / sqrt(d), one fma and one ex2 (only
//   the last tile masks keys past N). P is rounded to bf16 in the
//   accumulator-to-A-fragment layout and goes straight into P V, never
//   through shared memory. (The TPU kernel and the plain version round the
//   normalised weights to bf16 before P V; this kernel rounds them before
//   normalising, and divides the fp32 sum at the end.) lse goes out in
//   natural log, m / sqrt(d) + log(l);
// - the output tile is staged through the warp's own rows of Q's shared
//   memory and written with 16-byte stores; query rows past N are not
//   stored.
//
// fp32 (simt_fwd_kernel): plain SIMT code on the fp32 cores, written to be
// right and readable; no model path runs fp32 attention at a size that
// matters. One block takes one (batch, head, 32-query tile). Its 32 query
// rows are staged once in shared memory as fp32; the keys and values pass
// through shared memory in tiles of 64 rows (32 at d = 80, which keeps the
// static shared memory under 48 KB). Each of the 4 warps owns 8 query rows.
// For a chunk of 32 keys a lane holds one key row in registers and scores it
// against the warp's 8 queries, then the warp runs the online-softmax update
// and accumulates P.V with lane l owning the output columns l, l + 32, l + 64
// below d. Rows past N are staged as zeros and masked with a score of -inf.
//
// The dtype picks the kernel at compile time.

#pragma once

#include <math.h>

#include "common.cuh"

namespace attn_fwd {

// --- fp32: SIMT on the fp32 cores ------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryTile = kWarps * kRowsPerWarp;  // query rows per block

template <typename T, int D, bool kBias, bool kLse>
__global__ void __launch_bounds__(kThreads)
simt_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
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


// --- bf16: FlashAttention-2 on the tensor cores -----------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRowTiles = 2;                       // m16 row tiles a warp
constexpr int kBlockQ = kMmaWarps * 16 * kRowTiles;  // query rows per block
constexpr int kBlockK = 64;              // key rows per staged tile
constexpr int kRing = 3;                 // key and value tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of fwd_kernel<D>: the query tile, the ring's key and value
// tiles, rows of D + 8 bf16, and the bias slices of q, k and v
template <int D>
constexpr int mma_smem_bytes() {
  return (kBlockQ + 2 * kRing * kBlockK) * (D + 8) * 2 + 3 * D * 2;
}

template <int D, bool kBias, bool kLse>
__global__ void __launch_bounds__(kMmaThreads)
fwd_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, int ld,
           const __nv_bfloat16* __restrict__ bias,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int n,
           int e, float scale) {
  static_assert(D % 16 == 0, "head width");
  constexpr int kLd = D + 8;         // padded row, elements
  constexpr int kChunks = D / 8;     // 16-byte chunks a row
  constexpr int kKd = D / 16;        // k16 steps of Q K^T; pairs of n8 blocks of P V
  constexpr int kNd = D / 8;         // n8 blocks of the output
  constexpr int kR = kRowTiles;
  constexpr int kTile = kBlockK * kLd;
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * kLd;     // kRing tiles
  bf16* v_s = k_s + kRing * kTile;     // kRing tiles
  bf16* bias_s = v_s + kRing * kTile;  // kBias: [b_q | b_k | b_v] of head h

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;           // the row of an mma fragment
  const int t = lane & 3;            // its column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int w0 = warp * 16 * kR;     // this warp's first row in the block
  const size_t at = static_cast<size_t>(b) * n * ld + h * D;  // (b, row 0, head h)

  // `rows` rows from row0 of head h of src into a tile, rows past n as zeros
  auto load = [&](bf16* dst, const bf16* src, int row0, int rows) {
#pragma unroll
    for (int i = tid; i < rows * kChunks; i += kMmaThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool in = row0 + r < n;
      cp_async16(smem_u32(dst + r * kLd + c),
                 src + at + static_cast<size_t>(in ? row0 + r : 0) * ld + c, in);
    }
  };

  const int tiles = (n + kBlockK - 1) / kBlockK;
  load(q_s, q, q0, kBlockQ);
  load(k_s, k, 0, kBlockK);
  load(v_s, v, 0, kBlockK);
  if constexpr (kBias) {
    if (tid < 3 * kChunks) {
      const int part = tid / kChunks, c = (tid % kChunks) * 8;
      cp_async16(smem_u32(bias_s + part * D + c), bias + part * e + h * D + c,
                 true);
    }
  }
  cp_async_commit();
  if (tiles > 1) {
    load(k_s + kTile, k, kBlockK, kBlockK);
    load(v_s + kTile, v, kBlockK, kBlockK);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();    // Q, tile 0 and the bias have landed
  // kBias: b[c] and b[c + 1] of a bias slice as one bf16 pair, and b[c] twice
  auto bias2 = [&](int part, int c) {
    return *reinterpret_cast<const uint32_t*>(bias_s + part * D + c);
  };
  auto bias_twice = [&](int part, int c) {
    const uint32_t x = *reinterpret_cast<const uint16_t*>(bias_s + part * D + c);
    return x | (x << 16);
  };
  // a warp whose query rows all lie past n only stages and waits
  const bool active = q0 + w0 < n;
  uint32_t qf[kR][kKd][4];   // this warp's query rows, A fragments
  if (active) {
#pragma unroll
    for (int rt = 0; rt < kR; ++rt) {
      // matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15)
      const int row = w0 + rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk) {
        uint32_t (&a)[4] = qf[rt][kk];
        ldmatrix_x4(a, smem_u32(q_s + row * kLd + kk * 16 + (lane >> 4) * 8));
        if constexpr (kBias) {   // columns 16 kk + 2t (a0, a1), + 8 (a2, a3)
          const uint32_t b0 = bias2(0, kk * 16 + 2 * t);
          const uint32_t b1 = bias2(0, kk * 16 + 8 + 2 * t);
          a[0] = add_bf16x2(a[0], b0); a[1] = add_bf16x2(a[1], b0);
          a[2] = add_bf16x2(a[2], b1); a[3] = add_bf16x2(a[3], b1);
        }
      }
    }
  }

  const float scale2 = scale * kLog2e;  // p = 2^(s scale2 - m scale2)
  float o[kR][kNd][4];
  float m[kR][2], l[kR][2];  // rows g and g + 8 of each row tile: max of q.k,
                             // and this lane's share of the row sum
#pragma unroll
  for (int rt = 0; rt < kR; ++rt) {
    m[rt][0] = m[rt][1] = -INFINITY;
    l[rt][0] = l[rt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < kNd; ++j)
      o[rt][j][0] = o[rt][j][1] = o[rt][j][2] = o[rt][j][3] = 0.f;
  }

  // Tile `it` is visible to every warp when step `it` starts. The step starts
  // tile it + 2's copies into the slot tile it - 1 left, computes tile it,
  // and ends waiting for tile it + 1 at the one barrier of the step.
  for (int it = 0; it < tiles; ++it) {
    const bf16* kt = k_s + (it % kRing) * kTile;
    const bf16* vt = v_s + (it % kRing) * kTile;
    if (it + 2 < tiles) {
      load(k_s + ((it + 2) % kRing) * kTile, k, (it + 2) * kBlockK, kBlockK);
      load(v_s + ((it + 2) % kRing) * kTile, v, (it + 2) * kBlockK, kBlockK);
    }
    cp_async_commit();
    if (active) {
      // 16-key chunks of this tile that hold a key below n
      const int chunks = min(kBlockK, n - it * kBlockK + 15) / 16;

      // S = Q K^T over this tile's 64 keys: 8 n8 blocks a row tile; each K
      // fragment serves both row tiles
      float s[kR][8][4];
#pragma unroll
      for (int rt = 0; rt < kR; ++rt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[rt][j][0] = s[rt][j][1] = s[rt][j][2] = s[rt][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk) {
        uint32_t bk[2];   // kBias: k's bias at columns 16 kk + 2t, + 8
        if constexpr (kBias) {
          bk[0] = bias2(1, kk * 16 + 2 * t);
          bk[1] = bias2(1, kk * 16 + 8 + 2 * t);
        }
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (j2 >= chunks) break;   // keys past n: their scores become -inf
          // keys 16 j2 + (0-7 | 8-15) x head columns 16 kk + (0-7 | 8-15)
          uint32_t kf[4];
          const int key = j2 * 16 + (lane >> 4) * 8 + (lane & 7);
          ldmatrix_x4(kf, smem_u32(kt + key * kLd + kk * 16 + ((lane >> 3) & 1) * 8));
          if constexpr (kBias) {
            kf[0] = add_bf16x2(kf[0], bk[0]); kf[1] = add_bf16x2(kf[1], bk[1]);
            kf[2] = add_bf16x2(kf[2], bk[0]); kf[3] = add_bf16x2(kf[3], bk[1]);
          }
          const uint32_t b0[2] = {kf[0], kf[1]};
          const uint32_t b1[2] = {kf[2], kf[3]};
#pragma unroll
          for (int rt = 0; rt < kR; ++rt) {
            mma_bf16(s[rt][2 * j2], qf[rt][kk], b0);
            mma_bf16(s[rt][2 * j2 + 1], qf[rt][kk], b1);
          }
        }
      }

      // the online softmax: rows g (elements 0, 1) and g + 8 (elements 2, 3)
      if ((it + 1) * kBlockK > n) {   // the last tile: keys past n score -inf
        const int key0 = it * kBlockK + 2 * t;
#pragma unroll
        for (int rt = 0; rt < kR; ++rt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (key0 + j * 8 + (c & 1) >= n) s[rt][j][c] = -INFINITY;
      }
#pragma unroll
      for (int rt = 0; rt < kR; ++rt) {
        float mx[2] = {m[rt][0], m[rt][1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[rt][j][c]);
        float corr[2], ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // key it * 64 < n, so the max over the row's 4 lanes is finite
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          ms[r] = mx[r] * scale2;
          corr[r] = exp2_ftz(fmaf(m[rt][r], scale2, -ms[r]));
          m[rt][r] = mx[r];
          l[rt][r] *= corr[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[rt][j][c] = exp2_ftz(fmaf(s[rt][j][c], scale2, -ms[c >> 1]));
            l[rt][c >> 1] += s[rt][j][c];
          }
#pragma unroll
        for (int j = 0; j < kNd; ++j) {
          o[rt][j][0] *= corr[0]; o[rt][j][1] *= corr[0];
          o[rt][j][2] *= corr[1]; o[rt][j][3] *= corr[1];
        }
      }

      // O += P V: P's A fragments from the score accumulators, rounded to
      // bf16; each V fragment serves both row tiles
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        if (kk >= chunks) break;     // P is 0 there
        uint32_t pa[kR][4];
#pragma unroll
        for (int rt = 0; rt < kR; ++rt) {
          pa[rt][0] = Io<bf16>::pack(s[rt][2 * kk][0], s[rt][2 * kk][1]);
          pa[rt][1] = Io<bf16>::pack(s[rt][2 * kk][2], s[rt][2 * kk][3]);
          pa[rt][2] = Io<bf16>::pack(s[rt][2 * kk + 1][0], s[rt][2 * kk + 1][1]);
          pa[rt][3] = Io<bf16>::pack(s[rt][2 * kk + 1][2], s[rt][2 * kk + 1][3]);
        }
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp = 0; dp < kKd; ++dp) {
          // keys (0-7 | 8-15) x head columns 16 dp + (0-7 | 8-15), transposed
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_u32(vt + key * kLd + dp * 16 + (lane >> 4) * 8));
          if constexpr (kBias) {   // two keys of one column: 16 dp + g, + 8
            const uint32_t b0 = bias_twice(2, dp * 16 + g);
            const uint32_t b1 = bias_twice(2, dp * 16 + 8 + g);
            vf[0] = add_bf16x2(vf[0], b0); vf[1] = add_bf16x2(vf[1], b0);
            vf[2] = add_bf16x2(vf[2], b1); vf[3] = add_bf16x2(vf[3], b1);
          }
          const uint32_t b0[2] = {vf[0], vf[1]};
          const uint32_t b1[2] = {vf[2], vf[3]};
#pragma unroll
          for (int rt = 0; rt < kR; ++rt) {
            mma_bf16(o[rt][2 * dp], pa[rt], b0);
            mma_bf16(o[rt][2 * dp + 1], pa[rt], b1);
          }
        }
      }
    }
    cp_async_wait<1>();   // this thread's copies of tile it + 1 have landed
    __syncthreads();      // ... every thread's; tile it is consumed
  }

  // the output through this warp's rows of q_s (its Q is in registers), then
  // 16-byte stores
  bf16* o_s = q_s + w0 * kLd;
#pragma unroll
  for (int rt = 0; rt < kR; ++rt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[rt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.f / sum;
      const int row = q0 + w0 + rt * 16 + g + 8 * r;
      if (kLse && t == 0 && row < n)
        lse[(static_cast<size_t>(b) * gridDim.y + h) * n + row] =
            m[rt][r] * scale + logf(sum);
    }
    bf16* os = o_s + rt * 16 * kLd;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      *reinterpret_cast<uint32_t*>(os + g * kLd + j * 8 + 2 * t) =
          Io<bf16>::pack(o[rt][j][0] * inv[0], o[rt][j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(os + (g + 8) * kLd + j * 8 + 2 * t) =
          Io<bf16>::pack(o[rt][j][2] * inv[1], o[rt][j][3] * inv[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kR * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = q0 + w0 + r;
    if (row < n)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * n + row) * e +
                                h * D + c) =
          *reinterpret_cast<const uint4*>(o_s + r * kLd + c);
  }
}

// static: each library that includes this header keeps its own `attr`. A
// local static of a function with external linkage is one object across
// every loaded library (a GNU unique symbol), so a second library would skip
// setting the attribute on its own copy of the kernel, and its launches above
// 48 KB of shared memory would be refused.
template <int D, bool kBias, bool kLse>
static int launch_mma(const void* q, const void* k, const void* v, int ld,
                      const void* bias, void* out, float* lse, int batch,
                      int n, int e, int heads, float scale,
                      cudaStream_t stream) {
  constexpr int kSmem = mma_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D, kBias, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);  // once per instantiation and library
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  fwd_kernel<D, kBias, kLse><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ld,
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      lse, n, e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBias, bool kLse>
int launch_simt(const void* q, const void* k, const void* v, int ld,
                const void* bias, void* out, float* lse, int batch, int n,
                int e, int heads, float scale, cudaStream_t stream) {
  const dim3 grid((n + kQueryTile - 1) / kQueryTile, heads, batch);
  simt_fwd_kernel<float, D, kBias, kLse><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ld, static_cast<const float*>(bias),
      static_cast<float*>(out), lse, n, e, scale);
  return static_cast<int>(cudaGetLastError());
}

// The forward on one stream, q, k and v at row stride ld (elements); d =
// e / heads must be 64 or 80, dtype 0 = float32 (SIMT), 1 = bfloat16 (tensor
// cores). Returns a cudaError_t (0 on success). The caller checks shapes,
// contiguity and 16-byte alignment (of the pointers and of ld's rows).
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
    return launch_simt<64, kBias, kLse>(q, k, v, ld, bias, out, lse, batch, n,
                                        e, heads, scale, s);
  if (d == 64)
    return launch_mma<64, kBias, kLse>(q, k, v, ld, bias, out, lse, batch, n,
                                       e, heads, scale, s);
  if (d == 80 && dtype == 0)
    return launch_simt<80, kBias, kLse>(q, k, v, ld, bias, out, lse, batch, n,
                                        e, heads, scale, s);
  if (d == 80)
    return launch_mma<80, kBias, kLse>(q, k, v, ld, bias, out, lse, batch, n,
                                       e, heads, scale, s);
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
