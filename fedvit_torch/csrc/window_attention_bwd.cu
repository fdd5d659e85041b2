// Backward of the windowed multi-head attention with a per-head
// relative-position bias and a per-window shift mask (K6), the attention of
// every SwinV2 block under grad.
//
// Replaces the TPU kernels fedvit_tpu/ops/flash_attention.py::_wflat_bwd_kernel,
// ::_wflat_bwd_stats_kernel and ::_wflat_bwd_delta_kernel (launched by the rule
// of _make_wflat_bwd through pl.pallas_call). All three compute the same
// function and differ in what they recompute; this is the saved-statistics form
// with the delta identity, fed by the forward's per-row log-sum-exp and its
// unrounded fp32 output (window_attention.cu::window_attention_fwd_lse):
//
//   inputs   q, k, v, dout (W0*B, N, E) window-major rows, heads head-major
//            along E, each d = 32 wide; out (W0*B, N, E) fp32, the forward's
//            output before rounding; bias (H, N, N) fp32; mask (W0, N, N)
//            fp32 (W0 = 1: every row uses mask[0]); lse (W0*B, H, N) fp32
//   outputs  dq, dk, dv (W0*B, N, E) in q's type; dbias (H, N, N) fp32.
//            The mask gets no gradient: it is a constant of the model.
//
//   per (row r, head h), w = r / B:
//   S = q_h k_h^T + bias[h] + mask[w]   (no scale: the caller folded it into q)
//   P = exp(S - lse),  delta_i = sum_c dout_ic out_ic,  dP = dout_h v_h^T
//   dS = P * (dP - delta)
//   dv = P^T dout_h with P rounded to q's type first; dq = dS k_h and
//   dk = dS^T q_h with dS rounded to q's type first (as the TPU kernels round
//   them before their products); sums in fp32
//   dbias[h] = sum over all rows r of the unrounded fp32 dS
//
// Launches, in order on the caller's stream:
//   1. delta: one warp per (r, query, head), a lane per column, fp32. It
//      stands in for sum_j P_ij dP_ij (which the TPU's default kernel sums
//      over its resident tile) only as exactly as out is sum_j P_ij v_j: where
//      one key takes nearly all of a row's weight, dP_ij - delta_i is a
//      difference of near-equal numbers, and a bf16 out loses it (measured:
//      the q and k rows of SwinV2-L's qkv gradients then sit three times as
//      far from an fp32 reference as the plain backward's). Hence the fp32
//      out.
//   2-4, bf16, on the tensor cores (dkdv_mma_kernel, dq_mma_kernel,
//      dbias_mma_kernel):
//   2. dk, dv: one block per (two rows r of a window, h, 64-key tile); it
//      walks the query tiles and keeps its 64x32 dk and dv sums in registers.
//   3. dq: one block per (two rows r of a window, h, 64-query tile); it walks
//      the key tiles.
//   4. dbias: one block per (h, 64-query tile, 64-key tile); it walks all
//      W0*B rows in order, recomputes their dS and sums it in registers, so
//      each cell is summed in one order and written once.
//   2-5, fp32, plain SIMT code (dkdv_kernel, dq_dbias_kernel):
//   2. dk, dv as above.
//   3. dq and dbias: one block per (h, 32-query tile, group of rows). It walks
//      its rows r and, for each, the key tiles: dq of (r, tile) is summed in
//      registers and written once per r, and every dS it computes is also added
//      into the block's own (32, N) fp32 tile of dbias in shared memory, which
//      is written once at the end.
//   4. only with more than one group of rows: dbias = sum of the groups' tiles
//      (group_sum_kernel).
//
// dbias is the new problem of this kernel: a sum over all W0*B rows for each
// of H*N*N cells (SwinV2-L@384 at 8 images: 128 rows into 6 x 576^2 cells at
// stage 0, 8 rows into 24 x 576^2 cells, 32 MB, at stage 2). The TPU kernel
// keeps the (heads, N, N) block resident and orders its sequential grid so
// that consecutive steps add to it; Hopper's blocks run in no order. fp32
// atomics would do it in one line but give other bits every run. Instead the
// reduction over rows is a loop inside the block that owns the cells, so the
// sum is taken in one order and every run gives the same bits. bf16 gives it
// a pass of its own (4), which recomputes S and dP a third time but reads the
// bias and mask of its cells once per window instead of once per row, and
// fills the card with H * (N/64)^2 blocks (486 at stage 0). fp32 sums it in
// pass 3 and cuts the rows into up to 16 groups (H * N/32 blocks are only 108
// at stage 0 for 132 SMs), each writing its tile to an fp32 workspace
// (groups, H, N, N) that pass 4 sums in order; the number of groups is the one
// that fills the card's block slots in the fewest waves
// (window_attention_bwd_row_groups, which the caller asks to size the
// workspace). One group writes dbias directly and needs no workspace.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the SwinV2-L@384
// stage shapes for 8 images, bf16, from the function's own bytes: q, k, v and
// dout read, dq, dk, dv written, bias and mask read, dbias written (out and
// lse are the port's own leftovers, which the TPU kernel recomputes):
//   stage 0 (W0 16, N 576, E 192, H 6): 7 * 2 * 128*576*192 = 198.2 MB
//            + bias 8.0 + mask 21.2 + dbias 8.0 = 235.4 MB -> 70 us;
//            10 * 128*6*576^2*32 = 81.5 GFLOP -> 82 us at the bf16 tensor peak
//   stage 2 (W0 1, N 576, E 768, H 24): 49.5 + 31.9 + 1.3 + 31.9 = 114.6 MB
//            -> 34 us; 20.4 GFLOP -> 21 us
// so operations bound it at stage 0 and bytes at stage 2, where more than
// half of them are bias and dbias.
//
// K12's backward (the cosine_ entries) replaces ::_wcos_bwd_kernel (launched
// by _wcos_bwd_rule through pl.pallas_call): the gradients of the scaled-
// cosine attention of window_attention.cu's cosine entries with respect to
// the RAW q and k, v, the bias and the per-head scale (H,). It is K6
// compiled with kCosine: every q and k tile is normalised as it is staged,
// exactly as the forward does (q^n = round(q * (r_q * scale[h])),
// k^n = round(k * r_k), r = 1 / max(||x||, 1e-6); bf16 through
// window_tiles.cuh::normalize_row, the forward's own routine, fp32 through
// common.cuh::normalize_rows, the forward's fp32 one), so the
// passes above give dq^n, dk^n, dv and dbias of the normalised operands.
// Then, as the TPU kernel, the chain rule through x^ = x * r:
//
//   dq = scale[h] r_q (dq^n - [||q|| > eps] q^ (q^ . dq^n)),  q^ = q r_q
//   dk = r_k (dk^n - [||k|| > eps] k^ (k^ . dk^n)),           k^ = k r_k
//   dscale[h] = sum over all W0*B*N rows of q^ . dq^n
//
// At the clamp r is a constant and dx = r dx^ stays finite on a row of
// zeros. The row dot x^ . dx^n is summed over the lanes that hold the row
// with butterfly shuffles, which give every lane the same bits (fp32: 8
// neighbouring lanes of 4 columns each; bf16: the 4 lanes of a fragment row,
// 8 columns each). dscale is the new cross-block sum: each dq block adds its
// rows' dots in order and writes one partial, (H, query tiles, groups) fp32
// (bf16: (H, query tiles, W0, pairs of rows)), and a last pass sums each
// head's partials in order: no atomics, as dbias.
//
// Design, bf16: FlashAttention-2's backward at d = 32, as attention_bwd.cuh's
// (mma.sync.m16n8k16 in 128-thread blocks, warp w owning rows 16w .. +15 of
// the block's 64-row tile, S^T and dP^T in pass 2 so P^T and dS^T feed
// dV += P^T dO and dK += dS^T Q from registers, the tile routines of
// common.cuh and window_tiles.cuh), two k16 steps a product. The fp32 bias and mask are added to
// S in fp32 before the exponent; in passes 2 and 3 their 64 x 64 tiles
// arrive with the streamed operand tiles in a three-slot cp.async ring (16
// bytes a copy when N is a multiple of 4; a null mask moves no bytes), and
// each block takes two rows of one window, its halves sharing those tiles;
// in pass 4 they stay in registers while the window stays. P and dS are rounded to bf16 in registers before
// their products, as the TPU kernel rounds them; dbias sums the unrounded dS.
// kCosine normalises each staged bf16 tile in place (normalize_tile, a row
// at a time through normalize_row, which the forward calls too) behind one
// more barrier. The grids of passes 2 and 3 have
// the pair of rows fastest, so the blocks that read one (window, head)'s
// bias and mask tiles run together out of L2.
//
// Design, fp32: plain SIMT code on the fp32 cores, written to be right and
// readable; no model path runs fp32 attention at a size that matters. S and
// dP are recomputed in both passes (7 N^2 d products per (r, h) instead of
// 5). Tiles are staged as padded fp32 rows in dynamic shared memory; 256
// threads each own a (4 or 2) x 4 piece of a (64 or 32) x 64 score tile with
// the row index interleaved (thread column tx takes keys tx, tx+16, ...),
// and read bias[h][i][j] + mask[w][i][j] for their piece before the dot
// products that hide the loads.
//
// Any N up to window_attention_bwd_max_n() works: rows and keys past N are
// staged as zeros and get P = 0.

#include <math.h>

#include <algorithm>

#include "window_tiles.cuh"

namespace {

constexpr int kKeyTile = 64;            // keys of a score tile
constexpr int kDkdvQueryTile = 64;      // queries a score tile of pass 2
constexpr int kDqQueryTile = 32;        // queries a block of pass 3
constexpr int kThreads = 256;
constexpr int kStride = kD + 4;         // padded fp32 row of q, k, v, dout
constexpr int kPStride = kKeyTile + 1;  // padded fp32 row of P and dS
constexpr int kDbPad = 16;              // padding of a row of the dbias tile
constexpr int kMaxGroups = 16;
constexpr size_t kMaxSmem = 227 * 1024;

// rows [row0, row0 + kRows) of one head slice (src points at row 0, column
// h*d; ld elements a row) into fp32 shared memory; rows past n are zeros
template <typename T, int kRows>
__device__ void stage(float* dst, const T* __restrict__ src, int ld, int row0,
                      int n) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kVecPerRow = kD / kVec;
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float x[kVec];
    if (row0 + r < n) {
      Io<T>::load(src + static_cast<size_t>(row0 + r) * ld + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * kStride + c);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      d4[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// lse and delta of query rows [q0, q0 + count) of one (r, h) into shared memory
__device__ void stage_rows(float* lse_s, float* dl_s, const float* __restrict__ lse,
                           const float* __restrict__ delta, int q0, int n,
                           int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const bool in = q0 + i < n;
    lse_s[i] = in ? lse[q0 + i] : 0.f;
    dl_s[i] = in ? delta[q0 + i] : 0.f;
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// For the (16 kA) x 64 tile pair (query rows i = ty + 16a, key rows
// j = tx + 16b): P = exp(q_i k_j + bias + mask - lse_i) and
// dS = P * (dout_i v_j - delta_i), fp32 and unrounded, into this thread's
// registers. Entries past N get 0. bias_h and mask_w (null: no mask) point
// at the (N, N) slices of this head and window.
template <int kA>
__device__ __forceinline__ void scores(
    const float* q_s, const float* k_s, const float* do_s, const float* v_s,
    const float* lse_s, const float* dl_s, const float* __restrict__ bias_h,
    const float* __restrict__ mask_w, int n, int q0, int k0, float (&p)[kA][4],
    float (&ds)[kA][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float add[kA][4], s[kA][4], dp[kA][4];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = q0 + ty + 16 * a;
      const int j = k0 + tx + 16 * b;
      const size_t at = static_cast<size_t>(i) * n + j;
      add[a][b] = (i < n && j < n)
                      ? bias_h[at] + (mask_w == nullptr ? 0.f : mask_w[at])
                      : 0.f;
      s[a][b] = dp[a][b] = 0.f;
    }
#pragma unroll 4
  for (int c = 0; c < kD; c += 4) {
    float4 kb[4], vb[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * b) * kStride + c);
      vb[b] = *reinterpret_cast<const float4*>(v_s + (tx + 16 * b) * kStride + c);
    }
#pragma unroll
    for (int a = 0; a < kA; ++a) {
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
  for (int a = 0; a < kA; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool valid = q0 + i < n && k0 + tx + 16 * b < n;
      p[a][b] = valid ? __expf(s[a][b] + add[a][b] - lse_s[i]) : 0.f;
      ds[a][b] = p[a][b] * (dp[a][b] - dl_s[i]);
    }
  }
}

// 4 consecutive values of a row of T (8-byte aligned) as fp32
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&f)[4]) {
  Io<T>::load2(p, f);
  Io<T>::load2(p + 2, f + 2);
}

// kCosine, the chain rule of one d = 32 row through x^ = x r: the row's
// kD / kC lanes (neighbours in the warp) each hold kC of its columns of the
// normalised operand's gradient in g and of the raw row in x (zeros past N).
// g becomes mul * r * (g - [norm > eps] x^ (x^ . g)); returns x^ . g, the
// same bits in all the row's lanes. Every lane of the warp calls it.
template <int kC>
__device__ __forceinline__ float chain_rule(float (&g)[kC], float (&x)[kC],
                                            float norm, float mul) {
  const float r = __fdiv_rn(1.f, fmaxf(norm, kCosEps));
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    x[c] = __fmul_rn(x[c], r);
    dot = __fmaf_rn(x[c], g[c], dot);
  }
#pragma unroll
  for (int o = 1; o < kD / kC; o <<= 1)
    dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
  const bool radial = norm > kCosEps;
  const float m = __fmul_rn(mul, r);
#pragma unroll
  for (int c = 0; c < kC; ++c)
    g[c] = __fmul_rn(m, radial ? __fsub_rn(g[c], __fmul_rn(x[c], dot)) : g[c]);
  return dot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int n, int e, int heads, long long total) {
  const long long w = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= total) return;
  const int h = static_cast<int>(w % heads);
  const long long token = w / heads;          // r * n + i
  const long long r = token / n;
  const int i = static_cast<int>(token % n);
  const size_t at = static_cast<size_t>(token) * e + h * kD + lane;
  const float s = warp_sum(out[at] * static_cast<float>(dout[at]));
  if (lane == 0) delta[(static_cast<size_t>(r) * heads + h) * n + i] = s;
}

// Pass 2. block index = ((window * heads + head) * k_tiles + tile) * batch + b
template <typename T, bool kCosine>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ scale,
            const float* __restrict__ bias, const float* __restrict__ mask,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int n, int e, int heads,
            int batch, int w0, int k_tiles) {
  constexpr int kQ = kDkdvQueryTile;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kKeyTile * kStride;
  float* q_s = v_s + kKeyTile * kStride;
  float* do_s = q_s + kQ * kStride;
  float* p_s = do_s + kQ * kStride;
  float* ds_s = p_s + kQ * kPStride;
  float* lse_s = ds_s + kQ * kPStride;
  float* dl_s = lse_s + kQ;
  float* norm_s = dl_s + kQ;  // kCosine: the key rows' norms

  int idx = blockIdx.x;
  const int b = idx % batch;
  idx /= batch;
  const int k0 = (idx % k_tiles) * kKeyTile;
  idx /= k_tiles;
  const int h = idx % heads;
  const int w = idx / heads;
  const size_t row = static_cast<size_t>(w) * batch + b;  // window-major
  const size_t base = row * n * e + h * kD;
  const size_t rh = (row * heads + h) * n;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w0 > 1 ? w : 0) * nn;

  stage<T, kKeyTile>(k_s, k + base, e, k0, n);
  stage<T, kKeyTile>(v_s, v + base, e, k0, n);
  if constexpr (kCosine) {  // the query loop's first barrier orders it
    __syncthreads();
    normalize_rows<T, kD>(k_s, kStride, kKeyTile, 1.f, kThreads, norm_s);
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tr = threadIdx.x / 8;         // key rows tr, tr + 32
  const int tc = (threadIdx.x % 8) * 4;   // columns tc .. tc + 3
  float acc_k[2][4], acc_v[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kQ) {
    __syncthreads();  // the previous query tile is consumed
    stage<T, kQ>(q_s, q + base, e, q0, n);
    stage<T, kQ>(do_s, dout + base, e, q0, n);
    stage_rows(lse_s, dl_s, lse + rh, delta + rh, q0, n, kQ);
    __syncthreads();
    if constexpr (kCosine) {
      normalize_rows<T, kD>(q_s, kStride, kQ, scale[h], kThreads, nullptr);
      __syncthreads();
    }
    float p[4][4], ds[4][4];
    scores<4>(q_s, k_s, do_s, v_s, lse_s, dl_s, bias_h, mask_w, n, q0, k0, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int at = (ty + 16 * a) * kPStride + tx + 16 * bb;
        p_s[at] = Io<T>::round(p[a][bb]);
        ds_s[at] = Io<T>::round(ds[a][bb]);
      }
    __syncthreads();
    const int nq = min(kQ, n - q0);
    for (int i = 0; i < nq; ++i) {
      const float4 g = *reinterpret_cast<const float4*>(do_s + i * kStride + tc);
      const float4 x = *reinterpret_cast<const float4*>(q_s + i * kStride + tc);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float pv = p_s[i * kPStride + tr + 32 * a];
        const float dsv = ds_s[i * kPStride + tr + 32 * a];
        acc_v[a][0] += pv * g.x; acc_v[a][1] += pv * g.y;
        acc_v[a][2] += pv * g.z; acc_v[a][3] += pv * g.w;
        acc_k[a][0] += dsv * x.x; acc_k[a][1] += dsv * x.y;
        acc_k[a][2] += dsv * x.z; acc_k[a][3] += dsv * x.w;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int j = k0 + tr + 32 * a;
    const size_t at = base + static_cast<size_t>(j) * e + tc;
    if constexpr (kCosine) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < n) load4<T>(k + at, x);
      chain_rule(acc_k[a], x, norm_s[tr + 32 * a], 1.f);
    }
    if (j < n) {
      Io<T>::template store<4>(dk + at, acc_k[a]);
      Io<T>::template store<4>(dv + at, acc_v[a]);
    }
  }
}

// Pass 3. block index = (head * q_tiles + tile) * groups + group; the block
// takes rows [group * rows_per_group, (group + 1) * rows_per_group) and writes
// its (32, N) dbias tile to db_out + group * H*N*N (db_out is dbias itself
// when there is one group); with kCosine also the sum of its rows' q^ . dq^n
// to dscale_part[block index].
template <typename T, bool kCosine>
__global__ void __launch_bounds__(kThreads)
dq_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, float* __restrict__ db_out,
                float* __restrict__ dscale_part, int n, int e,
                int heads, int batch, int w0, int rows, int q_tiles, int groups,
                int rows_per_group, int db_stride) {
  constexpr int kQ = kDqQueryTile;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kQ * kStride;
  float* k_s = do_s + kQ * kStride;
  float* v_s = k_s + kKeyTile * kStride;
  float* ds_s = v_s + kKeyTile * kStride;
  float* lse_s = ds_s + kQ * kPStride;
  float* dl_s = lse_s + kQ;
  float* db_s = dl_s + kQ;  // (kQ, db_stride): this block's tile of dbias
  float* norm_s = db_s + kQ * db_stride;  // kCosine: the query rows' norms

  int idx = blockIdx.x;
  const int group = idx % groups;
  idx /= groups;
  const int q0 = (idx % q_tiles) * kQ;
  const int h = idx / q_tiles;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tr = threadIdx.x / 8;         // query row of this thread's dq
  const int tc = (threadIdx.x % 8) * 4;   // columns tc .. tc + 3

  for (int i = threadIdx.x; i < kQ * db_stride; i += kThreads) db_s[i] = 0.f;
  float dscale = 0.f;  // kCosine: this thread's query row's q^ . dq^n, summed

  const int r_end = min(rows, (group + 1) * rows_per_group);
  for (int r = group * rows_per_group; r < r_end; ++r) {
    const int w = r / batch;  // window-major
    const size_t base = static_cast<size_t>(r) * n * e + h * kD;
    const size_t rh = (static_cast<size_t>(r) * heads + h) * n;
    const float* mask_w = mask == nullptr ? nullptr : mask + (w0 > 1 ? w : 0) * nn;
    // q_s, do_s, lse_s and dl_s are last read by scores(), which every thread
    // has left at the barrier before the dq sums below
    stage<T, kQ>(q_s, q + base, e, q0, n);
    stage<T, kQ>(do_s, dout + base, e, q0, n);
    stage_rows(lse_s, dl_s, lse + rh, delta + rh, q0, n, kQ);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};

    for (int k0 = 0; k0 < n; k0 += kKeyTile) {
      __syncthreads();  // the previous key tile is consumed
      stage<T, kKeyTile>(k_s, k + base, e, k0, n);
      stage<T, kKeyTile>(v_s, v + base, e, k0, n);
      __syncthreads();
      if constexpr (kCosine) {
        normalize_rows<T, kD>(k_s, kStride, kKeyTile, 1.f, kThreads, nullptr);
        if (k0 == 0)
          normalize_rows<T, kD>(q_s, kStride, kQ, scale[h], kThreads, norm_s);
        __syncthreads();
      }
      float p[2][4], ds[2][4];
      scores<2>(q_s, k_s, do_s, v_s, lse_s, dl_s, bias_h, mask_w, n, q0, k0, p, ds);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int i = ty + 16 * a;
          const int j = tx + 16 * bb;
          db_s[i * db_stride + k0 + j] += ds[a][bb];  // this thread's own cell
          ds_s[i * kPStride + j] = Io<T>::round(ds[a][bb]);
        }
      __syncthreads();
      const int nk = min(kKeyTile, n - k0);
      for (int j = 0; j < nk; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(k_s + j * kStride + tc);
        const float dsv = ds_s[tr * kPStride + j];
        acc[0] += dsv * x.x; acc[1] += dsv * x.y;
        acc[2] += dsv * x.z; acc[3] += dsv * x.w;
      }
    }
    const size_t at = base + static_cast<size_t>(q0 + tr) * e + tc;
    if constexpr (kCosine) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (q0 + tr < n) load4<T>(q + at, x);
      dscale += chain_rule(acc, x, norm_s[tr], scale[h]);
    }
    if (q0 + tr < n) Io<T>::template store<4>(dq + at, acc);
  }

  __syncthreads();
  if constexpr (kCosine) {  // lse_s is free: the 32 query rows' sums, in order
    if (threadIdx.x % 8 == 0) lse_s[tr] = dscale;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < kQ; ++i) sum += lse_s[i];
      dscale_part[blockIdx.x] = sum;
    }
  }
  float* dst = db_out + (static_cast<size_t>(group) * heads + h) * nn;
  const int count = min(kQ, n - q0);
  for (int i = threadIdx.x; i < count * n; i += kThreads) {
    const int qi = i / n;
    const int j = i % n;
    dst[static_cast<size_t>(q0 + qi) * n + j] = db_s[qi * db_stride + j];
  }
}

// Pass 4. dbias[c] = sum_g partial[g, c], one thread per cell, groups in order
__global__ void __launch_bounds__(kThreads)
group_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                 int groups, size_t cells) {
  const size_t c = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= cells) return;
  float sum = 0.f;
  for (int g = 0; g < groups; ++g) sum += partial[g * cells + c];
  dbias[c] = sum;
}

// Pass 5, kCosine. dscale[h] = the sum of head h's per-block partials of
// pass 3, (query tiles x groups) of them, in order; one thread a head
__global__ void __launch_bounds__(kThreads)
scale_sum_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                 int heads, int per_head) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= heads) return;
  float sum = 0.f;
  for (int i = 0; i < per_head; ++i) sum += partial[h * per_head + i];
  dscale[h] = sum;
}

// --- bf16: the backward on the tensor cores ----------------------------------
// (the tiles, their ring slot and their loads: window_tiles.cuh)

// P of one score: 2^((s + bias + mask) log2 e - lse log2 e), the same
// expression in every pass
__device__ __forceinline__ float prob(float s, float add, float lse2) {
  return exp2_ftz(fmaf(s + add, kLog2e, -lse2));
}

// 16 x 64 scores of a warp: acc = A B^T over the head width, A's 16 rows
// from row0 of tile a, B's 64 rows (16-row chunks below `chunks`) from tile b
__device__ __forceinline__ void scores16(float (&acc)[8][4], const bf16* a,
                                         int row0, const bf16* b, int chunks) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t fa[4];
    load_a(fa, a, kLd, row0, kk * 16);
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
      if (j2 >= chunks) break;
      uint32_t f[4];
      load_b(f, b, kLd, j2 * 16, kk * 16);
      mma_pair(acc[2 * j2], acc[2 * j2 + 1], fa, f);
    }
  }
}

// acc (16 x D) += A B over the 64-row k index (16-row chunks below
// `chunks`): A's fragments from the two accumulator blocks of each chunk of
// x, rounded to bf16; B from tile b's rows, read transposed
__device__ __forceinline__ void product16(float (&acc)[kD / 8][4],
                                          const float (&x)[8][4], const bf16* b,
                                          int chunks) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= chunks) break;
    uint32_t xa[4];
    acc_to_a(xa, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int d2 = 0; d2 < kD / 16; ++d2) {
      uint32_t f[4];
      load_b_trans(f, b, kLd, kk * 16, d2 * 16);
      mma_pair(acc[2 * d2], acc[2 * d2 + 1], xa, f);
    }
  }
}

// Write rows row (and row + 8, half 1) of a warp's 16 x D accumulator tile
// to dst (the row's head slice) as bf16, with the chain rule first under
// kCosine (raw row read from src, its norm, mul); returns the rows' dots
// x^ . g (kCosine), summed over the two halves in order
template <bool kCosine>
__device__ float write_rows(float (&acc)[kD / 8][4], const bf16* src, bf16* dst,
                            int e, int row, int n, const float* norms,
                            int nrow, float mul) {
  const int t = threadIdx.x & 3;
  float dots[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    float gr[8];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      gr[2 * j] = acc[j][2 * half];
      gr[2 * j + 1] = acc[j][2 * half + 1];
    }
    if constexpr (kCosine) {
      float x[8];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        if (r < n)
          Io<bf16>::load2(src + static_cast<size_t>(r) * e + j * 8 + 2 * t, x + 2 * j);
        else
          x[2 * j] = x[2 * j + 1] = 0.f;
      }
      dots[half] = chain_rule(gr, x, norms[nrow + 8 * half], mul);
    }
    if (r < n) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r) * e + j * 8 + 2 * t) =
            Io<bf16>::pack(gr[2 * j], gr[2 * j + 1]);
    }
  }
  return dots[0] + dots[1];
}

// Pass 2, bf16. dk and dv of one (r, h, 64-key tile) for each of two rows r
// of one window: block index = ((window * heads + head) * k_tiles + tile) *
// pairs + pair, rows window * B + 2 pair (+1). Each half of the block (4
// warps) takes one row; warp w of a half owns keys 16w .. +15. S^T = K Q^T
// and dP^T = V dO^T put P^T and dS^T in the accumulator layout, rounded to
// bf16 into the A fragments of dV += P^T dO and dK += dS^T Q. Each query
// tile arrives through a three-slot ring, copies two tiles ahead, with its
// lse and delta rows and the bias and mask tiles, which the two rows share.
template <bool kCosine>
__global__ void __launch_bounds__(kPairThreads)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const float* __restrict__ mask, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int n, int e, int heads, int batch, int w0,
                int k_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* own = reinterpret_cast<bf16*>(smem_raw);    // per half: k, v
  Slot* ring = reinterpret_cast<Slot*>(own + kPair * 2 * kT);
  float* norm_s = reinterpret_cast<float*>(ring + kRing);  // kCosine, per half

  const int pairs = (batch + 1) / 2;
  int idx = blockIdx.x;
  const int pair = idx % pairs;
  idx /= pairs;
  const int k0 = (idx % k_tiles) * kTile;
  idx /= k_tiles;
  const int h = idx % heads;
  const int w = idx / heads;
  const int half = threadIdx.x / kMmaThreads;
  const int ht = threadIdx.x % kMmaThreads;          // thread in the half
  const int b = 2 * pair + half;
  const bool real = b < batch;                       // an odd B's last half idles
  const size_t row = static_cast<size_t>(w) * batch + (real ? b : 0);
  const size_t base = row * n * e + h * kD;
  const size_t rh = (row * heads + h) * n;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w0 > 1 ? w : 0) * nn;
  const float qmul = kCosine ? scale[h] : 1.f;
  bf16* k_s = own + half * 2 * kT;
  bf16* v_s = k_s + kT;
  float* norms = norm_s + half * kTile;

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % kMmaWarps;   // in its half
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wk = warp * 16;           // this warp's first key in the tile

  auto load_q = [&](int it) {
    Slot& sl = ring[it % kRing];
    if (real) {
      load_tile(sl.a[half], q + base, e, it * kTile, n, ht);
      load_tile(sl.b[half], dout + base, e, it * kTile, n, ht);
      load_rows(sl.rows[half], lse + rh, delta + rh, it * kTile, n, ht);
    }
    load_add(sl.bias, sl.mask, kAddLd, bias_h, mask_w, it * kTile, k0, n);
  };
  const int tiles = mma_tiles(n);
  if (real) {
    load_tile(k_s, k + base, e, k0, n, ht);
    load_tile(v_s, v + base, e, k0, n, ht);
  }
  load_q(0);
  cp_async_commit();
  if (tiles > 1) load_q(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kCosine) {
    normalize_tile(k_s, 1.f, norms, ht);
    normalize_tile(ring[0].a[half], qmul, nullptr, ht);
    __syncthreads();
  }

  const bool active = real && k0 + wk < n;
  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  // Query tile `it` is visible to every warp when step `it` starts; the step
  // starts tile it + 2's copies into the slot tile it - 1 left.
  for (int it = 0; it < tiles; ++it) {
    const Slot& sl = ring[it % kRing];
    if (it + 2 < tiles) load_q(it + 2);
    cp_async_commit();
    if (active) {
      const bf16* qt = sl.a[half];
      const bf16* dot = sl.b[half];
      const float* lse_t = sl.rows[half];
      const int q0 = it * kTile;
      const int chunks = min(kTile, n - q0 + 15) / 16;
      float s[8][4], dp[8][4];
      scores16(s, k_s, wk, qt, chunks);
      scores16(dp, v_s, wk, dot, chunks);
      // element c of block j: key g (+8 for c >= 2), query 8j + 2t (+1 for
      // odd c); queries past n get P = 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = j * 8 + 2 * t + (c & 1);
          const int kl = wk + g + 8 * (c >> 1);
          const float add = sl.bias[i * kAddLd + kl] + sl.mask[i * kAddLd + kl];
          const float p = q0 + i < n ? prob(s[j][c], add, lse_t[i] * kLog2e) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - lse_t[kTile + i]);
        }
      product16(acc_v, s, dot, chunks);
      product16(acc_k, dp, qt, chunks);
    }
    cp_async_wait<1>();   // this thread's copies of tile it + 1 have landed
    __syncthreads();      // ... every thread's; tile it is consumed
    if (kCosine && it + 1 < tiles) {
      normalize_tile(ring[(it + 1) % kRing].a[half], qmul, nullptr, ht);
      __syncthreads();
    }
  }

  if (!real) return;
  const int key = k0 + wk + g;
  write_rows<kCosine>(acc_k, k + base, dk + base, e, key, n, norms, wk + g, 1.f);
  write_rows<false>(acc_v, nullptr, dv + base, e, key, n, nullptr, 0, 1.f);
}

// Pass 3, bf16. dq of one (r, h, 64-query tile) for each of two rows r of
// one window: block index = ((head * q_tiles + tile) * W0 + window) * pairs
// + pair, so the blocks that read one (head, tile, window)'s bias and mask
// run together. Each half of the block takes one row; warp w of a half owns
// queries 16w .. +15, their Q and dO fragments in registers; key and value
// tiles, with the bias and mask tiles the two rows share, pass through the
// ring. kCosine also writes the sum of its rows' q^ . dq^n to
// dscale_part[block].
template <bool kCosine>
__global__ void __launch_bounds__(kPairThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const float* __restrict__ mask, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq,
              float* __restrict__ dscale_part, int n, int e, int heads,
              int batch, int w0, int q_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* own = reinterpret_cast<bf16*>(smem_raw);    // per half: q, dout
  Slot* ring = reinterpret_cast<Slot*>(own + kPair * 2 * kT);
  float* norm_s = reinterpret_cast<float*>(ring + kRing);  // kCosine, per half
  float* dot_s = norm_s + kPair * kTile;  // kCosine: the rows' q^ . dq^n

  const int pairs = (batch + 1) / 2;
  int idx = blockIdx.x;
  const int pair = idx % pairs;
  idx /= pairs;
  const int w = idx % w0;
  idx /= w0;
  const int q0 = (idx % q_tiles) * kTile;
  const int h = idx / q_tiles;
  const int half = threadIdx.x / kMmaThreads;
  const int ht = threadIdx.x % kMmaThreads;
  const int b = 2 * pair + half;
  const bool real = b < batch;
  const size_t r = static_cast<size_t>(w) * batch + (real ? b : 0);
  const size_t base = r * n * e + h * kD;
  const size_t rh = (r * heads + h) * n;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w0 > 1 ? w : 0) * nn;
  const float qmul = kCosine ? scale[h] : 1.f;
  bf16* q_s = own + half * 2 * kT;
  bf16* do_s = q_s + kT;
  float* norms = norm_s + half * kTile;

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % kMmaWarps;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = warp * 16;

  auto load_kv = [&](int it) {
    Slot& sl = ring[it % kRing];
    if (real) {
      load_tile(sl.a[half], k + base, e, it * kTile, n, ht);
      load_tile(sl.b[half], v + base, e, it * kTile, n, ht);
    }
    load_add(sl.bias, sl.mask, kAddLd, bias_h, mask_w, q0, it * kTile, n);
  };
  const int tiles = mma_tiles(n);
  if (real) {
    load_tile(q_s, q + base, e, q0, n, ht);
    load_tile(do_s, dout + base, e, q0, n, ht);
  }
  load_kv(0);
  cp_async_commit();
  if (tiles > 1) load_kv(1);
  cp_async_commit();
  float lse2[2], dl[2];   // rows g and g + 8; rows past n read 0
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + wq + g + 8 * hr;
    lse2[hr] = real && i < n ? lse[rh + i] * kLog2e : 0.f;
    dl[hr] = real && i < n ? delta[rh + i] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kCosine) {
    normalize_tile(q_s, qmul, norms, ht);
    normalize_tile(ring[0].a[half], 1.f, nullptr, ht);
    __syncthreads();
  }

  const bool active = real && q0 + wq < n;
  uint32_t qa[kD / 16][4], oa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    load_a(qa[kk], q_s, kLd, wq, kk * 16);
    load_a(oa[kk], do_s, kLd, wq, kk * 16);
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const Slot& sl = ring[it % kRing];
    if (it + 2 < tiles) load_kv(it + 2);
    cp_async_commit();
    if (active) {
      const bf16* kt = sl.a[half];
      const bf16* vt = sl.b[half];
      const int k0 = it * kTile;
      const int chunks = min(kTile, n - k0 + 15) / 16;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (j2 >= chunks) break;
          uint32_t f[4];
          load_b(f, kt, kLd, j2 * 16, kk * 16);
          mma_pair(s[2 * j2], s[2 * j2 + 1], qa[kk], f);
          load_b(f, vt, kLd, j2 * 16, kk * 16);
          mma_pair(dp[2 * j2], dp[2 * j2 + 1], oa[kk], f);
        }
      // element c of block j: query g (+8 for c >= 2), key 8j + 2t (+1 for
      // odd c); keys past n get P = 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int at = (wq + g + 8 * hr) * kAddLd + j * 8 + 2 * t;
          const float2 bb = *reinterpret_cast<const float2*>(sl.bias + at);
          const float2 mm = *reinterpret_cast<const float2*>(sl.mask + at);
          const float add[2] = {bb.x + mm.x, bb.y + mm.y};
#pragma unroll
          for (int odd = 0; odd < 2; ++odd) {
            const int c = 2 * hr + odd;
            const int key = k0 + j * 8 + 2 * t + odd;
            const float p = key < n ? prob(s[j][c], add[odd], lse2[hr]) : 0.f;
            dp[j][c] = p * (dp[j][c] - dl[hr]);
          }
        }
      product16(acc, dp, kt, chunks);
    }
    cp_async_wait<1>();
    __syncthreads();
    if (kCosine && it + 1 < tiles) {
      normalize_tile(ring[(it + 1) % kRing].a[half], 1.f, nullptr, ht);
      __syncthreads();
    }
  }

  float dot = 0.f;
  if (real)
    dot = write_rows<kCosine>(acc, q + base, dq + base, e, q0 + wq + g, n,
                              norms, wq + g, qmul);
  if constexpr (kCosine) {   // the tile's rows' dots, summed in one order
    if (t == 0) dot_s[threadIdx.x / 4] = dot;  // rows g and g + 8 of the warp
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < kPairThreads / 4; ++i) sum += dot_s[i];
      dscale_part[blockIdx.x] = sum;
    }
  }
}

// Pass 4, bf16. dbias of one (head, 64-query tile, 64-key tile): block index
// = (head * q_tiles + query tile) * k_tiles + key tile. It walks all W0*B
// rows in order, their q, dout, k and v tiles through the ring, and sums the
// unrounded fp32 dS of each row into its registers (warp w: queries
// 16w .. +15), so each cell is summed in row order and written once. The
// bias + mask of the tile stays in registers while the window stays.
template <bool kCosine>
__global__ void __launch_bounds__(kMmaThreads)
dbias_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ mask, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dbias,
                 int n, int e, int heads, int batch, int w0, int rows,
                 int q_tiles, int k_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // kRing x (q, dout, k, v)
  float* row_ring = reinterpret_cast<float*>(ring + kRing * 4 * kT);

  int idx = blockIdx.x;
  const int k0 = (idx % k_tiles) * kTile;
  idx /= k_tiles;
  const int q0 = (idx % q_tiles) * kTile;
  const int h = idx / q_tiles;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;
  const float qmul = kCosine ? scale[h] : 1.f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = warp * 16;

  auto load_row = [&](int r) {
    bf16* st = ring + (r % kRing) * 4 * kT;
    const size_t base = static_cast<size_t>(r) * n * e + h * kD;
    load_tile(st, q + base, e, q0, n, threadIdx.x);
    load_tile(st + kT, dout + base, e, q0, n, threadIdx.x);
    load_tile(st + 2 * kT, k + base, e, k0, n, threadIdx.x);
    load_tile(st + 3 * kT, v + base, e, k0, n, threadIdx.x);
    const size_t rh = (static_cast<size_t>(r) * heads + h) * n;
    load_rows(row_ring + (r % kRing) * 2 * kTile, lse + rh, delta + rh, q0, n,
              threadIdx.x);
  };
  auto normalize = [&](int r) {
    bf16* st = ring + (r % kRing) * 4 * kT;
    normalize_tile(st, qmul, nullptr, threadIdx.x);
    normalize_tile(st + 2 * kT, 1.f, nullptr, threadIdx.x);
  };
  load_row(0);
  cp_async_commit();
  if (rows > 1) load_row(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kCosine) {
    normalize(0);
    __syncthreads();
  }

  const bool active = q0 + wq < n;
  const int chunks = min(kTile, n - k0 + 15) / 16;
  float add[8][4], db[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) db[j][c] = 0.f;
  int window = -1;

  for (int r = 0; r < rows; ++r) {
    const bf16* st = ring + (r % kRing) * 4 * kT;
    const float* lse_t = row_ring + (r % kRing) * 2 * kTile;
    const float* dl_t = lse_t + kTile;
    if (r + 2 < rows) load_row(r + 2);
    cp_async_commit();
    const int w = w0 > 1 ? r / batch : 0;   // window-major rows
    if (active && w != window) {
      // element c of block j: query g (+8 for c >= 2), key 8j + 2t (+1)
      window = w;
      const float* mask_w = mask == nullptr ? nullptr : mask + w * nn;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = q0 + wq + g + 8 * (c >> 1);
          const int key = k0 + j * 8 + 2 * t + (c & 1);
          const size_t at = static_cast<size_t>(qi) * n + key;
          add[j][c] = (qi < n && key < n)
                          ? bias_h[at] + (mask_w == nullptr ? 0.f : mask_w[at])
                          : 0.f;
        }
    }
    if (active) {
      float s[8][4], dp[8][4];
      scores16(s, st, wq, st + 2 * kT, chunks);
      scores16(dp, st + kT, wq, st + 3 * kT, chunks);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = wq + g + 8 * (c >> 1);
          const bool in = q0 + i < n && k0 + j * 8 + 2 * t + (c & 1) < n;
          const float p = in ? prob(s[j][c], add[j][c], lse_t[i] * kLog2e) : 0.f;
          db[j][c] += p * (dp[j][c] - dl_t[i]);
        }
    }
    cp_async_wait<1>();
    __syncthreads();
    if (kCosine && r + 1 < rows) {
      normalize(r + 1);
      __syncthreads();
    }
  }

  if (!active) return;
  float* dst = dbias + h * nn;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = q0 + wq + g + 8 * (c >> 1);
      const int key = k0 + j * 8 + 2 * t + (c & 1);
      if (qi < n && key < n) dst[static_cast<size_t>(qi) * n + key] = db[j][c];
    }
}

// passes 2 and 3: each row's own two tiles, the ring, and the rows' norms
// and dots
constexpr int pass_mma_smem() {
  return kPair * 2 * kT * 2 + kRing * static_cast<int>(sizeof(Slot)) +
         2 * kPair * kTile * 4;
}

constexpr int dbias_mma_smem() {
  return kRing * 4 * kT * 2 + kRing * 2 * kTile * 4;
}

// The bf16 backward: delta, then passes 2-4 on the tensor cores, and
// kCosine's dscale sum. mask may be null (no mask). dscale_part holds
// heads * mma_tiles(n) * W0 * ceil(B / 2) floats, one per pass-3 block
// (scale_partials at least that).
template <bool kCosine>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const float* scale,
               const float* bias, const float* mask, const float* out,
               const bf16* dout, const float* lse, float* delta,
               float* dscale_part, bf16* dq, bf16* dk, bf16* dv, float* dbias,
               float* dscale, int rows, int n, int e, int heads, int w0,
               int scale_partials, cudaStream_t stream) {
  const int batch = rows / w0;
  const int tiles = mma_tiles(n);
  const int pairs = (batch + 1) / 2;
  const long long blocks = static_cast<long long>(w0) * pairs * heads * tiles;
  const long long total = static_cast<long long>(rows) * n * heads;
  const long long delta_blocks = (total + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL || delta_blocks > 0x7fffffffLL ||
      (kCosine && (scale == nullptr || dscale == nullptr || scale_partials < blocks)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = dbias_mma_smem();
  constexpr int kPassSmem = pass_mma_smem();
  static const cudaError_t attr[3] = {   // once per instantiation
      cudaFuncSetAttribute(dbias_mma_kernel<kCosine>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem),
      cudaFuncSetAttribute(dkdv_mma_kernel<kCosine>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kPassSmem),
      cudaFuncSetAttribute(dq_mma_kernel<kCosine>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kPassSmem)};
  for (const cudaError_t a : attr)
    if (a != cudaSuccess) return static_cast<int>(a);
  cudaError_t err;

  delta_kernel<bf16><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      out, dout, delta, n, e, heads, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dkdv_mma_kernel<kCosine><<<static_cast<unsigned>(blocks), kPairThreads, kPassSmem, stream>>>(
      q, k, v, dout, scale, bias, mask, lse, delta, dk, dv, n, e, heads, batch,
      w0, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dq_mma_kernel<kCosine><<<static_cast<unsigned>(blocks), kPairThreads, kPassSmem, stream>>>(
      q, k, v, dout, scale, bias, mask, lse, delta, dq, dscale_part, n, e,
      heads, batch, w0, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dbias_mma_kernel<kCosine><<<heads * tiles * tiles, kMmaThreads, kSmem, stream>>>(
      q, k, v, dout, scale, bias, mask, lse, delta, dbias, n, e, heads, batch,
      w0, rows, tiles, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if constexpr (kCosine) {
    scale_sum_kernel<<<(heads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        dscale_part, dscale, heads, static_cast<int>(blocks / heads));
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

// pass 2's shared memory; kCosine keeps the key rows' norms too
template <bool kCosine>
constexpr size_t dkdv_smem() {
  return (2 * kKeyTile * kStride + 2 * kDkdvQueryTile * kStride +
          2 * kDkdvQueryTile * kPStride + 2 * kDkdvQueryTile +
          (kCosine ? kKeyTile : 0)) * sizeof(float);
}

int key_tiles(int n) { return (n + kKeyTile - 1) / kKeyTile; }

int db_stride(int n) { return key_tiles(n) * kKeyTile + kDbPad; }

// pass 3's shared memory; kCosine keeps the query rows' norms too
template <bool kCosine>
size_t dq_smem(int n) {
  return (2 * kDqQueryTile * kStride + 2 * kKeyTile * kStride +
          kDqQueryTile * kPStride + 2 * kDqQueryTile +
          static_cast<size_t>(kDqQueryTile) * db_stride(n) +
          (kCosine ? kDqQueryTile : 0)) * sizeof(float);
}

int query_tiles(int n) { return (n + kDqQueryTile - 1) / kDqQueryTile; }

// How many groups pass 3 cuts the rows into: the count (at most kMaxGroups)
// that runs its H * q_tiles * groups blocks over the card's block slots in
// the least waves x rows a group, each group past the first charged a tenth
// of a row for its workspace tile. Returns 0 on a CUDA error.
template <typename T, bool kCosine>
int row_groups(int rows, int n, int heads) {
  const size_t smem = dq_smem<kCosine>(n);
  if (cudaFuncSetAttribute(dq_dbias_kernel<T, kCosine>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dq_dbias_kernel<T, kCosine>, kThreads, smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long tiles = static_cast<long long>(heads) * query_tiles(n);
  int best = 1;
  double best_cost = 0.;
  for (int g = 1; g <= std::min(rows, kMaxGroups); ++g) {
    const int per = (rows + g - 1) / g;
    const int used = (rows + per - 1) / per;
    if (used != g) continue;  // the same cut as a smaller count
    const long long waves = (tiles * g + slots - 1) / slots;
    const double cost = static_cast<double>(waves) * per + (g > 1 ? 0.1 * g : 0.);
    if (g == 1 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// kCosine reads scale (H,) and writes dscale (H,) through the workspace
// dscale_part of at least H * query_tiles(n) * groups floats
// (scale_partials); K6 passes nulls and 0 for those.
template <typename T, bool kCosine>
int launch(const void* q, const void* k, const void* v, const float* scale,
           const float* bias, const float* mask, const float* out,
           const void* dout, const float* lse, float* delta, float* partial,
           float* dscale_part, void* dq, void* dk, void* dv, float* dbias,
           float* dscale, int rows, int n, int e, int heads, int w0,
           int workspace_groups, int scale_partials, cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(dout);
  const int batch = rows / w0;
  cudaError_t err;

  // also opts pass 3's shared memory in
  const int groups = row_groups<T, kCosine>(rows, n, heads);
  if (groups < 1 || (groups > 1 && workspace_groups < groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = query_tiles(n);
  if (kCosine && (scale == nullptr || dscale == nullptr ||
                  scale_partials < heads * q_tiles * groups))
    return static_cast<int>(cudaErrorInvalidValue);

  const long long total = static_cast<long long>(rows) * n * heads;
  const long long delta_blocks = (total + kThreads / 32 - 1) / (kThreads / 32);
  const int k_tiles = key_tiles(n);
  const long long dkdv_blocks = static_cast<long long>(rows) * heads * k_tiles;
  if (delta_blocks > 0x7fffffffLL || dkdv_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  delta_kernel<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      out, gg, delta, n, e, heads, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  constexpr size_t kDkdvSmem = dkdv_smem<kCosine>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, kCosine>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDkdvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, kCosine>
      <<<static_cast<unsigned>(dkdv_blocks), kThreads, kDkdvSmem, stream>>>(
          qq, kk, vv, gg, scale, bias, mask, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), n, e, heads, batch, w0, k_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int rows_per_group = (rows + groups - 1) / groups;
  dq_dbias_kernel<T, kCosine>
      <<<static_cast<unsigned>(heads * q_tiles * groups), kThreads,
         dq_smem<kCosine>(n), stream>>>(
          qq, kk, vv, gg, scale, bias, mask, lse, delta, static_cast<T*>(dq),
          groups > 1 ? partial : dbias, dscale_part, n, e, heads, batch, w0,
          rows, q_tiles, groups, rows_per_group, db_stride(n));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if (groups > 1) {
    const size_t cells = static_cast<size_t>(heads) * n * n;
    group_sum_kernel<<<static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(partial, dbias, groups, cells);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if constexpr (kCosine) {
    scale_sum_kernel<<<(heads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        dscale_part, dscale, heads, q_tiles * groups);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

template <bool kCosine>
bool shapes_ok(int rows, int n, int e, int heads, int w0) {
  return rows > 0 && n > 0 && heads > 0 && w0 > 0 && e % heads == 0 &&
         e / heads == kD && rows % w0 == 0 && dq_smem<kCosine>(n) <= kMaxSmem &&
         static_cast<long long>(heads) * query_tiles(n) * kMaxGroups <=
             0x7fffffffLL;
}

template <bool kCosine>
int max_n() {
  int n = kKeyTile;
  while (dq_smem<kCosine>(n + kKeyTile) <= kMaxSmem) n += kKeyTile;
  return n;
}

template <bool kCosine>
int groups_for(int rows, int n, int e, int heads, int w0, int dtype) {
  if (!shapes_ok<kCosine>(rows, n, e, heads, w0)) return 0;
  if (dtype == 0) return row_groups<float, kCosine>(rows, n, heads);
  if (dtype == 1) return rows;   // bf16: sizes dscale_part, one per row at most
  return 0;
}

template <bool kCosine>
int dispatch(const void* q, const void* k, const void* v, const void* scale,
             const void* bias, const void* mask, const void* out,
             const void* dout, const void* lse, void* delta, void* partial,
             void* dscale_part, void* dq, void* dk, void* dv, void* dbias,
             void* dscale, int rows, int n, int e, int heads, int w0, int dtype,
             int workspace_groups, int scale_partials, void* stream) {
  if (!shapes_ok<kCosine>(rows, n, e, heads, w0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ss = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  const float* mm = static_cast<const float*>(mask);
  const float* ll = static_cast<const float*>(lse);
  const float* oo = static_cast<const float*>(out);
  float* dl = static_cast<float*>(delta);
  float* pp = static_cast<float*>(partial);
  float* sp = static_cast<float*>(dscale_part);
  float* db = static_cast<float*>(dbias);
  float* ds = static_cast<float*>(dscale);
  if (dtype == 0)
    return launch<float, kCosine>(q, k, v, ss, bb, mm, oo, dout, ll, dl, pp, sp,
                                  dq, dk, dv, db, ds, rows, n, e, heads, w0,
                                  workspace_groups, scale_partials, s);
  if (dtype == 1)
    return launch_mma<kCosine>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), ss, bb, mm, oo,
        static_cast<const bf16*>(dout), ll, dl, sp, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), db, ds, rows, n, e,
        heads, w0, scale_partials, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// the largest N the kernel takes: pass 3 keeps a (32, N) fp32 tile of dbias in
// shared memory
extern "C" int window_attention_bwd_max_n() { return max_n<false>(); }
extern "C" int cosine_window_attention_bwd_max_n() { return max_n<true>(); }

// Groups of rows pass 3 will use for these shapes on the current device
// (dtype: 0 = float32, 1 = bfloat16). float32: with more than one, the
// caller allocates the fp32 workspace `partial` of (groups, H, N, N).
// bfloat16: the row count; dbias has a pass of its own, so `partial` is not
// read, and pass 3 writes at most one dscale partial per row and query tile.
// 0 on an error or on shapes the kernel does not take.
extern "C" int window_attention_bwd_row_groups(int rows, int n, int e, int heads,
                                               int w0, int dtype) {
  return groups_for<false>(rows, n, e, heads, w0, dtype);
}

// The same for K12's backward, whose pass 3 is another compiled kernel; the
// caller also allocates dscale_part of H * ceil(N / 32) * groups floats.
extern "C" int cosine_window_attention_bwd_row_groups(int rows, int n, int e,
                                                      int heads, int w0,
                                                      int dtype) {
  return groups_for<true>(rows, n, e, heads, w0, dtype);
}

// rows = W0 * B. dtype of q, k, v, dout, dq, dk, dv: 0 = float32,
// 1 = bfloat16; out, bias, mask, lse, delta, partial and dbias are float32.
// A null mask is no mask (zeros), read from nowhere.
// Returns a cudaError_t (0 on success). The caller checks shapes, contiguity
// and 16-byte alignment and allocates the fp32 workspaces: delta (rows, H, N)
// and, for float32 when window_attention_bwd_row_groups(...) is more than 1,
// partial of that many (H, N, N) tiles; workspace_groups short of it is
// refused.

// K6.
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* mask,
                                    const void* out, const void* dout,
                                    const void* lse, void* delta, void* partial,
                                    void* dq, void* dk, void* dv, void* dbias,
                                    int rows, int n, int e, int heads, int w0,
                                    int dtype, int workspace_groups,
                                    void* stream) {
  return dispatch<false>(q, k, v, nullptr, bias, mask, out, dout, lse, delta,
                         partial, nullptr, dq, dk, dv, dbias, nullptr, rows, n,
                         e, heads, w0, dtype, workspace_groups, 0, stream);
}

// K12's backward: as K6's from raw q and k, the per-head scale (H,) fp32 and
// cosine_window_attention_fwd_lse's out32 and lse, with its groups
// (cosine_window_attention_bwd_row_groups); also writes dscale (H,) fp32
// through the workspace dscale_part of scale_partials floats, at least
// H * ceil(N / 32) * groups.
extern "C" int cosine_window_attention_bwd(
    const void* q, const void* k, const void* v, const void* scale,
    const void* bias, const void* mask, const void* out, const void* dout,
    const void* lse, void* delta, void* partial, void* dscale_part, void* dq,
    void* dk, void* dv, void* dbias, void* dscale, int rows, int n, int e,
    int heads, int w0, int dtype, int workspace_groups, int scale_partials,
    void* stream) {
  return dispatch<true>(q, k, v, scale, bias, mask, out, dout, lse, delta,
                        partial, dscale_part, dq, dk, dv, dbias, dscale, rows,
                        n, e, heads, w0, dtype, workspace_groups,
                        scale_partials, stream);
}
