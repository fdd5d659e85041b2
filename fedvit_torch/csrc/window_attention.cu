// Windowed multi-head softmax attention with two additive fp32 score terms, a
// per-head relative-position bias and a per-window shift mask: the forward of
// K5, the attention of every SwinV2 block; and of K12, the same with SwinV2's
// scaled-cosine scores, q and k normalised inside the kernel.
//
// Replaces the TPU kernels fedvit_tpu/ops/flash_attention.py::_wflat_fwd_kernel
// (no grad: serving) and ::_wflat_fwd_stats_kernel (under grad), launched by
// _wflat_fwd_rule and _wflat_fwd_rule_vjp through pl.pallas_call. The TPU's
// stats variant saves the row max and 1/sum in lane-padded blocks; this one
// saves lse = max + log(sum), (W0*B, H, N) fp32, which is what a backward
// needs to rebuild P, and the output before its rounding to the storage type,
// (W0*B, N, E) fp32: the backward's delta_i = sum_c dout_ic out_ic stands in
// for sum_j P_ij dP_ij only as exactly as out is sum_j P_ij v_j. From a bf16
// out, where one key takes nearly all of a row's weight, dP_ij - delta_i is
// lost in out's rounding, and the gradients of q and k with it.
//
//   q, k, v (W0*B, N, E)  window-major rows: rows [w*B, (w+1)*B) belong to
//                         window w; heads head-major along E, each d = E/H =
//                         32 wide (every SwinV2 the registry builds; others
//                         refused)
//   bias    (H, N, N)     fp32, added to head h's scores
//   mask    (W0, N, N)    fp32, added to the scores of window w's rows; with
//                         W0 = 1 every row uses mask[0]; null: no mask, and
//                         no bytes read for it
//   out     (W0*B, N, E)  head h writes its column slice [h*d, (h+1)*d)
//   lse     (W0*B, H, N)  flagged entry only: log sum_j exp(s_ij), fp32
//   out32   (W0*B, N, E)  flagged entry only: out before rounding, fp32
//
//   out_h = softmax(q_h k_h^T + bias[h] + mask[w]) v_h
//
// No score scale: the caller folds it into q. Scores, the running max and the
// running sum are fp32; each score is s + (bias + mask), the two terms summed
// first, as the backward adds them. The flagged entry is the same code with
// two more stores, so its output is bit-identical to the flagless one's.
//
// K12 (the cosine_ entries) replaces ::_wcos_fwd_kernel (launched by
// _wcos_fwd_rule): the op-level SwinV2 attention of
// ops/attention.py::windowed_cosine_attention_flat on RAW q and k, with
//
//   scale   (H,)          fp32, head h's logit scale (exp of the clamped
//                         logit_scale, as the model computes it)
//   out_h = softmax(scale[h] q^_h k^_h^T + bias[h] + mask[w]) v_h,
//   x^ = x / max(||x||, 1e-6) over each row's head slice of d = 32.
//
// It is K5's kernel compiled with kCosine: when a q or k tile is staged, each
// row's head slice is normalised in place and rounded to the input type, q
// as q * (r * scale[h]) and k as k * r with r = 1 / max(||x||, 1e-6), in the
// TPU kernel's order (bf16: window_tiles.cuh::normalize_row, which K12's
// backward calls on the same rows, so the two see the same bits; fp32:
// common.cuh::normalize_rows); the scores are then K5's.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 16 ex2 a clock on
// each of 132 SMs at 1.98 GHz = 4.18 T/s) at the SwinV2-L@384 stage shapes
// for a batch of 32, bf16, (W0, N, E, H), from the function's own bytes (q,
// k, v, bias and mask read, out written; lse and out32 are the port's own
// leftovers for the backward):
//   stage 0 (16, 576,  192,  6): 453.0 + bias 8.0 + mask 21.2 = 482.2 MB
//            -> 144 us; 130.5 GFLOP -> 132 us; 1019 M exponentials -> 244 us
//   stage 1 ( 4, 576,  384, 12): 226.5 + 15.9 + 5.3 = 247.7 MB -> 74 us;
//            65.2 GFLOP -> 66 us; 510 M exponentials -> 122 us
//   stage 2 ( 1, 576,  768, 24): 113.2 + 31.9 (no mask) = 145.1 MB -> 43 us;
//            32.6 GFLOP -> 33 us; 255 M exponentials -> 61 us
//   stage 3 ( 1, 144, 1536, 48): 56.6 + 4.0 = 60.6 MB -> 18 us;
//            4.1 GFLOP -> 4 us; 32 M exponentials -> 8 us
// (at 8 images: 42.5 / 23.2 / 18.0 / 5.4 us of bytes, 61 / 30 / 15 / 2 us
// of exponentials). At d = 32 a score costs one exponential against 64 flops
// of the tensor cores, so at N = 576 the special-function units, not the
// bytes, set the floor, and the bias and mask bytes are as many as the
// q/k/v bytes they go with. A forward launches it 24 times (2, 2, 18, 2 over
// the stages).
//
// Design, bf16 (window_mma_fwd_kernel): FlashAttention-2's forward on
// mma.sync m16n8k16 at d = 32, the loop of window_attention_bwd.cu's dq pass
// with the online softmax in place of the gradient:
// - one block a (head, window, 64-query tile, group of the window's rows),
//   256 threads in two halves of 4 warps; the block walks the group's rows
//   four at a time, half h taking rows 2h and 2h + 1 of each four, and warp
//   w of a half computes queries 16w .. +15 of both rows, their Q fragments
//   in registers: two independent chains of products, exponentials and
//   shuffles in one instruction stream, which hide each other's latency
//   (one block of 8 warps fills an SM's shared memory);
// - the bias (+ mask) of the 64-query tile, (64, N) fp32, is loaded once a
//   block into shared memory (the slab) and serves every row of the group:
//   the block reads it once where a per-row design reads it B times, and one
//   read of a slab cell serves both rows of a warp. The bias arrives by
//   cp.async a key tile at a time beside the first four rows' key and value
//   tiles; the mask is added into it in place, from registers loaded one
//   tile ahead, behind one barrier a tile of those rows only. A null mask
//   moves no bytes. Past N = 576 (no SwinV2 the registry builds has longer
//   windows) the slab does not fit and each score reads its bias and mask
//   from L2 instead;
// - each row's key and value tiles (32 x 32 bf16) stream through a
//   three-slot cp.async ring, copies two tiles ahead, one barrier a tile;
//   the flattened (four rows, key tile) sequence keeps the ring full across
//   rows; each row's Q tile arrives with its first key tile into one of up
//   to three buffers (as many as keep a buffer from being rewritten before it
//   is read). At N = 576 the ring, the Q buffers and the slab take 226 KB of
//   the 227 a block may have, which is what sets 32-key tiles and four rows;
// - S = Q K^T in fp32, two k16 steps; S + (bias + mask); keys past N score
//   -inf; the running max and sum in fp32, p = 2^(s log2 e - m log2 e) by
//   ex2.approx, one fma and one ex2 a score; P rounded to bf16 in the
//   accumulator-to-A-fragment layout straight into P V (as attention_fwd.cuh
//   does: the TPU kernel rounds the normalised weights, this kernel the
//   unnormalised ones, and divides the fp32 sum at the end);
// - the output is normalised once at the end of a row: out32 = o / l, out =
//   round(out32), so out32 rounds to out bit for bit;
// - the grid runs head-major, then window, query tile and group, so the
//   blocks that read one (head, window)'s keys and values run together out
//   of L2. The groups a window's rows are cut into are the count that runs
//   the grid in the least waves x (rows a block + the slab, which costs two
//   rows' key and value bytes, four with a mask) (the host picks it);
// - no atomics: every run gives the same bits.
//
// Design, fp32 (window_simt_fwd_kernel): plain SIMT code on the fp32 cores,
// written to be right and readable; no model path runs fp32 windowed attention at a
// size that matters. One block takes one (row, head, 32-query tile); its
// query rows are staged once in shared memory as fp32 and the keys and values
// pass through in tiles of 64 rows, so any N works. Each of the 4 warps owns
// 8 query rows; for a chunk of 32 keys a lane holds one key row in registers,
// scores it against the 8 queries, adds bias[h][query][key] +
// mask[w][query][key] (the 32 lanes read 128 contiguous bytes of each), then
// the warp runs the online-softmax update and accumulates P.V with each lane
// owning one output column. Rows past N are staged as zeros and score -inf.

#include <math.h>

#include "window_tiles.cuh"

namespace {

// --- fp32: SIMT on the fp32 cores -------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeyTile = 64;                        // key rows per staged tile

template <bool kLse, bool kCosine>
__global__ void __launch_bounds__(kThreads)
window_simt_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ out32, int n, int e, int heads, int batch,
                int w0, int q_tiles) {
  using T = float;
  constexpr int D = kD;
  constexpr int kVec = Io<T>::kVec;
  constexpr int kVecPerRow = D / kVec;
  constexpr int kStride = D + 4;  // padded fp32 row: conflict-free 16-byte reads
  constexpr int kCols = D / 32;   // output columns per lane
  constexpr int kR = kRowsPerWarp;

  __shared__ __align__(16) float q_s[kQueryTile * kStride];
  __shared__ __align__(16) float k_s[kKeyTile * kStride];
  __shared__ __align__(16) float v_s[kKeyTile * D];
  __shared__ __align__(16) float p_s[kWarps * kR * 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // block index = ((window * heads + head) * q_tiles + tile) * batch + b
  int idx = blockIdx.x;
  const int b = idx % batch;
  idx /= batch;
  const int q0 = (idx % q_tiles) * kQueryTile;
  idx /= q_tiles;
  const int h = idx % heads;
  const int w = idx / heads;
  const size_t row = static_cast<size_t>(w) * batch + b;  // window-major
  const size_t base = row * n * e + h * D;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w0 > 1 ? w : 0) * nn;

  // rows [row0, row0 + count) of one head slice of src to fp32 shared memory;
  // rows past n become zeros
  auto stage = [&](float* dst, int stride, const T* src, int row0, int count) {
    for (int i = tid; i < count * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      float x[kVec];
      if (row0 + r < n) {
        Io<T>::load(src + base + static_cast<size_t>(row0 + r) * e + c, x);
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

  stage(q_s, kStride, q, q0, kQueryTile);
  if constexpr (kCosine) {  // the key loop's first barrier orders it
    __syncthreads();
    normalize_rows<T, D>(q_s, kStride, kQueryTile, scale[h], kThreads, nullptr);
  }

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
  const int qrow0 = q0 + warp * kR;  // this warp's first query row

  for (int t0 = 0; t0 < n; t0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    stage(k_s, kStride, k, t0, kKeyTile);
    stage(v_s, D, v, t0, kKeyTile);
    __syncthreads();
    if constexpr (kCosine) {
      normalize_rows<T, D>(k_s, kStride, kKeyTile, 1.f, kThreads, nullptr);
      __syncthreads();
    }
    const int nk = min(kKeyTile, n - t0);

    for (int c0 = 0; c0 < nk; c0 += 32) {
      const int key = c0 + lane;
      // bias[h][query][key] + mask[w][query][key] for the 8 queries, asked for
      // before the dot products that hide their latency
      float add[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const size_t at = static_cast<size_t>(qrow0 + r) * n + t0 + key;
        add[r] = (key < nk && qrow0 + r < n)
                     ? bias_h[at] + (mask_w == nullptr ? 0.f : mask_w[at])
                     : 0.f;
      }
      float kr[D];
      const float4* k4 = reinterpret_cast<const float4*>(k_s + key * kStride);
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 t = k4[i];
        kr[4 * i] = t.x; kr[4 * i + 1] = t.y; kr[4 * i + 2] = t.z; kr[4 * i + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4* q4 = reinterpret_cast<const float4*>(q_w + r * kStride);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) {
          const float4 t = q4[i];
          acc = fmaf(t.x, kr[4 * i], acc);
          acc = fmaf(t.y, kr[4 * i + 1], acc);
          acc = fmaf(t.z, kr[4 * i + 2], acc);
          acc = fmaf(t.w, kr[4 * i + 3], acc);
        }
        const float s = key < nk ? acc + add[r] : -INFINITY;
        // lane 0 always holds a real key and the mask is finite (-100 across
        // regions), so the chunk max is finite
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
          for (int c = 0; c < kCols; ++c)
            vv[j][c] = v_s[(c0 + kk + j) * D + lane * kCols + c];
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
    const int qrow = qrow0 + r;
    if (kLse && qrow < n && lane == 0)
      lse[(row * heads + h) * n + qrow] = m[r] + logf(sum);
    if (qrow < n) {
      float res[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) res[c] = o[r][c] * inv;
      const size_t at = base + static_cast<size_t>(qrow) * e + lane * kCols;
      Io<T>::template store<kCols>(out + at, res);
      if (kLse) Io<float>::template store<kCols>(out32 + at, res);
    }
  }
}

// --- bf16: FlashAttention-2 on the tensor cores ------------------------------

constexpr int kQuad = 4;                // rows of a window in flight a block
constexpr int kKeys = 32;               // keys of a streamed tile
constexpr int kKT = kKeys * kLd;        // elements of a key or value tile
constexpr int kSlabPad = 8;             // a slab row is 32 t + 8 floats: the 8
                                        // rows of a fragment read fall in 8
                                        // bank groups
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int key_tiles(int n) { return (n + kKeys - 1) / kKeys; }

// Q tile buffers: enough that the buffer a quad's Q arrives in was read by
// the quad before it ahead of the copy, which starts two steps earlier
// (key tiles * buffers >= 3)
__host__ __device__ constexpr int q_buffers(int tiles) {
  return tiles >= 3 ? 1 : (tiles == 2 ? 2 : 3);
}

// shared memory of window_mma_fwd_kernel: the ring of key and value tiles,
// the Q buffers and, with the slab, the (64, N) fp32 bias (+ mask) of the
// block's query tile
constexpr size_t mma_smem(int n, bool slab) {
  return (kRing * kQuad * 2 * kKT + q_buffers(key_tiles(n)) * kQuad * kT) *
             sizeof(bf16) +
         (slab ? kTile * (key_tiles(n) * kKeys + kSlabPad) * sizeof(float) : 0);
}

// One block: (head, window, 64-query tile, group of the window's rows), block
// index = ((head * W0 + window) * q_tiles + tile) * groups + group. The group
// takes rows [group * per_group, +per_group) of the window (per_group a
// multiple of 4) four at a time: half `half` of the block takes rows 2 half
// and 2 half + 1 of each four, and each of its warps computes both, one
// chain of instructions for each. kSlab keeps the (64, N) bias (+ mask) in
// shared memory; without it each score reads them from L2.
template <bool kLse, bool kCosine, bool kSlab>
__global__ void __launch_bounds__(kPairThreads)
window_mma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ lse, float* __restrict__ out32, int n,
                      int e, int heads, int batch, int w0, int q_tiles,
                      int groups, int per_group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = key_tiles(n);           // key tiles a row
  const int nq = q_buffers(tiles);
  const int slab_ld = tiles * kKeys + kSlabPad;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);    // slot: k, v of 4 rows
  bf16* q_buf = ring + kRing * kQuad * 2 * kKT;      // buffer: q of 4 rows
  float* slab = reinterpret_cast<float*>(q_buf + nq * kQuad * kT);

  int idx = blockIdx.x;
  const int group = idx % groups;
  idx /= groups;
  const int q0 = (idx % q_tiles) * kTile;
  idx /= q_tiles;
  const int w = idx % w0;
  const int h = idx / w0;
  const int b0 = group * per_group;
  const int rows = min(batch, b0 + per_group) - b0;   // rows of this block
  const int steps = (rows + kQuad - 1) / kQuad * tiles;   // (quad, key tile)s
  const int half = threadIdx.x / kMmaThreads;
  const int ht = threadIdx.x % kMmaThreads;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* bias_h = bias + h * nn;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w0 > 1 ? w : 0) * nn;
  const float qmul = kCosine ? scale[h] : 1.f;

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % kMmaWarps;   // in its half
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = warp * 16;            // this warp's first query in the tile

  // row r (0, 1) of this half in quad i, of the block's rows; past `rows`
  // (the last quad of a group) it is idle
  auto row_of = [&](int i, int r) { return kQuad * i + 2 * half + r; };
  auto base_of = [&](int i, int r) {
    return (static_cast<size_t>(w) * batch + b0 + row_of(i, r)) * n * e + h * kD;
  };
  auto slot = [&](int s, int r) {
    return ring + ((s % kRing) * kQuad + 2 * half + r) * 2 * kKT;
  };
  auto q_tile = [&](int i, int r) {
    return q_buf + ((i % nq) * kQuad + 2 * half + r) * kT;
  };

  // step s's copies: the key and value tiles of (quad i, key tile kt), the
  // quad's Q tiles with its first key tile, and the first quad's bias
  // columns of the tile
  auto load_step = [&](int s, int i, int kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row_of(i, r) < rows) {
        const size_t base = base_of(i, r);
        load_tile<kKeys>(slot(s, r), k + base, e, kt * kKeys, n, ht);
        load_tile<kKeys>(slot(s, r) + kKT, v + base, e, kt * kKeys, n, ht);
        if (kt == 0) load_tile(q_tile(i, r), q + base, e, q0, n, ht);
      }
    }
    if (kSlab && i == 0)
      load_add<kKeys>(slab + kt * kKeys, nullptr, slab_ld, bias_h, nullptr, q0,
                      kt * kKeys, n);
  };
  // kSlab with a mask: this thread's share of mask tile kt (64 x 32), loaded
  // a tile ahead, added into the slab once the bias tile has landed
  constexpr int kMaskShare = kTile * kKeys / kPairThreads;
  float mk[kMaskShare];
  auto load_mask = [&](int kt) {
#pragma unroll
    for (int u = 0; u < kMaskShare; ++u) {
      const int cell = threadIdx.x + u * kPairThreads;
      const int qi = q0 + cell / kKeys, key = kt * kKeys + cell % kKeys;
      mk[u] = qi < n && key < n ? mask_w[static_cast<size_t>(qi) * n + key] : 0.f;
    }
  };
  // kCosine: step s's k tiles (the half's two rows, 64 rows of 32) and, at a
  // quad's first key tile, its two q tiles (128 rows), one thread a row
  auto normalize = [&](int s, int i, int kt) {
    for (int x = ht; x < 2 * kKeys; x += kMmaThreads)
      normalize_row(slot(s, x / kKeys) + (x % kKeys) * kLd, 1.f);
    if (kt == 0)
      for (int x = ht; x < 2 * kTile; x += kMmaThreads)
        normalize_row(q_tile(i, x / kTile) + (x % kTile) * kLd, qmul);
  };
  // (quad, key tile) of the next step
  auto advance = [&](int& i, int& kt) {
    if (++kt == tiles) {
      kt = 0;
      ++i;
    }
  };

  // (quad, key tile) of step s, s + 1 and s + 2
  int i = 0, kt = 0, i1 = 0, kt1 = 0, i2 = 0, kt2 = 0;
  advance(i1, kt1);
  advance(i2, kt2);
  advance(i2, kt2);
  load_step(0, 0, 0);
  cp_async_commit();
  if (steps > 1) load_step(1, i1, kt1);
  cp_async_commit();
  const bool masked_slab = kSlab && mask_w != nullptr;
  if (masked_slab) load_mask(0);
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kCosine) {
    normalize(0, 0, 0);
    __syncthreads();
  }

  uint32_t qa[2][kD / 16][4];       // this warp's queries of each row, A
                                    // fragments
  float o[2][kD / 8][4];
  float m[2][2], l[2][2];           // rows g and g + 8 of each: max of
                                    // s + add, and this lane's share of the sum
  for (int s = 0; s < steps; ++s) {
    if (s + 2 < steps) load_step(s + 2, i2, kt2);
    cp_async_commit();
    const int k0 = kt * kKeys;
    if (masked_slab && i == 0) {      // the first quad completes the slab
#pragma unroll
      for (int u = 0; u < kMaskShare; ++u) {
        const int cell = threadIdx.x + u * kPairThreads;
        slab[(cell / kKeys) * slab_ld + k0 + cell % kKeys] += mk[u];
      }
      if (kt + 1 < tiles) load_mask(kt + 1);
      __syncthreads();
    }
    if (row_of(i, 0) < rows && q0 + wq < n) {
      if (kt == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int kk = 0; kk < kD / 16; ++kk)
            load_a(qa[r][kk], q_tile(i, r), kLd, wq, kk * 16);
          m[r][0] = m[r][1] = -INFINITY;
          l[r][0] = l[r][1] = 0.f;
#pragma unroll
          for (int j = 0; j < kD / 8; ++j)
            o[r][j][0] = o[r][j][1] = o[r][j][2] = o[r][j][3] = 0.f;
        }
      }
      // 16-key chunks of this tile that hold a key below n
      const int chunks = min(kKeys, n - k0 + 15) / 16;
      float sc[2][kKeys / 8][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
          sc[r][j][0] = sc[r][j][1] = sc[r][j][2] = sc[r][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < kKeys / 16; ++j2) {
          if (j2 >= chunks) break;    // keys past n: their scores become -inf
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t f[4];
            load_b(f, slot(s, r), kLd, j2 * 16, kk * 16);
            mma_pair(sc[r][2 * j2], sc[r][2 * j2 + 1], qa[r][kk], f);
          }
        }
      // element c of block j: query g (+8 for c >= 2), key 8j + 2t (+1 for
      // odd c); one read of the bias (+ mask) serves both rows
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float add[2];
          if constexpr (kSlab) {
            const float2 a2 = *reinterpret_cast<const float2*>(
                slab + (wq + g + 8 * hr) * slab_ld + k0 + j * 8 + 2 * t);
            add[0] = a2.x;
            add[1] = a2.y;
          } else {
#pragma unroll
            for (int odd = 0; odd < 2; ++odd) {
              const int qi = q0 + wq + g + 8 * hr;
              const int key = k0 + j * 8 + 2 * t + odd;
              const size_t at = static_cast<size_t>(qi) * n + key;
              add[odd] = qi < n && key < n
                             ? bias_h[at] + (mask_w == nullptr ? 0.f : mask_w[at])
                             : 0.f;
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            sc[r][j][2 * hr] += add[0];
            sc[r][j][2 * hr + 1] += add[1];
          }
        }
      if (k0 + kKeys > n) {         // a row's last tile: keys past n score -inf
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (k0 + j * 8 + 2 * t + (c & 1) >= n) sc[r][j][c] = -INFINITY;
      }
      // the online softmax of each row: rows g (elements 0, 1) and g + 8
      // (elements 2, 3)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[2] = {m[r][0], m[r][1]};
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], sc[r][j][c]);
        float corr[2], ms[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          // key k0 < n and the terms are finite, so the max over the row's 4
          // lanes is finite
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
          ms[hr] = mx[hr] * kLog2e;
          corr[hr] = exp2_ftz(fmaf(m[r][hr], kLog2e, -ms[hr]));
          m[r][hr] = mx[hr];
          l[r][hr] *= corr[hr];
        }
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[r][j][c] = exp2_ftz(fmaf(sc[r][j][c], kLog2e, -ms[c >> 1]));
            l[r][c >> 1] += sc[r][j][c];
          }
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[r][j][0] *= corr[0]; o[r][j][1] *= corr[0];
          o[r][j][2] *= corr[1]; o[r][j][3] *= corr[1];
        }
      }
      // O += P V: P's A fragments from the score accumulators, rounded to
      // bf16; V's B fragments read transposed
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if (kk >= chunks) break;      // P is 0 there
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t pa[4];
          acc_to_a(pa, sc[r][2 * kk], sc[r][2 * kk + 1]);
#pragma unroll
          for (int d2 = 0; d2 < kD / 16; ++d2) {
            uint32_t f[4];
            load_b_trans(f, slot(s, r) + kKT, kLd, kk * 16, d2 * 16);
            mma_pair(o[r][2 * d2], o[r][2 * d2 + 1], pa, f);
          }
        }
      }

      if (kt == tiles - 1) {          // the rows' last key tile: write them
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (row_of(i, r) >= rows) continue;
          const size_t base = base_of(i, r);
          const size_t rh =
              ((static_cast<size_t>(w) * batch + b0 + row_of(i, r)) * heads + h) * n;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float sum = l[r][hr];
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const float inv = 1.f / sum;
            const int qi = q0 + wq + g + 8 * hr;
            if (kLse && t == 0 && qi < n) lse[rh + qi] = m[r][hr] + logf(sum);
            if (qi < n) {
#pragma unroll
              for (int j = 0; j < kD / 8; ++j) {
                const float x0 = o[r][j][2 * hr] * inv;
                const float x1 = o[r][j][2 * hr + 1] * inv;
                const size_t at = base + static_cast<size_t>(qi) * e + j * 8 + 2 * t;
                *reinterpret_cast<uint32_t*>(out + at) = Io<bf16>::pack(x0, x1);
                if (kLse)
                  *reinterpret_cast<float2*>(out32 + at) = make_float2(x0, x1);
              }
            }
          }
        }
      }
    }
    cp_async_wait<1>();   // this thread's copies of step s + 1 have landed
    __syncthreads();      // ... every thread's; step s is consumed
    if (kCosine && s + 1 < steps) {
      normalize(s + 1, i1, kt1);
      __syncthreads();
    }
    advance(i, kt);
    advance(i1, kt1);
    advance(i2, kt2);
  }
}

// The bf16 forward's cut of each window's rows into groups: the count that
// runs the H * W0 * q_tiles * groups blocks over the card's block slots in
// the least waves x (pairs of rows a block + the slab's cost in pairs: a
// (64, N) fp32 slab of bias, or of bias and mask, moves a pair's key and
// value bytes each); the fewest groups on a tie. 0 on a CUDA error.
template <bool kLse, bool kCosine, bool kSlab>
int mma_groups(int batch, int tiles_total, size_t smem, bool masked) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, window_mma_fwd_kernel<kLse, kCosine, kSlab>, kPairThreads,
          smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int quads = (batch + kQuad - 1) / kQuad;
  const int slab = kSlab ? (masked ? 2 : 1) : 0;
  int best = 1;
  long long best_cost = 0;
  for (int gr = 1; gr <= quads; ++gr) {
    const int per = (quads + gr - 1) / gr;
    if ((quads + per - 1) / per != gr) continue;   // the same cut as fewer
    const long long waves =
        (static_cast<long long>(tiles_total) * gr + slots - 1) / slots;
    const long long cost = waves * (2 * per + slab);
    if (gr == 1 || cost < best_cost) {
      best = gr;
      best_cost = cost;
    }
  }
  return best;
}

template <bool kLse, bool kCosine, bool kSlab>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const float* scale,
               const float* bias, const float* mask, bf16* out, float* lse,
               float* out32, int rows, int n, int e, int heads, int w0,
               cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(   // once per instantiation
      window_mma_fwd_kernel<kLse, kCosine, kSlab>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int batch = rows / w0;
  const int q_tiles = mma_tiles(n);
  const size_t smem = mma_smem(n, kSlab);
  const long long tiles_total = static_cast<long long>(heads) * w0 * q_tiles;
  if (tiles_total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = mma_groups<kLse, kCosine, kSlab>(
      batch, static_cast<int>(tiles_total), smem, mask != nullptr);
  if (groups < 1) return static_cast<int>(cudaErrorUnknown);
  const int quads = (batch + kQuad - 1) / kQuad;
  const int per_group = kQuad * ((quads + groups - 1) / groups);
  const long long blocks = tiles_total * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_mma_fwd_kernel<kLse, kCosine, kSlab>
      <<<static_cast<unsigned>(blocks), kPairThreads, smem, stream>>>(
          q, k, v, scale, bias, mask, out, lse, out32, n, e, heads, batch, w0,
          q_tiles, groups, per_group);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLse, bool kCosine>
int launch(const void* q, const void* k, const void* v, const float* scale,
           const float* bias, const float* mask, void* out, float* lse,
           float* out32, int rows, int n, int e, int heads, int w0, int dtype,
           cudaStream_t stream) {
  if (e / heads != kD) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const bf16* qq = static_cast<const bf16*>(q);
    const bf16* kk = static_cast<const bf16*>(k);
    const bf16* vv = static_cast<const bf16*>(v);
    bf16* oo = static_cast<bf16*>(out);
    if (mma_smem(n, true) <= kMaxSmem)
      return launch_mma<kLse, kCosine, true>(qq, kk, vv, scale, bias, mask, oo,
                                             lse, out32, rows, n, e, heads, w0,
                                             stream);
    return launch_mma<kLse, kCosine, false>(qq, kk, vv, scale, bias, mask, oo,
                                            lse, out32, rows, n, e, heads, w0,
                                            stream);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (n + kQueryTile - 1) / kQueryTile;
  const long long blocks = static_cast<long long>(rows) * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_simt_fwd_kernel<kLse, kCosine><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), scale, bias, mask, static_cast<float*>(out),
      lse, out32, n, e, heads, rows / w0, w0, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLse, bool kCosine>
int dispatch(const void* q, const void* k, const void* v, const void* scale,
             const void* bias, const void* mask, void* out, float* lse,
             float* out32, int rows, int n, int e, int heads, int w0, int dtype,
             void* stream) {
  if (rows <= 0 || n <= 0 || heads <= 0 || w0 <= 0 || e % heads != 0 ||
      rows % w0 != 0 || (kCosine && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kLse, kCosine>(q, k, v, static_cast<const float*>(scale),
                               static_cast<const float*>(bias),
                               static_cast<const float*>(mask), out, lse, out32,
                               rows, n, e, heads, w0, dtype,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

// rows = W0 * B. dtype of q, k, v and out: 0 = float32, 1 = bfloat16; scale,
// bias and mask are float32; a null mask is no mask, read from nowhere.
// Returns a cudaError_t (0 on success). The caller checks shapes, contiguity
// and 16-byte alignment.

// K5: out only.
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* mask,
                                    void* out, int rows, int n, int e, int heads,
                                    int w0, int dtype, void* stream) {
  return dispatch<false, false>(q, k, v, nullptr, bias, mask, out, nullptr,
                                nullptr, rows, n, e, heads, w0, dtype, stream);
}

// K5 with what the backward reads: out, lse (rows, H, N) fp32 and the
// unrounded output out32 (rows, N, E) fp32.
extern "C" int window_attention_fwd_lse(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* mask, void* out, void* lse,
                                        void* out32, int rows, int n, int e,
                                        int heads, int w0, int dtype,
                                        void* stream) {
  if (lse == nullptr || out32 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true, false>(q, k, v, nullptr, bias, mask, out,
                               static_cast<float*>(lse),
                               static_cast<float*>(out32), rows, n, e, heads, w0,
                               dtype, stream);
}

// K12: out only, from raw q and k and the per-head scale (H,) fp32.
extern "C" int cosine_window_attention_fwd(const void* q, const void* k,
                                           const void* v, const void* scale,
                                           const void* bias, const void* mask,
                                           void* out, int rows, int n, int e,
                                           int heads, int w0, int dtype,
                                           void* stream) {
  return dispatch<false, true>(q, k, v, scale, bias, mask, out, nullptr,
                               nullptr, rows, n, e, heads, w0, dtype, stream);
}

// K12 with what its backward reads: out, lse (rows, H, N) fp32 and the
// unrounded output out32 (rows, N, E) fp32.
extern "C" int cosine_window_attention_fwd_lse(const void* q, const void* k,
                                               const void* v, const void* scale,
                                               const void* bias,
                                               const void* mask, void* out,
                                               void* lse, void* out32, int rows,
                                               int n, int e, int heads, int w0,
                                               int dtype, void* stream) {
  if (lse == nullptr || out32 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true, true>(q, k, v, scale, bias, mask, out,
                              static_cast<float*>(lse),
                              static_cast<float*>(out32), rows, n, e, heads, w0,
                              dtype, stream);
}
