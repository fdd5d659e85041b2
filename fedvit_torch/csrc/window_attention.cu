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
//                         W0 = 1 every row uses mask[0]
//   out     (W0*B, N, E)  head h writes its column slice [h*d, (h+1)*d)
//   lse     (W0*B, H, N)  flagged entry only: log sum_j exp(s_ij), fp32
//   out32   (W0*B, N, E)  flagged entry only: out before rounding, fp32
//
//   out_h = softmax(q_h k_h^T + bias[h] + mask[w]) v_h
//
// No score scale: the caller folds it into q. Scores, the running max and the
// running sum are fp32. The flagged entry is the same code with two more
// stores, so its output is bit-identical to the flagless one's.
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
// row's head slice is normalised in place in fp32 and rounded to the input
// type, q as q * (r * scale[h]) and k as k * r with r = 1 / max(||x||, 1e-6),
// in the TPU kernel's order; the scores are then K5's. The operands' norm
// costs 2 d operations a row of each tile, next to the 2 d N of its scores.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the SwinV2-L@384
// stage shapes for a batch of 32, bf16, (W0, N, E, H):
//   stage 0 (16, 576, 192,  6): q, k, v, out 4*512*576*192*2 = 453.0 MB, bias
//            8.0 MB, mask 21.2 MB -> 482.2 MB / 3.35 TB/s = 144 us;
//            4*512*6*576^2*32 = 130.5 GFLOP -> 132 us at the bf16 tensor peak
//   stage 2 ( 1, 576, 768, 24): 113.2 + 31.9 + 1.3 MB -> 43.7 us;
//            32.6 GFLOP -> 33 us
// so the kernel is bound by bytes, narrowly: at d = 32 a score costs as many
// bias and mask bytes as it saves q/k/v bytes. A forward launches it 24 times
// (2, 2, 18, 2 over the stages).
//
// Design. As qkvb_attention.cu: plain SIMT code on the fp32 cores, written to
// be right and readable, well above the bound (see PERF.md). One block takes
// one (row, head, 32-query tile); its query rows are staged once in shared
// memory as fp32 and the keys and values pass through in tiles of 64 rows, so
// any N works. Each of the 4 warps owns 8 query rows; for a chunk of 32 keys a
// lane holds one key row in registers, scores it against the 8 queries, adds
// bias[h][query][key] + mask[w][query][key] (the 32 lanes read 128 contiguous
// bytes of each), then the warp runs the online-softmax update and accumulates
// P.V with each lane owning one output column. Rows past N are staged as
// zeros and score -inf.
//
// Every block of a (window, head, query tile) reads the same (32, N) slices of
// bias and mask, B times over: about 4 GB of logical reads at stage 0. The
// grid is one-dimensional with the batch index fastest, so those B blocks are
// scheduled together and all but the first read the slices from L2.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kQueryTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeyTile = 64;                        // key rows per staged tile

template <typename T, int D, bool kLse, bool kCosine>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ out,
                            float* __restrict__ lse, float* __restrict__ out32,
                            int n, int e, int heads, int batch, int w0,
                            int q_tiles) {
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
  const float* mask_w = mask + (w0 > 1 ? w : 0) * nn;

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
        add[r] = (key < nk && qrow0 + r < n) ? bias_h[at] + mask_w[at] : 0.f;
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

template <typename T, bool kLse, bool kCosine>
int launch(const void* q, const void* k, const void* v, const float* scale,
           const float* bias, const float* mask, void* out, float* lse,
           float* out32, int rows, int n, int e, int heads, int w0,
           cudaStream_t stream) {
  if (e / heads != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (n + kQueryTile - 1) / kQueryTile;
  const long long blocks = static_cast<long long>(rows) * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  window_attention_fwd_kernel<T, 32, kLse, kCosine>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), scale, bias, mask, static_cast<T*>(out), lse,
          out32, n, e, heads, rows / w0, w0, q_tiles);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ss = static_cast<const float*>(scale);
  const float* bb = static_cast<const float*>(bias);
  const float* mm = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch<float, kLse, kCosine>(q, k, v, ss, bb, mm, out, lse, out32,
                                        rows, n, e, heads, w0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kLse, kCosine>(q, k, v, ss, bb, mm, out, lse,
                                                out32, rows, n, e, heads, w0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rows = W0 * B. dtype of q, k, v and out: 0 = float32, 1 = bfloat16; scale,
// bias and mask are float32. Returns a cudaError_t (0 on success). The caller checks
// shapes, contiguity and 16-byte alignment.

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
