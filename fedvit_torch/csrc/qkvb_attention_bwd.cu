// Backward of the multi-head attention on the bias-free packed QKV projection
// output with the projection bias added on load (K3).
//
// Replaces the TPU kernels fedvit_tpu/ops/flash_attention.py::_qkvb_bwd_kernel,
// ::_qkvb_bwd_stats_kernel and ::_qkvb_bwd_delta_kernel (launched by
// _qkvb_bwd_rule through pl.pallas_call). All three compute the same
// function; this is the FlashAttention-2 form of it, fed by the forward's
// per-row log-sum-exp (K2 in qkvb_attention.cu):
//
//   inputs   qkv (B, N, 3E), bias (3E,) in qkv's type, out and dout (B, N, E),
//            lse (B, H, N) fp32
//   outputs  dqkv (B, N, 3E) in qkv's type, in qkv's layout
//            dbias (3E,) fp32 = sum over the B*N rows of dqkv rounded to its type
//
//   P = exp(s - lse), s = (q + b_q)(k + b_k)^T / sqrt(d)
//   delta_i = sum_c dout_ic out_ic              (= sum_j dP_ij P_ij)
//   dS = P * (dout (v + b_v)^T - delta)
//   dq = dS (k + b_k) / sqrt(d),  dk = dS^T (q + b_q) / sqrt(d),  dv = P^T dout
//
// Four launches, in order on the caller's stream:
//   1. delta: one warp per (b, row, head), fp32.
//   2. dk, dv: one block per (b, h, 64-key tile); it walks the query tiles and
//      keeps its 64x64 dk and dv sums in registers.
//   3. dq: one block per (b, h, 64-query tile); it walks the key tiles.
//      Two passes instead of fp32 atomics on dq, so the sums are taken in one
//      order and every run gives the same bits.
//   4. dbias: passes 2 and 3 write, per (b, 64-row tile), the column sums of
//      the dqkv they stored (rounded to its type) into an fp32
//      (B * tiles, 3E) buffer; this pass sums its rows. The TPU kernel instead
//      carried dbias in a resident block across its sequential grid, which
//      Hopper's unordered blocks cannot do.
// Scores, P, dP and dS stay fp32 (the TPU kernel rounds P and dS to the
// type of dout before its products); the tolerance against the plain version
// says so. Rows and keys past N (the ragged last tile at N=197) are staged as
// zeros and get P = 0.
//
// Bound on an H100 SXM at the ViT-B/16@224 training micro-batch, B=64, N=197,
// E=768, H=12, d=64, bf16: bytes qkv 58.1 MB + out 19.4 + dout 19.4 + lse 0.6
// + dqkv 58.1 = 155.6 MB / 3.35 TB/s = 46 us; operations 10*B*H*N^2*d =
// 19.1 GFLOP / 989 TFLOP/s = 19 us; so bytes bound it.
//
// Design. Like the forward, this first version is plain SIMT code on the
// fp32 cores, written to be right and readable, and sits far above the bound
// (PERF.md): it recomputes S in both passes (7 N^2 d products per (b, h)
// instead of 5). Each block stages its own tile and the streamed tiles as
// padded fp32 rows in dynamic shared memory; 256 threads each own a 4x4
// piece of every 64x64 product, with the streamed-row index interleaved
// (thread column tx takes rows tx, tx+16, ...) so that neighbouring threads
// read neighbouring rows without bank conflicts.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;               // head width (ViT-Ti/S/B/L)
constexpr int kTile = 64;            // rows of a query or key tile
constexpr int kThreads = 256;
constexpr int kStride = kD + 4;      // padded fp32 row of q, k, v, dout
constexpr int kPStride = kTile + 1;  // padded fp32 row of P and dS

// rows [row0, row0 + kTile) of a (rows, ld) matrix at column `off`, plus the
// bias (if any) rounded to T, into fp32 shared memory; rows past n are zeros
template <typename T>
__device__ void stage(float* dst, const T* __restrict__ src,
                      const T* __restrict__ bias, int ld, int row0, int n,
                      int off) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kVecPerRow = kD / kVec;
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float x[kVec];
    if (row0 + r < n) {
      Io<T>::load(src + static_cast<size_t>(row0 + r) * ld + off + c, x);
      if (bias != nullptr) {
        float bv[kVec];
        Io<T>::load(bias + off + c, bv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = Io<T>::round(x[j] + bv[j]);
      }
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

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// For the 64x64 tile pair (query rows i = ty + 16a, key rows j = tx + 16b):
// P = exp(s * scale - lse_i) and dS = P * (dP - delta_i), into p_s / ds_s
// (p_s may be null when only dS is needed). Masked entries get 0.
__device__ void scores(const float* q_s, const float* k_s, const float* do_s,
                       const float* v_s, const float* lse_s, const float* dl_s,
                       float* p_s, float* ds_s, int nq, int nk, float scale) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < kD; c += 4) {
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

// Write rows j = ty + 16a (< n - row0) of a 64x64 fp32 tile, times `mul`, to
// dqkv at column `col`, rounded to T, and the column sums of the rounded
// values to partial[prow, col + c]. red is kTile*16 floats of shared memory.
template <typename T>
__device__ void write_tile(const float (&acc)[4][4], float mul, T* __restrict__ dqkv,
                           float* __restrict__ partial, float* red, int e3,
                           size_t row_base, int row0, int n, int col, size_t prow) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty + 16 * a;
    if (r < n) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = Io<T>::round(acc[a][c] * mul);
        colsum[c] += v[c];
      }
      Io<T>::template store<4>(dqkv + (row_base + r) * e3 + col + tx * 4, v);
    }
  }
  __syncthreads();  // red is free
#pragma unroll
  for (int c = 0; c < 4; ++c) red[(tx * 4 + c) * 16 + ty] = colsum[c];
  __syncthreads();
  if (threadIdx.x < kD) {
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) sum += red[threadIdx.x * 16 + t];
    partial[prow * e3 + col + threadIdx.x] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int n, int e, int heads, int total) {
  const int w = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= total) return;
  const int h = w % heads;
  const int row = (w / heads) % n;
  const int b = w / (heads * n);
  const size_t at = (static_cast<size_t>(b) * n + row) * e + h * kD + lane * 2;
  float o[2], g[2];
  Io<T>::load2(out + at, o);
  Io<T>::load2(dout + at, g);
  const float s = warp_sum(o[0] * g[0] + o[1] * g[1]);
  if (lane == 0) delta[(static_cast<size_t>(b) * heads + h) * n + row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dqkv,
            float* __restrict__ partial, int n, int e, float scale) {
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
  const int e3 = 3 * e;
  const size_t bh = static_cast<size_t>(b) * gridDim.y + h;
  const T* rows = qkv + static_cast<size_t>(b) * n * e3;
  const T* drows = dout + static_cast<size_t>(b) * n * e;

  stage(k_s, rows, bias, e3, k0, n, e + h * kD);
  stage(v_s, rows, bias, e3, k0, n, 2 * e + h * kD);
  const int nk = min(kTile, n - k0);

  float dk[4][4], dv[4][4];  // key rows ty + 16a, columns tx*4 + c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    stage(q_s, rows, bias, e3, q0, n, h * kD);
    stage(do_s, drows, static_cast<const T*>(nullptr), e, q0, n, h * kD);
    stage_rows(lse_s, dl_s, lse, delta, bh, q0, n);
    __syncthreads();
    const int nq = min(kTile, n - q0);
    // S^T would be the natural layout here; scores() writes P[i][j] with the
    // query row first, and the loop below reads its column j
    scores(q_s, k_s, do_s, v_s, lse_s, dl_s, p_s, ds_s, nq, nk, scale);
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const float4 g = *reinterpret_cast<const float4*>(do_s + i * kStride + tx * 4);
      const float4 q = *reinterpret_cast<const float4*>(q_s + i * kStride + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = p_s[i * kPStride + ty + 16 * a];
        const float ds = ds_s[i * kPStride + ty + 16 * a];
        dv[a][0] += p * g.x; dv[a][1] += p * g.y; dv[a][2] += p * g.z; dv[a][3] += p * g.w;
        dk[a][0] += ds * q.x; dk[a][1] += ds * q.y; dk[a][2] += ds * q.z; dk[a][3] += ds * q.w;
      }
    }
  }

  const size_t prow = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  const size_t row_base = static_cast<size_t>(b) * n;
  write_tile<T>(dk, scale, dqkv, partial, p_s, e3, row_base, k0, n, e + h * kD, prow);
  write_tile<T>(dv, 1.f, dqkv, partial, p_s, e3, row_base, k0, n, 2 * e + h * kD, prow);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dqkv,
          float* __restrict__ partial, int n, int e, float scale) {
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
  const int e3 = 3 * e;
  const size_t bh = static_cast<size_t>(b) * gridDim.y + h;
  const T* rows = qkv + static_cast<size_t>(b) * n * e3;
  const T* drows = dout + static_cast<size_t>(b) * n * e;

  stage(q_s, rows, bias, e3, q0, n, h * kD);
  stage(do_s, drows, static_cast<const T*>(nullptr), e, q0, n, h * kD);
  stage_rows(lse_s, dl_s, lse, delta, bh, q0, n);
  const int nq = min(kTile, n - q0);

  float dq[4][4];  // query rows ty + 16a, columns tx*4 + c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[a][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    stage(k_s, rows, bias, e3, k0, n, e + h * kD);
    stage(v_s, rows, bias, e3, k0, n, 2 * e + h * kD);
    __syncthreads();
    const int nk = min(kTile, n - k0);
    scores(q_s, k_s, do_s, v_s, lse_s, dl_s, nullptr, ds_s, nq, nk, scale);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(k_s + j * kStride + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = ds_s[(ty + 16 * a) * kPStride + j];
        dq[a][0] += ds * k.x; dq[a][1] += ds * k.y; dq[a][2] += ds * k.z; dq[a][3] += ds * k.w;
      }
    }
  }

  const size_t prow = static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  write_tile<T>(dq, scale, dqkv, partial, ds_s, e3, static_cast<size_t>(b) * n, q0,
                n, h * kD, prow);
}

// dbias[c] = sum_r partial[r, c], one thread per column, rows in order
__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                  int rows, int cols) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float sum = 0.f;
  for (int r = 0; r < rows; ++r) sum += partial[static_cast<size_t>(r) * cols + c];
  dbias[c] = sum;
}

constexpr size_t kDkdvSmem =
    (4 * kTile * kStride + 2 * kTile * kPStride + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem =
    (4 * kTile * kStride + kTile * kPStride + 2 * kTile) * sizeof(float);

template <typename T>
int launch(const void* qkv, const void* bias, const void* out, const void* dout,
           const void* lse, void* delta, void* partial, void* dqkv, void* dbias,
           int batch, int n, int e, int heads, float scale, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qkv);
  const T* bb = static_cast<const T*>(bias);
  const T* o = static_cast<const T*>(out);
  const T* g = static_cast<const T*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(partial);
  T* dx = static_cast<T*>(dqkv);
  cudaError_t err;

  const int total = batch * n * heads;
  delta_kernel<T><<<(total + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                    stream>>>(o, g, dl, n, e, heads, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  err = cudaFuncSetAttribute(dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T><<<grid, kThreads, kDkdvSmem, stream>>>(q, bb, g, l, dl, dx, part,
                                                       n, e, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T><<<grid, kThreads, kDqSmem, stream>>>(q, bb, g, l, dl, dx, part, n,
                                                   e, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int e3 = 3 * e;
  column_sum_kernel<<<(e3 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, static_cast<float*>(dbias), batch * static_cast<int>(grid.x), e3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows of 3E in the fp32 workspace `partial`: one per (b, 64-row tile)
extern "C" int qkvb_attention_bwd_workspace_rows(int batch, int n) {
  return batch * ((n + kTile - 1) / kTile);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// The caller checks shapes, contiguity and 16-byte alignment and allocates
// the fp32 workspaces: delta (B, H, N) and partial (workspace_rows, 3E); a
// count short of qkvb_attention_bwd_workspace_rows(B, N) is refused.
extern "C" int qkvb_attention_bwd(const void* qkv, const void* bias,
                                  const void* out, const void* dout,
                                  const void* lse, void* delta, void* partial,
                                  void* dqkv, void* dbias, int batch, int n, int e,
                                  int heads, int dtype, float scale,
                                  int workspace_rows, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || e % heads != 0 || e / heads != kD ||
      batch > 65535 || heads > 65535 ||
      workspace_rows < qkvb_attention_bwd_workspace_rows(batch, n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(qkv, bias, out, dout, lse, delta, partial, dqkv, dbias,
                         batch, n, e, heads, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, bias, out, dout, lse, delta, partial, dqkv,
                                 dbias, batch, n, e, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
