// Rotary position embedding of q and k on flat (B, N, E) rows: EVA-02's 2-D
// RoPE (timm's RotaryEmbeddingCat with apply_rot_embed_cat).
//
// Replaces no TPU kernel: the JAX package has no EVA-02 block. Per head of
// width d (E = H d), pairs interleaved along the head, with the table of
// token t's angles (N - 1, d / 2) in fp32, token 0 (the class token) left as
// it is, and token t > 0 taking row t - 1 of the table:
//
//   y[2j]     = x[2j] cos[t-1, j] - x[2j+1] sin[t-1, j]
//   y[2j + 1] = x[2j+1] cos[t-1, j] + x[2j] sin[t-1, j]
//
// in fp32, each product and sum rounded as ops/rotary.py::rotate_plain
// rounds them, and the result rounded once to x's type: the kernel and the
// plain version give the same bits. The backward is the rotation by -theta,
// the same kernel with sin negated (`sign` -1). q and k share one launch and
// one read of the table.
//
// Bytes bound it: q and k read once and written once, 4 bytes an element
// pair in bf16, against 3 fp32 operations an element. On an H100 SXM (3.35
// TB/s), EVA-02-L/14@448's micro-batch of 32 (32 x 1,024 patch tokens x
// 1,024, bf16): 268.4 MB for q and k and 0.26 MB of table -> 80.2 us.
//
// Design: a block of 128 threads takes one token t for 8 batch rows. A
// thread takes 16-byte vectors of the row (8 bf16 or 4 fp32, always inside
// one head), reads its vector's kVec / 2 cosines and sines once (16 or 8
// bytes each), then has all 8 rows' q and k vectors in flight at once
// (16 loads of 16 bytes), rotates them and writes them with 16-byte stores.
// Token 0 is copied as it is.
// No atomics: the same bits on every run.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsB = 8;   // batch rows a block

// one 16-byte vector, 16-byte aligned
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// kN consecutive fp32 values as one 16-byte (kN 4) or 8-byte (kN 2) load
template <int kN>
__device__ __forceinline__ void load_floats(const float* p, float* f) {
  if constexpr (kN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    static_assert(kN == 2, "4 bf16 or 2 fp32 pairs a vector");
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void rotate_vec(const Raw<T>& in, T* out,
                                           const float* c, const float* s) {
  constexpr int kVec = Io<T>::kVec;
  float x[kVec], y[kVec];
  in.get(x);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float x0 = x[2 * j], x1 = x[2 * j + 1];
    y[2 * j] = __fsub_rn(__fmul_rn(x0, c[j]), __fmul_rn(x1, s[j]));
    y[2 * j + 1] = __fadd_rn(__fmul_rn(x1, c[j]), __fmul_rn(x0, s[j]));
  }
  Io<T>::template store<kVec>(out, y);
}

// Token blockIdx.x of batch rows blockIdx.y * 8 .. +7
template <typename T>
__global__ void __launch_bounds__(kThreads)
rotary_kernel(const T* q, const T* k, T* q_out, T* k_out,
              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
              int batch, int n, int e, int half, float sign) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kPairs = kVec / 2;
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * kRowsB;
  const int nvec = e / kVec;
  const int d = 2 * half;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    Raw<T> qr[kRowsB], kr[kRowsB];
    size_t at[kRowsB];
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      at[i] = (static_cast<size_t>(b0 + i) * n + t) * e +
              static_cast<size_t>(v) * kVec;
      if (b0 + i < batch) {
        qr[i].load(q + at[i]);
        kr[i].load(k + at[i]);
      }
    }
    if (t == 0) {                 // the class token: copied, not rotated
#pragma unroll
      for (int i = 0; i < kRowsB; ++i)
        if (b0 + i < batch) {
          copy16(q_out + at[i], &qr[i].v);
          copy16(k_out + at[i], &kr[i].v);
        }
      continue;
    }
    // this vector's pairs of the table row: kPairs consecutive floats
    const size_t p = static_cast<size_t>(t - 1) * half + (v * kVec % d) / 2;
    float c[kPairs], s[kPairs];
    load_floats<kPairs>(cos_t + p, c);
    load_floats<kPairs>(sin_t + p, s);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) s[j] *= sign;
#pragma unroll
    for (int i = 0; i < kRowsB; ++i)
      if (b0 + i < batch) {
        rotate_vec<T>(qr[i], q_out + at[i], c, s);
        rotate_vec<T>(kr[i], k_out + at[i], c, s);
      }
  }
}

template <typename T>
int launch(const void* q, const void* k, void* q_out, void* k_out,
           const float* cos_t, const float* sin_t, int batch, int n, int e,
           int half, float sign, cudaStream_t s) {
  constexpr int kVec = Io<T>::kVec;
  if ((2 * half) % kVec != 0 || e % (2 * half) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n, (batch + kRowsB - 1) / kRowsB);
  rotary_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(q_out),
      static_cast<T*>(k_out), cos_t, sin_t, batch, n, e, half, sign);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, q_out, k_out (batch, n, e) in dtype (0 = float32, 1 = bfloat16),
// the outputs apart from the inputs; cos and sin (n - 1, half) fp32;
// sign 1 rotates by +theta (the forward), -1 by -theta (the backward).
// Returns a cudaError_t (0 on success). The caller checks shapes, contiguity
// and 16-byte alignment; a head width 2 half off the 16-byte vector, or an e
// it does not divide, is refused.
extern "C" int rotary_qk(const void* q, const void* k, void* q_out, void* k_out,
                         const void* cos_t, const void* sin_t, int batch, int n,
                         int e, int half, int dtype, float sign, void* stream) {
  if (batch <= 0 || n <= 1 || e <= 0 || half <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  if (dtype == 0)
    return launch<float>(q, k, q_out, k_out, c, sn, batch, n, e, half, sign, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, q_out, k_out, c, sn, batch, n, e, half,
                                 sign, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
