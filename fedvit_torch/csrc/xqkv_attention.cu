// K11's forward: the QKV projection and the multi-head attention on its
// output, attention(x W + b), in hand-written code: the projection's products
// run in this library's own tensor-core GEMM (gemm.cuh), not in cuBLAS.
//
// Replaces the TPU kernel fedvit_tpu/ops/flash_attention.py::_xqkv_fwd_kernel
// (launched by _xqkv_fwd_rule through pl.pallas_call): the ViT attention of
// `attention_impl: mega`.
//
//   x    (B, N, D)   the block's normalised input, in T
//   w    (D, 3E)     the packed [Wq | Wk | Wv] projection, heads head-major
//                    within each third (nn.Dense's kernel layout), in T
//   b    (3E,)       the projection bias, in T
//   qkv  (B, N, 3E)  workspace in T, allocated by the caller
//   out  (B, N, E),  lse (B, H, N) fp32 for the _lse entry
//
//   qkv = round_T(x W + b)   (fp32 products and sum, the fp32 bias added,
//                             one rounding, as the TPU kernel and the XLA
//                             branch do)
//   out_h = softmax(q_h k_h^T / sqrt(d)) v_h,  d = E / H = 64 or 80
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the ViT-B/16@224
// serving shape, B=256, N=197, D=E=768, H=12, bf16: operations 2*B*N*D*3E =
// 178.5 GFLOP of projection + 4*B*H*N^2*d = 30.5 of attention = 209.0 GFLOP
// -> 211 us; bytes x 77.5 MB + w 3.5 + out 77.5 = 158.5 MB -> 47 us. K11 is
// bound by operations: the projection is 85% of them.
//
// Design. The TPU kernel keeps W, a batch block and its qkv resident in
// VMEM, so qkv never reaches HBM. A Hopper block has 227 KB of shared memory;
// this first version instead runs two launches on the caller's stream: the
// projection (gemm.cuh: 64 x 64 output tiles, mma.sync bf16 tensor-core
// products with fp32 accumulation, the bias added in fp32 and the result
// rounded once to T) writes qkv to the workspace, and the bias-free attention
// forward (attention_fwd.cuh, K10's kernel) reads it. Any N and dtype work
// with no second path. Materialising qkv (232 MB written and read at the
// serving shape) is this version's known cost, as dqkv's is in the backward;
// fusing it away, with K and V resident in shared memory, is a later PR.

#include "attention_fwd.cuh"
#include "gemm.cuh"

namespace {

template <typename T, bool kLse>
int forward(const void* x, const void* w, const void* b, void* qkv, void* out,
            float* lse, int batch, int n, int dim, int e, int heads, int dtype,
            float scale, void* stream) {
  const int err = gemm::launch<T, true, false>(
      static_cast<const T*>(x), dim, static_cast<const T*>(w), 3 * e,
      static_cast<T*>(qkv), 3 * e, static_cast<const T*>(b), batch * n, 3 * e,
      dim, static_cast<cudaStream_t>(stream));
  if (err) return err;
  return attn_fwd::launch_packed<false, kLse>(qkv, nullptr, out, lse, batch, n,
                                              e, heads, dtype, scale, stream);
}

template <bool kLse>
int dispatch(const void* x, const void* w, const void* b, void* qkv, void* out,
             float* lse, int batch, int n, int dim, int e, int heads, int dtype,
             float scale, void* stream) {
  if (batch <= 0 || n <= 0 || dim <= 0 || heads <= 0 || e % heads != 0 ||
      dim % 8 != 0 || e % 8 != 0 ||
      static_cast<long long>(batch) * n > 0x7fffffffLL / 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return forward<float, kLse>(x, w, b, qkv, out, lse, batch, n, dim, e, heads,
                                dtype, scale, stream);
  if (dtype == 1)
    return forward<__nv_bfloat16, kLse>(x, w, b, qkv, out, lse, batch, n, dim, e,
                                        heads, dtype, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// The caller checks shapes, contiguity and 16-byte alignment (D and E
// multiples of 8, d = E / heads of 64 or 80) and allocates the qkv workspace.

// K11 serving: out only.
extern "C" int xqkv_attention_fwd(const void* x, const void* w, const void* b,
                                  void* qkv, void* out, int batch, int n,
                                  int dim, int e, int heads, int dtype,
                                  float scale, void* stream) {
  return dispatch<false>(x, w, b, qkv, out, nullptr, batch, n, dim, e, heads,
                         dtype, scale, stream);
}

// K11 under grad: out and lse (B, H, N) fp32.
extern "C" int xqkv_attention_fwd_lse(const void* x, const void* w,
                                      const void* b, void* qkv, void* out,
                                      void* lse, int batch, int n, int dim,
                                      int e, int heads, int dtype, float scale,
                                      void* stream) {
  return dispatch<true>(x, w, b, qkv, out, static_cast<float*>(lse), batch, n,
                        dim, e, heads, dtype, scale, stream);
}
