// K11's backward: the gradients of attention(x W + b) with respect to x, W
// and b, in hand-written code: the products run in this library's own
// tensor-core GEMM (gemm.cuh: wgmma), not in cuBLAS.
//
// Replaces the TPU kernel fedvit_tpu/ops/flash_attention.py::_xqkv_bwd_kernel
// (launched by _xqkv_bwd_rule through pl.pallas_call).
//
//   inputs   x (B, N, D), w (D, 3E), b (3E,), out and dout (B, N, E) in T;
//            lse (B, H, N) fp32 from xqkv_attention_fwd_lse
//   outputs  dx (B, N, D), dw (D, 3E) in T; db (3E,) fp32, which the caller
//            rounds to b's type
//   workspaces (the caller allocates): qkv and dqkv (B, N, 3E) in T, delta
//            (B, H, N) fp32, partial (xqkv_attention_bwd_workspace_rows(B, N),
//            3E) fp32
//
// As the TPU kernel: qkv is recomputed, round_T(x W + b); the attention's
// backward gives dqkv rounded to T; then dx = dqkv W^T (fp32 sums, rounded
// to T), dW = x^T dqkv summed in fp32 over all B*N rows and rounded once to
// W's type, db = the fp32 column sums of dqkv (rounded to b's type by the
// caller, as K3's dbias is).
//
// Bound on an H100 SXM at the ViT-B/16@224 training micro-batch, B=64, N=197,
// D=E=768, H=12, bf16: operations recompute 2*B*N*D*3E = 44.6 GFLOP +
// attention 10*B*H*N^2*d = 19.1 + dx 44.6 + dW 44.6 = 152.9 GFLOP -> 155 us;
// bytes x 19.4 MB + w 3.5 + out 19.4 + dout 19.4 + lse 0.6 + dx 19.4 + dw 3.5
// ~ 85 MB -> 25 us: bound by operations.
//
// Design. Launches in order on the caller's stream, with no atomics, so every
// run gives the same bits:
//   1. the projection again (gemm.cuh) into the qkv workspace;
//   2. the bias-free attention backward (attention_bwd.cuh: K10's delta,
//      dk/dv and dq passes) into the dqkv workspace, rounded to T; as in K3,
//      the dk/dv and dq passes also write the column sums of the dqkv tiles
//      they store, and a last pass sums them in order into db. The TPU
//      kernel keeps a batch block's dqkv in VMEM; dx needs the sum over heads
//      of each row's dqkv W_h^T, which spans this design's (b, h) blocks, so
//      dqkv goes through device memory (58 MB at the micro-batch of 64): the
//      known cost of this first version;
//   3. dx = dqkv W^T by 128 x 128 tiles of (B*N, D), W read in its own
//      layout (gemm.cuh: wgmma, both operands from shared memory in their
//      natural major-ness);
//   4. dW = x^T dqkv by 128 x 128 tiles of (D, 3E), x and dqkv both read
//      m- and n-contiguous as they lie. Each tile is summed over all B*N rows
//      in one fixed order and rounded once (the TPU kernel carried dW across
//      its sequential grid in a resident fp32 block; Hopper's blocks are
//      unordered). At ViT-B's (768, 2304) the 108 tiles fill 108 of 132
//      SMs; a k split into fp32 partials, summed in order, measured slower
//      (PERF.md).

#include "attention_bwd.cuh"
#include "gemm.cuh"

namespace {

template <typename T>
int backward(const void* x, const void* w, const void* b, const void* out,
             const void* dout, const void* lse, void* qkv, void* dqkv,
             void* delta, void* partial, void* dx, void* dw, void* db, int batch,
             int n, int dim, int e, int heads, int dtype, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * n;
  const int e3 = 3 * e;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* dq = static_cast<T*>(dqkv);
  int err = gemm::launch<T, true, false>(xt, dim, wt, e3, static_cast<T*>(qkv),
                                         e3, static_cast<const T*>(b), rows, e3,
                                         dim, s);
  if (err) return err;
  err = attn_bwd::launch_packed<false, true>(qkv, nullptr, out, dout, lse,
                                             delta, partial, dqkv, db, batch, n,
                                             e, heads, dtype, scale, stream);
  if (err) return err;
  err = gemm::launch<T, true, true>(dq, e3, wt, e3, static_cast<T*>(dx), dim,
                                    nullptr, rows, dim, e3, s);
  if (err) return err;
  return gemm::launch<T, false, false>(xt, dim, dq, e3, static_cast<T*>(dw),
                                       e3, nullptr, dim, e3, rows, s);
}

}  // namespace

// rows of 3E in the fp32 workspace `partial`: one per (b, 64-row tile)
extern "C" int xqkv_attention_bwd_workspace_rows(int batch, int n) {
  return attn_bwd::workspace_rows(batch, n);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// The caller checks shapes, contiguity and 16-byte alignment (D and E
// multiples of 8, d = E / heads of 64 or 80) and allocates the workspaces; a
// partial shorter than xqkv_attention_bwd_workspace_rows(B, N) is refused.
extern "C" int xqkv_attention_bwd(const void* x, const void* w, const void* b,
                                  const void* out, const void* dout,
                                  const void* lse, void* qkv, void* dqkv,
                                  void* delta, void* partial, void* dx,
                                  void* dw, void* db, int batch, int n, int dim,
                                  int e, int heads, int dtype, float scale,
                                  int workspace_rows, void* stream) {
  if (batch <= 0 || n <= 0 || dim <= 0 || heads <= 0 || e % heads != 0 ||
      dim % 8 != 0 || e % 8 != 0 ||
      static_cast<long long>(batch) * n > 0x7fffffffLL / 3 ||
      workspace_rows < attn_bwd::workspace_rows(batch, n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return backward<float>(x, w, b, out, dout, lse, qkv, dqkv, delta, partial,
                           dx, dw, db, batch, n, dim, e, heads, dtype, scale,
                           stream);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, w, b, out, dout, lse, qkv, dqkv, delta,
                                   partial, dx, dw, db, batch, n, dim, e, heads,
                                   dtype, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
