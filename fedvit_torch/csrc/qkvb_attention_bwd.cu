// Backward of the multi-head attention on the packed QKV projection output:
// K3, with the projection bias added on load and its gradient, and K10's
// backward, the same without a bias; and K9's, K10's on three flat q, k, v
// tensors with three flat dq, dk, dv. The kernels are attention_bwd.cuh.
//
// K3 replaces the TPU kernels fedvit_tpu/ops/flash_attention.py::
// _qkvb_bwd_kernel, ::_qkvb_bwd_stats_kernel and ::_qkvb_bwd_delta_kernel
// (launched by _qkvb_bwd_rule through pl.pallas_call). K10's backward
// replaces ::_qkv_bwd_kernel (launched by _qkv_bwd_rule): dqkv in qkv's
// layout, and no bias gradient, which the `packed` ViT attention takes from
// its projection's own backward. K9's replaces ::_flat_bwd_kernel (launched
// by _flat_bwd_rule), which recomputes the row statistics from q and k; this
// one reads the forward's lse instead (flat_attention_fwd_lse), the same
// function. All compute the same function; this is the
// FlashAttention-2 form of it, fed by the forward's per-row log-sum-exp
// (the _lse entries of qkvb_attention.cu):
//
//   inputs   qkv (B, N, 3E), bias (3E,) in qkv's type (K3 only), out and
//            dout (B, N, E), lse (B, H, N) fp32; K9: q, k, v (B, N, E) for qkv
//   outputs  dqkv (B, N, 3E) in qkv's type; K9: dq, dk, dv (B, N, E)
//            K3 only: dbias (3E,) fp32 = sum over the B*N rows of dqkv
//            rounded to its type
//
// Bound on an H100 SXM at the ViT-B/16@224 training micro-batch, B=64, N=197,
// E=768, H=12, d=64, bf16, from the function's own bytes: qkv 58.1 MB + dout
// 19.4 + dqkv 58.1 = 135.6 MB / 3.35 TB/s = 40 us (out and lse are the port's
// own leftovers of the forward, which the TPU kernel recomputes instead);
// operations 10*B*H*N^2*d = 19.1 GFLOP / 989 TFLOP/s = 19 us; so bytes bound
// it, K10's and K9's as K3's.
//
// Design (attention_bwd.cuh): delta, dk/dv and dq passes, no atomics, so
// every run gives the same bits; K3 adds a column-sum pass for dbias. bf16:
// FlashAttention-2's backward on mma.sync, one 128-thread block a 64-row
// tile, P and dS rounded to bf16 in registers between the products, as the
// TPU kernel rounds them; fp32: plain SIMT code. d = 64 or 80.

#include "attention_bwd.cuh"

// rows of 3E in the fp32 workspace `partial`: one per (b, 64-row tile)
extern "C" int qkvb_attention_bwd_workspace_rows(int batch, int n) {
  return attn_bwd::workspace_rows(batch, n);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// The caller checks shapes, contiguity and 16-byte alignment and allocates
// the fp32 workspaces: delta (B, H, N) and partial (workspace_rows, 3E); a
// count short of qkvb_attention_bwd_workspace_rows(B, N) is refused.

// K3: dqkv and dbias.
extern "C" int qkvb_attention_bwd(const void* qkv, const void* bias,
                                  const void* out, const void* dout,
                                  const void* lse, void* delta, void* partial,
                                  void* dqkv, void* dbias, int batch, int n, int e,
                                  int heads, int dtype, float scale,
                                  int workspace_rows, void* stream) {
  if (batch <= 0 || n <= 0 ||
      workspace_rows < attn_bwd::workspace_rows(batch, n))
    return static_cast<int>(cudaErrorInvalidValue);
  return attn_bwd::launch_packed<true, true>(qkv, bias, out, dout, lse, delta,
                                             partial, dqkv, dbias, batch, n, e,
                                             heads, dtype, scale, stream);
}

// K10's backward: dqkv only; the workspace is delta (B, H, N) fp32.
extern "C" int qkv_attention_bwd(const void* qkv, const void* out,
                                 const void* dout, const void* lse, void* delta,
                                 void* dqkv, int batch, int n, int e, int heads,
                                 int dtype, float scale, void* stream) {
  return attn_bwd::launch_packed<false, false>(qkv, nullptr, out, dout, lse,
                                               delta, nullptr, dqkv, nullptr,
                                               batch, n, e, heads, dtype, scale,
                                               stream);
}

// K9's backward: flat (B, N, E) dq, dk and dv from flat q, k and v; the
// workspace is delta (B, H, N) fp32.
extern "C" int flat_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* out, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int batch, int n, int e,
                                  int heads, int dtype, float scale,
                                  void* stream) {
  return attn_bwd::launch<false, false>(q, k, v, e, nullptr, out, dout, lse,
                                        delta, nullptr, dq, dk, dv, nullptr,
                                        batch, n, e, heads, dtype, scale,
                                        stream);
}
