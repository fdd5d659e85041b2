// Multi-head softmax attention on the packed QKV projection output: the
// forward of K1 (no grad) and K2 (the forward under grad, which also writes
// each row's log-sum-exp), both with the projection bias added on load, and
// of K10, the same without a bias; and of K9, K10 on three flat q, k, v
// tensors. The kernel is attention_fwd.cuh.
//
// K1 and K2 replace the TPU kernels fedvit_tpu/ops/flash_attention.py::
// _qkvb_fwd_kernel and ::_qkvb_fwd_stats_kernel, both launched by
// _qkvb_fwd_rule through pl.pallas_call. The TPU's K2 saves the row max and
// 1/sum in a (B, N, 128) block; this one saves lse = max + log(sum),
// (B, H, N) fp32, which is what the backward in qkvb_attention_bwd.cu needs to
// rebuild P. K10's forward entries replace ::_qkv_fwd_kernel (launched by
// _qkv_fwd_rule): the `packed` ViT attention, whose projection has already
// added the bias. The bias-free kernel is a compile-time variant, so K10 reads
// no bias at all. K9's entries replace ::_flat_fwd_kernel (launched by
// _flat_fwd_rule): the op-level attention on flat (B, N, E) q, k and v
// (ops/attention.py::dot_product_attention_flat). They are K10's kernel
// reading three base pointers at row stride E instead of the thirds of one
// packed tensor at 3E: no packed copy is made, and on the same values K9 and
// K10 give the same bits.
//
//   qkv  (B, N, 3E)  heads head-major, d = E/H = 64 (ViT-Ti/S/B/L) or 80 (ViT-H)
//   q, k, v (B, N, E) K9 only, in place of qkv; heads head-major
//   bias (3E,)       K1 and K2 only, in qkv's type
//   out  (B, N, E),  lse (B, H, N) fp32 for the _lse entries
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at the ViT-B/16@224
// serving shape, B=256, N=197, E=768, H=12, d=64, bf16:
//   bytes: qkv read 256*197*2304*2 = 232.4 MB, out write 77.5 MB
//          -> 309.9 MB / 3.35 TB/s = 92.5 us (K10: the same less 4.6 KB of bias)
//   flops: 4*197^2*64*12*256 = 30.5 GFLOP -> 30.8 us at the bf16 tensor peak
// so the kernel is bound by bytes, and a forward launches it 12 times. The
// _lse entries at the training micro-batch of 64 add 0.6 MB of lse to 77.5
// MB: ~23 us. K9 moves the same bytes as K10, in three tensors.
//
// Design (attention_fwd.cuh): plain SIMT code on the fp32 cores, written to
// be right and readable, so it sits well above the bound (see PERF.md). The
// head width d = 80 gives each lane 2 or 3 output columns and stages keys in
// tiles of 32 rows; d = 64 keeps tiles of 64.

#include "attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// The caller checks shapes, contiguity and 16-byte alignment.

// K1: out only.
extern "C" int qkvb_attention_fwd(const void* qkv, const void* bias, void* out,
                                  int batch, int n, int e, int heads, int dtype,
                                  float scale, void* stream) {
  return attn_fwd::launch_packed<true, false>(qkv, bias, out, nullptr, batch,
                                              n, e, heads, dtype, scale, stream);
}

// K2: out and lse (B, H, N) fp32.
extern "C" int qkvb_attention_fwd_lse(const void* qkv, const void* bias,
                                      void* out, void* lse, int batch, int n,
                                      int e, int heads, int dtype, float scale,
                                      void* stream) {
  return attn_fwd::launch_packed<true, true>(qkv, bias, out,
                                             static_cast<float*>(lse), batch, n,
                                             e, heads, dtype, scale, stream);
}

// K10, serving: out only, no bias.
extern "C" int qkv_attention_fwd(const void* qkv, void* out, int batch, int n,
                                 int e, int heads, int dtype, float scale,
                                 void* stream) {
  return attn_fwd::launch_packed<false, false>(qkv, nullptr, out, nullptr,
                                               batch, n, e, heads, dtype, scale,
                                               stream);
}

// K10 under grad: out and lse (B, H, N) fp32, no bias.
extern "C" int qkv_attention_fwd_lse(const void* qkv, void* out, void* lse,
                                     int batch, int n, int e, int heads,
                                     int dtype, float scale, void* stream) {
  return attn_fwd::launch_packed<false, true>(qkv, nullptr, out,
                                              static_cast<float*>(lse), batch,
                                              n, e, heads, dtype, scale, stream);
}

// K9 with no grad: out from flat (B, N, E) q, k and v, no bias.
extern "C" int flat_attention_fwd(const void* q, const void* k, const void* v,
                                  void* out, int batch, int n, int e, int heads,
                                  int dtype, float scale, void* stream) {
  return attn_fwd::launch<false, false>(q, k, v, e, nullptr, out, nullptr,
                                        batch, n, e, heads, dtype, scale,
                                        stream);
}

// K9 under grad: out and lse (B, H, N) fp32.
extern "C" int flat_attention_fwd_lse(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int n, int e, int heads,
                                      int dtype, float scale, void* stream) {
  return attn_fwd::launch<false, true>(q, k, v, e, nullptr, out,
                                       static_cast<float*>(lse), batch, n, e,
                                       heads, dtype, scale, stream);
}
