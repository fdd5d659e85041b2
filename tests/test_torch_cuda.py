"""The hand-written CUDA kernels against their plain versions, on the card.

Needs an NVIDIA Hopper GPU and ``nvcc``; skips elsewhere. Run on a machine
with the card (no JAX needed there, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances:

- K1 and K2's output: fp32 atol 2e-5 (fp32 scores and sums in both, other
  summation order and ``__expf``); bf16 atol 2^-5, one bf16 ulp of outputs
  below 8 (both round the softmax weights to bf16 before P·V, the plain
  version after normalising them and the tensor-core kernel before, so each
  weight differs by a bf16 rounding). K2's output is K1's, bit for bit.
- K2's log-sum-exp: atol 1e-4 against ``torch.logsumexp`` of the same fp32
  scores (values of 5-10; summation order and ``__expf``/``logf``).
- K3 (dqkv, dbias) against autograd of the plain version, as a share of the
  largest |value|: fp32 1e-4 (sums over N keys and B·N rows in another
  order); bf16 2^-5, four bf16 ulps of the largest value (the plain
  backward rounds P, dP and dS to bf16 at each cast of the forward; the
  tensor-core kernel rounds P and dS before their products, as the TPU
  kernel does, and dbias sums the rounded dqkv in fp32).
- K4 (dx, dgamma, dbeta) against ``ln_bwd_plain``, as a share of the
  largest |value|: fp32 1e-5; bf16 dx 2^-6 (both round dx to bf16: one ulp,
  from fp32 sums in another order), dgamma and dbeta 1e-4 in both (fp32 sums
  over the rows in another order; the kernel's variance is E[x²] − μ², the
  plain version's the centred one, as the TPU kernel and ``_ln_bwd_xla``).
- K5's output against ``windowed_attention_flat``: fp32 atol 2e-5, bf16 atol
  2^-5, for K1's reasons (fp32 scores, max and sums in both; both round the
  softmax weights to bf16 before P·V, the plain version after normalising
  them, the tensor-core kernel before). The log-sum-exp variant's
  output is K5's, bit for bit; its LSE atol 1e-4 against ``torch.logsumexp`` of
  the plain fp32 scores.
- K6 (dq, dk, dv, dbias) against autograd of ``windowed_attention_flat``:
  fp32 1e-4 of the largest |value| (sums over N keys and, for dbias, W0·B rows
  in another order); bf16 2^-6 as the RMS of the difference over the RMS of the
  plain gradient (the kernel rounds dS to bf16 before dq and dk, the plain
  backward rounds dP instead; both round P before dv: each term a bf16
  rounding apart, some 2^-8 of the RMS in all). The log-sum-exp entry's
  unrounded fp32 output, which K6's delta reads, rounds to its output.
- K1, K2 and K3 at d = 80 (ViT-H's head width): K1's and K3's tolerances.
- K10 (attention on the packed projection output with its bias added, no
  bias in the op) against ``attention_from_qkv``: its output and log-sum-exp
  as K1's and K2's, dqkv as K3's, for K3's reasons.
- K11 (the projection and the attention) against ``attention_from_x``: the
  output fp32 atol 1e-4 (qkv's sums over D products in another order feed
  the attention; K1's 2e-5 after it), bf16 atol 2^-5 as K1 (qkv rounds to
  the same bf16 value unless the two fp32 sums straddle a rounding boundary;
  the two round the softmax weights at K1's two places); dx, dW
  and db as shares of the largest |value|, fp32 1e-4 (sums over N keys, B·N
  rows and 3E columns in another order), bf16 2^-5 as K3 (dqkv carries K3's
  difference; each of dx, dW, db sums it in fp32 and rounds once). The
  backward twice gives the same bits.
- Tiny ``packed`` and ``mega`` train steps on the card against the CPU, fp32:
  each leaf's gradient atol 1e-4 plus rtol 1e-3, as for ``auto``.
- A tiny SwinV2 train step on the card against the CPU, fp32: loss rtol 1e-4,
  each leaf's gradient atol 1e-4 plus rtol 1e-3, as for the ViT.
- K9 (attention on flat q, k, v) against ``dot_product_attention_flat(...,
  impl="xla")``: its output, log-sum-exp and (dq, dk, dv) as K10's, for
  K10's reasons; and K9 on three (B, N, E) tensors against K10 on their
  concatenation: the same bits (one kernel, other addresses).
- K12 (the scaled-cosine windowed attention) against
  ``windowed_cosine_attention_flat(..., impl="xla")``. fp32: the output atol
  1e-4 (K5's 2e-5, and the two normalise in other orders: q·(r·s) against
  q/‖q‖·s, an ulp or two apart, on scores up to s + 16 = 116, where an ulp
  is 8e-6); the gradients 1e-4 of the largest |value|, as K6. bf16: as the
  RMS of the difference over the RMS of the plain value, 2^-6 for each
  output and gradient, as K6's (both round q̂ and k̂, P and dS to bf16; an
  element of q̂ that the two fp32 norms put on the two sides of a bf16
  rounding boundary moves its row's scores by a bf16 ulp, rarely, which a
  max would charge in full). bf16 dscale is a sum that cancels (the rows of
  dS sum to 0): the kernel rounds dS to bf16 before dq̂n, as the TPU kernel
  does, where autograd of the plain version keeps dS fp32 and rounds dq̂n;
  the dS rounding moves dscale more (on a small case JAX's own kernel is
  0.0185 of the RMS from the fp32 value, the plain version 0.0156), so
  dscale is held, at the same 2^-6, to ``windowed_cosine_dscale``, the plain
  version in the TPU kernel's order. The backward twice gives the same bits;
  a zero row of q or k gives finite gradients.
- The bf16 attention forward (K1, K2, K10, K9) at query and key tails around
  its 64-key and 128-query tiles: K1's and K2's limits, for their reasons.
- The bf16 attention backwards (K3, K10's, K9's, K6 and K12's) against
  their plain versions in the kernels' own order (``*_bwd_plain`` in
  ``ops/flash_attention.py``, the TPU kernels' order: P and dS rounded to
  bf16 before their products, fp32 sums) on the kernel entry's own inputs:
  each gradient as the RMS of the difference over the RMS of the plain value,
  2^-9 (fp32 summation order and ex2.approx against exp move an occasional
  element across a bf16 rounding boundary, one ulp of it). The backwards of
  K3, K10 and K6 give the same bits every run.
- The bf16 windowed forwards (K5, K12, and their log-sum-exp entries)
  against ``window_attention_fwd_plain``, their plain version in the
  tensor-core kernel's order (the unnormalised P of each 64-key tile rounded
  before P·V), on the same inputs: out and out32 as the RMS of the difference
  over the RMS of the plain value, 2^-8 (fp32 summation order and ex2.approx
  against exp move an occasional weight or output across a bf16 rounding
  boundary); the log-sum-exp atol 1e-4 (K5's), K12's mean |difference| at
  most 2^-8 (the kernel and the plain version sum ‖q‖² in other orders, so
  now and then an element of q̂ (up to 100 in size) rounds one bf16 ulp
  apart and moves its row's scores, as for K12 against its plain version
  above). The same bits every run.
- K4 at SwinV2-L's widths and at row counts around its 8-row blocks and
  64-row clusters: its limits above; dgamma and dbeta the same bits twice.
- The LayerNorm forward kernel against ``layer_norm_plain``: both take the
  same roundings in the same order but for the fp32 sums of x and x² (another
  summation order), and round once. A bf16 output within one bf16 ulp of the
  larger of the two values, or within 1e-6 of the largest |value| (fp32
  rounding noise at elements near zero, where an ulp is smaller than it); an
  fp32 output within 1e-6 of the largest |value| (or of 1 when smaller). The
  same bits every run.
- The ragged LayerNorm kernels (rows off 16 bytes or over D 2048, up to
  4096: EVA-02-L's SwiGLU norm at D 2,730) to the forward's and K4's
  tolerances above, for their reasons; the same bits twice. The widths the
  16-byte kernels take keep their kernels' names.
- The rotary kernel (EVA-02's 2-D RoPE) against ``ops/rotary.py::
  rotate_plain``: exact. Both round each product and sum in fp32 as the
  equations order them and round once to the storage type; the backward is
  the same kernel with sin negated, and autograd's gradient is the output
  gradient turned by −θ, exact.
- A two-block EVA-02 step on the card against the CPU, fp32: the features
  atol 1e-4 plus rtol 1e-4, each leaf's gradient as for the ViT.
- ``gemm_product`` (K11's products alone) against ``product_plain``: both
  sum in fp32 and round once, so bf16 values differ by at most one bf16 ulp
  (2^-7 of the value) plus 1e-3 near zero; fp32 1e-5 of the value plus 1e-4.
- K7 (row/column shift) and K8 (equalize) against their plain versions:
  exact. A shift moves values; equalize's fp32 values are integers below
  2^24 and both divide correctly rounded. The train augment through them
  against the same call through the plain versions, from one generator
  state: exact (nothing else differs between the two).
"""

import math

import pytest
import torch

from fedvit_torch.ops import flash_attention as fa
from fedvit_torch.ops import layer_norm as ln
from fedvit_torch.ops import attention as tattn
from fedvit_torch.ops.attention import (attention_from_qkv,
                                        attention_from_qkvb, attention_from_x,
                                        windowed_attention_flat)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(b, n, e, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * e, device="cuda", generator=g).to(dtype)
    bias = 0.5 * torch.randn(3 * e, device="cuda", generator=g)
    return qkv, bias


@pytest.mark.parametrize("b,n,heads,d,dtype,atol", [
    (2, 37, 2, 64, torch.float32, 2e-5),
    (3, 197, 12, 64, torch.float32, 2e-5),
    (2, 65, 3, 64, torch.float32, 2e-5),
    (2, 1, 2, 64, torch.float32, 2e-5),
    (2, 197, 12, 64, torch.bfloat16, 2.0 ** -5),
    (1, 577, 16, 64, torch.bfloat16, 2.0 ** -5),
])
def test_qkvb_kernel_matches_plain(cuda, b, n, heads, d, dtype, atol):
    qkv, bias = _inputs(b, n, heads * d, dtype, seed=n)
    before = fa.flash_attention_qkvb.launches
    got = fa.flash_attention_qkvb(qkv, bias, heads)
    torch.cuda.synchronize()
    assert fa.flash_attention_qkvb.launches == before + 1
    want = attention_from_qkvb(qkv, bias, heads)
    assert got.dtype == dtype and got.shape == (b, n, heads * d)
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= atol


def test_qkvb_kernel_refuses_what_it_does_not_take(cuda):
    qkv, bias = _inputs(2, 9, 128, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_qkvb(qkv, bias, 4)             # d = 32
    with pytest.raises(TypeError):
        fa.flash_attention_qkvb(qkv.half(), bias, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_qkvb(qkv[:, 1:], bias, 2)
    with pytest.raises(ValueError, match="bias"):
        fa.flash_attention_qkvb(qkv, bias[:-1], 2)


def test_tiny_model_on_the_card_matches_the_cpu(cuda):
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model

    cfg = from_dict({"model": {"backbone": "vit_tiny_patch16_224",
                               "image_size": 32, "compute_dtype": "float32"},
                     "data": {"use_segmentation_mask": True}})
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 32, 32, 4, generator=g)
    meta = torch.randn(3, 13, generator=g)
    before = fa.flash_attention_qkvb.launches
    with torch.inference_mode():
        want = cpu(x, meta)["logits"]
        got = gpu(x.cuda(), meta.cuda())["logits"].cpu()
    assert fa.flash_attention_qkvb.launches == before + 12
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _rel_err(got, want):
    """max |got − want| as a share of max |want| (or of 1 when smaller)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("b,n,heads,dtype", [
    (2, 37, 2, torch.float32), (2, 65, 3, torch.float32),
    (3, 197, 12, torch.float32), (2, 197, 12, torch.bfloat16),
    (2, 65, 3, torch.bfloat16)])
def test_k2_is_k1_plus_lse(cuda, b, n, heads, dtype):
    qkv, bias = _inputs(b, n, heads * 64, dtype, seed=n + 1)
    before = fa.qkvb_attention_lse_cuda.launches
    out, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
    torch.cuda.synchronize()
    assert fa.qkvb_attention_lse_cuda.launches == before + 1
    assert torch.equal(out, fa.qkvb_attention_cuda(qkv, bias, heads))
    e = heads * 64
    x = qkv + bias.to(dtype)
    q = x[..., :e].reshape(b, n, heads, 64).float()
    k = x[..., e:2 * e].reshape(b, n, heads, 64).float()
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / 8.0
    assert lse.shape == (b, heads, n) and lse.dtype == torch.float32
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-4


def _plain_grads(qkv, bias, heads, dout):
    qkv = qkv.detach().requires_grad_()
    bias = bias.detach().requires_grad_()
    out = attention_from_qkvb(qkv, bias, heads)
    return torch.autograd.grad(out, (qkv, bias), dout)


@pytest.mark.parametrize("b,n,heads,dtype,tol", [
    (2, 37, 2, torch.float32, 1e-4), (2, 65, 3, torch.float32, 1e-4),
    (3, 197, 12, torch.float32, 1e-4), (2, 1, 2, torch.float32, 1e-4),
    (4, 197, 12, torch.bfloat16, 2.0 ** -5),
    (2, 37, 2, torch.bfloat16, 2.0 ** -5)])
def test_k3_matches_plain_backward(cuda, b, n, heads, dtype, tol):
    qkv, bias = _inputs(b, n, heads * 64, dtype, seed=n + 2)
    g = torch.Generator(device="cuda").manual_seed(n)
    dout = torch.randn(b, n, heads * 64, device="cuda", generator=g).to(dtype)
    qkv_g = qkv.clone().requires_grad_()
    bias_g = bias.clone().requires_grad_()
    k2, k3 = fa.qkvb_attention_lse_cuda.launches, fa.qkvb_attention_bwd_cuda.launches
    k1 = fa.flash_attention_qkvb.launches
    out = fa.flash_attention_qkvb(qkv_g, bias_g, heads)
    dqkv, dbias = torch.autograd.grad(out, (qkv_g, bias_g), dout)
    torch.cuda.synchronize()
    assert fa.qkvb_attention_lse_cuda.launches == k2 + 1
    assert fa.qkvb_attention_bwd_cuda.launches == k3 + 1
    assert fa.flash_attention_qkvb.launches == k1          # no K1 under grad
    want_dqkv, want_dbias = _plain_grads(qkv, bias, heads, dout)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert torch.isfinite(dqkv).all() and torch.isfinite(dbias).all()
    assert _rel_err(dqkv, want_dqkv) <= tol
    assert _rel_err(dbias, want_dbias) <= tol


def test_k3_dbias_sums_the_rounded_dqkv(cuda):
    qkv, bias = _inputs(3, 197, 12 * 64, torch.bfloat16, seed=5)
    out, lse = fa.qkvb_attention_lse_cuda(qkv, bias, 12)
    dout = torch.randn_like(out)
    dqkv, dbias = fa.qkvb_attention_bwd_cuda(qkv, bias, out, dout, lse, 12)
    want = dqkv.float().sum((0, 1))
    assert float((dbias - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("shape,dtype,dx_tol", [
    ((37, 192), torch.float32, 1e-5), ((3, 197, 768), torch.float32, 1e-5),
    ((2, 65, 1024), torch.float32, 1e-5), ((64, 197, 768), torch.bfloat16, 2.0 ** -6),
    ((5, 37, 192), torch.bfloat16, 2.0 ** -6), ((1, 1, 768), torch.bfloat16, 2.0 ** -6),
    # SwinV2-L's widths: 24 and 48 vectors a row (lanes idle), 1536 in both types
    ((9, 48, 384), torch.bfloat16, 2.0 ** -6), ((70, 1536), torch.bfloat16, 2.0 ** -6),
    ((70, 1536), torch.float32, 1e-5), ((3, 2048), torch.float32, 1e-5),
    # SwinV2-L's stages 2 and 3 at 8 images; row counts under and over one
    # 8-row block and one 64-row cluster; fp32 at the widest D
    ((4608, 768), torch.bfloat16, 2.0 ** -6), ((1152, 1536), torch.bfloat16, 2.0 ** -6),
    ((7, 384), torch.bfloat16, 2.0 ** -6), ((9, 384), torch.bfloat16, 2.0 ** -6),
    ((63, 768), torch.bfloat16, 2.0 ** -6), ((65, 768), torch.float32, 1e-5),
    ((129, 2048), torch.float32, 1e-5)])
def test_k4_matches_plain(cuda, shape, dtype, dx_tol):
    g = torch.Generator(device="cuda").manual_seed(shape[-1])
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    w = 1.0 + 0.3 * torch.randn(shape[-1], device="cuda", generator=g)
    before = ln.layer_norm_bwd_cuda.launches
    dx, dg, db = ln.layer_norm_bwd(x, w, dy, 1e-6)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd_cuda.launches == before + 1
    want = ln.ln_bwd_plain(x, w, dy, 1e-6)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dg.dtype == db.dtype == torch.float32
    assert _rel_err(dx, want[0]) <= dx_tol
    assert _rel_err(dg, want[1]) <= 1e-4
    assert _rel_err(db, want[2]) <= 1e-4


def test_k4_refuses_d_over_its_cap(cuda):
    """Over the 16-byte pass's 2048 the ragged pass takes D up to 4096;
    over that, or on rows off 4 bytes, K4 raises."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 4104, device="cuda").to(dtype)
        with pytest.raises(ValueError, match="at most 4096"):
            ln.layer_norm_bwd_cuda(x, torch.ones(4104, device="cuda"), x)
    x = torch.randn(2, 13, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        ln.layer_norm_bwd_cuda(x, torch.ones(13, device="cuda"), x)


def test_k3_k4_refuse_a_short_workspace(cuda):
    """The C entry points own their workspace sizes and return an error for a
    buffer shorter than they write, instead of writing past it."""
    lib = ln._library()
    rows, d = 130, 64
    assert lib.layer_norm_bwd_workspace_rows(rows) == 3
    x = torch.randn(rows, d, device="cuda")
    w = torch.ones(d, device="cuda")
    part = torch.empty(2, d, device="cuda")
    out = [torch.empty_like(x), torch.empty(d, device="cuda"),
           torch.empty(d, device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.layer_norm_bwd(x.data_ptr(), x.data_ptr(), w.data_ptr(),
                              out[0].data_ptr(), part.data_ptr(), part.data_ptr(),
                              out[1].data_ptr(), out[2].data_ptr(), rows, d, 0,
                              1e-6, 2, stream) != 0
    blib = fa._bwd_library()
    b, n, e = 2, 197, 64
    assert blib.qkvb_attention_bwd_workspace_rows(b, n) == 8
    qkv, bias = _inputs(b, n, e, torch.float32)
    o = torch.empty(b, n, e, device="cuda")
    lse = torch.empty(b, 1, n, device="cuda")
    wsp = torch.empty(7, 3 * e, device="cuda")
    assert blib.qkvb_attention_bwd(
        qkv.data_ptr(), bias.data_ptr(), o.data_ptr(), o.data_ptr(),
        lse.data_ptr(), lse.data_ptr(), wsp.data_ptr(), qkv.data_ptr(),
        wsp.data_ptr(), b, n, e, 1, 0, 0.125, 7, stream) != 0


def test_layer_norm_function_launches_k4_under_grad(cuda):
    """Under grad ``layer_norm`` launches the forward kernel once and K4
    once, and nothing of the plain forward."""
    x = torch.randn(4, 9, 64, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda", requires_grad=True)
    b = torch.zeros(64, device="cuda", requires_grad=True)
    before = (ln.layer_norm_fwd_cuda.launches, ln.layer_norm_bwd_cuda.launches)
    y = ln.layer_norm(x, w, b)
    assert ln.layer_norm_fwd_cuda.launches == before[0] + 1
    y.square().sum().backward()
    assert (ln.layer_norm_fwd_cuda.launches,
            ln.layer_norm_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert x.grad.shape == x.shape and w.grad.shape == b.grad.shape == (64,)
    torch.testing.assert_close(y.detach(), ln.layer_norm_plain(x.detach(), w, b),
                               atol=1e-6, rtol=0)


def _ln_fwd_err(got, want):
    """(|got − want| elementwise in fp32, max |want| or 1 when smaller)."""
    diff = (got.float() - want.float()).abs()
    return diff, max(1.0, float(want.float().abs().max()))


def _ln_fwd_ok(got, want) -> bool:
    """Within the forward's tolerance (module docstring)."""
    assert got.dtype == want.dtype
    diff, scale = _ln_fwd_err(got, want)
    if got.dtype == torch.float32:
        return float(diff.max()) <= 1e-6 * scale
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), e - 8)   # a bf16 ulp of big
    return bool(((diff <= ulp) | (diff <= 1e-6 * scale)).all())


LN_FWD_WIDTHS = [(192, torch.bfloat16, torch.bfloat16),
                 (384, torch.bfloat16, torch.bfloat16),
                 (768, torch.bfloat16, torch.bfloat16),
                 (1536, torch.bfloat16, torch.bfloat16),
                 (512, torch.float32, torch.float32),
                 (768, torch.float32, torch.float32)]


def _ln_fwd_inputs(rows, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, d, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    w = 1.0 + 0.3 * torch.randn(d, device="cuda", generator=g)
    b = 0.2 * torch.randn(d, device="cuda", generator=g)
    return x, w, b


@pytest.mark.parametrize("rows", [1, 7, 9, 1152, 25216, 294912])
@pytest.mark.parametrize("d,xdt,ydt", LN_FWD_WIDTHS,
                         ids=[f"{d}-{str(a)[6:]}-{str(b)[6:]}"
                              for d, a, b in LN_FWD_WIDTHS])
def test_ln_fwd_matches_plain(cuda, rows, d, xdt, ydt):
    x, w, b = _ln_fwd_inputs(rows, d, xdt, rows + d)
    before = ln.layer_norm_fwd_cuda.launches
    y = ln.layer_norm_fwd(x, w, b, 1e-6, ydt)
    torch.cuda.synchronize()
    assert ln.layer_norm_fwd_cuda.launches == before + 1
    want = ln.layer_norm_plain(x, w, b, 1e-6, ydt)
    assert y.dtype == ydt and y.shape == x.shape
    assert _ln_fwd_ok(y, want), float(_ln_fwd_err(y, want)[0].max())
    assert torch.equal(y, ln.layer_norm_fwd(x, w, b, 1e-6, ydt))


@pytest.mark.parametrize("xdt,ydt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["f32-bf16", "bf16-f32"])
@pytest.mark.parametrize("shape", [(3, 197, 768), (9, 1536), (5, 8), (33, 2048),
                                   (70, 384)])
def test_ln_fwd_mixed_dtypes_match_plain(cuda, shape, xdt, ydt):
    x, w, b = _ln_fwd_inputs(math.prod(shape[:-1]), shape[-1], xdt, 11)
    x = x.reshape(shape)
    before = ln.layer_norm_fwd_cuda.launches
    y = ln.layer_norm(x, w, b, 1e-6, ydt)
    assert ln.layer_norm_fwd_cuda.launches == before + 1
    want = ln.layer_norm_plain(x, w, b, 1e-6, ydt)
    assert y.dtype == ydt and y.shape == x.shape
    assert _ln_fwd_ok(y, want), float(_ln_fwd_err(y, want)[0].max())


def test_ln_fwd_refuses_what_it_does_not_take(cuda):
    """Rows off 4 bytes, D over the ragged kernel's 4096, fp16, an x off 4
    bytes: the forward raises and launches nothing, on the card as K4 does.
    Rows off 16 bytes, D over 2048 and an x off 16 bytes take the ragged
    kernel. A strided x is made contiguous and a bf16 weight cast, as K4
    takes them."""
    x, w, b = _ln_fwd_inputs(6, 24, torch.float32, 12)
    xb = x.to(torch.bfloat16)
    refused = [
        (xb[:, :13].contiguous(), w[:13], b[:13]),                    # 26 bytes
        (torch.randn(3, 4100, device="cuda"), torch.ones(4100, device="cuda"),
         torch.zeros(4100, device="cuda")),                           # cap
        (x.half(), w, b),                                             # fp16
        (torch.empty(6 * 24 + 1, dtype=torch.bfloat16,
                     device="cuda")[1:].view(6, 24).copy_(xb), w, b)]  # offset
    for xi, wi, bi in refused:
        before = ln.layer_norm_fwd_cuda.launches
        with torch.no_grad(), pytest.raises((ValueError, TypeError)):
            ln.layer_norm(xi, wi, bi, 1e-6)
        with pytest.raises((ValueError, TypeError)):
            ln.layer_norm(xi, wi, bi, 1e-6)
        assert ln.layer_norm_fwd_cuda.launches == before
    ragged = [
        (xb[:, :12].contiguous(), w[:12], b[:12]),                    # D 12
        (x[:, :6].contiguous(), w[:6], b[:6]),                        # D 6
        (torch.randn(3, 2056, device="cuda"), torch.ones(2056, device="cuda"),
         torch.zeros(2056, device="cuda")),                           # over 2048
        (torch.empty(6 * 24 + 1, device="cuda")[1:].view(6, 24).copy_(x), w,
         b)]                                                          # offset
    for xi, wi, bi in ragged:
        before = ln.layer_norm_fwd_cuda.launches
        with torch.no_grad():
            y = ln.layer_norm(xi, wi, bi, 1e-6)
        assert ln.layer_norm_fwd_cuda.launches == before + 1
        assert _ln_fwd_ok(y, ln.layer_norm_plain(xi, wi, bi, 1e-6))
    strided = x.t().contiguous().t()
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fwd_cuda(strided, w, b)
    for xi, wi in ((strided, w), (x, w.to(torch.bfloat16))):
        before = ln.layer_norm_fwd_cuda.launches
        with torch.no_grad():
            y = ln.layer_norm(xi, wi, b, 1e-6)
        assert ln.layer_norm_fwd_cuda.launches == before + 1
        assert _ln_fwd_ok(y, ln.layer_norm_plain(xi, wi, b, 1e-6))


def test_ln_fwd_cap_is_k4s(cuda):
    """The forward takes D up to K4's cap and its library refuses more."""
    for dtype in (0, 1):
        assert ln._library().layer_norm_bwd_max_d(dtype) == ln._LN_MAX_D
    x, w, b = _ln_fwd_inputs(2, ln._LN_MAX_D + 4, torch.float32, 13)
    y = torch.empty_like(x)
    assert ln._fwd_library().layer_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 2,
        ln._LN_MAX_D + 4, 0, 0, 1e-6,
        torch.cuda.current_stream().cuda_stream) != 0
    torch.testing.assert_close(
        ln.layer_norm_fwd_cuda(x[:, :ln._LN_MAX_D].contiguous(),
                               w[:ln._LN_MAX_D], b[:ln._LN_MAX_D]),
        ln.layer_norm_plain(x[:, :ln._LN_MAX_D], w[:ln._LN_MAX_D],
                            b[:ln._LN_MAX_D]), atol=1e-5, rtol=0)


# --- the ragged LayerNorm kernels: rows off 16 bytes, D up to 4096 ----------

LN_RAGGED_WIDTHS = [(2730, torch.bfloat16, torch.bfloat16),
                    (1030, torch.bfloat16, torch.bfloat16),
                    (4096, torch.bfloat16, torch.bfloat16),
                    (2730, torch.float32, torch.float32),
                    (2052, torch.float32, torch.float32),
                    (2730, torch.bfloat16, torch.float32),
                    (2730, torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("rows", [1, 7, 129, 32800])
@pytest.mark.parametrize("d,xdt,ydt", LN_RAGGED_WIDTHS,
                         ids=[f"{d}-{str(a)[6:]}-{str(b)[6:]}"
                              for d, a, b in LN_RAGGED_WIDTHS])
def test_ln_fwd_ragged_matches_plain(cuda, rows, d, xdt, ydt):
    """EVA-02-L's SwiGLU norm (D 2,730) and other rows off 16 bytes or over
    2048: the forward's tolerance, the same bits twice."""
    x, w, b = _ln_fwd_inputs(rows, d, xdt, rows + d)
    before = ln.layer_norm_fwd_cuda.launches
    y = ln.layer_norm_fwd(x, w, b, 1e-6, ydt)
    torch.cuda.synchronize()
    assert ln.layer_norm_fwd_cuda.launches == before + 1
    want = ln.layer_norm_plain(x, w, b, 1e-6, ydt)
    assert y.dtype == ydt and y.shape == x.shape
    assert _ln_fwd_ok(y, want), float(_ln_fwd_err(y, want)[0].max())
    assert torch.equal(y, ln.layer_norm_fwd(x, w, b, 1e-6, ydt))


@pytest.mark.parametrize("shape,dtype,dx_tol", [
    ((1, 2730), torch.bfloat16, 2.0 ** -6), ((63, 2730), torch.bfloat16, 2.0 ** -6),
    ((32800, 2730), torch.bfloat16, 2.0 ** -6), ((4, 9, 1030), torch.bfloat16, 2.0 ** -6),
    ((129, 4096), torch.bfloat16, 2.0 ** -6), ((65, 2730), torch.float32, 1e-5),
    ((1057, 2052), torch.float32, 1e-5), ((3, 6), torch.float32, 1e-5)])
def test_k4_ragged_matches_plain(cuda, shape, dtype, dx_tol):
    """K4's ragged pass against ``ln_bwd_plain`` to K4's tolerances; the same
    bits twice."""
    g = torch.Generator(device="cuda").manual_seed(shape[-1] + shape[0])
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    w = 1.0 + 0.3 * torch.randn(shape[-1], device="cuda", generator=g)
    before = ln.layer_norm_bwd_cuda.launches
    got = ln.layer_norm_bwd(x, w, dy, 1e-6)
    torch.cuda.synchronize()
    assert ln.layer_norm_bwd_cuda.launches == before + 1
    want = ln.ln_bwd_plain(x, w, dy, 1e-6)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    assert _rel_err(got[0], want[0]) <= dx_tol
    assert _rel_err(got[1], want[1]) <= 1e-4
    assert _rel_err(got[2], want[2]) <= 1e-4
    again = ln.layer_norm_bwd(x, w, dy, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _kernel_names(fn) -> set:
    """The device kernels ``fn()`` launches, by the profiler's names."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_time_total > 0}


@pytest.mark.parametrize("d", [192, 384, 768, 1024, 1536, 2730])
def test_ln_widths_keep_their_kernel_names(cuda, d):
    """The widths the 16-byte kernels take keep ``ln_fwd_kernel<`` and K4's
    ``ln_bwd_rows_kernel<``; D 2,730 takes the ragged kernels, whose names
    ``ln_fwd_ms.*``'s pattern does not match, and which the ragged
    counters alone count."""
    import re
    x = torch.randn(64, d, device="cuda").to(torch.bfloat16)
    w, b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    fns = (ln.layer_norm_fwd_cuda, ln.layer_norm_bwd_cuda)
    before = [(f.launches, f.ragged_launches) for f in fns]
    names = _kernel_names(lambda: (ln.layer_norm_fwd(x, w, b),
                                   ln.layer_norm_bwd(x, w, x)))
    fwd = re.compile(r"\bln_fwd_kernel<")
    ragged = d % 8 != 0
    assert [(f.launches - n, f.ragged_launches - r)
            for f, (n, r) in zip(fns, before)] == [(1, int(ragged))] * 2
    assert any(fwd.search(n) for n in names) != ragged, names
    assert any("ln_bwd_rows_kernel<" in n for n in names) != ragged, names
    assert any("ln_fwd_ragged_kernel<" in n for n in names) == ragged, names
    assert any("ln_bwd_ragged_kernel<" in n for n in names) == ragged, names


def test_tiny_model_training_launches_k2_k3_k4(cuda):
    """Under grad a ViT forward and backward launches K2 and K3 once per
    block and K4 once per LayerNorm (2 per block + the final norm), and no
    K1; the grads match the CPU's."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model

    cfg = from_dict({"model": {"backbone": "vit_tiny_patch16_224",
                               "image_size": 32, "compute_dtype": "float32",
                               "drop_path_rate": 0.0,
                               "metadata": {"dropout": 0.0},
                               "classifier": {"dropout": 0.0}},
                     "data": {"use_segmentation_mask": True}})
    cpu = build_model(cfg, device="cpu").train()
    gpu = build_model(cfg, device="cuda").train()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 32, 32, 4, generator=g)
    meta = torch.randn(3, 13, generator=g)
    counts = (fa.flash_attention_qkvb.launches, fa.qkvb_attention_lse_cuda.launches,
              fa.qkvb_attention_bwd_cuda.launches, ln.layer_norm_bwd_cuda.launches,
              ln.layer_norm_fwd_cuda.launches)
    gpu(x.cuda(), meta.cuda())["logits"].square().sum().backward()
    after = (fa.flash_attention_qkvb.launches, fa.qkvb_attention_lse_cuda.launches,
             fa.qkvb_attention_bwd_cuda.launches, ln.layer_norm_bwd_cuda.launches,
             ln.layer_norm_fwd_cuda.launches)
    assert [a - c for a, c in zip(after, counts)] == [0, 12, 12, 25, 25]
    cpu(x, meta)["logits"].square().sum().backward()
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-3,
                                   msg=name)


# --- K5: windowed attention with a bias and a mask ---------------------------

def _window_inputs(w0, b, n, heads, dtype, seed=0, masked=True):
    """Seeded q, k, v (W0·B, N, 32·H) of unit-norm-sized heads, a bias of
    16·sigmoid size and a −100/0 mask that differs per window."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = 32 * heads
    q, k, v = (torch.randn(w0 * b, n, e, device="cuda", generator=g).to(dtype)
               for _ in range(3))
    bias = 16 * torch.sigmoid(torch.randn(heads, n, n, device="cuda", generator=g))
    mask = torch.where(torch.rand(w0, n, n, device="cuda", generator=g) > 0.8,
                       -100.0, 0.0) if masked else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("w0,b,n,heads,dtype,atol", [
    (4, 3, 49, 2, torch.float32, 2e-5),      # ragged N, W0 > 1 and B > 1
    (9, 2, 16, 3, torch.float32, 2e-5),
    (1, 5, 64, 6, torch.float32, 2e-5),
    (3, 2, 1, 1, torch.float32, 2e-5),
    (2, 3, 144, 4, torch.float32, 2e-5),
    (4, 3, 49, 2, torch.bfloat16, 2.0 ** -5),
    (4, 2, 576, 6, torch.bfloat16, 2.0 ** -5),
    (1, 3, 144, 48, torch.bfloat16, 2.0 ** -5),
])
def test_window_kernel_matches_plain(cuda, w0, b, n, heads, dtype, atol):
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, dtype, seed=n + w0)
    before = fa.flash_attention_bias_flat.launches
    got = fa.flash_attention_bias_flat(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    assert fa.flash_attention_bias_flat.launches == before + 1
    want = windowed_attention_flat(q, k, v, bias, mask, heads)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= atol


def test_window_kernel_rows_are_window_major(cuda):
    """A batch-major reading of the rows (mask[r % W0]) gives another answer;
    the kernel agrees with the window-major one, and with mask=None it agrees
    with a zeros mask."""
    w0, b, n, heads = 4, 3, 49, 2
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, torch.float32, seed=3)
    got = fa.flash_attention_bias_flat(q, k, v, bias, mask, heads)
    rows = torch.arange(w0 * b, device="cuda")
    wrong = torch.cat([windowed_attention_flat(
        q[r:r + 1], k[r:r + 1], v[r:r + 1], bias, mask[r % w0][None], heads)
        for r in rows.tolist()])
    right = windowed_attention_flat(q, k, v, bias, mask, heads)
    assert float((got - right).abs().max()) <= 2e-5
    assert float((got - wrong).abs().max()) > 1e-2
    none = fa.flash_attention_bias_flat(q, k, v, bias, None, heads)
    zeros = fa.flash_attention_bias_flat(q, k, v, bias, torch.zeros_like(mask),
                                         heads)
    assert torch.equal(none, zeros)


@pytest.mark.parametrize("w0,b,n,heads,dtype", [
    (4, 3, 49, 2, torch.float32), (1, 2, 144, 3, torch.float32),
    (4, 2, 576, 6, torch.bfloat16), (9, 2, 16, 3, torch.bfloat16)])
def test_window_lse_variant_is_k5_plus_lse(cuda, w0, b, n, heads, dtype):
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, dtype, seed=n)
    counts = (fa.flash_attention_bias_flat.launches,
              fa.window_attention_lse_cuda.launches)
    out, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bias_flat.launches,
            fa.window_attention_lse_cuda.launches) == (counts[0], counts[1] + 1)
    assert torch.equal(out, fa.window_attention_cuda(q, k, v, bias, mask, heads))
    # the unrounded output: fp32, and out is its rounding to q's type
    assert out32.dtype == torch.float32 and torch.equal(out32.to(dtype), out)
    qh, kh = (t.reshape(w0, b, n, heads, 32).float() for t in (q, k))
    s = torch.einsum("wbnhd,wbmhd->wbhnm", qh, kh) + bias + mask[:, None, None]
    assert lse.shape == (w0 * b, heads, n) and lse.dtype == torch.float32
    want = torch.logsumexp(s, -1).reshape(w0 * b, heads, n)
    assert float((lse - want).abs().max()) <= 1e-4


def test_window_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, bias, mask = _window_inputs(2, 2, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bias_flat(q, k, v, bias[:1], mask, 1)      # d = 64
    with pytest.raises(TypeError):
        fa.flash_attention_bias_flat(q.half(), k.half(), v.half(), bias, mask, 2)
    with pytest.raises(TypeError):
        fa.flash_attention_bias_flat(q, k.bfloat16(), v, bias, mask, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bias_flat(q.transpose(0, 1).contiguous().transpose(0, 1),
                                     k, v, bias, mask, 2)
    wide = torch.randn(4, 16, 68, device="cuda")[..., 4:]   # 16 bytes off a row
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bias_flat(wide, k, v, bias, mask, 2)
    flat = torch.randn(4 * 16 * 64 + 1, device="cuda")[1:].view(4, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bias_flat(flat, k, v, bias, mask, 2)
    with pytest.raises(ValueError, match="bias"):
        fa.flash_attention_bias_flat(q, k, v, bias[:, :-1], mask, 2)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention_bias_flat(q, k, v, bias, mask.repeat(3, 1, 1)[:3], 2)
    with pytest.raises(ValueError, match="CUDA"):
        fa.window_attention_cuda(q.cpu(), k.cpu(), v.cpu(), bias.cpu(),
                                 mask.cpu(), 2)
    with pytest.raises(ValueError, match="mask"):     # the mask is a constant
        fa.flash_attention_bias_flat(q, k, v, bias, mask.clone().requires_grad_(),
                                     2)
    counts = (fa.flash_attention_bias_flat.launches,
              fa.window_attention_lse_cuda.launches)
    with torch.no_grad():      # without grad mode a leaf is served by K5
        fa.flash_attention_bias_flat(q.clone().requires_grad_(), k, v, bias,
                                     mask, 2)
    assert (fa.flash_attention_bias_flat.launches,
            fa.window_attention_lse_cuda.launches) == (counts[0] + 1, counts[1])


def test_tiny_swin_model_on_the_card_matches_the_cpu(cuda):
    """A SwinV2-tiny ISICClassifier at image_size 64 (windows of 8: stage 0
    shifts, the others clamp): one K5 launch per block, none of K1-K4, logits
    equal to the CPU's plain path."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model

    cfg = from_dict({"model": {"backbone": "swinv2_tiny_window8_64",
                               "image_size": 64, "compute_dtype": "float32"},
                     "data": {"use_segmentation_mask": True}})
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():       # non-zero biases, peaked attention
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 64, 64, 4, generator=g)
    meta = torch.randn(3, 13, generator=g)
    counts = (fa.flash_attention_bias_flat.launches,
              fa.flash_attention_qkvb.launches, fa.qkvb_attention_lse_cuda.launches,
              fa.qkvb_attention_bwd_cuda.launches, ln.layer_norm_bwd_cuda.launches)
    with torch.inference_mode():
        want = cpu(x, meta)["logits"]
        got = gpu(x.cuda(), meta.cuda())["logits"].cpu()
    after = (fa.flash_attention_bias_flat.launches,
             fa.flash_attention_qkvb.launches, fa.qkvb_attention_lse_cuda.launches,
             fa.qkvb_attention_bwd_cuda.launches, ln.layer_norm_bwd_cuda.launches)
    assert [a - c for a, c in zip(after, counts)] == [12, 0, 0, 0, 0]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# --- K6: the windowed attention's backward -----------------------------------

def _plain_window_grads(q, k, v, bias, mask, heads, dout):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    out = windowed_attention_flat(*leaves, mask, heads)
    return torch.autograd.grad(out, leaves, dout)


def _rel_rms(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).square().mean() / want.square().mean()).sqrt())


@pytest.mark.parametrize("w0,b,n,heads,dtype,masked", [
    (4, 3, 49, 2, torch.float32, True),       # ragged N, W0 > 1 and B > 1
    (9, 2, 16, 3, torch.float32, True),
    (1, 5, 64, 6, torch.float32, False),
    (3, 2, 1, 1, torch.float32, True),
    (2, 3, 144, 4, torch.float32, True),      # 4.5 query tiles, 2.25 key tiles
    (1, 40, 33, 2, torch.float32, False),     # more rows than row groups
    (4, 3, 49, 2, torch.bfloat16, True),
    (4, 2, 576, 6, torch.bfloat16, True),
    (1, 3, 144, 48, torch.bfloat16, False),
])
def test_k6_matches_plain_backward(cuda, w0, b, n, heads, dtype, masked):
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, dtype, seed=n + w0 + 1,
                                         masked=masked)
    g = torch.Generator(device="cuda").manual_seed(n)
    dout = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    counted = (fa.flash_attention_bias_flat, fa.window_attention_lse_cuda,
               fa.window_attention_bwd_cuda)
    counts = [fn.launches for fn in counted]
    out = fa.flash_attention_bias_flat(*leaves, mask, heads)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    # under grad: the log-sum-exp entry and K6, not the plain K5
    assert [fn.launches - c for fn, c in zip(counted, counts)] == [0, 1, 1]
    want = _plain_window_grads(q, k, v, bias, mask, heads, dout)
    assert [t.dtype for t in got] == [dtype] * 3 + [torch.float32]
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape and torch.isfinite(a).all(), name
        if dtype == torch.float32:
            assert _rel_err(a, w) <= 1e-4, name
        else:
            assert _rel_rms(a, w) <= 2.0 ** -6, name


def test_k6_rows_are_window_major_and_every_run_gives_the_same_bits(cuda):
    w0, b, n, heads = 4, 3, 49, 2
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, torch.float32, seed=3)
    out, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, heads)
    dout = torch.randn_like(out)
    got = fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32, dout, lse, heads)
    again = fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32, dout, lse, heads)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    # each window's rows alone, with that window's mask: dq, dk, dv of those
    # rows, and dbias the sum over the windows
    dbias = torch.zeros_like(got[3])
    for w in range(w0):
        rows = slice(w * b, (w + 1) * b)
        one = _plain_window_grads(q[rows], k[rows], v[rows], bias, mask[w:w + 1],
                                  heads, dout[rows])
        for a, c in zip(got[:3], one[:3]):
            assert _rel_err(a[rows], c) <= 1e-4
        dbias += one[3]
    assert _rel_err(got[3], dbias) <= 1e-4


def test_k6_refuses_what_it_does_not_take(cuda):
    q, k, v, bias, mask = _window_inputs(2, 2, 16, 2, torch.float32)
    out, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, 2)
    with pytest.raises(ValueError, match="dout"):
        fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32, out[:, 1:], lse, 2)
    with pytest.raises(ValueError, match="lse"):
        fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32, out, lse.double(), 2)
    with pytest.raises(ValueError, match="out32"):     # the fp32 output, not out
        fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32.bfloat16(), out,
                                     lse, 2)
    with pytest.raises(ValueError, match="head dim"):
        fa.window_attention_bwd_cuda(q, k, v, bias[:1], mask, out, out, lse, 1)
    lib = fa._window_bwd_library()
    n = lib.window_attention_bwd_max_n() + 1
    big = torch.zeros(1, n, 32, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        fa.window_attention_bwd_cuda(big, big, big, torch.zeros(1, n, n, device="cuda"),
                                     None, big, big, torch.zeros(1, 1, n, device="cuda"), 1)


def test_k6_refuses_a_short_workspace(cuda):
    """With more than one group of rows the C entry point needs a tile of
    (H, N, N) per group and returns an error for fewer, instead of writing
    past the buffer."""
    rows, n, heads = 64, 64, 1
    lib = fa._window_bwd_library()
    groups = lib.window_attention_bwd_row_groups(rows, n, 32 * heads, heads, 1, 0)
    assert groups > 1
    q, k, v, bias, _ = _window_inputs(1, rows, n, heads, torch.float32, masked=False)
    mask = torch.zeros(1, n, n, device="cuda")
    out, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, heads)
    delta = torch.empty_like(lse)
    partial = torch.empty(groups - 1, heads, n, n, device="cuda")
    outs = [torch.empty_like(q) for _ in range(3)] + [torch.empty_like(bias)]
    args = [t.data_ptr() for t in (q, k, v, bias, mask, out32, out, lse, delta,
                                   partial, *outs)]
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.window_attention_bwd(*args, rows, n, 32 * heads, heads, 1, 0,
                                    groups - 1, stream) != 0
    assert lib.window_attention_bwd_row_groups(rows, n, 64, heads, 1, 0) == 0


def test_tiny_swin_train_step_on_the_card_matches_the_cpu(cuda):
    """One accumulation of a SwinV2-tiny train step at image_size 64 (windows
    of 8: stage 0 shifts and takes the mask), fp32, drop-path and dropouts off
    and no mixing so both devices compute the same function: per micro-batch
    one launch of K5's log-sum-exp entry and of K6 per block, one K4 per
    LayerNorm, none of K1-K3 nor of the plain K5; loss and every leaf's
    gradient equal to the CPU's plain path."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    cfg = from_dict({
        "model": {"backbone": "swinv2_tiny_window8_64", "image_size": 64,
                  "compute_dtype": "float32", "drop_path_rate": 0.0,
                  "metadata": {"dropout": 0.0}, "classifier": {"dropout": 0.0}},
        "data": {"use_segmentation_mask": True},
        "training": {"batch_size": 2, "gradient_accumulation_steps": 2,
                     "scheduler": {"warmup_epochs": 0}},
        "augmentation": {"mixup": {"enabled": False},
                         "cutmix": {"enabled": False}}})
    cpu = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():       # non-zero biases, peaked attention
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = {"image": torch.randn(4, 64, 64, 4, generator=g).numpy(),
             "label": torch.randint(0, 8, (4,), generator=g).numpy(),
             "metadata": torch.rand(4, 13, generator=g).numpy()}
    step = make_train_step(cfg, build_loss(cfg))
    grads, losses = {}, {}
    counted = (fa.flash_attention_bias_flat, fa.window_attention_lse_cuda,
               fa.window_attention_bwd_cuda, ln.layer_norm_bwd_cuda,
               fa.flash_attention_qkvb, fa.qkvb_attention_lse_cuda,
               fa.qkvb_attention_bwd_cuda)
    counts = [fn.launches for fn in counted]
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        tx, _ = build_optimizer(cfg, model, steps_per_epoch=10)
        state = TrainState.create(model, tx, seed=0)
        got, loss, _ = step.accumulate_grads(state, batch)
        grads[name] = {n: t.detach().cpu().clone() for n, t in got.items()}
        losses[name] = float(loss)
    norms = sum(isinstance(m, ln.LayerNorm) for m in gpu.modules())
    assert norms == 1 + 2 * 12 + 3 + 1
    assert [fn.launches - c for fn, c in zip(counted, counts)] == [
        0, 2 * 12, 2 * 12, 2 * norms, 0, 0, 0]
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for n, want in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][n], want, atol=1e-4, rtol=1e-3,
                                   msg=n)


# --- K7, K8 and the train augment ------------------------------------------------

def _shift_inputs(b, h, w, c, axis, seed):
    from fedvit_torch.ops.row_shift import _shift_amount
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(b, h, w, c, device="cuda", generator=g)
    extent = w if axis == 2 else h
    n = h if axis == 2 else w
    shift = (torch.rand(b, n, device="cuda", generator=g) - 0.5) * 3.2 * extent
    ties = torch.tensor([0.5, -0.5, 1.5, -2.5, extent + 0.5, -extent - 0.5],
                        device="cuda")[:n]
    shift[0, :len(ties)] = ties
    return img, shift, _shift_amount(shift, extent)


@pytest.mark.parametrize("b,h,w,c", [(3, 14, 19, 1), (3, 14, 19, 3),
                                     (2, 37, 29, 4), (4, 250, 250, 3),
                                     (2, 372, 372, 4),
                                     # C = 4 at odd W; C = 3 rows whose
                                     # starts are not 16-byte aligned; C = 1;
                                     # rows shorter than a 4-float group; a
                                     # C the kernel reads at run time
                                     (2, 9, 31, 4), (3, 11, 25, 3),
                                     (2, 13, 33, 1), (2, 6, 3, 1),
                                     (2, 5, 3, 2), (2, 7, 9, 5)])
@pytest.mark.parametrize("axis", [2, 1])
def test_k7_matches_plain(cuda, b, h, w, c, axis):
    from fedvit_torch.ops import row_shift as rs
    img, shift, s = _shift_inputs(b, h, w, c, axis, seed=h + c + axis)
    before = rs.shift_cuda.launches
    got = (rs.row_shift if axis == 2 else rs.col_shift)(img, shift)
    torch.cuda.synchronize()
    assert rs.shift_cuda.launches == before + 1
    want = (rs.row_shift_plain if axis == 2 else rs.col_shift_plain)(img, shift)
    assert torch.equal(got, want)
    assert torch.equal(rs.shift_cuda(img, s, axis), got)
    assert bool((got == 0).any()) and bool((got != 0).any())


def _off_16_bytes(img):
    """A contiguous copy of ``img`` at a storage offset of one float: its
    data pointer is 4 bytes past a 16-byte boundary."""
    view = torch.empty(img.numel() + 1, device=img.device)[1:].view(img.shape)
    view.copy_(img)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("b,h,w,c", [(2, 37, 29, 4), (3, 11, 25, 3),
                                     (2, 13, 33, 1), (4, 250, 250, 3)])
@pytest.mark.parametrize("axis", [2, 1])
def test_k7_at_a_storage_offset_off_16_bytes(cuda, b, h, w, c, axis):
    from fedvit_torch.ops import row_shift as rs
    img, shift, s = _shift_inputs(b, h, w, c, axis, seed=h + c + axis)
    got = rs.shift_cuda(_off_16_bytes(img), s, axis)
    torch.cuda.synchronize()
    want = (rs.row_shift_plain if axis == 2 else rs.col_shift_plain)(img, shift)
    assert torch.equal(got, want)


def test_k7_refuses_what_it_does_not_take(cuda):
    from fedvit_torch.ops import row_shift as rs
    img, _, s = _shift_inputs(2, 8, 6, 3, 2, seed=0)
    with pytest.raises(TypeError):
        rs.shift_cuda(img.double(), s, 2)
    with pytest.raises(TypeError):
        rs.shift_cuda(img, s.long(), 2)
    with pytest.raises(ValueError, match="shifts must be"):
        rs.shift_cuda(img, s, 1)                 # (B, H) shifts for columns
    with pytest.raises(ValueError, match="contiguous"):
        rs.shift_cuda(img.transpose(1, 2), s[:, :6].contiguous(), 2)


@pytest.mark.parametrize("b,h,w,c", [(2, 24, 20, 3), (3, 37, 41, 3),
                                     (2, 224, 224, 3), (1, 384, 384, 3)])
def test_k8_matches_plain(cuda, b, h, w, c):
    from fedvit_torch.ops import randaugment as ra
    g = torch.Generator(device="cuda").manual_seed(h)
    img = torch.rand(b, h, w, c, device="cuda", generator=g)
    img[0, ..., 0] = 0.5                              # step == 0: passthrough
    img[-1, ..., 1] = 0.25                            # one value and a few others
    img[-1, :2, :3, 1] = 0.9
    before = ra.equalize_cuda.launches
    got = ra.equalize(img)
    torch.cuda.synchronize()
    assert ra.equalize_cuda.launches == before + 1
    assert torch.equal(got, ra.equalize_plain(img))
    assert torch.equal(got[0, ..., 0], img[0, ..., 0])


@pytest.mark.parametrize("b,h,w,c", [
    (2, 40, 33, 1), (3, 50, 47, 4), (2, 33, 35, 2), (2, 30, 31, 5),  # C
    (1, 97, 89, 3),           # B = 1; H·W·C not a multiple of a block's span
    (2, 97, 89, 3),           # ... and the second sample off 16 bytes
    (1, 1000, 1000, 3), (1, 2000, 2000, 1)])   # spans counted, then read twice
def test_k8_edge_cases(cuda, b, h, w, c):
    """K8 against ``equalize_plain`` at other C, B = 1, spans that do not
    divide the sample and spans too large for shared memory, with a channel
    of one bin within the first block's span only (a run of one bin) and one
    whose only non-zero bin lies within the last block's span: a cluster has
    at most 16 blocks, so the first ⌈P/16⌉ pixels lie in the first block's
    span and the last P − 15⌈P/16⌉ in the last block's."""
    from fedvit_torch.ops import randaugment as ra
    g = torch.Generator(device="cuda").manual_seed(h * c)
    img = torch.rand(b, h, w, c, device="cuda", generator=g)
    p = h * w
    edge = -(-p // 16)
    flat = img.view(b, p, c)
    flat[0, :edge, 0] = 0.5
    flat[-1, :, -1] = 0.0
    flat[-1, 15 * edge:, -1] = 0.7
    before = ra.equalize_cuda.launches
    got = ra.equalize(img)
    torch.cuda.synchronize()
    assert ra.equalize_cuda.launches == before + 1
    assert torch.equal(got, ra.equalize_plain(img))


@pytest.mark.parametrize("b,h,w,c", [(2, 37, 41, 3), (1, 97, 89, 4),
                                     (2, 224, 224, 3)])
def test_k8_at_a_storage_offset_off_16_bytes(cuda, b, h, w, c):
    from fedvit_torch.ops import randaugment as ra
    g = torch.Generator(device="cuda").manual_seed(w)
    img = torch.rand(b, h, w, c, device="cuda", generator=g)
    got = ra.equalize_cuda(_off_16_bytes(img))
    torch.cuda.synchronize()
    assert torch.equal(got, ra.equalize_plain(img))


def test_k8_refuses_what_it_does_not_take(cuda):
    from fedvit_torch.ops import randaugment as ra
    img = torch.rand(2, 8, 8, 3, device="cuda")
    with pytest.raises(TypeError):
        ra.equalize_cuda(img.double())
    with pytest.raises(ValueError, match="contiguous"):
        ra.equalize_cuda(img.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ra.equalize_cuda(img.cpu())


def test_train_augment_through_the_kernels_equals_the_plain_path(cuda):
    """make_device_augment(train=True) on a card batch: 12 K7 and 3 K8
    launches a call, and bit for bit the output of the same call with the
    plain shifts and equalize, from the same generator state."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.data.pipeline import make_device_augment
    from fedvit_torch.ops import randaugment as ra
    from fedvit_torch.ops import row_shift as rs

    cfg = from_dict({"model": {"image_size": 64},
                     "data": {"use_segmentation_mask": True}})
    augment = make_device_augment(cfg, train=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    raw = torch.randint(0, 256, (8, 80, 80, 4), device="cuda", generator=g,
                        dtype=torch.uint8)
    raw[..., 3] = torch.where(raw[..., 3] > 127, 255, 0)
    start = g.get_state()
    counts = (rs.shift_cuda.launches, ra.equalize_cuda.launches)
    got = augment({"image": raw}, g)["image"]
    torch.cuda.synchronize()
    assert (rs.shift_cuda.launches - counts[0],
            ra.equalize_cuda.launches - counts[1]) == (12, 3)
    g.set_state(start)
    kernels = (rs.row_shift, rs.col_shift, ra.equalize)
    try:
        rs.row_shift, rs.col_shift = rs.row_shift_plain, rs.col_shift_plain
        ra.equalize = ra.equalize_plain
        want = augment({"image": raw}, g)["image"]
    finally:
        rs.row_shift, rs.col_shift, ra.equalize = kernels
    assert got.shape == (8, 64, 64, 4) and torch.equal(got, want)
    assert set(got[..., 3].unique().tolist()) <= {-1.0, 1.0}


# --- K1-K3 at d = 80; K10 and K11 ---------------------------------------------

@pytest.mark.parametrize("b,n,dtype,tol", [
    (2, 37, torch.float32, (2e-5, 1e-4)), (3, 197, torch.float32, (2e-5, 1e-4)),
    (2, 197, torch.bfloat16, (2.0 ** -5, 2.0 ** -5)),
    (2, 65, torch.bfloat16, (2.0 ** -5, 2.0 ** -5))])
def test_k1_k2_k3_take_d80(cuda, b, n, dtype, tol):
    """E = 160 in 2 heads of 80, ViT-H's head width."""
    heads, e = 2, 160
    qkv, bias = _inputs(b, n, e, dtype, seed=n + 80)
    out = fa.flash_attention_qkvb(qkv, bias, heads)
    out2, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    assert float((out.float() - attention_from_qkvb(qkv, bias, heads).float())
                 .abs().max()) <= tol[0]
    x = qkv + bias.to(dtype)
    q = x[..., :e].reshape(b, n, heads, 80).float()
    k = x[..., e:2 * e].reshape(b, n, heads, 80).float()
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(80)
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-4
    g = torch.Generator(device="cuda").manual_seed(n)
    dout = torch.randn(b, n, e, device="cuda", generator=g).to(dtype)
    qkv_g, bias_g = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    dqkv, dbias = torch.autograd.grad(fa.flash_attention_qkvb(qkv_g, bias_g, heads),
                                      (qkv_g, bias_g), dout)
    want_dqkv, want_dbias = _plain_grads(qkv, bias, heads, dout)
    assert _rel_err(dqkv, want_dqkv) <= tol[1]
    assert _rel_err(dbias, want_dbias) <= tol[1]


@pytest.mark.parametrize("b,n,heads,d,dtype,tol", [
    (2, 37, 2, 64, torch.float32, (2e-5, 1e-4)),
    (3, 197, 12, 64, torch.float32, (2e-5, 1e-4)),
    (2, 37, 2, 80, torch.float32, (2e-5, 1e-4)),
    (2, 1, 2, 64, torch.float32, (2e-5, 1e-4)),
    (4, 197, 12, 64, torch.bfloat16, (2.0 ** -5, 2.0 ** -5)),
    (2, 197, 2, 80, torch.bfloat16, (2.0 ** -5, 2.0 ** -5))])
def test_k10_matches_plain(cuda, b, n, heads, d, dtype, tol):
    e = heads * d
    qkv, bias = _inputs(b, n, e, dtype, seed=n + d)
    qkv = qkv + bias.to(dtype)               # the packed Dense's output
    counts = (fa.flash_attention_qkv.launches, fa.qkv_attention_lse_cuda.launches,
              fa.qkv_attention_bwd_cuda.launches, fa.flash_attention_qkvb.launches)
    out = fa.flash_attention_qkv(qkv, heads)
    out2, lse = fa.qkv_attention_lse_cuda(qkv, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and out.dtype == dtype
    assert float((out.float() - attention_from_qkv(qkv, heads).float())
                 .abs().max()) <= tol[0]
    q = qkv[..., :e].reshape(b, n, heads, d).float()
    k = qkv[..., e:2 * e].reshape(b, n, heads, d).float()
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(d)
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-4
    g = torch.Generator(device="cuda").manual_seed(n)
    dout = torch.randn(b, n, e, device="cuda", generator=g).to(dtype)
    qkv_g = qkv.clone().requires_grad_()
    (dqkv,) = torch.autograd.grad(fa.flash_attention_qkv(qkv_g, heads), qkv_g, dout)
    torch.cuda.synchronize()
    qkv_p = qkv.clone().requires_grad_()
    (want,) = torch.autograd.grad(attention_from_qkv(qkv_p, heads), qkv_p, dout)
    assert dqkv.dtype == dtype and torch.isfinite(dqkv).all()
    assert _rel_err(dqkv, want) <= tol[1]
    after = (fa.flash_attention_qkv.launches, fa.qkv_attention_lse_cuda.launches,
             fa.qkv_attention_bwd_cuda.launches, fa.flash_attention_qkvb.launches)
    assert [a - c for a, c in zip(after, counts)] == [1, 2, 1, 0]


def _x_inputs(b, n, dim, e, dtype, seed):
    """x of unit entries, W of N(0, 1/D) (so qkv is of unit size) and a bias
    of 0.5, all in ``dtype``; W in the JAX kernel's (D, 3E) layout."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, n, dim, device="cuda", generator=g)
    w = torch.randn(dim, 3 * e, device="cuda", generator=g) / math.sqrt(dim)
    bias = 0.5 * torch.randn(3 * e, device="cuda", generator=g)
    return x.to(dtype), w.to(dtype), bias.to(dtype)


def _plain_x_grads(x, w, bias, heads, dout):
    x, w, bias = (t.detach().clone().requires_grad_() for t in (x, w, bias))
    return torch.autograd.grad(attention_from_x(x, w, bias, heads), (x, w, bias),
                               dout)


@pytest.mark.parametrize("b,n,dim,heads,d,dtype,tol", [
    (2, 37, 128, 2, 64, torch.float32, (1e-4, 1e-4)),
    (3, 197, 768, 12, 64, torch.float32, (1e-4, 1e-4)),
    (2, 37, 160, 2, 80, torch.float32, (1e-4, 1e-4)),
    (2, 1, 64, 1, 64, torch.float32, (1e-4, 1e-4)),
    (4, 197, 768, 12, 64, torch.bfloat16, (2.0 ** -5, 2.0 ** -5)),
    (2, 197, 160, 2, 80, torch.bfloat16, (2.0 ** -5, 2.0 ** -5))])
def test_k11_matches_plain(cuda, b, n, dim, heads, d, dtype, tol):
    e = heads * d
    x, w, bias = _x_inputs(b, n, dim, e, dtype, seed=n + dim)
    counts = (fa.flash_attention_xqkv.launches, fa.xqkv_attention_lse_cuda.launches,
              fa.xqkv_attention_bwd_cuda.launches)
    out = fa.flash_attention_xqkv(x, w, bias, heads)
    out2, lse = fa.xqkv_attention_lse_cuda(x, w, bias, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and out.dtype == dtype
    assert float((out.float() - attention_from_x(x, w, bias, heads).float())
                 .abs().max()) <= tol[0]
    assert lse.shape == (b, heads, n) and torch.isfinite(lse).all()
    g = torch.Generator(device="cuda").manual_seed(n)
    dout = torch.randn(b, n, e, device="cuda", generator=g).to(dtype)
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, bias))
    got = torch.autograd.grad(fa.flash_attention_xqkv(xg, wg, bg, heads),
                              (xg, wg, bg), dout)
    torch.cuda.synchronize()
    want = _plain_x_grads(x, w, bias, heads, dout)
    for name, gt, wt in zip(("dx", "dw", "db"), got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape, name
        assert torch.isfinite(gt).all(), name
        assert _rel_err(gt, wt) <= tol[1], (name, _rel_err(gt, wt))
    after = (fa.flash_attention_xqkv.launches, fa.xqkv_attention_lse_cuda.launches,
             fa.xqkv_attention_bwd_cuda.launches)
    assert [a - c for a, c in zip(after, counts)] == [1, 2, 1]


def test_k11_backward_gives_the_same_bits_twice(cuda):
    x, w, bias = _x_inputs(8, 197, 768, 768, torch.bfloat16, seed=3)
    out, lse = fa.xqkv_attention_lse_cuda(x, w, bias, 12)
    dout = torch.randn_like(out)
    first = fa.xqkv_attention_bwd_cuda(x, w, bias, out, dout, lse, 12)
    second = fa.xqkv_attention_bwd_cuda(x, w, bias, out, dout, lse, 12)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_k10_k11_refuse_what_they_do_not_take(cuda):
    qkv, _ = _inputs(2, 9, 128, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_qkv(qkv, 4)                    # d = 32
    with pytest.raises(TypeError):
        fa.flash_attention_qkv(qkv.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_qkv(qkv[:, 1:], 2)
    x, w, bias = _x_inputs(2, 9, 64, 128, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_xqkv(x, w, bias, 4)
    with pytest.raises(TypeError):
        fa.flash_attention_xqkv(x, w.bfloat16(), bias, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_xqkv(x.transpose(0, 1), w, bias, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention_xqkv(x[..., :60].contiguous(), w[:60].contiguous(),
                                bias, 2)
    lib = fa._xqkv_bwd_library()
    assert lib.xqkv_attention_bwd_workspace_rows(2, 197) == 8
    ptr = x.data_ptr()
    assert lib.xqkv_attention_bwd(*[ptr] * 13, 2, 197, 64, 128, 2, 0, 0.125, 7,
                                  torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.parametrize("impl", ["packed", "mega"])
def test_tiny_packed_and_mega_training_matches_the_cpu(cuda, impl):
    """Under grad a ViT forward and backward launches the impl's kernels once
    per block (the log-sum-exp forward and the backward) and K4 once per
    LayerNorm, and none of K1-K3 nor the other impl's; the grads match the
    CPU's."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model

    cfg = from_dict({"model": {"backbone": "vit_tiny_patch16_224",
                               "image_size": 32, "compute_dtype": "float32",
                               "drop_path_rate": 0.0, "attention_impl": impl,
                               "metadata": {"dropout": 0.0},
                               "classifier": {"dropout": 0.0}},
                     "data": {"use_segmentation_mask": True}})
    cpu = build_model(cfg, device="cpu").train()
    gpu = build_model(cfg, device="cuda").train()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 32, 32, 4, generator=g)
    meta = torch.randn(3, 13, generator=g)
    fns = (fa.flash_attention_qkvb, fa.qkvb_attention_lse_cuda,
           fa.qkvb_attention_bwd_cuda, fa.flash_attention_qkv,
           fa.qkv_attention_lse_cuda, fa.qkv_attention_bwd_cuda,
           fa.flash_attention_xqkv, fa.xqkv_attention_lse_cuda,
           fa.xqkv_attention_bwd_cuda, ln.layer_norm_bwd_cuda)
    counts = [f.launches for f in fns]
    gpu(x.cuda(), meta.cuda())["logits"].square().sum().backward()
    got = [f.launches - c for f, c in zip(fns, counts)]
    want = [0] * 9 + [25]
    first = 4 if impl == "packed" else 7
    want[first:first + 2] = [12, 12]
    assert got == want
    cpu(x, meta)["logits"].square().sum().backward()
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-3,
                                   msg=name)


@pytest.mark.parametrize("size", ["tiny", "small", "base", "large", "huge"])
def test_every_vit_width_runs_on_the_card(cuda, size, monkeypatch):
    """Each ViT width of the registry (heads of 64, ViT-H's of 80) takes every
    ported attention_impl on the card, forward and backward, in bf16: cut to
    2 blocks (the width, heads and head dim stay), at a 2 × 2 grid of
    patches."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model
    from fedvit_torch.models import vit as tvit

    monkeypatch.setitem(tvit.VIT_CONFIGS, size,
                        dict(tvit.VIT_CONFIGS[size], depth=2))
    patch = 14 if size == "huge" else 16
    for impl, fns in (("auto", (fa.qkvb_attention_lse_cuda,
                                fa.qkvb_attention_bwd_cuda)),
                      ("packed", (fa.qkv_attention_lse_cuda,
                                  fa.qkv_attention_bwd_cuda)),
                      ("mega", (fa.xqkv_attention_lse_cuda,
                                fa.xqkv_attention_bwd_cuda))):
        cfg = from_dict({"model": {"backbone": f"vit_{size}_patch{patch}_224",
                                   "image_size": 2 * patch,
                                   "compute_dtype": "bfloat16",
                                   "attention_impl": impl,
                                   "drop_path_rate": 0.0,
                                   "metadata": {"dropout": 0.0},
                                   "classifier": {"dropout": 0.0}},
                         "data": {"use_segmentation_mask": True}})
        model = build_model(cfg, device="cuda").train()
        before = [f.launches for f in fns]
        x = torch.randn(2, 2 * patch, 2 * patch, 4, device="cuda")
        logits = model(x, torch.randn(2, 13, device="cuda"))["logits"]
        logits.float().square().sum().backward()
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(fns, before)] == [2, 2], impl
        assert torch.isfinite(logits).all(), impl
        assert all(torch.isfinite(p.grad).all() for p in model.parameters()
                   if p.grad is not None), impl


# --- K9: attention on flat q, k and v ----------------------------------------

def _flat_plain(q, k, v, heads):
    return tattn.dot_product_attention_flat(q, k, v, heads, impl="xla")


@pytest.mark.parametrize("b,n,heads,d,dtype,tol", [
    (2, 37, 2, 64, torch.float32, (2e-5, 1e-4)),
    (3, 197, 12, 64, torch.float32, (2e-5, 1e-4)),
    (2, 37, 2, 80, torch.float32, (2e-5, 1e-4)),
    (2, 1, 2, 64, torch.float32, (2e-5, 1e-4)),
    (4, 197, 12, 64, torch.bfloat16, (2.0 ** -5, 2.0 ** -5)),
    (2, 577, 16, 64, torch.bfloat16, (2.0 ** -5, 2.0 ** -5)),
    (2, 197, 2, 80, torch.bfloat16, (2.0 ** -5, 2.0 ** -5))])
def test_k9_matches_plain(cuda, b, n, heads, d, dtype, tol):
    e = heads * d
    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v, dout = (torch.randn(b, n, e, device="cuda", generator=g).to(dtype)
                     for _ in range(4))
    counted = (fa.flash_attention_flat, fa.flat_attention_lse_cuda,
               fa.flat_attention_bwd_cuda, fa.flash_attention_qkv)
    counts = [f.launches for f in counted]
    out = fa.flash_attention_flat(q, k, v, heads)
    out2, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and out.dtype == dtype
    assert float((out.float() - _flat_plain(q, k, v, heads).float())
                 .abs().max()) <= tol[0]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float().reshape(b, n, heads, d),
                     k.float().reshape(b, n, heads, d)) / math.sqrt(d)
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-4
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention_flat(*leaves, heads), leaves,
                              dout)
    torch.cuda.synchronize()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(_flat_plain(*plain, heads), plain, dout)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        assert _rel_err(a, w) <= tol[1], (name, _rel_err(a, w))
    assert [f.launches - c for f, c in zip(counted, counts)] == [1, 2, 1, 0]


@pytest.mark.parametrize("n,d,dtype", [(197, 64, torch.bfloat16),
                                       (37, 80, torch.float32)])
def test_k9_gives_k10_bits_on_the_same_values(cuda, n, d, dtype):
    """K9 reads three (B, N, E) tensors where K10 reads the thirds of one
    packed (B, N, 3E): the output, lse and gradients are the same bits."""
    heads, b = 12 if d == 64 else 2, 3
    e = heads * d
    g = torch.Generator(device="cuda").manual_seed(n)
    qkv = torch.randn(b, n, 3 * e, device="cuda", generator=g).to(dtype)
    dout = torch.randn(b, n, e, device="cuda", generator=g).to(dtype)
    q, k, v = (t.contiguous() for t in qkv.split(e, dim=-1))
    assert torch.equal(fa.flat_attention_cuda(q, k, v, heads),
                       fa.qkv_attention_cuda(qkv, heads))
    out, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
    out_p, lse_p = fa.qkv_attention_lse_cuda(qkv, heads)
    assert torch.equal(out, out_p) and torch.equal(lse, lse_p)
    grads = fa.flat_attention_bwd_cuda(q, k, v, out, dout, lse, heads)
    dqkv = fa.qkv_attention_bwd_cuda(qkv, out_p, dout, lse_p, heads)
    assert torch.equal(torch.cat(grads, dim=-1), dqkv)


def test_k9_refuses_what_it_does_not_take(cuda):
    q = torch.randn(2, 9, 128, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_flat(q, q, q, 4)                  # d = 32
    with pytest.raises(TypeError):
        fa.flash_attention_flat(q, q.bfloat16(), q, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_flat(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                                q, 2)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.randn(2 * 9 * 128 + 1, device="cuda")[1:].view(2, 9, 128)
        fa.flash_attention_flat(q, q, odd, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flat_attention_cuda(q.cpu(), q.cpu(), q.cpu(), 2)
    out, lse = fa.flat_attention_lse_cuda(q, q, q, 2)
    with pytest.raises(ValueError, match="lse"):
        fa.flat_attention_bwd_cuda(q, q, q, out, out, lse[:, :1], 2)


def test_op_level_entries_reach_the_kernels(cuda):
    """On CUDA tensors with impl="auto": dot_product_attention_flat and
    dot_product_attention without a bias launch K9 once a call (its
    log-sum-exp entry and backward under grad); with a bias the plain body
    runs and launches nothing; windowed_cosine_attention_flat launches K12."""
    counted = (fa.flash_attention_flat, fa.flat_attention_lse_cuda,
               fa.flat_attention_bwd_cuda, fa.flash_attention_cosine_flat,
               fa.cosine_window_attention_lse_cuda,
               fa.cosine_window_attention_bwd_cuda)

    def launched(fn):
        before = [f.launches for f in counted]
        fn()
        torch.cuda.synchronize()
        return [f.launches - b for f, b in zip(counted, before)]

    q = torch.randn(2, 37, 128, device="cuda", requires_grad=True)
    qh = q.detach().view(2, 37, 2, 64)
    with torch.no_grad():
        assert launched(lambda: tattn.dot_product_attention_flat(q, q, q, 2)) \
            == [1, 0, 0, 0, 0, 0]
        assert launched(lambda: tattn.dot_product_attention(qh, qh, qh)) \
            == [1, 0, 0, 0, 0, 0]
        assert launched(lambda: tattn.dot_product_attention(
            qh, qh, qh, bias=torch.zeros(2, 37, 37, device="cuda"))) == [0] * 6
    assert launched(lambda: tattn.dot_product_attention_flat(q, q, q, 2).sum()
                    .backward()) == [0, 1, 1, 0, 0, 0]
    wq, wk, wv, bias, mask = _window_inputs(2, 2, 49, 2, torch.float32, seed=1)
    scale = torch.full((2,), 10.0, device="cuda", requires_grad=True)
    with torch.no_grad():
        assert launched(lambda: tattn.windowed_cosine_attention_flat(
            wq, wk, wv, scale, bias, mask, 2)) == [0, 0, 0, 1, 0, 0]
    assert launched(lambda: tattn.windowed_cosine_attention_flat(
        wq, wk, wv, scale, bias, mask, 2).sum().backward()) == [0, 0, 0, 0, 1, 1]
    assert scale.grad is not None and torch.isfinite(scale.grad).all()


# --- K12: the scaled-cosine windowed attention --------------------------------

def _cosine_plain(*args):
    return tattn.windowed_cosine_attention_flat(*args, impl="xla")


def _cosine_scale(heads, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = math.log(10), math.log(100)
    return torch.exp(lo + (hi - lo) * torch.rand(heads, device="cuda", generator=g))


def _held(got, want, dtype):
    """K12's measure: fp32, max |difference| over max(1, max |plain|);
    bf16, the RMS of the difference over the RMS of the plain value."""
    return _rel_err(got, want) if dtype == torch.float32 else _rel_rms(got, want)


@pytest.mark.parametrize("w0,b,n,heads,dtype,masked", [
    (4, 3, 49, 2, torch.float32, True),
    (1, 5, 64, 6, torch.float32, False),
    (2, 3, 144, 4, torch.float32, True),
    (1, 40, 33, 2, torch.float32, False),     # more rows than row groups
    (4, 3, 49, 2, torch.bfloat16, True),
    (4, 2, 576, 6, torch.bfloat16, True),
    (1, 3, 144, 48, torch.bfloat16, False)])
def test_k12_matches_plain(cuda, w0, b, n, heads, dtype, masked):
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, dtype, seed=n + w0 + 2,
                                         masked=masked)
    scale = _cosine_scale(heads, n)
    g = torch.Generator(device="cuda").manual_seed(n + 3)
    dout = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
    counted = (fa.flash_attention_cosine_flat, fa.cosine_window_attention_lse_cuda,
               fa.cosine_window_attention_bwd_cuda, fa.flash_attention_bias_flat)
    counts = [f.launches for f in counted]
    out = fa.flash_attention_cosine_flat(q, k, v, scale, bias, mask, heads)
    out2, lse, out32 = fa.cosine_window_attention_lse_cuda(q, k, v, scale, bias,
                                                           mask, heads)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(out32.to(dtype), out)
    want = _cosine_plain(q, k, v, scale, bias, mask, heads)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert _held(out, want, dtype) <= tol
    leaves = [t.clone().requires_grad_() for t in (q, k, v, scale, bias)]
    got = torch.autograd.grad(fa.flash_attention_cosine_flat(
        *leaves, mask, heads), leaves, dout)
    torch.cuda.synchronize()
    plain = [t.clone().requires_grad_() for t in (q, k, v, scale, bias)]
    want = torch.autograd.grad(_cosine_plain(*plain, mask, heads), plain, dout)
    if dtype == torch.bfloat16:   # dscale: in the TPU kernel's order
        want = list(want)
        want[3] = tattn.windowed_cosine_dscale(q, k, v, scale, bias, mask, dout,
                                               heads)
    assert [t.dtype for t in got] == [dtype] * 3 + [torch.float32] * 2
    for name, a, w in zip(("dq", "dk", "dv", "dscale", "dbias"), got, want):
        assert a.shape == w.shape and torch.isfinite(a).all(), name
        assert _held(a, w, dtype) <= tol, (name, _held(a, w, dtype), tol)
    assert [f.launches - c for f, c in zip(counted, counts)] == [1, 2, 1, 0]


def test_k12_backward_gives_the_same_bits_twice_and_zero_rows_are_finite(cuda):
    q, k, v, bias, mask = _window_inputs(4, 3, 49, 2, torch.bfloat16, seed=5)
    q[:, :3] = 0
    k[:, 5:7] = 0
    k[:, 9] = 1e-8
    scale = _cosine_scale(2, 5)
    out, lse, out32 = fa.cosine_window_attention_lse_cuda(q, k, v, scale, bias,
                                                          mask, 2)
    dout = torch.randn_like(out)
    first = fa.cosine_window_attention_bwd_cuda(q, k, v, scale, bias, mask,
                                                out32, dout, lse, 2)
    second = fa.cosine_window_attention_bwd_cuda(q, k, v, scale, bias, mask,
                                                 out32, dout, lse, 2)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(t).all() for t in first)
    assert float(first[0][:, :3].abs().max()) > 0    # the clamp branch: r·dq̂


def test_k12_refuses_what_it_does_not_take(cuda):
    q, k, v, bias, mask = _window_inputs(2, 2, 16, 2, torch.float32)
    scale = torch.full((2,), 10.0, device="cuda")
    with pytest.raises(ValueError, match="scale"):
        fa.flash_attention_cosine_flat(q, k, v, scale[:1], bias, mask, 2)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cosine_flat(q, k, v, scale[:1], bias[:1], mask, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fa.cosine_window_attention_cuda(q.cpu(), k.cpu(), v.cpu(), scale.cpu(),
                                        bias.cpu(), mask.cpu(), 2)
    with pytest.raises(ValueError, match="constant"):
        fa.flash_attention_cosine_flat(q, k, v, scale, bias,
                                       mask.clone().requires_grad_(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cosine_flat(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v, scale, bias,
            mask, 2)
    out, lse, out32 = fa.cosine_window_attention_lse_cuda(q, k, v, scale, bias,
                                                          mask, 2)
    with pytest.raises(ValueError, match="out32"):
        fa.cosine_window_attention_bwd_cuda(q, k, v, scale, bias, mask,
                                            out32[:, 1:], out, lse, 2)
    with pytest.raises(ValueError, match="lse"):
        fa.cosine_window_attention_bwd_cuda(q, k, v, scale, bias, mask, out32,
                                            out, lse.double(), 2)
    lib = fa._window_bwd_library()
    groups = lib.cosine_window_attention_bwd_row_groups(4, 16, 64, 2, 2, 0)
    assert groups >= 1
    ptrs = [t.data_ptr() for t in (q, k, v, scale, bias, mask, out32, out, lse)]
    ptrs += [q.data_ptr()] * 8
    stream = torch.cuda.current_stream().cuda_stream
    # a dscale workspace one float short is refused
    assert lib.cosine_window_attention_bwd(*ptrs, 4, 16, 64, 2, 2, 0, groups,
                                           2 * groups - 1, stream) != 0


# --- the tensor-core attention forward (attention_fwd.cuh, bf16) -------------

ATTN_FWD_N = (1, 15, 16, 17, 63, 64, 65, 127, 129, 197, 577)


@pytest.mark.parametrize("n", ATTN_FWD_N)
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("entry", ["qkvb", "qkv", "flat"])
def test_attention_forward_matches_plain_at_every_tail(cuda, n, d, entry):
    """The bf16 forward at query and key tails on both sides of its 64-key
    and 128-query tiles: with the bias (K1, K2; ld = 3E), without (K10; ld = 3E) and on
    flat q, k, v (K9; ld = E); the serving entry and the log-sum-exp entry,
    the same bits. The output at K1's 2^-5, the log-sum-exp at K2's 1e-4
    against ``torch.logsumexp`` of the fp32 scores of the biased bf16 q, k."""
    b, heads = 2, 2
    e = heads * d
    qkv, bias = _inputs(b, n, e, torch.bfloat16, seed=n + d)
    if entry == "qkvb":
        out = fa.flash_attention_qkvb(qkv, bias, heads)
        out2, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
        want = attention_from_qkvb(qkv, bias, heads)
        x = qkv + bias.to(qkv.dtype)
    elif entry == "qkv":
        out = fa.flash_attention_qkv(qkv, heads)
        out2, lse = fa.qkv_attention_lse_cuda(qkv, heads)
        want = attention_from_qkv(qkv, heads)
        x = qkv
    else:
        q, k, v = (t.contiguous() for t in qkv.split(e, dim=-1))
        out = fa.flash_attention_flat(q, k, v, heads)
        out2, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
        want = _flat_plain(q, k, v, heads)
        x = qkv
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and out.shape == (b, n, e)
    assert torch.isfinite(out).all()
    assert float((out.float() - want.float()).abs().max()) <= 2.0 ** -5
    q = x[..., :e].reshape(b, n, heads, d).float()
    k = x[..., e:2 * e].reshape(b, n, heads, d).float()
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(d)
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-4


def test_attention_forward_gives_the_same_bits_every_run(cuda):
    qkv, bias = _inputs(4, 197, 768, torch.bfloat16, seed=11)
    first = fa.qkvb_attention_cuda(qkv, bias, 12)
    assert all(torch.equal(first, fa.qkvb_attention_cuda(qkv, bias, 12))
               for _ in range(3))


# --- gemm.cuh's products alone (gemm_product) --------------------------------
#
# Against ``product_plain`` on the same operands: both sum in fp32 and round
# once, so bf16 values differ by at most one bf16 ulp (2^-7 of the value)
# where the two fp32 sums straddle a rounding boundary, plus 1e-3 near zero,
# where sums of K ~ 800 unit products in another order differ by ~1e-4; fp32
# 1e-5 of the value plus 1e-4 (the summation order alone).

GEMM_TOL = {torch.bfloat16: (2.0 ** -7, 1e-3), torch.float32: (1e-5, 1e-4)}


def _gemm_operands(m, n, k, transpose_a, transpose_b, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(*((k, m) if transpose_a else (m, k)), device="cuda",
                    generator=g)
    b = torch.randn(*((n, k) if transpose_b else (k, n)), device="cuda",
                    generator=g) / math.sqrt(k)
    bias = 0.5 * torch.randn(n, device="cuda", generator=g)
    return a.to(dtype), b.to(dtype), bias.to(dtype)


def _gemm_close(got, want, dtype):
    rtol, atol = GEMM_TOL[dtype]
    err = (got.float() - want.float()).abs() - rtol * want.float().abs()
    return float(err.max()) <= atol


@pytest.mark.parametrize("transpose_a,transpose_b", [
    (False, False),   # x·W: the projection, W n-contiguous
    (False, True),    # dqkv·Wᵀ: dx
    (True, False),    # xᵀ·dqkv: dW, both operands m-/n-contiguous
    (True, True)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_product_matches_plain_in_each_layout(cuda, transpose_a,
                                                   transpose_b, with_bias,
                                                   dtype):
    """M = 8·197, N = 264 and K = 776: multiples of 8, not of the tiles."""
    m, n, k = 8 * 197, 264, 776
    a, b, bias = _gemm_operands(m, n, k, transpose_a, transpose_b, dtype,
                                seed=m + n + k + 2 * transpose_a + transpose_b)
    bias = bias if with_bias else None
    before = fa.gemm_product.launches
    got = fa.gemm_product(a, b, bias, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    torch.cuda.synchronize()
    assert fa.gemm_product.launches == before + 1
    want = tattn.product_plain(a.t() if transpose_a else a,
                               b.t() if transpose_b else b, bias)
    assert got.shape == (m, n) and got.dtype == dtype
    assert torch.isfinite(got).all()
    assert _gemm_close(got, want, dtype)


def test_gemm_product_dw_gives_the_same_bits_twice(cuda):
    """xᵀ·dqkv at ViT-B's widths (768 x 2304 over 8·197 rows), both operands
    read as they lie: the same bits twice, within the limit of the plain
    version."""
    rows, dim, e3 = 8 * 197, 768, 2304
    x, dqkv, _ = _gemm_operands(dim, e3, rows, True, False, torch.bfloat16, 5)
    first = fa.gemm_product(x, dqkv, transpose_a=True)
    second = fa.gemm_product(x, dqkv, transpose_a=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _gemm_close(first, tattn.product_plain(x.t(), dqkv), torch.bfloat16)


def test_gemm_product_refuses_what_it_does_not_take(cuda):
    a, b, bias = _gemm_operands(64, 64, 64, False, False, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.gemm_product(a[:60].contiguous(), b)
    with pytest.raises(ValueError, match="multiply"):
        fa.gemm_product(a, b[:56].contiguous())
    with pytest.raises(TypeError):
        fa.gemm_product(a, b.float())
    with pytest.raises(ValueError, match="bias"):
        fa.gemm_product(a, b, bias[:8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.gemm_product(a.t(), b)
    lib = fa._xqkv_library()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = a.data_ptr()
    # a leading dimension shorter than its row
    assert lib.gemm_product(ptr, 56, 1, ptr, 64, 0, None, ptr, 64, 64, 64, 64,
                            1, stream) != 0


# --- the tensor-core attention backwards (attention_bwd.cuh and
# window_attention_bwd.cu, bf16) --------------------------------------------

ORDER_RTOL = 2.0 ** -9
ATTN_BWD_N = (1, 15, 16, 17, 63, 64, 65, 197, 577)


@pytest.mark.parametrize("n", ATTN_BWD_N)
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("entry", ["qkvb", "qkv", "flat"])
def test_attention_backward_matches_kernel_order_plain_at_every_tail(
        cuda, n, d, entry):
    """The bf16 backward at query and key tails on both sides of its 64-row
    tiles: with the bias and its gradient (K3; ld = 3E), without (K10's;
    ld = 3E) and on flat q, k, v (K9's; ld = E), each against its plain
    version in the kernels' order on the kernel forward's out and lse."""
    b, heads = 2, 2
    e = heads * d
    qkv, bias = _inputs(b, n, e, torch.bfloat16, seed=n + d + 1)
    g = torch.Generator(device="cuda").manual_seed(n + d)
    dout = torch.randn(b, n, e, device="cuda", generator=g).bfloat16()
    if entry == "qkvb":
        out, lse = fa.qkvb_attention_lse_cuda(qkv, bias, heads)
        got = fa.qkvb_attention_bwd_cuda(qkv, bias, out, dout, lse, heads)
        want = fa.qkvb_attention_bwd_plain(qkv, bias, out, dout, lse, heads)
    elif entry == "qkv":
        out, lse = fa.qkv_attention_lse_cuda(qkv, heads)
        got = (fa.qkv_attention_bwd_cuda(qkv, out, dout, lse, heads),)
        want = fa.qkvb_attention_bwd_plain(qkv, None, out, dout, lse, heads)[:1]
    else:
        # dq, dk and dv held together, as dqkv is: at N = 1, P = 1 and dq, dk
        # are rounding noise around 0 on their own
        q, k, v = (t.contiguous() for t in qkv.split(e, dim=-1))
        out, lse = fa.flat_attention_lse_cuda(q, k, v, heads)
        got = (torch.cat(fa.flat_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                    heads), dim=-1),)
        want = (torch.cat(fa.flat_attention_bwd_plain(q, k, v, out, dout, lse,
                                                      heads), dim=-1),)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert torch.isfinite(a).all()
        assert _rel_rms(a, w) <= ORDER_RTOL, _rel_rms(a, w)


@pytest.mark.parametrize("n", [16, 49, 144, 576])
@pytest.mark.parametrize("w0,b", [(1, 3), (4, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", ["K6", "K12"])
def test_window_backward_matches_kernel_order_plain(cuda, n, w0, b, masked,
                                                    kernel):
    """K6 and K12's bf16 backward against their plain versions in the
    kernels' order, with one window (W0 = 1) and several, with and without
    the shift mask, at SwinV2-L's window sizes (144, 576), a small one and a
    ragged one (49: no 16-byte rows of the bias)."""
    heads = 2
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, torch.bfloat16,
                                         seed=n + w0 + 7, masked=masked)
    g = torch.Generator(device="cuda").manual_seed(n + w0)
    dout = torch.randn(q.shape, device="cuda", generator=g).bfloat16()
    if kernel == "K6":
        out, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask,
                                                       heads)
        got = fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32, dout,
                                           lse, heads)
        want = fa.window_attention_bwd_plain(q, k, v, bias, mask, out32, dout,
                                             lse, heads)
    else:
        scale = _cosine_scale(heads, n)
        out, lse, out32 = fa.cosine_window_attention_lse_cuda(
            q, k, v, scale, bias, mask, heads)
        got = fa.cosine_window_attention_bwd_cuda(q, k, v, scale, bias, mask,
                                                  out32, dout, lse, heads)
        want = fa.cosine_window_attention_bwd_plain(q, k, v, scale, bias, mask,
                                                    out32, dout, lse, heads)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert torch.isfinite(a).all()
        assert _rel_rms(a, w) <= ORDER_RTOL, _rel_rms(a, w)


@pytest.mark.parametrize("kernel", ["K3", "K10", "K6"])
def test_attention_backward_gives_the_same_bits_every_run(cuda, kernel):
    """No atomics: every sum is taken in one order."""
    if kernel == "K6":
        q, k, v, bias, mask = _window_inputs(4, 2, 144, 4, torch.bfloat16,
                                             seed=13)
        out, lse, out32 = fa.window_attention_lse_cuda(q, k, v, bias, mask, 4)
        dout = torch.randn_like(out)

        def run():
            return fa.window_attention_bwd_cuda(q, k, v, bias, mask, out32,
                                                dout, lse, 4)
    else:
        qkv, bias = _inputs(8, 197, 768, torch.bfloat16, seed=17)
        dout = torch.randn(8, 197, 768, device="cuda").bfloat16()
        if kernel == "K3":
            out, lse = fa.qkvb_attention_lse_cuda(qkv, bias, 12)

            def run():
                return fa.qkvb_attention_bwd_cuda(qkv, bias, out, dout, lse, 12)
        else:
            out, lse = fa.qkv_attention_lse_cuda(qkv, 12)

            def run():
                return (fa.qkv_attention_bwd_cuda(qkv, out, dout, lse, 12),)
    first = run()
    assert all(all(torch.equal(a, c) for a, c in zip(first, run()))
               for _ in range(3))


# --- the tensor-core windowed forward (window_attention.cu, bf16) -----------

FWD_ORDER_RTOL = 2.0 ** -8
# SwinV2-L@384's four stage shapes cut to 2 images (W0, B, N, H, masked), a
# ragged window (49: no 16-byte rows of the bias), 144 = 2·64 + 16 with an
# odd B, a lone token, and N = 640, past the 576 whose bias slab fits in
# shared memory (each score then reads its bias and mask from L2)
WINDOW_FWD_CASES = [(16, 2, 576, 6, True), (4, 2, 576, 12, True),
                    (1, 2, 576, 24, False), (1, 2, 144, 48, False),
                    (4, 3, 49, 2, True), (2, 3, 144, 4, True),
                    (3, 2, 1, 1, True), (1, 2, 640, 2, True)]


@pytest.mark.parametrize("w0,b,n,heads,masked", WINDOW_FWD_CASES)
@pytest.mark.parametrize("kernel", ["K5", "K12"])
def test_window_forward_matches_kernel_order_plain(cuda, w0, b, n, heads,
                                                   masked, kernel):
    """K5's and K12's bf16 forwards and log-sum-exp entries against their
    plain version in the kernel's order; the entries give the same output,
    out32 rounds to it, and a second run gives the same bits."""
    q, k, v, bias, mask = _window_inputs(w0, b, n, heads, torch.bfloat16,
                                         seed=n + heads + w0, masked=masked)
    if kernel == "K5":
        args = (q, k, v, bias, mask, heads)
        fwd, entry = fa.window_attention_cuda, fa.window_attention_lse_cuda
        want = fa.window_attention_fwd_plain(*args)
    else:
        scale = _cosine_scale(heads, n + 1)
        args = (q, k, v, scale, bias, mask, heads)
        fwd = fa.cosine_window_attention_cuda
        entry = fa.cosine_window_attention_lse_cuda
        want = fa.window_attention_fwd_plain(q, k, v, bias, mask, heads, scale)
    out = fwd(*args)
    out2, lse, out32 = entry(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert torch.equal(out, out2) and torch.equal(out32.to(out.dtype), out)
    assert _rel_rms(out, want[0]) <= FWD_ORDER_RTOL, _rel_rms(out, want[0])
    assert _rel_rms(out32, want[2]) <= FWD_ORDER_RTOL, _rel_rms(out32, want[2])
    diff = (lse - want[1]).abs()
    if kernel == "K5":
        assert float(diff.max()) <= 1e-4
    else:       # a rare straddled element of q̂ moves its row's scores
        assert float(diff.mean()) <= 2.0 ** -8
    assert torch.equal(fwd(*args), out)
    again = entry(*args)
    assert torch.equal(again[1], lse) and torch.equal(again[2], out32)


def test_cosine_window_forward_takes_zero_rows(cuda):
    """K12's bf16 forward with rows of q and k of norm 0 and below 1e-6 (the
    norm's clamp): finite, and its kernel-order plain version's."""
    q, k, v, bias, mask = _window_inputs(4, 3, 49, 2, torch.bfloat16, seed=9)
    q[:, :3] = 0
    q[:, 3] *= 1e-8
    k[:, 5:7] = 0
    k[:, 9] = 1e-8
    scale = _cosine_scale(2, 9)
    out, lse, out32 = fa.cosine_window_attention_lse_cuda(q, k, v, scale, bias,
                                                          mask, 2)
    want = fa.window_attention_fwd_plain(q, k, v, bias, mask, 2, scale)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel_rms(out32, want[2]) <= FWD_ORDER_RTOL


def test_window_forward_mask_none_is_zeros(cuda):
    """The bf16 forward with mask=None (no bytes read for it) gives the bits
    of a zeros mask, through both entries and K12."""
    q, k, v, bias, _ = _window_inputs(1, 3, 144, 4, torch.bfloat16, seed=11)
    zeros = torch.zeros(1, 144, 144, device="cuda")
    assert torch.equal(fa.window_attention_cuda(q, k, v, bias, None, 4),
                       fa.window_attention_cuda(q, k, v, bias, zeros, 4))
    for a, z in zip(fa.window_attention_lse_cuda(q, k, v, bias, None, 4),
                    fa.window_attention_lse_cuda(q, k, v, bias, zeros, 4)):
        assert torch.equal(a, z)
    scale = _cosine_scale(4, 11)
    assert torch.equal(
        fa.cosine_window_attention_cuda(q, k, v, scale, bias, None, 4),
        fa.cosine_window_attention_cuda(q, k, v, scale, bias, zeros, 4))


# --- K4's column sums ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_gives_the_same_bits_twice(cuda, dtype):
    """No atomics: dgamma and dbeta are summed in one order."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4608, 768, device="cuda", generator=g).to(dtype)
    dy = torch.randn(4608, 768, device="cuda", generator=g).to(dtype)
    w = torch.randn(768, device="cuda", generator=g)
    first = ln.layer_norm_bwd(x, w, dy, 1e-6)
    second = ln.layer_norm_bwd(x, w, dy, 1e-6)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


# --- model.remat and the plain attention options on the card -----------------

@pytest.mark.parametrize("backbone,size", [("vit_tiny_patch16_224", 32),
                                           ("swinv2_tiny_window8_64", 64)])
def test_remat_on_the_card_is_bit_equal_and_runs_the_forward_twice(
        cuda, backbone, size):
    """A rematerialised train-mode forward and backward (drop-path 0.1, the
    masks from a CUDA generator) gives the gradients and the generator state
    of the same pass without remat, bit for bit, and launches the forward
    kernel under grad twice a block; the backward and K4 once."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model

    cfg = from_dict({"model": {"backbone": backbone, "image_size": size,
                               "compute_dtype": "bfloat16",
                               "drop_path_rate": 0.1, "remat": True},
                     "data": {"use_segmentation_mask": True}})
    model = build_model(cfg, device="cuda").train()
    blocks = [m for m in model.modules()
              if isinstance(getattr(m, "remat", None), bool)]
    x = torch.randn(3, size, size, 4, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    fwd, bwd = ((fa.qkvb_attention_lse_cuda, fa.qkvb_attention_bwd_cuda)
                if backbone.startswith("vit") else
                (fa.window_attention_lse_cuda, fa.window_attention_bwd_cuda))
    got = {}
    for on in (False, True):
        for m in blocks:
            m.remat = on
        g = torch.Generator(device="cuda").manual_seed(2)
        before = [f.launches for f in (fwd, bwd, ln.layer_norm_bwd_cuda)]
        model(x, generator=g)["logits"].float().square().sum().backward()
        torch.cuda.synchronize()
        got[on] = ([f.launches - b for f, b in
                    zip((fwd, bwd, ln.layer_norm_bwd_cuda), before)],
                   {n: p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None}, g.get_state())
        model.zero_grad(set_to_none=True)
    (n0, g0, s0), (n1, g1, s1) = got[False], got[True]
    assert n1 == [2 * n0[0], n0[1], n0[2]] and n0[0] > 0
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert torch.equal(s0, s1)


@pytest.mark.parametrize("backbone,size,impl", [
    ("vit_tiny_patch16_224", 32, "xla"), ("swinv2_tiny_window8_64", 64, "xla"),
    ("swinv2_tiny_window8_64", 64, "packed")])
def test_plain_attention_options_launch_no_attention_kernel(cuda, backbone,
                                                            size, impl):
    """``xla`` (and ``packed`` on a SwinV2) run the plain attention on the
    card, forward and backward: no attention kernel, K4 as usual; in fp32
    the logits match ``auto``'s on the same weights within 1e-4 of the RMS
    logit (the kernels' fp32 sums in another order; TF32 is off)."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models import build_model

    def cfg(value):
        return from_dict({"model": {"backbone": backbone, "image_size": size,
                                    "compute_dtype": "float32",
                                    "attention_impl": value},
                          "data": {"use_segmentation_mask": True}})

    auto = build_model(cfg("auto"), device="cuda")
    plain = build_model(cfg(impl), device="cuda")
    plain.load_state_dict(auto.state_dict())
    x = torch.randn(2, size, size, 4, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    fns = [f for f in vars(fa).values() if hasattr(f, "launches")]
    before = [f.launches for f in fns]
    k4 = ln.layer_norm_bwd_cuda.launches
    logits = plain(x)["logits"]
    logits.float().square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == before
    assert ln.layer_norm_bwd_cuda.launches > k4
    with torch.no_grad():
        want = auto(x)["logits"].float()
    err = ((logits.detach().float() - want).square().mean()
           / want.square().mean()).sqrt()
    assert float(err) <= 1e-4


# --- the rotary kernel (EVA-02's 2-D RoPE) and the EVA-02 block --------------

@pytest.mark.parametrize("b,n,e,heads,dtype", [
    (32, 1025, 1024, 16, torch.bfloat16), (3, 17, 192, 3, torch.bfloat16),
    (9, 1025, 1024, 16, torch.bfloat16), (5, 17, 192, 3, torch.float32),
    (2, 50, 128, 2, torch.float32)])
def test_rotary_kernel_matches_plain(cuda, b, n, e, heads, dtype):
    """The kernel and ``rotate_plain`` take the same roundings: the same
    bits, forward (+θ) and backward (−θ), into new tensors, the inputs left
    as they were; the class token copied as it is."""
    from fedvit_torch.ops import rotary
    grid = int(round((n - 1) ** 0.5))
    cos, sin = rotary.rope_table(grid, e // heads, 16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(n + e)
    q, k = (torch.randn(b, n, e, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    q0, k0 = q.clone(), k.clone()
    for sign in (1.0, -1.0):
        before = rotary.rotary_qk_cuda.launches
        qo, ko = rotary.rotary_qk_cuda(q, k, cos, sin, sign)
        assert rotary.rotary_qk_cuda.launches == before + 1
        s = sin if sign > 0 else -sin
        assert torch.equal(qo, rotary.rotate_plain(q.cpu(), cos.cpu(), s.cpu()
                                                   ).cuda())
        assert torch.equal(ko, rotary.rotate_plain(k, cos, s))
        assert torch.equal(qo[:, 0], q[:, 0]) and torch.equal(ko[:, 0], k[:, 0])
        assert torch.equal(q, q0) and torch.equal(k, k0)
        assert qo.data_ptr() != q.data_ptr() and ko.data_ptr() != k.data_ptr()


def test_rotary_autograd_turns_the_gradient_back(cuda):
    """Under grad ``rotary_qk`` launches the kernel once forward and once
    backward, and the gradient is the output's turned by −θ."""
    from fedvit_torch.ops import rotary
    cos, sin = rotary.rope_table(4, 64, 16, device="cuda")
    q = torch.randn(2, 17, 128, device="cuda", requires_grad=True)
    k = torch.randn(2, 17, 128, device="cuda", requires_grad=True)
    dq, dk = torch.randn_like(q), torch.randn_like(k)
    before = rotary.rotary_qk_cuda.launches
    qo, ko = rotary.rotary_qk(q, k, cos, sin)
    torch.autograd.backward([qo, ko], [dq, dk])
    assert rotary.rotary_qk_cuda.launches == before + 2
    assert torch.equal(q.grad, rotary.rotate_plain(dq, cos, -sin))
    assert torch.equal(k.grad, rotary.rotate_plain(dk, cos, -sin))


def test_rotary_refuses_what_it_does_not_take(cuda):
    from fedvit_torch.ops import rotary
    cos, sin = rotary.rope_table(4, 64, 16, device="cuda")
    q = torch.randn(2, 17, 128, device="cuda")
    for args, err in [((q.half(), q.half(), cos, sin), TypeError),
                      ((q[:, :9].contiguous(), q[:, :9].contiguous(), cos, sin),
                       ValueError),                            # a short table
                      ((q, q, cos.double(), sin.double()), ValueError),
                      ((q[..., :96].contiguous(), q[..., :96].contiguous(),
                        cos, sin), ValueError)]:               # E not heads of d
        before = rotary.rotary_qk_cuda.launches
        with pytest.raises(err):
            rotary.rotary_qk_cuda(*args)
        assert rotary.rotary_qk_cuda.launches == before


def test_eva_training_step_on_the_card_matches_the_cpu(cuda):
    """A two-block EVA-02 (E 128, 2 heads, SwiGLU width 342: the ragged
    LayerNorm kernels in fp32) under grad launches, a block, K9's entry and
    backward once, the rotary kernel twice, three LayerNorm forwards and
    three K4s, one of each ragged; its features and gradients match the
    CPU's."""
    from fedvit_torch.models.eva import Eva
    from fedvit_torch.ops import rotary
    kw = dict(image_size=56, patch_size=14, in_channels=4, embed_dim=128,
              depth=2, num_heads=2, mlp_hidden=342, drop_path_rate=0.0)
    cpu = Eva(**kw).train()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn_like(p))
    gpu = Eva(**kw).cuda().train()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 56, 56, 4, generator=torch.Generator().manual_seed(1))
    counters = (fa.flat_attention_lse_cuda, fa.flat_attention_bwd_cuda,
                rotary.rotary_qk_cuda, ln.layer_norm_fwd_cuda,
                ln.layer_norm_bwd_cuda)
    before = [c.launches for c in counters]
    ragged = [ln.layer_norm_fwd_cuda.ragged_launches,
              ln.layer_norm_bwd_cuda.ragged_launches]
    out = gpu(x.cuda())
    out.square().sum().backward()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 4, 7, 7]
    assert [ln.layer_norm_fwd_cuda.ragged_launches - ragged[0],
            ln.layer_norm_bwd_cuda.ragged_launches - ragged[1]] == [2, 2]
    want = cpu(x)
    want.square().sum().backward()
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4, rtol=1e-3,
                                   msg=name)
