"""The plain versions of the attention backwards in the kernels' own order
(``fedvit_torch/ops/flash_attention.py``'s ``*_bwd_plain``, which the
tensor-core backwards are held to on the card) against ``jax.vjp`` of the JAX
package's Pallas kernels in interpret mode, in bf16, on the CPU, on the same
seeded numpy inputs.

Both round P and dS to bf16 before their products and sum in fp32. They
differ in what each reads: the port's plain version takes the kernel entry's
inputs, the forward's out and each row's log-sum-exp, and computes
P = exp(s − lse) and delta = Σ dout∘out (K6: the fp32 out before its
rounding); the TPU kernel recomputes P from the row max and sum and takes
delta = Σ_j dP∘P. The bf16 out moves delta by a bf16 rounding of it, so
dS = P∘(dP − delta) moves by that much where dP and delta nearly cancel, and
each stored gradient by an ulp here and there. Tolerance: each gradient's RMS
difference within 2^-6 of its RMS value, the card's gate against autograd of
the plain forward (chip_smoke.py's K6_RTOL_BF16), with dbias (K3: the fp32
sum of the rounded dqkv; K6: of the unrounded dS) at the same measure.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.ops import attention as tattn
from fedvit_torch.ops import flash_attention as tfa
from fedvit_tpu.ops import flash_attention as jfa

RTOL = 2.0 ** -6


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).bfloat16()


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if
                       t.dtype == torch.bfloat16 else jnp.float32)


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _torch_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _lse(q: torch.Tensor, k: torch.Tensor, heads: int, scale: float,
         add=None) -> torch.Tensor:
    """Each row's log-sum-exp of the fp32 scores of bf16 q and k, (rows, H,
    N), as the forward kernels write it."""
    rows, n, e = q.shape
    qh, kh = (t.reshape(rows, n, heads, e // heads).transpose(1, 2).float()
              for t in (q, k))
    s = qh @ kh.transpose(-1, -2) * scale
    return torch.logsumexp(s if add is None else s + add, dim=-1)


@pytest.mark.parametrize("n", [37, 197])
@pytest.mark.parametrize("entry", ["qkvb", "qkv", "flat"])
def test_attention_bwd_plain_matches_jax_kernel(n, entry):
    """K3 (with the bias and its gradient), K10's (no bias) and K9's (flat
    q, k, v) plain backward against the vjp of ``flash_attention_qkvb``,
    ``flash_attention_qkv`` and ``flash_attention_flat`` in interpret mode,
    d = 64 and a ragged N."""
    b, heads, d = 2, 2, 64
    e = heads * d
    rng = np.random.default_rng(n + len(entry))
    qkv = _bf16(rng.normal(size=(b, n, 3 * e)).astype(np.float32))
    bias = torch.from_numpy((0.5 * rng.normal(size=(3 * e,))).astype(np.float32))
    dout = _bf16(rng.normal(size=(b, n, e)).astype(np.float32))
    scale = 1.0 / math.sqrt(d)
    if entry == "qkvb":
        x = qkv + bias.bfloat16()
        out = tattn.attention_from_qkvb(qkv, bias, heads)
        got = tfa.qkvb_attention_bwd_plain(qkv, bias, out, dout,
                                           _lse(x[..., :e], x[..., e:2 * e],
                                                heads, scale), heads)
        _, vjp = jax.vjp(lambda t, bb: jfa.flash_attention_qkvb(
            t, bb, heads, interpret=True), _jax(qkv), _jax(bias))
        want = vjp(_jax(dout))
        names = ("dqkv", "dbias")
    elif entry == "qkv":
        out = tattn.attention_from_qkv(qkv, heads)
        got = tfa.qkvb_attention_bwd_plain(
            qkv, None, out, dout, _lse(qkv[..., :e], qkv[..., e:2 * e], heads,
                                       scale), heads)[:1]
        _, vjp = jax.vjp(lambda t: jfa.flash_attention_qkv(
            t, heads, interpret=True), _jax(qkv))
        want = vjp(_jax(dout))
        names = ("dqkv",)
    else:
        q, k, v = (t.contiguous() for t in qkv.split(e, dim=-1))
        out = tattn.dot_product_attention_flat(q, k, v, heads, impl="xla")
        got = tfa.flat_attention_bwd_plain(q, k, v, out, dout,
                                           _lse(q, k, heads, scale), heads)
        _, vjp = jax.vjp(lambda *t: jfa.flash_attention_flat(
            *t, heads, interpret=True), *map(_jax, (q, k, v)))
        want = vjp(_jax(dout))
        names = ("dq", "dk", "dv")
    assert all(g.dtype == torch.bfloat16 for g in got[:len(names)]
               if g.dim() == 3)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        assert np.isfinite(_torch_np(g)).all(), name
        assert _rel_rms(_torch_np(g), w) <= RTOL, (name, _rel_rms(_torch_np(g), w))


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("w0,b", [(1, 3), (3, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_bwd_plain_matches_jax_kernel(n, w0, b, masked):
    """K6's plain backward against the vjp of ``flash_attention_bias_flat``
    in interpret mode: dq, dk, dv and dbias, one window or several, with
    and without a shift mask."""
    heads = 2
    e = 32 * heads
    rows = w0 * b
    rng = np.random.default_rng(n + 10 * w0 + masked)
    q, k, v, dout = (_bf16(rng.normal(size=(rows, n, e)).astype(np.float32))
                     for _ in range(4))
    bias = torch.from_numpy(
        (4.0 * rng.normal(size=(heads, n, n))).astype(np.float32))
    mask = torch.from_numpy(np.where(rng.random((w0, n, n)) > 0.8, -100.0,
                                     0.0).astype(np.float32))
    if not masked:
        mask = torch.zeros_like(mask)
    add = (bias[None] + mask[:, None]).repeat_interleave(b, dim=0)
    qh, kh, vh = (t.reshape(rows, n, heads, 32).transpose(1, 2).float()
                  for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) + add, dim=-1)
    out32 = (p.bfloat16().float() @ vh).transpose(1, 2).reshape(rows, n, e)
    got = tfa.window_attention_bwd_plain(q, k, v, bias, mask, out32, dout,
                                         _lse(q, k, heads, 1.0, add), heads)
    _, vjp = jax.vjp(lambda *t: jfa.flash_attention_bias_flat(
        *t, _jax(mask), heads, interpret=True), *map(_jax, (q, k, v, bias)))
    want = vjp(_jax(dout))
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32]
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert np.isfinite(_torch_np(g)).all(), name
        assert _rel_rms(_torch_np(g), w) <= RTOL, (name, _rel_rms(_torch_np(g), w))
