"""The plain version of the windowed attention forward in the tensor-core
kernel's order (``fedvit_torch/ops/flash_attention.py::
window_attention_fwd_plain``, which K5's and K12's forwards are held to on
the card) against the JAX package's Pallas kernels in interpret mode, in
bf16, and against the port's plain windowed attention in fp32, on the CPU, on
the same seeded numpy inputs.

Both sides sum the scores in fp32 with the fp32 bias and mask. They differ in
where the softmax weights are rounded to bf16 before P·V: the TPU kernel
rounds the normalised weights of the whole row; the kernel-order plain version
rounds the unnormalised ones of each 64-key tile against the running max and
divides the fp32 sum at the end. Each weight is a bf16 rounding apart, so the
outputs differ by a bf16 ulp here and there. Tolerance: the RMS of the
difference within 2^-6 of the RMS of the output (the card's gate of K12's
bf16 output against its plain version, ``chip_smoke.py``'s K12_RTOL_BF16).
In fp32 the two orders are one function: atol 1e-5 on outputs of |v| < 5
(summation order and exp of differences), and the log-sum-exp against
``torch.logsumexp`` of the fp32 scores at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.ops import attention as tattn
from fedvit_torch.ops import flash_attention as tfa
from fedvit_tpu.ops import flash_attention as jfa

RTOL = 2.0 ** -6
ATOL_FP32 = 1e-5
HEADS = 2


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16 if
                       t.dtype == torch.bfloat16 else jnp.float32)


def _rel_rms(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _inputs(w0, b, n, masked, dtype, seed):
    """q, k, v (W0·B, N, 32·H) normal, a bias of 16·sigmoid size, a −100/0
    mask that differs per window (None when not ``masked``) and a per-head
    logit scale in [ln 10, ln 100]'s exp range."""
    rng = np.random.default_rng(seed)
    rows, e = w0 * b, 32 * HEADS
    q, k, v = (torch.from_numpy(rng.normal(size=(rows, n, e)).astype(np.float32))
               .to(dtype) for _ in range(3))
    bias = torch.from_numpy(
        (16.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(HEADS, n, n)))))
        .astype(np.float32))
    mask = torch.from_numpy(np.where(rng.random((w0, n, n)) > 0.8, -100.0,
                                     0.0).astype(np.float32))
    scale = torch.from_numpy(np.exp(rng.uniform(np.log(10.0), np.log(100.0),
                                                size=HEADS)).astype(np.float32))
    return q, k, v, bias, mask if masked else None, scale


@pytest.mark.parametrize("n", [16, 49])
@pytest.mark.parametrize("w0,b", [(1, 3), (3, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cosine", [False, True])
def test_window_fwd_plain_matches_jax_kernel(n, w0, b, masked, cosine):
    """bf16: K5's kernel-order plain forward against ``flash_attention_bias_flat``
    and K12's against ``flash_attention_cosine_flat``, in interpret mode; one
    window or several, with and without a shift mask, N within one key tile
    and ragged."""
    q, k, v, bias, mask, scale = _inputs(w0, b, n, masked, torch.bfloat16,
                                         n + 10 * w0 + 2 * masked + cosine)
    jmask = _jax(mask if masked else torch.zeros(w0, n, n))
    if cosine:
        out, lse, out32 = tfa.window_attention_fwd_plain(q, k, v, bias, mask,
                                                         HEADS, scale)
        want = jfa.flash_attention_cosine_flat(
            *map(_jax, (q, k, v)), _jax(scale), _jax(bias), jmask, HEADS,
            interpret=True)
    else:
        out, lse, out32 = tfa.window_attention_fwd_plain(q, k, v, bias, mask,
                                                         HEADS)
        want = jfa.flash_attention_bias_flat(*map(_jax, (q, k, v, bias)),
                                             jmask, HEADS, interpret=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert out32.dtype == lse.dtype == torch.float32
    assert lse.shape == (w0 * b, HEADS, n)
    assert torch.equal(out32.to(torch.bfloat16), out)
    assert torch.isfinite(out32).all() and torch.isfinite(lse).all()
    err = _rel_rms(out.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err <= RTOL, err


@pytest.mark.parametrize("n", [16, 49, 144])
@pytest.mark.parametrize("masked", [False, True])
def test_window_fwd_plain_is_the_plain_attention_in_fp32(n, masked):
    """fp32: K5's kernel-order plain forward against
    ``windowed_attention_flat`` and its log-sum-exp against
    ``torch.logsumexp`` of the fp32 scores; N over several 64-key tiles
    (144 = 2·64 + 16) as well."""
    w0, b = 3, 2
    q, k, v, bias, mask, _ = _inputs(w0, b, n, masked, torch.float32, n + masked)
    out, lse, out32 = tfa.window_attention_fwd_plain(q, k, v, bias, mask, HEADS)
    want = tattn.windowed_attention_flat(q, k, v, bias, mask, HEADS)
    assert out.dtype == torch.float32 and torch.equal(out, out32)
    assert float((out - want).abs().max()) <= ATOL_FP32
    qh, kh = (t.reshape(w0, b, n, HEADS, 32) for t in (q, k))
    s = torch.einsum("wbnhd,wbmhd->wbhnm", qh, kh) + bias
    if mask is not None:
        s = s + mask[:, None, None]
    want_lse = torch.logsumexp(s, -1).reshape(w0 * b, HEADS, n)
    assert float((lse - want_lse).abs().max()) <= ATOL_FP32


@pytest.mark.parametrize("n", [16, 144])
def test_cosine_window_fwd_plain_is_the_plain_attention_in_fp32(n):
    """fp32: K12's kernel-order plain forward against
    ``windowed_cosine_attention_flat(impl="xla")``, with a zero row of q and
    of k (the norm's clamp)."""
    w0, b = 3, 2
    q, k, v, bias, mask, scale = _inputs(w0, b, n, True, torch.float32, 7 + n)
    scale = scale / 10.0          # scores of up to ~26, as SwinV2-L's heads
    q[0, 1] = 0.0
    k[1, 2] = 0.0
    out, _, _ = tfa.window_attention_fwd_plain(q, k, v, bias, mask, HEADS, scale)
    want = tattn.windowed_cosine_attention_flat(q, k, v, scale, bias, mask,
                                                HEADS, impl="xla")
    assert torch.isfinite(out).all()
    assert float((out - want).abs().max()) <= ATOL_FP32
