"""The op-level attention of the port against the JAX package, on the CPU, on
the same seeded numpy inputs: K9's plain version (``ops/attention.py::
dot_product_attention_flat`` with ``impl="xla"``, which ``flash_attention_flat``
runs on a CPU tensor) and K12's (``windowed_cosine_attention_flat``, which
``flash_attention_cosine_flat`` runs), against JAX's XLA branch and its Pallas
kernels in interpret mode; the op-level entries' ``impl`` dispatch; and the two
findings about the reference that the port follows.

Tolerances, with their reasons (fp32 unless said):

- outputs 2e-5, gradients 2e-4 (rtol and atol): JAX's own bounds for the
  same comparisons (``tests/test_flash_attention.py``); the frameworks sum
  rows of N keys and d columns, and (dbias, dscale) all W0·B·N rows, in other
  orders;
- bf16: JAX's XLA branch rounds the softmax weights (and, for K12, q̂ and k̂)
  to bf16 at the same places as the port; both then differ by summation
  order, and the outputs below 2 by at most 2 bf16 ulps (atol 2·2^-7·2);
- the bf16 dscale reference (``windowed_cosine_dscale``) against JAX's
  kernel, which rounds dS at the same place: RMS error within 2^-10 of the
  RMS value, summation order and rare rounding straddles only;
- a zero row of q or k: the port's gradients are finite, and equal JAX's
  kernel's everywhere (its clamp branch), at 2e-4; dq and dk there are
  1e6 times the gradient of x̂, so they are compared times max(‖x‖, 1e-6),
  on x̂'s scale, where an fp32 rounding of x̂'s gradient is not magnified a
  millionfold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.ops import attention as tattn
from fedvit_torch.ops import flash_attention as tfa
from fedvit_tpu.ops import attention as jattn
from fedvit_tpu.ops import flash_attention as jfa

VAL = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=2e-4, rtol=2e-4)
BF16_ATOL = 2 * 2.0 ** -7 * 2


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _grad(fn, *arrays, dout):
    """fn's value and its gradients against each of the torch leaves."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grad(fn, *arrays, dout):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


# --- K9: attention on flat q, k and v ----------------------------------------

FLAT = [(2, 37, 2, 64), (2, 37, 2, 80), (3, 50, 3, 32)]   # (B, N, heads, d)


def _flat(b, n, e, seed):
    rng = np.random.default_rng(seed)
    return [_normal(rng, b, n, e) for _ in range(4)]      # q, k, v, dout


@pytest.mark.parametrize("b,n,heads,d", FLAT, ids=["d64", "d80", "d32"])
def test_flat_plain_matches_jax_xla_and_pallas(b, n, heads, d):
    q, k, v, dout = _flat(b, n, heads * d, seed=n + d)
    got, grads = _grad(lambda *t: tfa.flash_attention_flat(*t, heads), q, k, v,
                       dout=dout)
    for fn in (lambda *t: jattn.dot_product_attention_flat(*t, heads,
                                                           impl="xla"),
               lambda *t: jfa.flash_attention_flat(*t, heads, interpret=True)):
        want, want_grads = _jax_grad(fn, q, k, v, dout=dout)
        np.testing.assert_allclose(got, want, **VAL)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
            np.testing.assert_allclose(g, w, err_msg=name, **GRAD)


@pytest.mark.parametrize("impl", ["auto", "pallas", "mega", "xla"])
def test_flat_entry_takes_every_impl(impl):
    q, k, v, _ = _flat(2, 21, 96, seed=5)
    got = tattn.dot_product_attention_flat(*map(torch.from_numpy, (q, k, v)), 3,
                                           impl=impl)
    want = jattn.dot_product_attention_flat(*map(jnp.asarray, (q, k, v)), 3,
                                            impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_flat_bf16_follows_the_xla_branch_casts():
    q, k, v, _ = _flat(2, 37, 128, seed=11)
    want = jattn.dot_product_attention_flat(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), 2, impl="xla")
    got = tfa.flash_attention_flat(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL)


def test_flat_heads_are_head_major():
    """Head h is columns [h·d, (h+1)·d) of q, k, v and the output, as the JAX
    kernel's layout: each head alone gives its slice."""
    b, n, heads, d = 2, 32, 2, 64
    q, k, v, _ = (torch.from_numpy(t) for t in _flat(b, n, heads * d, seed=53))
    out = tfa.flash_attention_flat(q, k, v, heads)
    want = jfa.flash_attention_flat(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                    heads, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **VAL)
    for h in range(heads):
        cols = slice(h * d, (h + 1) * d)
        one = tfa.flash_attention_flat(q[..., cols], k[..., cols], v[..., cols], 1)
        np.testing.assert_allclose(out[..., cols].numpy(), one.numpy(), **VAL)


def test_flash_attention_on_bnhd_matches_jax():
    b, n, heads, d = 2, 37, 3, 32
    rng = np.random.default_rng(17)
    q, k, v, dout = (_normal(rng, b, n, heads, d) for _ in range(4))
    got, grads = _grad(tfa.flash_attention, q, k, v, dout=dout)
    want, want_grads = _jax_grad(
        lambda *t: jfa.flash_attention(*t, interpret=True), q, k, v, dout=dout)
    assert got.shape == (b, n, heads, d)
    np.testing.assert_allclose(got, want, **VAL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, **GRAD)


@pytest.mark.parametrize("windows", [None, 1, 3], ids=["hnn", "w0=1", "w0=3"])
@pytest.mark.parametrize("scale", [None, 0.5])
def test_dot_product_attention_with_a_bias_matches_jax(windows, scale):
    """A (H, N, N) bias broadcast over the batch, or (W0, H, N, N) with batch
    element b taking window b % W0 (window-minor); the bias and the scale
    are honoured on every impl, as JAX's plain branch does."""
    b, n, heads, d = 6, 19, 2, 16
    rng = np.random.default_rng(23)
    q, k, v, dout = (_normal(rng, b, n, heads, d) for _ in range(4))
    shape = (heads, n, n) if windows is None else (windows, heads, n, n)
    bias = _normal(rng, *shape, scale=2.0)
    for impl in ("auto", "pallas", "xla"):
        got, grads = _grad(
            lambda *t: tattn.dot_product_attention(*t, impl=impl, scale=scale),
            q, k, v, bias, dout=dout)
        want, want_grads = _jax_grad(
            lambda *t: jattn.dot_product_attention(*t, impl=impl, scale=scale),
            q, k, v, bias, dout=dout)
        np.testing.assert_allclose(got, want, **VAL)
        for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, want_grads):
            np.testing.assert_allclose(g, w, err_msg=name, **GRAD)


def test_dot_product_attention_bias_is_window_minor():
    """Batch element b of a (W0, H, N, N) bias takes window b % W0."""
    b, n, heads, d, w0 = 4, 9, 2, 8, 2
    rng = np.random.default_rng(29)
    q, k, v = (torch.from_numpy(_normal(rng, b, n, heads, d)) for _ in range(3))
    bias = torch.from_numpy(_normal(rng, w0, heads, n, n, scale=3.0))
    got = tattn.dot_product_attention(q, k, v, bias)
    for i in range(b):
        one = tattn.xla_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                  bias=bias[i % w0])
        np.testing.assert_allclose(got[i:i + 1].numpy(), one.numpy(), **VAL)


def test_dot_product_attention_kernel_path_ignores_scale():
    """JAX's ``dot_product_attention`` with no bias and ``impl="pallas"``
    calls ``flash_attention(q, k, v)`` and drops ``scale``; the port gives the
    same result, and on ``impl="xla"`` (and JAX's ``auto`` off a TPU) honours
    it."""
    b, n, heads, d = 2, 21, 2, 32
    rng = np.random.default_rng(31)
    q, k, v = (_normal(rng, b, n, heads, d) for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for impl in ("pallas", "mega", "auto", "xla"):
        got = tattn.dot_product_attention(tq, tk, tv, impl=impl, scale=0.5)
        want = jattn.dot_product_attention(jq, jk, jv, impl=impl, scale=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL,
                                   err_msg=impl)
    unscaled = tattn.dot_product_attention(tq, tk, tv, impl="xla")
    kernel = tattn.dot_product_attention(tq, tk, tv, impl="pallas", scale=0.5)
    halved = tattn.dot_product_attention(tq, tk, tv, impl="xla", scale=0.5)
    np.testing.assert_allclose(kernel.numpy(), unscaled.numpy(), **VAL)
    assert not np.allclose(kernel.numpy(), halved.numpy(), **VAL)


def test_an_unknown_impl_is_refused():
    q = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="impl"):
        tattn.dot_product_attention_flat(q, q, q, 1, impl="cudnn")
    with pytest.raises(ValueError, match="impl"):
        tattn.dot_product_attention(q[:, :, None], q[:, :, None],
                                    q[:, :, None], impl="triton")


def test_plain_attention_from_qkv_never_reaches_k9(monkeypatch):
    """K10's plain version (and through it K1-K3's and K11's) runs the plain
    body on every device: on the card it must never launch K9, or the kernels
    would be held against a kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain path reached flash_attention_flat")

    monkeypatch.setattr(tfa, "flash_attention_flat", refuse)
    rng = np.random.default_rng(37)
    qkv = torch.from_numpy(_normal(rng, 2, 9, 3 * 128))
    bias = torch.from_numpy(_normal(rng, 3 * 128))
    x, w = torch.from_numpy(_normal(rng, 2, 9, 64)), torch.from_numpy(
        _normal(rng, 64, 3 * 128))
    tattn.attention_from_qkv(qkv, 2)
    tattn.attention_from_qkvb(qkv, bias, 2)
    tattn.attention_from_x(x, w, bias, 2)
    tfa.flash_attention_qkv(qkv, 2)
    with pytest.raises(AssertionError, match="reached"):   # the entry does
        tattn.dot_product_attention_flat(qkv[..., :128], qkv[..., :128],
                                         qkv[..., :128], 2, impl="pallas")


# --- K12: the scaled-cosine windowed attention -------------------------------

def _cosine(w0, b, n, heads, seed, masked=True, d=32):
    """Raw q, k, v, dout of unit entries; scales drawn in [ln 10, ln 100] and
    exponentiated, as SwinV2's logit_scale; a bias of the model's 16·sigmoid
    size; a mask of 0 and -100 (or None)."""
    rng = np.random.default_rng(seed)
    rows, e = w0 * b, heads * d
    q, k, v, dout = (_normal(rng, rows, n, e) for _ in range(4))
    scale = np.exp(rng.uniform(np.log(10), np.log(100), size=heads)).astype(
        np.float32)
    bias = (16 / (1 + np.exp(-2 * rng.normal(size=(heads, n, n))))).astype(
        np.float32)
    mask = (np.where(rng.random((w0, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
            if masked else None)
    return q, k, v, scale, bias, mask, dout


def _jax_cosine(mask, heads, impl):
    m = None if mask is None else jnp.asarray(mask)
    if impl == "interpret":   # the kernel takes no None: zeros (1, N, N)
        return lambda q, *t: jfa.flash_attention_cosine_flat(
            q, *t, jnp.zeros((1,) + q.shape[1:2] * 2) if m is None else m,
            heads, interpret=True)
    return lambda *t: jattn.windowed_cosine_attention_flat(*t, m, heads,
                                                           impl="xla")


@pytest.mark.parametrize("w0,b,n,heads,masked", [
    (2, 3, 49, 2, True), (1, 4, 36, 3, False), (4, 2, 16, 2, True)],
    ids=["2x3x49-mask", "1x4x36", "4x2x16-mask"])
def test_cosine_plain_matches_jax_xla_and_pallas(w0, b, n, heads, masked):
    """The forward and all five cotangents: dq, dk (through the norm), dv,
    dscale (summed over all W0·B·N rows) and dbias."""
    q, k, v, scale, bias, mask, dout = _cosine(w0, b, n, heads, seed=n + heads,
                                               masked=masked)
    tmask = None if mask is None else torch.from_numpy(mask)
    got, grads = _grad(
        lambda *t: tfa.flash_attention_cosine_flat(*t, tmask, heads),
        q, k, v, scale, bias, dout=dout)
    for impl in ("xla", "interpret"):
        want, want_grads = _jax_grad(_jax_cosine(mask, heads, impl), q, k, v,
                                     scale, bias, dout=dout)
        np.testing.assert_allclose(got, want, err_msg=impl, **VAL)
        for name, g, w in zip(("dq", "dk", "dv", "dscale", "dbias"), grads,
                              want_grads):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, err_msg=f"{impl} {name}", **GRAD)


@pytest.mark.parametrize("impl", ["auto", "pallas", "mega", "xla"])
def test_cosine_entry_takes_every_impl(impl):
    q, k, v, scale, bias, mask, _ = _cosine(2, 2, 16, 2, seed=3)
    got = tattn.windowed_cosine_attention_flat(
        *map(torch.from_numpy, (q, k, v, scale, bias, mask)), 2, impl=impl)
    want = jattn.windowed_cosine_attention_flat(
        *map(jnp.asarray, (q, k, v, scale, bias, mask)), 2, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_cosine_bf16_follows_the_xla_branch_casts():
    q, k, v, scale, bias, mask, _ = _cosine(2, 2, 36, 2, seed=7)
    want = jattn.windowed_cosine_attention_flat(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(scale),
        jnp.asarray(bias), jnp.asarray(mask), 2, impl="xla")
    got = tfa.flash_attention_cosine_flat(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
        *map(torch.from_numpy, (scale, bias, mask)), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("dtype,masked", [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)],
    ids=["fp32-mask", "bf16-mask", "bf16"])
def test_cosine_dscale_reference_matches_jax_kernel(dtype, masked):
    """``windowed_cosine_dscale``, the reference K12's dscale is held to on
    the card, is the TPU kernel's dscale: dS rounded to q's dtype before
    dq̂n. In fp32 it is also autograd's of the plain version. In bf16 the two
    differ only by summation order and the rare dS element whose fp32 values
    straddle a bf16 rounding boundary: RMS error within 2^-10 of the RMS
    value."""
    q, k, v, scale, bias, mask, dout = _cosine(4, 3, 49, 2, seed=23,
                                               masked=masked)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(_jax_cosine(mask, 2, "interpret"),
                     *(jnp.asarray(t, jdt) for t in (q, k, v)),
                     jnp.asarray(scale), jnp.asarray(bias))
    want = np.asarray(vjp(jnp.asarray(dout, jdt))[3])
    tq, tk, tv, tdout = (torch.from_numpy(t).to(dtype) for t in (q, k, v, dout))
    got = tattn.windowed_cosine_dscale(
        tq, tk, tv, torch.from_numpy(scale), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), tdout, 2)
    assert got.shape == (2,) and got.dtype == torch.float32
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **GRAD)
        _, grads = _grad(lambda *t: tfa.flash_attention_cosine_flat(
            *t, torch.from_numpy(mask), 2), q, k, v, scale, bias, dout=dout)
        np.testing.assert_allclose(got.numpy(), grads[3], **GRAD)
    else:
        err = np.sqrt(np.mean((got.numpy() - want) ** 2) / np.mean(want ** 2))
        assert err <= 2.0 ** -10, err


def _times_norm(g, x, heads):
    """g times max(‖x‖, 1e-6) of each row's head slice of x."""
    rows, n, e = x.shape
    split = (rows, n, heads, e // heads)
    norm = np.linalg.norm(x.reshape(split), axis=-1, keepdims=True)
    return (g.reshape(split) * np.maximum(norm, 1e-6)).reshape(x.shape)


def test_cosine_zero_and_tiny_rows_have_finite_gradients_equal_to_jax_kernel():
    """Rows of q and k of norm 0 and below 1e-6 take the clamp: x̂ = x·1e6
    with the constant-r gradient dx = 1e6·dx̂ (JAX's kernel). JAX's XLA branch
    gives NaN on the zero rows; the port's plain version gives the kernel's
    finite values everywhere."""
    q, k, v, scale, bias, mask, dout = _cosine(1, 2, 16, 2, seed=47)
    q[:, :3] = 0.0
    q[:, 3] *= 1e-8 / np.linalg.norm(q[:, 3], axis=-1, keepdims=True)
    k[:, 2:5] = 0.0
    k[:, 6, :32] = 1e-7                     # norm 1e-7·√32 ≈ 5.7e-7 < 1e-6
    got, grads = _grad(
        lambda *t: tfa.flash_attention_cosine_flat(*t, torch.from_numpy(mask), 2),
        q, k, v, scale, bias, dout=dout)
    want, want_grads = _jax_grad(_jax_cosine(mask, 2, "interpret"), q, k, v,
                                 scale, bias, dout=dout)
    assert np.isfinite(got).all() and all(np.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(got, want, **VAL)
    # dq and dk are r·(gradient of x̂) with r = 1e6 on a clamped row: they are
    # held on the scale of x̂'s gradient, times max(‖x‖, 1e-6) row by row
    for name, g, w, x in zip(("dq", "dk"), grads, want_grads, (q, k)):
        np.testing.assert_allclose(_times_norm(g, x, 2), _times_norm(w, x, 2),
                                   err_msg=name, **GRAD)
    for name, g, w in zip(("dv", "dscale", "dbias"), grads[2:], want_grads[2:]):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD)
    # the clamp branch, read off directly: the zero rows' dq is 1e6·scale·dq̂n,
    # not 0, and JAX's XLA branch is not finite there
    assert np.abs(grads[0][:, :3]).max() > 0
    _, xla_grads = _jax_grad(_jax_cosine(mask, 2, "xla"), q, k, v, scale, bias,
                             dout=dout)
    assert not np.isfinite(xla_grads[0]).all()


def test_cosine_rows_are_window_major():
    """Rows [w·B, (w+1)·B) belong to window w: each window's rows alone, with
    its own mask, give their rows of the output."""
    w0, b, n, heads = 3, 2, 16, 2
    q, k, v, scale, bias, mask, _ = map(torch.from_numpy,
                                        _cosine(w0, b, n, heads, seed=13))
    got = tfa.flash_attention_cosine_flat(q, k, v, scale, bias, mask, heads)
    for w in range(w0):
        rows = slice(w * b, (w + 1) * b)
        one = tfa.flash_attention_cosine_flat(q[rows], k[rows], v[rows], scale,
                                              bias, mask[w:w + 1], heads)
        np.testing.assert_allclose(got[rows].numpy(), one.numpy(), **VAL)


def test_cosine_refuses_a_mask_that_needs_a_gradient():
    q, k, v, scale, bias, mask, _ = map(torch.from_numpy,
                                        _cosine(1, 2, 16, 2, seed=19))
    with pytest.raises(ValueError, match="constant"):
        tfa.flash_attention_cosine_flat(q, k, v, scale, bias,
                                        mask.requires_grad_(), 2)


def test_cpu_paths_launch_no_kernel():
    """On CPU tensors, forward and backward, the entries run the plain
    versions: no counter of K9 or K12 moves."""
    counters = (tfa.flash_attention_flat, tfa.flat_attention_lse_cuda,
                tfa.flat_attention_bwd_cuda, tfa.flash_attention_cosine_flat,
                tfa.cosine_window_attention_lse_cuda,
                tfa.cosine_window_attention_bwd_cuda)
    before = [f.launches for f in counters]
    q, k, v, scale, bias, mask, dout = _cosine(2, 2, 16, 2, seed=41, d=64)
    _grad(lambda *t: tattn.dot_product_attention_flat(*t, 2), q, k, v, dout=dout)
    _grad(lambda *t: tattn.windowed_cosine_attention_flat(
        *t, torch.from_numpy(mask), 2, impl="pallas"), q, k, v, scale, bias,
        dout=dout)
    assert [f.launches for f in counters] == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, scale, bias, mask, dout = map(torch.from_numpy,
                                           _cosine(1, 2, 16, 1, seed=43, d=64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flat_attention_cuda(q, k, v, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flat_attention_lse_cuda(q, k, v, 1)
    q, k, v, scale, bias, mask, dout = map(torch.from_numpy,
                                           _cosine(1, 2, 16, 2, seed=43))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.cosine_window_attention_cuda(q, k, v, scale, bias, mask, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.cosine_window_attention_lse_cuda(q, k, v, scale, bias, mask, 2)
