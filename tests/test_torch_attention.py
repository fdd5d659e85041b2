"""The port's attention against the JAX package's, on the CPU.

``fedvit_torch.ops.flash_attention.flash_attention_qkvb`` on CPU tensors runs
its plain version, which the CUDA kernel is held to on the card. Here it is
held to ``fedvit_tpu``'s XLA branch (``attention_from_qkvb(impl="xla")``) and
to the Pallas kernel in interpret mode, on the same seeded numpy inputs, at
an odd N so that a ragged tile would show. Tolerance: atol 1e-5 — fp32
throughout, the frameworks sum the 37-long rows in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.ops import attention as tattn
from fedvit_torch.ops.flash_attention import flash_attention_qkvb
from fedvit_tpu.ops import attention as jattn
from fedvit_tpu.ops.flash_attention import flash_attention_qkvb as jax_qkvb

ATOL = 1e-5


def _inputs(b, n, e, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3 * e)).astype(np.float32)
    bias = (0.5 * rng.normal(size=(3 * e,))).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("b,n,heads,d", [(2, 37, 2, 64), (1, 50, 3, 32)],
                         ids=["2x37x2x64", "1x50x3x32"])
def test_plain_qkvb_matches_jax_xla_branch(b, n, heads, d):
    qkv, bias = _inputs(b, n, heads * d, seed=b * n)
    want = jattn.attention_from_qkvb(jnp.asarray(qkv), jnp.asarray(bias),
                                     heads, impl="xla")
    got = flash_attention_qkvb(torch.from_numpy(qkv), torch.from_numpy(bias),
                               heads)
    assert got.shape == (b, n, heads * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_qkvb_matches_pallas_kernel_in_interpret_mode():
    qkv, bias = _inputs(2, 37, 2 * 64, seed=7)
    want = jax_qkvb(jnp.asarray(qkv), jnp.asarray(bias), 2, interpret=True)
    got = flash_attention_qkvb(torch.from_numpy(qkv), torch.from_numpy(bias), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_follows_the_xla_branch_casts():
    """In bf16 the bias is cast to bf16 before the add and the softmax
    weights are rounded to bf16 before P·V, as in the XLA branch; the two
    then differ only by summation order (atol: 2 bf16 ulps at |x| ≤ 2)."""
    qkv, bias = _inputs(2, 37, 2 * 64, seed=11)
    want = jattn.attention_from_qkvb(jnp.asarray(qkv, jnp.bfloat16),
                                     jnp.asarray(bias), 2, impl="xla")
    got = flash_attention_qkvb(torch.from_numpy(qkv).bfloat16(),
                               torch.from_numpy(bias), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2 * 2.0 ** -7 * 2)


def test_xla_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 21, 3, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.xla_attention(*(jnp.asarray(t) for t in (q, k, v)))
    got = tattn.xla_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_counts_only_kernel_launches():
    qkv, bias = _inputs(1, 5, 64, seed=0)
    before = flash_attention_qkvb.launches
    flash_attention_qkvb(torch.from_numpy(qkv), torch.from_numpy(bias), 1)
    assert flash_attention_qkvb.launches == before   # CPU: plain version


def test_kernel_wrapper_refuses_cpu_tensors():
    from fedvit_torch.ops.flash_attention import qkvb_attention_cuda
    qkv, bias = _inputs(1, 5, 64, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        qkvb_attention_cuda(torch.from_numpy(qkv), torch.from_numpy(bias), 1)


# --- the backward ------------------------------------------------------------
# The port's CPU path is the plain version under torch autograd; K3 is held
# to it on the card. Here its gradients (dqkv, dbias) are held to jax.vjp of
# the Pallas kernel in interpret mode — every TPU backward variant: the plain
# recompute kernel (picked at these N), the stats pair and the stats+delta
# pair, chosen by the JAX package's own switches — and of the XLA branch.
# Tolerance: atol 1e-5 for dqkv (fp32, sums over N keys in another order),
# 1e-4 for dbias (fp32 sums over B·N rows of dqkv).

_VARIANTS = {"plain": {}, "stats": {"FEDVIT_QKVB_STATS": "1"},
             "stats_delta": {"FEDVIT_QKVB_STATS": "1", "FEDVIT_QKVB_DELTA": "1"}}


def _port_grads(qkv, bias, heads, dout):
    qt = torch.from_numpy(qkv).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    out = flash_attention_qkvb(qt, bt, heads)
    out.backward(torch.from_numpy(dout))
    return qt.grad.numpy(), bt.grad.numpy()


def _jax_vjp(fn, qkv, bias, dout):
    _, vjp = jax.vjp(fn, jnp.asarray(qkv), jnp.asarray(bias))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("variant", list(_VARIANTS))
@pytest.mark.parametrize("n", [37, 197])
def test_backward_matches_pallas_kernels_in_interpret_mode(monkeypatch, n,
                                                           variant):
    for k, v in _VARIANTS[variant].items():
        monkeypatch.setenv(k, v)
    heads = 2
    qkv, bias = _inputs(2, n, heads * 64, seed=n + 1)
    dout = np.random.default_rng(n).normal(size=(2, n, heads * 64)).astype(
        np.float32)
    want = _jax_vjp(lambda q, b: jax_qkvb(q, b, heads, interpret=True),
                    qkv, bias, dout)
    got = _port_grads(qkv, bias, heads, dout)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)


@pytest.mark.parametrize("n", [37, 197])
def test_backward_matches_jax_xla_branch(n):
    heads = 3
    qkv, bias = _inputs(2, n, heads * 64, seed=n + 2)
    dout = np.random.default_rng(n + 1).normal(size=(2, n, heads * 64)).astype(
        np.float32)
    want = _jax_vjp(lambda q, b: jattn.attention_from_qkvb(q, b, heads,
                                                           impl="xla"),
                    qkv, bias, dout)
    got = _port_grads(qkv, bias, heads, dout)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)


def test_cpu_grad_path_launches_no_kernel():
    from fedvit_torch.ops import flash_attention as fa
    qkv, bias = _inputs(1, 5, 64, seed=1)
    counts = (fa.flash_attention_qkvb.launches,
              fa.qkvb_attention_lse_cuda.launches,
              fa.qkvb_attention_bwd_cuda.launches)
    _port_grads(qkv, bias, 1, np.ones((1, 5, 64), np.float32))
    assert (fa.flash_attention_qkvb.launches, fa.qkvb_attention_lse_cuda.launches,
            fa.qkvb_attention_bwd_cuda.launches) == counts


def test_kernel_wrappers_of_the_backward_refuse_cpu_tensors():
    from fedvit_torch.ops import flash_attention as fa
    qkv, bias = (torch.from_numpy(a) for a in _inputs(1, 5, 64, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        fa.qkvb_attention_lse_cuda(qkv, bias, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fa.qkvb_attention_bwd_cuda(qkv, bias, qkv[..., :64], qkv[..., :64],
                                   torch.zeros(1, 1, 5), 1)


# --- windowed attention with a bias and a mask (SwinV2) ----------------------
# ``flash_attention_bias_flat`` on CPU tensors runs the plain
# ``windowed_attention_flat``, which K5 is held to on the card. Here it is held
# to the JAX package's Pallas kernel in interpret mode and to its XLA branch,
# over the shapes of ``tests/test_kernel_shapes.py::WFLAT_SHAPES`` (odd N, odd
# window counts, one row per window, d = 32) plus a case with W0 > 1 and B > 1,
# with a mask that differs per window, and with ``mask=None``. Tolerance: atol
# 2e-5 — fp32 throughout, rows of up to 144 scores of size ~6 summed in other
# orders.

WFLAT_SHAPES = [(1, 2, 49, 2, 8), (4, 1, 16, 3, 8), (9, 2, 16, 1, 8),
                (1, 3, 64, 6, 32), (4, 2, 144, 2, 16), (4, 3, 49, 2, 32)]
WFLAT_ATOL = 2e-5


def _window_inputs(w0, b, n, h, d, seed, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(w0 * b, n, h * d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(h, n, n)).astype(np.float32)
    mask = np.where(rng.normal(size=(w0, n, n)) > 1.0, -100.0, 0.0).astype(
        np.float32) if masked else None
    return q, k, v, bias, mask


def _port_window(q, k, v, bias, mask, h):
    from fedvit_torch.ops.flash_attention import flash_attention_bias_flat
    return flash_attention_bias_flat(
        *(torch.from_numpy(t) for t in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), h).numpy()


@pytest.mark.parametrize("w0,b,n,h,d", WFLAT_SHAPES)
def test_plain_windowed_matches_pallas_kernel_in_interpret_mode(w0, b, n, h, d):
    from fedvit_tpu.ops.flash_attention import flash_attention_bias_flat
    q, k, v, bias, mask = _window_inputs(w0, b, n, h, d, seed=n + w0)
    want = flash_attention_bias_flat(*(jnp.asarray(t) for t in
                                       (q, k, v, bias, mask)), h, interpret=True)
    got = _port_window(q, k, v, bias, mask, h)
    assert got.shape == (w0 * b, n, h * d)
    np.testing.assert_allclose(got, np.asarray(want), atol=WFLAT_ATOL)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "mask_none"])
@pytest.mark.parametrize("w0,b,n,h,d", WFLAT_SHAPES)
def test_plain_windowed_matches_jax_xla_branch(w0, b, n, h, d, masked):
    if not masked:
        w0, b = 1, w0 * b           # no mask: one group of all rows
    q, k, v, bias, mask = _window_inputs(w0, b, n, h, d, seed=n + b, masked=masked)
    want = jattn.windowed_attention_flat(
        *(jnp.asarray(t) for t in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), h, impl="xla")
    got = _port_window(q, k, v, bias, mask, h)
    np.testing.assert_allclose(got, np.asarray(want), atol=WFLAT_ATOL)


def test_windowed_rows_are_window_major():
    """Row r uses mask[r // B], not mask[r % W0]: with W0 = 3 and B = 2 the
    op equals three separate calls on each window's two rows."""
    w0, b, n, h, d = 3, 2, 16, 2, 32
    q, k, v, bias, mask = _window_inputs(w0, b, n, h, d, seed=5)
    got = _port_window(q, k, v, bias, mask, h)
    for w in range(w0):
        rows = slice(w * b, (w + 1) * b)
        one = _port_window(q[rows], k[rows], v[rows], bias, mask[w:w + 1], h)
        np.testing.assert_allclose(got[rows], one, atol=1e-6)


def test_windowed_bf16_follows_the_xla_branch_casts():
    """bf16 operands: fp32 scores, bias and mask added in fp32, softmax weights
    rounded to bf16 before P·V, as in the XLA branch (atol: 2 bf16 ulps at
    |x| ≤ 2)."""
    q, k, v, bias, mask = _window_inputs(2, 2, 49, 2, 32, seed=9)
    want = jattn.windowed_attention_flat(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(bias),
        jnp.asarray(mask), 2, impl="xla")
    from fedvit_torch.ops.flash_attention import flash_attention_bias_flat
    got = flash_attention_bias_flat(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(mask), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2 * 2.0 ** -7 * 2)


def test_window_wrapper_counts_only_kernel_launches_and_refuses_cpu_tensors():
    from fedvit_torch.ops import flash_attention as fa
    q, k, v, bias, mask = (torch.from_numpy(t) for t in
                           _window_inputs(2, 2, 16, 1, 32, seed=0))
    counts = (fa.flash_attention_bias_flat.launches,
              fa.window_attention_lse_cuda.launches)
    fa.flash_attention_bias_flat(q, k, v, bias, mask, 1)     # CPU: plain version
    assert (fa.flash_attention_bias_flat.launches,
            fa.window_attention_lse_cuda.launches) == counts
    with pytest.raises(ValueError, match="CUDA"):
        fa.window_attention_cuda(q, k, v, bias, mask, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fa.window_attention_lse_cuda(q, k, v, bias, mask, 1)


# --- the windowed backward ---------------------------------------------------
# The port's CPU path is the plain version under torch autograd; K6 is held to
# it on the card. Here its gradients (dq, dk, dv, dbias; the mask gets none)
# are held to jax.vjp of the Pallas kernel in interpret mode in every TPU
# backward variant — the plain recompute kernel, the saved-statistics kernel
# (the default) and the statistics + delta kernel, chosen by the JAX package's
# own switches — and of the XLA branch, at the shapes with several windows and
# several rows a window, with the mask and with ``mask=None``. Tolerance: atol
# 2e-5 plus rtol 1e-5 for dq, dk, dv (fp32, sums over up to 144 keys in another
# order; gradients reach several units, where an fp32 ulp is 5e-7), atol 1e-4
# for dbias (fp32 sums of dS over up to 12 rows, values of size ~1).

WFLAT_GRAD_SHAPES = [s for s in WFLAT_SHAPES if s[0] > 1 and s[1] > 1]
_WINDOW_VARIANTS = {"plain": {"FEDVIT_WATTN_STATS": "0"}, "stats": {},
                    "stats_delta": {"FEDVIT_WATTN_DELTA": "1"}}


def _port_window_grads(q, k, v, bias, mask, h, dout):
    from fedvit_torch.ops.flash_attention import flash_attention_bias_flat
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    out = flash_attention_bias_flat(
        *leaves, None if mask is None else torch.from_numpy(mask), h)
    out.backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in leaves]


def _jax_window_vjp(fn, q, k, v, bias, dout):
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v, bias)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _assert_window_grads(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=WFLAT_ATOL, rtol=1e-5)
    np.testing.assert_allclose(got[3], want[3], atol=1e-4)


def _window_grad_case(w0, b, n, h, d, masked, seed):
    if not masked:
        w0, b = 1, w0 * b           # no mask: one group of all rows
    q, k, v, bias, mask = _window_inputs(w0, b, n, h, d, seed, masked=masked)
    dout = np.random.default_rng(seed + 1).normal(
        size=(w0 * b, n, h * d)).astype(np.float32)
    return q, k, v, bias, mask, dout


@pytest.mark.parametrize("variant", list(_WINDOW_VARIANTS))
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "mask_none"])
@pytest.mark.parametrize("w0,b,n,h,d", WFLAT_GRAD_SHAPES)
def test_windowed_backward_matches_pallas_kernels_in_interpret_mode(
        monkeypatch, w0, b, n, h, d, masked, variant):
    from fedvit_tpu.ops.flash_attention import flash_attention_bias_flat
    for key, val in _WINDOW_VARIANTS[variant].items():
        monkeypatch.setenv(key, val)
    q, k, v, bias, mask, dout = _window_grad_case(w0, b, n, h, d, masked,
                                                  seed=n + w0 + 3)
    jmask = jnp.zeros((1, n, n), jnp.float32) if mask is None else \
        jnp.asarray(mask)
    want = _jax_window_vjp(
        lambda q_, k_, v_, b_: flash_attention_bias_flat(
            q_, k_, v_, b_, jmask, h, interpret=True), q, k, v, bias, dout)
    _assert_window_grads(_port_window_grads(q, k, v, bias, mask, h, dout), want)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "mask_none"])
@pytest.mark.parametrize("w0,b,n,h,d", WFLAT_GRAD_SHAPES)
def test_windowed_backward_matches_jax_xla_branch(w0, b, n, h, d, masked):
    q, k, v, bias, mask, dout = _window_grad_case(w0, b, n, h, d, masked,
                                                  seed=n + b + 5)
    jmask = None if mask is None else jnp.asarray(mask)
    want = _jax_window_vjp(
        lambda q_, k_, v_, b_: jattn.windowed_attention_flat(
            q_, k_, v_, b_, jmask, h, impl="xla"), q, k, v, bias, dout)
    _assert_window_grads(_port_window_grads(q, k, v, bias, mask, h, dout), want)


def test_windowed_mask_that_needs_a_gradient_raises():
    """The mask is a constant of the model: its cotangent is structurally zero
    in the JAX package, so the port refuses a mask that asks for one instead of
    handing it zeros."""
    from fedvit_torch.ops.flash_attention import flash_attention_bias_flat
    q, k, v, bias, mask = (torch.from_numpy(t) for t in
                           _window_inputs(2, 2, 16, 1, 32, seed=1))
    with pytest.raises(ValueError, match="mask"):
        flash_attention_bias_flat(q, k, v, bias, mask.requires_grad_(), 1)


def test_windowed_cpu_grad_path_launches_no_kernel():
    from fedvit_torch.ops import flash_attention as fa
    q, k, v, bias, mask = _window_inputs(2, 2, 16, 1, 32, seed=2)
    counted = (fa.flash_attention_bias_flat, fa.window_attention_lse_cuda,
               fa.window_attention_bwd_cuda)
    counts = [fn.launches for fn in counted]
    grads = _port_window_grads(q, k, v, bias, mask, 1,
                               np.ones((4, 16, 32), np.float32))
    assert [fn.launches for fn in counted] == counts
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in grads)


def test_kernel_wrapper_of_the_windowed_backward_refuses_cpu_tensors():
    from fedvit_torch.ops import flash_attention as fa
    q, k, v, bias, mask = (torch.from_numpy(t) for t in
                           _window_inputs(2, 2, 16, 1, 32, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        fa.window_attention_bwd_cuda(q, k, v, bias, mask, q, q,
                                     torch.zeros(4, 1, 16), 1)
