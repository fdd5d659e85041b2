"""The port's LayerNorm against the JAX package's, on the CPU.

``layer_norm_fwd`` leaves every CPU tensor on ``layer_norm_plain`` (the
kernel runs only on CUDA tensors), bit for bit, in each of the four
(input, output) dtype pairs the port uses, and that plain forward is held to
JAX's ``layer_norm`` forward: fp32 output atol 1e-5 (row means in another
order), bf16 output one bf16 ulp of the largest value (both round once).

``fedvit_torch.ops.layer_norm.ln_bwd_plain`` is the version K4 is held to on
the card, and ``LayerNormFn`` (the forward under grad) takes it on CPU
tensors. Both are held here to ``jax.vjp`` of ``fedvit_tpu``'s
``layer_norm(impl="pallas", interpret=True)`` — the Pallas kernel
``_ln_bwd_kernel`` run as its own tests run it — on the same seeded numpy
inputs, flat (rows, D) and (B, N, D) with a ragged N.

Tolerances, fp32 throughout: dx atol 1e-5 (row means in another order; the
kernel's variance is E[x²] − μ², the plain version's the centred one);
dgamma and dbeta atol 1e-4 (column sums over up to 74 rows of terms of size
~2, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.ops import layer_norm as tln
from fedvit_tpu.ops.layer_norm import layer_norm as jax_layer_norm

EPS = 1e-6


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (2.0 * rng.normal(size=shape) + 0.5).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=(d,))).astype(np.float32)
    b = (0.2 * rng.normal(size=(d,))).astype(np.float32)
    return x, dy, w, b


def _jax_grads(x, dy, w, b):
    def f(x, w, b):
        return jax_layer_norm(x, w, b, eps=EPS, impl="pallas", interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _check(got, want):
    dx, dg, db = (g.detach().numpy() if isinstance(g, torch.Tensor) else g
                  for g in got)
    np.testing.assert_allclose(dx, want[0], atol=1e-5)
    np.testing.assert_allclose(dg, want[1], atol=1e-4)
    np.testing.assert_allclose(db, want[2], atol=1e-4)


SHAPES = [(64, 128), (2, 37, 64), (1, 197, 192)]
IDS = ["rows64xD128", "2x37x64", "1x197x192"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_backward_matches_jax_pallas_kernel(shape):
    x, dy, w, b = _inputs(shape, seed=shape[-1])
    got = tln.ln_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(dy), EPS)
    assert got[0].shape == shape and got[1].dtype == torch.float32
    _check(got, _jax_grads(x, dy, w, b))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_function_grads_match_jax_pallas_kernel(shape):
    x, dy, w, b = _inputs(shape, seed=shape[-1] + 1)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = tln.layer_norm(xt, wt, bt, EPS)
    assert y.grad_fn is not None and "LayerNormFn" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(dy))
    _check((xt.grad, wt.grad, bt.grad), _jax_grads(x, dy, w, b))


def test_function_forward_is_the_plain_forward():
    x, _, w, b = _inputs((3, 37, 64), seed=3)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    under_grad = tln.layer_norm(*args, EPS, torch.bfloat16)
    with torch.no_grad():
        plain = tln.layer_norm(*args, EPS, torch.bfloat16)
    assert under_grad.dtype == torch.bfloat16
    assert torch.equal(under_grad, plain)
    assert torch.equal(plain, tln.layer_norm_plain(*args, EPS, torch.bfloat16))


def test_bf16_backward_returns_dx_in_x_dtype_and_fp32_sums():
    x, dy, w, b = _inputs((2, 37, 64), seed=4)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    tln.layer_norm(xt, wt, bt, EPS).backward(torch.from_numpy(dy).bfloat16())
    assert xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == bt.grad.dtype == torch.float32
    want = _jax_grads(np.asarray(xt.detach().float()),
                      np.asarray(torch.from_numpy(dy).bfloat16().float()), w, b)
    # dx rounded to bf16 (relative 2^-8); the sums see bf16-rounded inputs
    np.testing.assert_allclose(xt.grad.float().numpy(), want[0],
                               atol=2.0 ** -7 * np.abs(want[0]).max())
    np.testing.assert_allclose(wt.grad.numpy(), want[1], atol=1e-4)


def test_wrapper_counts_only_kernel_launches():
    x, dy, w, _ = _inputs((4, 64), seed=5)
    before = tln.layer_norm_bwd_cuda.launches
    tln.layer_norm_bwd(*(torch.from_numpy(a) for a in (x, w, dy)))
    assert tln.layer_norm_bwd_cuda.launches == before   # CPU: plain version


def test_kernel_wrapper_refuses_cpu_tensors():
    x, dy, w, _ = _inputs((4, 64), seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_bwd_cuda(*(torch.from_numpy(a) for a in (x, w, dy)))


FWD_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
FWD_IDS = ["f32-f32", "bf16-bf16", "f32-bf16", "bf16-f32"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtypes", FWD_DTYPES, ids=FWD_IDS)
def test_forward_leaves_cpu_tensors_on_the_plain_version(shape, dtypes):
    x, _, w, b = _inputs(shape, seed=shape[-1] + 7)
    xt = torch.from_numpy(x).to(dtypes[0])
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    before = tln.layer_norm_fwd_cuda.launches
    got = tln.layer_norm_fwd(xt, wt, bt, EPS, dtypes[1])
    with torch.no_grad():
        no_grad = tln.layer_norm(xt, wt, bt, EPS, dtypes[1])
    under_grad = tln.layer_norm(xt, wt.requires_grad_(), bt, EPS, dtypes[1])
    assert tln.layer_norm_fwd_cuda.launches == before
    want = tln.layer_norm_plain(xt, wt, bt, EPS, dtypes[1])
    assert got.dtype == want.dtype == dtypes[1] and got.shape == shape
    for y in (got, no_grad, under_grad):
        assert torch.equal(y, want)


@pytest.mark.parametrize("dtypes", FWD_DTYPES, ids=FWD_IDS)
def test_plain_forward_matches_jax(dtypes):
    x, _, w, b = _inputs((2, 37, 64), seed=8)
    xt = torch.from_numpy(x).to(dtypes[0])
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = np.asarray(jax_layer_norm(
        jnp.asarray(xt.float().numpy()).astype(jdt[dtypes[0]]), jnp.asarray(w),
        jnp.asarray(b), eps=EPS, dtype=jdt[dtypes[1]], impl="xla"
    ).astype(jnp.float32))
    got = tln.layer_norm_plain(xt, torch.from_numpy(w), torch.from_numpy(b),
                               EPS, dtypes[1]).float().numpy()
    atol = 1e-5 if dtypes[1] == torch.float32 else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol)


def test_forward_kernel_wrapper_refuses_cpu_tensors():
    x, _, w, b = _inputs((4, 64), seed=9)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_fwd_cuda(*args)
