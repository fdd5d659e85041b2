"""``attention_impl: packed`` and ``mega`` in the port against the JAX
package, on the CPU, on the same seeded numpy inputs.

The port's plain versions of K10 (``ops/attention.py::attention_from_qkv``)
and K11 (``attention_from_x``), which its CUDA kernels are held to on the
card, against JAX's XLA branch and its Pallas kernels in interpret mode, at
d = 64 and d = 80 (ViT-H's head width) and a ragged N; then a shallow
``vit_tiny`` ISICClassifier with each value and one training step of it.

Tolerances, with their reasons (fp32 unless said):

- K10's values 2e-5, dqkv 2e-4; K11's values 2e-5 (JAX's own bounds for the
  same comparisons, ``tests/test_flash_attention.py``: the frameworks sum
  rows of N and D terms in other orders), dx, dW and db 3e-4 (sums over N
  keys, B·N rows and 3E columns);
- bf16: qkv of ``mega`` equals the fp32 sum plus the fp32 bias rounded once,
  exactly, and JAX's to within one bf16 ulp where the two fp32 sums straddle
  a rounding boundary (at most 1% of the elements); the attention on it 2
  bf16 ulps of outputs below 2;
- the classifier's logits atol 1e-4 (fp32 through its blocks, as
  ``tests/test_torch_models.py``);
- one step: loss and grad_norm rtol 1e-4, the parameters and EMA after it
  atol 2·lr·scale per leaf, the median 1e-3·lr·scale plus 4 ulps, as
  ``tests/test_torch_train.py`` after 3 steps (Adam's first update is about
  ±lr·scale whatever the gradient's size).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_torch.ops import attention as tattn
from fedvit_torch.ops.flash_attention import (flash_attention_qkv,
                                              flash_attention_xqkv)
from fedvit_torch.train import losses as tl
from fedvit_torch.train.optim import build_optimizer
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.ops import attention as jattn
from fedvit_tpu.ops.flash_attention import flash_attention_qkv as jax_qkv
from fedvit_tpu.ops.flash_attention import flash_attention_xqkv as jax_xqkv
from fedvit_tpu.train import losses as jl
from fedvit_tpu.train.optim import build_optimizer as jax_build_optimizer
from fedvit_tpu.train.state import TrainState as JaxTrainState
from fedvit_tpu.train.step import make_train_step as jax_make_train_step

from tests.torch_parity import TINY, jax_variables, shallow_vit, torch_model

SHAPES = [(2, 37, 2, 64), (2, 37, 2, 80)]        # (B, N, heads, d)
IDS = ["d64", "d80"]
ZERO_GRAD = ("metadata_branch.net.0.bias", "metadata_branch.net.4.bias")


def _grad(fn, *arrays, dout):
    """fn's value and its gradients against each of the torch leaves."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grad(fn, *arrays, dout):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("b,n,heads,d", SHAPES, ids=IDS)
def test_plain_qkv_matches_jax_xla_and_pallas(b, n, heads, d):
    e = heads * d
    rng = np.random.default_rng(n + d)
    qkv = rng.normal(size=(b, n, 3 * e)).astype(np.float32)
    dout = rng.normal(size=(b, n, e)).astype(np.float32)
    got, (dqkv,) = _grad(lambda t: flash_attention_qkv(t, heads), qkv,
                         dout=dout)
    for fn in (lambda t: jattn.attention_from_qkv(t, heads, impl="xla"),
               lambda t: jax_qkv(t, heads, interpret=True)):
        want, (want_dqkv,) = _jax_grad(fn, qkv, dout=dout)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(dqkv, want_dqkv, atol=2e-4, rtol=2e-4)


def _x_inputs(b, n, dim, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, dim)).astype(np.float32)
    w = (rng.normal(size=(dim, 3 * e)) / np.sqrt(dim)).astype(np.float32)
    bias = (0.5 * rng.normal(size=(3 * e,))).astype(np.float32)
    dout = rng.normal(size=(b, n, e)).astype(np.float32)
    return x, w, bias, dout


@pytest.mark.parametrize("b,n,heads,d", SHAPES, ids=IDS)
def test_plain_x_matches_jax_xla_and_pallas(b, n, heads, d):
    e = heads * d
    x, w, bias, dout = _x_inputs(b, n, 96, e, seed=n + d)
    got, grads = _grad(lambda *t: flash_attention_xqkv(*t, heads), x, w, bias,
                       dout=dout)
    for fn in (lambda *t: jattn.attention_from_x(*t, heads, impl="xla"),
               lambda *t: jax_xqkv(*t, heads, interpret=True)):
        want, want_grads = _jax_grad(fn, x, w, bias, dout=dout)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        for name, g, wg in zip(("dx", "dw", "db"), grads, want_grads):
            np.testing.assert_allclose(g, wg, atol=3e-4, rtol=3e-4,
                                       err_msg=name)


def test_mega_rounds_qkv_once_in_bf16(monkeypatch):
    """``mega``'s qkv is x·W summed in fp32 plus the fp32 bias, rounded once
    to bf16 — not the bf16 product plus a bf16 bias (``packed``'s two
    roundings) — as JAX's XLA branch computes it."""
    heads, d = 2, 80
    x, w, bias, _ = _x_inputs(2, 37, 96, heads * d, seed=3)
    x16, w16, b16 = (torch.from_numpy(t).bfloat16() for t in (x, w, bias))
    seen = []
    plain = tattn.attention_from_qkv
    monkeypatch.setattr(tattn, "attention_from_qkv",
                        lambda qkv, h: seen.append(qkv) or plain(qkv, h))
    got = tattn.attention_from_x(x16, w16, b16, heads)
    (qkv,) = seen
    once = (x16.float() @ w16.float() + b16.float()).bfloat16()
    twice = (x16 @ w16) + b16
    assert qkv.dtype == torch.bfloat16 and torch.equal(qkv, once)
    assert not torch.equal(once, twice)
    jx, jw, jb = (jnp.asarray(t, jnp.bfloat16) for t in (x, w, bias))
    jqkv = (jnp.dot(jx, jw, preferred_element_type=jnp.float32)
            + jb.astype(jnp.float32)).astype(jnp.bfloat16)
    apart = np.abs(qkv.float().numpy() - np.asarray(jqkv.astype(jnp.float32)))
    ulp = 2.0 ** -7 * np.maximum(np.abs(np.asarray(jqkv, np.float32)), 2.0 ** -126)
    assert np.all(apart <= ulp) and np.mean(apart > 0) <= 0.01
    want = jattn.attention_from_x(jx, jw, jb, heads, impl="xla")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2 * 2.0 ** -7 * 2)


@pytest.fixture(scope="module", params=["packed", "mega"])
def tiny(request):
    """(impl, JAX config, port config, JAX model, variables) of a 2-block
    vit_tiny with ``attention_impl`` ``packed`` or ``mega``."""
    raw = copy.deepcopy(TINY)
    raw["model"]["attention_impl"] = request.param
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["model"]["classifier"] = {"dropout": 0.0}
    raw["training"].update({"batch_size": 4, "gradient_accumulation_steps": 2,
                            "optimizer": {"lr": 1e-3, "weight_decay": 1e-2},
                            "scheduler": {"warmup_epochs": 0},
                            "ema": {"decay": 0.9}})
    raw["augmentation"] = {"mixup": {"enabled": False},
                           "cutmix": {"enabled": False}}
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg, seed=4)
        yield request.param, jcfg, tcfg, jmodel, variables


def test_classifier_logits_match_jax(tiny):
    impl, jcfg, tcfg, jmodel, variables = tiny
    tmodel = torch_model(tcfg, variables)
    auto = torch_model(tcfg.replace(model=dataclasses.replace(
        tcfg.model, attention_impl="auto")), variables)
    # one key set for every attention_impl: the same variables load into each
    assert tmodel.state_dict().keys() == auto.state_dict().keys()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 32, 32, jcfg.in_channels)).astype(np.float32)
    meta = rng.normal(size=(3, 13)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(meta),
                        deterministic=True)["logits"]
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(meta))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_one_train_step_matches_jax(tiny):
    impl, jcfg, tcfg, jmodel, variables = tiny
    tx, _ = jax_build_optimizer(jcfg, variables["params"], steps_per_epoch=10)
    jstate = JaxTrainState.create(jmodel.apply, variables["params"],
                                  variables["batch_stats"], tx,
                                  jax.random.key(0), ema_enabled=True)
    jstep = jax_make_train_step(jcfg, jl.build_loss(jcfg), donate=False)
    model = torch_model(tcfg, variables)
    ttx, _ = build_optimizer(tcfg, model, steps_per_epoch=10)
    tstate = TrainState.create(model, ttx, seed=0)
    tstep = make_train_step(tcfg, tl.build_loss(tcfg))
    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(size=(8, 32, 32, 4)).astype(np.float32),
             "label": rng.integers(0, 8, 8).astype(np.int32),
             "metadata": rng.random((8, 13)).astype(np.float32)}
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tstep(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    lr = tcfg.training.optimizer.lr
    want = state_dict_from_jax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
    want_ema = state_dict_from_jax({"params": jstate.ema_params})
    start = torch_model(tcfg, variables).state_dict()
    moved = 0
    for n, p in tstate.model.named_parameters():
        tol = lr * tstate.tx.scales[n]
        for mine, theirs in ((p.detach(), want[n]), (tstate.ema[n], want_ema[n])):
            diff = (mine - theirs).abs()
            assert float(diff.max()) <= 2 * tol, n
            if n in ZERO_GRAD:
                continue
            floor = 4 * 2.0 ** -24 * float(theirs.abs().max())
            assert float(diff.median()) <= 1e-3 * tol + floor, n
        moved += not torch.equal(p.detach(), start[n])
    assert moved == len(want_ema)
