"""The port's training step on a SwinV2 against the JAX package's, on the CPU,
fp32, on the same seeded numpy inputs and the same weights.

The model is the two-stage SwinV2 of ``torch_parity`` (``swinv2_parity_window4``
at image_size 32: one stage shifts and takes the mask, the other clamps its
window), 4 channels with metadata. On the CPU the port's attention is the plain
version of K5 and K6 under torch autograd and its LayerNorm backward
``ln_bwd_plain``.

Tolerances, as ``test_torch_train.py`` states them for the ViT: loss and
grad_norm rtol 1e-4; parameters and EMA after 3 steps atol 3·2·lr·scale per
leaf (scale its LLRD multiplier: in Adam's first steps an update is close to
±lr·scale whatever the gradient's size, so a gradient within rounding of zero
may take the other sign in the other framework), and the median difference of a
leaf 1e-3·lr·scale plus 4 fp32 ulps of its largest value.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_torch.train import losses as tl
from fedvit_torch.train import mixup as tmix
from fedvit_torch.train.optim import build_optimizer, llrd_scale_map
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.train import losses as jl
from fedvit_tpu.train.optim import build_optimizer as jax_build_optimizer
from fedvit_tpu.train.optim import llrd_scale_tree
from fedvit_tpu.train.state import TrainState as JaxTrainState
from fedvit_tpu.train.step import make_train_step as jax_make_train_step

from torch_parity import jax_variables, raw_config, torch_model

# Biases that feed a BatchNorm in training mode: their true gradient is 0, so
# only the bound on the largest difference holds for them.
ZERO_GRAD = {"metadata_branch.net.0.bias", "metadata_branch.net.4.bias"}
DECAY = 0.8


@pytest.fixture(scope="module")
def swin():
    raw = raw_config(use_mask=True, backbone="swin")
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["model"]["classifier"] = {"dropout": 0.0}
    raw["training"].update({"batch_size": 4, "gradient_accumulation_steps": 2,
                            "optimizer": {"lr": 1e-3, "weight_decay": 1e-2},
                            "scheduler": {"warmup_epochs": 0},
                            "llrd": {"decay_rate": DECAY},
                            "ema": {"decay": 0.9}})
    raw["augmentation"] = {"mixup": {"enabled": False},
                           "cutmix": {"enabled": False}}
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    jmodel, variables = jax_variables(jcfg, seed=2)
    return raw, jcfg, tcfg, jmodel, variables


def test_llrd_scale_of_every_swin_leaf_matches_jax(swin):
    """Every leaf through ``state_dict_from_jax``'s name map. The patch
    merging is ``layers_{s}/downsample`` in the JAX tree and
    ``layers.{s+1}.downsample`` here, and keeps stage s's scale."""
    _, _, tcfg, _, variables = swin
    params = variables["params"]
    # each JAX leaf's scale, spread over the leaf's shape, takes the name map
    # of the weights themselves
    spread = jax.tree.map(lambda s, p: np.full(np.shape(p), float(s), np.float32),
                          llrd_scale_tree(params, DECAY, 10.0), params)
    want = {n: float(t.flatten()[0])
            for n, t in state_dict_from_jax({"params": spread}).items()}
    model = torch_model(tcfg, variables)
    got = llrd_scale_map((n for n, _ in model.named_parameters()), DECAY, 10.0)
    assert got.keys() == want.keys()
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, err_msg=n)
    n_stages = 2
    b = "backbone."
    for leaf in ("reduction.weight", "norm.weight", "norm.bias"):
        np.testing.assert_allclose(got[f"{b}layers.1.downsample.{leaf}"],
                                   DECAY ** n_stages, rtol=1e-6)
    for leaf in ("proj.weight", "proj.bias", "norm.weight", "norm.bias"):
        np.testing.assert_allclose(got[f"{b}patch_embed.{leaf}"],
                                   DECAY ** (n_stages + 1), rtol=1e-6)
    for leaf in ("logit_scale", "cpb_mlp.0.weight", "cpb_mlp.0.bias",
                 "cpb_mlp.2.weight", "q_bias", "v_bias", "qkv.weight"):
        np.testing.assert_allclose(got[f"{b}layers.1.blocks.0.attn.{leaf}"],
                                   DECAY ** (n_stages - 1), rtol=1e-6)
    assert got[f"{b}norm.weight"] == got[f"{b}norm.bias"] == 1.0
    assert got["classifier.0.weight"] == 10.0


def _batches(n, b, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(b, 32, 32, 4)).astype(np.float32),
             "label": rng.integers(0, 8, b).astype(np.int32),
             "metadata": rng.random((b, 13)).astype(np.float32)}
            for _ in range(n)]


def _jax_state(jcfg, jmodel, variables):
    tx, _ = jax_build_optimizer(jcfg, variables["params"], steps_per_epoch=10)
    return JaxTrainState.create(jmodel.apply, variables["params"],
                                variables["batch_stats"], tx,
                                jax.random.key(0), ema_enabled=True)


def _torch_state(tcfg, variables):
    model = torch_model(tcfg, variables)
    tx, _ = build_optimizer(tcfg, model, steps_per_epoch=10)
    return TrainState.create(model, tx, seed=0)


def test_swin_train_step_matches_jax_after_3_steps(swin):
    _, jcfg, tcfg, jmodel, variables = swin
    jstate = _jax_state(jcfg, jmodel, variables)
    jstep = jax_make_train_step(jcfg, jl.build_loss(jcfg), donate=False)
    tstate = _torch_state(tcfg, variables)
    tstep = make_train_step(tcfg, tl.build_loss(tcfg))
    start = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    for batch in _batches(3, 8):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert tstate.step == int(jstate.step) == 3
    lr = tcfg.training.optimizer.lr
    scales = tstate.tx.scales
    want = state_dict_from_jax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
    want_ema = state_dict_from_jax({"params": jstate.ema_params})
    names = [n for n, _ in tstate.model.named_parameters()]
    for kind in ("logit_scale", "cpb_mlp.0.weight", "cpb_mlp.0.bias",
                 "cpb_mlp.2.weight", "q_bias", "v_bias",
                 "downsample.reduction.weight", "downsample.norm.weight",
                 "patch_embed.norm.weight"):
        assert any(n.endswith(kind) for n in names), kind
    for n, p in tstate.model.named_parameters():
        tol = lr * scales[n]
        # every leaf moved, and its EMA shadow with it
        assert not torch.equal(p.detach(), start[n]), n
        assert not torch.equal(tstate.ema[n], start[n]), n
        for mine, theirs in ((p.detach(), want[n]), (tstate.ema[n], want_ema[n])):
            diff = (mine - theirs).abs()
            assert float(diff.max()) <= 3 * 2 * tol, n
            if n in ZERO_GRAD:
                continue
            floor = 4 * 2.0 ** -24 * float(theirs.abs().max())   # fp32 ulps
            assert float(diff.median()) <= 1e-3 * tol + floor, n


@pytest.mark.parametrize("mix", ["cutmix", "mixup"])
def test_swin_step_loss_with_mixing_matches_jax(swin, monkeypatch, mix):
    raw, _, _, jmodel, variables = swin
    raw = copy.deepcopy(raw)
    raw["augmentation"] = {"mixup": {"enabled": True, "alpha": 0.4},
                           "cutmix": {"enabled": True, "alpha": 1.0,
                                      "prob": 0.5}}
    jcfg, tcfg = jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)
    perm = np.array([2, 3, 1, 0])
    lam, centre = 0.375, (9, 20)
    draws = iter(centre * 2)          # one box per micro-batch
    monkeypatch.setattr(jax.random, "beta", lambda *a, **k: jnp.float32(lam))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda *a, **k: jnp.asarray(perm))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.int32(next(draws)))
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.float32(
        0.25 if mix == "cutmix" else 0.75))
    jstate = _jax_state(jcfg, jmodel, variables)
    jstep = jax_make_train_step(jcfg, jl.build_loss(jcfg), donate=False)
    tstate = _torch_state(tcfg, variables)
    tstep = make_train_step(tcfg, tl.build_loss(tcfg))
    box = tmix.rand_bbox(32, 32, lam, *centre)
    tstep.mix = lambda x, y, **kw: tmix.mixup_cutmix(
        x, y, use_cutmix=mix == "cutmix", lam=lam, perm=torch.from_numpy(perm),
        box=box)
    batch = _batches(1, 8, seed=4)[0]
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tstep(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)


def test_swin_step_with_drop_path_draws_from_the_states_generator(swin):
    """Drop-path masks come from the train state's generator: two states made
    from one seed take the same step, another seed another."""
    raw = copy.deepcopy(swin[0])
    raw["model"]["drop_path_rate"] = 0.5
    tcfg = tconfig.from_dict(raw)
    batch = _batches(1, 8, seed=6)[0]
    losses = []
    for seed in (0, 0, 1):
        model = torch_model(tcfg, swin[4])
        tx, _ = build_optimizer(tcfg, model, steps_per_epoch=10)
        state = TrainState.create(model, tx, seed=seed)
        _, m = make_train_step(tcfg, tl.build_loss(tcfg))(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]
