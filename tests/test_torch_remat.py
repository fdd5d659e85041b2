"""``model.remat``: rematerialised transformer blocks in the port, on the CPU.

- Remat on and off: the same seeded model and batch through one train step
  of 2 micro-batches, with drop-path 0.1, metadata and head dropout and
  MixUp/CutMix drawing from the step's generator. The loss, every gradient,
  every parameter after the update and the generator's state after the step
  must be bit-equal: the recomputation replays the forward's own masks and
  leaves the generator where a step without remat leaves it. The global
  torch RNG must not move.
- The port's remat step against JAX's (``nn.remat`` blocks) on the same
  weights at drop-path 0: loss and grad_norm of 2 steps at rtol 1e-4, the
  tolerance of ``tests/test_torch_train.py``'s step without remat (fp32
  matmuls and sums in another order, ~1e-6 relative an op).
- Evaluation, and training without a gradient, run no checkpoint.

The models: a ViT of 2 blocks at width 64 (one head of 64), a SwinV2 of
depths (1, 1) with windows of 4 (embed 32, heads of 32), both at 32 px.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.models import build_model
from fedvit_torch.models import registry as tregistry
from fedvit_torch.models import vit as tvit
from fedvit_torch.train import losses as tl
from fedvit_torch.train.optim import build_optimizer
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.models import registry as jregistry
from fedvit_tpu.models import vit as jvit
from fedvit_tpu.train import losses as jl
from fedvit_tpu.train.optim import build_optimizer as jax_build_optimizer
from fedvit_tpu.train.state import TrainState as JaxTrainState
from fedvit_tpu.train.step import make_train_step as jax_make_train_step

from tests.torch_parity import jax_variables, torch_model

SWIN_NAME = "swinv2_remat_window4"
SWIN_SPEC = dict(family="swinv2", embed_dim=32, depths=(1, 1),
                 num_heads=(1, 2), window_size=4,
                 pretrained_window_sizes=(2, 2))
BACKBONES = {"vit": "vit_tiny_patch16_224", "swin": SWIN_NAME}


@pytest.fixture(autouse=True)
def small_backbones():
    """``vit_tiny`` as 2 blocks of width 64 and the two-stage SwinV2, in both
    packages' registries, for the length of each test."""
    with pytest.MonkeyPatch.context() as mp:
        for configs_ in (jvit.VIT_CONFIGS, tvit.VIT_CONFIGS):
            mp.setitem(configs_, "tiny",
                       dict(embed_dim=64, depth=2, num_heads=1))
        for specs in (jregistry.BACKBONE_SPECS, tregistry.BACKBONE_SPECS):
            mp.setitem(specs, SWIN_NAME, SWIN_SPEC)
        yield


def _raw(backbone, remat, drop_path=0.1, mix=True):
    return {
        "model": {"backbone": BACKBONES[backbone], "image_size": 32,
                  "compute_dtype": "float32", "drop_path_rate": drop_path,
                  "remat": remat, "metadata": {"enabled": True}},
        "data": {"use_segmentation_mask": True},
        "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                     "optimizer": {"lr": 1e-3},
                     "scheduler": {"warmup_epochs": 0}},
        "augmentation": {"mixup": {"enabled": mix},
                         "cutmix": {"enabled": mix}},
    }


def _batch(seed=0, b=8):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, 32, 32, 4)).astype(np.float32),
            "label": rng.integers(0, 8, b).astype(np.int32),
            "metadata": rng.random((b, 13)).astype(np.float32)}


def _step(backbone, remat):
    """One step of a seeded model: (loss, grads, parameters after the
    update, the generator's state after the step); the global torch RNG
    must not move in the step (building a module draws from it)."""
    tcfg = tconfig.from_dict(_raw(backbone, remat))
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    tx, _ = build_optimizer(tcfg, model, steps_per_epoch=10)
    state = TrainState.create(model, tx, seed=2)
    step = make_train_step(tcfg, tl.build_loss(tcfg))
    rng_before = torch.get_rng_state()
    grads, loss, _ = step.accumulate_grads(state, _batch())
    grads = {n: g.clone() for n, g in grads.items()}
    step.apply_update(state, grads)
    assert torch.equal(torch.get_rng_state(), rng_before)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return float(loss), grads, params, state.generator.get_state()


@pytest.mark.parametrize("backbone", ["vit", "swin"])
def test_remat_step_is_bit_equal_to_the_step_without(backbone):
    loss, grads, params, gen = _step(backbone, remat=False)
    calls = []
    real = torch.utils.checkpoint.checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.utils.checkpoint, "checkpoint",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        r_loss, r_grads, r_params, r_gen = _step(backbone, remat=True)
    # 2 blocks (the ViT) or 1 + 1 (the SwinV2), each micro-batch
    assert len(calls) == 2 * 2
    assert r_loss == loss
    assert r_grads.keys() == grads.keys()
    for n in grads:
        assert torch.equal(r_grads[n], grads[n]), n
        assert torch.equal(r_params[n], params[n]), n
    assert torch.equal(r_gen, gen)


@pytest.mark.parametrize("backbone", ["vit", "swin"])
def test_remat_step_matches_jax(backbone):
    raw = _raw(backbone, remat=True, drop_path=0.0, mix=False)
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["model"]["classifier"] = {"dropout": 0.0}
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    jmodel, variables = jax_variables(jcfg)
    tx, _ = jax_build_optimizer(jcfg, variables["params"], steps_per_epoch=10)
    jstate = JaxTrainState.create(jmodel.apply, variables["params"],
                                  variables["batch_stats"], tx,
                                  jax.random.key(0), ema_enabled=True)
    jstep = jax_make_train_step(jcfg, jl.build_loss(jcfg), donate=False)
    model = torch_model(tcfg, variables)
    ttx, _ = build_optimizer(tcfg, model, steps_per_epoch=10)
    tstate = TrainState.create(model, ttx, seed=0)
    tstep = make_train_step(tcfg, tl.build_loss(tcfg))
    for seed in (3, 4):
        batch = _batch(seed)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("backbone", ["vit", "swin"])
def test_remat_checkpoints_only_in_training_with_grad(backbone):
    model = build_model(tconfig.from_dict(_raw(backbone, remat=True)),
                        device="cpu")
    x = torch.from_numpy(_batch()["image"][:2])
    calls = []
    real = torch.utils.checkpoint.checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.utils.checkpoint, "checkpoint",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        model.eval()
        model(x)
        with torch.no_grad():
            model(x)
        model.train()
        with torch.no_grad():
            model(x, generator=torch.Generator())
        assert calls == []
        model(x, generator=torch.Generator())["logits"].sum().backward()
    assert len(calls) == 2
