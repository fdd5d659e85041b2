"""The old generation's training and serving in the port against the JAX
package's, on the CPU: ``bce_dice_loss`` and ``joint_loss``, one JointLoss
train step of a tiny HybridViT, the LLRD scales and the stage-1 mask of the
segmentation branch and the fusion, and named-view TTA.

Tolerances, with their reasons: the losses are fp32 reductions over a few
hundred elements in another order, rtol 1e-6; the named views and the TTA
logits 1e-4 of the reference's largest |value| (fp32 resizes and matmuls in
another order). The step runs in fp32 through 2 ViT blocks, the U-Net and
the fusion forward and back, and the two sides differ by summation order
only: the loss to rtol 1e-5, the gradient norm to 1e-4, the running
statistics to 1e-4 of the reference's largest |value|, and each gradient
leaf outside the U-Net to 1e-4 as the RMS of the difference over the RMS
of the reference (measured: 5e-5 at most).

The U-Net's gradients are not that well conditioned. In training mode
every U-Net convolution feeds a BatchNorm, whose backward subtracts the
mean and the projection on the normalised input, so the gradient of each
layer before one is a sum that cancels, and the ReLUs and max pools switch
where a value sits at a tie. The two frameworks' forwards differ by 1e-5 of
the values at the bottleneck (sums in another order through 10
BatchNorms); JAX's own U-Net gradients move by up to a few percent of a
small leaf when its image is perturbed by 3e-6 of itself. So the U-Net is
held as a whole, the L2 norm of the difference over all its leaves at 1e-2
of the reference's (measured: 1.8e-3; every other module 1e-4, measured
1.6e-6 at most), and each of its leaves at a quarter of its RMS (measured:
0.03 at most, on a one-element psi BatchNorm bias). A wrong kernel flip, momentum, target or seg weight
moves a leaf by its own size. Leaves of RMS at most 2^-6 of their module's
median leaf are held only by their module's norm.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.data.pipeline import ArrayDataSource as TorchSource
from fedvit_torch.eval.serve import evaluate_with_tta
from fedvit_torch.models import build_model
from fedvit_torch.models.import_weights import (_flatten, _name,
                                                load_jax_variables,
                                                state_dict_from_jax)
from fedvit_torch.ops import image as TI
from fedvit_torch.train import losses as tl
from fedvit_torch.train.optim import (build_optimizer, head_only_mask,
                                      llrd_scale_map)
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.data.pipeline import ArrayDataSource as JaxSource
from fedvit_tpu.ops import image as JI
from fedvit_tpu.train import loop as jloop
from fedvit_tpu.train import losses as jl
from fedvit_tpu.train.optim import head_only_mask as jax_head_only_mask
from fedvit_tpu.train.optim import llrd_scale_tree
from fedvit_tpu.train.state import TrainState as JaxTrainState
from fedvit_tpu.train.step import make_train_step as jax_make_train_step

from tests.test_torch_old_gen import RTOL, close, old_gen_raw
from tests.torch_parity import jax_variables, shallow_vit


# --- the losses ----------------------------------------------------------------

def _seg(seed, soft):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(3, 12, 10, 1))).astype(np.float32)
    target = (rng.random((3, 12, 10, 1)) if soft
              else rng.random((3, 12, 10, 1)) > 0.6).astype(np.float32)
    return logits, target


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_bce_dice_loss_matches_jax(soft):
    logits, target = _seg(0, soft)
    for w, smooth in ((0.5, 1.0), (0.2, 0.1)):
        want = jl.bce_dice_loss(jnp.asarray(logits), jnp.asarray(target),
                                w, smooth)
        got = tl.bce_dice_loss(torch.from_numpy(logits),
                               torch.from_numpy(target), w, smooth)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # fp32 whatever the logits' dtype
    low = tl.bce_dice_loss(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(target))
    assert low.dtype == torch.float32


def test_joint_loss_matches_jax():
    logits, target = _seg(1, False)
    rng = np.random.default_rng(2)
    cls = rng.normal(size=(3, 8)).astype(np.float32)
    y = rng.integers(0, 8, 3)
    for seg, weight in ((True, 0.3), (True, 0.0), (False, 0.3)):
        args = (jnp.asarray(logits), jnp.asarray(target)) if seg else (None, None)
        want = jl.joint_loss(jl.asymmetric_focal_loss, jnp.asarray(cls),
                             jnp.asarray(y), *args, seg_weight=weight)
        targs = ((torch.from_numpy(logits), torch.from_numpy(target)) if seg
                 else (None, None))
        got = tl.joint_loss(tl.asymmetric_focal_loss, torch.from_numpy(cls),
                            torch.from_numpy(y), *targs, seg_weight=weight)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- one JointLoss step ------------------------------------------------------------

def _step_raw(fusion):
    raw = old_gen_raw(fusion, 48)
    raw["model"]["classifier"]["dropout"] = 0.0
    raw["training"].update({"batch_size": 4, "gradient_accumulation_steps": 2,
                            "scheduler": {"warmup_epochs": 0}})
    raw["augmentation"] = {"mixup": {"enabled": False},
                           "cutmix": {"enabled": False}}
    return raw


UNET_RTOL, UNET_LEAF_RTOL, NOISE_SHARE = 1e-2, 0.25, 2.0 ** -6


def _capture_grads():
    """An optax transform whose state after an update is the gradients it
    was given and whose update is zero: the JAX step's averaged gradients,
    read from its new ``opt_state``."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_step(jcfg, jmodel, variables, batch):
    """JAX's step on ``batch``: (metrics, averaged gradients and running
    statistics after the step, by the port's names)."""
    state = JaxTrainState.create(jmodel.apply, variables["params"],
                                 variables["batch_stats"], _capture_grads(),
                                 jax.random.key(0), ema_enabled=False)
    step = jax_make_train_step(jcfg, jl.build_loss(jcfg), donate=False)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return metrics, state_dict_from_jax({"params": state.opt_state,
                                         "batch_stats": state.batch_stats})


def test_joint_loss_step_matches_jax():
    """Mix off, dropout and drop-path 0, 2 accumulations of 4; the batch's
    4th channel a binary mask normalised as the augment does, ±1. Then the
    LLRD scale and the stage-1 mask of every leaf against JAX's
    ``llrd_scale_tree`` and ``head_only_mask``: the fusion and the U-Net
    take the head's multiplier and train in stage 1."""
    raw = _step_raw("attention")
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    rng = np.random.default_rng(7)
    img = rng.normal(size=(8, 48, 48, 3)).astype(np.float32)
    mask = np.where(rng.random((8, 48, 48, 1)) > 0.5, 1.0, -1.0)
    batch = {"image": np.concatenate([img, mask], -1).astype(np.float32),
             "label": rng.integers(0, 8, 8).astype(np.int32),
             "metadata": rng.random((8, 13)).astype(np.float32)}
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg)
        jm, want = _jax_step(jcfg, jmodel, variables, batch)
        model = load_jax_variables(build_model(tcfg, device="cpu"), variables)
    tx, _ = build_optimizer(tcfg, model, steps_per_epoch=10)
    state = TrainState.create(model, tx, seed=0)
    step = make_train_step(tcfg, tl.build_loss(tcfg))
    assert step.seg_weight == 0.3
    grads, loss, stats = step.accumulate_grads(state, batch)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-5)
    assert set(want) == {n for n in {**grads, **stats}
                         if not n.startswith("metadata_branch.")}
    assert not any(g.any() for n, g in grads.items()      # the branch that
                   if n.startswith("metadata_branch."))   # never runs
    for n, t in stats.items():
        close(t, want[n].numpy(), n)

    def rel_rms(names):
        num = sum(float(((grads[n] - want[n]) ** 2).sum()) for n in names)
        return (num / sum(float((want[n] ** 2).sum()) for n in names)) ** 0.5

    for module in ("backbone", "fusion", "classifier", "seg_branch"):
        names = [n for n in grads if n.startswith(module + ".")]
        rms = {n: float(want[n].square().mean().sqrt()) for n in names}
        median = float(np.median(list(rms.values())))
        kept = [n for n in names if rms[n] > NOISE_SHARE * median]
        limit = UNET_LEAF_RTOL if module == "seg_branch" else RTOL
        worst = max(kept, key=lambda n: rel_rms([n]))
        assert rel_rms([worst]) <= limit, (worst, rel_rms([worst]))
        assert rel_rms(names) <= (UNET_RTOL if module == "seg_branch"
                                  else RTOL), module
    assert "seg_branch.decoder.final_conv.weight" in want
    assert "seg_branch.decoder.dec3.bn2.running_var" in want
    norm = step.apply_update(state, grads)
    np.testing.assert_allclose(float(norm), float(jm["grad_norm"]), rtol=1e-4)
    # without the seg term the step adds nothing for the mask
    off = tconfig.from_dict({**raw, "loss": {"seg_weight": 0.0}})
    assert make_train_step(off, tl.build_loss(off)).seg_weight == 0.0

    params = variables["params"]
    scale = {_name(p, head_ln=True): float(v) for p, v in
             _flatten(llrd_scale_tree(params, 0.75, 10.0)).items()}
    mask = {_name(p, head_ln=True): bool(v) for p, v in
            _flatten(jax_head_only_mask(params)).items()}
    got = llrd_scale_map((n for n, _ in model.named_parameters()), 0.75, 10.0)
    got_mask = head_only_mask(model)
    for n in scale:
        assert got[n] == pytest.approx(scale[n], rel=1e-6), n
        assert got_mask[n] == mask[n], n
    old = [n for n in scale if n.startswith(("seg_branch.", "fusion."))]
    assert len(old) > 50 and all(got[n] == 10.0 and got_mask[n] for n in old)


# --- named-view TTA -------------------------------------------------------------

VIEWS = ("original", "hflip", "vflip", "crop_tl", "crop_br", "crop_center",
         "unknown")


def test_tta_views_named_match_jax():
    img = np.random.default_rng(8).random((2, 50, 44, 3)).astype(np.float32)
    want = JI.tta_views_named(jnp.asarray(img), VIEWS, out_size=40)
    got = TI.tta_views_named(torch.from_numpy(img), VIEWS, out_size=40)
    assert got.shape == (2, len(VIEWS), 40, 40, 3)
    close(got, want)
    torch.testing.assert_close(got[:, -1], got[:, 0])


def _tta_raw(use_mask):
    """A 3-channel HybridViT with the MLP metadata branch and the plain
    head (the classifier tests of ``test_torch_old_gen.py`` take the other
    options)."""
    raw = old_gen_raw("attention", 32, joint=False, style="mlp",
                      head_ln=False)
    raw["data"]["use_segmentation_mask"] = use_mask
    raw["training"]["tta"] = {"views": list(VIEWS[:6])}
    return raw


def test_evaluate_with_named_views_matches_jax():
    raw = _tta_raw(False)
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    rng = np.random.default_rng(9)
    data = {"image": rng.integers(0, 256, (5, 40, 40, 3), dtype=np.uint8),
            "label": rng.integers(0, 8, 5),
            "metadata": rng.random((5, 13)).astype(np.float32)}
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg)
        model = load_jax_variables(build_model(tcfg, device="cpu"), variables)
        want = jloop.evaluate_with_tta(jcfg, jmodel, variables["params"],
                                       variables["batch_stats"],
                                       JaxSource(data), batch_size=2)
    got = evaluate_with_tta(tcfg, model, TorchSource(data), batch_size=2)
    assert got[1] == want[1] and got[2].shape == (5, 8)
    close(got[2], want[2])
    assert got[0] == want[0]


def test_named_views_refuse_the_mask_channel_in_both_packages():
    raw = _tta_raw(True)
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    data = {"image": np.zeros((2, 40, 40, 4), np.uint8), "label": np.zeros(2),
            "metadata": np.zeros((2, 13), np.float32)}
    with pytest.raises(ValueError, match="3-channel pipeline"):
        jloop.evaluate_with_tta(jcfg, None, None, None, JaxSource(data))
    with shallow_vit():
        model = build_model(tcfg, device="cpu")
    with pytest.raises(ValueError, match="3-channel pipeline"):
        evaluate_with_tta(tcfg, model, TorchSource(data))
