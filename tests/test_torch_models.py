"""The port's ISICClassifier against the JAX package's, on the same weights.

A JAX ISICClassifier (vit_tiny_patch16_224 at image_size 32, fp32) is
initialised, its variables converted with ``state_dict_from_jax`` and loaded
into the port's model; both take the same seeded numpy inputs. Tolerance:
logits atol 1e-4 — fp32 throughout, the two frameworks sum in other orders
through 12 blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_tpu.models.import_weights import import_torch_isic

from torch_parity import (configs, flat, jax_variables, shallow_vit,
                          torch_model)

ATOL = 1e-4


@pytest.mark.parametrize("use_mask,with_meta", [
    (True, True), (False, True), (True, False)],
    ids=["4ch", "3ch", "no_metadata"])
def test_logits_match_jax(use_mask, with_meta):
    jcfg, tcfg = configs(use_mask)
    jmodel, variables = jax_variables(jcfg, seed=1)
    tmodel = torch_model(tcfg, variables)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 32, 32, jcfg.in_channels)).astype(np.float32)
    meta = rng.normal(size=(3, 13)).astype(np.float32) if with_meta else None
    want = jmodel.apply(variables, jnp.asarray(x),
                        None if meta is None else jnp.asarray(meta),
                        deterministic=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x),
                     None if meta is None else torch.from_numpy(meta))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), atol=ATOL)


def test_state_dict_round_trip_through_import_torch_isic():
    """port state_dict → import_torch_isic → the original JAX variables."""
    jcfg, tcfg = configs(True)
    _, variables = jax_variables(jcfg, seed=3)
    sd = torch_model(tcfg, variables).state_dict()
    back = import_torch_isic(sd, variables, depth=12)
    for group in ("params", "batch_stats"):
        want = flat(variables[group])
        got = flat(back[group])
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_state_dict_names_follow_the_reference():
    _, tcfg = configs(True)
    from fedvit_torch.models import build_model
    keys = set(build_model(tcfg, device="cpu").state_dict())
    for k in ("backbone.patch_embed.proj.weight", "backbone.cls_token",
              "backbone.blocks.11.attn.qkv.bias", "backbone.norm.weight",
              "metadata_branch.net.0.weight", "metadata_branch.net.5.running_var",
              "classifier.0.weight", "classifier.3.bias"):
        assert k in keys, k
    assert build_model(tcfg, device="cpu").state_dict()[
        "backbone.patch_embed.proj.weight"].shape == (192, 4, 16, 16)


def test_cuda_entry_point_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = configs(True)
    from fedvit_torch.models import build_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(tcfg)


def test_unported_branches_raise():
    """The old generation's options and rematerialised blocks are ported:
    each builds, and a remat model takes a train step."""
    _, tcfg = configs(True)
    from fedvit_torch.models import build_model
    m = tcfg.model
    for model_cfg in (
            m.__class__(**{**m.__dict__, "metadata": m.metadata.__class__(style="embedding")}),
            m.__class__(**{**m.__dict__, "segmentation": m.segmentation.__class__(
                enabled=True, encoder_channels=(4, 8, 8, 8),
                decoder_channels=(8, 8, 4, 4))})):
        model = build_model(tcfg.replace(model=model_cfg), device="cpu")
        assert "metadata_branch.age_proj.weight" in model.state_dict() or \
            "seg_branch.decoder.final_conv.weight" in model.state_dict()
    # a Swin model trains like a ViT, and so does a rematerialised one
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.step import TrainStep, make_train_step
    swin = tcfg.replace(model=m.__class__(
        **{**m.__dict__, "backbone": "swin_small_patch4_window12_384"}))
    assert isinstance(make_train_step(swin, build_loss(swin)), TrainStep)
    remat = tcfg.replace(model=m.__class__(**{**m.__dict__, "remat": True}))
    _takes_a_step(remat)


def _takes_a_step(tcfg):
    """A train step of the model ``tcfg`` builds (vit_tiny cut to 2 blocks)
    on a seeded batch of 4: a finite loss, the step counted."""
    from fedvit_torch.models import build_model
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step
    with shallow_vit():
        model = build_model(tcfg, device="cpu")
    tx, _ = build_optimizer(tcfg, model, steps_per_epoch=4)
    state = TrainState.create(model, tx, seed=0)
    rng = np.random.default_rng(3)
    s, c = tcfg.model.image_size, tcfg.in_channels
    state, metrics = make_train_step(tcfg, build_loss(tcfg))(state, {
        "image": rng.normal(size=(4, s, s, c)).astype(np.float32),
        "label": rng.integers(0, 8, 4), "metadata": rng.random((4, 13))})
    assert np.isfinite(float(metrics["loss"])) and state.step == 1


def _with_impl(backbone, impl):
    _, tcfg = configs(True, backbone=backbone)
    m = tcfg.model
    return tcfg.replace(model=m.__class__(**{**m.__dict__,
                                             "attention_impl": impl}))


@pytest.mark.parametrize("backbone,impl", [
    ("vit", "xla"), ("swin", "xla"), ("swin", "packed")])
def test_attention_has_one_path(backbone, impl):
    """The values JAX runs through its XLA branch on any device, ``xla`` and,
    on the SwinV2, ``packed``, take the port's plain attention on any
    device: the logits and every parameter's gradient of a fixed weighting
    of them against JAX's model with the same ``attention_impl``, fp32, at
    1e-4 (of the leaf's largest |value| for the gradients: sums in another
    order through vit_tiny cut to 2 blocks or the two-stage SwinV2)."""
    jcfg, tcfg = configs(True, backbone=backbone)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                  attention_impl=impl))
    tcfg = _with_impl(backbone, impl)
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg, seed=4)
        tmodel = torch_model(tcfg, variables)
        _logits_and_grads_match_jax(jmodel, variables, tmodel)


def _logits_and_grads_match_jax(jmodel, variables, tmodel):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    meta = rng.normal(size=(2, 13)).astype(np.float32)
    weights = rng.normal(size=(2, 8)).astype(np.float32)

    def objective(params):
        out = jmodel.apply({**variables, "params": params}, jnp.asarray(x),
                           jnp.asarray(meta), deterministic=True)
        return (out["logits"] * weights).sum(), out["logits"]

    (_, want), want_g = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        variables["params"])
    want_g = state_dict_from_jax({"params": jax.device_get(want_g)})
    got = tmodel(torch.from_numpy(x), torch.from_numpy(meta))["logits"]
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert grads.keys() == want_g.keys()
    for n, g in grads.items():
        w = want_g[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize("backbone,impl", [
    ("vit", "pallas"), ("vit", "packed"), ("vit", "mega"),
    ("swin", "pallas"), ("swin", "mega")])
def test_ported_attention_impls_build_and_agree_with_auto(backbone, impl):
    """Each ported value builds, takes the ``auto`` model's weights (one key
    set) and gives its logits: ``pallas`` and the SwinV2's ``mega`` are the
    same path as ``auto`` (bit for bit); the ViT's ``packed`` and ``mega``
    compose the projection and the attention otherwise (atol 1e-5, fp32
    sums in another order)."""
    from fedvit_torch.models import build_model
    auto = build_model(_with_impl(backbone, "auto"), device="cpu")
    _perturb(auto)
    model = build_model(_with_impl(backbone, impl), device="cpu")
    model.load_state_dict(auto.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 32, 32, 4)).astype(np.float32))
    with torch.inference_mode():
        want, got = auto(x)["logits"], model(x)["logits"]
    exact = impl == "pallas" or backbone == "swin"
    torch.testing.assert_close(got, want, atol=0 if exact else 1e-5, rtol=0)


def _perturb(model):
    """chip_smoke.py's seeded perturbation: non-zero qkv biases, so that a
    path that dropped or doubled them would show."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.perturb(model, seed=0)


def test_smoke_reference_attention_is_swapped_in_and_restored():
    """chip_smoke.py's plain reference path: ``attention_replaced_by`` runs
    the model's attention through another function, then puts the op back."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from fedvit_torch.models import build_model, layers
    from fedvit_torch.ops.attention import attention_from_qkvb

    _, tcfg = configs(True)
    model = build_model(tcfg, device="cpu")
    chip_smoke.perturb(model, seed=0)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 4)).astype(np.float32))
    kernel = layers.flash_attention_qkvb
    with torch.inference_mode():
        want = model(x)["logits"]
        with chip_smoke.attention_replaced_by(
                lambda qkv, bias, h: attention_from_qkvb(qkv, bias * 0, h)):
            no_bias = model(x)["logits"]
        again = model(x)["logits"]
    assert layers.flash_attention_qkvb is kernel
    torch.testing.assert_close(again, want, atol=0, rtol=0)
    assert chip_smoke.rel_rms(no_bias.numpy(), want.numpy()) > 0.1
