"""The port's training pieces and train step against the JAX package's, on
the CPU, fp32, on the same seeded numpy inputs.

Tolerances, with their reasons:

- losses, schedule, EMA, mixing, BatchNorm: 1e-6 relative or absolute (fp32
  elementwise work, reductions over at most a few hundred terms);
- the optimizer, 3 updates on the same gradients: 1e-7 absolute on
  parameters of size ~1 (lr 1e-3: updates of ≤ 1e-2, fp32 rounding of Adam's
  ratio, in another order); with the first moment in bf16, 3·2^-7·lr·scale
  (one bf16 ulp of the moment in each update; scale the LLRD multiplier);
- the whole step: loss and grad_norm rtol 1e-4 (the two frameworks' fp32
  matmuls and sums over the model (vit_tiny cut to 2 blocks, see ``tiny``)
  differ at ~1e-6 relative per op);
  parameters, EMA and BatchNorm statistics after 3 steps: atol 3·2·lr·scale
  per leaf (scale its LLRD multiplier). In Adam's first steps every update is
  close to ±lr·scale whatever the gradient's size, so a gradient within
  rounding of zero can take the other sign in the other framework and move
  that element by up to 2·lr·scale a step; the others agree to the fp32
  rounding of the parameter, which the median check holds (1e-3·lr·scale
  plus 4 ulps of the leaf's largest value).
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.models.import_weights import _flatten, _name, state_dict_from_jax
from fedvit_torch.models.layers import DropPath, Dropout, TorchBatchNorm
from fedvit_torch.train import ema as tema
from fedvit_torch.train import losses as tl
from fedvit_torch.train import mixup as tmix
from fedvit_torch.train import schedule as tsched
from fedvit_torch.train.optim import build_optimizer, llrd_scale_map
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.models.layers import TorchBatchNorm as JaxBatchNorm
from fedvit_tpu.train import ema as jema
from fedvit_tpu.train import losses as jl
from fedvit_tpu.train import mixup as jmix
from fedvit_tpu.train import schedule as jsched
from fedvit_tpu.train.optim import build_optimizer as jax_build_optimizer
from fedvit_tpu.train.optim import llrd_scale_tree
from fedvit_tpu.train.state import TrainState as JaxTrainState
from fedvit_tpu.train.step import make_train_step as jax_make_train_step

from tests.torch_parity import TINY, jax_variables, shallow_vit, torch_model

# --- losses -------------------------------------------------------------------

WEIGHTS = np.array([0.5, 2.0, 1.0, 1.5, 0.8, 3.0, 1.2, 0.7], np.float32)
LOSSES = {
    "asymmetric": (jl.asymmetric_focal_loss, tl.asymmetric_focal_loss, {}),
    "asymmetric_noclip": (partial(jl.asymmetric_focal_loss, clip=0.0),
                          partial(tl.asymmetric_focal_loss, clip=0.0), {}),
    "ce": (jl.cross_entropy_loss, tl.cross_entropy_loss, {}),
    "ce_smooth": (partial(jl.cross_entropy_loss, label_smoothing=0.1),
                  partial(tl.cross_entropy_loss, label_smoothing=0.1), {}),
    "ce_weighted_smooth": (jl.cross_entropy_loss, tl.cross_entropy_loss,
                           {"class_weights": WEIGHTS, "label_smoothing": 0.1}),
    "focal": (jl.focal_loss, tl.focal_loss, {}),
    "focal_weighted": (jl.focal_loss, tl.focal_loss,
                       {"class_weights": WEIGHTS}),
}


def _logits(seed=0, b=16, c=8):
    rng = np.random.default_rng(seed)
    return (2 * rng.normal(size=(b, c))).astype(np.float32), \
        rng.integers(0, c, b)


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_grad_match_jax(name):
    jfn, tfn, kw = LOSSES[name]
    logits, targets = _logits(seed=len(name))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want, want_g = jax.value_and_grad(
        lambda x: jfn(x, jnp.asarray(targets), **jkw))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tfn(lt, torch.from_numpy(targets), **tkw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), atol=1e-6)


def test_losses_compute_in_fp32():
    logits, targets = _logits(1)
    for _, tfn, _ in LOSSES.values():
        got = tfn(torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets))
        assert got.dtype == torch.float32


@pytest.mark.parametrize("kind", ["asymmetric", "ce", "focal"])
@pytest.mark.parametrize("use_weights", [False, True])
def test_build_loss_matches_jax(kind, use_weights):
    raw = {"loss": {"type": kind, "class_weights": use_weights,
                    "label_smoothing": 0.05}}
    jfn = jl.build_loss(jconfig.from_dict(copy.deepcopy(raw)),
                        jnp.asarray(WEIGHTS))
    tfn = tl.build_loss(tconfig.from_dict(raw), torch.from_numpy(WEIGHTS))
    logits, targets = _logits(2)
    np.testing.assert_allclose(
        float(tfn(torch.from_numpy(logits), torch.from_numpy(targets))),
        float(jfn(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-6)


def test_mixup_criterion_matches_jax():
    logits, ta = _logits(3)
    tb = np.roll(ta, 1)
    want = jl.mixup_criterion(jl.asymmetric_focal_loss, jnp.asarray(logits),
                              jnp.asarray(ta), jnp.asarray(tb),
                              jnp.float32(0.3))
    got = tl.mixup_criterion(tl.asymmetric_focal_loss, torch.from_numpy(logits),
                             torch.from_numpy(ta), torch.from_numpy(tb), 0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_old_generation_losses_raise():
    """The old generation's losses are ported: they compute JAX's values
    (``tests/test_torch_joint_loss.py`` holds them in full) and raise only on
    inputs they cannot take."""
    logits, _ = _logits(4, b=6, c=5)
    seg = logits.reshape(2, 3, 5, 1)
    target = (seg > 0).astype(np.float32)
    want = jl.joint_loss(jl.asymmetric_focal_loss, jnp.asarray(logits[:2]),
                         jnp.asarray([1, 3]), jnp.asarray(seg),
                         jnp.asarray(target), 0.3)
    got = tl.joint_loss(tl.asymmetric_focal_loss, torch.from_numpy(logits[:2]),
                        torch.tensor([1, 3]), torch.from_numpy(seg),
                        torch.from_numpy(target), 0.3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for fn in (tl.bce_dice_loss, tl.joint_loss):
        with pytest.raises((TypeError, AttributeError)):
            fn(None, None)


# --- schedule and EMA ---------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 30), (0, 10), (3, 3)])
def test_lr_curve_matches_jax(warmup, total):
    np.testing.assert_allclose(tsched.lr_curve(1e-4, warmup, total, 1e-6),
                               jsched.lr_curve(1e-4, warmup, total, 1e-6),
                               rtol=1e-6)


def test_epoch_schedule_matches_jax_and_is_zero_in_warmup_epoch_0():
    want = jsched.make_epoch_schedule(3e-4, 2, 10, 1e-6, steps_per_epoch=7)
    got = tsched.make_epoch_schedule(3e-4, 2, 10, 1e-6, steps_per_epoch=7)
    for step in (0, 3, 6, 7, 13, 14, 40, 69, 100):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert all(got(s) == 0.0 for s in range(7))


def test_ema_is_a_copy_and_updates_as_jax():
    model = torch.nn.Linear(3, 4)
    shadow = tema.ema_init(model)
    assert all(shadow[n].data_ptr() != p.data_ptr()
               for n, p in model.named_parameters())
    before = {n: t.clone() for n, t in shadow.items()}
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    tema.ema_update(shadow, model, 0.9)
    want = jema.ema_update({n: jnp.asarray(t.numpy()) for n, t in before.items()},
                           {n: jnp.asarray(p.detach().numpy())
                            for n, p in model.named_parameters()}, 0.9)
    for n in shadow:
        np.testing.assert_allclose(shadow[n].numpy(), np.asarray(want[n]),
                                   atol=1e-6)


# --- mixing, at a given λ, permutation and box --------------------------------

def _images(b=6, h=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, h, 4)).astype(np.float32),
            rng.integers(0, 8, b))


def _patch_jax_random(monkeypatch, lam=None, perm=None, centre=None,
                      uniform=None):
    if lam is not None:
        monkeypatch.setattr(jax.random, "beta",
                            lambda *a, **k: jnp.float32(lam))
    if perm is not None:
        monkeypatch.setattr(jax.random, "permutation",
                            lambda *a, **k: jnp.asarray(perm))
    if centre is not None:
        it = iter(centre)
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.int32(next(it)))
    if uniform is not None:
        monkeypatch.setattr(jax.random, "uniform",
                            lambda *a, **k: jnp.float32(uniform))


def test_mixup_arithmetic_matches_jax(monkeypatch):
    x, y = _images()
    perm = np.array([3, 0, 5, 1, 4, 2])
    _patch_jax_random(monkeypatch, lam=0.3125, perm=perm)
    want = jmix.mixup(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), 0.4)
    got = tmix.mixup(torch.from_numpy(x), torch.from_numpy(y), 0.4, lam=0.3125,
                     perm=torch.from_numpy(perm))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[3] == float(want[3])


@pytest.mark.parametrize("lam0,cy,cx", [(0.6, 5, 9), (0.1, 0, 11), (0.99, 6, 6)])
def test_cutmix_box_and_arithmetic_match_jax(monkeypatch, lam0, cy, cx):
    x, y = _images(h=12, seed=1)
    perm = np.array([5, 4, 3, 2, 1, 0])
    _patch_jax_random(monkeypatch, lam=lam0, perm=perm, centre=(cy, cx))
    want = jmix.cutmix(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), 1.0)
    box = tmix.rand_bbox(12, 12, lam0, cy, cx)
    got = tmix.cutmix(torch.from_numpy(x), torch.from_numpy(y), 1.0,
                      perm=torch.from_numpy(perm), box=box)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3], float(want[3]), rtol=1e-6)


def test_mix_draws_come_from_the_given_generators():
    x, y = _images(seed=2)
    mix = tmix.make_mix_fn(tconfig.from_dict({}).augmentation)
    runs = []
    for _ in range(2):
        rng, g = np.random.default_rng(3), torch.Generator().manual_seed(3)
        runs.append([mix(torch.from_numpy(x), torch.from_numpy(y), rng=rng,
                         generator=g) for _ in range(4)])
    for a, b in zip(*runs):
        assert torch.equal(a[0], b[0]) and a[3] == b[3]
    assert len({r[3] for r in runs[0]}) > 1
    off = tconfig.from_dict({"augmentation": {"mixup": {"enabled": False},
                                              "cutmix": {"enabled": False}}})
    assert tmix.make_mix_fn(off.augmentation) is None


# --- train-mode layers ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7])
def test_batchnorm_train_mode_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 5)).astype(np.float32) * 3 + 1
    mean0 = rng.normal(size=5).astype(np.float32)
    var0 = (np.abs(rng.normal(size=5)) + 0.5).astype(np.float32)
    scale = rng.normal(size=5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = JaxBatchNorm().apply(variables, jnp.asarray(x),
                                     use_running_average=False,
                                     mutable=["batch_stats"])
    bn = TorchBatchNorm(5).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


@pytest.mark.parametrize("layer", [Dropout, DropPath])
def test_dropout_layers_take_the_callers_generator(layer):
    mod = layer(0.5)
    x = torch.ones(64, 3, 4)
    assert mod.eval()(x) is x
    mod.train()
    with pytest.raises(ValueError, match="generator"):
        mod(x)
    a = mod(x, torch.Generator().manual_seed(1))
    b = mod(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    if layer is DropPath:   # one decision per sample
        assert all(len(s.unique()) == 1 for s in a)


# --- LLRD and the optimizer -------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    raw = copy.deepcopy(TINY)
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
    # vit_tiny at 2 blocks while this module's tests run: the JAX step and
    # optimizer compile per block, and 12 blocks cost the suite minutes
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg)
        yield raw, jcfg, tcfg, jmodel, variables


def test_llrd_scale_of_every_leaf_matches_jax(tiny):
    _, _, tcfg, _, variables = tiny
    want = {_name(path): float(v) for path, v in
            _flatten(llrd_scale_tree(variables["params"], 0.75, 10.0)).items()}
    model = torch_model(tcfg, variables)
    got = llrd_scale_map((n for n, _ in model.named_parameters()), 0.75, 10.0)
    assert got.keys() == want.keys()
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, err_msg=n)
    assert got["backbone.cls_token"] == got["backbone.patch_embed.proj.weight"]
    assert got["backbone.norm.weight"] == 1.0
    assert got["metadata_branch.net.0.weight"] == 10.0


def _sd(params):
    return state_dict_from_jax({"params": params})


@pytest.mark.parametrize("mu_dtype,clip", [("float32", 1.0), ("bfloat16", 1.0),
                                           ("float32", 0.0)])
def test_optimizer_matches_optax_chain(tiny, mu_dtype, clip):
    raw = copy.deepcopy(tiny[0])
    raw["training"]["optimizer"]["mu_dtype"] = mu_dtype
    raw["training"]["grad_clip"] = clip
    jcfg, tcfg = jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)
    params = tiny[4]["params"]
    tx, _ = jax_build_optimizer(jcfg, params, steps_per_epoch=2)
    model = torch_model(tcfg, tiny[4])
    ttx, _ = build_optimizer(tcfg, model, steps_per_epoch=2)
    opt_state, tstate = tx.init(params), ttx.init(model)
    rng = np.random.default_rng(0)
    jparams = params

    @jax.jit
    def jax_update(grads, opt_state, jparams):
        updates, opt_state = tx.update(grads, opt_state, jparams)
        return optax.apply_updates(jparams, updates), opt_state

    for i in range(3):
        # gradients of global norm ~0.5 (clip idle) and ~50 (clip acting)
        size = 1e-3 if i == 1 else 1e-1
        grads = jax.tree.map(
            lambda p: (size * rng.normal(size=p.shape)).astype(np.float32),
            params)
        jparams, opt_state = jax_update(grads, opt_state, jparams)
        norm = ttx.step(model, {n: g for n, g in _sd(grads).items()}, tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-5)
    # a first moment stored in bf16 may round one bf16 ulp (up to 2^-7
    # relative) apart in the two frameworks, which moves each of the 3
    # updates by as much of lr·scale
    want = _sd(jparams)
    for n, p in model.named_parameters():
        atol = (1e-7 if mu_dtype == "float32"
                else 3 * 2.0 ** -7 * 1e-3 * ttx.scales[n])
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=atol, err_msg=n)
    assert tstate["count"] == 3
    assert all(m.dtype == getattr(torch, mu_dtype) for m in tstate["mu"].values())


# --- the whole step -----------------------------------------------------------------

# Biases that feed a BatchNorm in training mode: the batch mean cancels them,
# so their true gradient is 0 and both frameworks' gradients are rounding
# noise, which Adam turns into ±lr·scale steps of either sign. Only the bound
# on the largest difference holds for them.
ZERO_GRAD = {"metadata_branch.net.0.bias", "metadata_branch.net.4.bias"}


def _batches(n, b, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(b, 32, 32, 4)).astype(np.float32),
             "label": rng.integers(0, 8, b).astype(np.int32),
             "metadata": rng.random((b, 13)).astype(np.float32)}
            for _ in range(n)]


def _jax_state(jcfg, jmodel, variables, spe=10):
    tx, _ = jax_build_optimizer(jcfg, variables["params"], steps_per_epoch=spe)
    return JaxTrainState.create(jmodel.apply, variables["params"],
                                variables["batch_stats"], tx,
                                jax.random.key(0), ema_enabled=True)


def _torch_state(tcfg, variables, spe=10):
    model = torch_model(tcfg, variables)
    tx, _ = build_optimizer(tcfg, model, steps_per_epoch=spe)
    return TrainState.create(model, tx, seed=0)


def test_train_step_matches_jax_after_3_steps(tiny):
    _, jcfg, tcfg, jmodel, variables = tiny
    jstate = _jax_state(jcfg, jmodel, variables)
    jstep = jax_make_train_step(jcfg, jl.build_loss(jcfg), donate=False)
    tstate = _torch_state(tcfg, variables)
    tstep = make_train_step(tcfg, tl.build_loss(tcfg))
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
    want_ema = _sd(jstate.ema_params)
    got = tstate.model.state_dict()
    for n, p in tstate.model.named_parameters():
        tol = lr * scales[n]
        for mine, theirs in ((p.detach(), want[n]), (tstate.ema[n], want_ema[n])):
            diff = (mine - theirs).abs()
            assert float(diff.max()) <= 3 * 2 * tol, n
            if n in ZERO_GRAD:
                continue
            floor = 4 * 2.0 ** -24 * float(theirs.abs().max())   # fp32 ulps
            assert float(diff.median()) <= 1e-3 * tol + floor, n
    # BatchNorm statistics are taken from activations of parameters that
    # may differ as above: a running mean moves with the noisy bias before
    # its BatchNorm (ZERO_GRAD), 0.1·(2 + 4)·lr·scale apart at most after 3
    # steps; both statistics with the head's weights (rtol 1e-3 for their
    # ±2·lr·scale elements)
    head = tcfg.training.llrd.head_lr_mult
    for n in want:
        if "running" in n:
            atol = 1e-5 + (0.6 * lr * head if "running_mean" in n else 0.0)
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       atol=atol, rtol=1e-3, err_msg=n)
    assert tstate.eval_params()["backbone.cls_token"] is tstate.ema[
        "backbone.cls_token"]


@pytest.mark.parametrize("mix", ["cutmix", "mixup"])
def test_step_loss_with_mixing_matches_jax(tiny, monkeypatch, mix):
    raw, _, _, jmodel, variables = tiny
    raw = copy.deepcopy(raw)
    raw["augmentation"] = {"mixup": {"enabled": True, "alpha": 0.4},
                           "cutmix": {"enabled": True, "alpha": 1.0,
                                      "prob": 0.5}}
    jcfg, tcfg = jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)
    perm = np.array([2, 3, 1, 0])
    lam, centre = 0.375, (9, 20)
    _patch_jax_random(monkeypatch, lam=lam, perm=perm, centre=centre,
                      uniform=0.25 if mix == "cutmix" else 0.75)
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


def test_step_refuses_what_is_not_ported(tiny):
    tcfg = tiny[2]
    # the train augment is ported (tests/test_torch_loop.py runs it fused)
    augment = lambda batch, generator: batch   # noqa: E731
    assert make_train_step(tcfg, tl.build_loss(tcfg),
                           augment=augment).augment is augment
    # and so is model.remat: the model built with it takes a step
    remat = tcfg.replace(model=tcfg.model.__class__(
        **{**tcfg.model.__dict__, "remat": True}))
    state = _torch_state(remat, tiny[4])
    state, metrics = make_train_step(remat, tl.build_loss(remat))(
        state, _batches(1, 8, seed=6)[0])
    assert np.isfinite(float(metrics["loss"])) and state.step == 1


def test_eval_step_after_a_train_step_is_deterministic(tiny):
    """The fold trainer evaluates between steps: the eval step must run the
    model in evaluation mode (no dropout, running statistics untouched),
    as the JAX eval step's ``deterministic=True``, whatever mode the train
    step left it in."""
    from fedvit_torch.eval.serve import make_eval_step
    raw = copy.deepcopy(tiny[0])
    raw["model"]["metadata"]["dropout"] = 0.4
    raw["model"]["classifier"] = {"dropout": 0.5}
    tcfg = tconfig.from_dict(raw)
    state = _torch_state(tcfg, tiny[4])
    batch = _batches(1, 8, seed=5)[0]
    state, _ = make_train_step(tcfg, tl.build_loss(tcfg))(state, batch)
    assert state.model.training
    stats = {n: t.clone() for n, t in state.model.named_buffers()}
    eval_step = make_eval_step(state.model, tcfg)
    a, b = eval_step(batch), eval_step(batch)
    assert torch.equal(a, b) and not state.model.training
    assert all(torch.equal(t, stats[n])
               for n, t in state.model.named_buffers())


def test_warmup_epoch_0_moves_nothing(tiny):
    raw = copy.deepcopy(tiny[0])
    raw["training"]["scheduler"]["warmup_epochs"] = 2
    tcfg = tconfig.from_dict(raw)
    state = _torch_state(tcfg, tiny[4])
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, m = make_train_step(tcfg, tl.build_loss(tcfg))(state, _batches(1, 8)[0])
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert all(torch.equal(p, before[n])
               for n, p in state.model.named_parameters())
