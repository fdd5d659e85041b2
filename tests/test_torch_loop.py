"""The port's fold trainer and what it calls — data sources, checkpoints,
EMA-swapped validation, the two-stage schedule, the batch-size probe —
against the JAX package's, on the CPU, fp32.

The fold-level parity test makes both packages deterministic: RandomResized
Crop with scale and ratio (1, 1) (the whole canvas, resized), no flips,
rotation, jitter or RandAugment, no MixUp/CutMix, dropout and drop-path 0,
no TTA. Both start from the same weights (JAX's init for seed + fold, loaded
into the port through ``state_dict_from_jax``) and draw the same numpy batch
plans. ``vit_tiny_patch16_224`` is cut to 2 blocks for the length of that
test (both registries' ``VIT_CONFIGS``) and JAX's init is jitted: a 12-block
fold costs ~45 s of XLA compiles on the CPU, eager init included, which the
suite's clock cannot carry.

Tolerances, with their reasons:

- validation and test accuracy, balanced accuracy and macro F1: equal (the
  argmax of logits that agree to ~1e-5 does not flip on these seeds);
  validation loss rtol 1e-4 (fp32 sums in other orders through 8 steps);
- test logits atol 1e-4: the two trajectories differ by Adam's rounding —
  each update is ±lr·scale whatever the gradient's size, so a gradient within
  rounding of 0 can take the other sign (lr 1e-4 keeps that below 1e-4 of
  the logits after 8 steps);
- the head optimizer against the optax chain, 3 updates: 1e-7 (fp32 Adam in
  another order on parameters of size ~1, lr 1e-3);
- everything the port alone computes (checkpoints, sources, sampler plans,
  the EMA swap): exact.
"""

import copy
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.data import pipeline as tpipe
from fedvit_torch.data.sampling import epoch_indices
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_torch.train import checkpoint as tckpt
from fedvit_torch.train import loop as tloop
from fedvit_torch.train import optim as toptim
from fedvit_torch.train.losses import build_loss
from fedvit_torch.train.probe import auto_batch_size
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.data import pipeline as jpipe
from fedvit_tpu.models import build_model as jax_build_model
from fedvit_tpu.train import loop as jloop
from fedvit_tpu.train import optim as joptim
from fedvit_tpu.train.state import TrainState as JaxTrainState

from tests.torch_parity import TINY, shallow_vit, torch_model


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one torch thread: these ops are small, and the suite
    runs one process per core, where torch's thread pool would only wait on
    the other processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def shallow():
    """vit_tiny cut to 2 blocks in both packages, for this test only."""
    with shallow_vit():
        yield


def _raw(**training):
    raw = copy.deepcopy(TINY)
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["model"]["classifier"] = {"dropout": 0.0}
    raw["training"].update({"batch_size": 4, "gradient_accumulation_steps": 2,
                            "epochs": 2, "optimizer": {"lr": 1e-4},
                            "scheduler": {"warmup_epochs": 0},
                            "ema": {"decay": 0.9}, "tta": {"enabled": False}})
    raw["training"].update(training)
    raw["augmentation"] = {
        "mixup": {"enabled": False}, "cutmix": {"enabled": False},
        "train": {"random_resized_crop": {"scale": [1.0, 1.0],
                                          "ratio": [1.0, 1.0]},
                  "horizontal_flip": False, "vertical_flip": False,
                  "rotation": 0.0,
                  "color_jitter": {"brightness": 0.0, "contrast": 0.0,
                                   "saturation": 0.0, "hue": 0.0},
                  "randaugment": {"enabled": False}}}
    return raw


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, 48, 48, 4), dtype=np.uint8),
            "label": rng.integers(0, 8, n).astype(np.int32),
            "metadata": rng.random((n, 13)).astype(np.float32)}


def _jax_variables(jcfg, seed):
    """JAX's init of the ISICClassifier for ``seed``, jitted."""
    model = jax_build_model(jcfg)
    s = jcfg.model.image_size
    x = jnp.zeros((2, s, s, jcfg.in_channels), jnp.float32)
    meta = jnp.zeros((2, 13), jnp.float32)
    init = jax.jit(lambda r: model.init({"params": r, "dropout": r}, x, meta))
    return model, jax.device_get(init(jax.random.key(seed)))


def _recording(fn, into):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append(out)
        return out
    return wrapped


def _best_epochs(lines):
    epoch, best = None, []
    for line in lines:
        m = re.match(r"  E(\d+) \|", line)
        if m:
            epoch = int(m.group(1))
        if ">>> New best" in line:
            best.append(epoch)
    return best


def test_train_fold_matches_jax(shallow, monkeypatch, tmp_path):
    raw = _raw()
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    train, val, test = _data(32, 0), _data(12, 1), _data(10, 2)
    inits = {}

    def jax_init(cfg, tx, rng_seed=0, ema_enabled=None):
        model, variables = _jax_variables(cfg, rng_seed)
        inits["variables"] = variables
        state = JaxTrainState.create(
            model.apply, variables["params"], variables["batch_stats"], tx,
            jax.random.key(rng_seed + 1), ema_enabled=cfg.training.ema.enabled)
        return model, state

    monkeypatch.setattr(jloop, "init_model_state", jax_init)
    jevals, tevals = [], []
    monkeypatch.setattr(jloop, "_evaluate", _recording(jloop._evaluate, jevals))
    monkeypatch.setattr(tloop, "_evaluate", _recording(tloop._evaluate, tevals))
    jlog, tlog = [], []
    want = jloop.train_fold(jcfg, 0, *(jpipe.ArrayDataSource(d)
                                       for d in (train, val, test)),
                            log=jlog.append)
    monkeypatch.setattr(tloop, "build_model", lambda cfg, device, generator:
                        torch_model(cfg, inits["variables"]))
    got = tloop.train_fold(tcfg, 0, *(tpipe.ArrayDataSource(d)
                                      for d in (train, val, test)),
                           workdir=str(tmp_path), log=tlog.append, device="cpu")

    assert len(jevals) == len(tevals) == 3            # 2 validations, 1 test
    for j, t in zip(jevals, tevals):
        for key in ("accuracy", "balanced_accuracy", "macro_f1"):
            assert t[key] == j[key], key
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    best = _best_epochs(jlog)
    assert best and _best_epochs(tlog) == best
    meta = json.loads((tmp_path / "best_fold0" / "meta.json").read_text())
    assert meta["epoch"] == best[-1]
    assert json.loads((tmp_path / "resume_fold0" / "meta.json").read_text()
                      )["epoch"] == 2
    assert got.logits.shape == want.logits.shape == (10, 8)
    np.testing.assert_allclose(got.logits, want.logits, atol=1e-4, rtol=0)
    for key in ("accuracy", "balanced_accuracy", "macro_f1"):
        assert got.metrics[key] == want.metrics[key]


# --- checkpoints and resume -------------------------------------------------------------

def _state(tcfg, seed):
    model = tloop.build_model(tcfg, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    tx, _ = toptim.build_optimizer(tcfg, model, steps_per_epoch=4)
    return TrainState.create(model, tx, seed, ema_enabled=True)


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, 32, 32, 4)).astype(np.float32),
            "label": rng.integers(0, 8, n).astype(np.int32),
            "metadata": rng.random((n, 13)).astype(np.float32)}


def test_checkpoint_restores_every_tensor_and_both_generators(shallow, tmp_path):
    tcfg = tconfig.from_dict(_raw())
    state = _state(tcfg, 0)
    state, _ = make_train_step(tcfg, build_loss(tcfg))(state, _batch())
    tckpt.save_checkpoint(str(tmp_path / "c"), state, 3, 0.25, 2, tcfg)
    fresh = _state(tcfg, 1)
    meta = tckpt.load_checkpoint(str(tmp_path / "c"), fresh)
    assert meta["state"] is fresh and tckpt.checkpoint_exists(str(tmp_path / "c"))
    assert (meta["epoch"], meta["best_metric"], meta["epochs_without_improve"]) \
        == (3, 0.25, 2)
    assert tconfig.from_dict(meta["config"]) == tcfg
    for name, t in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], t), name
    for part in ("mu", "nu"):
        for name, t in state.opt_state[part].items():
            assert torch.equal(fresh.opt_state[part][name], t), name
    assert fresh.opt_state["count"] == state.opt_state["count"] == 1
    for name, t in state.ema.items():
        assert torch.equal(fresh.ema[name], t), name
    assert fresh.step == state.step == 1
    assert torch.equal(torch.rand(5, generator=fresh.generator),
                       torch.rand(5, generator=state.generator))
    assert fresh.np_rng.random() == state.np_rng.random()


def test_load_pretrained_refuses_another_model(shallow, tmp_path):
    tcfg = tconfig.from_dict(_raw())
    model = _state(tcfg, 0).model
    tckpt.save_pretrained(str(tmp_path / "p"), model, tcfg, source="test")
    assert tckpt.pretrained_exists(str(tmp_path / "p"))
    other = _state(tcfg, 1).model
    tckpt.load_pretrained(str(tmp_path / "p"), other, tcfg)
    for name, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[name], t), name
    for change in ({"image_size": 64}, {"backbone": "vit_small_patch16_224"}):
        cfg = tcfg.replace(model=tcfg.model.__class__(
            **{**tcfg.model.__dict__, **change}))
        with pytest.raises(ValueError, match=next(iter(change))):
            tckpt.load_pretrained(str(tmp_path / "p"), other, cfg)
    three = tcfg.replace(data=tcfg.data.__class__(
        **{**tcfg.data.__dict__, "use_segmentation_mask": False}))
    with pytest.raises(ValueError, match="in_channels"):
        tckpt.load_pretrained(str(tmp_path / "p"), other, three)


class _Recording(tpipe.ArrayDataSource):
    """An ArrayDataSource that keeps the index rows it gathers."""

    def __init__(self, data):
        super().__init__(data)
        self.rows = []

    def gather(self, indices):
        self.rows.append(np.asarray(indices).tolist())
        return super().gather(indices)


def test_resume_follows_jax(shallow, monkeypatch, tmp_path):
    """JAX's train_fold makes its plan generator afresh before the epoch loop
    whatever epoch it starts at (loop.py:336): a run resumed after epoch 2
    trains epoch 3 on the plan of epoch 1. The port does the same. Between
    epochs, validation on the EMA shadow leaves the trained weights in the
    model: epoch 2 starts from the weights epoch 1 ended with."""
    tcfg = tconfig.from_dict(_raw())
    seams = []

    def epoch(step, state, *args):
        seams.append({n: p.detach().clone()
                      for n, p in state.model.named_parameters()})
        state, loss = train_epoch(step, state, *args)
        seams.append({n: p.detach().clone()
                      for n, p in state.model.named_parameters()})
        return state, loss

    train_epoch = tloop._train_epoch
    monkeypatch.setattr(tloop, "_train_epoch", epoch)
    train, val = _Recording(_data(16, 3)), tpipe.ArrayDataSource(_data(8, 4))
    first = []
    tloop.train_fold(tcfg, 0, train, val, workdir=str(tmp_path),
                     log=first.append, device="cpu")
    plans = [train.rows[:2], train.rows[2:4]]               # 2 steps an epoch
    assert all(torch.equal(seams[1][n], seams[2][n]) for n in seams[1])
    assert plans[0] != plans[1]

    train.rows.clear()
    resumed = []
    more = tconfig.from_dict(_raw(epochs=3))
    tloop.train_fold(more, 0, train, val, workdir=str(tmp_path),
                     log=resumed.append, resume=True, device="cpu")
    assert any("Resumed from epoch 2" in line for line in resumed)
    assert [line[:5] for line in resumed if re.match(r"  E\d+ \|", line)] \
        == ["  E03"]
    assert train.rows == plans[0]
    rng = np.random.default_rng(tcfg.seed)
    uninterrupted = [epoch_indices(train.labels, 8, rng, True).tolist()
                     for _ in range(3)][2]
    assert train.rows != uninterrupted
    # the resumed epoch starts from the saved state, bit for bit
    assert all(torch.equal(seams[4][n], seams[3][n]) for n in seams[3])


def test_fused_augment_draws_from_the_states_generator(shallow):
    """make_train_step(augment=...) takes raw uint8 canvases and augments
    them with draws from the state's generator: two states of one seed take
    the same step, and the augment's draws move the generator on."""
    raw = _raw()
    raw["augmentation"]["train"] = {}                  # the default recipe
    tcfg = tconfig.from_dict(raw)
    step = make_train_step(tcfg, build_loss(tcfg),
                           tpipe.make_device_augment(tcfg, train=True))
    batch = _data(8, 10)
    a, b = _state(tcfg, 0), _state(tcfg, 0)
    untouched = a.generator.get_state()
    (a, ma), (b, mb) = step(a, batch), step(b, batch)
    assert torch.equal(ma["loss"], mb["loss"]) and bool(torch.isfinite(ma["loss"]))
    assert not torch.equal(a.generator.get_state(), untouched)


def test_batch_generator_depends_on_base_and_index_only():
    draws = [torch.rand(3, generator=tloop.batch_generator(b, i, "cpu"))
             for b, i in ((42003, 0), (42003, 0), (42003, 1), (42004, 0))]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[3])


# --- EMA-swapped validation -------------------------------------------------------

def test_ema_swap_evaluates_the_shadow_and_restores_the_weights(shallow):
    from fedvit_torch.eval.serve import make_eval_step
    tcfg = tconfig.from_dict(_raw())
    step = make_train_step(tcfg, build_loss(tcfg))
    state, _ = step(_state(tcfg, 0), _batch(seed=1))
    twin, _ = step(_state(tcfg, 0), _batch(seed=1))
    trained = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    assert any(not torch.equal(trained[n], state.ema[n]) for n in trained)
    eval_step = make_eval_step(state.model, tcfg)
    batch = _batch(4, seed=2)
    with state.ema_weights() as model:
        for n, p in model.named_parameters():
            assert torch.equal(p, state.ema[n]), n
        inside = eval_step(batch)
    shadow = copy.deepcopy(state.model)
    shadow.load_state_dict({**state.model.state_dict(), **state.ema})
    assert torch.equal(inside, make_eval_step(shadow, tcfg)(batch))
    for n, p in state.model.named_parameters():
        assert torch.equal(p, trained[n]), n
    # the next step sees the trained weights: as a twin never evaluated
    state, m = step(state, _batch(seed=3))
    twin, tm = step(twin, _batch(seed=3))
    assert torch.equal(m["loss"], tm["loss"])
    for (n, p), q in zip(state.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p, q), n


# --- two-stage ------------------------------------------------------------------------

def test_two_stage_freezes_the_backbone_then_restarts_the_ema(shallow,
                                                              monkeypatch):
    tcfg = tconfig.from_dict(_raw(epochs=1, two_stage={
        "enabled": True, "stage1_epochs": 1, "stage1_lr": 1e-3}))
    calls = []

    def epoch(step, state, *args):
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        ema = None if state.ema is None else {n: t.clone()
                                              for n, t in state.ema.items()}
        calls.append((state, before, ema, state.step))
        return train_epoch(step, state, *args)

    train_epoch = tloop._train_epoch
    monkeypatch.setattr(tloop, "_train_epoch", epoch)
    tloop.train_fold(tcfg, 0, tpipe.ArrayDataSource(_data(16, 5)),
                     tpipe.ArrayDataSource(_data(8, 6)), log=lambda s: None,
                     device="cpu")
    (head, before1, ema1, _), (main, before2, ema2, step2) = calls
    assert head is not main and ema1 is None and head.step == 2
    for n in before1:
        moved = not torch.equal(before1[n], before2[n])
        assert moved == (not n.startswith("backbone.")), n
    assert step2 == 0 and ema2.keys() == before2.keys()
    assert all(torch.equal(ema2[n], before2[n]) for n in before2)


def test_head_optimizer_matches_optax(shallow):
    raw = _raw(optimizer={"lr": 1e-3, "weight_decay": 1e-2})
    jcfg, tcfg = jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)
    _, variables = _jax_variables(jcfg, 0)
    params = variables["params"]
    tx = joptim.build_head_optimizer(jcfg, params, 1e-3)
    model = torch_model(tcfg, variables)
    ttx = toptim.build_head_optimizer(tcfg, model, 1e-3)
    opt_state, tstate = tx.init(params), ttx.init(model)
    assert set(tstate["nu"]) == {n for n, keep in
                                 toptim.head_only_mask(model).items() if keep}
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u),
                                                     s2))(*tx.update(g, s, p)))
    rng = np.random.default_rng(0)
    for i in range(3):
        size = 1e-3 if i == 1 else 1.0       # the clip idle, then acting
        grads = jax.tree.map(lambda p: (size * rng.normal(size=p.shape)
                                        ).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        tgrads = dict(state_dict_from_jax({"params": grads}))
        norm = ttx.step(model, tgrads, tstate)
        head = [tgrads[n].numpy() for n in tstate["nu"]]   # the leaves it clips
        np.testing.assert_allclose(float(norm), float(optax.global_norm(head)),
                                   rtol=1e-5)
    want = state_dict_from_jax({"params": params})
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-7, rtol=0, err_msg=n)
    assert not n.startswith("backbone.") or torch.equal(
        p, state_dict_from_jax({"params": variables["params"]})[n])


# --- the probe ---------------------------------------------------------------------------

def test_probe_backs_off_on_out_of_memory(shallow, monkeypatch):
    tcfg = tconfig.from_dict(_raw())
    model = _state(tcfg, 0).model
    forward = model.forward
    seen = []

    def limited(x, meta=None, *args, **kwargs):
        seen.append(x.shape[0])
        if x.shape[0] >= 14:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return forward(x, meta, *args, **kwargs)

    monkeypatch.setattr(model, "forward", limited)
    logs = []
    assert auto_batch_size(tcfg, model, log=logs.append) == 12
    assert seen == [8, 10, 12, 14] and logs[-1].endswith("= 12")

    def broken(x, meta=None, *args, **kwargs):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(model, "forward", broken)
    with pytest.raises(RuntimeError, match="not a memory"):
        auto_batch_size(tcfg, model, log=logs.append)


# --- data sources ---------------------------------------------------------------------------

def test_device_source_gathers_what_the_host_source_gathers():
    tcfg = tconfig.from_dict(_raw())
    data = _data(11, 7)
    host = tpipe.ArrayDataSource(data)
    assert tpipe.maybe_device_resident(host, tcfg, "cpu") is host
    dev = tpipe.DeviceDataSource(host, "cpu")
    a = list(host.epoch_batches(4, np.random.default_rng(1), True))
    b = list(dev.epoch_batches(4, np.random.default_rng(1), True))
    assert len(a) == len(b) == 2
    for x, y in zip(a + list(host.sequential_batches(4)),
                    b + list(dev.sequential_batches(4))):
        for k in ("image", "label", "metadata"):
            np.testing.assert_array_equal(y[k].numpy(), x[k])
    assert tpipe.DeviceDataSource.nbytes_estimate(host) == data["image"].nbytes


def test_host_source_honours_cache_gb_and_prefetch(tmp_path):
    from PIL import Image
    import pandas as pd
    rng = np.random.default_rng(8)
    paths = []
    for i in range(6):
        p = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    df = pd.DataFrame({"image_path": paths, "label": [0, 1, 2, 0, 1, 2]})
    per = 48 * 48 * 3                      # one 48² RGB canvas (image_size 32)
    raw = _raw()
    raw["data"] = {"use_segmentation_mask": False, "cache_gb": 2.5 * per / 2 ** 30,
                   "prefetch_batches": 2}
    src = tpipe.HostDataSource(df, tconfig.from_dict(raw))
    assert isinstance(src._cache, tpipe._ByteLRU)
    batches = list(src.epoch_batches(2, np.random.default_rng(0), False))
    plan = epoch_indices(src.labels, 2, np.random.default_rng(0), False)
    assert len(batches) == 3
    for b, row in zip(batches, plan):
        np.testing.assert_array_equal(b["image"], src.gather(row)["image"])
        np.testing.assert_array_equal(b["label"], src.labels[row])
    assert src._cache.used <= 2.5 * per and len(src._cache._d) == 2
    seq = list(src.sequential_batches(4))
    assert [len(b["label"]) for b in seq] == [4, 2]
    with pytest.raises(ZeroDivisionError):
        list(tpipe.prefetch_iterator((1 / x for x in (1, 0)), 2))


# --- the K-fold runner's ensemble ----------------------------------------------------------

def test_ensemble_and_aggregate_match_jax():
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 8, 20)
    logits = [rng.normal(size=(20, 8)).astype(np.float32) for _ in range(3)]
    tres = [tloop.FoldResult(l, tloop._softmax(l)) for l in logits]
    jres = [jloop.FoldResult(l, jloop._softmax(l)) for l in logits]
    tres.append(tloop.FoldResult(np.zeros((0, 8)), np.zeros((0, 8))))
    got = {**tloop.aggregate_fold_metrics(tres, labels, 8, lambda s: None),
           **tloop.ensemble_folds(tres, labels, 8, lambda s: None)}
    want = {**jloop.aggregate_fold_metrics(jres, labels, 8, lambda s: None),
            **jloop.ensemble_folds(jres, labels, 8, lambda s: None)}
    assert got["aggregate"] == want["aggregate"] and got["n_folds"] == 3
    np.testing.assert_array_equal(got["ensemble_logits"], want["ensemble_logits"])
    for k in ("accuracy", "balanced_accuracy", "macro_f1", "auroc"):
        assert got["ensemble_metrics"][k] == pytest.approx(
            want["ensemble_metrics"][k], rel=1e-12)
    assert tloop.ensemble_folds(tres[3:], labels, 8) == {}
