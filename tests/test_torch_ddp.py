"""The port's data-parallel fold (``training.data_parallel``) on the CPU, at
world 2 under gloo (``tests/torch_dist.py``), fp32, ``vit_tiny`` cut to 2
blocks at ``image_size`` 32.

The DP step holds the port's single-device step on one seeded model and
macro batch, with every draw and cross-row term on: accumulation 2, drop
path 0.1, the classifier's and the metadata branch's dropout, MixUp and
CutMix, the metadata branch's BatchNorm and class-weighted, label-smoothed
cross-entropy. Tolerances, with their reasons:

- the loss rtol 1e-6: the two sum the same terms in another order (each
  rank's share, then the all-reduce);
- each gradient leaf within 3e-5 of its RMS, absolute, elementwise: the
  same sums over rows and tokens in another order (per rank, then the
  all-reduce); a weight's gradient sums 2 · 34 row-token products here,
  and its largest element moves by up to 1.1e-5 of the leaf's RMS (the
  attention's qkv weight; measured at one thread), so 3e-5 is three times
  that noise and far below the control's error (the leaves next to the
  metadata BatchNorm: 1e-5 of the branch's largest gradient, ``BN_FED``
  says why); the BatchNorm running statistics rtol 1e-6;
- the two ranks after 2 steps: bit-equal (parameters, statistics, both
  generators), since every rank applies the same all-reduced gradient and
  draws at the whole micro-batch's shape.

The control leaves the gradient all-reduce out: each rank's gradient is then
its rows' share alone and misses the leaf gate by far.

The DP fold is held to JAX's ``train_fold`` with ``data_parallel`` on its 8
CPU devices (and JAX's DP fold to JAX's single-device fold), on
``test_torch_loop.py``'s deterministic augment, from JAX's init: the
validation loss rtol 1e-4 and the test logits atol 1e-4, that file's
tolerances and reasons (fp32 sums in another order, Adam's ±lr on
gradients within rounding of 0, lr 1e-4, 8 steps).
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.data import pipeline as jpipe
from fedvit_tpu.train import loop as jloop
from fedvit_tpu.train.state import TrainState as JaxTrainState

from fedvit_torch.cli import train as train_cli
from tests import torch_dist
from tests.test_torch_cli_train import _config, _tree
from tests.test_torch_loop import _data, _jax_variables, _raw
from tests.torch_parity import TINY, shallow_vit


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step_raw(batch_size, accum=2):
    raw = copy.deepcopy(TINY)
    raw["model"]["drop_path_rate"] = 0.1
    raw["model"]["classifier"] = {"dropout": 0.5}
    raw["training"].update({"batch_size": batch_size,
                            "gradient_accumulation_steps": accum,
                            "optimizer": {"lr": 1e-4},
                            "scheduler": {"warmup_epochs": 0}})
    raw["loss"] = {"type": "ce", "class_weights": True,
                   "label_smoothing": 0.1}
    raw["augmentation"] = {"mixup": {"enabled": True, "alpha": 0.4},
                           "cutmix": {"enabled": True, "alpha": 1.0,
                                      "prob": 0.5}}
    return raw


def _batches(n, count=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(n, 32, 32, 4)).astype(np.float32),
             "label": rng.integers(0, 8, n).astype(np.int64),
             "metadata": rng.random((n, 13)).astype(np.float32)}
            for _ in range(count)]


CLASS_WEIGHTS = np.linspace(0.5, 2.0, 8).astype(np.float32)


# The metadata branch's layers around its BatchNorm: BatchNorm's backward
# subtracts the micro-batch's mean gradient, a sum that the ranks take in
# pieces, and the cancellation leaves these leaves with rounding noise of that
# sum's size, not of their own (the biases feeding it have a gradient of 0 in
# exact arithmetic). They are held to 1e-5 of the branch's largest gradient.
BN_FED = ("metadata_branch.net.0.", "metadata_branch.net.1.",
          "metadata_branch.net.4.")


def _leaf_gate(got, want):
    """The names of the leaves of ``got`` off ``want`` by more than 3e-5 of
    the leaf's RMS (``BN_FED``: 1e-5 of the branch's largest element)."""
    branch = max(float(np.max(np.abs(w))) for n, w in want.items()
                 if n.startswith(BN_FED))
    bad = []
    for name, w in want.items():
        bound = 1e-5 * branch if name.startswith(BN_FED) else 3e-5 * float(
            np.sqrt(np.mean(np.square(w, dtype=np.float64))))
        if np.max(np.abs(got[name] - w)) > bound:
            bad.append(name)
    return bad


@pytest.mark.parametrize("batch_size", [4, 3, 1],
                         ids=["even", "uneven", "empty-piece"])
def test_dp_step_matches_single_device(batch_size, tmp_path):
    """Micro-batches of 4 (2 + 2 rows), 3 (2 + 1) and 1 (rank 1 holds no
    row and runs one it counts nowhere)."""
    raw = _step_raw(batch_size)
    batches = _batches(2 * batch_size)
    want = torch_dist.steps(raw, batches, CLASS_WEIGHTS, data=False)
    got = torch_dist.run_world(torch_dist.steps, 2, tmp_path, raw, batches,
                               CLASS_WEIGHTS, True)
    for rank in got:
        np.testing.assert_allclose(rank["loss0"], want["loss0"], rtol=1e-6)
        assert not _leaf_gate(rank["grads0"], want["grads0"])
        for name, w in want["stats0"].items():
            np.testing.assert_allclose(rank["stats0"][name], w, rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    a, b = got
    for name, value in a["params"].items():
        np.testing.assert_array_equal(value, b["params"][name], err_msg=name)
    np.testing.assert_array_equal(a["generator"], b["generator"])
    np.testing.assert_array_equal(a["generator"], want["generator"])
    assert a["np_rng"] == b["np_rng"] == want["np_rng"]
    assert a["losses"] == b["losses"] and a["norms"] == b["norms"]


def test_dp_step_without_the_gradient_reduce_fails(tmp_path):
    raw = _step_raw(4)
    batches = _batches(8, count=1)
    want = torch_dist.steps(raw, batches, CLASS_WEIGHTS, data=False)
    got = torch_dist.run_world(torch_dist.steps, 2, tmp_path, raw, batches,
                               CLASS_WEIGHTS, True, False)
    for rank in got:
        assert len(_leaf_gate(rank["grads0"], want["grads0"])) > \
            len(want["grads0"]) // 2


# --- the fold ------------------------------------------------------------------

def _fold_raw(**training):
    raw = _raw(data_parallel=True, **training)
    return raw


def _jax_fold(raw, train, val, test, variables_box, **kw):
    jcfg = jconfig.from_dict(copy.deepcopy(raw))

    def jax_init(cfg, tx, rng_seed=0, ema_enabled=None):
        model, variables = _jax_variables(cfg, rng_seed)
        variables_box["variables"] = variables
        state = JaxTrainState.create(
            model.apply, variables["params"], variables["batch_stats"], tx,
            jax.random.key(rng_seed + 1), ema_enabled=cfg.training.ema.enabled)
        return model, state

    evals = []
    evaluate = jloop._evaluate

    def recording(*a, **k):
        out = evaluate(*a, **k)
        evals.append(out)
        return out

    init = jloop.init_model_state
    jloop.init_model_state, jloop._evaluate = jax_init, recording
    try:
        result = jloop.train_fold(jcfg, 0, *(jpipe.ArrayDataSource(d)
                                             for d in (train, val, test)),
                                  log=lambda s: None, **kw)
    finally:
        jloop.init_model_state, jloop._evaluate = init, evaluate
    return result, evals


def test_dp_fold_matches_jax_dp_fold(tmp_path):
    """JAX's DP fold over its 8 CPU devices (macro batch 8, a row each)
    against JAX's single-device fold, then the port's at world 2."""
    train, val, test = _data(32, 0), _data(12, 1), _data(10, 2)
    box = {}
    with shallow_vit():
        want, jevals = _jax_fold(_fold_raw(), train, val, test, box)
        single, sevals = _jax_fold(_raw(), train, val, test, {})
    assert len(jax.devices()) == 8
    for j, s in zip(jevals, sevals):
        np.testing.assert_allclose(j["loss"], s["loss"], rtol=1e-4)
    np.testing.assert_allclose(want.logits, single.logits, atol=1e-4, rtol=0)

    sd = {k: v.numpy() for k, v in state_dict_from_jax(
        box["variables"]).items()}
    data = {"train": train, "val": val, "test": test}
    got = torch_dist.run_world(torch_dist.fold, 2, tmp_path, _fold_raw(), sd,
                               data, str(tmp_path / "fold"))
    for rank in got:
        assert len(rank["evals"]) == len(jevals) == 3
        for t, j in zip(rank["evals"], jevals):
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
            assert t["accuracy"] == j["accuracy"]
        np.testing.assert_allclose(rank["logits"], want.logits, atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(got[0]["logits"], got[1]["logits"])
    assert any("Data-parallel: batch sharded over 2 devices" in line
               for line in got[0]["log"])


def test_dp_fold_refuses_a_batch_the_ranks_do_not_divide(tmp_path):
    """JAX's refusal and its message: macro batch 3 over 2 ranks."""
    raw = _fold_raw(batch_size=3, gradient_accumulation_steps=1)
    data = {"train": _data(12, 0), "val": _data(4, 1), "test": None}
    got = torch_dist.run_world(torch_dist.fold_refusal, 2, tmp_path, raw,
                               data)
    assert got == ["batch 3 not divisible by 2 data-parallel devices"] * 2


def test_dp_fold_rank_zero_writes_and_both_ranks_resume(tmp_path):
    """Rank 0 alone writes the checkpoints, rank 1 logs nothing; a resumed
    third epoch loads on both ranks, and they end bit-equal."""
    data = {"train": _data(32, 0), "val": _data(12, 1), "test": _data(10, 2)}
    workdir = str(tmp_path / "fold")
    sd = None
    first = torch_dist.run_world(torch_dist.fold, 2, tmp_path, _fold_raw(),
                                 sd, data, workdir)
    assert first[0]["writes"] and not first[1]["writes"]
    assert first[0]["log"] and not first[1]["log"]
    meta = json.loads((tmp_path / "fold" / "resume_fold0" / "meta.json")
                      .read_text())
    assert meta["epoch"] == 2
    again = torch_dist.run_world(torch_dist.fold, 2, tmp_path,
                                 _fold_raw(epochs=3), sd, data, workdir,
                                 True)
    for rank in again:
        assert any(p.endswith("resume_fold0") for p in rank["loads"])
        assert len(rank["evals"]) == 2              # epoch 3, then the test
    assert any("Resumed from epoch 2" in line for line in again[0]["log"])
    np.testing.assert_array_equal(again[0]["logits"], again[1]["logits"])


def test_cli_train_over_two_ranks(tmp_path):
    """``cli.train --fold 0 --device cpu`` with ``training.data_parallel``
    in a world of 2 (as under torchrun) against the same command on one
    process: the ensemble logits at the fold's tolerance (atol 1e-4); rank
    0 alone prints and writes."""
    root = _tree(tmp_path)
    config = _config(tmp_path, root, data_parallel=True)
    argv = ["--config", config, "--fold", "0", "--device", "cpu"]
    with torch_dist.shallow():
        assert train_cli.main(argv + ["--log", str(tmp_path / "one")]) == 0
    want = np.load(tmp_path / "one" / "ensemble_logits.npy")
    got = torch_dist.run_world(torch_dist.cli, 2, tmp_path, "train",
                               argv + ["--log", str(tmp_path / "two")])
    assert [r["rc"] for r in got] == [0, 0]
    assert got[0]["stdout"] and not got[1]["stdout"]
    assert any("Data-parallel: batch sharded over 2 devices" in line
               for line in got[0]["stdout"])
    np.testing.assert_allclose(
        np.load(tmp_path / "two" / "ensemble_logits.npy"), want, atol=1e-4,
        rtol=0)
    assert (tmp_path / "two" / "fold0" / "best_fold0" / "state.pt").exists()


def test_probe_takes_the_least_batch_size_of_the_ranks(tmp_path):
    """Rank 0's forward fits 14 rows, rank 1's 10: both train at 10."""
    got = torch_dist.run_world(torch_dist.probe, 2, tmp_path, _raw(),
                               [14, 10])
    assert got == [10, 10]
