"""The port's federated server on its own, on the CPU: resume, its refusals,
the checkpoint's crash windows, what ``train_federated`` leaves alone, and
the CLI. ``vit_tiny`` cut to 2 blocks at ``image_size`` 32, fp32, with the
train augment, MixUp/CutMix, dropout and partial participation on, so that
every generator matters. Everything is the port against itself: exact."""

import copy
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from fedvit_torch.cli import train_federated as cli
from fedvit_torch.core import config as tconfig
from fedvit_torch.data.synthetic import make_synthetic_dataset
from fedvit_torch.fed import server as tserver
from fedvit_torch.models import build_model
from fedvit_torch.train import checkpoint as ckpt

from tests.torch_parity import TINY, shallow_vit


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def shallow():
    with shallow_vit():
        yield


def _raw(rounds=3, lr=1e-3):
    raw = copy.deepcopy(TINY)
    raw["training"].update({"batch_size": 4, "optimizer": {"lr": lr},
                            "ema": {"decay": 0.9}})
    raw["loss"] = {"class_weights": True}
    raw["federated"] = {"enabled": True, "num_clients": 4,
                        "clients_per_round": 2, "rounds": rounds,
                        "local_steps": 2}
    return raw


def _data(n=60):
    data = make_synthetic_dataset(n=n, image_size=32, seed=0)
    data["image"] = np.concatenate([data["image"], data["mask"]], -1)
    return {k: v[12:] for k, v in data.items()}, {k: v[:12] for k, v in
                                                  data.items()}


def _model(cfg):
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _run(cfg, workdir=None, resume=False):
    train, ev = _data()
    return tserver.train_federated(cfg, _model(cfg), train, ev,
                                   log_fn=lambda s: None, eval_batch_size=8,
                                   workdir=workdir, resume=resume,
                                   device="cpu")


def _equal_states(a, b):
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


def _history(result):
    return [{k: v for k, v in h.items() if k != "round_time_s"}
            for h in result.history]


class Crash(Exception):
    pass


def test_resume_continues_bit_for_bit(shallow, tmp_path, monkeypatch):
    """Resumes from a run cut after round 2 (while its round-3 draws were
    being made in the background) and from a finished 2-round run extended
    to 3 rounds: both equal 3 uninterrupted rounds in every tensor and every
    history entry but ``round_time_s``."""
    cfg3 = tconfig.from_dict(_raw(rounds=3))
    full = _run(cfg3)
    save = ckpt.save_federated_checkpoint

    def crash_after_round_2(path, model, ema, rnd, *args, **kwargs):
        save(path, model, ema, rnd, *args, **kwargs)
        if rnd == 2:
            raise Crash

    cut = str(tmp_path / "cut")
    with monkeypatch.context() as mp:
        mp.setattr(ckpt, "save_federated_checkpoint", crash_after_round_2)
        with pytest.raises(Crash):
            _run(cfg3, workdir=cut)
    extended = str(tmp_path / "extended")
    two = _run(tconfig.from_dict(_raw(rounds=2)), workdir=extended)
    assert _history(two) == _history(full)[:2]
    # the rounds moved the model, and the two runs differ from round 2 on
    assert _equal_states(full.model.state_dict(), two.model.state_dict())

    for wd in (cut, extended):
        assert json.loads((Path(wd) / "fed_ckpt" / "fed_meta.json")
                          .read_text())["round"] == 2
        resumed = _run(cfg3, workdir=wd, resume=True)
        assert [h["round"] for h in resumed.history] == [1, 2, 3]
        assert _history(resumed) == _history(full)
        assert all(np.isfinite(h["loss"]) for h in resumed.history)
        assert not _equal_states(resumed.model.state_dict(),
                                 full.model.state_dict())
        assert not _equal_states(resumed.ema_params, full.ema_params)
        meta = json.loads((Path(wd) / "fed_ckpt" / "fed_meta.json")
                          .read_text())
        assert meta["round"] == 3 and len(meta["history"]) == 3


def test_resume_refuses_another_config(shallow, tmp_path):
    wd = str(tmp_path / "ckpt")
    _run(tconfig.from_dict(_raw(rounds=1)), workdir=wd)
    with pytest.raises(ValueError, match="config mismatch.*training"):
        _run(tconfig.from_dict(_raw(rounds=1, lr=2e-3)), workdir=wd,
             resume=True)
    # a run that is already as long as asked trains nothing more
    done = _run(tconfig.from_dict(_raw(rounds=1)), workdir=wd, resume=True)
    assert [h["round"] for h in done.history] == [1]


def test_caller_model_and_environment_unchanged(shallow):
    cfg = tconfig.from_dict(_raw(rounds=1))
    model = _model(cfg).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    environ = dict(os.environ)
    train, ev = _data()
    result = tserver.train_federated(cfg, model, train, ev,
                                     log_fn=lambda s: None, device="cpu")
    assert not _equal_states(before, model.state_dict())
    assert model.training and dict(os.environ) == environ
    assert result.model is not model
    assert {p.data_ptr() for p in result.model.parameters()}.isdisjoint(
        p.data_ptr() for p in model.parameters())
    assert _equal_states(before, result.model.state_dict())


def test_host_assembly_matches_resident_data(shallow):
    """A training set over ``federated.device_resident_mb`` is assembled on
    the host each round: the same draws, the same batches, the same run."""
    resident = _run(tconfig.from_dict(_raw(rounds=2)))
    raw = _raw(rounds=2)
    raw["federated"]["device_resident_mb"] = 0
    host = _run(tconfig.from_dict(raw))
    assert _history(host) == _history(resident)
    assert not _equal_states(host.model.state_dict(),
                             resident.model.state_dict())


def test_federated_checkpoint_crash_windows(tmp_path):
    """Every crash window of the directory-swap save leaves a loadable
    generation: mid-tmp-write (the stale tmp is ignored), between the two
    renames (the ``.old`` fallback), and after promotion (live wins)."""
    model = nn.Linear(4, 4)
    rng = np.random.default_rng(3)
    base = str(tmp_path / "wd")

    def save(rnd):
        with torch.no_grad():
            model.weight.fill_(float(rnd))
        ckpt.save_federated_checkpoint(base, model, None, rnd,
                                       [{"round": rnd}],
                                       rng.bit_generator.state, 7)

    def load():
        target = nn.Linear(4, 4)
        got = ckpt.load_federated_checkpoint(base, target, None)
        return got, float(target.weight.detach()[0, 0])

    save(1)
    assert ckpt.federated_checkpoint_exists(base)

    # window A: a half-written tmp generation; the live one still loads
    tmp = Path(base) / "fed_ckpt.tmp"
    tmp.mkdir()
    (tmp / "fed_meta.json").write_text("{corrupt")
    got, w = load()
    assert got["round"] == 1 and w == 1.0
    shutil.rmtree(tmp)

    # window B: between the two renames only .old holds round 1
    live, old = Path(base) / "fed_ckpt", Path(base) / "fed_ckpt.old"
    live.rename(old)
    assert ckpt.federated_checkpoint_exists(base)
    got, w = load()
    assert got["round"] == 1 and got["history"] == [{"round": 1}] and w == 1.0
    assert got["generator_base"] == 7
    assert got["np_rng_state"] == rng.bit_generator.state
    old.rename(live)

    # window C: a later save promotes over the previous one and clears both
    # transient generations
    save(2)
    got, w = load()
    assert got["round"] == 2 and w == 2.0
    assert not tmp.exists() and not old.exists()
    with pytest.raises(ValueError, match="EMA"):
        ckpt.load_federated_checkpoint(base, model, {"weight": model.weight})


def test_cli_writes_history_and_checkpoint(shallow, tmp_path):
    config = tmp_path / "fed.yaml"
    config.write_text(json.dumps({
        "model": {"backbone": "vit_tiny_patch16_224", "image_size": 32,
                  "compute_dtype": "float32"},
        "training": {"batch_size": 4}}))          # JSON is YAML
    log = tmp_path / "log"
    assert cli.main(["--config", str(config), "--synthetic", "48",
                     "--clients", "4", "--rounds", "2", "--log", str(log),
                     "--device", "cpu"]) == 0
    history = json.loads((log / "federated_history.json").read_text())
    assert [h["round"] for h in history] == [1, 2]
    assert all(np.isfinite(h[k]) for h in history
               for k in ("loss", "accuracy", "balanced_accuracy", "macro_f1"))
    assert ckpt.federated_checkpoint_exists(str(log / "ckpt"))
    assert sorted(p.name for p in (log / "ckpt").iterdir()) == ["fed_ckpt"]
    # without --synthetic it reads data.isic_dir, absent here
    config.write_text(json.dumps({"data": {"isic_dir": str(tmp_path / "none")}}))
    with pytest.raises(FileNotFoundError,
                       match="ISIC_2019_Training_GroundTruth.csv"):
        cli.main(["--config", str(config), "--log", str(log),
                  "--device", "cpu"])
