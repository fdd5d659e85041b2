"""The port's user path on ISIC files — ``cli/train.py``, ``cli/predict.py
--isic_dir`` and ``cli/train_federated.py`` without ``--synthetic`` —
against the JAX package's CLIs, on the CPU, on ISIC-2019 layouts written
under ``tmp_path`` (small JPEGs and mask PNGs).

The training parity test makes both packages deterministic as
``tests/test_torch_loop.py::test_train_fold_matches_jax`` does (the whole
canvas resized, no flips, rotation, jitter, RandAugment, MixUp/CutMix,
dropout or drop-path, no TTA), cuts ``vit_tiny`` to 2 blocks and carries
each fold's JAX init into the port. Both decode with PIL:
``fedvit_tpu.data.native_loader.available`` is held False, so JAX's C++
loader is not used wherever it happens to be built.

Tolerances: ``ensemble_logits.npy`` atol 1e-4, for
``test_train_fold_matches_jax``'s reason (Adam's rounding through 4 steps a
fold); the best epochs equal. Everything the port alone computes (a fold
run alone against the same fold of the full run, predict against the CLI's
logits, the federated CLI's data against JAX's): exact up to 1e-6 or bit
for bit.
"""

import copy
import json
import logging
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fedvit_torch.cli import import_weights as timport_cli
from fedvit_torch.cli import predict as tpredict
from fedvit_torch.cli import train as tcli
from fedvit_torch.cli import train_federated as tfed_cli
from fedvit_torch.core import config as tconfig
from fedvit_torch.data.isic import load_isic_data
from fedvit_torch.fed import server as tserver
from fedvit_torch.models import build_model as build_torch_model
from fedvit_torch.train import loop as tloop
from fedvit_torch.train import probe as tprobe
from fedvit_tpu.cli import train as jcli
from fedvit_tpu.cli import train_federated as jfed_cli
from fedvit_tpu.data import native_loader
from fedvit_tpu.fed import server as jserver
from fedvit_tpu.models import build_model as jax_build_model
from fedvit_tpu.train import loop as jloop
from fedvit_tpu.train import probe as jprobe
from fedvit_tpu.train.state import TrainState as JaxTrainState

from tests.torch_parity import TINY, shallow_vit, torch_model, write_isic_tree


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_jax_cli_loggers():
    """JAX's ``cli.train.setup_logging`` keeps its handlers on the named
    loggers ``isic_*``; clear them so that a later test in this process
    logs into its own directory."""
    yield
    for name in list(logging.Logger.manager.loggerDict):
        if name.startswith("isic_"):
            for handler in list(logging.getLogger(name).handlers):
                logging.getLogger(name).removeHandler(handler)
                handler.close()


@pytest.fixture
def shallow():
    with shallow_vit():
        yield


@pytest.fixture
def pil_only(monkeypatch):
    monkeypatch.setattr(native_loader, "available", lambda: False)


def _config(tmp_path, root, masks=True, **training):
    """A tiny deterministic YAML (JSON is YAML) over the tree at ``root``."""
    raw = copy.deepcopy(TINY)
    raw["data"].update({"isic_dir": str(root), "use_segmentation_mask": masks,
                        "segmentation_mask_dir": str(tmp_path / "masks")})
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["model"]["classifier"] = {"dropout": 0.0}
    raw["training"].update({
        "batch_size": 4, "gradient_accumulation_steps": 2, "epochs": 2,
        "optimizer": {"lr": 1e-4}, "scheduler": {"warmup_epochs": 0},
        "ema": {"decay": 0.9}, "tta": {"enabled": False},
        "cv": {"n_splits": 2}, "num_workers": 2})
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
    path = tmp_path / f"config_{len(list(tmp_path.glob('config_*')))}.yaml"
    path.write_text(json.dumps(raw))
    return str(path)


def _tree(tmp_path, test="labelled"):
    return write_isic_tree(tmp_path / "ISIC", test=test,
                           masks=tmp_path / "masks")


def _carry_jax_init(monkeypatch):
    """JAX's jitted init of each fold's model, loaded into the port's."""
    inits = {}

    def jax_init(cfg, tx, rng_seed=0, ema_enabled=None):
        model = jax_build_model(cfg)
        s = cfg.model.image_size
        x = jnp.zeros((2, s, s, cfg.in_channels), jnp.float32)
        meta = jnp.zeros((2, 13), jnp.float32)
        init = jax.jit(lambda r: model.init({"params": r, "dropout": r},
                                            x, meta))
        variables = jax.device_get(init(jax.random.key(rng_seed)))
        inits[rng_seed] = variables
        state = JaxTrainState.create(
            model.apply, variables["params"], variables["batch_stats"], tx,
            jax.random.key(rng_seed + 1), ema_enabled=cfg.training.ema.enabled)
        return model, state

    monkeypatch.setattr(jloop, "init_model_state", jax_init)
    monkeypatch.setattr(tloop, "build_model", lambda cfg, device, generator:
                        torch_model(cfg, inits[generator.initial_seed()]))


def _meta(path):
    return json.loads((path / "meta.json").read_text())


def _predict(capsys, config, root, checkpoints, out, *extra):
    argv = ["--config", config, "--isic_dir", str(root), "--output",
            str(out / "pred.csv"), "--logits_out", str(out / "logits.npy"),
            "--device", "cpu", *extra]
    for c in checkpoints:
        argv += ["--checkpoint", str(c)]
    capsys.readouterr()
    assert tpredict.main(argv) == 0
    printed = capsys.readouterr().out
    return (np.load(out / "logits.npy"), pd.read_csv(out / "pred.csv"),
            printed)


def test_train_cli_matches_jax(shallow, pil_only, monkeypatch, capsys,
                               tmp_path):
    """2 folds of 2 epochs, masks fed from PNGs, a labelled test split: the
    ensemble logits, each fold's best and last epochs, the logs; then predict
    --isic_dir on both folds' best checkpoints gives the CLI's ensemble."""
    root = _tree(tmp_path)
    config = _config(tmp_path, root)
    _carry_jax_init(monkeypatch)
    jlog, tlog = tmp_path / "jax", tmp_path / "torch"
    assert jcli.main(["--config", config, "--log", str(jlog)]) == 0
    assert tcli.main(["--config", config, "--log", str(tlog),
                      "--device", "cpu"]) == 0
    got = np.load(tlog / "ensemble_logits.npy")
    want = np.load(jlog / "ensemble_logits.npy")
    assert got.shape == want.shape == (10, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for f in (0, 1):
        for kind in ("best", "resume"):
            t, j = (_meta(d / f"fold{f}" / f"{kind}_fold{f}")
                    for d in (tlog, jlog))
            assert t["epoch"] == j["epoch"] and t["epoch"] >= 1
            assert abs(t["best_metric"] - j["best_metric"]) < 1e-6
        fold_log = (tlog / f"fold{f}" / f"train_fold{f}.log").read_text()
        assert " E02 " in fold_log and f"FOLD {f}" in fold_log
    main_log = (tlog / "train_main.log").read_text()
    assert "2-Fold CV" in main_log and "StratifiedGroupKFold" in main_log
    assert "precision" in main_log and "Ensemble logits saved" in main_log
    assert not (jlog / "train_main.log").read_text().count("PyTorch")

    logits, rows, printed = _predict(
        capsys, config, root, [tlog / f"fold{f}" / f"best_fold{f}"
                               for f in (0, 1)], tmp_path)
    np.testing.assert_allclose(logits, got, atol=1e-6, rtol=0)
    _, test_df = load_isic_data(str(root), log=lambda s: None)
    assert list(rows["image"]) == list(test_df["image"])
    assert "precision" in printed and "macro avg" in printed


def _recording_folds(monkeypatch, into):
    fold = tloop.train_fold

    def recorded(cfg, f, *args, **kwargs):
        out = fold(cfg, f, *args, **kwargs)
        into[f] = out
        return out
    monkeypatch.setattr(tloop, "train_fold", recorded)


def test_fold_alone_resume_and_predict_one_fold(shallow, monkeypatch,
                                                capsys, tmp_path):
    """``--fold 1`` alone trains what the full run's fold 1 trains; predict
    --isic_dir on its best checkpoint gives its ensemble (one fold), rows in
    the test frame's order, with the report; ``--resume`` continues a fold
    from its last epoch."""
    root = _tree(tmp_path)
    config = _config(tmp_path, root)
    folds = {}
    _recording_folds(monkeypatch, folds)
    assert tcli.main(["--config", config, "--log", str(tmp_path / "all"),
                      "--device", "cpu"]) == 0
    full = dict(folds)
    alone = tmp_path / "alone"
    assert tcli.main(["--config", config, "--log", str(alone), "--fold", "1",
                      "--device", "cpu"]) == 0
    one = np.load(alone / "ensemble_logits.npy")
    np.testing.assert_allclose(one, full[1].logits, atol=1e-6, rtol=0)
    assert not (alone / "fold0").exists()

    logits, rows, printed = _predict(
        capsys, config, root, [alone / "fold1" / "best_fold1"], tmp_path)
    np.testing.assert_allclose(logits, one, atol=1e-6, rtol=0)
    _, test_df = load_isic_data(str(root), log=lambda s: None)
    assert list(rows["image"]) == list(test_df["image"])
    assert rows.shape == (10, 10) and "precision" in printed

    short = _config(tmp_path, root, epochs=1)
    run = tmp_path / "resumed"
    assert tcli.main(["--config", short, "--log", str(run), "--fold", "0",
                      "--device", "cpu"]) == 0
    fold_log = run / "fold0" / "train_fold0.log"
    assert " E01 " in fold_log.read_text()
    assert tcli.main(["--config", config, "--log", str(run), "--fold", "0",
                      "--resume", "--device", "cpu"]) == 0
    text = fold_log.read_text()
    after = text[text.index("Resumed from epoch 1"):]
    assert " E02 " in after and " E01 " not in after
    assert _meta(run / "fold0" / "resume_fold0")["epoch"] == 2


def test_auto_batch_size_branch_matches_jax(pil_only, monkeypatch, tmp_path):
    """With ``training.auto_batch_size`` both CLIs train every fold at the
    probe's batch size, on the same train, validation and test rows (the
    probe and the fold trainer stubbed)."""
    root = _tree(tmp_path)
    config = _config(tmp_path, root, auto_batch_size=True)
    seen = {"jax": [], "torch": []}

    def probe(side):
        def fn(cfg, **kwargs):
            seen[side].append(("probe", cfg.training.batch_size))
            return 6
        return fn

    def fold(side, result):
        def fn(cfg, f, trn, val, test, **kwargs):
            seen[side].append((f, cfg.training.batch_size,
                               trn.labels.tolist(), val.labels.tolist(),
                               test.labels.tolist(),
                               np.asarray(trn.metadata).tolist(),
                               kwargs.get("resume")))
            empty = np.zeros((0, 8))
            return result(logits=empty, probs=empty)
        return fn

    monkeypatch.setattr(jprobe, "auto_batch_size", probe("jax"))
    monkeypatch.setattr(tprobe, "auto_batch_size", probe("torch"))
    monkeypatch.setattr(jloop, "train_fold", fold("jax", jloop.FoldResult))
    monkeypatch.setattr(tloop, "train_fold", fold("torch", tloop.FoldResult))
    assert jcli.main(["--config", config, "--log", str(tmp_path / "j"),
                      "--resume"]) == 0
    assert tcli.main(["--config", config, "--log", str(tmp_path / "t"),
                      "--resume", "--device", "cpu"]) == 0
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == ("probe", 4)
    assert [s[:2] for s in seen["torch"][1:]] == [(0, 6), (1, 6)]
    assert all(s[-1] is True for s in seen["torch"][1:])
    assert not (tmp_path / "t" / "ensemble_logits.npy").exists()


def test_profile_writes_a_trace(shallow, tmp_path):
    """``--profile`` traces optimizer steps 2-4 of a run of 6 (fold 0: 2
    steps an epoch, 3 epochs) and no other."""
    root = _tree(tmp_path)
    config = _config(tmp_path, root, epochs=3)
    trace = tmp_path / "trace"
    steps = []
    fold = tloop.train_fold

    def counted(*args, on_step=None, **kwargs):
        def step():
            steps.append(len(steps))
            on_step()
        return fold(*args, on_step=step, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tloop, "train_fold", counted)
        assert tcli.main(["--config", config, "--log", str(tmp_path / "log"),
                          "--fold", "0", "--profile", str(trace),
                          "--device", "cpu"]) == 0
    assert len(steps) == 6
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    recorded = {e["name"] for e in events
                if str(e.get("name", "")).startswith("ProfilerStep#")}
    assert recorded == {"ProfilerStep#1", "ProfilerStep#2", "ProfilerStep#3"}
    assert "Profiler trace written" in (tmp_path / "log" /
                                        "train_main.log").read_text()


def test_predict_isic_unlabelled_and_empty_splits(shallow, capsys, tmp_path):
    """An unlabelled test split is predicted in its frame's order with no
    report; an ISIC directory with no test split is refused."""
    root = _tree(tmp_path, test="unlabelled")
    config = _config(tmp_path, root)
    tcfg = tconfig.load_config(config)
    weights = tmp_path / "model.pt"
    torch.save(build_torch_model(tcfg, device="cpu").state_dict(), weights)
    logits, rows, printed = _predict(capsys, config, root, [weights],
                                     tmp_path, "--tta")
    _, test_df = load_isic_data(str(root), log=lambda s: None)
    assert logits.shape == (11, 8) and np.isfinite(logits).all()
    assert list(rows["image"]) == list(test_df["image"])
    assert "precision" not in printed

    empty = write_isic_tree(tmp_path / "no_test", test=None)
    with pytest.raises(SystemExit, match="no test split"):
        _predict(capsys, config, empty, [weights], tmp_path)


@pytest.mark.parametrize("test", ("labelled", None))
def test_train_federated_isic_data_matches_jax(shallow, pil_only, monkeypatch,
                                               tmp_path, test):
    """Without ``--synthetic`` both CLIs hand ``train_federated`` the same
    uint8 canvases, labels and metadata of the training split, and the test
    split (or None) as the evaluation data, bit for bit."""
    root = _tree(tmp_path, test=test)
    config = _config(tmp_path, root)
    seen = {}

    def capture(side):
        def fn(cfg, model, *args, **kwargs):
            data = [a for a in args if a is None or isinstance(a, dict)]
            seen[side] = data[-2:]
            return types.SimpleNamespace(history=[])
        return fn

    monkeypatch.setattr(jserver, "train_federated", capture("jax"))
    monkeypatch.setattr(tserver, "train_federated", capture("torch"))
    argv = ["--config", config, "--clients", "2", "--rounds", "1"]
    assert jfed_cli.main(argv + ["--log", str(tmp_path / "j")]) == 0
    assert tfed_cli.main(argv + ["--log", str(tmp_path / "t"),
                                 "--device", "cpu"]) == 0
    (t_train, t_eval), (j_train, j_eval) = seen["torch"], seen["jax"]
    assert t_train["image"].dtype == np.uint8
    assert t_train["image"].shape == (36, 48, 48, 4)
    for t, j in ((t_train, j_train), (t_eval, j_eval)):
        if j is None:
            assert t is None and test is None
            continue
        assert set(t) == set(j) == {"image", "label", "metadata"}
        for key in t:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key])
    assert json.loads((tmp_path / "t" / "federated_history.json"
                       ).read_text()) == []


@pytest.mark.parametrize("cli", ("train", "predict", "import_weights",
                                 "train_federated"))
def test_entry_points_need_a_card_unless_told_cpu(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root = _tree(tmp_path)
    config = _config(tmp_path, root)
    weights = tmp_path / "w.pt"
    torch.save({}, weights)
    argv = {"train": (tcli, ["--config", config]),
            "predict": (tpredict, ["--config", config, "--isic_dir", str(root),
                                   "--checkpoint", str(weights)]),
            "import_weights": (timport_cli, ["--config", config, "--weights",
                                             str(weights), "--output",
                                             str(tmp_path / "out")]),
            "train_federated": (tfed_cli, ["--config", config])}
    module, args = argv[cli]
    with pytest.raises(RuntimeError, match=re.escape("device='cpu'")):
        module.main(args + ["--log", str(tmp_path / "log")]
                    if cli in ("train", "train_federated") else args)
    assert not (tmp_path / "log" / "ensemble_logits.npy").exists()
