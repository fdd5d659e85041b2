"""``fedvit_torch.cli.verify`` and ``fedvit_torch.utils.profiling`` on the
CPU: the harness's 14 checks pass and a broken one fails the command by
name; ``trace`` writes a trace with a ``span``'s range in it;
``cli.train --profile`` writes its trace through ``trace``, with the
epoch loop's spans in it."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fedvit_torch.cli import train as tcli
from fedvit_torch.cli import verify
from fedvit_torch.utils import profiling

from tests.torch_parity import TINY, shallow_vit, write_isic_tree

ROOT = Path(__file__).resolve().parents[1]


def test_verify_passes_all_14_checks_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "fedvit_torch.cli.verify", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("[PASS]") == 14
    assert "[FAIL]" not in out.stdout
    assert "14/14 tests passed" in out.stdout


def test_verify_fails_and_names_a_broken_check(monkeypatch, capsys):
    from fedvit_torch.train import schedule
    monkeypatch.setattr(schedule, "lr_curve",
                        lambda *a: [1.0] * 20)        # no warm-up from 0
    assert verify.main(["--device", "cpu"]) == 1
    printed = capsys.readouterr().out
    assert printed.count("[PASS]") == 13
    assert "[FAIL] scheduler warmup then cosine decay" in printed
    assert "FAILED: scheduler warmup then cosine decay" in printed


def test_array_source_takes_float_images_as_jax_does():
    """Check 9's source: [0, 1] float images (the synthetic fixture's) are
    stored as JAX's ``ArrayDataSource`` stores them, uint8 bit for bit."""
    from fedvit_torch.data.pipeline import ArrayDataSource
    from fedvit_torch.data.synthetic import make_synthetic_dataset
    from fedvit_tpu.data.pipeline import ArrayDataSource as JaxSource
    data = make_synthetic_dataset(n=6, image_size=16, seed=3)
    data["image"][0, 0, 0] = [-0.5, 1.5, 0.999]          # clipped either way
    got = ArrayDataSource(data).gather(np.arange(6))
    want = JaxSource(data).gather(np.arange(6))
    assert got["image"].dtype == np.uint8
    for k in ("image", "label", "metadata"):
        np.testing.assert_array_equal(got[k], want[k])


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    import torch
    with profiling.trace(str(tmp_path)):
        with profiling.span("verify_span"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {str(e.get("name", "")) for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert "fedvit.verify_span" in names
    assert any(n.startswith("aten::") for n in names)


def test_cli_train_profiles_through_utils_trace(tmp_path):
    """``cli.train --profile`` on a tiny ISIC layout opens one
    ``utils.profiling.trace`` with a schedule, and its trace is written with
    the profiled steps' ``fedvit.train.step`` spans in it."""
    root = write_isic_tree(tmp_path / "ISIC", n_train=24, test=None,
                           masks=tmp_path / "masks")
    raw = copy.deepcopy(TINY)
    raw["data"].update({"isic_dir": str(root),
                        "segmentation_mask_dir": str(tmp_path / "masks")})
    raw["training"].update({
        "batch_size": 4, "gradient_accumulation_steps": 1, "epochs": 1,
        "scheduler": {"warmup_epochs": 0}, "tta": {"enabled": False},
        "cv": {"n_splits": 2}, "num_workers": 2})
    config = tmp_path / "config.yaml"
    config.write_text(json.dumps(raw))
    opened = []
    real = profiling.trace

    def spy(log_dir, schedule=None, cuda=None):
        opened.append((log_dir, schedule, cuda))
        return real(log_dir, schedule=schedule, cuda=cuda)

    with pytest.MonkeyPatch.context() as mp, shallow_vit():
        mp.setattr(profiling, "trace", spy)
        assert tcli.main(["--config", str(config), "--log",
                          str(tmp_path / "log"), "--fold", "0", "--profile",
                          str(tmp_path / "trace"), "--device", "cpu"]) == 0
    assert len(opened) == 1 and opened[0][1] is not None
    assert opened[0][2] is False            # a CPU run records no CUDA activity
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    steps = [e for e in json.loads(files[0].read_text())["traceEvents"]
             if e.get("name") == "fedvit.train.step"]
    assert steps and all(e.get("cat") == "user_annotation" for e in steps)
