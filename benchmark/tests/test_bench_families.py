"""What the harness knows of an architecture lives in one module a family
(``benchmark/families/``), and a new family is new files only.

The literals below were recorded on the CPU in fp32, two threads, with the
harness as it stood before its family branches became modules: at each
family's tiny size, a sha256 of the parameter spec's names and shapes, of
the weights the seed makes, and of the reference's served logits, and the
reference's three training losses; at the published sizes, the operation
counts and a sha256 of the attention calls' (bytes, operations). The modules
must reproduce them bit for bit.
"""

import hashlib
import json
import shutil
import time

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import flops, inputs, manifest
from benchmark.reference import models as ref_models
from benchmark.tests.tiny import CPU, tiny_cell

SEED = 2 ** 31 + 4242

GOLDEN = {
    "vit": {
        "spec": "eb5b0468a72fa2eac338921a0b930a0db5ef964929fca5751e62e3fece14a9be",
        "weights": "dd50368329bb27b29ae2a808229cc78c042efd6fdcc77225f4cff883bb4ea2ae",
        "losses": [1.9805837869644165, 2.5591604709625244, 1.9598610401153564],
        "logits": "f7b0c4bc5753bc56bfc4def6c0396178788d743e9118d85597318da797d3f0bc",
    },
    "swinv2": {
        "spec": "0df5232b89c41d9910a08050cc3c78f981af29aa57e52ba2d4dbbb4a41abddf7",
        "weights": "af0680f26a3ed4271c90e905660979d2866bc16b8f121aa3a4d72a01c177ac5d",
        "losses": [1.6883156299591064, 4.696505546569824, 1.6975749731063843],
        "logits": "67ad61c174458b52ca09f74f0ef8e300e8dc42e4b4b1dc0d1ac6e6839990e4a8",
    },
}

COUNTS = {
    "vit-base-224": {
        "forward": {1: 35204188672, 32: 1126534037504, 128: 4506136150016},
        "train": {16: 1689801056256, 128: 13518408450048},
        "calls": {
            "serve": "5378a5a2c8d80fb1bf38311fd2a5f51270f6a6a7dde7e7e240fb17c005b0862e",
            "train_fwd": "97a12ce4f0828843aecfc5b9205884d128bdeb9eafef9e679db3978d7463ab22",
            "train_bwd": "1788c7d429998b8743156b6929f2f6b83fbcc338a4db801a340344f6c0838f97",
        },
    },
    "swinv2-large-384": {
        "forward": {1: 232038189568, 32: 7387640090624, 128: 29546923397120},
        "train": {16: 11083278618624, 128: 88640770191360},
        "calls": {
            "serve": "0a09e2c8e099e83e64410033509c24d11f6762c3dc138fecc301e40e515708d4",
            "train_fwd": "520d6f2a134a7224e8e3da52e0c0a692778642a4406101e1b9d053358a016f2d",
            "train_bwd": "36e83bd091b07de2146d2e1b84d7146194bed66279c68063c517e6b095101c69",
        },
    },
}


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("family", sorted(GOLDEN))
def test_the_spec_and_weights_are_unchanged(family):
    arch = tiny_cell(family).config["model"]
    spec = ref_models.param_spec(arch)
    assert sha(json.dumps([[n, list(s)] for n, s in spec]).encode()) == \
        GOLDEN[family]["spec"]
    w = inputs.make_weights(spec, SEED, CPU)
    assert sha(b"".join(w[n].numpy().tobytes() for n, _ in spec)) == \
        GOLDEN[family]["weights"]


@pytest.mark.parametrize("family", sorted(GOLDEN))
def test_the_reference_training_losses_are_unchanged(family):
    mode = manifest.mode_module("train_epoch")
    losses = mode.reference_readings(tiny_cell(family), SEED, CPU)["loss"]
    assert losses == GOLDEN[family]["losses"]


@pytest.mark.parametrize("family", sorted(GOLDEN))
def test_the_reference_served_logits_are_unchanged(family):
    cell = tiny_cell(family, mode="predict", resident=16, micro=4)
    logits = manifest.mode_module("predict").reference_logits(
        cell, SEED, np.arange(8), CPU)
    assert sha(np.ascontiguousarray(logits, np.float64).tobytes()) == \
        GOLDEN[family]["logits"]


@pytest.mark.parametrize("config", sorted(COUNTS))
def test_the_operation_and_byte_counts_are_unchanged(config):
    with open(manifest.BENCH_DIR / "configs" / f"{config}.json") as f:
        arch = json.load(f)["model"]
    want = COUNTS[config]
    assert {b: flops.forward_flops(arch, b) for b in want["forward"]} == \
        want["forward"]
    assert {b: flops.train_flops(arch, b) for b in want["train"]} == \
        want["train"]
    assert {k: sha(repr(flops.attention_calls(arch, 32, k)).encode())
            for k in want["calls"]} == want["calls"]


# ---------------------------------------------------------------------------
# A new architecture as new files only
# ---------------------------------------------------------------------------

TOY_FAMILY = '''"""A toy architecture: ViT's functions under another family name."""
from pathlib import Path

from benchmark.harness.manifest import load_module

_vit = load_module(Path(__file__).with_name("vit.py"), "family_toyvit_vit")
globals().update({k: v for k, v in vars(_vit).items()
                  if not k.startswith("__")})
'''

TOY_CELLS = {"train_epoch": ("toyvit-train", "vitb224-train-1x128"),
             "predict": ("toyvit-predict", "swinv2l384-predict-b32")}


def write_new(path, text: str) -> None:
    assert not path.exists(), f"{path} is there already"
    path.write_text(text)


def toy_benchmark(root):
    """A copy of ``benchmark/`` under ``root`` with a toy family, its
    configuration, a training and a serving mix, their limits and their
    manifest entries, all written as new files: (manifest, benchmark dir)."""
    base = root / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((manifest.REPO_DIR / "BENCHMARK.json").read_text())
    write_new(base / "families" / "toyvit.py", TOY_FAMILY)

    config = tiny_cell("vit").config
    config["model"]["family"] = "toyvit"
    write_new(base / "configs" / "toyvit-tiny.json", json.dumps(config))
    data["configs"].append({
        "name": "toyvit-tiny", "source": "https://arxiv.org/abs/2010.11929",
        "file": "benchmark/configs/toyvit-tiny.json", "reduced": [],
        "why": "a toy family that reuses ViT's functions"})

    counts = [4522, 12875, 3323, 867, 2624, 239, 253, 628]
    mixes = {
        "train_epoch": {"mode": "train_epoch", "resident": 16,
                        "class_counts": counts, "profiled_steps": 1,
                        "program": {"training": {
                            "batch_size": 4,
                            "gradient_accumulation_steps": 1}}},
        "predict": {"mode": "predict", "host_images": 16,
                    "class_counts": counts, "warmup": 1, "sample": 8,
                    "profiled_batches": 1,
                    "program": {"training": {"batch_size": 4}}}}
    for mode, (cell, like) in TOY_CELLS.items():
        write_new(base / "traffic" / f"{cell}.json", json.dumps(mixes[mode]))
        write_new(base / "limits" / f"{cell}.json",
                  (base / "limits" / f"{like}.json").read_text())
        data["workloads"].append({"name": cell, "config": "toyvit-tiny",
                                  "traffic": cell, "chips": 1,
                                  "why": f"the toy family's {mode} cell"})
        for m in data["end_to_end"] + data["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    write_new(root / "BENCHMARK.json", json.dumps(data))
    return data, base


@pytest.mark.parametrize("mode", sorted(TOY_CELLS))
def test_a_new_family_is_new_files_only(mode, tmp_path, monkeypatch):
    data, base = toy_benchmark(tmp_path)
    monkeypatch.setattr(manifest, "FAMILIES_DIR", base / "families")
    assert manifest.problems(data, base) == []
    cell = manifest.load_cell(TOY_CELLS[mode][0], data, base)
    assert cell.mode == mode and cell.per_layer
    code, out = run.execute(cell, SEED, 1.0, False, time.time(), "cpu",
                            log=lambda s: None)
    assert code == 0
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_a_config_of_a_missing_family_is_a_problem(tmp_path):
    data, base = toy_benchmark(tmp_path)
    (base / "families" / "toyvit.py").unlink()
    assert manifest.problems(data, base) == ["families/toyvit.py is missing"]
