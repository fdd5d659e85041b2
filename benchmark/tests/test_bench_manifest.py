"""The manifest against the contract's rules, and the harness finding every
file of a cell by name."""

import json
import shutil

import pytest
import torch

from benchmark.harness import manifest
from benchmark.reference import models as ref_models

MANIFEST = manifest.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
CONFIGS = [c["name"] for c in MANIFEST["configs"]]
NUMBERS = {"train_epoch": {"loss_gap", "grad_gap", "grad_gap.median",
                           "change_gap", "ema_gap"},
           "predict": {"logit_gap"}}


def test_names_units_and_files_are_valid():
    assert manifest.problems(MANIFEST) == []


def test_entries_have_the_contract_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in [e["name"] for e in MANIFEST["end_to_end"]]
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = manifest.load_cell(name, MANIFEST)
    mode = manifest.mode_module(cell.mode)
    assert callable(mode.run)
    assert set(cell.limits) == NUMBERS[cell.mode]
    assert cell.per_layer and any(m["name"] != "setup_s"
                                  for m in cell.end_to_end)
    for metric in cell.per_layer:
        assert callable(manifest.metric_module(metric["name"]).read)


def test_a_data_only_cell_is_picked_up(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((manifest.REPO_DIR / "BENCHMARK.json").read_text())
    traffic = json.loads((base / "traffic" / "train-1x128.json").read_text())
    traffic["program"]["training"].update(batch_size=64,
                                          gradient_accumulation_steps=2)
    (base / "traffic" / "train-2x64.json").write_text(json.dumps(traffic))
    (base / "limits" / "vitb224-train-2x64.json").write_text(
        (base / "limits" / "vitb224-train-1x128.json").read_text())
    data["workloads"].append({"name": "vitb224-train-2x64",
                              "config": "vit-base-224", "traffic": "train-2x64",
                              "chips": 1, "why": "the same epochs at 2 x 64"})
    for m in data["end_to_end"] + data["per_layer"]:
        if "workloads" in m and "vitb224-train-1x128" in m["workloads"]:
            m["workloads"].append("vitb224-train-2x64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    assert manifest.problems(data, base) == []
    cell = manifest.load_cell("vitb224-train-2x64", data, base)
    assert cell.mode == "train_epoch"
    assert cell.traffic["program"]["training"]["batch_size"] == 64
    assert {m["name"] for m in cell.per_layer} >= {"mfu_pct.train",
                                                   "augment_ms.train"}
    assert manifest.mode_module(cell.mode, base).run


@pytest.mark.parametrize("config", CONFIGS)
def test_the_program_has_the_reference_parameters(config):
    """At the published sizes, the program's model (built on the meta
    device: shapes only) has exactly the reference's parameter names and
    shapes, which the benchmark's weights are made for."""
    from fedvit_torch.core.config import from_dict
    from fedvit_torch.models.isic import ISICClassifier

    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    with open(manifest.REPO_DIR / entry["file"]) as f:
        conf = json.load(f)
    cfg = from_dict(conf["program"])
    m = cfg.model
    with torch.device("meta"):
        model = ISICClassifier(
            backbone_name=m.backbone, num_classes=m.num_classes,
            image_size=m.image_size, in_channels=cfg.in_channels,
            drop_path_rate=m.drop_path_rate, pool=m.pool,
            compute_dtype=m.compute_dtype)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = dict(ref_models.param_spec(conf["model"]))
    assert got == want
