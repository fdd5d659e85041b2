"""Tiny cells for the harness's CPU tests: the real cells' files with the
models cut to the size each family's module gives (``TINY``: ViT-Ti/16 at
32 px; SwinV2-T with windows of 8 at 64 px), their compute in fp32 or bf16.
``FAMILIES`` is every architecture in ``benchmark/families/``, so that a
new family brings its cases to the tests that run each family."""

from __future__ import annotations

import copy
import json

import torch

from benchmark.harness import manifest

FAMILIES = sorted(p.stem for p in manifest.FAMILIES_DIR.glob("*.py"))


def tiny_cell(family: str, mode: str = "train_epoch", resident: int = 24,
              micro: int = 4, dtype: str = "float32",
              limits=None) -> manifest.Cell:
    tiny = manifest.family_module(family).TINY
    with open(manifest.BENCH_DIR / "configs" / f"{tiny['config']}.json") as f:
        config = json.load(f)
    config = copy.deepcopy(config)
    config["model"].update(tiny["model"], image_size=tiny["image_size"])
    config["inputs"]["canvas"] = tiny["canvas"]
    prog = config["program"]["model"]
    prog.update(backbone=tiny["backbone"], image_size=tiny["image_size"],
                compute_dtype=dtype)
    if mode == "train_epoch":
        traffic = {"mode": mode, "resident": resident,
                   "class_counts": [4522, 12875, 3323, 867, 2624, 239, 253, 628],
                   "profiled_steps": 1,
                   "program": {"training": {"batch_size": micro,
                                            "gradient_accumulation_steps": 1}}}
        limits = limits or {"loss_gap": 0.05, "grad_gap": 0.5,
                            "grad_gap.median": 0.5, "change_gap": 0.5,
                            "ema_gap": 0.5}
    else:
        traffic = {"mode": mode, "host_images": resident,
                   "class_counts": [4522, 12875, 3323, 867, 2624, 239, 253, 628],
                   "warmup": 1, "sample": 8, "profiled_batches": 1,
                   "program": {"training": {"batch_size": micro}}}
        limits = limits or {"logit_gap": 0.2}
    e2e = ([{"name": "train_img_s", "unit": "img/s"}] if mode == "train_epoch"
           else [{"name": "predict_img_s", "unit": "img/s"},
                 {"name": "predict_ms_p95", "unit": "ms"}])
    e2e.append({"name": "setup_s", "unit": "s"})
    return manifest.Cell(f"tiny-{family}-{mode}", 1, config, traffic, e2e,
                         [], limits, manifest.BENCH_DIR)


CPU = torch.device("cpu")
