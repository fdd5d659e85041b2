"""The manifest (``BENCHMARK.json``) and the files it names.

A cell is one entry of ``workloads``: a configuration and a traffic mix. The
harness finds everything else by name, so a new cell, configuration, mix,
mode, architecture or per-layer metric is new files and new manifest
entries:

    configs/<config>.json     the configuration (its ``file`` in the manifest)
    traffic/<traffic>.json    the mix: its mode and that mode's parameters
    modes/<mode>.py           the code that drives the program for a mode
    families/<family>.py      an architecture (a configuration's
                              ``model.family``): its backbone's parameters,
                              reference forward, operation counts, attention
                              kernel names and tiny CPU size
    metrics/<metric>.py       a per-layer metric's reader
    limits/<workload>.json    the limits of the cell's correctness numbers

A new architecture is new files only: ``families/<family>.py``,
``configs/<name>.json``, ``traffic/<mix>.json`` and ``limits/<cell>.json``;
entries in ``configs``, ``workloads`` and ``per_layer``; and the new cell's
name added to the ``workloads`` list of each end-to-end metric it reports.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent
FAMILIES_DIR = BENCH_DIR / "families"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]
    base: Path

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def load_manifest(path: Optional[Path] = None) -> Dict:
    with open(path or REPO_DIR / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(name: str, manifest: Optional[Dict] = None,
              base: Path = BENCH_DIR) -> Cell:
    """The cell ``name``: its entry, its configuration, its mix, the
    metrics it reports and its limits."""
    manifest = manifest or load_manifest(base.parent / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in the manifest")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(base.parent / conf["file"]) as f:
        config = json.load(f)
    with open(base / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(base / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), config, traffic, e2e, per_layer,
                limits, base)


def load_module(path: Path, tag: str) -> ModuleType:
    """Import the Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + re.sub(r"\W", "_", tag), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mode_module(mode: str, base: Path = BENCH_DIR) -> ModuleType:
    return load_module(base / "modes" / f"{mode}.py", f"mode_{mode}")


def metric_module(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return load_module(base / "metrics" / f"{name}.py", f"metric_{name}")


def family_module(family: str) -> ModuleType:
    """The architecture ``family``: ``families/<family>.py`` under
    ``FAMILIES_DIR``, loaded once (the reference asks for it at every
    forward)."""
    return _family(FAMILIES_DIR / f"{family}.py")


@functools.lru_cache(maxsize=None)
def _family(path: Path) -> ModuleType:
    return load_module(path, f"family_{path.stem}")


def problems(manifest: Dict, base: Path = BENCH_DIR) -> List[str]:
    """What in the manifest breaks the naming rules or names a file that is
    not there."""
    out = []

    def name_ok(what, v):
        if not isinstance(v, str) or not NAME.match(v):
            out.append(f"{what} {v!r} is not a valid name")

    for c in manifest["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
        if not (base.parent / c["file"]).is_file():
            out.append(f"config file {c['file']} is missing")
            continue
        with open(base.parent / c["file"]) as f:
            family = json.load(f)["model"]["family"]
        if not (base / "families" / f"{family}.py").is_file():
            out.append(f"families/{family}.py is missing")
    for w in manifest["workloads"]:
        for k in ("name", "config", "traffic"):
            name_ok(f"workload {k}", w[k])
        for sub, fname in (("traffic", f"{w['traffic']}.json"),
                           ("limits", f"{w['name']}.json")):
            if not (base / sub / fname).is_file():
                out.append(f"{sub}/{fname} is missing")
        if (base / "traffic" / f"{w['traffic']}.json").is_file():
            with open(base / "traffic" / f"{w['traffic']}.json") as f:
                mode = json.load(f)["mode"]
            if not (base / "modes" / f"{mode}.py").is_file():
                out.append(f"modes/{mode}.py is missing")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name_ok("metric", m["name"])
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']} is not valid")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better must be lower or higher")
    for m in manifest["per_layer"]:
        if not (base / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metrics/{m['name']}.py is missing")
    names = [c["name"] for c in manifest["configs"]]
    cells = [w["name"] for w in manifest["workloads"]]
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    for what, lst in (("config", names), ("workload", cells),
                      ("metric", metrics)):
        if len(set(lst)) != len(lst):
            out.append(f"two {what}s share a name")
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a configuration and traffic pair appears twice")
    return out
