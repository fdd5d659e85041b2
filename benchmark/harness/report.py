"""What a mode hands back, and the result line built from it."""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark.harness import checks, manifest
from benchmark.harness.manifest import Cell
from benchmark.harness.trace import Profile


@dataclasses.dataclass
class Context:
    """One run: the cell, ``--seed``, ``--seconds``, ``--trace`` and the
    process's start on the host clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: torch.device = torch.device("cuda")
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Measured:
    """What a mode measured, for the end-to-end metrics and the per-layer
    readers. ``wall_s`` and ``images`` are the measured window's (without
    the profiler); ``profile`` and ``profiled_steps`` (batches, serving) the
    profiled sub-window's; ``spans`` the benchmark's own spans, ms each, by
    name."""
    cell: Cell
    arch: Dict
    end_to_end: Dict[str, float]
    wall_s: float
    images: int
    micro: int
    accum: int
    attempted: int
    failed: int
    memory_peak_bytes: int
    profile: Optional[Profile] = None
    profiled_steps: int = 0
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    numbers: Dict[str, Tuple[float, str]] = dataclasses.field(default_factory=dict)


def per_layer_values(m: Measured) -> Dict[str, Dict]:
    """Each of the cell's per-layer metrics that its reader finds something
    to read for."""
    out = {}
    for metric in m.cell.per_layer:
        reader = manifest.metric_module(metric["name"], m.cell.base)
        value = reader.read(m)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def result(m: Measured, device: Dict, trace: bool,
           log: Callable[[str], None]) -> Dict:
    """The result object; the compared numbers go last, and to ``log``."""
    ok, compared = checks.judge(m.numbers, m.cell.limits)
    if trace:
        metrics = per_layer_values(m)
        device = dict(device, busy_s=m.profile.busy_s,
                      window_s=m.profile.window_s)
    else:
        units = {e["name"]: e["unit"] for e in m.cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in m.end_to_end.items() if k in units}
    out = {"correct": bool(ok and m.failed == 0), "attempted": m.attempted,
           "failed": m.failed, "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = m.profile.breakdown()
    out["compared"] = compared
    for name, c in compared.items():
        log(f"compared {name}: {c['value']!r} (limit {c['limit']!r}) at {c['at']}")
    return out


def dumps(obj: Dict) -> str:
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v
    return json.dumps(clean(obj))
