"""A short profiled sub-window, read into the device's busy time, its
operations by name and its idle gaps by what the host was doing.

``torch.profiler`` records the host's operations and the device's kernels,
copies and sets on one clock. The sub-window is a ``record_function`` range
that ends with a synchronise, so every device operation it started ends
inside it. Device time can also be taken by what launched it: the operations
whose launch (a runtime or driver call, matched by its correlation id) lies
inside a named host range, such as the benchmark's ``record_function`` range
around the train augment. The trace goes through a Chrome trace file in a temporary
directory (under ``TMPDIR``), removed once read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import shutil
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Tuple

import torch

WINDOW = "bench_window"
AUGMENT = "bench_augment"     # the train augment's calls in a profiled window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op",) + LAUNCH_CATS


class Profile:
    """What one profiled sub-window shows."""

    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the profile holds no benchmark window")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = []
        self.ops: Dict[str, float] = defaultdict(float)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                self.ops[e["name"]] += (b - a) * 1e-6
        dev.sort()
        merged: List[List[float]] = []
        for a, b in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                       e["name"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
        self.gaps: Dict[str, float] = defaultdict(float)
        self._events = events
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                self.gaps[_host_at(host, a)] += (b - a) * 1e-6

    def seconds(self, patterns: Iterable[str]) -> Tuple[float, int]:
        """Device seconds and distinct names of the operations whose names
        match one of ``patterns`` (regular expressions)."""
        pats = [re.compile(p) for p in patterns]
        hit = {n: s for n, s in self.ops.items()
               if any(p.search(n) for p in pats)}
        return sum(hit.values()), len(hit)

    def launched_within(self, annotation: str) -> float:
        """Device seconds of the operations launched inside the host ranges
        named ``annotation`` (the sum of their durations: one stream)."""
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in self._events if e.get("name") == annotation
                        and e.get("cat") == "user_annotation")
        starts = [a for a, _ in ranges]
        launches = set()
        for e in self._events:
            if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS:
                continue
            t = float(e["ts"])
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                launches.add(e.get("args", {}).get("correlation"))
        launches.discard(None)
        return sum(float(e.get("dur", 0)) for e in self._events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                   and e.get("args", {}).get("correlation") in launches) * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


def _host_at(host: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host operation running at ``t``: of those that cover
    it, the latest to start (looked for among the 500 that start last
    before it)."""
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for ev in reversed(host[max(0, i - 500):i]):
        if ev[1] >= t:
            return ev[2]
    return "host: no operation recorded"


@contextlib.contextmanager
def profiled() -> Iterator[List[Profile]]:
    """``with profiled() as out: ...`` profiles the block as one window,
    which must end with a synchronise; ``out[0]`` is its ``Profile``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: List[Profile] = []
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                yield out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        out.append(Profile(events))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
