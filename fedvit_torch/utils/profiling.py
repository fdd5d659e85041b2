"""Profiling and tracing hooks — the port of ``fedvit_tpu/utils/profiling.py``.

* ``trace(log_dir)``  — a ``torch.profiler`` context over the host and, for a
                        run on the card, the card; writes a trace that
                        TensorBoard's profiler plugin reads into ``log_dir``
* ``StepTimer``       — per-step wall-clock stats with warm-up-step exclusion
* ``annotate(name)``  — a named range in the trace for host-side phases

``cli/train.py --profile`` goes through ``trace``. ``StepTimer`` and
``annotate`` have no caller in the package, as in the JAX module: they are
kept so that code written against that module's API runs here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, schedule: Optional[Callable] = None,
          cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """Record CPU and, with ``cuda`` (by default: when CUDA is available),
    CUDA activity and write it into ``log_dir`` as ``*.pt.trace.json``; a run
    on the CPU passes ``cuda=False``. Without ``schedule`` the whole
    block is recorded and written on exit; with one
    (``torch.profiler.schedule``) the caller steps the yielded profiler once
    a step and the trace is written when the schedule's active steps end (or
    on exit, if the run has fewer)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if cuda is None:
        cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, schedule=schedule,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Track per-step times; the first ``skip`` steps (warm-up) are left out
    of the stats. CUDA launches return before the card has run them, so with
    CUDA initialised a step ends with a synchronise: its time is the
    device's, as a JAX caller's ``block_until_ready`` gives."""

    def __init__(self, skip: int = 2):
        self.skip = skip
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def stats(self) -> Dict[str, float]:
        xs = self.times[self.skip:] or self.times
        if not xs:
            return {"mean_s": 0.0, "p50_s": 0.0, "max_s": 0.0, "steps": 0}
        xs_sorted = sorted(xs)
        return {
            "mean_s": sum(xs) / len(xs),
            "p50_s": xs_sorted[len(xs) // 2],
            "max_s": xs_sorted[-1],
            "steps": len(xs),
        }
