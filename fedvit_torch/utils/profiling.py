"""Profiling and tracing hooks — the port of ``fedvit_tpu/utils/profiling.py``.

* ``span(name)``        — a named stage of the program: the epoch loop's
                          fetch, augment and step, the train step's halves,
                          a source's gather, the serving step's copy,
                          augment and forward. While a ``torch.profiler``
                          runs, the span is a ``record_function`` range
                          named ``fedvit.<name>``, on the clock of the
                          card's kernels and copies in the same trace; it
                          always adds its host-clock duration to the
                          statistics of ``name``.
* ``span_stats(name)``  — those statistics: how many spans, their total,
                          and the last ``RECENT`` durations (seconds), or
                          None for a name no span has had
* ``reset_spans()``     — forget every name's statistics
* ``trace(log_dir)``    — a ``torch.profiler`` context over the host and,
                          for a run on the card, the card; writes a trace
                          that TensorBoard's profiler plugin reads into
                          ``log_dir``

``cli/train.py --profile`` goes through ``trace``, and the spans of the
profiled steps are in its trace. The profiler range is opened only while a
profiler is enabled: outside one a span costs two clock reads and an
update of its statistics, about a microsecond on the host, so spans sit at
the granularity of a step's stages (about ten a step), never a layer or a
kernel. A span launches nothing and touches no tensor: what it surrounds
computes the same bits with or without a profiler.

The JAX module's ``StepTimer`` (per-step wall times with a synchronise a
step) and ``annotate`` are not ported: the statistics of the ``train.step``
span give per-step host times without a synchronise that would stall the
card, and ``span`` is ``annotate`` with them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, Iterator, Optional, Tuple

import torch

PREFIX = "fedvit."      # the profiler range of span "x" is "fedvit.x"
RECENT = 4096           # durations each name keeps


class _Stats:
    __slots__ = ("count", "total_ns", "recent_ns")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.recent_ns: Deque[int] = collections.deque(maxlen=RECENT)


@dataclasses.dataclass(frozen=True)
class SpanStats:
    """One name's spans: ``count`` of them, ``total_s`` of host time, and
    the durations of the last ``RECENT`` (oldest first), in seconds."""
    count: int
    total_s: float
    recent_s: Tuple[float, ...]


_stats: Dict[str, _Stats] = {}
_lock = threading.Lock()        # sources gather on their prefetch threads
_profiler_enabled = torch._C._autograd._profiler_enabled
_now_ns = time.perf_counter_ns


class span:
    """``with span("train.step"): ...``: a named stage (module docstring)."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = _now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = _now_ns() - self._t0
        s = _stats.get(self.name)
        if s is None:
            s = _stats.setdefault(self.name, _Stats())
        _lock.acquire()
        s.count += 1
        s.total_ns += dt
        s.recent_ns.append(dt)
        _lock.release()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)


def span_stats(name: str) -> Optional[SpanStats]:
    """The statistics of the spans named ``name`` so far, or None."""
    with _lock:
        s = _stats.get(name)
        if s is None:
            return None
        return SpanStats(s.count, s.total_ns * 1e-9,
                         tuple(t * 1e-9 for t in s.recent_ns))


def reset_spans() -> None:
    with _lock:
        _stats.clear()


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
