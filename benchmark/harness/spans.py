"""The program's own spans in a profiled sub-window.

``fedvit_torch/utils/profiling.py::span`` puts each stage of the epoch loop,
the train and serve steps and the sources' gathers in a ``record_function``
range named ``fedvit.<name>`` while a profiler runs, and always keeps
host-clock statistics of it. This module reads them:

* ``idle_by_span``: the device's idle time in the sub-window, split by the
  innermost program span open at each instant of each gap (over the whole
  gap, not only at its start), the rest under ``OUTSIDE``; the parts sum to
  the sub-window's idle time; ``outside_by_host_op`` splits the rest by
  the innermost host operation, as the profile's own gaps name a gap by
  the operation open at its start;
* ``launches_within``: the kernel launches made inside a span (runtime or
  driver calls, ``LAUNCH_CATS``, whose correlation id a kernel carries; a
  graph launch counts once);
* ``host_median_ms``: the median of a span's recent host durations, from
  the program's ``span_stats``.

Device time launched inside a span is ``Profile.launched_within`` of its
range. Each returns None where the program has no such span (a program
without spans, or a profile without device operations), so that a reader
finds nothing rather than a number.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import (DEVICE_CATS, HOST_CATS, LAUNCH_CATS,
                                     WINDOW, Profile)

PREFIX = "fedvit."
OUTSIDE = "outside"
NO_OP = "host: no operation recorded"


def _events(profile: Profile) -> List[Dict]:
    return profile._events


def _window(events: List[Dict]) -> Tuple[float, float]:
    w = next(e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation")
    return float(w["ts"]), float(w["ts"]) + float(w["dur"])


def ranges(profile: Profile, name: str) -> List[Tuple[float, float]]:
    """(start, end) of each range of the program's span ``name``, in us."""
    full = PREFIX + name
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in _events(profile) if e.get("name") == full
                  and e.get("cat") == "user_annotation")


def has_device_work(profile: Optional[Profile]) -> bool:
    return profile is not None and profile.busy_s > 0


def _idle(events: List[Dict], w0: float, w1: float
          ) -> List[Tuple[float, float]]:
    """The sub-window's intervals with no device operation running."""
    dev = sorted((max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e.get("dur", 0)), w1))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    idle, t = [], w0
    for a, b in dev:
        if b <= a:
            continue
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if w1 > t:
        idle.append((t, w1))
    return idle


def _innermost(ranges_: List[Tuple[float, float, str]], w0: float,
               w1: float, none: str) -> List[Tuple[float, float, str]]:
    """[w0, w1] cut where a range opens or closes: each piece with the
    innermost range open over it (the latest to open, on any thread), or
    ``none``."""
    edges = sorted({w0, w1} | {min(max(x, w0), w1)
                               for a, b, _ in ranges_ for x in (a, b)})
    opens = sorted(ranges_)
    active: List[Tuple[float, float, str]] = []
    out, k = [], 0
    for a, b in zip(edges, edges[1:]):
        while k < len(opens) and opens[k][0] <= a:
            active.append(opens[k])
            k += 1
        active = [r for r in active if r[1] > a]
        inner = max(active, key=lambda r: (r[0], -r[1])) if active else None
        out.append((a, b, inner[2] if inner else none))
    return out


def _cut(intervals: List[Tuple[float, float]],
         ranges_: List[Tuple[float, float, str]], w0: float, w1: float,
         none: str) -> List[Tuple[float, float, str]]:
    """``intervals`` (sorted, disjoint, inside [w0, w1]) cut into pieces by
    the innermost of ``ranges_`` open over each."""
    pieces = _innermost(ranges_, w0, w1, none)
    out, j = [], 0
    for a, b in intervals:
        while pieces[j][1] <= a:
            j += 1
        for pa, pb, name in pieces[j:]:
            if pa >= b:
                break
            out.append((max(a, pa), min(b, pb), name))
    return out


def _idle_pieces(profile: Profile) -> List[Tuple[float, float, str]]:
    events = _events(profile)
    w0, w1 = _window(events)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["name"][len(PREFIX):]) for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    return _cut(_idle(events, w0, w1), spans, w0, w1, OUTSIDE)


def idle_by_span(profile: Profile) -> Dict[str, float]:
    """Idle seconds of the sub-window by the innermost program span (its
    name without ``fedvit.``) open over them; ``OUTSIDE`` where none was."""
    out: Dict[str, float] = defaultdict(float)
    for a, b, name in _idle_pieces(profile):
        out[name] += (b - a) * 1e-6
    return dict(out)


def outside_by_host_op(profile: Profile) -> Dict[str, float]:
    """The idle seconds outside every program span, by the innermost host
    operation (an operator or a runtime or driver call) open over them."""
    events = _events(profile)
    w0, w1 = _window(events)
    outside = [(a, b) for a, b, name in _idle_pieces(profile)
               if name == OUTSIDE]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    out: Dict[str, float] = defaultdict(float)
    for a, b, name in _cut(outside, ops, w0, w1, NO_OP):
        out[name] += (b - a) * 1e-6
    return dict(out)


def launches_within(profile: Profile, name: str) -> Optional[int]:
    """Kernel launches made inside the ranges of span ``name``; None where
    the profile has no such range or no device operation."""
    rs = ranges(profile, name)
    if not rs or not has_device_work(profile):
        return None
    events = _events(profile)
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"}
    kernels.discard(None)
    starts = [a for a, _ in rs]
    hit = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr not in kernels:
            continue
        t = float(e["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= rs[i][1]:
            hit.add(corr)
    return len(hit)


def idle_within(profile: Optional[Profile], names) -> Optional[float]:
    """Idle seconds while one of ``names`` is the innermost span; None
    where the profile has none of them or no device operation."""
    if not has_device_work(profile) or not any(ranges(profile, n)
                                               for n in names):
        return None
    split = idle_by_span(profile)
    return sum(split.get(n, 0.0) for n in names)


def host_median_ms(name: str) -> Optional[float]:
    """The median host ms of the last spans named ``name`` in this process
    (``span_stats``); None where the program keeps no such statistics."""
    try:
        from fedvit_torch.utils.profiling import span_stats
    except ImportError:
        return None
    stats = span_stats(name)
    if stats is None or not stats.recent_s:
        return None
    return 1e3 * statistics.median(stats.recent_s)
