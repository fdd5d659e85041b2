"""The card's idle ms a step while the epoch loop's own host work runs: the
device idle time of the profiled steps while the innermost program span is
``train.fetch`` or ``train.augment`` (or the source's ``data.gather``,
which runs inside the fetch), over the profiled steps
(``harness/spans.py::idle_by_span``). Read under the profiler, whose host
cost lengthens these gaps: beside ``device_idle_pct.train``, not instead of
it. None where the profile holds no such span."""

from benchmark.harness import spans

LOOP = ("train.fetch", "train.augment", "data.gather")


def read(m):
    if not m.profiled_steps:
        return None
    seconds = spans.idle_within(m.profile, LOOP)
    return None if seconds is None else 1e3 * seconds / m.profiled_steps
