"""The card's idle ms a batch while the host copies a batch to it: the
device idle time of the profiled batches while the innermost program span
is ``serve.copy``, over the profiled batches (``harness/spans.py::
idle_by_span``). None where the profile holds no such span."""

from benchmark.harness import spans


def read(m):
    if not m.profiled_steps:
        return None
    seconds = spans.idle_within(m.profile, ("serve.copy",))
    return None if seconds is None else 1e3 * seconds / m.profiled_steps
