"""Kernel launches a training step: the runtime and driver calls made
inside the program's ``train.step`` spans (the step alone; the epoch loop's
fetch and augment are outside it) whose correlation id a kernel carries, in
the profiled steps, over the profiled steps (``harness/spans.py::
launches_within``). None where the profile holds no such span."""

from benchmark.harness import spans


def read(m):
    if not m.profiled_steps:
        return None
    n = spans.launches_within(m.profile, "train.step")
    return None if n is None else n / m.profiled_steps
