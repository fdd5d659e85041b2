"""Kernel launches a serving batch: the runtime and driver calls made
inside the program's ``serve.forward`` spans (the model's forward; the copy
and the eval augment are outside it) whose correlation id a kernel carries,
in the profiled batches, over the profiled batches (``harness/spans.py::
launches_within``). None where the profile holds no such span."""

from benchmark.harness import spans


def read(m):
    if not m.profiled_steps:
        return None
    n = spans.launches_within(m.profile, "serve.forward")
    return None if n is None else n / m.profiled_steps
