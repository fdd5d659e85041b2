"""The train augment's device ms a macro batch: the device time of the
operations launched inside the augment's calls in the profiled steps (the
benchmark's ``record_function`` range around the augment it hands
``_train_epoch``; ``harness/trace.py::Profile.launched_within``), over the
profiled steps. Host gaps between those operations are not counted. None
where the profile holds no such range."""

from benchmark.harness.trace import AUGMENT


def read(m):
    if m.profile is None or m.profiled_steps == 0:
        return None
    seconds = m.profile.launched_within(AUGMENT)
    return 1e3 * seconds / m.profiled_steps if seconds > 0 else None
