"""The train augment's device ms a macro batch, by the program's own span:
the device time of the operations launched inside its ``train.augment``
spans (``fedvit_torch/train/loop.py::_train_epoch``: the batch's generator
and the augment) in the profiled steps (``Profile.launched_within``), over
the profiled steps. The program's twin of ``augment_ms.train``, which reads
the benchmark's own range around the same call. None where the profile holds
no such span."""

from benchmark.harness import spans


def read(m):
    if not m.profiled_steps or not spans.has_device_work(m.profile) or \
            not spans.ranges(m.profile, "train.augment"):
        return None
    seconds = m.profile.launched_within(spans.PREFIX + "train.augment")
    return 1e3 * seconds / m.profiled_steps
