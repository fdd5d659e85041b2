"""The optimizer update's device ms a step: the device time of the
operations launched inside the program's ``train.update`` spans
(``fedvit_torch/train/step.py::TrainStep.apply_update``: the global norm,
the clip, AdamW-LLRD and the EMA) in the profiled steps, over the profiled
steps. None where the profile holds no such span."""

from benchmark.harness import spans


def read(m):
    if not m.profiled_steps or not spans.has_device_work(m.profile) or \
            not spans.ranges(m.profile, "train.update"):
        return None
    seconds = m.profile.launched_within(spans.PREFIX + "train.update")
    return 1e3 * seconds / m.profiled_steps
