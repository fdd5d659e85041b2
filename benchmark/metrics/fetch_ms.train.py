"""The epoch loop's fetch of a batch on the host: the median host ms of the
program's ``train.fetch`` spans (``fedvit_torch/train/loop.py::
_train_epoch``: the source's next batch, the sampler's plan on an epoch's
first, and the copy to the card), over the run's last 4,096 of them
(``harness/spans.py::host_median_ms``). None where the program keeps no such
span."""

from benchmark.harness import spans


def read(m):
    return spans.host_median_ms("train.fetch")
