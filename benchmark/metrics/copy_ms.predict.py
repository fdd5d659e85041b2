"""The serving step's copy of a host batch to the card: the median host ms
of the program's ``serve.copy`` spans (``fedvit_torch/eval/serve.py::
make_eval_step``'s ``_to_device``: pageable uint8 canvases, labels and
metadata), over the run's last 4,096 of them. None where the program keeps
no such span."""

from benchmark.harness import spans


def read(m):
    return spans.host_median_ms("serve.copy")
