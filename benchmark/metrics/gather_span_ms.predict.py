"""The host's gather of a serving batch, by the program's own span: the
median host ms of its ``data.gather`` spans (``fedvit_torch/data/
pipeline.py::ArrayDataSource.gather``), over the run's last 4,096 of them.
The program's twin of ``gather_ms.predict``, which times the same call from
the benchmark's loop. None where the program keeps no such span."""

from benchmark.harness import spans


def read(m):
    return spans.host_median_ms("data.gather")
