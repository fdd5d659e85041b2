"""The host's gather of a serving batch from host canvases: the median, over
the measured window's batches, of the host clock around
``ArrayDataSource.sequential_batches`` yielding it."""

import statistics


def read(m):
    ms = m.spans.get("gather_ms")
    return statistics.median(ms) if ms else None
