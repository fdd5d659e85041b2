"""The readers of the program's own spans (``harness/spans.py`` and the ten
metrics that use it) on hand-made traces, and one traced run of each mode on
the CPU, where only the host-clock readings have something to read."""

import dataclasses
import time
import types

import pytest

from benchmark import run
from benchmark.harness import manifest, spans
from benchmark.harness.trace import WINDOW, Profile
from benchmark.tests.tiny import tiny_cell

SEED = 3 * 10 ** 9 + 17
TRAIN = ("fetch_ms.train", "augment_device_ms.train", "update_ms.train",
         "launches.train", "loop_idle_ms.train")
PREDICT = ("gather_span_ms.predict", "copy_ms.predict",
           "gather_idle_ms.predict", "copy_idle_ms.predict",
           "launches.predict")
HOST = ("fetch_ms.train", "gather_span_ms.predict", "copy_ms.predict")


def ev(cat, name, ts, dur, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def span(name, ts, dur):
    return ev("user_annotation", spans.PREFIX + name, ts, dur)


# a serving batch in [0, 100] us: the device busy 0-10, 58-59 and 60-70; a
# fetch 15-40 holds its gather 20-40, then the copy 40-55, which launches a
# kernel; the forward 56-75 launches three kernels (a runtime call with the
# driver call under it, a driver call, a graph of two), a memcpy and a set;
# the next gather 80-90 after the logits read
SERVE = [
    ev("user_annotation", WINDOW, 0.0, 100.0),
    ev("kernel", "prev_kernel", 0.0, 10.0, correlation=1),
    span("train.fetch", 15.0, 25.0),
    span("data.gather", 20.0, 20.0),
    span("serve.copy", 40.0, 15.0),
    ev("cuda_runtime", "cudaLaunchKernel", 50.0, 1.0, correlation=2),
    span("serve.forward", 56.0, 19.0),
    ev("cuda_runtime", "cudaLaunchKernel", 57.0, 1.0, correlation=3),
    ev("cuda_driver", "cuLaunchKernel", 57.2, 0.5, correlation=3),
    ev("cuda_driver", "cuLaunchKernel", 59.0, 1.0, correlation=4),
    ev("cuda_runtime", "cudaGraphLaunch", 61.0, 1.0, correlation=5),
    ev("cuda_runtime", "cudaMemcpyAsync", 63.0, 1.0, correlation=6),
    ev("cuda_runtime", "cudaMemsetAsync", 64.0, 1.0, correlation=7),
    ev("kernel", "copy_kernel", 60.0, 2.0, correlation=2),
    ev("kernel", "k3", 62.0, 2.0, correlation=3),
    ev("kernel", "k4", 64.0, 2.0, correlation=4),
    ev("kernel", "graph_a", 66.0, 2.0, correlation=5),
    ev("kernel", "graph_b", 68.0, 1.0, correlation=5),
    ev("gpu_memcpy", "Memcpy DtoH", 69.0, 1.0, correlation=6),
    ev("gpu_memset", "Memset", 58.0, 1.0, correlation=7),
    span("data.gather", 80.0, 10.0),
]


def test_the_idle_time_is_split_over_each_whole_gap():
    """The gap 10-58 runs through the fetch, its gather, the copy and the
    forward; the gap 59-60 lies in the forward; 70-100 through the
    forward's end and the next gather."""
    p = Profile(SERVE)
    split = spans.idle_by_span(p)
    want = {"outside": 5 + 1 + 5 + 10, "train.fetch": 5,
            "data.gather": 20 + 10, "serve.copy": 15,
            "serve.forward": 2 + 1 + 5}
    assert set(split) == set(want)
    for name, us in want.items():
        assert split[name] == pytest.approx(us * 1e-6), name
    # the parts are the sub-window's idle time
    assert sum(split.values()) == pytest.approx(p.window_s - p.busy_s)
    # the profile's own gaps name each by its start alone
    assert p.gaps["host: no operation recorded"] > 0


def test_the_idle_time_outside_the_spans_is_split_by_host_operation():
    """The logits read 5-12 holds the gap's first 2 us outside any span;
    a host operator 92-96 four more; nothing recorded over the other 15."""
    p = Profile(SERVE + [
        ev("cuda_runtime", "cudaMemcpyAsync", 5.0, 7.0, correlation=9),
        ev("cpu_op", "aten::to", 92.0, 4.0)])
    split = spans.outside_by_host_op(p)
    assert split == pytest.approx({"cudaMemcpyAsync": 2e-6, "aten::to": 4e-6,
                                   spans.NO_OP: 15e-6})
    assert sum(split.values()) == pytest.approx(
        spans.idle_by_span(p)[spans.OUTSIDE])


def test_launches_are_counted_inside_their_span_once_each():
    p = Profile(SERVE)
    # correlation 3 (a runtime call and the driver call under it) once,
    # 4 (the driver's), 5 (a graph of two kernels) once; not the memcpy,
    # the set, or the copy's launch outside the forward
    assert spans.launches_within(p, "serve.forward") == 3
    assert spans.launches_within(p, "serve.copy") == 1
    assert spans.launches_within(p, "train.step") is None


def measured(profile, steps):
    return types.SimpleNamespace(profile=profile, profiled_steps=steps)


def test_the_device_readers_read_their_spans():
    events = [ev("user_annotation", WINDOW, 0.0, 100.0),
              span("train.fetch", 0.0, 10.0), span("data.gather", 2.0, 4.0),
              span("train.augment", 10.0, 20.0),
              span("train.step", 30.0, 60.0), span("train.update", 70.0, 15.0),
              ev("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, correlation=1),
              ev("cuda_runtime", "cudaLaunchKernel", 40.0, 1.0, correlation=2),
              ev("cuda_runtime", "cudaLaunchKernel", 75.0, 1.0, correlation=3),
              ev("kernel", "augment", 15.0, 25.0, correlation=1),
              ev("kernel", "forward", 40.0, 40.0, correlation=2),
              ev("kernel", "adam", 80.0, 6.0, correlation=3)]
    m = measured(Profile(events), 2)
    read = {n: manifest.metric_module(n).read(m) for n in TRAIN}
    assert read["augment_device_ms.train"] == pytest.approx(25e-3 / 2)
    assert read["update_ms.train"] == pytest.approx(6e-3 / 2)
    assert read["launches.train"] == 1.0        # the step's; the update's
    # idle 0-15 under the fetch (0-2, 6-10), its gather (2-6) and the
    # augment (10-15); 86-100 outside
    assert read["loop_idle_ms.train"] == pytest.approx(15e-3 / 2)


def test_the_serving_readers_read_their_spans():
    m = measured(Profile(SERVE), 1)
    read = {n: manifest.metric_module(n).read(m) for n in PREDICT[2:]}
    assert read == pytest.approx({"gather_idle_ms.predict": 30e-3,
                                  "copy_idle_ms.predict": 15e-3,
                                  "launches.predict": 3.0})


@pytest.mark.parametrize("metric", TRAIN + PREDICT)
def test_nothing_to_read_where_the_span_is_absent(metric, monkeypatch):
    """A profile without the program's spans (the parent's), no profile,
    and a program without ``span_stats``."""
    from fedvit_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_stats")
    read = manifest.metric_module(metric).read
    bare = [e for e in SERVE if not e["name"].startswith(spans.PREFIX)]
    assert read(measured(Profile(bare), 1)) is None
    assert read(measured(None, 0)) is None


def test_the_host_readers_take_the_median_of_the_programs_spans(monkeypatch):
    from fedvit_torch.utils import profiling
    clock = iter([0, 2_000_000, 10_000_000, 19_000_000, 20_000_000,
                  21_000_000])                           # 2, 9 and 1 ms
    monkeypatch.setattr(profiling, "_now_ns", lambda: next(clock))
    profiling.reset_spans()
    try:
        for _ in range(3):
            with profiling.span("serve.copy"):
                pass
        monkeypatch.undo()
        read = manifest.metric_module("copy_ms.predict").read
        assert read(measured(None, 0)) == pytest.approx(2.0)
        assert manifest.metric_module("gather_span_ms.predict").read(
            measured(None, 0)) is None
    finally:
        profiling.reset_spans()


@pytest.mark.parametrize("family,mode,cell", [
    ("vit", "train_epoch", "vitb224-train-1x128"),
    ("swinv2", "predict", "swinv2l384-predict-b32")])
def test_a_traced_run_on_the_cpu_reports_the_host_readings(family, mode,
                                                           cell):
    """The real cell's per-layer metrics on a tiny cell: the program's spans
    give the host-clock readings; with no device operation in the profile
    the device readings find nothing."""
    from fedvit_torch.utils.profiling import reset_spans
    reset_spans()
    tiny = tiny_cell(family, mode=mode,
                     resident=16 if mode == "train_epoch" else 8)
    tiny = dataclasses.replace(tiny,
                               per_layer=manifest.load_cell(cell).per_layer)
    code, out = run.execute(tiny, SEED, 1.0, True, time.time(), "cpu",
                            log=lambda s: None)
    assert code == 0 and out["correct"]
    names = TRAIN if mode == "train_epoch" else PREDICT
    got = {n for n in names if n in out["metrics"]}
    assert got == set(HOST) & set(names)
    assert all(out["metrics"][n]["value"] > 0 for n in got)
