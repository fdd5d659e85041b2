"""The port's spans (``fedvit_torch/utils/profiling.py::span``) on the CPU.

Without a profiler a span keeps host statistics and opens no profiler
range; under ``torch.profiler`` it is a ``record_function`` range named
``fedvit.<name>``. The epoch loop, the train step, the serving step and each
source's gather put their stages in spans, nested as ``_train_epoch`` calls
them, and a span changes no number: losses, parameters and logits are
bit-equal with a profiler running and without one. ``vit_tiny`` cut to 2
blocks (``tests/torch_dist.py::shallow``) at ``image_size`` 32, fp32. This
file imports no JAX: the data-parallel case runs its worker in spawned
processes.
"""

import copy
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fedvit_torch.core import config as tconfig
from fedvit_torch.data import pipeline as tpipe
from fedvit_torch.eval.serve import make_eval_step
from fedvit_torch.models import build_model
from fedvit_torch.train import loop as tloop
from fedvit_torch.train.losses import build_loss
from fedvit_torch.train.optim import build_optimizer
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_torch.utils import profiling
from fedvit_torch.utils.profiling import (RECENT, reset_spans, span,
                                          span_stats)

from tests import torch_dist

RAW = {
    "model": {"backbone": "vit_tiny_patch16_224", "image_size": 32,
              "compute_dtype": "float32", "drop_path_rate": 0.1,
              "metadata": {"enabled": True}},
    "data": {"use_segmentation_mask": True},
    "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                 "scheduler": {"warmup_epochs": 0}, "num_workers": 2},
}
STEP = ("train.augment", "train.step", "train.forward_backward",
        "train.update")


@pytest.fixture(autouse=True)
def fresh():
    """Each test on one torch thread, from empty statistics, with the
    ViT cut to 2 blocks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_spans()
    with torch_dist.shallow():
        yield
    torch.set_num_threads(threads)
    reset_spans()


def _cfg(**training):
    raw = copy.deepcopy(RAW)
    raw["training"].update(training)
    return tconfig.from_dict(raw)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, 48, 48, 4), dtype=np.uint8),
            "label": rng.integers(0, 8, n).astype(np.int32),
            "metadata": rng.random((n, 13)).astype(np.float32)}


def _profiled(fn):
    """(fn's result, the profiler's events) of ``fn()`` under a CPU
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _ranges(events, name):
    """(start, end) of each range named ``fedvit.<name>``, in order."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == profiling.PREFIX + name)


def _inside(inner, outer):
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def _epoch(cfg, source, seed=0):
    """One epoch of ``_train_epoch`` from a model seeded with ``seed``:
    (state, mean loss)."""
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    tx, _ = build_optimizer(cfg, model, steps_per_epoch=2)
    state = TrainState.create(model, tx, seed + 1)
    step = make_train_step(cfg, build_loss(cfg))
    macro = cfg.training.batch_size * cfg.training.gradient_accumulation_steps
    return tloop._train_epoch(step, state, source, macro,
                              np.random.default_rng(seed), True,
                              tpipe.make_device_augment(cfg, True), 42001,
                              "cpu")


class _Spy:
    """``torch.profiler.record_function`` that counts its ranges."""

    def __init__(self, real):
        self.real, self.names = real, []

    def __call__(self, name, *args):
        self.names.append(name)
        return self.real(name, *args)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", s)
    return s


# --- the span itself ------------------------------------------------------------

def test_without_a_profiler_a_span_keeps_statistics_and_opens_no_range(spy):
    for _ in range(3):
        with span("unit.work"):
            sum(range(100))
    s = span_stats("unit.work")
    assert spy.names == []
    assert s.count == 3 and len(s.recent_s) == 3
    assert all(t > 0 for t in s.recent_s)
    assert s.total_s == pytest.approx(sum(s.recent_s))


def test_under_a_profiler_a_span_is_a_range_with_its_prefix(spy):
    def work():
        with span("unit.outer"):
            with span("unit.inner"):
                torch.ones(8, 8).sum()
    _, events = _profiled(work)
    assert spy.names == ["fedvit.unit.outer", "fedvit.unit.inner"]
    outer, inner = _ranges(events, "unit.outer"), _ranges(events, "unit.inner")
    assert len(outer) == len(inner) == 1 and _inside(inner[0], outer)
    # the statistics are kept with a profiler too
    assert span_stats("unit.outer").count == span_stats("unit.inner").count == 1


def test_an_unknown_name_has_no_statistics_and_reset_forgets_them():
    assert span_stats("unit.never") is None
    with span("unit.once"):
        pass
    assert span_stats("unit.once").count == 1
    reset_spans()
    assert span_stats("unit.once") is None


def test_the_recent_durations_are_bounded():
    for _ in range(RECENT + 100):
        with span("unit.many"):
            pass
    s = span_stats("unit.many")
    assert s.count == RECENT + 100 and len(s.recent_s) == RECENT
    assert s.total_s >= sum(s.recent_s)


def test_a_span_whose_block_raises_counts_and_closes_its_range():
    def fails():
        with span("unit.fails"):
            raise KeyError("inside")

    def work():
        with pytest.raises(KeyError):
            fails()
        with span("unit.after"):
            pass
    _, events = _profiled(work)
    assert span_stats("unit.fails").count == 1
    (failed,), (after,) = _ranges(events, "unit.fails"), _ranges(events,
                                                                 "unit.after")
    assert failed[1] <= after[0]                # closed before the next opened


def test_spans_on_many_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span of one
    name is counted and its duration added."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(500):
                with span("unit.shared"):
                    pass
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    s = span_stats("unit.shared")
    assert s.count == 16 * 500 and len(s.recent_s) == RECENT
    assert s.total_s >= sum(s.recent_s) > 0


# --- the program's spans ----------------------------------------------------------

def test_the_epoch_loop_spans_each_stage_once_a_step_nested():
    """Two steps of 2 x 4 from an ``ArrayDataSource``: a fetch a step (its
    gather inside it) and the fetch that ends the epoch, then an augment
    and a step a step, the step's forward-backward and update inside it, no
    all-reduce on one process, and one read of the epoch's losses."""
    cfg = _cfg()
    _, events = _profiled(lambda: _epoch(cfg, tpipe.ArrayDataSource(_data(16))))
    r = {n: _ranges(events, n) for n in STEP + (
        "train.fetch", "train.epoch_end", "train.allreduce", "data.gather")}
    assert [len(r[n]) for n in STEP] == [2, 2, 2, 2]
    assert len(r["train.fetch"]) == 3 and len(r["data.gather"]) == 2
    assert len(r["train.epoch_end"]) == 1 and r["train.allreduce"] == []
    assert all(_inside(g, r["train.fetch"]) for g in r["data.gather"])
    for inner in ("train.forward_backward", "train.update"):
        assert all(_inside(x, r["train.step"]) for x in r[inner])
    order = sorted((a, n) for n in ("train.fetch", "train.augment",
                                    "train.step", "train.epoch_end")
                   for a, _ in r[n])
    assert [n for _, n in order] == [
        "train.fetch", "train.augment", "train.step"] * 2 + [
        "train.fetch", "train.epoch_end"]


def test_the_epoch_loop_keeps_host_statistics_without_a_profiler(spy):
    _epoch(_cfg(), tpipe.ArrayDataSource(_data(16)))
    counts = {n: span_stats(n).count for n in STEP + ("train.fetch",
                                                      "train.epoch_end")}
    assert counts == {"train.augment": 2, "train.step": 2,
                      "train.forward_backward": 2, "train.update": 2,
                      "train.fetch": 3, "train.epoch_end": 1}
    assert spy.names == []


def test_a_fused_augment_is_a_span_before_the_forward_backward():
    cfg = _cfg()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tx, _ = build_optimizer(cfg, model, steps_per_epoch=2)
    state = TrainState.create(model, tx, 1)
    step = make_train_step(cfg, build_loss(cfg),
                           tpipe.make_device_augment(cfg, True))
    _, events = _profiled(lambda: step(state, _data(8)))
    (aug,), (fb,), (upd,) = (_ranges(events, n) for n in (
        "train.augment", "train.forward_backward", "train.update"))
    assert aug[1] <= fb[0] and fb[1] <= upd[0]


def test_the_serving_step_spans_its_copy_augment_and_forward():
    cfg = _cfg()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    step = make_eval_step(model, cfg, tpipe.make_device_augment(cfg, False))
    _, events = _profiled(lambda: step(_data(4)))
    (copy_,), (aug,), (fwd,) = (_ranges(events, n) for n in (
        "serve.copy", "serve.augment", "serve.forward"))
    assert copy_[1] <= aug[0] and aug[1] <= fwd[0]
    assert all(span_stats(n).count == 1
               for n in ("serve.copy", "serve.augment", "serve.forward"))


def _host_source(tmp_path, n):
    import pandas as pd
    from PIL import Image
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        p = tmp_path / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    df = pd.DataFrame({"image_path": paths, "label": np.arange(n) % 3})
    raw = copy.deepcopy(RAW)
    raw["data"] = {"use_segmentation_mask": False, "prefetch_batches": 2}
    return tpipe.HostDataSource(df, tconfig.from_dict(raw))


@pytest.mark.parametrize("kind", ["array", "host", "device"])
def test_each_sources_gather_is_a_span(kind, tmp_path):
    """A gather, an epoch's batches and the sequential batches: one
    ``data.gather`` a batch, also on the host source's prefetch thread."""
    if kind == "host":
        source = _host_source(tmp_path, 6)
    else:
        source = tpipe.ArrayDataSource(_data(6))
        if kind == "device":
            source = tpipe.DeviceDataSource(source, "cpu")
    reset_spans()                       # the device source's upload gathers
    source.gather(np.arange(2))
    list(source.epoch_batches(2, np.random.default_rng(0), False))
    list(source.sequential_batches(4))
    assert span_stats("data.gather").count == 1 + 3 + 2


def test_training_is_bit_equal_under_a_profiler():
    cfg = _cfg()
    plain_state, plain_loss = _epoch(cfg, tpipe.ArrayDataSource(_data(16)))
    (state, loss), _ = _profiled(
        lambda: _epoch(cfg, tpipe.ArrayDataSource(_data(16))))
    assert loss == plain_loss and np.isfinite(loss)
    for (n, a), b in zip(plain_state.model.state_dict().items(),
                         state.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(plain_state.generator.get_state(),
                       state.generator.get_state())


def test_logits_are_bit_equal_under_a_profiler():
    cfg = _cfg()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    step = make_eval_step(model, cfg, tpipe.make_device_augment(cfg, False))
    batch = _data(4, seed=5)
    plain = step(batch)
    traced, _ = _profiled(lambda: step(batch))
    assert torch.equal(plain, traced)


def test_the_data_parallel_step_spans_its_all_reduce(tmp_path):
    """On two gloo ranks a step's gradients are all-reduced once, inside
    ``train.allreduce``, on each rank."""
    raw = copy.deepcopy(RAW)
    raw["training"].update({"data_parallel": True,
                            "gradient_accumulation_steps": 1})
    batch = dict(_data(4), image=np.random.default_rng(1).normal(
        size=(4, 32, 32, 4)).astype(np.float32))       # augmented already
    got = torch_dist.run_world(torch_dist.step_span_counts, 2, tmp_path, raw,
                               batch)
    want = {"train.augment": 0, "train.forward_backward": 1,
            "train.allreduce": 1, "train.update": 1}
    assert got == [want, want]
