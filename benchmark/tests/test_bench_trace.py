"""The profile reader and the readers of the profile-based metrics, on
hand-made traces."""

import types

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import AUGMENT, WINDOW, Profile


def ev(cat, name, ts, dur, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


EVENTS = [
    ev("user_annotation", WINDOW, 100.0, 100.0),
    ev("kernel", "window_mma_fwd_kernel<true, false, true>", 90.0, 30.0),
    ev("kernel", "void (anonymous namespace)::dkdv_mma_kernel<false>", 115.0, 20.0),
    ev("kernel", "void attn_bwd::delta_kernel<64>", 150.0, 10.0),
    ev("gpu_memcpy", "Memcpy HtoD", 170.0, 10.0),
    ev("kernel", "late", 195.0, 20.0),
    ev("cpu_op", "aten::mm", 130.0, 30.0),
    ev("cuda_runtime", "cudaLaunchKernel", 140.0, 5.0),
    ev("cpu_op", "aten::copy_", 160.0, 5.0),
]


def test_busy_time_window_and_gaps():
    p = Profile(EVENTS)
    assert abs(p.window_s - 100e-6) < 1e-12
    # device intervals clipped to [100, 200]: 100-135, 150-160, 170-180, 195-200
    assert abs(p.busy_s - 60e-6) < 1e-12
    # gaps 135-150 (inside aten::mm), 160-170 (aten::copy_ covers 160),
    # 180-195 (nothing)
    assert abs(p.gaps["aten::mm"] - 15e-6) < 1e-12
    assert abs(p.gaps["aten::copy_"] - 10e-6) < 1e-12
    assert abs(p.gaps["host: no operation recorded"] - 15e-6) < 1e-12


def test_kernel_groups_and_breakdown():
    p = Profile(EVENTS)
    k6 = r"(?<!attn_bwd::)\b(delta|dkdv_mma|dq_mma|dbias_mma)_kernel\b"
    secs, names = p.seconds([k6])
    assert names == 1 and abs(secs - 20e-6) < 1e-12   # not attn_bwd's delta
    b = p.breakdown(top=2)
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2
    assert b["device_ops"][0][0].startswith("window_mma_fwd_kernel")


# two augment calls on the host (100-120, 150-160); kernels 1 and 3 were
# launched inside them (one by the driver API), 2 and 4 outside, and each
# ran later on the device
LAUNCHES = [
    ev("user_annotation", WINDOW, 100.0, 200.0),
    ev("user_annotation", AUGMENT, 100.0, 20.0),
    ev("user_annotation", AUGMENT, 150.0, 10.0),
    ev("cuda_runtime", "cudaLaunchKernel", 105.0, 2.0, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 125.0, 2.0, correlation=2),
    ev("cuda_driver", "cuLaunchKernel", 155.0, 2.0, correlation=3),
    ev("cuda_runtime", "cudaMemcpyAsync", 170.0, 2.0, correlation=4),
    ev("kernel", "equalize_kernel", 130.0, 7.0, correlation=1),
    ev("kernel", "gemm", 140.0, 30.0, correlation=2),
    ev("kernel", "shift_kernel", 175.0, 5.0, correlation=3),
    ev("gpu_memcpy", "Memcpy HtoD", 185.0, 4.0, correlation=4),
]


def test_device_time_by_the_range_that_launched_it():
    p = Profile(LAUNCHES)
    assert abs(p.launched_within(AUGMENT) - 12e-6) < 1e-12
    assert p.launched_within("no such range") == 0.0


def measured(profile, steps, wall_s, micro=8, accum=2):
    return types.SimpleNamespace(profile=profile, profiled_steps=steps,
                                 images=100 * micro * accum, micro=micro,
                                 accum=accum, wall_s=wall_s)


@pytest.mark.parametrize("metric", ["device_idle_pct.train",
                                    "device_idle_pct.predict"])
def test_the_idle_share_is_the_windows(metric):
    """Busy 46 us in 2 profiled steps: 23 us a step; 100 steps in the
    window's 4.6 ms would leave the card idle 50% of it. (A predict batch
    is ``micro`` images.)"""
    m = measured(Profile(LAUNCHES), 2, 4.6e-3, accum=2 if "train" in metric
                 else 1)
    if "predict" in metric:
        m.images = 100 * m.micro
    read = manifest.metric_module(metric).read
    assert read(m) == pytest.approx(50.0)
    assert read(measured(None, 0, 1.0)) is None


def test_the_augment_ms_reads_its_range():
    read = manifest.metric_module("augment_ms.train").read
    assert read(measured(Profile(LAUNCHES), 2, 1.0)) == pytest.approx(6e-3)
    assert read(measured(Profile(EVENTS), 1, 1.0)) is None
