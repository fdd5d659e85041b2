"""The program's spans in one traced run of a cell, and what a span costs.

    python3 benchmark/span_report.py --workload <name> --seed <n> --seconds <s>
    python3 benchmark/span_report.py --cost

With ``--workload`` it runs the cell as ``run.py --trace 1`` does and prints,
for the profiled sub-window, the device's idle ms a step (a batch, serving)
split by the innermost program span (``harness/spans.py::idle_by_span``,
every ``fedvit.*`` span and ``outside``) beside the profile's idle time, the
``outside`` part by the innermost host operation, and
for each span its ranges, kernel launches and device ms launched inside it a
step, and its host median from the program's ``span_stats``; then the cell's
per-layer metrics. With ``--cost`` it times ``fedvit_torch.utils.profiling.
span`` in a loop with no profiler running and under a CPU and CUDA
profiler. Each report is one JSON line on standard output. It needs a card
for ``--workload``, as ``run.py`` does.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NAMES = ("train.fetch", "train.augment", "train.step",
         "train.forward_backward", "train.allreduce", "train.update",
         "train.epoch_end", "data.gather", "serve.copy", "serve.augment",
         "serve.forward")


def span_cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    """Microseconds a span costs with no profiler and under one, less an
    empty loop's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedvit_torch.utils.profiling import reset_spans, span

    def per_span(n):
        t = time.perf_counter()
        for _ in range(n):
            with span("cost.probe"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    def empty(n):
        t = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t) / n * 1e6

    per_span(1000)
    base = min(empty(n_off) for _ in range(3))
    off = [per_span(n_off) - base for _ in range(3)]
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        on = [per_span(n_on) - base for _ in range(3)]
    reset_spans()
    return {"off_us": off, "on_us": on, "loop_us": base}


def cell_report(cell, seed: int, seconds: float, dev) -> dict:
    """The report of one traced run of ``cell`` on ``dev``."""
    from benchmark.harness import checks, manifest, report, spans

    ctx = report.Context(cell, seed, seconds, True, T0, dev)
    m = manifest.mode_module(cell.mode).run(ctx)
    p, k = m.profile, m.profiled_steps
    split = spans.idle_by_span(p)
    per_span = {}
    for name in NAMES:
        rs = spans.ranges(p, name)
        if not rs:
            continue
        launches = spans.launches_within(p, name)
        per_span[name] = {
            "ranges": len(rs),
            "launches_per_step": None if launches is None else launches / k,
            "device_ms_per_step": 1e3 * p.launched_within(
                spans.PREFIX + name) / k,
            "host_median_ms": spans.host_median_ms(name)}
    return {"workload": cell.name, "seed": seed, "profiled_steps": k, "window_ms": 1e3 * p.window_s,
            "idle_ms": 1e3 * (p.window_s - p.busy_s),
            "idle_ms_per_step_by_span": {n: 1e3 * s / k
                                         for n, s in sorted(split.items())},
            "idle_split_sum_ms": 1e3 * sum(split.values()),
            "outside_ms_per_step_by_host_op": dict(sorted(
                ((n, 1e3 * s / k) for n, s in
                 spans.outside_by_host_op(p).items()),
                key=lambda kv: -kv[1])[:12]),
            "spans": per_span,
            "idle_gaps_by_start": p.breakdown()["idle_gaps"],
            "per_layer": report.per_layer_values(m),
            "correct": bool(checks.judge(m.numbers, cell.limits)[0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--cost", action="store_true")
    args = p.parse_args(argv)
    if args.cost:
        print(json.dumps({"span_cost": span_cost()}), flush=True)
    if args.workload:
        import torch

        from benchmark.harness import device, manifest
        cell = manifest.load_cell(args.workload)
        device.require_cards(cell.chips)
        device.keep_caches_in(ROOT)
        out = cell_report(cell, args.seed, args.seconds, torch.device("cuda"))
        print(json.dumps(dict(out, card=device.card_line())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
