"""The benchmark of ``fedvit_torch`` on NVIDIA H100 cards.

Run one cell from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell asks for and exits with code 2,
printing no result, without them; it never falls back to the CPU. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown`` (the profiled sub-window's longest device operations and idle
gaps), and last ``compared``: each number that decided ``correct`` beside
its limit. The same numbers are the last lines of standard error.

Layout (everything the harness finds by name, see ``harness/manifest.py``):

    BENCHMARK.json             the cells, configurations and metrics
    benchmark/configs/         a configuration: its published sizes
                               (``model``) and the program's settings
                               (``program``, the fedvit_torch schema)
    benchmark/traffic/         a mix: its mode and that mode's parameters
    benchmark/modes/           the code that drives the program for a mode
                               (``train_epoch``, ``predict``)
    benchmark/families/        an architecture (a configuration's
                               ``model.family``): its backbone's
                               parameters, reference forward, operation
                               counts, attention kernel names, tiny CPU size
    benchmark/metrics/         a per-layer metric: ``read(measured)``
                               returns its value, or None where the run has
                               nothing for it to read
    benchmark/limits/          a cell's correctness limits
    benchmark/reference/       the plain reference (imports no program code)
    benchmark/harness/         inputs from the seed, counts of operations
                               and bytes, the profile reader, the checks

To add a cell, write ``traffic/<mix>.json`` (an existing mode and its
parameters) and ``limits/<cell>.json``, and add the cell to ``workloads`` in
``BENCHMARK.json``; a configuration is ``configs/<name>.json`` and an entry
in ``configs``; a mode is ``modes/<mode>.py`` with ``run(context) →
Measured``; a per-layer metric is ``metrics/<name>.py`` with ``read`` and an
entry in ``per_layer``. No file that is there needs an edit.

A new architecture is new files only: ``families/<family>.py``,
``configs/<name>.json``, ``traffic/<mix>.json`` and ``limits/<cell>.json``;
entries in ``configs``, ``workloads`` and ``per_layer``; and the new cell's
name added to the ``workloads`` list of each end-to-end metric it reports.

The port's kernels build on a checkout's first run into ``build/kernels/``
(``fedvit_torch/core/kernels.py``: nvcc for sm_90a, a library a source,
named by the hash of its source and flags), and every later run there loads
them; torch's and Triton's caches are pointed at ``build/`` as well. The
correctness tests of the harness itself: ``python -m pytest
benchmark/tests``. ``benchmark/calibrate.py`` reads the numbers the limits
were set from.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def execute(cell, seed: int, seconds: float, trace: bool, t0: float,
            device=None, log=None):
    """One run of ``cell`` on ``device`` (the card unless a test passes the
    CPU): (exit code, result object or None)."""
    import torch

    from benchmark.harness import device as devices
    from benchmark.harness import manifest, report

    dev = torch.device("cuda") if device is None else torch.device(device)
    ctx = report.Context(cell, seed, seconds, trace, t0, dev)
    if log is not None:
        ctx.log = log
    measured = manifest.mode_module(cell.mode, cell.base).run(ctx)
    if dev.type == "cuda":
        record = devices.device_record(cell.chips)
    else:
        record = {"platform": "cpu", "kind": "cpu", "count": 1}
    record["memory_peak_bytes"] = measured.memory_peak_bytes
    out = report.result(measured, record, trace, ctx.log)
    found = devices.forbidden_modules()
    if found:
        ctx.log(f"benchmark: the run loaded {found}: no result")
        return 3, None
    return 0, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import device, manifest, report

    cell = manifest.load_cell(args.workload)
    device.require_cards(cell.chips)
    device.keep_caches_in(ROOT)
    card = device.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    code, out = execute(cell, args.seed, args.seconds, bool(args.trace), T0)
    if out is None:
        return code
    print(f"memory peak: {out['device']['memory_peak_bytes']} bytes on {card}",
          flush=True)
    print(report.dumps(out), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
