"""The readings a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

For each of ``--seeds`` it reads the program's numbers as a run does (the
first three steps against the reference; or a short serving window's
sampled answers against it): the lower readings. For each of
``--control-seeds`` it reads the control, the reference computed in fp8 in
the program's place (the precision below the configuration's bf16), and for
a training cell the planted fault "half of each batch left out, the mean
taken over the rest", in the reference put in the program's place: the
upper readings. (A state left unchanged reads 1 on ``change_gap`` and
``ema_gap`` and needs no run.) One JSON line a reading on standard output.
The benchmark's own runs never run this.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def emit(kind: str, seed: int, numbers) -> None:
    print(json.dumps({"kind": kind, "seed": seed, "t": time.time() - T0,
                      "numbers": {k: v for k, (v, _) in numbers.items()},
                      "at": {k: a for k, (_, a) in numbers.items()}}),
          flush=True)


def free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def training(cell, mode, seeds, control_seeds, dev) -> None:
    from benchmark.harness import checks

    for seed in seeds:
        objs = mode.build(cell, seed, dev)
        prog = mode.first_steps(cell, seed, objs, dev)
        del objs
        free()
        ref = mode.reference_readings(cell, seed, dev)
        emit("program", seed, checks.training_numbers(prog, ref))
        free()
    sh = mode.shapes(cell)
    for seed in control_seeds:
        ref = mode.reference_readings(cell, seed, dev)
        low = mode.reference_readings(cell, seed, dev, precision="fp8")
        emit("control_fp8", seed, checks.training_numbers(low, ref))
        fault = mode.reference_readings(cell, seed, dev,
                                        rows=slice(0, sh["micro"] // 2))
        emit("fault_half_batch", seed, checks.training_numbers(fault, ref))
        free()


def serving(cell, mode, seeds, control_seeds, seconds, dev) -> None:
    import numpy as np

    from benchmark.harness import checks

    for seed in seeds:
        objs = mode.build(cell, seed, dev)
        loop = mode.Loop(objs)
        for _ in range(cell.traffic["warmup"]):
            loop.one(keep=False)
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            loop.one(keep=True)
        answers, starts = loop.answers, loop.starts
        del objs, loop
        free()
        emit("program", seed, mode.compared(cell, seed, answers, starts, dev))
        free()
    for seed in control_seeds:
        images = np.arange(cell.traffic["sample"]) * 13 % cell.traffic["host_images"]
        ref = mode.reference_logits(cell, seed, images, dev)
        low = mode.reference_logits(cell, seed, images, dev, precision="fp8")
        emit("control_fp8", seed, {"logit_gap": checks.logit_gap(low, ref)})
        free()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import device, manifest

    cell = manifest.load_cell(args.workload)
    device.require_cards(1)
    device.keep_caches_in(ROOT)
    print(f"card: {device.card_line()}", flush=True)
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    mode = manifest.mode_module(cell.mode)
    if cell.mode == "train_epoch":
        training(cell, mode, seeds, controls, dev)
    else:
        serving(cell, mode, seeds, controls, args.seconds, dev)
    print(f"calibrate: {time.time() - T0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
