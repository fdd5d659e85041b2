"""Batch prediction through the program's own serving step, a closed loop.

Each batch is gathered by ``ArrayDataSource.sequential_batches`` from
canvases in host memory (cycled), run through
``fedvit_torch/eval/serve.py::make_eval_step(model, cfg,
make_device_augment(cfg, False))`` and its logits brought to the host as
``_evaluate`` brings them; then the next batch, as ``cli.predict`` without
``--tta`` runs. A batch's latency runs from the start of its gather to its
logits on the host.

Once the window has closed, a sample of its answers drawn from the seed is
compared with the reference's logits of the same images (``harness/
checks.py``).

The mix (``traffic/*.json``): ``host_images`` canvases, ``class_counts`` the
labels' shares, ``program.training.batch_size`` the batch, ``warmup``
batches before the window, ``sample`` answers compared, ``profiled_batches``
the batches the ``--trace 1`` run profiles after its window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import checks, inputs, program
from benchmark.harness.inputs import sub_seed
from benchmark.harness.report import Context, Measured
from benchmark.harness.trace import profiled, synchronize
from benchmark.reference import augment as ref_augment
from benchmark.reference import models as ref_models


def build(cell, seed: int, dev) -> Dict:
    from fedvit_torch.core import kernels
    from fedvit_torch.data.pipeline import (ArrayDataSource, canvas_size,
                                            make_device_augment)
    from fedvit_torch.eval.serve import make_eval_step
    from fedvit_torch.models import build_model

    if dev.type == "cuda":
        kernels.build_all()
    cfg = program.program_config(cell)
    arch, tr = cell.config["model"], cell.traffic
    side = cell.config["inputs"]["canvas"]
    if side != canvas_size(cfg.model.image_size):
        raise ValueError(f"canvas {side} is not the program's "
                         f"{canvas_size(cfg.model.image_size)}")
    n = tr["host_images"]
    source = ArrayDataSource({
        "image": inputs.make_canvases(n, side, seed, dev).cpu().numpy(),
        "label": inputs.make_labels(n, tr["class_counts"], seed),
        "metadata": inputs.make_metadata(n, seed)})
    model = build_model(cfg, device=str(dev),
                        generator=torch.Generator().manual_seed(0))
    spec = ref_models.param_spec(arch)
    program.load_weights(model, inputs.make_weights(spec, seed, dev),
                         inputs.running_stats(spec, dev))
    step = make_eval_step(model, cfg, augment=make_device_augment(cfg, False))
    return {"cfg": cfg, "source": source, "model": model, "step": step,
            "batch": cfg.training.batch_size}


class Loop:
    """The closed loop: gather, serve, logits to the host; cycling over the
    source's batches."""

    def __init__(self, objs: Dict):
        self.objs = objs
        self.batches = self._cycle()
        self.latency_ms: List[float] = []
        self.gather_ms: List[float] = []
        self.answers: List[np.ndarray] = []    # logits of each batch, in order
        self.starts: List[int] = []            # the first canvas of each
        self.count = 0
        if len(objs["source"]) % objs["batch"]:
            raise ValueError("the host images must be whole batches")

    def _cycle(self):
        while True:
            yield from self.objs["source"].sequential_batches(self.objs["batch"])

    def one(self, keep: bool) -> None:
        t0 = time.perf_counter()
        batch = next(self.batches)
        t1 = time.perf_counter()
        logits = self.objs["step"](batch).float().cpu().numpy()
        t2 = time.perf_counter()
        start = self.count * self.objs["batch"] % len(self.objs["source"])
        self.count += 1
        if keep:
            self.starts.append(start)
            self.gather_ms.append((t1 - t0) * 1e3)
            self.latency_ms.append((t2 - t0) * 1e3)
            self.answers.append(logits)


def sample(seed: int, answers: int, k: int) -> np.ndarray:
    """``k`` of the window's answers (batch-major order), drawn from the
    seed."""
    rng = np.random.default_rng(sub_seed(seed, inputs.SAMPLE))
    return np.sort(rng.choice(answers, size=min(k, answers), replace=False))


def reference_logits(cell, seed: int, images: np.ndarray, dev,
                     precision: str = "fp32", chunk: int = 16) -> np.ndarray:
    """The reference's logits of canvases ``images`` (indices)."""
    arch, tr = cell.config["model"], cell.traffic
    n, side = tr["host_images"], cell.config["inputs"]["canvas"]
    canv = inputs.make_canvases(n, side, seed, dev)[torch.from_numpy(images).to(dev)]
    meta = torch.from_numpy(inputs.make_metadata(n, seed)[images]).to(dev)
    spec = ref_models.param_spec(arch)
    w = inputs.make_weights(spec, seed, dev)
    running = inputs.running_stats(spec, dev)
    prec = ref_models.Precision(precision)
    out = []
    with torch.no_grad(), ref_models.fp32_products():
        for s in range(0, len(images), chunk):
            x = ref_augment.eval_batch(canv[s:s + chunk], arch["image_size"])
            out.append(ref_models.classifier(
                x, meta[s:s + chunk], w, arch, None, prec, train=False,
                running=running).double().cpu().numpy())
    return np.concatenate(out)


def compared(cell, seed: int, answers: List[np.ndarray], starts: List[int],
             dev, precision: str = "fp32") -> Dict:
    """The window's sampled answers (the logits of each batch, and the index
    of each batch's first canvas) against the reference's logits."""
    batch = answers[0].shape[0]
    flat = np.concatenate(answers)
    picks = sample(seed, len(flat), cell.traffic["sample"])
    images = np.asarray(starts)[picks // batch] + picks % batch
    want = reference_logits(cell, seed, images, dev, precision)
    return {"logit_gap": checks.logit_gap(flat[picks], want)}


def run(ctx: Context) -> Measured:
    cell, dev, tr = ctx.cell, ctx.device, ctx.cell.traffic
    objs = build(cell, ctx.seed, dev)
    loop = Loop(objs)
    for _ in range(tr["warmup"]):
        loop.one(keep=False)
    synchronize()
    t_start = time.perf_counter()
    setup_s = time.time() - ctx.t0
    while time.perf_counter() - t_start < ctx.seconds:
        loop.one(keep=True)
    wall = time.perf_counter() - t_start
    batches = len(loop.answers)
    images = batches * objs["batch"]
    ctx.log(f"window: {batches} batches, {images} images in {wall!r} s; "
            f"set-up {setup_s!r} s")
    failed = sum(int(not np.isfinite(a).all()) for a in loop.answers)
    m = Measured(cell=cell, arch=cell.config["model"],
                 end_to_end={"predict_img_s": images / wall,
                             "predict_ms_p95": float(np.percentile(
                                 loop.latency_ms, 95)),
                             "setup_s": setup_s},
                 wall_s=wall, images=images, micro=objs["batch"], accum=1,
                 attempted=batches, failed=failed, memory_peak_bytes=0)
    m.spans["gather_ms"] = list(loop.gather_ms)
    if ctx.trace:
        k = tr["profiled_batches"]
        with profiled() as prof:
            for _ in range(k):
                loop.one(keep=False)
            synchronize()
        m.profile, m.profiled_steps = prof[0], k
    if dev.type == "cuda":
        m.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    answers, starts = loop.answers, loop.starts
    del objs, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    m.numbers = compared(cell, ctx.seed, answers, starts, dev)
    return m
