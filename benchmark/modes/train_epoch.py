"""Training epochs through the program's own epoch loop.

The window drives ``fedvit_torch/train/loop.py::_train_epoch``, the loop
``train_fold`` runs each epoch, over a ``DeviceDataSource`` of resident
uint8 canvases with the weighted sampler, ``make_device_augment(cfg, True)``
and the ``TrainStep``: epoch after epoch, until the first step boundary
after ``--seconds``, where the epoch under way ends early. Each epoch ends in
the loop's own read of its losses (a synchronise), so the window's last
step has finished when it closes. (Ending inside an epoch keeps every
cell's window at ``--seconds`` whatever its epoch lasts: a SwinV2-L epoch of
2,048 images takes over 20 s.)

Set-up builds the step, its model and optimizer state once, with the
benchmark's weights, and drives that object through its first three steps
by the same call on a source of ``3 × macro`` distinct canvases; it then
hands it to the window. Those steps are compared with the reference's three
steps from the same canvases, weights and seeds (``harness/checks.py``),
once the window has closed and the program's state is freed.

The canvases are handed to the program on the host, as ``train_fold``
gets a fold, and ``maybe_device_resident`` decides by the configuration's
``data.device_resident_mb`` whether they live on the card; the run logs its
choice.

The mix (``traffic/*.json``): ``resident`` canvases, ``class_counts`` the
labels' shares, ``program`` the step's batch settings; ``profiled_steps``
the steps the ``--trace 1`` run profiles after its window, with each call of
the augment inside a ``record_function`` range (``AUGMENT``), so that the
augment's device time can be read by what launched it.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import checks, inputs, program
from benchmark.harness.inputs import sub_seed
from benchmark.harness.report import Context, Measured
from benchmark.harness.trace import AUGMENT, profiled, synchronize
from benchmark.reference import augment as ref_augment
from benchmark.reference import models as ref_models
from benchmark.reference import train as ref_train

FIRST_STEPS = 3


class Recorder:
    """The step as the epoch loop calls it, keeping each step's loss and,
    after the first step, the norm of each leaf of the gradient the
    optimizer got: Adam's first moment after one step is (1 − β₁)·g."""

    def __init__(self, step, b1: float):
        self.step, self.b1 = step, b1
        self.losses: List[torch.Tensor] = []
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None

    def __call__(self, state, batch):
        state, m = self.step(state, batch)
        self.losses.append(m["loss"])
        if self.first_grad is None:
            mu = state.opt_state["mu"]
            norms = torch._foreach_norm([t.float() for t in mu.values()])
            self.first_grad = dict(zip(mu, [n / (1.0 - self.b1) for n in norms]))
        return state, m


class FirstBatches:
    """A source whose epoch is ``source``'s, ending after ``k`` batches or
    at the first batch the host asks for after ``deadline``
    (``time.perf_counter``), whichever comes first."""

    def __init__(self, source, k: int = 1 << 62, deadline: float = math.inf):
        self.source, self.k, self.deadline = source, k, deadline
        self.served = 0

    def done(self) -> bool:
        return time.perf_counter() >= self.deadline

    def epoch_batches(self, batch_size, rng, weighted, drop_last=True):
        for i, b in enumerate(self.source.epoch_batches(batch_size, rng,
                                                        weighted, drop_last)):
            if i == self.k or self.done():
                return
            self.served += 1
            yield b


def annotated(augment):
    """``augment`` with each call inside a ``record_function`` range."""
    from torch.profiler import record_function

    def call(batch, generator=None):
        with record_function(AUGMENT):
            return augment(batch, generator)
    return call


def shapes(cell) -> Dict:
    t = cell.traffic["program"]["training"]
    micro, accum = t["batch_size"], t["gradient_accumulation_steps"]
    n = cell.traffic["resident"]
    return {"micro": micro, "accum": accum, "macro": micro * accum,
            "resident": n, "steps_per_epoch": n // (micro * accum)}


def seeds(seed: int) -> Dict[str, int]:
    return {"state": sub_seed(seed, inputs.STATE),
            "plan_first": sub_seed(seed, inputs.PLAN, 0),
            "plan": sub_seed(seed, inputs.PLAN, 1),
            "augment_first": sub_seed(seed, inputs.AUGMENT, 0),
            "augment": sub_seed(seed, inputs.AUGMENT, 1)}


def build(cell, seed: int, dev):
    """The program's objects for one run: config, sources, step, state."""
    from fedvit_torch.core import kernels
    from fedvit_torch.data.pipeline import (ArrayDataSource, canvas_size,
                                            make_device_augment,
                                            maybe_device_resident)
    from fedvit_torch.models import build_model
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    if dev.type == "cuda":
        kernels.build_all()
    cfg = program.program_config(cell)
    arch = cell.config["model"]
    sh, sd = shapes(cell), seeds(seed)
    side = cell.config["inputs"]["canvas"]
    if side != canvas_size(cfg.model.image_size):
        raise ValueError(f"canvas {side} is not the program's "
                         f"{canvas_size(cfg.model.image_size)}")
    canv = inputs.make_canvases(sh["resident"], side, seed, dev).cpu().numpy()
    labels = inputs.make_labels(sh["resident"], cell.traffic["class_counts"], seed)
    meta = inputs.make_metadata(sh["resident"], seed)
    first = FIRST_STEPS * sh["macro"]
    train_source = maybe_device_resident(ArrayDataSource(
        {"image": canv, "label": labels, "metadata": meta}), cfg, dev)
    first_source = maybe_device_resident(ArrayDataSource(
        {"image": canv[:first], "label": labels[:first],
         "metadata": meta[:first]}), cfg, dev)
    del canv
    model = build_model(cfg, device=str(dev),
                        generator=torch.Generator().manual_seed(0))
    spec = ref_models.param_spec(arch)
    program.load_weights(model, inputs.make_weights(spec, seed, dev),
                         inputs.running_stats(spec, dev))
    tx, _ = build_optimizer(cfg, model, sh["steps_per_epoch"])
    state = TrainState.create(model, tx, sd["state"],
                              ema_enabled=cfg.training.ema.enabled)
    step = Recorder(make_train_step(cfg, build_loss(cfg)),
                    cfg.training.optimizer.b1)
    return {"cfg": cfg, "train": train_source, "first": first_source,
            "state": state, "step": step,
            "augment": make_device_augment(cfg, True)}


def first_steps(cell, seed: int, objs, dev) -> Dict:
    """Drive the state through its first three steps by the window's own
    call and feed; returns the program's readings."""
    from fedvit_torch.train.loop import _train_epoch

    sh, sd = shapes(cell), seeds(seed)
    step, state = objs["step"], objs["state"]
    state, _ = _train_epoch(step, state, objs["first"], sh["macro"],
                            np.random.default_rng(sd["plan_first"]), False,
                            objs["augment"], sd["augment_first"], dev)
    objs["state"] = state
    w0 = inputs.make_weights(ref_models.param_spec(cell.config["model"]), seed,
                             dev)
    with torch.no_grad():
        delta = {n: (p - w0[n]).cpu()
                 for n, p in state.model.named_parameters()}
    readings = {"loss": [float(x) for x in step.losses],
                "grad": {n: float(v) for n, v in step.first_grad.items()},
                "delta": delta, "ema": checks.leaf_norms(state.ema, w0)}
    del w0
    step.losses = []
    return readings


def reference_readings(cell, seed: int, dev, precision: str = "fp32",
                       rows: Optional[slice] = None) -> Dict:
    """The reference's three steps from the same inputs, in ``precision``;
    ``rows`` keeps part of each micro-batch (a planted fault)."""
    arch = cell.config["model"]
    raw = program.program_raw(cell)
    recipe = ref_train.recipe_of(raw)
    aug = ref_augment.recipe_of(raw["augmentation"]["train"])
    sh, sd = shapes(cell), seeds(seed)
    first = FIRST_STEPS * sh["macro"]
    side = cell.config["inputs"]["canvas"]
    canv = inputs.make_canvases(sh["resident"], side, seed, dev, first=first)
    labels = torch.from_numpy(inputs.make_labels(
        sh["resident"], cell.traffic["class_counts"], seed)[:first]).long().to(dev)
    meta = torch.from_numpy(inputs.make_metadata(sh["resident"], seed)[:first]
                            ).to(dev)
    spec = ref_models.param_spec(arch)
    w0 = inputs.make_weights(spec, seed, dev)
    trainer = ref_train.Trainer(arch, recipe, w0, ref_models.Precision(precision),
                                sh["steps_per_epoch"])
    plan = np.random.default_rng(sd["plan_first"]).permutation(first)
    plan = plan.reshape(FIRST_STEPS, sh["macro"])
    np_rng = np.random.default_rng(sd["state"])
    g = torch.Generator(device=dev).manual_seed(sd["state"])
    with ref_models.fp32_products():
        losses = []
        for i, idx in enumerate(plan):
            idx = torch.from_numpy(idx).to(dev)
            x = ref_augment.train_batch(
                canv[idx],
                ref_augment.augment_generator(sd["augment_first"], i, dev),
                arch["image_size"], aug)
            losses.append(trainer.step(x, labels[idx], meta[idx], np_rng, g,
                                       sh["accum"], rows))
    with torch.no_grad():
        delta = {n: p - w0[n] for n, p in trainer.p.items()}
    out = {"loss": losses, "grad": checks.leaf_norms(trainer.first_grads),
           "grads": trainer.first_grads, "delta": delta,
           "ema": checks.leaf_norms(trainer.ema, w0)}
    del trainer, w0
    return out


def run(ctx: Context) -> Measured:
    from fedvit_torch.train.loop import _train_epoch

    cell, dev = ctx.cell, ctx.device
    sh, sd = shapes(cell), seeds(ctx.seed)
    objs = build(cell, ctx.seed, dev)
    prog = first_steps(cell, ctx.seed, objs, dev)
    step, state, source = objs["step"], objs["state"], objs["train"]
    augment = objs["augment"]
    weighted = objs["cfg"].training.use_weighted_sampler
    rng = np.random.default_rng(sd["plan"])
    synchronize()
    t_start = time.perf_counter()
    setup_s = time.time() - ctx.t0
    window = FirstBatches(source, deadline=t_start + ctx.seconds)
    epochs = 0
    while not window.done():
        state, _ = _train_epoch(step, state, window, sh["macro"], rng, weighted,
                                augment, sd["augment"] + epochs, dev)
        epochs += 1
    synchronize()
    wall = time.perf_counter() - t_start
    steps = window.served
    images = steps * sh["macro"]
    failed = int((~torch.isfinite(torch.stack(step.losses))).sum())
    m = Measured(cell=cell, arch=cell.config["model"],
                 end_to_end={"train_img_s": images / wall, "setup_s": setup_s},
                 wall_s=wall, images=images, micro=sh["micro"],
                 accum=sh["accum"], attempted=steps, failed=failed,
                 memory_peak_bytes=0)
    if ctx.trace:
        k = cell.traffic["profiled_steps"]
        with profiled() as prof:
            state, _ = _train_epoch(step, state, FirstBatches(source, k=k),
                                    sh["macro"], rng, weighted,
                                    annotated(augment),
                                    sd["augment"] + epochs, dev)
            synchronize()
        m.profile, m.profiled_steps = prof[0], k
    if dev.type == "cuda":
        m.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    ctx.log(f"window: {steps} steps in {epochs} epochs, {images} images in "
            f"{wall!r} s from a {type(source).__name__}; set-up {setup_s!r} s")
    del objs, state, step, source, augment, window
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, ctx.seed, dev)
    m.numbers = checks.training_numbers(prog, ref)
    return m
