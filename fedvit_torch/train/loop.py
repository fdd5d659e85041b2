"""The fold trainer and the K-fold runner (``fedvit_tpu/train/loop.py``).

``train_fold`` trains one cross-validation fold end to end on one device:
the model, LLRD optimizer and EMA, the epoch loop over class-balanced batch
plans with the on-device train augment, EMA-swapped validation,
best-metric and resume checkpoints, early stopping, the old generation's
optional two-stage schedule (the head alone first, with the backbone
frozen), then the best checkpoint's test evaluation with or without TTA.
``run_experiment`` runs the folds and ensembles their test logits.

Randomness follows the JAX package's structure with torch generators:

- the batch plans come from ``numpy.random.default_rng(seed + fold)``, made
  afresh before the epoch loop whatever epoch it starts at, as the JAX
  package does (so a resumed run's first epoch draws the plan of epoch 1);
- batch i of epoch e is augmented with draws from ``batch_generator(seed ·
  1000 + e, i)`` (``fold_in(key(seed · 1000 + e), i)`` in JAX): they depend
  only on those two numbers, not on the batches before, and survive a
  resume;
- dropout, drop-path and MixUp/CutMix draw from the state's generators,
  which checkpoints save and restore.

On a CUDA device each optimizer step launches the augment's kernels (12 K7,
3 K8) and the step's (``train/step.py``).

With ``training.data_parallel`` in a process group of more than one rank
(JAX's rule: more than one device) the fold is data-parallel over a
``"data"`` mesh of every rank (``parallel/``), with the values of the
unsharded fold: each rank draws the same batch plans and augment draws,
augments the whole macro batch and trains on its rows of each micro-batch
(``train/step.py``); the state is broadcast from rank 0 first. Every rank
evaluates the whole validation and test split, and takes rank 0's metrics
and logits, so the best-checkpoint and early-stopping decisions are one.
Rank 0 alone logs and writes the checkpoints (``train/checkpoint.py``);
every rank reads them.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedvit_torch.core.config import Config
from fedvit_torch.core.device import resolve_device
from fedvit_torch.data.pipeline import make_device_augment, maybe_device_resident
from fedvit_torch.data.sampling import compute_class_weights
from fedvit_torch.eval.metrics import classification_report, compute_metrics
from fedvit_torch.eval.serve import (_evaluate, _softmax, _to_device,
                                     evaluate_with_tta, make_eval_step)
from fedvit_torch.models import build_model
from fedvit_torch.parallel.data import DataParallel
from fedvit_torch.parallel.mesh import (data_mesh, replicate, world_size,
                                        writer_log)
from fedvit_torch.train import checkpoint as ckpt
from fedvit_torch.train.ema import ema_init
from fedvit_torch.train.losses import build_loss, cross_entropy_loss
from fedvit_torch.train.optim import build_head_optimizer, build_optimizer
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step
from fedvit_torch.utils.profiling import span


def init_model_state(cfg: Config, rng_seed: int = 0,
                     ema_enabled: Optional[bool] = None,
                     device: str = "cuda", steps_per_epoch: int = 1):
    """(model, TrainState): the model built from ``rng_seed`` on ``device``,
    the LLRD optimizer for ``steps_per_epoch`` steps an epoch, the state's
    generators seeded with ``rng_seed + 1``."""
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(rng_seed))
    tx, _ = build_optimizer(cfg, model, steps_per_epoch)
    ema = cfg.training.ema.enabled if ema_enabled is None else ema_enabled
    return model, TrainState.create(model, tx, rng_seed + 1, ema_enabled=ema)


def batch_generator(base: int, i: int, device) -> torch.Generator:
    """The augment's generator for batch ``i`` of an epoch whose base is
    ``base`` (seed · 1000 + epoch), on ``device``: seeded from the two
    numbers alone."""
    seed = np.random.SeedSequence([base % 2 ** 63, i]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _agree(obj, dp: Optional[DataParallel]):
    """Rank 0's ``obj`` on every rank of the data group (a picklable
    value), so that every rank decides alike; ``obj`` itself without
    one."""
    if dp is None:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(
        box, group_src=0, group=dp.group)
    return box[0]


@dataclasses.dataclass
class FoldResult:
    """One fold's output. ``logits`` are the raw (pre-softmax) test logits —
    the reference's fold contract (train.py:446-455 averages raw logits across
    folds); ``probs`` their softmax; ``metrics`` the fold's test metrics ({}
    without test ground truth)."""
    logits: np.ndarray
    probs: np.ndarray
    metrics: Dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:          # "fold produced test outputs?"
        return len(self.logits)


def _train_epoch(step, state, source, macro_bs: int, rng_np, weighted: bool,
                 augment, base: int, device, on_step=None
                 ) -> Tuple[object, float]:
    """One epoch of optimizer steps; returns (state, mean train loss).
    ``on_step()`` runs after each optimizer step.

    Each step runs in three spans (``utils/profiling.py``): ``train.fetch``
    (the source's next batch, the sampler's plan on the first, and its copy
    to ``device``), ``train.augment`` (the batch's generator and the
    augment) and ``train.step``; the epoch ends with the fetch that finds
    the source exhausted and ``train.epoch_end``, the read of its losses."""
    losses = []
    batches = iter(source.epoch_batches(macro_bs, rng_np, weighted))
    for i in itertools.count():
        with span("train.fetch"):
            batch = next(batches, None)
            if batch is not None:
                batch = _to_device(batch, device)
        if batch is None:
            break
        with span("train.augment"):
            batch = augment(batch, batch_generator(base, i, device))
        with span("train.step"):
            state, m = step(state, batch)
        losses.append(m["loss"])
        if on_step is not None:
            on_step()
    with span("train.epoch_end"):
        if not losses:
            return state, float("nan")
        return state, float(np.mean(torch.stack(losses).cpu().numpy()))


def train_fold(cfg: Config, fold: int, train_source, val_source,
               test_source=None, workdir: Optional[str] = None,
               log: Callable[[str], None] = print, resume: bool = False,
               device: str = "cuda",
               on_step: Optional[Callable[[], None]] = None) -> FoldResult:
    """Train one CV fold end to end on ``device`` (the card unless the caller
    asks for the CPU); returns a FoldResult whose ``logits`` are the raw
    test-set logits (N, C) — the contract of reference train_fold
    (train.py:221-371). With ``workdir``, the best checkpoint goes to
    ``{workdir}/best_fold{fold}`` and the last epoch's to
    ``{workdir}/resume_fold{fold}``, which ``resume`` continues from.
    ``on_step()`` runs after each optimizer step. With
    ``training.data_parallel`` in a group of several ranks, every rank calls
    it alike and trains its rows (module docstring)."""
    t = cfg.training
    dev = resolve_device(device)
    log = writer_log(log)
    # the canvases go to the card once when they fit (DeviceDataSource)
    train_source = maybe_device_resident(train_source, cfg, dev)
    val_source = maybe_device_resident(val_source, cfg, dev)
    test_source = maybe_device_resident(test_source, cfg, dev)
    accum = max(1, t.gradient_accumulation_steps)
    # one optimizer step per macro batch of batch_size · accum
    macro_bs = t.batch_size * accum
    opt_steps_per_epoch = max(1, len(train_source) // macro_bs)

    class_w = None
    if cfg.loss.class_weights:
        # balanced weights from the fold's train labels (old-gen semantics)
        class_w = torch.from_numpy(compute_class_weights(
            train_source.labels, cfg.num_classes)).to(dev)
    loss_fn = build_loss(cfg, class_w)
    model, state = init_model_state(cfg, cfg.seed + fold, device=dev,
                                    steps_per_epoch=opt_steps_per_epoch)
    schedule = state.tx.schedule
    if cfg.model.pretrained_path:
        ckpt.load_pretrained(cfg.model.pretrained_path, model, cfg)
        if state.ema is not None:
            state.ema = ema_init(model)
        log(f" Pretrained init ← {cfg.model.pretrained_path}")

    log(f"{'=' * 60}\n FOLD {fold}\n{'=' * 60}")
    log(f" Train: {len(train_source):,}  |  Val: {len(val_source):,}")
    log(f" Parameters: {sum(p.numel() for p in model.parameters()):,}")

    # data-parallel fold training: the state replicated over a "data" mesh,
    # each micro-batch's rows cut over it, the gradients all-reduced
    dp = None
    if t.data_parallel and world_size() > 1:
        mesh = data_mesh()
        ndev = mesh.size()
        if macro_bs % ndev:
            raise ValueError(f"batch {macro_bs} not divisible by {ndev} "
                             f"data-parallel devices")
        replicate(mesh, model)
        if state.ema is not None:
            replicate(mesh, state.ema)
        dp = DataParallel(mesh.get_group("data"))
        log(f" Data-parallel: batch sharded over {ndev} devices")

    augment_train = make_device_augment(cfg, train=True)
    augment_eval = make_device_augment(cfg, train=False)
    train_step = make_train_step(cfg, loss_fn, data=dp)
    # validation uses the training criterion (reference validate train.py:199)
    eval_step = make_eval_step(model, cfg, augment=augment_eval)

    metric_name = t.early_stopping.metric
    patience = t.early_stopping.patience
    best_metric = -math.inf          # the reference's uninitialised best, fixed
    epochs_without_improve = 0
    start_epoch = 1
    ckpt_path = f"{workdir}/best_fold{fold}" if workdir else None
    resume_path = f"{workdir}/resume_fold{fold}" if workdir else None

    if resume and resume_path and ckpt.checkpoint_exists(resume_path):
        meta = ckpt.load_checkpoint(resume_path, state)
        start_epoch = meta["epoch"] + 1
        best_metric = meta["best_metric"]
        epochs_without_improve = meta["epochs_without_improve"]
        log(f" Resumed from epoch {meta['epoch']} "
            f"(best {metric_name}={best_metric:.4f})")

    # ---- two-stage: head-only warm start (old-gen train_old.py:433-498) ----
    if t.two_stage.enabled and start_epoch == 1:
        head = state.fork(build_head_optimizer(cfg, model,
                                               t.two_stage.stage1_lr))
        rng_np = np.random.default_rng(cfg.seed + 100 + fold)
        for ep in range(1, t.two_stage.stage1_epochs + 1):
            head, loss = _train_epoch(train_step, head, train_source, macro_bs,
                                      rng_np, t.use_weighted_sampler,
                                      augment_train, cfg.seed + ep, dev,
                                      on_step)
            log(f"  [stage1] E{ep:02d} | trn_loss {loss:.4f}")
        # stage 2 carries the trained parameters (the model is shared) and
        # restarts the EMA from them (train_old.py:500-520)
        if t.ema.enabled:
            state.ema = ema_init(model)

    rng_np = np.random.default_rng(cfg.seed + fold)
    for epoch in range(start_epoch, t.epochs + 1):
        t0 = time.time()
        state, train_loss = _train_epoch(
            train_step, state, train_source, macro_bs, rng_np,
            t.use_weighted_sampler, augment_train, cfg.seed * 1000 + epoch, dev,
            on_step)

        # EMA-swapped validation (reference train.py:289-295)
        with state.ema_weights():
            val = _evaluate(eval_step, val_source, t.batch_size,
                            cfg.num_classes, loss_fn=loss_fn)
        val = _agree(val, dp)
        lr_now = float(schedule(state.step))
        log(f"  E{epoch:02d} | trn_loss {train_loss:.4f} | "
            f"val_loss {val['loss']:.4f} | val_acc {val['accuracy']:.4f} | "
            f"val_bal {val['balanced_accuracy']:.4f} | "
            f"val_f1 {val['macro_f1']:.4f} | lr {lr_now:.2e} | "
            f"{time.time() - t0:.1f}s")

        metric_val = val[metric_name]
        if metric_val > best_metric:
            best_metric = metric_val
            epochs_without_improve = 0
            if ckpt_path:
                ckpt.save_checkpoint(ckpt_path, state, epoch, best_metric, 0,
                                     cfg)
            log(f"  >>> New best {metric_name}: {best_metric:.4f} — saved.")
        else:
            epochs_without_improve += 1
            if patience > 0 and epochs_without_improve >= patience:
                log(f"  Early stopping at epoch {epoch} (patience={patience}).")
                break
        if resume_path:
            ckpt.save_checkpoint(resume_path, state, epoch, best_metric,
                                 epochs_without_improve, cfg)

    # ---- restore the best and evaluate on test ------------------------------
    if ckpt_path and ckpt.checkpoint_exists(ckpt_path):
        log(f"  Loading best checkpoint (best {metric_name}={best_metric:.4f})")
        ckpt.load_checkpoint(ckpt_path, state)

    if test_source is None or len(test_source) == 0:
        log("  No test data available — skipping test evaluation.")
        empty = np.zeros((0, cfg.num_classes))
        return FoldResult(logits=empty, probs=empty.copy())

    with state.ema_weights():
        if t.tta.enabled:
            log("  Running TTA on test set…")
            preds, labels, logits = evaluate_with_tta(cfg, model, test_source)
        else:
            log("  Evaluating on test set (no TTA)…")
            # the reference's no-TTA branch returns one-hot "logits" from the
            # predictions (train.py:355-358); these are the raw logits
            res = _evaluate(eval_step, test_source, t.batch_size,
                            cfg.num_classes, loss_fn=cross_entropy_loss)
            logits = res["logits"]
            preds = logits.argmax(-1).tolist()
            labels = [int(v) for v in test_source.labels]
    preds, labels, logits = _agree((preds, labels, logits), dp)
    logits = np.asarray(logits)
    probs = _softmax(logits)

    # AUROC, the north-star metric, needs the probabilities
    m = compute_metrics(labels, preds, cfg.num_classes, probs)
    log(f"  Fold {fold} Test — acc: {m['accuracy']:.4f} | "
        f"bal_acc: {m['balanced_accuracy']:.4f} | "
        f"macro_f1: {m['macro_f1']:.4f} | "
        f"auroc: {m.get('auroc', float('nan')):.4f}")
    log("\n" + classification_report(np.asarray(labels), np.asarray(preds),
                                     list(cfg.class_names)))
    log(f"  Confusion Matrix:\n{m['confusion_matrix']}")
    return FoldResult(logits=logits, probs=probs, metrics=m)


def ensemble_folds(fold_results: List[FoldResult], test_labels,
                   num_classes: int, log: Callable[[str], None] = print,
                   compute: bool = True) -> Dict:
    """Fold-averaged RAW-logit ensemble (reference main, train.py:446-472):
    the mean of each fold's raw logits, its probabilities (for AUROC) the
    softmax of that mean. {} when no fold produced test logits."""
    valid = [r.logits for r in fold_results if len(r) > 0]
    if not valid:
        return {}
    avg = np.mean(valid, axis=0)
    out: Dict = {"ensemble_logits": avg, "n_folds": len(valid)}
    if compute:
        preds = avg.argmax(axis=1)
        m = compute_metrics(np.asarray(test_labels), preds, num_classes,
                            _softmax(avg))
        out["ensemble_metrics"] = m
        log(f"\n  {len(valid)}-Fold ENSEMBLE — acc {m['accuracy']:.4f} | "
            f"bal {m['balanced_accuracy']:.4f} | f1 {m['macro_f1']:.4f} | "
            f"auroc {m.get('auroc', float('nan')):.4f}")
    return out


def run_experiment(cfg: Config, sources_per_fold, test_source=None,
                   workdir: Optional[str] = None, fold: int = -1,
                   log: Callable[[str], None] = print,
                   device: str = "cuda") -> Dict:
    """K-fold runner + fold-averaged logit ensemble (reference main,
    train.py:437-472) + per-fold mean ± std (old-gen train_kfold,
    train_old.py:685-759). ``sources_per_fold``: a list of (train_source,
    val_source); ``fold`` ≥ 0 runs that fold only."""
    fold_list = list(range(len(sources_per_fold))) if fold < 0 else [fold]
    fold_results: List[FoldResult] = []
    for f in fold_list:
        tr, va = sources_per_fold[f]
        fold_results.append(train_fold(cfg, f, tr, va, test_source, workdir,
                                       log, device=device))
    result: Dict = {"fold_results": fold_results,
                    "fold_logits": [r.logits for r in fold_results]}
    if test_source is not None and len(test_source) > 0:
        result.update(aggregate_fold_metrics(fold_results, test_source.labels,
                                             cfg.num_classes, log))
        result.update(ensemble_folds(fold_results, test_source.labels,
                                     cfg.num_classes, log))
    return result


def aggregate_fold_metrics(fold_results: List[FoldResult], test_labels,
                           num_classes: int,
                           log: Callable[[str], None] = print) -> Dict:
    """Per-fold test metrics and their mean ± std over folds (old-gen
    train_kfold, reference train_old.py:685-759)."""
    labels = np.asarray(test_labels)
    fold_metrics = [compute_metrics(labels, r.logits.argmax(-1), num_classes,
                                    r.probs)
                    for r in fold_results if len(r) > 0]
    if not fold_metrics:
        return {}
    agg_keys = ["accuracy", "balanced_accuracy", "macro_f1"]
    if all("auroc" in m for m in fold_metrics):
        agg_keys.append("auroc")
    agg = {k: (float(np.mean([m[k] for m in fold_metrics])),
               float(np.std([m[k] for m in fold_metrics])))
           for k in agg_keys}
    log("\n  K-FOLD AGGREGATE (mean ± std over folds)")
    for k, (mu, sd) in agg.items():
        log(f"    {k:>18s}: {mu:.4f} ± {sd:.4f}")
    return {"fold_metrics": fold_metrics, "aggregate": agg}
