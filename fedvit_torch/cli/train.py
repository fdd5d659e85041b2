"""Training CLI — K-fold cross-validation on ISIC-2019 files, on the GPU (the
port of ``fedvit_tpu/cli/train.py``, reference train.py:378-474).

    python -m fedvit_torch.cli.train --config config.yaml [--fold K] \
        [--log DIR] [--seed N] [--resume] [--profile DIR] [--device cuda]

``data.isic_dir`` is read by ``data/isic.py``; the folds are stratified
K-fold, grouped on ``lesion_id`` when the metadata has more than one lesion
(``data/splits.py``). Each fold trains with ``train/loop.py::train_fold``
under ``<log>/fold{k}`` (``best_fold{k}``, ``resume_fold{k}``, which
``--resume`` continues from), from ``model.pretrained_path`` when it is set
(``cli.import_weights`` writes one). With a test split the fold-averaged
logits go to ``<log>/ensemble_logits.npy``, and with real test labels the
per-fold and ensemble metrics and the classification report to the log
(``<log>/train_main.log``, ``<log>/fold{k}/train_fold{k}.log`` and stdout).
``training.auto_batch_size`` probes the batch size first. ``--profile DIR``
writes a ``torch.profiler`` trace (``utils/profiling.py::trace``) of
optimizer steps 2-4 of the run (the first is its warm-up) into DIR
(TensorBoard's format); the program's spans (``fedvit.train.step``,
``fedvit.train.forward_backward``, ...; ``utils/profiling.py::span``) are
ranges in it, on the clock of the kernels they launched. ``--device`` picks
the device, ``cuda`` by default; without a card the command fails unless
``--device cpu`` is given.

With ``training.data_parallel: true`` on a machine with N > 1 cards the
command trains each fold data-parallel over N ranks, one a card, as the JAX
package's trains over its N devices: it starts the N ranks itself
(``parallel/mesh.py::launch_ranks``, the command again with torchrun's
environment) and waits for them. Under ``torchrun --nproc_per_node N`` (or
any launcher that sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``) each
process is one rank, also with ``--device cpu`` (gloo). Rank 0 alone logs
and writes; ``training.auto_batch_size`` takes the least batch size any
rank's probe found.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

import numpy as np
import torch


def setup_logging(log_dir: str, fold: int = -1) -> logging.Logger:
    """The run's logger (reference train.py:75-88): stdout and
    ``<log_dir>/train_{main|fold{k}}.log``, not the root logger's handlers.
    Its handlers are replaced on every call, so a second run in one process
    logs to its own directory."""
    os.makedirs(log_dir, exist_ok=True)
    tag = f"fold{fold}" if fold >= 0 else "main"
    logger = logging.getLogger(f"fedvit_torch.cli.train.{tag}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(logging.Formatter("%(asctime)s | %(message)s",
                                      datefmt="%H:%M:%S"))
    logger.addHandler(ch)
    fh = logging.FileHandler(os.path.join(log_dir, f"train_{tag}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s | %(message)s"))
    logger.addHandler(fh)
    return logger


# optimizer steps the profiler records, after one step of warm-up: a real
# fold's thousands of launches a step would otherwise pile up in host memory
PROFILE_STEPS = 3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="ISIC 2019 — K-Fold CV Training (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--fold", type=int, default=-1,
                        help="Run a single fold (-1 = all)")
    parser.add_argument("--log", type=str, default="logs")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--resume", action="store_true",
                        help="Resume folds from their latest checkpoint")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler trace of optimizer "
                             "steps 2-4 of the run into DIR (view with "
                             "TensorBoard); the program's spans "
                             "(fedvit.train.step, fedvit.data.gather, ...) "
                             "are ranges in it")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from fedvit_torch.core.config import load_config
    from fedvit_torch.core.device import resolve_device
    from fedvit_torch.parallel.mesh import main_on_ranks

    resolve_device(args.device)
    cfg = load_config(args.config).replace(seed=args.seed)
    return main_on_ranks("fedvit_torch.cli.train", argv, args.device,
                         cfg.training.data_parallel,
                         lambda device: _run(args, cfg, device))


def _run(args, cfg, device) -> int:
    from fedvit_torch.data.isic import (has_real_test_labels, load_isic_data,
                                        print_class_distribution)
    from fedvit_torch.data.pipeline import HostDataSource
    from fedvit_torch.data.splits import make_cv_splits
    from fedvit_torch.eval.metrics import classification_report
    from fedvit_torch.parallel.mesh import is_writer, silent
    from fedvit_torch.train.loop import (aggregate_fold_metrics,
                                         ensemble_folds, train_fold)
    from fedvit_torch.utils.profiling import trace

    writer = is_writer()
    log = setup_logging(args.log).info if writer else silent

    t = cfg.training
    n_folds = t.cv.n_splits
    log("=" * 60)
    log(f"  ISIC 2019 Classifier — {n_folds}-Fold CV (PyTorch, {device})")
    log("=" * 60)

    train_full_df, test_df = load_isic_data(cfg.data.isic_dir, log=log)
    print_class_distribution(train_full_df, "Full Train", log=log)
    if len(test_df) > 0:
        print_class_distribution(test_df, "Test", log=log)

    eff_bs = t.batch_size * t.gradient_accumulation_steps
    log(f"  [Config] physical_bs={t.batch_size}, "
        f"accum={t.gradient_accumulation_steps}, effective_bs={eff_bs}")

    # auto batch-size probe (reference train.py:411-418: probe, then
    # override training.batch_size with the result)
    if t.auto_batch_size:
        import dataclasses
        from fedvit_torch.train.probe import auto_batch_size
        bs = auto_batch_size(cfg, log=log, device=device)
        cfg = cfg.replace(training=dataclasses.replace(cfg.training,
                                                       batch_size=bs))
        t = cfg.training

    labels = train_full_df["label"].values
    groups = (train_full_df["lesion_id"].values
              if "lesion_id" in train_full_df.columns
              and train_full_df["lesion_id"].nunique() > 1 else None)
    splits = make_cv_splits(labels, groups, n_folds, args.seed)
    log(f"[Split] {'StratifiedGroupKFold (on lesion_id)' if groups is not None else 'StratifiedKFold'}")

    test_source = HostDataSource(test_df, cfg) if len(test_df) > 0 else None

    fold_list = list(range(n_folds)) if args.fold < 0 else [args.fold]
    fold_results = []
    profile_cm = contextlib.nullcontext()
    if args.profile and writer:
        profile_cm = trace(args.profile, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=PROFILE_STEPS, repeat=1),
            cuda=device.type == "cuda")
    with profile_cm as prof:
        for f in fold_list:
            trn_idx, val_idx = splits[f]
            trn_src = HostDataSource(train_full_df.iloc[trn_idx], cfg)
            val_src = HostDataSource(train_full_df.iloc[val_idx], cfg)
            fold_dir = os.path.join(args.log, f"fold{f}")
            fold_log = (setup_logging(fold_dir, fold=f).info if writer
                        else silent)
            fold_results.append(train_fold(
                cfg, f, trn_src, val_src, test_source, workdir=fold_dir,
                log=fold_log, resume=args.resume, device=device,
                on_step=None if prof is None else prof.step))
    if args.profile and writer:
        log(f"  Profiler trace written → {args.profile}")

    has_gt = has_real_test_labels(test_df)
    if test_source is not None and has_gt:
        aggregate_fold_metrics(fold_results, test_df["label"].values,
                               cfg.num_classes, log)
    ens = (ensemble_folds(fold_results, test_df["label"].values,
                          cfg.num_classes, log, compute=has_gt)
           if test_source is not None else {})
    if ens and writer:
        avg = ens["ensemble_logits"]
        np.save(os.path.join(args.log, "ensemble_logits.npy"), avg)
        log(f"  Ensemble logits saved → {args.log}/ensemble_logits.npy")
        # metrics only with real ground truth (placeholder gate, train.py:459)
        if has_gt:
            preds = avg.argmax(axis=1)
            m = ens["ensemble_metrics"]
            log("\n" + classification_report(test_df["label"].values, preds,
                                             list(cfg.class_names)))
            log(f"Confusion Matrix:\n{m['confusion_matrix']}")
    log("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
