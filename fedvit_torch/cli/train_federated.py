"""Federated training CLI (the port of ``fedvit_tpu/cli/train_federated.py``).

    python -m fedvit_torch.cli.train_federated [--config config.yaml] \
        [--clients 8] [--rounds 10] [--synthetic N] [--log DIR] [--seed N] \
        [--resume] [--checkpoint-every N] [--device cuda]

Clients are partitioned (Dirichlet class-skew by default) and trained one
after another on the device each round, then averaged (``fed/fedavg.py``).
``--synthetic N`` trains on the synthetic ISIC-like fixture
(``data/synthetic.py``; an eighth of it, at least 8, is the evaluation set);
without it the training split of ``data.isic_dir`` (``data/isic.py``) is
decoded whole into uint8 canvases by ``HostDataSource`` and its test split,
when there is one, is the evaluation set. The history goes to
``<log>/federated_history.json`` and the server state to ``<log>/ckpt``.
Without ``--config`` the defaults are the JAX package's:
ViT-B/16@224, bf16, batch 4, 4 clients. ``--device`` picks the device,
``cuda`` by default; without a card the command fails unless ``--device cpu``
is given.

Ranks are launched as for ``cli.train``: on a machine with N > 1 cards the
command runs N ranks itself, one a card; under ``torchrun --nproc_per_node
N`` (also with ``--device cpu``, gloo) each process is one rank. The
clients are then spread over a client mesh of the ranks
(``fed/server.py``); rank 0 alone evaluates, logs and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Federated (FedAvg) training")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--clients", type=int, default=None)
    parser.add_argument("--rounds", type=int, default=None)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic samples instead of ISIC")
    parser.add_argument("--log", type=str, default="logs_fed")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the last federated checkpoint "
                             "in <log>/ckpt")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="save federated server state every N rounds "
                             "(0 disables checkpointing)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from fedvit_torch.core.device import resolve_device
    from fedvit_torch.parallel.mesh import main_on_ranks

    if args.resume and args.checkpoint_every <= 0:
        raise SystemExit(
            "--resume requires --checkpoint-every > 0: with checkpointing "
            "disabled there is no workdir to resume from (and the resumed "
            "run would stop persisting progress).")
    resolve_device(args.device)
    return main_on_ranks("fedvit_torch.cli.train_federated", argv,
                         args.device, True, lambda device: _run(args, device))


def _run(args, device) -> int:
    import torch
    from fedvit_torch.core.config import Config, load_config
    from fedvit_torch.fed.server import train_federated
    from fedvit_torch.models import build_model
    from fedvit_torch.parallel.mesh import is_writer

    cfg = load_config(args.config) if args.config else Config()
    cfg = cfg.replace(seed=args.seed)
    over = {}
    if args.clients is not None:
        over["num_clients"] = args.clients
        over["clients_per_round"] = args.clients
    if args.rounds is not None:
        over["rounds"] = args.rounds
    cfg = cfg.replace(federated=dataclasses.replace(cfg.federated,
                                                    enabled=True, **over))

    if is_writer():
        os.makedirs(args.log, exist_ok=True)

    # ---- data: raw images (uint8 canvases, or [0, 1] floats); every
    # client's local step and the per-round evaluation run the device
    # augment, which owns the geometry and the normalisation
    if args.synthetic > 0:
        from fedvit_torch.data.synthetic import make_synthetic_dataset
        data = make_synthetic_dataset(n=args.synthetic,
                                      image_size=cfg.model.image_size,
                                      seed=cfg.seed)
        if cfg.data.use_segmentation_mask:
            data["image"] = np.concatenate([data["image"], data["mask"]], -1)
        n_eval = max(8, args.synthetic // 8)
        eval_data = {k: v[:n_eval] for k, v in data.items()}
        train_data = {k: v[n_eval:] for k, v in data.items()}
    else:
        from fedvit_torch.data.isic import load_isic_data
        from fedvit_torch.data.pipeline import HostDataSource
        train_df, test_df = load_isic_data(cfg.data.isic_dir)
        train_data = HostDataSource(train_df, cfg).gather(
            np.arange(len(train_df)))
        eval_data = (HostDataSource(test_df, cfg).gather(
            np.arange(len(test_df))) if len(test_df) else None)

    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    workdir = (os.path.join(args.log, "ckpt")
               if args.checkpoint_every > 0 else None)
    result = train_federated(cfg, model, train_data, eval_data,
                             workdir=workdir, resume=args.resume,
                             checkpoint_every=max(1, args.checkpoint_every),
                             device=device)

    if is_writer():
        hist_path = os.path.join(args.log, "federated_history.json")
        with open(hist_path, "w") as f:
            json.dump(result.history, f, indent=2)
        print(f"History saved → {hist_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
