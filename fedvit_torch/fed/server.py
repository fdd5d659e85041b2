"""Federated server — the round loop around the FedAvg round
(``fedvit_tpu/fed/server.py``).

Per round the host draws which clients take part and each one's
(local steps, batch) sample indices from its partition (optionally
class-balanced, the federated analogue of the reference's
WeightedRandomSampler, data.py:457-464); the round's (clients, steps, batch,
...) tensors are gathered on the device from a resident copy of the training
set when it fits ``federated.device_resident_mb``, else assembled on the host
and copied. A one-thread assembler draws and gathers round r + 1 while round
r trains. Evaluation (the eval augment, K1 on a CUDA ViT) and the server EMA
run between rounds.

Numpy draws are the JAX package's, in its order, from
``numpy.random.default_rng(cfg.seed)``: the partition, then per round the
active clients and their indices. The clients' augment, mix and dropout
draws come from generators seeded from (seed, round, client)
(``fed/fedavg.py::client_generators``).
"""

from __future__ import annotations

import copy
import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from fedvit_torch.core.config import Config, to_dict
from fedvit_torch.core.device import resolve_device
from fedvit_torch.data.constants import NUM_CLASSES
from fedvit_torch.data.pipeline import make_device_augment
from fedvit_torch.data.sampling import compute_class_weights
from fedvit_torch.eval.metrics import compute_metrics
from fedvit_torch.eval.serve import make_eval_step
from fedvit_torch.fed.fedavg import client_slots, make_federated_round
from fedvit_torch.fed.partition import client_weights, partition
from fedvit_torch.parallel.mesh import (client_mesh, is_writer,
                                        mesh_coordinate, row_piece,
                                        world_size, writer_log)
from fedvit_torch.train import checkpoint as ckpt
from fedvit_torch.train.ema import ema_init, ema_update, shadow_weights
from fedvit_torch.train.losses import build_loss


def sample_client_indices(labels_all: np.ndarray, part_idx: np.ndarray,
                          local_steps: int, batch_size: int,
                          rng: np.random.Generator,
                          weighted: bool = True,
                          num_classes: int = NUM_CLASSES) -> np.ndarray:
    """Sample (local_steps, batch) GLOBAL dataset indices from one client's
    partition, with replacement, optionally inverse-class-frequency
    weighted."""
    labels = labels_all[part_idx]
    if weighted and len(labels):
        counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
        counts[counts == 0] = 1.0
        w = (1.0 / counts)[labels]
        p = w / w.sum()
    else:
        p = None
    sel = rng.choice(len(part_idx), size=(local_steps, batch_size), p=p)
    return part_idx[sel.reshape(-1)].reshape(local_steps, batch_size)


def sample_client_batches(data: Dict[str, np.ndarray],
                          part_idx: np.ndarray,
                          local_steps: int, batch_size: int,
                          rng: np.random.Generator,
                          weighted: bool = True,
                          keys=("image", "label", "metadata"),
                          num_classes: int = NUM_CLASSES) -> Dict[str, np.ndarray]:
    """Sample (local_steps, batch, ...) arrays from one client's partition,
    with replacement, optionally inverse-class-frequency weighted."""
    flat = sample_client_indices(data["label"], part_idx, local_steps,
                                 batch_size, rng, weighted,
                                 num_classes).reshape(-1)
    return {k: data[k][flat].reshape((local_steps, batch_size)
                                     + data[k].shape[1:])
            for k in keys if k in data}


@dataclass
class FederatedResult:
    """The global model after the last round (a new module: the caller's is
    left as it was), the server's EMA shadow of its parameters (None without
    EMA) and one history entry a round."""
    model: nn.Module
    ema_params: Optional[Dict[str, torch.Tensor]]
    history: List[Dict] = field(default_factory=list)


class RoundBatches:
    """Draws each round's batches: ``draw()`` → (batches {key: (C, S, B,
    ...) tensors on the device}, the active clients' weights renormalised
    over them, the active client ids), with the numpy draws of the JAX
    package's ``assemble``, in its order, from ``rng``.

    The training set goes to the device once when it fits
    ``federated.device_resident_mb`` (and ``device_resident_data`` is on),
    and each round is gathered there from host-drawn indices (KBs a round);
    otherwise each round is fancy-indexed and stacked on the host and
    copied."""

    def __init__(self, cfg: Config, train_data: Dict[str, np.ndarray],
                 parts: List[np.ndarray], weights: np.ndarray,
                 local_steps: int, rng: np.random.Generator, device,
                 slots: Optional[Callable[[int], slice]] = None,
                 rows: slice = slice(None)):
        fed = cfg.federated
        self.cfg, self.train_data, self.parts = cfg, train_data, parts
        self.weights, self.local_steps, self.rng = weights, local_steps, rng
        self.device = device
        self.slots = slots or (lambda active: slice(0, active))
        self.rows = rows
        self.active_count = min(fed.clients_per_round or fed.num_clients,
                                fed.num_clients)
        keys = tuple(k for k in ("image", "label", "metadata")
                     if k in train_data)
        data_bytes = sum(train_data[k].nbytes for k in keys)
        self.resident = None
        if fed.device_resident_data and \
                data_bytes <= fed.device_resident_mb * 2 ** 20:
            self.resident = {
                k: torch.from_numpy(np.ascontiguousarray(train_data[k]))
                .to(device) for k in keys}

    def draw(self):
        cfg, rng, bs = self.cfg, self.rng, self.cfg.training.batch_size
        num_clients = cfg.federated.num_clients
        if self.active_count < num_clients:
            active = np.sort(rng.choice(num_clients, self.active_count,
                                        replace=False))
        else:
            active = np.arange(num_clients)
        w_round = self.weights[active]
        w_round = w_round / w_round.sum()
        weighted = cfg.training.use_weighted_sampler
        idx = np.stack([
            sample_client_indices(
                self.train_data["label"], self.parts[c],
                self.local_steps, bs, rng, weighted=weighted,
                num_classes=cfg.num_classes)
            for c in active])                        # (C, S, B)
        # every rank draws the whole round; it uploads its own part
        idx = idx[self.slots(len(active))][:, :, self.rows]
        if self.resident is not None:
            flat = torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(
                self.device)
            batches = {k: v.index_select(0, flat).reshape(idx.shape
                                                          + v.shape[1:])
                       for k, v in self.resident.items()}
        else:
            batches = {k: torch.from_numpy(
                np.ascontiguousarray(v[idx.reshape(-1)])
                .reshape(idx.shape + v.shape[1:])).to(self.device)
                for k, v in self.train_data.items()
                if k in ("image", "label", "metadata")}
        return batches, w_round, active


def _refuse_other_config(cfg: Config, saved: Optional[Dict],
                         workdir: str) -> None:
    """A resume continues the dead run's draws only under its config; a
    longer ``federated.rounds`` is the one change allowed."""
    if saved is None:
        return
    # through the JSON encoding the checkpoint used (tuples → lists)
    cur = json.loads(json.dumps(to_dict(cfg), default=str))
    old = copy.deepcopy(saved)
    for d in (cur, old):
        d.get("federated", {}).pop("rounds", None)
    if cur != old:
        diff = [k for k in set(cur) | set(old) if cur.get(k) != old.get(k)]
        raise ValueError(
            f"--resume config mismatch vs the checkpoint at {workdir} "
            f"(differing sections: {sorted(diff)}); resuming under different "
            f"hyperparameters would silently break the continuation. Use the "
            f"original config, or start a fresh run without --resume.")


def train_federated(
    cfg: Config,
    model: nn.Module,
    train_data: Dict[str, np.ndarray],
    eval_data: Optional[Dict[str, np.ndarray]] = None,
    log_fn: Callable[[str], None] = print,
    eval_batch_size: int = 64,
    workdir: Optional[str] = None,
    resume: bool = False,
    checkpoint_every: int = 1,
    device: str = "cuda",
    mesh: Optional[DeviceMesh] = None,
) -> FederatedResult:
    """Run ``cfg.federated.rounds`` rounds of FedAvg from ``model``'s weights
    on ``device`` (the card unless the caller asks for the CPU).

    ``train_data`` and ``eval_data`` are numpy dicts with "image" (raw: uint8
    canvases or float images in [0, 1], mask as a 4th channel when
    configured), "label" and "metadata". ``model`` is not changed: the server
    and the clients train copies, and the result holds the new global model.

    With ``workdir`` the server state (global model, EMA, round, history,
    the numpy generator's state, the clients' generator seed) is saved every
    ``checkpoint_every`` rounds and after the last; ``resume=True``
    continues from the last save, drawing what the uninterrupted run would
    have drawn.

    In a process group of more than one rank the round runs over ``mesh``
    (default: a client mesh of every rank, ``parallel/mesh.py``): every rank
    makes the same host draws and uploads only its clients' batches (its
    rows of them on a 2-D client × data mesh), the round sums the clients
    over the ranks (``fed/fedavg.py``), and every rank holds the same
    server. Rank 0 alone evaluates, logs and writes the checkpoints, and
    gives every rank its history entry; every rank loads on resume."""
    fed = cfg.federated
    dev = resolve_device(device)
    if mesh is None and world_size() > 1:
        mesh = client_mesh()
    slots, rows = None, slice(None)
    if mesh is not None:
        axis_size = mesh.size(mesh.mesh_dim_names.index(fed.mesh_axis))
        if fed.num_clients % axis_size:
            raise ValueError(
                f"num_clients={fed.num_clients} must be divisible by the mesh "
                f"'{fed.mesh_axis}' axis size ({axis_size}); pick a client "
                f"count that tiles the device mesh (each device hosts "
                f"num_clients/{axis_size} clients)")
        cpr = min(fed.clients_per_round or fed.num_clients, fed.num_clients)
        if cpr % axis_size and cpr != fed.num_clients:
            raise ValueError(f"clients_per_round={cpr} must tile the mesh "
                             f"axis ({axis_size})")
        slots = lambda active: client_slots(mesh, fed.mesh_axis,  # noqa: E731
                                            active)
        if "data" in mesh.mesh_dim_names:
            rows = slice(*row_piece(cfg.training.batch_size,
                                    mesh.size(mesh.mesh_dim_names.index(
                                        "data")),
                                    mesh_coordinate(mesh, "data")))
    log_fn = writer_log(log_fn)
    class_w = None
    if cfg.loss.class_weights:
        # balanced weights from the SERVER's global training labels — every
        # client optimizes the same objective (a per-client reweighting
        # would change the FedAvg fixed point under non-IID splits)
        class_w = torch.from_numpy(compute_class_weights(
            np.asarray(train_data["label"]), cfg.num_classes)).to(dev)
    loss_fn = build_loss(cfg, class_w)
    round_fn = make_federated_round(cfg, loss_fn, mesh)

    # --- partition data over clients ---------------------------------------
    parts = partition(fed.partition, train_data["label"], fed.num_clients,
                      alpha=fed.dirichlet_alpha, seed=cfg.seed)
    weights = client_weights(parts)
    log_fn(f"[fed] {fed.num_clients} clients, partition={fed.partition}, "
           f"sizes={[len(p) for p in parts]}")

    bs = cfg.training.batch_size
    if fed.local_steps > 0:
        local_steps = fed.local_steps
    else:
        mean_size = int(np.mean([len(p) for p in parts]))
        local_steps = max(1, (mean_size // bs) * fed.local_epochs)

    server = copy.deepcopy(model).to(dev)
    server.zero_grad(set_to_none=True)
    if cfg.model.pretrained_path:
        # same converted-checkpoint starting point as train_fold
        ckpt.load_pretrained(cfg.model.pretrained_path, server, cfg)
        log_fn(f"[fed] pretrained init ← {cfg.model.pretrained_path}")
    work = copy.deepcopy(server)          # each client's working copy
    ema_enabled = cfg.training.ema.enabled
    ema_params = ema_init(server) if ema_enabled else None

    rng = np.random.default_rng(cfg.seed)
    base = cfg.seed
    history: List[Dict] = []
    start_round = 1
    if resume and workdir and ckpt.federated_checkpoint_exists(workdir):
        saved = ckpt.load_federated_checkpoint(workdir, server, ema_params)
        _refuse_other_config(cfg, saved["config"], workdir)
        rng.bit_generator.state = saved["np_rng_state"]
        base = saved["generator_base"]
        history = list(saved["history"])
        start_round = saved["round"] + 1
        log_fn(f"[fed] resumed from round {saved['round']} ({workdir}) — "
               f"continuing at round {start_round}")

    round_batches = RoundBatches(cfg, train_data, parts, weights, local_steps,
                                 rng, dev, slots, rows)

    # --- per-round evaluation -------------------------------------------------
    # The eval set is padded to whole batches (the last row repeated) and
    # placed on the device once; it goes through the same eval augment as the
    # clients' inputs (eval geometry, ImageNet and mask normalisation).
    if eval_data is not None:
        n_eval = len(eval_data["label"])
        ebs = min(eval_batch_size, max(1, n_eval))
        n_padded = -(-n_eval // ebs) * ebs
        eval_dev = {
            k: torch.from_numpy(np.ascontiguousarray(np.concatenate(
                [v, np.repeat(v[-1:], n_padded - n_eval, 0)]))).to(dev)
            for k, v in eval_data.items() if k != "mask"}
        eval_step = make_eval_step(server, cfg,
                                   augment=make_device_augment(cfg, False))
        y_true = np.asarray(eval_data["label"])

        def evaluate() -> np.ndarray:
            logits = [eval_step({k: v[s:s + ebs] for k, v in eval_dev.items()})
                      for s in range(0, n_padded, ebs)]
            return torch.softmax(torch.cat(logits).float(), -1)[:n_eval] \
                .cpu().numpy()

    with ThreadPoolExecutor(1) as assembler:
        if start_round <= fed.rounds:
            pending = assembler.submit(round_batches.draw)
        for rnd in range(start_round, fed.rounds + 1):
            t0 = time.time()
            batches, w_round, active = pending.result()
            # the host generator's state between this round's draws and the
            # next round's background assembly: where a resumed run starts
            # its round-(rnd+1) draws
            rng_state = copy.deepcopy(rng.bit_generator.state)
            if rnd < fed.rounds:
                pending = assembler.submit(round_batches.draw)

            metrics = round_fn(server, work, batches, w_round, active, rnd,
                               base)
            del batches
            if ema_enabled:
                ema_update(ema_params, server, cfg.training.ema.decay)

            entry = {"round": rnd, "loss": float(metrics["loss"]),
                     "local_steps": local_steps,
                     "round_time_s": time.time() - t0}
            if eval_data is not None and is_writer():
                with shadow_weights(server, ema_params):
                    probs = evaluate()
                m = compute_metrics(y_true, probs.argmax(-1), cfg.num_classes,
                                    probs)
                entry.update({k: m[k] for k in
                              ("accuracy", "balanced_accuracy", "macro_f1")})
                if "auroc" in m:
                    entry["auroc"] = m["auroc"]

            if mesh is not None:
                box = [entry]
                torch.distributed.broadcast_object_list(box, src=0)
                entry = box[0]
            history.append(entry)
            log_fn(f"[fed] round {rnd:03d} | loss {entry['loss']:.4f}"
                   + (f" | acc {entry.get('accuracy', float('nan')):.4f}"
                      f" | bal {entry.get('balanced_accuracy', float('nan')):.4f}"
                      if eval_data is not None else "")
                   + f" | {entry['round_time_s']:.1f}s")

            if workdir and (rnd % checkpoint_every == 0 or rnd == fed.rounds):
                ckpt.save_federated_checkpoint(workdir, server, ema_params,
                                               rnd, history, rng_state, base,
                                               cfg)

    server.eval()
    return FederatedResult(server, ema_params, history)
