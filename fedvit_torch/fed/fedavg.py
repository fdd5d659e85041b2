"""FedAvg on one device (``fedvit_tpu/fed/fedavg.py``).

A round takes the global model and every active client's batches, laid out
(clients, local steps, batch, ...). The clients run one after another on a
working copy of the model:

1. the working copy takes the global parameters and BatchNorm statistics;
2. local training: ``local_steps`` steps, each the device augment (the train
   transform when ``federated.augment``, else the eval transform), MixUp /
   CutMix, forward, loss, backward and one update of a local optimizer made
   fresh for the client (clip → Adam → weight decay → −lr);
3. w_i · θ_i joins an fp32 accumulator.

Then the server step θ ← θ + η (Σ w_i θ_i − θ) (η = ``federated.server_lr``;
η = 1 is plain FedAvg), for the parameters and the BatchNorm running
statistics alike, as JAX averages ``params`` and ``batch_stats``.
Everything on the leaves is ``torch._foreach_*`` over all of them at once.

The JAX package maps clients onto a mesh axis (``vmap`` within a device,
``psum`` across devices). Here, given a mesh (``parallel/mesh.py``), rank c
on its ``"client"`` axis trains the active slots [c·cpd, (c+1)·cpd) (cpd =
the active clients over the axis size), one after another, and the fp32
accumulators and the weighted loss are summed over the axis in one flat
all-reduce before every rank takes the server step; without one (a single
process), the loop above runs every client. With a ``"data"`` axis too,
each client's local batch is cut over it and its local steps are per shard
(JAX's ``shard_map``): each data rank runs the plain step on its shard with
the client's generators, and after each step the gradients, loss and
BatchNorm statistics are averaged over the data axis (``train/step.py``).
A client's training depends on its id, not on the rank that runs it.
Each client draws its augment, mix and dropout from a
``torch.Generator`` and its MixUp / CutMix λ and box from a numpy generator,
both seeded from (seed, round, client) alone (``client_generators``): a
resumed round needs nothing but its number.

On a CUDA model a ViT-B local step launches 12 K7 and 3 K8 (the train
augment) and 12 K2, 12 K3 and 25 K4 (``train/step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from fedvit_torch.core.config import Config
from fedvit_torch.data.pipeline import make_device_augment
from fedvit_torch.parallel.data import DataParallel, all_reduce_flat
from fedvit_torch.parallel.mesh import mesh_coordinate
from fedvit_torch.train.losses import LossFn
from fedvit_torch.train.optim import AdamWLLRD
from fedvit_torch.train.state import TrainState
from fedvit_torch.train.step import make_train_step


def build_local_optimizer(cfg: Config, model: nn.Module) -> AdamWLLRD:
    """The client's optimizer, made fresh every round (standard FedAvg):
    optax's ``clip_by_global_norm`` (when ``grad_clip`` > 0) →
    ``scale_by_adam`` (fp32 moments) → ``add_decayed_weights`` →
    ``scale(−lr)``, as ``fedvit_tpu/fed/fedavg.py::build_local_optimizer``:
    ``AdamWLLRD`` with every scale 1 and a constant LR."""
    opt = cfg.training.optimizer
    return AdamWLLRD({n: 1.0 for n, _ in model.named_parameters()},
                     lambda count: opt.lr, cfg.training.grad_clip or 0.0,
                     opt.b1, opt.b2, opt.eps, opt.weight_decay)


def client_generators(base: int, rnd: int, client: int, device
                      ) -> Tuple[torch.Generator, np.random.Generator]:
    """(torch generator on ``device``, numpy generator) of ``client`` in
    round ``rnd`` of a run seeded ``base``: seeded from the three numbers
    alone."""
    seq = np.random.SeedSequence([base % 2 ** 63, rnd, client])
    seed = int(seq.generate_state(1, np.uint64)[0])
    return (torch.Generator(device=device).manual_seed(seed),
            np.random.default_rng(seq))


def federated_leaves(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors FedAvg averages, by state-dict name: every parameter and
    every BatchNorm running mean and variance (JAX's ``params`` and
    ``batch_stats``). Left out: BatchNorm's ``num_batches_tracked``, an int64
    count with no JAX counterpart that ``nn.BatchNorm1d`` reads only when its
    momentum is None (``TorchBatchNorm``'s is 0.1). It counts the local
    steps on the path that led to a model: each client's copy starts from
    the global count and advances by its local steps, and a round advances
    the global count by its local steps."""
    leaves = dict(model.named_parameters())
    leaves.update((n, b) for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var")))
    return leaves


def make_local_train(cfg: Config, loss_fn: LossFn,
                     data: Optional[DataParallel] = None) -> Callable:
    """One client's local training for a round:

    ``local_train(model, batches, generator, np_rng) → mean loss`` trains
    ``model`` in place from the state it holds, one step for each of the
    ``batches``' leading entries ({key: (S, B, ...)}), with a fresh local
    optimizer. The device augment draws from ``generator``; the mix from
    ``np_rng`` and ``generator``; dropout and drop-path from ``generator``.
    Gradient accumulation does not apply: a local step is one batch. With
    ``data`` (per-shard semantics) the batches are this rank's shard of the
    client's and each step is averaged over the data group."""
    training = dataclasses.replace(cfg.training, gradient_accumulation_steps=1)
    step = make_train_step(cfg.replace(training=training), loss_fn,
                           augment=make_device_augment(
                               cfg, train=cfg.federated.augment), data=data)

    def local_train(model: nn.Module, batches: Dict[str, torch.Tensor],
                    generator: torch.Generator,
                    np_rng: np.random.Generator) -> torch.Tensor:
        tx = build_local_optimizer(cfg, model)
        state = TrainState(step=0, model=model, tx=tx,
                           opt_state=tx.init(model), ema=None,
                           generator=generator, np_rng=np_rng)
        losses = []
        for s in range(batches["label"].shape[0]):
            state, metrics = step(state, {k: v[s] for k, v in batches.items()})
            losses.append(metrics["loss"])
        return torch.stack(losses).mean()

    return local_train


@torch.no_grad()
def accumulate(acc: List[torch.Tensor], leaves: List[torch.Tensor],
               weight: float) -> None:
    """acc += w·θ, with the product rounded before the sum: JAX's
    ``(stack * w).sum(0)``."""
    torch._foreach_add_(acc, torch._foreach_mul(leaves, weight))


@torch.no_grad()
def server_step(global_leaves: List[torch.Tensor], acc: List[torch.Tensor],
                server_lr: float) -> None:
    """θ ← θ + η (Σ wᵢθᵢ − θ), in place."""
    delta = torch._foreach_sub(acc, global_leaves)
    torch._foreach_mul_(delta, server_lr)
    torch._foreach_add_(global_leaves, delta)


def client_slots(mesh: Optional[DeviceMesh], axis: str, active: int
                 ) -> slice:
    """The active-client slots this rank trains: all of them without a
    mesh, else [c·cpd, (c+1)·cpd) for rank c of the mesh's ``axis``."""
    if mesh is None:
        return slice(0, active)
    cpd = active // mesh.size(mesh.mesh_dim_names.index(axis))
    c = mesh_coordinate(mesh, axis)
    return slice(c * cpd, (c + 1) * cpd)


def make_federated_round(cfg: Config, loss_fn: LossFn,
                         mesh: Optional[DeviceMesh] = None) -> Callable:
    """The FedAvg round:

    ``round_fn(server, work, batches, weights, clients, rnd, base)
    → {"loss": weighted mean client loss}``

    ``server`` holds the global model and is updated in place; ``work`` is
    the clients' working copy (same architecture, overwritten). ``weights``
    are the (C,) float32 weights of the C active clients (summing to 1),
    ``clients`` their ids and ``base`` the run's seed, which with ``rnd``
    seed each client's generators. ``batches`` is {key: (C, S, B, ...)} on
    the models' device; with ``mesh`` it is this rank's part of that, the
    clients of ``client_slots`` and, with a ``"data"`` axis, this rank's
    rows of each batch (``row_piece``)."""
    server_lr = cfg.federated.server_lr
    axis = cfg.federated.mesh_axis
    client_group = data = None
    if mesh is not None:
        client_group = mesh.get_group(axis)
        if "data" in mesh.mesh_dim_names:
            data = DataParallel(mesh.get_group("data"), spmd=False)
    local_train = make_local_train(cfg, loss_fn, data)

    def round_fn(server: nn.Module, work: nn.Module,
                 batches: Dict[str, torch.Tensor], weights: np.ndarray,
                 clients: Sequence[int], rnd: int, base: int
                 ) -> Dict[str, torch.Tensor]:
        device = next(server.parameters()).device
        glob, mine = federated_leaves(server), federated_leaves(work)
        global_leaves = list(glob.values())
        work_leaves = [mine[n] for n in glob]
        work_buffers = dict(work.named_buffers())
        counts = [(b, work_buffers[n]) for n, b in server.named_buffers()
                  if n.endswith("num_batches_tracked")]
        slots = client_slots(mesh, axis, len(clients))
        acc = [torch.zeros_like(t) for t in global_leaves]
        losses = []
        for i, slot in enumerate(range(slots.start, slots.stop)):
            with torch.no_grad():
                torch._foreach_copy_(work_leaves, global_leaves)
                for src, dst in counts:
                    dst.copy_(src)
            generator, np_rng = client_generators(base, rnd,
                                                  int(clients[slot]), device)
            losses.append(local_train(work, {k: v[i] for k, v in
                                             batches.items()},
                                      generator, np_rng))
            accumulate(acc, work_leaves, float(weights[slot]))
        w = torch.as_tensor(np.asarray(weights[slots], np.float32),
                            device=device)
        loss = (torch.stack(losses) * w).sum()
        if client_group is not None:
            all_reduce_flat(acc + [loss], client_group)
        server_step(global_leaves, acc, server_lr)
        for n, b in server.named_buffers():
            if n.endswith("num_batches_tracked"):
                b.add_(batches["label"].shape[1])
        return {"loss": loss}

    return round_fn


def stack_client_batches(per_client_batches) -> Dict[str, np.ndarray]:
    """List of per-client {key: (S, B, ...)} dicts → {key: (C, S, B, ...)}."""
    return {k: np.stack([cb[k] for cb in per_client_batches], axis=0)
            for k in per_client_batches[0]}
