"""A world of ranks on the CPU for the port's tests: ``run_world(fn, world,
tmp_path, *args)`` spawns ``world`` processes that join a gloo group through
a ``FileStore`` under ``tmp_path`` (no TCP port), run ``fn(*args)`` and send
back what it returns, rank by rank. A rank that raises, or a world that does
not finish within ``timeout`` seconds, fails the caller, and every process
is stopped.

Spawned processes import the module that defines their target, so this one
and every worker below import only torch, numpy and the port — never JAX.
The workers run ``vit_tiny`` cut to 2 blocks (``shallow``), as the tests'
JAX side does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import queue
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fedvit_torch.core import config as tconfig
from fedvit_torch.models import build_model
from fedvit_torch.models import vit as tvit

WORLD_TIMEOUT = 150.0


def _rank_main(rank: int, world: int, store: str, fn: Callable, args,
               out) -> None:
    torch.set_num_threads(1)
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        from fedvit_torch.parallel.mesh import init_process_group_from_env
        init_process_group_from_env("cpu", init_method=f"file://{store}",
                                    log=lambda s: None)
        result = fn(*args)
        dist.barrier()
        out.put((rank, True, result))
    except Exception:                              # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn: Callable, world: int, tmp_path, *args,
              timeout: float = WORLD_TIMEOUT) -> List[Any]:
    """``fn(*args)`` on each of ``world`` ranks; their results by rank."""
    store = Path(tmp_path) / f"store_{fn.__name__}_{os.getpid()}"
    if store.exists():
        store.unlink()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(store), fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{fn.__name__}: the world of {world} did "
                                   f"not finish in {timeout:.0f} s")
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                                   f"{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
    return [results[r] for r in range(world)]


@contextlib.contextmanager
def shallow():
    """``vit_tiny`` cut to 2 blocks in the port's ``VIT_CONFIGS``."""
    saved = tvit.VIT_CONFIGS["tiny"]
    tvit.VIT_CONFIGS["tiny"] = dict(saved, depth=2)
    try:
        yield
    finally:
        tvit.VIT_CONFIGS["tiny"] = saved


def numpy_tree(tree):
    """Tensors → numpy arrays, through dicts and lists."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def model_from(raw: Dict, state_dict=None, seed: int = 0):
    """The port's model for ``raw`` on the CPU: seeded, or loaded from a
    numpy ``state_dict``."""
    cfg = tconfig.from_dict(copy.deepcopy(raw))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in state_dict.items()})
    return cfg, model


# --- the data-parallel step --------------------------------------------------------

def steps(raw: Dict, batches: List[Dict], class_weights, data: bool,
          reduce: bool = True) -> Dict:
    """Train ``len(batches)`` steps of the port's train step from the
    seeded model, data-parallel over the default group when ``data`` (the
    gradient all-reduce left out when not ``reduce``). Returns the first
    step's loss, gradients and BatchNorm statistics, each step's loss and
    grad norm, the final state dict and the generator's state."""
    from fedvit_torch.parallel.data import DataParallel
    from fedvit_torch.train import step as tstep
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    with shallow():
        cfg, model = model_from(raw)
        tx, _ = build_optimizer(cfg, model, steps_per_epoch=4)
        state = TrainState.create(model, tx, 5)
        loss_fn = build_loss(cfg, None if class_weights is None
                             else torch.tensor(class_weights))
        dp = DataParallel(dist.group.WORLD) if data else None
        step = tstep.make_train_step(cfg, loss_fn, data=dp)
        reduce_flat = tstep.all_reduce_flat
        if not reduce:
            tstep.all_reduce_flat = lambda *a, **k: None
        try:
            grads, loss, stats = step.accumulate_grads(state, batches[0])
            out = {"loss0": float(loss), "grads0": numpy_tree(grads),
                   "stats0": numpy_tree(stats)}
            norms = [float(step.apply_update(state, grads))]
            losses = [float(loss)]
            for batch in batches[1:]:
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        finally:
            tstep.all_reduce_flat = reduce_flat
        out.update(losses=losses, norms=norms,
                   params=numpy_tree(model.state_dict()),
                   generator=state.generator.get_state().numpy().copy(),
                   np_rng=state.np_rng.bit_generator.state)
    return out


def step_span_counts(raw: Dict, batch: Dict) -> Dict[str, int]:
    """One data-parallel train step over the default group from the seeded
    model; how many spans of each of the step's names it recorded
    (``utils/profiling.py``)."""
    from fedvit_torch.parallel.data import DataParallel
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step
    from fedvit_torch.utils.profiling import reset_spans, span_stats
    with shallow():
        cfg, model = model_from(raw)
        tx, _ = build_optimizer(cfg, model, steps_per_epoch=4)
        state = TrainState.create(model, tx, 5)
        step = make_train_step(cfg, build_loss(cfg),
                               data=DataParallel(dist.group.WORLD))
        reset_spans()
        step(state, batch)
    names = ("train.augment", "train.forward_backward", "train.allreduce",
             "train.update")
    return {n: span_stats(n).count if span_stats(n) else 0 for n in names}


# --- the fold --------------------------------------------------------------------

def fold(raw: Dict, state_dict, data: Dict, workdir: str,
         resume: bool = False) -> Dict:
    """``train_fold`` of fold 0 on ``data``'s train / val / test numpy
    dicts from ``state_dict``, on the CPU; records every validation, the
    checkpoint writes and loads of this rank."""
    from fedvit_torch.data.pipeline import ArrayDataSource
    from fedvit_torch.train import checkpoint as ckpt
    from fedvit_torch.train import loop as tloop
    evals, writes, loads = [], [], []
    evaluate, atomic, load = (tloop._evaluate, ckpt._atomic_save,
                              ckpt.load_checkpoint)

    def recording_evaluate(*a, **k):
        out = evaluate(*a, **k)
        evals.append({k2: out[k2] for k2 in ("loss", "accuracy")})
        return out

    def recording_atomic(obj, path):
        writes.append(str(path))
        return atomic(obj, path)

    def recording_load(path, state):
        loads.append(str(path))
        return load(path, state)

    def model_for(cfg, device, generator):
        return model_from(raw, state_dict)[1]

    tloop._evaluate, ckpt._atomic_save = recording_evaluate, recording_atomic
    ckpt.load_checkpoint, build = recording_load, tloop.build_model
    tloop.build_model = model_for
    lines: List[str] = []
    try:
        with shallow():
            cfg = tconfig.from_dict(copy.deepcopy(raw))
            result = tloop.train_fold(
                cfg, 0, *(None if data[k] is None else ArrayDataSource(data[k])
                          for k in ("train", "val", "test")),
                workdir=workdir, log=lines.append, resume=resume,
                device="cpu", on_step=None)
    finally:
        tloop._evaluate, ckpt._atomic_save = evaluate, atomic
        ckpt.load_checkpoint, tloop.build_model = load, build
    return {"logits": result.logits, "metrics": {
        k: result.metrics[k] for k in ("accuracy", "macro_f1")},
        "evals": evals, "writes": writes, "loads": loads, "log": lines}


def fold_refusal(raw: Dict, data: Dict) -> str:
    """The message ``train_fold`` refuses ``raw``'s macro batch with."""
    try:
        fold(raw, None, data, None)
    except ValueError as e:
        return str(e)
    return ""


# --- FedAvg ------------------------------------------------------------------------

def fed_round(raw: Dict, state_dict, batches: Dict, weights, clients,
              mesh_shape=None, drop_sum: bool = False) -> Dict:
    """One FedAvg round of the port from ``state_dict`` on the CPU, over a
    mesh of ``mesh_shape`` (``(clients, data)`` or ``(clients,)``) of the
    default group, or on one process without. ``batches`` holds every
    active client's {key: (C, S, B, ...)}; each rank takes its part. Returns
    the loss, the global state dict and each client's trained leaves by
    client id. With ``drop_sum`` rank 1 adds none of its clients to the
    sum."""
    from fedvit_torch.fed import fedavg
    from fedvit_torch.parallel import mesh as pmesh
    from fedvit_torch.train.losses import build_loss
    trained = []
    accumulate = fedavg.accumulate

    def recording(acc, leaves, weight):
        trained.append([t.detach().clone().numpy() for t in leaves])
        if drop_sum and pmesh.rank() == 1:
            return None
        return accumulate(acc, leaves, weight)

    fedavg.accumulate = recording
    try:
        with shallow():
            cfg, server = model_from(raw, state_dict)
            work = copy.deepcopy(server)
            mesh = None
            local = {k: torch.from_numpy(np.asarray(v))
                     for k, v in batches.items()}
            if mesh_shape is not None:
                names = ["client", "data"][:len(mesh_shape)]
                mesh = pmesh.make_mesh(list(mesh_shape), names)
                local = pmesh.shard_leading(mesh, local, "client")
                if "data" in names:
                    local = {k: pmesh.shard_leading(
                        mesh, v.transpose(0, 2), "data").transpose(0, 2)
                        for k, v in local.items()}
            round_fn = fedavg.make_federated_round(cfg, build_loss(cfg),
                                                   mesh)
            metrics = round_fn(server, work, local, np.asarray(weights),
                               list(clients), 1, 0)
            slots = fedavg.client_slots(mesh, "client", len(clients))
    finally:
        fedavg.accumulate = accumulate
    return {"loss": float(metrics["loss"]),
            "params": numpy_tree(server.state_dict()),
            "clients": {int(clients[s]): leaves for s, leaves in
                        zip(range(slots.start, slots.stop), trained)}}


def federated(raw: Dict, state_dict, train_data: Dict, eval_data: Dict,
              workdir: str, rounds: int, resume: bool = False) -> Dict:
    """``train_federated`` for ``rounds`` rounds from ``state_dict`` on the
    CPU (over a client mesh of the default group when it has several
    ranks); its history and the final global state dict."""
    from fedvit_torch.fed.server import train_federated
    with shallow():
        cfg, model = model_from(raw, state_dict)
        cfg = cfg.replace(federated=dataclasses.replace(cfg.federated,
                                                        rounds=rounds))
        result = train_federated(cfg, model, train_data, eval_data,
                                 log_fn=lambda s: None, eval_batch_size=8,
                                 workdir=workdir, resume=resume,
                                 device="cpu")
    return {"history": [{k: v for k, v in h.items() if k != "round_time_s"}
                        for h in result.history],
            "params": numpy_tree(result.model.state_dict())}


def probe(raw: Dict, fits_by_rank: List[int]) -> int:
    """``auto_batch_size`` on this rank's model, whose forward runs out of
    memory above ``fits_by_rank[rank]`` rows."""
    from fedvit_torch.parallel.mesh import rank
    from fedvit_torch.train.probe import auto_batch_size
    with shallow():
        cfg, model = model_from(raw)
    forward, fits = model.forward, fits_by_rank[rank()]

    def limited(x, meta=None, *args, **kwargs):
        if x.shape[0] > fits:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return forward(x, meta, *args, **kwargs)

    model.forward = limited
    return auto_batch_size(cfg, model, log=lambda s: None, device="cpu")


# --- the CLIs ----------------------------------------------------------------------

def cli(module: str, argv: List[str]) -> Dict:
    """``fedvit_torch.cli.<module>``'s ``main(argv)`` on this rank (the
    group already joined, as under torchrun): its exit code and its stdout
    lines."""
    import contextlib as cl
    import importlib
    import io
    main = importlib.import_module(f"fedvit_torch.cli.{module}").main
    out = io.StringIO()
    with shallow(), cl.redirect_stdout(out):
        rc = main(argv)
    return {"rc": rc, "stdout": out.getvalue().splitlines()}


# --- meshes ----------------------------------------------------------------------

def mesh_facts(sizes, names) -> Dict:
    """This rank's view of ``make_mesh(sizes, names)``: the mesh's ranks,
    its coordinate, ``shard_batch`` of a (6, 2) tensor along the last axis
    and ``replicate`` of a tensor holding the rank."""
    from fedvit_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(sizes, names)
    batch = {"x": torch.arange(12.0).reshape(6, 2)}
    rep = {"r": torch.full((3,), float(pmesh.rank()))}
    pmesh.replicate(mesh, rep)
    return {"mesh": mesh.mesh.numpy().tolist(),
            "coordinate": mesh.get_coordinate(),
            "shard": pmesh.shard_batch(mesh, batch, names[-1])["x"].numpy(),
            "replicated": rep["r"].numpy()}
