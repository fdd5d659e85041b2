"""Device meshes over ``torch.distributed`` (``fedvit_tpu/parallel/mesh.py``).

JAX is one process that sees every device; here there is one process a rank,
PyTorch's idiom, and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group. Its axes are the JAX package's:

* ``"client"`` — federated clients (FedAvg's weighted sum is an all-reduce
  over this axis, ``fed/fedavg.py``);
* ``"data"`` — data parallelism (the fold's gradient all-reduce,
  ``train/step.py``, or a client's batch shards on a 2-D mesh).

Which rank sits where is plain arithmetic on rank numbers
(``mesh_layout``, ``hybrid_layout``), the same as JAX's on its device list,
so it is tested without a process group. Building a ``DeviceMesh`` is
collective: every rank of the world calls it, also a rank the mesh leaves
out.

A process joins the group through ``init_process_group_from_env``, which
reads torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE``. Its backend follows one rule (``choose_backend``),
never the failure of another: NCCL when every rank on the node has a card of
its own, gloo when ranks share a card (NCCL refuses two ranks on one device)
or run on the CPU. ``launch_ranks`` starts the ranks of a command on one
node, as torchrun does, for the entry points' plain launch on N cards.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the device this process's rank computes on, once it joined a group
_rank_device: Optional[torch.device] = None


# --- layout: which rank sits where (no process group needed) -------------------

def mesh_layout(axis_sizes: Sequence[int], axis_names: Sequence[str],
                ranks: Sequence[int]) -> np.ndarray:
    """The ranks of a mesh, an array of shape ``axis_sizes``: the first
    ∏ sizes of ``ranks`` in order, as JAX lays out its devices. A size of −1
    is "whatever is left" (at most one)."""
    sizes = list(axis_sizes)
    if -1 in sizes:
        i = sizes.index(-1)
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[i] = len(ranks) // known
    total = int(np.prod(sizes))
    if total > len(ranks):
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} needs {total} "
                         f"devices, have {len(ranks)}")
    return np.array(list(ranks)[:total], dtype=np.int64).reshape(sizes)


def hybrid_layout(slices: int, per_slice: int,
                  ranks: Sequence[int]) -> np.ndarray:
    """The ranks of a (slices, per_slice) mesh in rank order: JAX's
    ``hybrid_mesh`` on devices without a slice topology, where device order
    stands in for the slice grouping."""
    need = slices * per_slice
    if need > len(ranks):
        raise ValueError(f"hybrid mesh {slices}x{per_slice} needs {need} "
                         f"devices, have {len(ranks)}")
    return np.array(list(ranks)[:need], dtype=np.int64).reshape(
        slices, per_slice)


def row_piece(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows [lo, hi) of piece ``index`` when ``n`` rows are cut into
    ``parts`` pieces in order, the first ``n % parts`` a row longer
    (``numpy.array_split``): even pieces when ``parts`` divides ``n``."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


# --- the process group ----------------------------------------------------------

def world_size() -> int:
    """The default group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return rank() == 0


def silent(_: str) -> None:
    """A log that prints nothing: a rank other than 0's."""


def writer_log(log: Callable[[str], None]) -> Callable[[str], None]:
    """``log`` on the process that writes (``is_writer``), ``silent`` on
    every other rank."""
    return log if is_writer() else silent


def barrier() -> None:
    """Every rank waits for the others; nothing without a group of more than
    one."""
    if world_size() > 1:
        dist.barrier()


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int) -> Tuple[str, str]:
    """(backend, reason). NCCL when the ranks compute on CUDA and every rank
    on the node has a card of its own; gloo when ranks share a card (NCCL
    refuses two ranks on one device; gloo moves CUDA tensors through the
    host) or compute on the CPU."""
    if device_type != "cuda":
        return "gloo", "ranks on the CPU"
    if local_world_size <= device_count:
        return "nccl", (f"{local_world_size} ranks on {device_count} "
                        f"card(s), one card a rank")
    return "gloo", (f"{local_world_size} ranks share {device_count} "
                    f"card(s)")


def init_process_group_from_env(device: str = "cuda",
                                init_method: str = "env://",
                                log: Callable[[str], None] = print
                                ) -> torch.device:
    """Join the default process group as torchrun's environment says
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and
    return this rank's device: ``cuda:{LOCAL_RANK % device_count}``, made
    the current device, or the CPU when ``device`` is ``cpu``. The backend is
    ``choose_backend``'s, and logged."""
    global _rank_device
    r = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", r))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    count = 0
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run fedvit_torch on the CPU")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    backend, why = choose_backend(dev.type, local_world, count)
    dist.init_process_group(backend, init_method=init_method, rank=r,
                            world_size=world)
    _rank_device = dev
    log(f"[parallel] rank {r}/{world} on {dev}: backend {backend} ({why})")
    return dev


def launched_rank() -> bool:
    """Whether this process is one rank of a launch (torchrun's or
    ``launch_ranks``'s environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def main_on_ranks(module: str, argv: Optional[Sequence[str]], device: str,
                  launch: bool, run: Callable[[torch.device], int]) -> int:
    """An entry point's body, ``run(device)``, on the ranks it takes:

    - in a rank of a launch (torchrun's environment, or ``launch_ranks``')
      whose group is not joined yet: join it
      (``init_process_group_from_env``), run on this rank's device, leave
      it;
    - with ``launch`` on a CUDA ``device`` of a machine with N > 1 cards:
      start N ranks of ``python -m module argv`` and return their exit
      code;
    - else (one card, the CPU, or a group already joined): run here."""
    if not dist.is_initialized() and launched_rank():
        dev = init_process_group_from_env(device)
        try:
            return run(dev)
        finally:
            dist.destroy_process_group()
    dev = torch.device(device)
    if launch and not dist.is_initialized() and dev.type == "cuda" and \
            torch.cuda.device_count() > 1:
        return launch_ranks(torch.cuda.device_count(), [
            sys.executable, "-m", module,
            *(sys.argv[1:] if argv is None else argv)])
    return run(dev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(n: int, argv: Sequence[str],
                 env: Optional[Dict[str, str]] = None) -> int:
    """Run ``argv`` as ``n`` ranks on this node, as ``torchrun
    --nproc_per_node n`` does: each process gets ``RANK`` = ``LOCAL_RANK`` =
    its index, ``WORLD_SIZE`` = ``LOCAL_WORLD_SIZE`` = n and a free
    localhost port for the rendezvous. Returns 0 when every rank exits 0;
    when one fails, the others are stopped and its exit code is returned."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    procs: List[subprocess.Popen] = []
    for r in range(n):
        procs.append(subprocess.Popen(
            list(argv), env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
    rc = 0
    try:
        while procs and rc == 0:
            for p in list(procs):
                code = p.poll()
                if code is not None:
                    procs.remove(p)
                    rc = rc or code
            time.sleep(0.2)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


# --- meshes ---------------------------------------------------------------------

def _device_type() -> str:
    if _rank_device is not None:
        return _rank_device.type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _world_ranks(num: Optional[int]) -> List[int]:
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a process group: join "
                           "one first (init_process_group_from_env)")
    ranks = list(range(dist.get_world_size()))
    return ranks[:num] if num else ranks


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh of the group's ranks (``ranks``, default all of them) laid
    out by ``mesh_layout``."""
    ranks = _world_ranks(None) if ranks is None else list(ranks)
    arr = mesh_layout(axis_sizes, axis_names, ranks)
    return DeviceMesh(_device_type(), torch.from_numpy(arr),
                      mesh_dim_names=tuple(axis_names))


def client_mesh(num_ranks: Optional[int] = None) -> DeviceMesh:
    """1-D mesh over the ranks for federated client parallelism."""
    ranks = _world_ranks(num_ranks)
    return make_mesh([len(ranks)], ["client"], ranks)


def data_mesh(num_ranks: Optional[int] = None) -> DeviceMesh:
    """1-D mesh for plain data parallelism."""
    ranks = _world_ranks(num_ranks)
    return make_mesh([len(ranks)], ["data"], ranks)


def hybrid_mesh(slices: int, per_slice: int,
                axis_names: Sequence[str] = ("client", "data"),
                ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """2-D (slices, per_slice) mesh: the outer axis ("client") across
    slices, the inner ("data") within one (JAX's multi-slice layout; on one
    node rank order stands in for the slices)."""
    ranks = _world_ranks(None) if ranks is None else list(ranks)
    arr = hybrid_layout(slices, per_slice, ranks)
    return DeviceMesh(_device_type(), torch.from_numpy(arr),
                      mesh_dim_names=tuple(axis_names))


def mesh_coordinate(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis``; raises for a rank the mesh leaves
    out."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {rank()} is not in the mesh {mesh}")
    return coord[mesh.mesh_dim_names.index(axis)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_leading(mesh: DeviceMesh, tree, axis: str):
    """This rank's piece of every leaf's leading dimension along ``axis``
    (e.g. stacked per-client batches along "client"): ``row_piece`` of it,
    even when the axis divides the dimension."""
    index, parts = mesh_coordinate(mesh, axis), mesh.size(
        mesh.mesh_dim_names.index(axis))

    def take(x):
        lo, hi = row_piece(x.shape[0], parts, index)
        return x[lo:hi]
    return _tree_map(take, tree)


def shard_batch(mesh: DeviceMesh, batch, axis: str = "data"):
    """This rank's rows of a batch, its leading dimension cut along
    ``axis``."""
    return shard_leading(mesh, batch, axis)


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` (a module's parameters and buffers, or a
    nest of dicts and lists of tensors) made, in place, the value it holds
    on the mesh's first rank: broadcast along each axis in turn from the
    rank at index 0 of it. Returns ``tree``."""
    tensors = (list(tree.state_dict().values())
               if isinstance(tree, torch.nn.Module) else [])
    if not tensors:
        _tree_map(lambda x: tensors.append(x)
                  if isinstance(x, torch.Tensor) else None, tree)
    coord = mesh.get_coordinate()
    if coord is None:
        return tree
    for d in range(mesh.ndim):
        if mesh.size(d) == 1:
            continue
        index = list(coord)
        index[d] = 0
        src = int(mesh.mesh[tuple(index)])
        group = mesh.get_group(d)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return tree
