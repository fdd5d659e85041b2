"""What a data-parallel train step needs (``train/step.py``): the group and
its semantics, the rows a rank holds of a micro-batch, and the reductions.

There are two semantics, the JAX package's two, and the caller picks one
(``DataParallel.spmd``):

* **SPMD** (``train_fold`` under ``training.data_parallel``, JAX's ``jit``
  over a sharded batch): the values are those of the unsharded step. Each
  micro-batch is cut over the ranks (``mesh.row_piece``); while a rank runs
  forward and backward on its rows, ``rows()`` says which they are, and the
  layers that see across rows read it: dropout and drop-path draw their
  masks at the whole micro-batch's shape and keep the rank's rows (so every
  rank's generator advances alike), BatchNorm sums over the group with
  autograd (``all_reduce_sum``), and the losses divide by the whole
  micro-batch's count or weight (``row_sum``, ``weight_sum``).
* **per shard** (a client's batch on a 2-D FedAvg mesh, JAX's
  ``shard_map``): each rank runs the plain step on its shard, drawing from
  the same generator as its peers; after the step its gradients, loss and
  BatchNorm statistics are averaged over the group (``pmean``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A data group and its semantics: ``spmd`` True for the fold's (the
    unsharded step's values), False for the FedAvg mesh's per-shard
    step."""
    group: dist.ProcessGroup
    spmd: bool = True

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def index(self) -> int:
        return dist.get_rank(self.group)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rank's rows [lo, hi) of a micro-batch of ``n`` rows. A rank
    whose piece is empty (a micro-batch with fewer rows than ranks) holds
    one row, ``start``, that it runs but counts nowhere: ``valid`` is 0."""
    group: dist.ProcessGroup
    lo: int
    hi: int
    n: int

    @property
    def valid(self) -> int:
        return self.hi - self.lo

    @property
    def start(self) -> int:
        return self.lo if self.hi > self.lo else min(self.lo, self.n - 1)

    @property
    def held(self) -> slice:
        """The rows of the micro-batch this rank runs."""
        return slice(self.start, self.start + max(self.valid, 1))


_rows: Optional[Rows] = None


def rows() -> Optional[Rows]:
    """The rows the running SPMD step holds, or None outside one."""
    return _rows


@contextlib.contextmanager
def holding(r: Rows) -> Iterator[Rows]:
    """``rows()`` is ``r`` inside the block (the step's forward and
    backward, where a rematerialised block runs its forward again)."""
    global _rows
    prev, _rows = _rows, r
    try:
        yield r
    finally:
        _rows = prev


def all_reduce_sum(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Σ over the group with autograd: the backward sums the gradients the
    ranks hold, so a loss on every rank gets the gradient of the sum of
    their losses."""
    return dist_nn.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def row_sum(v: torch.Tensor) -> torch.Tensor:
    """The mean over the micro-batch's rows of the per-row ``v``: inside an
    SPMD step the rank's share Σ_own v / n, which sums over the ranks to the
    mean; else ``v.mean()``."""
    r = _rows
    if r is None:
        return v.mean()
    return v[:r.valid].sum() / r.n


def element_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean over every element of the per-row ``v`` (rows on axis 0),
    the rank's share of it inside an SPMD step."""
    r = _rows
    if r is None:
        return v.mean()
    return v[:r.valid].sum() / (r.n * v[0].numel())


def own_sum(v: torch.Tensor) -> torch.Tensor:
    """Σ of the per-row ``v`` over the rows this rank counts (all of them
    outside an SPMD step)."""
    r = _rows
    return v.sum() if r is None else v[:r.valid].sum()


def weight_sum(w: torch.Tensor) -> torch.Tensor:
    """Σ of the per-row weights ``w`` over the whole micro-batch (a constant:
    no gradient flows into it)."""
    r = _rows
    if r is None:
        return w.sum()
    total = w[:r.valid].sum().detach().clone()
    dist.all_reduce(total, group=r.group)
    return total


@torch.no_grad()
def all_reduce_flat(tensors: List[torch.Tensor], group: dist.ProcessGroup,
                    scale: float = 1.0) -> None:
    """Σ over the group of each tensor, times ``scale``, in place, through
    one flat fp32 bucket: one collective however many tensors."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
