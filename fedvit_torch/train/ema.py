"""Exponential moving average of the parameters (``fedvit_tpu/train/ema.py``):
s ← d·s + (1−d)·p after every optimizer step, over parameters only (the
BatchNorm running statistics are not averaged, as in the JAX package, whose
shadow is a copy of ``params``)."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch
from torch import nn


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A real copy of every parameter — never an alias of the live tensors,
    which the optimizer updates in place."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], model: nn.Module,
               decay: float) -> None:
    """s ← d·s + (1−d)·p for every parameter, in place: ``_foreach_lerp_``
    computes s + (1−d)(p − s), the same average in one pass, and updating the
    shadow in place keeps no second copy of it."""
    names = list(shadow)
    params = dict(model.named_parameters())
    torch._foreach_lerp_([shadow[n] for n in names],
                         [params[n].detach() for n in names], 1.0 - decay)


@contextlib.contextmanager
def shadow_weights(model: nn.Module,
                   shadow: Optional[Dict[str, torch.Tensor]]
                   ) -> Iterator[nn.Module]:
    """``model`` with the ``shadow``'s tensors as its parameters inside the
    block (the model as it is when ``shadow`` is None), and with its own
    parameters again after it, whatever the block raised. Nothing is
    copied: the parameters point at the shadow's tensors for the length of
    the block."""
    if shadow is None:
        yield model
        return
    params = dict(model.named_parameters())
    own = {n: p.data for n, p in params.items()}
    for n, s in shadow.items():
        params[n].data = s
    try:
        yield model
    finally:
        for n, p in params.items():
            p.data = own[n]
