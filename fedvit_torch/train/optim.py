"""AdamW with layer-wise LR decay (LLRD) and the warmup-cosine schedule
(``fedvit_tpu/train/optim.py``).

``build_optimizer`` returns the same transform as the JAX package's optax
chain (:112-128), in this order, for every parameter:

1. clip: optax's ``clip_by_global_norm`` — g·c/‖g‖ when ‖g‖ ≥ c (not
   ``torch.nn.utils.clip_grad_norm_``, which divides by ‖g‖ + 1e-6);
2. Adam: m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², bias-corrected, update
   m̂ / (√v̂ + eps), with m stored in ``optimizer.mu_dtype``;
3. weight decay: + wd·p on every parameter, with no mask;
4. LLRD: × the parameter's scale (``llrd_scale_map``);
5. LR: × −lr(count), with the count before this update.

It is written as ``torch._foreach_*`` passes over all parameters at once
and updates them in place.

``build_head_optimizer`` is the stage-1 transform of the two-stage schedule
(:131-154): the same clip, Adam and weight decay at a constant LR on the
parameters outside the backbone only (the clip's norm taken over those), and
a zero update for the backbone, whose parameters it leaves alone.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from fedvit_torch.core.config import Config
from fedvit_torch.models.registry import DTYPES
from fedvit_torch.train.schedule import make_epoch_schedule

_STAGE = re.compile(r"^backbone\.(blocks|layers)\.(\d+)\.")
_LOWEST = ("patch_embed", "patch_norm", "cls_token", "pos_embed",
           "absolute_pos_embed")


def llrd_scale_map(names: Iterable[str], decay: float = 0.75,
                   head_mult: float = 10.0) -> Dict[str, float]:
    """The LR multiplier of each parameter name (``llrd_scale_tree`` on the
    port's timm names), with n the backbone's block count:

    ``backbone.patch_embed.*``, ``backbone.cls_token``, ``backbone.pos_embed``
    : d^(n+1); ``backbone.blocks.{i}.*`` and ``backbone.layers.{i}.*`` :
    d^(n−i); other backbone parameters (the final ``backbone.norm``) : 1;
    everything else (head, metadata) : ``head_mult``.

    A SwinV2 patch merging is ``backbone.layers.{s}.downsample.*`` here (timm
    puts it at the start of the stage it feeds) and ``layers_{s−1}/downsample``
    in the JAX tree (at the end of the stage it follows): it takes stage
    s−1's scale, d^(n−s+1), as the JAX package gives it."""
    names = list(names)
    stages = [int(m.group(2)) for m in map(_STAGE.match, names) if m]
    n = max(stages) + 1 if stages else 0

    def scale_for(name: str) -> float:
        parts = name.split(".")
        if parts[0] != "backbone":
            return head_mult
        if parts[1] in _LOWEST:
            return decay ** (n + 1)
        m = _STAGE.match(name)
        if m:
            i = int(m.group(2)) - (parts[3] == "downsample")
            return decay ** (n - i)
        return 1.0

    return {name: scale_for(name) for name in names}


class AdamWLLRD:
    """clip → Adam → weight decay → LLRD → −lr(count), over the parameters
    named in ``scales``. ``init`` makes the state; ``step`` applies one update
    in place and returns the global norm of those parameters' gradients
    before clipping."""

    def __init__(self, scales: Dict[str, float],
                 schedule: Callable[[int], float], grad_clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.float32):
        self.scales = scales
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, model: nn.Module) -> Dict:
        """The state of the parameters this transform updates: those named
        in ``scales``."""
        params = {n: p for n, p in model.named_parameters() if n in self.scales}
        return {"count": 0,
                "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def step(self, model: nn.Module, grads: Dict[str, torch.Tensor],
             state: Dict) -> torch.Tensor:
        names = list(state["nu"])
        pmap = dict(model.named_parameters())
        params = [pmap[n] for n in names]
        g = [grads[n].float() for n in names]

        norm = global_norm(g)
        if self.grad_clip and self.grad_clip > 0:
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            g = torch._foreach_mul(g, factor)

        count = state["count"] + 1
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        # b1·m in m's dtype (rounded to bf16 when m is, as optax's weakly
        # typed product is), then + (1 − b1)·g in fp32
        torch._foreach_mul_(mu, self.b1)
        mu32 = mu if self.mu_dtype == torch.float32 else [m.float() for m in mu]
        torch._foreach_add_(mu32, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu32, bc1)
        torch._foreach_div_(update, denom)
        if mu32 is not mu:
            for m, m32 in zip(mu, mu32):
                m.copy_(m32)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, [self.scales[n] for n in names])
        torch._foreach_add_(params, update, alpha=-self.schedule(state["count"]))
        state["count"] = count
        return norm


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the 2-norm of all the tensors' elements, in
    fp32."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def build_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int
                    ) -> Tuple[AdamWLLRD, Callable[[int], float]]:
    """The training transform for ``cfg`` and ``model``: (optimizer,
    schedule). One step is one macro batch (accumulation happens inside the
    train step)."""
    t = cfg.training
    opt = t.optimizer
    schedule = make_epoch_schedule(opt.lr, t.scheduler.warmup_epochs, t.epochs,
                                   t.scheduler.min_lr, steps_per_epoch)
    # as in the reference, LLRD groups always exist with the head at
    # head_lr_mult; "disabled" only flattens the backbone's decay to 1
    decay = t.llrd.decay_rate if t.llrd.enabled else 1.0
    scales = llrd_scale_map((n for n, _ in model.named_parameters()), decay,
                            t.llrd.head_lr_mult)
    tx = AdamWLLRD(scales, schedule, t.grad_clip or 0.0, opt.b1, opt.b2,
                   opt.eps, opt.weight_decay, DTYPES[opt.mu_dtype])
    return tx, schedule


def head_only_mask(model: nn.Module) -> Dict[str, bool]:
    """True for every parameter outside the backbone (the head, the metadata
    branch): the leaves stage 1 of the two-stage schedule trains
    (train_old.py:433-498)."""
    return {n: not n.startswith("backbone.") for n, _ in model.named_parameters()}


def build_head_optimizer(cfg: Config, model: nn.Module, lr: float) -> AdamWLLRD:
    """Stage-1 optimizer: clip (``grad_clip``, or 1.0 when unset) → Adam →
    weight decay → −lr on the head's parameters; the backbone is frozen (a
    zero update). Adam's first moment is fp32, as optax's default."""
    opt = cfg.training.optimizer
    head = [n for n, keep in head_only_mask(model).items() if keep]
    return AdamWLLRD({n: 1.0 for n in head}, lambda count: lr,
                     cfg.training.grad_clip or 1.0, opt.b1, opt.b2, opt.eps,
                     opt.weight_decay)
