"""LR schedule — linear warmup then cosine decay, stepped once per epoch
(``fedvit_tpu/train/schedule.py``):

    epoch e < warmup : lr = base · e / max(1, warmup)          (epoch 0 → 0)
    else             : p  = (e - warmup) / max(1, total - warmup)
                       lr = min_lr + (base - min_lr) · ½(1 + cos(π·p))

As a function of the optimizer step, epoch = step // steps_per_epoch, and
the optimizer reads it at the count *before* its update, as optax's
``scale_by_schedule`` does. So with ``warmup_epochs > 0`` every step of epoch
0 has LR exactly 0 and moves nothing.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def warmup_cosine_lr(epoch: int, base_lr: float, warmup_epochs: int,
                     total_epochs: int, min_lr: float = 1e-6) -> float:
    """LR at integer ``epoch``, computed in float32 as the JAX package does."""
    e = np.float32(epoch)
    if e < warmup_epochs:
        return float(np.float32(base_lr) * e / np.float32(max(1, warmup_epochs)))
    progress = (e - np.float32(warmup_epochs)) / np.float32(
        max(1, total_epochs - warmup_epochs))
    cos = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * progress,
                                                      dtype=np.float32))
    return float(np.float32(min_lr) + np.float32(base_lr - min_lr) * cos)


def make_epoch_schedule(base_lr: float, warmup_epochs: int, total_epochs: int,
                        min_lr: float, steps_per_epoch: int
                        ) -> Callable[[int], float]:
    """step → lr, constant within an epoch."""
    spe = max(1, int(steps_per_epoch))

    def schedule(step: int) -> float:
        return warmup_cosine_lr(int(step) // spe, base_lr, warmup_epochs,
                                total_epochs, min_lr)

    return schedule


def lr_curve(base_lr: float, warmup_epochs: int, total_epochs: int,
             min_lr: float) -> np.ndarray:
    """The LR of every epoch, for logging and tests."""
    return np.array([warmup_cosine_lr(e, base_lr, warmup_epochs, total_epochs,
                                      min_lr) for e in range(total_epochs)])
