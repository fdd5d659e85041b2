"""TrainState — what a training run carries from step to step
(``fedvit_tpu/train/state.py``).

Parameters and BatchNorm statistics live in the model (``nn.Module``); the
optimizer state and the EMA shadow are plain dicts of tensors keyed by
parameter name; randomness comes from two explicit generators: a
``torch.Generator`` on the model's device (dropout, drop-path, mix
permutations) and a ``numpy.random.Generator`` on the host (mix λ, choice and
box).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from fedvit_torch.train.ema import ema_init
from fedvit_torch.train.optim import AdamWLLRD


@dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: AdamWLLRD
    opt_state: Dict
    ema: Optional[Dict[str, torch.Tensor]]   # None disables EMA
    generator: torch.Generator
    np_rng: np.random.Generator

    @classmethod
    def create(cls, model: nn.Module, tx: AdamWLLRD, seed: int,
               ema_enabled: bool = True) -> "TrainState":
        device = next(model.parameters()).device
        return cls(step=0, model=model, tx=tx, opt_state=tx.init(model),
                   ema=ema_init(model) if ema_enabled else None,
                   generator=torch.Generator(device=device).manual_seed(seed),
                   np_rng=np.random.default_rng(seed))

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The state dict to evaluate with (``eval/serve.py``): the model's,
        with the EMA shadow in place of the parameters when EMA is on."""
        sd = self.model.state_dict()
        if self.ema is not None:
            sd.update(self.ema)
        return sd
