"""TrainState — what a training run carries from step to step
(``fedvit_tpu/train/state.py``).

Parameters and BatchNorm statistics live in the model (``nn.Module``); the
optimizer state and the EMA shadow are plain dicts of tensors keyed by
parameter name; randomness comes from two explicit generators: a
``torch.Generator`` on the model's device (dropout, drop-path, mix
permutations) and a ``numpy.random.Generator`` on the host (mix λ, choice and
box).

Validation runs on the EMA shadow (``fedvit_tpu``'s ``state.eval_params()``):
``ema_weights()`` puts the shadow in the model's parameters for the length of
a ``with`` block and the trained weights back after it, without a copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ContextManager, Dict, Optional

import numpy as np
import torch
from torch import nn

from fedvit_torch.train.ema import ema_init, shadow_weights
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

    def ema_weights(self) -> ContextManager[nn.Module]:
        """The model with the EMA shadow as its parameters inside a ``with``
        block (the model itself when EMA is off), and with its trained
        parameters again after it (``ema.py::shadow_weights``): nothing is
        copied, and the optimizer and the next step see the trained
        tensors."""
        return shadow_weights(self.model, self.ema)

    def fork(self, tx: AdamWLLRD) -> "TrainState":
        """A state on the same model with optimizer ``tx``, no EMA, step 0,
        and copies of this state's generators (stage 1 of the two-stage
        schedule trains on it and leaves this state's draws as they were)."""
        generator = torch.Generator(device=self.generator.device)
        generator.set_state(self.generator.get_state())
        np_rng = np.random.default_rng()
        np_rng.bit_generator.state = self.np_rng.bit_generator.state
        return TrainState(step=0, model=self.model, tx=tx,
                          opt_state=tx.init(self.model), ema=None,
                          generator=generator, np_rng=np_rng)
