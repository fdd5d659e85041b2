"""Classification head — ``fedvit_tpu/models/heads.py::ClassifierHead``
(reference model.py:139-145: Linear → GELU → Dropout(0.5) → Linear), named
``classifier.{0,3}`` as in the reference. The old generation's variant
(``layer_norm=True``, reference model_old.py:215-221) adds a LayerNorm after
the GELU: Linear → GELU → LayerNorm → Dropout → Linear, ``classifier.{0,2,4}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedvit_torch.models.layers import (GELU, Dense, Dropout, LayerNormF32,
                                        run_sequential)


class ClassifierHead(nn.Sequential):
    def __init__(self, in_dim: int, num_classes: int = 8,
                 hidden_dim: int = 512, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 layer_norm: bool = False):
        norm = [LayerNormF32(hidden_dim)] if layer_norm else []
        super().__init__(Dense(in_dim, hidden_dim, dtype), GELU(), *norm,
                         Dropout(dropout),
                         Dense(hidden_dim, num_classes, dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, in_dim) → fp32 logits (B, num_classes); in training mode the
        dropout mask comes from ``generator``. The LayerNorm takes the GELU's
        output promoted to fp32 and returns fp32, as flax's
        ``nn.LayerNorm(dtype=float32)``."""
        return run_sequential(self, x, generator).float()
