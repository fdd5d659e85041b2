"""Metadata fusion branch — ``fedvit_tpu/models/metadata.py::MetadataBranch``
(reference model.py:27-60: Linear(13→256) → BN → GELU → Dropout(0.4) →
Linear(256→128) → BN → GELU), named ``net.{0,1,4,5}`` as in the reference."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedvit_torch.models.layers import (GELU, Dense, Dropout, TorchBatchNorm,
                                        run_sequential)


class MetadataBranch(nn.Module):
    def __init__(self, input_dim: int = 13, hidden_dim: int = 256,
                 output_dim: int = 128, dropout: float = 0.4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.Sequential(
            Dense(input_dim, hidden_dim, dtype), TorchBatchNorm(hidden_dim),
            GELU(), Dropout(dropout),
            Dense(hidden_dim, output_dim, dtype), TorchBatchNorm(output_dim),
            GELU())

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, input_dim) → (B, output_dim) fp32. The BatchNorms emit
        fp32, so both GELUs take the exact-erf form, as in the JAX package.
        In training mode the dropout mask comes from ``generator``."""
        return run_sequential(self.net, x, generator).float()
