"""Metadata fusion branches (``fedvit_tpu/models/metadata.py``).

* ``MetadataBranch`` — the current generation's MLP on the flat 13-dim vector
  (reference model.py:27-60: Linear(13→256) → BN → GELU → Dropout(0.4) →
  Linear(256→128) → BN → GELU), named ``net.{0,1,4,5}`` as in the reference.
* ``MetadataEmbedding`` — the old generation's learned embeddings of the raw
  fields (reference model_old.py:28-112), with JAX's module names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedvit_torch.data.constants import NUM_SEX, NUM_SITE
from fedvit_torch.models.layers import (GELU, Dense, Dropout, LayerNormF32,
                                        TorchBatchNorm, run_sequential)


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


class MetadataEmbedding(nn.Module):
    """age → Dense(d/4) + ReLU; sex and site → embeddings of d/4 and d/2;
    concatenated → Dense(d) → LayerNorm (eps 1e-6, fp32) → ReLU →
    Dropout(0.1). Inputs are the raw fields: age (B,) or (B, 1) float, sex
    and site (B,) int."""

    def __init__(self, embed_dim: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = embed_dim
        self.compute_dtype = dtype
        self.age_proj = Dense(1, d // 4, dtype)
        self.sex_embed = nn.Embedding(NUM_SEX, d // 4)
        self.site_embed = nn.Embedding(NUM_SITE, d // 2)
        self.fusion = Dense(d // 4 * 2 + d // 2, d, dtype)
        self.fusion_ln = LayerNormF32(d)
        self.dropout = Dropout(0.1)

    def forward(self, age: torch.Tensor, sex: torch.Tensor, site: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """→ (B, embed_dim) fp32; in training mode the dropout mask comes
        from ``generator``."""
        dt = self.compute_dtype
        if age.dim() == 1:
            age = age[:, None]
        x = torch.cat([torch.relu(self.age_proj(age)),
                       self.sex_embed.weight.to(dt)[sex.long()],
                       self.site_embed.weight.to(dt)[site.long()]], dim=-1)
        x = torch.relu(self.fusion_ln(self.fusion(x)))
        return self.dropout(x, generator).float()
