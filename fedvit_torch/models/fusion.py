"""Fusion of the backbone's pooled features with the segmentation branch's
last decoder map, the old generation's (``fedvit_tpu/models/fusion.py``;
reference segmentation.py:277-491):

* ``AttentionFusion`` — the seg map through two 1×1 convs to a sigmoid
  attention map whose mean scales the projected backbone features;
* ``ConcatFusion`` — both halves pooled and projected, concatenated, an MLP;
* ``CrossAttentionFusion`` — the backbone features as a one-token query over
  the flattened seg map, a residual, a projection and a LayerNorm.

JAX's module names (``seg_proj1``, ``trans_proj``, ``q_proj``, ...). Each
computes in the compute dtype where JAX's does and returns fp32 (B, D). No
Pallas kernel is on this path in JAX; the cross-attention is the port's
``ops/attention.py::xla_attention`` and its LayerNorm the port's
``ops/layer_norm.py::LayerNorm`` on fp32 input, whose backward is K4.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedvit_torch.models.layers import Dense, Dropout, LayerNormF32
from fedvit_torch.models.unet import Conv2d
from fedvit_torch.ops.activations import gelu
from fedvit_torch.ops.attention import xla_attention


class AttentionFusion(nn.Module):
    def __init__(self, transformer_dim: int, seg_channels: int,
                 hidden_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.seg_proj1 = Conv2d(seg_channels, hidden_dim, 1, 0, True, dtype)
        self.seg_proj2 = Conv2d(hidden_dim, 1, 1, 0, True, dtype)
        self.trans_proj = Dense(transformer_dim, transformer_dim, dtype)

    def forward(self, trans: torch.Tensor, seg: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """trans (B, D), seg (B, H, W, C) → (B, D) fp32."""
        dt = self.compute_dtype
        a = torch.sigmoid(self.seg_proj2(torch.relu(self.seg_proj1(seg))))
        pooled = a.float().mean(dim=(1, 2)).to(dt)             # (B, 1)
        t = self.trans_proj(trans)
        return (t * (1.0 + pooled)).float()


class ConcatFusion(nn.Module):
    def __init__(self, transformer_dim: int, seg_channels: int,
                 output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.seg_proj = Dense(seg_channels, output_dim // 2, dtype)
        self.trans_proj = Dense(transformer_dim, output_dim // 2, dtype)
        self.fusion_fc = Dense(output_dim // 2 * 2, output_dim, dtype)
        self.dropout = Dropout(0.1)

    def forward(self, trans: torch.Tensor, seg: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training mode the dropout mask comes from ``generator``."""
        dt = self.compute_dtype
        pooled = seg.to(dt).float().mean(dim=(1, 2)).to(dt)
        x = torch.cat([self.trans_proj(trans), self.seg_proj(pooled)], dim=-1)
        x = gelu(self.fusion_fc(x))
        return self.dropout(x, generator).float()


class CrossAttentionFusion(nn.Module):
    def __init__(self, transformer_dim: int, seg_channels: int,
                 output_dim: int, num_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = transformer_dim
        self.num_heads = num_heads
        self.seg_proj = Conv2d(seg_channels, d, 1, 0, True, dtype)
        self.q_proj = Dense(d, d, dtype)
        self.k_proj = Dense(d, d, dtype)
        self.v_proj = Dense(d, d, dtype)
        self.attn_out = Dense(d, d, dtype)
        self.out_proj = Dense(d, output_dim, dtype)
        self.norm = LayerNormF32(output_dim)

    def forward(self, trans: torch.Tensor, seg: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, d = trans.shape
        h = self.num_heads
        seg_flat = self.seg_proj(seg).reshape(b, -1, d)        # (B, HW, D)
        q = self.q_proj(trans)[:, None]                        # (B, 1, D)
        k = self.k_proj(seg_flat)
        v = self.v_proj(seg_flat)
        attn = xla_attention(q.reshape(b, 1, h, d // h),
                             k.reshape(b, -1, h, d // h),
                             v.reshape(b, -1, h, d // h))
        attn = self.attn_out(attn.reshape(b, 1, d))[:, 0]
        fused = trans.float() + attn.float()
        return self.norm(self.out_proj(fused)).float()


def build_fusion_module(fusion_type: str, transformer_dim: int,
                        seg_channels: int, output_dim: Optional[int] = None,
                        dtype: torch.dtype = torch.float32) -> nn.Module:
    """(reference segmentation.py:458-491)"""
    output_dim = output_dim or transformer_dim
    if fusion_type == "attention":
        return AttentionFusion(transformer_dim, seg_channels, dtype=dtype)
    if fusion_type == "concat":
        return ConcatFusion(transformer_dim, seg_channels, output_dim, dtype)
    if fusion_type == "cross_attention":
        return CrossAttentionFusion(transformer_dim, seg_channels, output_dim,
                                    dtype=dtype)
    raise ValueError(f"Unknown fusion type: {fusion_type}")
