"""Vision Transformer backbone — the counterpart of ``fedvit_tpu/models/vit.py``,
with timm parameter names."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedvit_torch.models.layers import (DropPath, Mlp, MultiHeadAttention,
                                        run_blocks)
from fedvit_torch.ops.layer_norm import LayerNorm


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as patchify + one matmul.

    The weight is timm's conv kernel ``proj.weight`` (D, C, P, P); the
    matmul reads it as rows in (py, px, c) order, like the JAX package's
    Dense kernel."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")
        nh, nw = h // p, w // p
        x = x.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, nh * nw, p * p * c)
        d = self.proj.weight.shape[0]
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(d, p * p * c)
        dt = self.compute_dtype
        return F.linear(x.to(dt), wt.to(dt), self.proj.bias.to(dt))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = MultiHeadAttention(dim, num_heads, dtype, attention_impl)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class VisionTransformer(nn.Module):
    """Headless ViT returning pooled fp32 features (B, embed_dim). In
    training mode the drop-path masks come from ``generator``; the dropout
    rate is 0.0, as in the JAX package (``models/vit.py:84``). With
    ``remat`` each block is rematerialised in training
    (``layers.py::remat_block``), as JAX's ``nn.remat(ViTBlock)``."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 in_channels: int = 3, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, pool: str = "cls",
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", remat: bool = False):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.pool = pool
        self.compute_dtype = dtype
        self.remat = remat
        self.num_features = embed_dim
        n = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, in_channels, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        dpr = [drop_path_rate * i / max(1, depth - 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, dpr[i], dtype,
                     attention_impl) for i in range(depth))
        self.norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = run_blocks(self.blocks, x, generator, self.remat)
        x = self.norm(x)
        feats = x[:, 0] if self.pool == "cls" else x[:, 1:].mean(dim=1)
        return feats.float()


VIT_CONFIGS = {
    "tiny":  dict(embed_dim=192,  depth=12, num_heads=3),
    "small": dict(embed_dim=384,  depth=12, num_heads=6),
    "base":  dict(embed_dim=768,  depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "huge":  dict(embed_dim=1280, depth=32, num_heads=16),
}
