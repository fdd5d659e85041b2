"""EVA-02 backbone (timm's ``Eva`` as its ``eva02_*_patch14_*`` models build
it; EVA-02, arXiv:2303.11331), with timm's parameter names. The JAX package
has no counterpart.

Pre-norm blocks without layer scale:

    x += drop_path(proj(attention(rope(q_proj(h)), rope(k_proj(h)), v_proj(h))))
                                                         with h = norm1(x)
    x += drop_path(fc2(mlp.norm(silu(fc1_g(h)) · fc1_x(h))))  with h = norm2(x)

q and v have a bias, k none. ``rope`` turns the head pairs of the patch
tokens by EVA-02's 2-D rotary angles (``ops/rotary.py``: the rotary kernel
on the card); the class token is not turned. The attention is K9
(``ops/attention.py::dot_product_attention_flat`` → ``flash_attention_flat``)
on the flat (B, N, E) q, k and v. The feature is the mean of the patch
tokens after the last block, then ``fc_norm``: no final ``norm`` and no
class-token feature. Every LayerNorm is ``ops/layer_norm.py::LayerNorm``
(eps 1e-6), ``mlp.norm`` over the SwiGLU's hidden width (2,730 for
EVA-02-L: the LayerNorm kernels' rows off 16 bytes).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedvit_torch.models.layers import Dense, DropPath, run_blocks
from fedvit_torch.models.vit import PatchEmbed
from fedvit_torch.ops.attention import dot_product_attention_flat
from fedvit_torch.ops.layer_norm import LayerNorm
from fedvit_torch.ops.rotary import rope_table, rotary_qk

# the ``model.attention_impl`` values: K9 (``auto`` on the card; ``pallas``
# and ``mega`` the kernel entry on any device), or the plain attention
# (``packed``, ``xla``), as SwinV2 takes them
EVA_ATTENTION_IMPLS = {"auto": "auto", "pallas": "pallas", "mega": "mega",
                       "packed": "xla", "xla": "xla"}


class EvaAttention(nn.Module):
    """Separate q, k and v projections (no k bias), q and k turned by the
    rotary table, attention on the flat (B, N, E) operands, then ``proj``."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        if attention_impl not in EVA_ATTENTION_IMPLS:
            raise ValueError(f"attention_impl={attention_impl!r} is not one of "
                             f"EVA-02's {tuple(EVA_ATTENTION_IMPLS)}")
        self.num_heads = num_heads
        self.impl = EVA_ATTENTION_IMPLS[attention_impl]
        self.q_proj = Dense(dim, dim, dtype)
        self.k_proj = Dense(dim, dim, dtype, bias=False)
        self.v_proj = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        q, k = rotary_qk(self.q_proj(x), self.k_proj(x), cos, sin)
        out = dot_product_attention_flat(q, k, self.v_proj(x), self.num_heads,
                                         impl=self.impl)
        return self.proj(out)


class SwiGLU(nn.Module):
    """timm's ``SwiGLU`` with its inner norm (EVA-02's ``scale_mlp``):
    fc2(norm(silu(fc1_g(x)) · fc1_x(x)))."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1_g = Dense(dim, hidden_dim, dtype)
        self.fc1_x = Dense(dim, hidden_dim, dtype)
        self.norm = LayerNorm(hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x)))


class EvaBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_hidden: int,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = EvaAttention(dim, num_heads, dtype, attention_impl)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = SwiGLU(dim, mlp_hidden, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator],
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x), cos, sin), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class Eva(nn.Module):
    """Headless EVA-02 returning pooled fp32 features (B, embed_dim), as
    ``VisionTransformer`` does. In training mode the drop-path masks come
    from ``generator``; with ``remat`` each block is rematerialised in
    training (``layers.py::run_blocks``). The rotary table of the
    ``image_size / patch_size`` grid, positions scaled to
    ``rope_ref_grid`` (the pretraining grid: 224 / 14 for every EVA-02), is
    a pair of non-persistent buffers: state dicts hold timm's parameters
    only."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 in_channels: int = 3, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_hidden: int = 2048,
                 rope_ref_grid: int = 16, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", remat: bool = False):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch_size}")
        grid = image_size // patch_size
        self.compute_dtype = dtype
        self.remat = remat
        self.num_features = embed_dim
        self.patch_embed = PatchEmbed(patch_size, in_channels, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim))
        cos, sin = rope_table(grid, embed_dim // num_heads, rope_ref_grid)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        dpr = [drop_path_rate * i / max(1, depth - 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            EvaBlock(embed_dim, num_heads, mlp_hidden, dpr[i], dtype,
                     attention_impl) for i in range(depth))
        self.fc_norm = LayerNorm(embed_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = run_blocks(self.blocks, x, generator, self.remat, self.rope_cos,
                       self.rope_sin)
        return self.fc_norm(x[:, 1:].mean(dim=1)).float()


# timm's eva02_{size}_patch14_* widths: SwiGLU hidden int(E · 4 · 2 / 3)
EVA_CONFIGS = {
    "tiny":  dict(embed_dim=192,  depth=12, num_heads=3,  mlp_hidden=512),
    "small": dict(embed_dim=384,  depth=12, num_heads=6,  mlp_hidden=1024),
    "base":  dict(embed_dim=768,  depth=12, num_heads=12, mlp_hidden=2048),
    "large": dict(embed_dim=1024, depth=24, num_heads=16, mlp_hidden=2730),
}
