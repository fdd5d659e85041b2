"""SwinV2 backbone — the counterpart of ``fedvit_tpu/models/swin.py``, with
timm's ``SwinTransformerV2`` parameter names.

SwinV2 specifics (Liu et al. 2022, timm semantics), as in the JAX package:
post-norm blocks; scaled cosine attention with a learned per-head logit scale
clamped at log 100 and folded into q; the continuous log-spaced
relative-position bias (an MLP 2 → 512 → heads over the coordinate table,
16·sigmoid, the table normalised by the *pretrained* window); shifted windows
with the static cross-boundary mask; PatchMerging v2 (reduction, then norm);
a window that clamps to the stage's resolution.

Layout: tokens stay (B, H, W, C) between blocks; the window partition is
window-major, (nW·B, w², C) with the rows of one window contiguous, which is
what ``flash_attention_bias_flat`` takes: on a CUDA tensor the hand-written
kernels (K5; under grad its log-sum-exp entry and the backward K6), on a CPU
tensor their plain version. The bias (H, n, n) and the shift mask (nW, n, n)
go to it as separate inputs; the bias's gradient reaches ``cpb_mlp`` through
the sliding windows of ``expand_bias_table``.

Two things differ from the JAX module tree, both to keep timm's names and
weight layouts: the patch merging sits at the start of stage s+1
(``layers.{s+1}.downsample``), not at the end of stage s, and gathers its four
pixel chunks in timm's order. The coordinate table and the shift mask are made
at construction from ``image_size`` and are buffers that the state dict leaves
out.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedvit_torch.models.layers import Dense, DropPath, Mlp, run_blocks
from fedvit_torch.models.vit import PatchEmbed
from fedvit_torch.ops.attention import windowed_attention_flat
from fedvit_torch.ops.flash_attention import flash_attention_bias_flat
from fedvit_torch.ops.layer_norm import LayerNorm

LN_EPS = 1e-5
# the SwinV2's ``model.attention_impl`` values: JAX maps ``pallas`` and
# ``mega`` to the windowed kernel (``fedvit_tpu/ops/attention.py:162-167``),
# K5/K6 here; ``packed`` and ``xla`` fall to its XLA branch, the plain
# ``windowed_attention_flat`` here (no kernel)
SWIN_ATTENTION_IMPLS = ("auto", "pallas", "mega", "packed", "xla")
PLAIN_IMPLS = ("packed", "xla")


# ---------------------------------------------------------------------------
# Window helpers
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, w: int, major: bool = False
                     ) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, w², C) (batch-major) or (nW·B, w², C)
    (window-major, ``major=True``: the rows of one window contiguous)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    x = x.permute((1, 3, 0, 2, 4, 5) if major else (0, 1, 3, 2, 4, 5))
    return x.reshape(-1, w * w, c)


def window_unpartition(x: torch.Tensor, w: int, h: int, wd: int,
                       major: bool = False) -> torch.Tensor:
    """Inverse of ``window_partition``."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (wd // w))
    if major:
        x = x.reshape(h // w, wd // w, b, w, w, c).permute(2, 0, 3, 1, 4, 5)
    else:
        x = x.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def relative_coords_table(window: int, pretrained_window: int = 0
                          ) -> np.ndarray:
    """SwinV2 log-spaced CPB input table (1, 2w−1, 2w−1, 2), float64 then
    float32."""
    rh = np.arange(-(window - 1), window, dtype=np.float64)
    rw = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij"), axis=-1)[None]
    denom = (pretrained_window - 1) if pretrained_window > 0 else (window - 1)
    denom = max(denom, 1)
    table = table / denom
    table = table * 8
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.astype(np.float32)


def relative_position_index(window: int) -> np.ndarray:
    """(w², w²) indices into the flattened (2w−1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))          # (2, w, w)
    flat = coords.reshape(2, -1)                           # (2, w²)
    rel = flat[:, :, None] - flat[:, None, :]              # (2, w², w²)
    rel = rel.transpose(1, 2, 0)
    rel[..., 0] += window - 1
    rel[..., 1] += window - 1
    rel[..., 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int32)                    # (w², w²)


def expand_bias_table(table: torch.Tensor, window: int) -> torch.Tensor:
    """(2w−1, 2w−1, H) bias table → (H, w², w²) per-pair bias, the values of
    ``table.reshape(-1, H)[relative_position_index(w)]`` with the heads moved
    first: entry (query (yi, xi), key (yj, xj)) is
    ``table[yi − yj + w − 1, xi − xj + w − 1]``.

    Built from sliding windows over the flipped table, not from an index
    gather (the JAX function, too, builds it from static slices): under grad a
    gather's backward is a scatter-add of H·w⁴ values over repeated indices,
    which PyTorch sorts first, a millisecond a block on the card; a sliding
    window's backward sums each table cell's w² uses in one order."""
    heads = table.shape[-1]
    n = window * window
    flipped = table.permute(2, 0, 1).flip((1, 2))          # (H, 2w−1, 2w−1)
    # [h, s, t, yj, xj] = flipped[h, s + yj, t + xj], with s = w − 1 − yi
    pairs = flipped.unfold(1, window, 1).unfold(2, window, 1)
    return pairs.flip((1, 2)).reshape(heads, n, n)


def shift_attention_mask(h: int, w: int, window: int, shift: int
                         ) -> Optional[np.ndarray]:
    """Additive (nW, w², w²) mask for shifted windows (−100 across region
    boundaries), or None for shift 0."""
    if shift == 0:
        return None
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    x = img.reshape(1, h // window, window, w // window, window, 1)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = x[:, None, :] - x[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class WindowAttentionV2(nn.Module):
    """Scaled-cosine window attention with the continuous relative-position
    bias. ``forward`` takes (nW·B, w², C) window-major rows and the static
    (nW, w², w²) mask or None.

    ``attention_impl`` ``auto``, ``pallas`` and ``mega`` take
    ``flash_attention_bias_flat`` (K5, and under grad K5's log-sum-exp entry
    and K6, on a CUDA tensor); ``packed`` and ``xla`` the plain
    ``ops/attention.py::windowed_attention_flat`` on the same normalised q,
    k, v, bias and mask, JAX's XLA branch, on any device. That branch holds
    all (nW, B, H, w², w²) scores in fp32 in device memory, where the
    kernels keep a tile of them in registers."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 pretrained_window: int = 0,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        if attention_impl not in SWIN_ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl={attention_impl!r} is not one of the "
                f"SwinV2's {SWIN_ATTENTION_IMPLS}")
        self.plain = attention_impl in PLAIN_IMPLS
        self.num_heads = num_heads
        self.window = window
        self.compute_dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        # SwinV2 has a q and a v bias but no k bias
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.proj = Dense(dim, dim, dtype)
        self.register_buffer(
            "relative_coords_table",
            torch.from_numpy(relative_coords_table(window, pretrained_window)),
            persistent=False)

    def relative_position_bias(self) -> torch.Tensor:
        """(H, w², w²) fp32: 16·sigmoid of the CPB MLP over the coordinate
        table, in fp32 whatever the compute dtype."""
        cpb = self.cpb_mlp(self.relative_coords_table)     # (1, 2w−1, 2w−1, H)
        return expand_bias_table(16.0 * torch.sigmoid(cpb[0]), self.window)

    def _inv_norm(self, t: torch.Tensor,
                  head_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """1 / max(‖t_h‖, 1e-6) per head (times ``head_scale``), from a sum of
        squares in fp32, cast to t's dtype: (rows, n, H, 1)."""
        ss = t.float().square().sum(-1)
        inv = 1.0 / torch.clamp(torch.sqrt(ss), min=1e-6)
        if head_scale is not None:
            inv = inv * head_scale.reshape(1, 1, -1)
        return inv.to(t.dtype).unsqueeze(-1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows, n, c = x.shape
        h = self.num_heads
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt))
        q = (qkv[..., :c] + self.q_bias.to(dt)).reshape(rows, n, h, c // h)
        k = qkv[..., c:2 * c].reshape(rows, n, h, c // h)
        v = qkv[..., 2 * c:] + self.v_bias.to(dt)
        # cosine attention, with the learned per-head scale folded into q; the
        # multiply runs in the compute dtype
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        qn = (q * self._inv_norm(q, scale)).reshape(rows, n, c)
        kn = (k * self._inv_norm(k)).reshape(rows, n, c)
        attend = (windowed_attention_flat if self.plain
                  else flash_attention_bias_flat)
        out = attend(qn.contiguous(), kn.contiguous(), v.contiguous(),
                     self.relative_position_bias(), mask, h)
        return self.proj(out)


class SwinBlockV2(nn.Module):
    """Post-norm SwinV2 block on a (B, h, w, C) map of the resolution given
    at construction. A window that covers the map is clamped to it and loses
    its shift."""

    def __init__(self, dim: int, resolution: Tuple[int, int], num_heads: int,
                 window: int, shift: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, pretrained_window: int = 0,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        h, w = resolution
        if window >= min(h, w):
            window, shift = min(h, w), 0
        if h % window or w % window:
            raise ValueError(f"feature map {h}x{w} not divisible by window "
                             f"{window}")
        self.resolution = (h, w)
        self.window = window
        self.shift = shift
        self.attn = WindowAttentionV2(dim, num_heads, window, pretrained_window,
                                      dtype, attention_impl)
        self.norm1 = LayerNorm(dim, LN_EPS, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype)
        self.drop_path = DropPath(drop_path)
        mask = shift_attention_mask(h, w, window, shift)
        self.register_buffer(
            "attn_mask", None if mask is None else torch.from_numpy(mask),
            persistent=False)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        if (h, w) != self.resolution:
            raise ValueError(f"feature map {h}x{w}, built for "
                             f"{self.resolution[0]}x{self.resolution[1]}")
        win, shift = self.window, self.shift
        shortcut = x
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = self.attn(window_partition(x, win, major=True), self.attn_mask)
        x = window_unpartition(xw, win, h, w, major=True)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(self.norm1(x), generator)
        return x + self.drop_path(self.norm2(self.mlp(x)), generator)


class PatchMergingV2(nn.Module):
    """2×2 space-to-depth, Linear(4C → 2C) without bias, then norm. The four
    pixel chunks are laid out in timm's order, (0,0), (1,0), (0,1), (1,1) as
    (row, column) offsets, which is the layout of timm's ``reduction.weight``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim, LN_EPS, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        dt = self.compute_dtype
        y = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        y = y.reshape(b, h // 2, w // 2, 4 * c)
        return self.norm(F.linear(y.to(dt), self.reduction.weight.to(dt)))


class SwinStage(nn.Module):
    """One resolution stage: the optional downsample (timm puts the patch
    merging at the start of the stage it feeds), then ``depth`` blocks, each
    rematerialised in training with ``remat`` (JAX's
    ``nn.remat(SwinBlockV2)``; the patch merging is not). ``resolution`` is
    the map the blocks see."""

    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int,
                 num_heads: int, window: int, mlp_ratio: float,
                 drop_paths: Tuple[float, ...], pretrained_window: int,
                 downsample: bool, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", remat: bool = False):
        super().__init__()
        self.remat = remat
        self.downsample = PatchMergingV2(dim // 2, dtype) if downsample else None
        self.blocks = nn.ModuleList(
            SwinBlockV2(dim, resolution, num_heads, window,
                        0 if blk % 2 == 0 else window // 2, mlp_ratio,
                        drop_paths[blk], pretrained_window, dtype,
                        attention_impl) for blk in range(depth))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        return run_blocks(self.blocks, x, generator, self.remat)


class SwinPatchEmbed(PatchEmbed):
    """4×4 patch embedding and its norm, returning the (B, h, w, D) map."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, in_channels, embed_dim, dtype)
        self.norm = LayerNorm(embed_dim, LN_EPS, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        return self.norm(super().forward(x)).reshape(b, h // p, w // p, -1)


class SwinTransformerV2(nn.Module):
    """Headless SwinV2 returning mean-pooled fp32 features
    (B, embed_dim · 2^(stages−1)) from (B, image_size, image_size, C) images.
    In training mode the drop-path masks come from ``generator``; with
    ``remat`` every block is rematerialised (``SwinStage``)."""

    def __init__(self, image_size: int = 384, patch_size: int = 4,
                 in_channels: int = 3, embed_dim: int = 192,
                 depths: Tuple[int, ...] = (2, 2, 18, 2),
                 num_heads: Tuple[int, ...] = (6, 12, 24, 48),
                 window_size: int = 24,
                 pretrained_window_sizes: Tuple[int, ...] = (0, 0, 0, 0),
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", remat: bool = False):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch_size}")
        self.compute_dtype = dtype
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.patch_embed = SwinPatchEmbed(patch_size, in_channels, embed_dim,
                                          dtype)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(1, total - 1) for i in range(total)]
        side = image_size // patch_size
        stages, di = [], 0
        for s, depth in enumerate(depths):
            stages.append(SwinStage(
                embed_dim * 2 ** s, (side // 2 ** s, side // 2 ** s), depth,
                num_heads[s], window_size, mlp_ratio,
                tuple(dpr[di:di + depth]), pretrained_window_sizes[s],
                downsample=s > 0, dtype=dtype, attention_impl=attention_impl,
                remat=remat))
            di += depth
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNorm(self.num_features, LN_EPS, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x.to(self.compute_dtype))
        for stage in self.layers:
            x = stage(x, generator)
        x = self.norm(x)
        return x.reshape(x.shape[0], -1, x.shape[-1]).mean(dim=1).float()


SWIN_CONFIGS = {
    "tiny":  dict(embed_dim=96,  depths=(2, 2, 6, 2),
                  num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96,  depths=(2, 2, 18, 2),
                  num_heads=(3, 6, 12, 24)),
    "base":  dict(embed_dim=128, depths=(2, 2, 18, 2),
                  num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2),
                  num_heads=(6, 12, 24, 48)),
}
