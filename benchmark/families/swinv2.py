"""SwinV2, in timm's ``swinv2_large_window12to24_192to384`` layout: a
normed patch embedding, stages of post-norm blocks of scaled cosine
attention over (shifted) windows with a log-spaced continuous position bias,
a 2×2 patch merging between stages, the mean of the last map after the last
norm as the feature.

Everything the harness knows of one architecture, found by the
configuration's ``model.family`` (``harness/manifest.py``): the backbone's
parameters, its reference forward, its operation counts and the names of
the program's attention kernels that run it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from benchmark.reference.models import (Params, Precision, drop,
                                        drop_path_rates, layer_norm, linear,
                                        linear_spec, mlp, norm_spec,
                                        patch_embed)

# the tiny size of the harness's CPU tests: the configuration it cuts, the
# program's backbone at that size, the image and canvas sides, the sizes
TINY = {"config": "swinv2-large-384", "backbone": "swinv2_tiny_window8_64",
        "image_size": 64, "canvas": 80,
        "model": {"embed_dim": 96, "depths": [2, 2, 6, 2],
                  "num_heads": [3, 6, 12, 24], "window_size": 8,
                  "pretrained_window_sizes": [0, 0, 0, 0]}}

# the program's attention kernels, by the regular expressions their device
# names match: K5's log-sum-exp entry and K6 in training, K5 in serving
ATTENTION_KERNELS = {
    "train": (r"window_mma_fwd_kernel<true, false, ",
              r"(?<!attn_bwd::)\b(delta|dkdv_mma|dq_mma|dbias_mma)_kernel\b"),
    "serve": (r"window_mma_fwd_kernel<false, false, ",),
}

# a drop-path mask's shape after the batch: one per image over (H, W, C)
DROP_PATH_SHAPE = (1, 1, 1)


def _heads(arch: Dict, stage: int) -> int:
    h = arch["num_heads"]
    return h[stage] if isinstance(h, (list, tuple)) else h


def feature_dim(arch: Dict) -> int:
    return arch["embed_dim"] * 2 ** (len(arch["depths"]) - 1)


def block_names(arch: Dict) -> List[str]:
    return [f"backbone.layers.{s}.blocks.{b}"
            for s, d in enumerate(arch["depths"]) for b in range(d)]


def backbone_spec(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    cin, patch, d0 = arch["in_chans"], arch["patch_size"], arch["embed_dim"]
    r = arch["mlp_ratio"]
    spec = [("backbone.patch_embed.proj.weight", (d0, cin, patch, patch)),
            ("backbone.patch_embed.proj.bias", (d0,))]
    spec += norm_spec("backbone.patch_embed.norm", d0)
    for s, depth in enumerate(arch["depths"]):
        c = d0 * 2 ** s
        if s > 0:
            spec += linear_spec(f"backbone.layers.{s}.downsample.reduction",
                                2 * c, c, bias=False)
            spec += norm_spec(f"backbone.layers.{s}.downsample.norm", c)
        for b in range(depth):
            blk = f"backbone.layers.{s}.blocks.{b}"
            heads = _heads(arch, s)
            spec.append((f"{blk}.attn.q_bias", (c,)))
            spec.append((f"{blk}.attn.v_bias", (c,)))
            spec.append((f"{blk}.attn.logit_scale", (heads, 1, 1)))
            spec += linear_spec(f"{blk}.attn.qkv", c, 3 * c, bias=False)
            spec += linear_spec(f"{blk}.attn.cpb_mlp.0", 2, 512)
            spec += linear_spec(f"{blk}.attn.cpb_mlp.2", 512, heads, bias=False)
            spec += linear_spec(f"{blk}.attn.proj", c, c)
            spec += norm_spec(f"{blk}.norm1", c)
            spec += linear_spec(f"{blk}.mlp.fc1", c, int(c * r))
            spec += linear_spec(f"{blk}.mlp.fc2", int(c * r), c)
            spec += norm_spec(f"{blk}.norm2", c)
    return spec + norm_spec("backbone.norm", feature_dim(arch))


def relative_coords_table(window: int, pretrained_window: int) -> torch.Tensor:
    """SwinV2's log-spaced coordinate table (2w−1, 2w−1, 2), the deltas
    normalised by the pretrained window's extent minus one."""
    r = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    table = table / max((pretrained_window or window) - 1, 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return torch.from_numpy(table.astype(np.float32))


def relative_position_index(window: int) -> torch.Tensor:
    """(w², w²) index into the flattened table of query − key offsets."""
    ys, xs = np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return torch.from_numpy(dy * (2 * window - 1) + dx)


def shift_mask(h: int, w: int, window: int, shift: int) -> Optional[torch.Tensor]:
    """(nW, w², w²) additive mask: −100 between tokens of different regions
    of the cyclically shifted map, None without a shift."""
    if shift == 0:
        return None
    region = torch.zeros(h, w)
    cuts = ((0, h - window), (h - window, h - shift), (h - shift, h))
    cuts_w = ((0, w - window), (w - window, w - shift), (w - shift, w))
    label = 0
    for y0, y1 in cuts:
        for x0, x1 in cuts_w:
            region[y0:y1, x0:x1] = label
            label += 1
    win = region.reshape(h // window, window, w // window, window)
    win = win.permute(0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(win[:, :, None] != win[:, None, :], -100.0, 0.0)


def attention(x: torch.Tensor, p: Params, name: str, heads: int,
              window: int, pretrained_window: int,
              mask: Optional[torch.Tensor], prec: Precision,
              chunk: int) -> torch.Tensor:
    """Scaled cosine attention over windows: x (windows, n, C)."""
    rows, n, c = x.shape
    d = c // heads
    bias = torch.cat([p[f"{name}.q_bias"], torch.zeros_like(p[f"{name}.q_bias"]),
                      p[f"{name}.v_bias"]])
    qkv = linear(x, p[f"{name}.qkv.weight"], bias, prec)
    q, k, v = qkv.reshape(rows, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    table = relative_coords_table(window, pretrained_window).to(x.device)
    hid = F.relu(linear(table, p[f"{name}.cpb_mlp.0.weight"],
                        p[f"{name}.cpb_mlp.0.bias"], prec))
    cpb = linear(hid, p[f"{name}.cpb_mlp.2.weight"], None, prec)
    idx = relative_position_index(window).to(x.device).reshape(-1)
    rel = cpb.reshape(-1, heads)[idx].reshape(n, n, heads).permute(2, 0, 1)
    rel = 16.0 * torch.sigmoid(rel)
    scale = torch.exp(torch.clamp(p[f"{name}.logit_scale"], max=math.log(100.0)))
    qn = F.normalize(q, dim=-1)
    kn = F.normalize(k, dim=-1)
    outs = []
    for s in range(0, rows, chunk):          # windows of ``chunk`` at a time
        e = min(rows, s + chunk)
        att = prec.out(prec(qn[s:e]) @ prec(kn[s:e]).transpose(-2, -1)) * scale + rel
        if mask is not None:
            nw = mask.shape[0]
            att = att + mask[torch.arange(s, e, device=x.device) % nw][:, None]
        outs.append(prec.out(prec(torch.softmax(att, -1)) @ prec(v[s:e])))
    out = torch.cat(outs).transpose(1, 2).reshape(rows, n, c)
    return linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], prec)


def windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, w², C), the windows of each image together."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def unwindows(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def features(img: torch.Tensor, p: Params, arch: Dict,
             masks: Dict[str, Optional[torch.Tensor]], prec: Precision,
             remat: bool, chunk: int = 64) -> torch.Tensor:
    eps = arch["ln_eps"]
    x = patch_embed(img, p, "backbone.patch_embed", arch["patch_size"], prec)
    x = layer_norm(x, p, "backbone.patch_embed.norm", eps)
    rates = iter(drop_path_rates(arch))
    for s, depth in enumerate(arch["depths"]):
        if s > 0:                 # 2×2 merge: chunks (0,0), (1,0), (0,1), (1,1)
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
            x = x.reshape(b, h // 2, w // 2, 4 * c)
            name = f"backbone.layers.{s}.downsample"
            x = linear(x, p[f"{name}.reduction.weight"], None, prec)
            x = layer_norm(x, p, f"{name}.norm", eps)
        _, h, w, _ = x.shape
        window = arch["window_size"]
        clamp = window >= min(h, w)
        window = min(h, w) if clamp else window
        heads = _heads(arch, s)
        pw = arch["pretrained_window_sizes"][s]
        for b_i in range(depth):
            blk = f"backbone.layers.{s}.blocks.{b_i}"
            shift = 0 if (clamp or b_i % 2 == 0) else window // 2
            mask = shift_mask(h, w, window, shift)
            mask = None if mask is None else mask.to(x.device)
            rate = next(rates)

            def block(x, blk=blk, shift=shift, mask=mask, rate=rate,
                      window=window, heads=heads, pw=pw, h=h, w=w):
                keep = 1.0 - rate
                y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
                y = attention(windows(y, window), p, f"{blk}.attn", heads,
                              window, pw, mask, prec, chunk)
                y = unwindows(y, window, h, w)
                if shift:
                    y = torch.roll(y, (shift, shift), (1, 2))
                x = x + drop(layer_norm(y, p, f"{blk}.norm1", eps),
                             masks.get(f"{blk}.attn"), keep)
                y = layer_norm(mlp(x, p, f"{blk}.mlp", prec), p,
                               f"{blk}.norm2", eps)
                return x + drop(y, masks.get(f"{blk}.mlp"), keep)
            x = checkpoint.checkpoint(block, x, use_reentrant=False) if remat \
                else block(x)
    x = layer_norm(x, p, "backbone.norm", eps)
    return x.reshape(x.shape[0], -1, x.shape[-1]).mean(1)


def stages(arch: Dict) -> List[Dict]:
    """Each stage: channels, side of the map, window (clamped to the map),
    heads, depth."""
    side = arch["image_size"] // arch["patch_size"]
    out = []
    for s, depth in enumerate(arch["depths"]):
        r = side // 2 ** s
        out.append({"c": arch["embed_dim"] * 2 ** s, "side": r,
                    "window": min(arch["window_size"], r),
                    "heads": _heads(arch, s), "depth": depth})
    return out


def backbone_flops(arch: Dict, batch: int) -> int:
    """Operations of one backbone forward of ``batch`` images; the position
    bias MLP runs once a forward, whatever the batch."""
    cin, p = arch["in_chans"], arch["patch_size"]
    r = arch["mlp_ratio"]
    side = arch["image_size"] // p
    per_image = 2 * side * side * p * p * cin * arch["embed_dim"]
    per_forward = 0
    for s, st in enumerate(stages(arch)):
        c, n, w = st["c"], st["side"] ** 2, st["window"]
        if s > 0:
            per_image += 2 * n * (2 * c) * c
        per_image += st["depth"] * (2 * n * c * 3 * c + 2 * 2 * n * w * w * c
                                    + 2 * n * c * c
                                    + 2 * 2 * n * c * int(c * r))
        table = (2 * w - 1) ** 2
        per_forward += st["depth"] * 2 * table * (2 * 512 + 512 * st["heads"])
    return batch * per_image + per_forward


def attention_calls(arch: Dict, batch: int, kind: str
                    ) -> List[Tuple[float, float]]:
    calls = []
    for st in stages(arch):
        w, c, heads = st["window"], st["c"], st["heads"]
        rows = batch * (st["side"] // w) ** 2
        shifted_windows = (st["side"] // w) ** 2 if w < st["side"] else 0
        for b in range(st["depth"]):
            masked = shifted_windows if b % 2 == 1 else 0
            calls.append(window_call(rows, w * w, c, heads, masked, kind))
    return calls


def window_call(rows: int, n: int, c: int, heads: int, masked_windows: int,
                kind: str) -> Tuple[float, float]:
    """K5 (serve), its log-sum-exp entry (train_fwd) or K6 (train_bwd) on
    ``rows`` windows of ``n`` tokens of width ``c``; ``masked_windows`` the
    shift mask's windows (0 without a shift)."""
    q = rows * n * c
    d = c // heads
    extra = (heads * n * n + masked_windows * n * n) * 4
    if kind == "train_bwd":
        return 7 * q * 2 + extra + heads * n * n * 4, 10.0 * rows * heads * n * n * d
    nbytes = 4 * q * 2 + extra
    if kind == "train_fwd":
        nbytes += rows * heads * n * 4
    return nbytes, 4.0 * rows * heads * n * n * d
