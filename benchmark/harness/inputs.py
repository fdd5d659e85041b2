"""Inputs made from ``--seed``: weights, canvases, labels and metadata.

Every input is a function of the seed and the cell's files alone, so the
program and the reference are handed the same ones and a seed gives the same
run. Sizes never depend on the seed: every seed makes the same number of
canvases of the same size and the same count of each class, in another
order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, *tags: int) -> int:
    """A 62-bit seed for one purpose of a run, from ``--seed`` and the
    purpose's tags."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(2))


# purposes of the seed
WEIGHTS, CANVASES, LABELS, METADATA, STATE, PLAN, AUGMENT, SAMPLE = range(8)


def leaf_scale(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(offset, std) of a weight's values: linear, convolution and position
    maps N(0, 1/fan_in); the class token and position embedding N(0, 0.02²);
    SwinV2's logit scale log 10 + N(0, 0.1²); norm scales 1 + N(0, 0.1²);
    biases N(0, 0.1²)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("cls_token", "pos_embed"):
        return 0.0, 0.02
    if leaf == "logit_scale":
        return math.log(10.0), 0.1
    if leaf == "weight" and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "weight":
        return 1.0, 0.1
    return 0.0, 0.1


def make_weights(spec: List[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``spec`` in fp32 on ``device``, from one draw of
    normal values by a generator on the device."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        off, std = leaf_scale(name, shape)
        out[name] = flat[at:at + n].view(shape).mul_(std).add_(off)
        at += n
    return out


def running_stats(spec: List[Tuple[str, Tuple[int, ...]]], device
                  ) -> Dict[str, torch.Tensor]:
    """The metadata BatchNorms' running statistics: mean 0, variance 1."""
    out = {}
    for name, shape in spec:
        if name.startswith("metadata_branch.net.") and name.endswith(".weight") \
                and len(shape) == 1:
            base = name[:-len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{base}.running_var"] = torch.ones(shape, device=device)
    return out


def make_canvases(n: int, side: int, seed: int, device, channels: int = 4,
                  first: Optional[int] = None, chunk: int = 256
                  ) -> torch.Tensor:
    """(n, side, side, channels) uint8 dermoscopy-like canvases, made on the
    device from the seed, ``chunk`` canvases a pass: skin of a tone drawn
    for each canvas under smooth low-frequency shading, one darker lesion
    (an ellipse of drawn centre, radii and angle whose rim is bent by two
    angular harmonics, a soft edge and a texture of its own), sensor grain;
    the 4th channel is the lesion's mask, 0 or 255. Pixel values crowd into
    few intensity bins, as a real image's do. ``first``: only the first
    canvases of the ``n``, with the same values."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, CANVASES))
    keep = n if first is None else min(first, n)
    out = torch.empty((keep, side, side, channels), dtype=torch.uint8,
                      device=device)
    ax = (torch.arange(side, device=device, dtype=torch.float32) + 0.5
          ) * (2.0 / side) - 1.0
    yy, xx = ax.view(1, side, 1), ax.view(1, 1, side)
    for a in range(0, keep, chunk):
        m = min(n, a + chunk) - a
        u = torch.rand((m, 14), generator=g, device=device)
        shade = torch.rand((m, 4, 6, 6), generator=g, device=device)
        grain = torch.randn((m, side, side, 3), generator=g, device=device)
        col = lambda i: u[:, i].view(m, 1, 1)  # noqa: E731
        skin = torch.stack([150.0 + 80.0 * u[:, 0],
                            (0.68 + 0.12 * u[:, 1]) * (150.0 + 80.0 * u[:, 0]),
                            (0.55 + 0.15 * u[:, 2]) * (150.0 + 80.0 * u[:, 0])],
                           dim=1)
        dark = 0.3 + 0.3 * u[:, 3]
        lesion = skin * torch.stack([dark, dark * (0.75 + 0.15 * u[:, 4]),
                                     dark * (0.7 + 0.2 * u[:, 5])], dim=1)
        dx, dy = xx - 0.6 * (col(6) - 0.5), yy - 0.6 * (col(7) - 0.5)
        rx = 0.35 + 0.4 * col(8)
        ry = rx * (0.65 + 0.35 * col(9))
        cos, sin = torch.cos(torch.pi * col(10)), torch.sin(torch.pi * col(10))
        px, py = dx * cos + dy * sin, dy * cos - dx * sin
        phi = torch.atan2(py, px)
        rim = 1.0 + 0.15 * col(11) * torch.cos(3.0 * phi + 6.2832 * col(12)) \
            + 0.08 * col(13) * torch.cos(5.0 * phi)
        d = torch.sqrt((px / rx) ** 2 + (py / ry) ** 2) - rim
        inside = torch.sigmoid(-d / 0.04).unsqueeze(-1)          # (m, s, s, 1)
        field = F.interpolate(shade, size=(side, side), mode="bicubic",
                              align_corners=False).permute(0, 2, 3, 1)
        img = skin.view(m, 1, 1, 3) * (1.0 - inside) \
            + lesion.view(m, 1, 1, 3) * inside \
            + 40.0 * (field[..., :1] - 0.5) \
            + 10.0 * (field[..., :3] - field[..., 1:2]) \
            + 40.0 * (field[..., 3:] - 0.5) * inside + 3.0 * grain
        k = min(m, keep - a)
        out[a:a + k, ..., :3] = img[:k].round_().clamp_(0, 255).to(torch.uint8)
        if channels > 3:
            out[a:a + k, ..., 3] = (d[:k] < 0).to(torch.uint8) * 255
    return out


def make_labels(n: int, class_counts: Sequence[int], seed: int) -> np.ndarray:
    """``n`` labels whose class shares are those of ``class_counts``
    (largest remainder), in an order drawn from the seed."""
    counts = np.asarray(class_counts, np.float64)
    want = counts / counts.sum() * n
    got = np.floor(want).astype(np.int64)
    rest = np.argsort(-(want - got), kind="stable")[:n - got.sum()]
    got[rest] += 1
    labels = np.repeat(np.arange(len(counts)), got).astype(np.int32)
    return np.random.default_rng(sub_seed(seed, LABELS)).permutation(labels)


def make_metadata(n: int, seed: int, sexes: int = 3, sites: int = 9
                  ) -> np.ndarray:
    """(n, 13) float32: age in [0, 1], then one-hot sex and anatomical site."""
    rng = np.random.default_rng(sub_seed(seed, METADATA))
    out = np.zeros((n, 1 + sexes + sites), np.float32)
    out[:, 0] = rng.random(n, dtype=np.float32)
    out[np.arange(n), 1 + rng.integers(0, sexes, n)] = 1.0
    out[np.arange(n), 1 + sexes + rng.integers(0, sites, n)] = 1.0
    return out
