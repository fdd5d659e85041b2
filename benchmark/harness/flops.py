"""Operation and byte counts from a configuration's shapes, and the H100's
peaks they are held against.

Operations count two per multiply-add of the products the model requires
(linear maps, patch embedding, attention scores and values, the SwinV2
position-bias MLP); elementwise work and normalisations are not counted. A
training step counts three forwards (forward, and the backward's two
products per forward product); recomputation is not counted.

The attention counts are those of one kernel call, as ``chip_smoke.py``
counted them beside each kernel check: each input byte read once and each
output byte written once, in bf16 (fp32 for the bias, mask, log-sum-exp and
the bias gradient).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _heads(arch: Dict, stage: int) -> int:
    h = arch["num_heads"]
    return h[stage] if isinstance(h, (list, tuple)) else h


def _head_flops(arch: Dict, feat: int) -> int:
    meta, head = arch["metadata"], arch["head"]
    return 2 * (meta["input_dim"] * meta["hidden_dim"]
                + meta["hidden_dim"] * meta["output_dim"]
                + (feat + meta["output_dim"]) * head["hidden_dim"]
                + head["hidden_dim"] * head["num_classes"])


def swin_stages(arch: Dict) -> List[Dict]:
    """Each SwinV2 stage: channels, side of the map, window (clamped to the
    map), heads, depth."""
    side = arch["image_size"] // arch["patch_size"]
    out = []
    for s, depth in enumerate(arch["depths"]):
        r = side // 2 ** s
        out.append({"c": arch["embed_dim"] * 2 ** s, "side": r,
                    "window": min(arch["window_size"], r),
                    "heads": _heads(arch, s), "depth": depth})
    return out


def forward_flops(arch: Dict, batch: int) -> int:
    """Operations of one forward of ``batch`` images."""
    cin, p = arch["in_chans"], arch["patch_size"]
    r = arch["mlp_ratio"]
    if arch["family"] == "vit":
        d = arch["embed_dim"]
        npatch = (arch["image_size"] // p) ** 2
        n = npatch + 1
        per_block = (2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d
                     + 2 * 2 * n * d * int(d * r))
        per_image = (2 * npatch * p * p * cin * d + arch["depth"] * per_block
                     + _head_flops(arch, d))
        return batch * per_image
    side = arch["image_size"] // p
    per_image = 2 * side * side * p * p * cin * arch["embed_dim"]
    per_forward = 0
    for s, st in enumerate(swin_stages(arch)):
        c, n, w = st["c"], st["side"] ** 2, st["window"]
        if s > 0:
            per_image += 2 * n * (2 * c) * c
        per_image += st["depth"] * (2 * n * c * 3 * c + 2 * 2 * n * w * w * c
                                    + 2 * n * c * c
                                    + 2 * 2 * n * c * int(c * r))
        table = (2 * w - 1) ** 2
        per_forward += st["depth"] * 2 * table * (2 * 512 + 512 * st["heads"])
    per_image += _head_flops(arch, arch["embed_dim"] * 2 ** (len(arch["depths"]) - 1))
    return batch * per_image + per_forward


def train_flops(arch: Dict, batch: int) -> int:
    return 3 * forward_flops(arch, batch)


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_calls(arch: Dict, batch: int, kind: str) -> List[Tuple[float, float]]:
    """(bytes, operations) of each attention kernel call in one forward
    (``kind`` ``serve`` or ``train_fwd``) or one backward (``train_bwd``) of
    ``batch`` images, block by block."""
    if kind not in ("serve", "train_fwd", "train_bwd"):
        raise ValueError(f"kind must be serve, train_fwd or train_bwd: {kind!r}")
    calls = []
    if arch["family"] == "vit":
        e, heads = arch["embed_dim"], arch["num_heads"]
        d = e // heads
        n = (arch["image_size"] // arch["patch_size"]) ** 2 + 1
        for _ in range(arch["depth"]):
            calls.append(vit_call(batch, n, e, heads, d, kind))
        return calls
    for s, st in enumerate(swin_stages(arch)):
        w, c, heads = st["window"], st["c"], st["heads"]
        rows = batch * (st["side"] // w) ** 2
        shifted_windows = (st["side"] // w) ** 2 if w < st["side"] else 0
        for b in range(st["depth"]):
            masked = shifted_windows if b % 2 == 1 else 0
            calls.append(window_call(rows, w * w, c, heads, masked, kind))
    return calls


def vit_call(b: int, n: int, e: int, heads: int, d: int, kind: str
             ) -> Tuple[float, float]:
    """K1 (serve), K2 (train_fwd) or K3 (train_bwd) on (b, n, 3e) qkv."""
    qkv, out, bias = b * n * 3 * e, b * n * e, 3 * e
    if kind == "train_bwd":
        return (2 * qkv + out + bias) * 2 + bias * 4, 10.0 * b * heads * n * n * d
    nbytes = (qkv + bias + out) * 2
    if kind == "train_fwd":
        nbytes += b * heads * n * 4
    return nbytes, 4.0 * b * heads * n * n * d


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


def attention_least_seconds(arch: Dict, batch: int, kinds) -> float:
    return sum(least_seconds(b, f) for k in kinds
               for b, f in attention_calls(arch, batch, k))
