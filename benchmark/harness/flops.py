"""Operation and byte counts from a configuration's shapes, and the H100's
peaks they are held against.

Operations count two per multiply-add of the products the model requires
(linear maps, patch embedding, attention scores and values, SwinV2's
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

from benchmark.harness import manifest

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _head_flops(arch: Dict, feat: int) -> int:
    meta, head = arch["metadata"], arch["head"]
    return 2 * (meta["input_dim"] * meta["hidden_dim"]
                + meta["hidden_dim"] * meta["output_dim"]
                + (feat + meta["output_dim"]) * head["hidden_dim"]
                + head["hidden_dim"] * head["num_classes"])


def forward_flops(arch: Dict, batch: int) -> int:
    """Operations of one forward of ``batch`` images: the family's backbone
    (``families/<family>.py``), the metadata MLP and the head."""
    fam = manifest.family_module(arch["family"])
    return fam.backbone_flops(arch, batch) \
        + batch * _head_flops(arch, fam.feature_dim(arch))


def train_flops(arch: Dict, batch: int) -> int:
    return 3 * forward_flops(arch, batch)


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_calls(arch: Dict, batch: int, kind: str) -> List[Tuple[float, float]]:
    """(bytes, operations) of each attention kernel call in one forward
    (``kind`` ``serve`` or ``train_fwd``) or one backward (``train_bwd``) of
    ``batch`` images, block by block, as the family counts them."""
    if kind not in ("serve", "train_fwd", "train_bwd"):
        raise ValueError(f"kind must be serve, train_fwd or train_bwd: {kind!r}")
    return manifest.family_module(arch["family"]).attention_calls(
        arch, batch, kind)


def attention_least_seconds(arch: Dict, batch: int, kinds) -> float:
    return sum(least_seconds(b, f) for k in kinds
               for b, f in attention_calls(arch, batch, k))
