"""Backbone registry — timm-style names → port backbones
(``fedvit_tpu/models/registry.py``):

  * "vit_{size}_patch{P}_{res}" (and deit names)        → VisionTransformer
  * "eva02_{tiny|small|base|large}_patch{P}_{res}[.tag]" → Eva (EVA-02:
    rotary q/k, separate q/k/v with no k bias, SwiGLU with its inner norm,
    the mean of the patch tokens then ``fc_norm``; ``models/eva.py``).
    base and large are timm's blocks (``qkv_fused=False``, ``scale_mlp``), so
    their checkpoints import (``models/import_weights.py``); tiny and small
    build the same block at their widths, for tests, and timm's own tiny
    and small checkpoints (a fused qkv, no inner norm) are not claimed
    importable. The JAX registry maps these names onto a plain ViT.
  * "swinv2_large_window12to24_192to384.ms_in22k_ft_in1k",
    "swin_small_patch4_window12_384", "swin(v2)_{size}_..._window{W}[to{W2}]"
                                                        → SwinTransformerV2

``pool`` is the ViT's alone: a SwinV2 and an EVA-02 pool the mean of their
tokens.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Tuple

import torch
from torch import nn

from fedvit_torch.models.eva import EVA_CONFIGS, Eva
from fedvit_torch.models.swin import SWIN_CONFIGS, SwinTransformerV2
from fedvit_torch.models.vit import VIT_CONFIGS, VisionTransformer

BACKBONE_SPECS: Dict[str, Dict[str, Any]] = {
    # explicit entries for exact reference config names
    "swinv2_large_window12to24_192to384.ms_in22k_ft_in1k": dict(
        family="swinv2", embed_dim=192, depths=(2, 2, 18, 2),
        num_heads=(6, 12, 24, 48), window_size=24,
        pretrained_window_sizes=(12, 12, 12, 6)),
    "swin_small_patch4_window12_384": dict(
        family="swin", embed_dim=96, depths=(2, 2, 18, 2),
        num_heads=(3, 6, 12, 24), window_size=12),
}

_VIT_RE = re.compile(
    r"^(vit|deit)_(tiny|small|base|large|huge)_patch(\d+)(?:_(\d+))?")
_EVA_RE = re.compile(r"^eva02_(tiny|small|base|large)_patch(\d+)(?:_(\d+))?")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def build_backbone(name: str, image_size: int, in_channels: int = 3,
                   drop_path_rate: float = 0.1, pool: str = "cls",
                   compute_dtype: str = "float32",
                   attention_impl: str = "auto",
                   pretrained: bool = False,
                   remat: bool = False) -> Tuple[nn.Module, int]:
    """Returns (module, num_features). ``remat`` rematerialises the
    transformer blocks in training."""
    if pretrained:
        warnings.warn(
            "pretrained=True: weights are not downloaded; initializing "
            "randomly. Load a converted state dict into the model instead.")
    m = _VIT_RE.match(name)
    if m:
        cfg = VIT_CONFIGS[m.group(2)]
        mod = VisionTransformer(
            image_size=image_size, patch_size=int(m.group(3)),
            in_channels=in_channels, drop_path_rate=drop_path_rate, pool=pool,
            dtype=DTYPES[compute_dtype], attention_impl=attention_impl,
            remat=remat, **cfg)
        return mod, cfg["embed_dim"]
    m = _EVA_RE.match(name)
    if m:
        cfg = EVA_CONFIGS[m.group(1)]
        mod = Eva(image_size=image_size, patch_size=int(m.group(2)),
                  in_channels=in_channels, drop_path_rate=drop_path_rate,
                  dtype=DTYPES[compute_dtype], attention_impl=attention_impl,
                  remat=remat, **cfg)
        return mod, cfg["embed_dim"]
    if name.startswith("swin"):
        spec = BACKBONE_SPECS.get(name)
        if spec is None:
            sm = re.match(r"^swin(?:v2)?_(tiny|small|base|large)", name)
            if not sm:
                raise ValueError(f"Unknown swin backbone: {name}")
            spec = dict(SWIN_CONFIGS[sm.group(1)])
            wm = re.search(r"window(\d+)(?:to(\d+))?", name)
            if wm:
                spec["window_size"] = int(wm.group(2) or wm.group(1))
        spec = {k: v for k, v in spec.items() if k != "family"}
        mod = SwinTransformerV2(
            image_size=image_size, in_channels=in_channels,
            drop_path_rate=drop_path_rate, dtype=DTYPES[compute_dtype],
            attention_impl=attention_impl, remat=remat, **spec)
        return mod, mod.num_features
    raise ValueError(f"Unknown backbone: {name}")
