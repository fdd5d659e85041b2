"""ISICClassifier — backbone + metadata fusion + classifier, the current-
generation path of ``fedvit_tpu/models/isic.py`` (reference model.py:67-207).

    forward(images NHWC, metadata (B, 13) or None)
        → {"logits": (B, C) fp32, "features": (B, D) fp32}

With the metadata branch enabled and ``metadata=None``, the embedding is
zero-filled so the classifier's input width stays constant (reference
model.py:199-203). The old-generation segmentation branch, the learned
metadata embedding and the LayerNorm head are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from fedvit_torch.core.config import Config
from fedvit_torch.core.device import resolve_device
from fedvit_torch.models.heads import ClassifierHead
from fedvit_torch.models.layers import trunc_normal_
from fedvit_torch.models.metadata import MetadataBranch
from fedvit_torch.models.registry import DTYPES, build_backbone


class ISICClassifier(nn.Module):
    def __init__(self, backbone_name: str = "vit_base_patch16_224",
                 num_classes: int = 8, image_size: int = 224,
                 in_channels: int = 3, pretrained: bool = False,
                 drop_path_rate: float = 0.1, pool: str = "cls",
                 metadata_enabled: bool = True, metadata_style: str = "mlp",
                 meta_input_dim: int = 13, meta_hidden_dim: int = 256,
                 meta_output_dim: int = 128, meta_dropout: float = 0.4,
                 cls_hidden_dim: int = 512, cls_dropout: float = 0.5,
                 cls_layer_norm: bool = False, seg_enabled: bool = False,
                 compute_dtype: str = "bfloat16",
                 attention_impl: str = "auto"):
        super().__init__()
        if seg_enabled:
            raise NotImplementedError(
                "the old-generation segmentation branch is not yet ported")
        if metadata_enabled and metadata_style != "mlp":
            raise NotImplementedError(
                "MetadataEmbedding (metadata.style: embedding) is not yet ported")
        if cls_layer_norm:
            raise NotImplementedError(
                "the LayerNorm classifier head is not yet ported")
        dtype = DTYPES[compute_dtype]
        self.backbone, dim = build_backbone(
            backbone_name, image_size, in_channels, drop_path_rate, pool,
            compute_dtype, attention_impl, pretrained)
        self.meta_output_dim = meta_output_dim if metadata_enabled else 0
        if metadata_enabled:
            self.metadata_branch = MetadataBranch(
                meta_input_dim, meta_hidden_dim, meta_output_dim, meta_dropout,
                dtype)
        self.classifier = ClassifierHead(dim + self.meta_output_dim,
                                         num_classes, cls_hidden_dim,
                                         cls_dropout, dtype)

    def forward(self, x: torch.Tensor,
                metadata: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """In training mode (``model.train()``) every dropout and drop-path
        mask is drawn from ``generator``, a ``torch.Generator`` on the
        model's device; evaluation needs none."""
        features = self.backbone(x, generator)
        out = {"features": features}
        if self.meta_output_dim:
            if metadata is not None:
                meta = self.metadata_branch(metadata, generator)
            else:
                meta = features.new_zeros(features.shape[0],
                                          self.meta_output_dim)
            features = torch.cat([features, meta], dim=-1)
        out["logits"] = self.classifier(features, generator)
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: trunc-normal(0.02) weights for every linear map,
    the patch embedding, the cls token and the position embedding; zero
    biases; unit LayerNorm/BatchNorm scales; SwinV2's ``logit_scale`` log 10
    and its ``q_bias``/``v_bias`` zeros (the JAX package's init, except that
    flax's lecun-normal default for the metadata and CPB Dense layers is
    trunc-normal here too)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("cls_token", "pos_embed") or (
                    leaf == "weight" and p.dim() >= 2):
                trunc_normal_(p, generator)
            elif leaf in ("bias", "q_bias", "v_bias"):
                p.zero_()
            elif leaf == "logit_scale":
                p.fill_(math.log(10.0))
            else:
                p.fill_(1.0)
    return model


def build_model(cfg: Config, device: str = "cuda",
                generator: Optional[torch.Generator] = None) -> ISICClassifier:
    """ISICClassifier for ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``), in eval mode, with weights from ``generator`` (a CPU
    generator; default: seeded with ``cfg.seed``). in_channels = 4 iff
    data.use_segmentation_mask (reference model.py:302-324)."""
    dev = resolve_device(device)
    m = cfg.model
    if m.segmentation.enabled and cfg.loss.seg_weight > 0:
        raise NotImplementedError("old-generation JointLoss mode is not yet "
                                  "ported")
    model = ISICClassifier(
        backbone_name=m.backbone, num_classes=m.num_classes,
        image_size=m.image_size, in_channels=cfg.in_channels,
        pretrained=m.pretrained and not m.pretrained_path,
        drop_path_rate=m.drop_path_rate, pool=m.pool,
        metadata_enabled=m.metadata.enabled,
        metadata_style=m.metadata.style,
        meta_input_dim=m.metadata.input_dim,
        meta_hidden_dim=m.metadata.hidden_dim,
        meta_output_dim=m.metadata.output_dim,
        meta_dropout=m.metadata.dropout,
        cls_hidden_dim=m.classifier.hidden_dim,
        cls_dropout=m.classifier.dropout,
        cls_layer_norm=m.classifier.layer_norm,
        seg_enabled=m.segmentation.enabled,
        compute_dtype=m.compute_dtype, attention_impl=m.attention_impl)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    return init_weights(model, generator).to(dev).eval()
