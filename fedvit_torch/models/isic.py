"""ISICClassifier — backbone + metadata fusion + classifier, with the old
generation's segmentation branch and fusion (the HybridViT) as options, as
``fedvit_tpu/models/isic.py`` (reference model.py:67-207, model_old.py:
119-287).

    forward(images NHWC, metadata (B, 13) or None, metadata_raw=None)
        → {"logits": (B, C) fp32, "features": (B, D) fp32
           [, "seg_mask": (B, H, W, 1) fp32 logits]}

With the metadata branch enabled and no metadata for it (``metadata`` for
the MLP, ``metadata_raw`` {"age", "sex", "site"} for ``metadata.style:
embedding``), the embedding is zero-filled so the classifier's input width
stays constant (reference model.py:199-203). No entry point passes
``metadata_raw``, so the embedding style trains and serves with a zero
embedding, as in the JAX package, whose variable tree then holds no
``metadata_branch`` at all.

With ``seg_enabled`` the Attention U-Net (``models/unet.py``) runs on the same
input and ``models/fusion.py`` merges its last decoder map into the pooled
backbone features. With ``mask_as_target`` (JointLoss mode) the model reads
only the first ``in_channels`` channels: the 4th canvas channel is the
segmentation target.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from fedvit_torch.core.config import Config
from fedvit_torch.core.device import resolve_device
from fedvit_torch.models.heads import ClassifierHead
from fedvit_torch.models.layers import trunc_normal_
from fedvit_torch.models.fusion import build_fusion_module
from fedvit_torch.models.metadata import MetadataBranch, MetadataEmbedding
from fedvit_torch.models.registry import DTYPES, build_backbone
from fedvit_torch.models.unet import SegmentationBranch


class ISICClassifier(nn.Module):
    def __init__(self, backbone_name: str = "vit_base_patch16_224",
                 num_classes: int = 8, image_size: int = 224,
                 in_channels: int = 3, pretrained: bool = False,
                 drop_path_rate: float = 0.1, pool: str = "cls",
                 metadata_enabled: bool = True, metadata_style: str = "mlp",
                 meta_input_dim: int = 13, meta_hidden_dim: int = 256,
                 meta_output_dim: int = 128, meta_dropout: float = 0.4,
                 meta_embed_dim: int = 64,
                 cls_hidden_dim: int = 512, cls_dropout: float = 0.5,
                 cls_layer_norm: bool = False, seg_enabled: bool = False,
                 seg_encoder_channels: Sequence[int] = (64, 128, 256, 512),
                 seg_decoder_channels: Sequence[int] = (256, 128, 64, 32),
                 fusion_type: str = "attention", mask_as_target: bool = False,
                 compute_dtype: str = "bfloat16",
                 attention_impl: str = "auto", remat: bool = False):
        super().__init__()
        dtype = DTYPES[compute_dtype]
        self.in_channels = in_channels
        self.mask_as_target = mask_as_target
        self.backbone, dim = build_backbone(
            backbone_name, image_size, in_channels, drop_path_rate, pool,
            compute_dtype, attention_impl, pretrained, remat)
        self.seg_enabled = seg_enabled
        if seg_enabled:
            self.seg_branch = SegmentationBranch(
                in_channels, tuple(seg_encoder_channels),
                tuple(seg_decoder_channels), dtype)
            self.fusion = build_fusion_module(
                fusion_type, dim, seg_decoder_channels[-1], dim, dtype)
        self.metadata_style = metadata_style
        self.meta_output_dim = 0
        if metadata_enabled and metadata_style == "mlp":
            self.metadata_branch = MetadataBranch(
                meta_input_dim, meta_hidden_dim, meta_output_dim, meta_dropout,
                dtype)
            self.meta_output_dim = meta_output_dim
        elif metadata_enabled:
            self.metadata_branch = MetadataEmbedding(meta_embed_dim, dtype)
            self.meta_output_dim = meta_embed_dim
        self.classifier = ClassifierHead(dim + self.meta_output_dim,
                                         num_classes, cls_hidden_dim,
                                         cls_dropout, dtype, cls_layer_norm)

    def forward(self, x: torch.Tensor,
                metadata: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                metadata_raw: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """x (B, H, W, C); ``metadata`` the flat (B, 13) vector of the MLP
        branch, ``metadata_raw`` the {"age", "sex", "site"} fields of the
        embedding branch. In training mode (``model.train()``) every dropout
        and drop-path mask is drawn from ``generator``, a
        ``torch.Generator`` on the model's device; evaluation needs none."""
        if self.mask_as_target:
            x = x[..., :self.in_channels]
        features = self.backbone(x, generator)
        out = {"features": features}
        if self.seg_enabled:
            seg_mask, dec_feats, _ = self.seg_branch(x)
            out["seg_mask"] = seg_mask
            features = self.fusion(features, dec_feats[-1], generator)
        if self.meta_output_dim:
            if self.metadata_style == "mlp" and metadata is not None:
                meta = self.metadata_branch(metadata, generator)
            elif self.metadata_style != "mlp" and metadata_raw is not None:
                meta = self.metadata_branch(
                    metadata_raw["age"], metadata_raw["sex"],
                    metadata_raw["site"], generator)
            else:
                meta = features.new_zeros(features.shape[0],
                                          self.meta_output_dim)
            features = torch.cat([features, meta], dim=-1)
        out["logits"] = self.classifier(features, generator)
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: trunc-normal(0.02) weights for every linear map,
    convolution and embedding (every ``weight`` of rank >= 2), the cls
    token and the position embedding; zero
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


def is_joint_loss(cfg: Config) -> bool:
    """Whether ``cfg`` trains in the old generation's JointLoss mode."""
    return bool(cfg.model.segmentation.enabled and cfg.loss.seg_weight > 0
                and cfg.data.use_segmentation_mask)


def build_model(cfg: Config, device: str = "cuda",
                generator: Optional[torch.Generator] = None) -> ISICClassifier:
    """ISICClassifier for ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``), in eval mode, with weights from ``generator`` (a CPU
    generator; default: seeded with ``cfg.seed``). in_channels = 4 iff
    data.use_segmentation_mask (reference model.py:302-324), except in the
    old generation's JointLoss mode (``segmentation.enabled``,
    ``loss.seg_weight > 0`` and ``data.use_segmentation_mask``): there the
    model takes 3 channels and the 4th is the BCE-Dice target that
    ``train/step.py`` adds (reference train_old.py:392-396)."""
    dev = resolve_device(device)
    m = cfg.model
    joint = is_joint_loss(cfg)
    model = ISICClassifier(
        backbone_name=m.backbone, num_classes=m.num_classes,
        image_size=m.image_size, in_channels=3 if joint else cfg.in_channels,
        mask_as_target=joint,
        pretrained=m.pretrained and not m.pretrained_path,
        drop_path_rate=m.drop_path_rate, pool=m.pool,
        metadata_enabled=m.metadata.enabled,
        metadata_style=m.metadata.style,
        meta_input_dim=m.metadata.input_dim,
        meta_hidden_dim=m.metadata.hidden_dim,
        meta_output_dim=m.metadata.output_dim,
        meta_dropout=m.metadata.dropout,
        meta_embed_dim=m.metadata.embed_dim,
        cls_hidden_dim=m.classifier.hidden_dim,
        cls_dropout=m.classifier.dropout,
        cls_layer_norm=m.classifier.layer_norm,
        seg_enabled=m.segmentation.enabled,
        seg_encoder_channels=tuple(m.segmentation.encoder_channels),
        seg_decoder_channels=tuple(m.segmentation.decoder_channels),
        fusion_type=m.segmentation.fusion_type,
        compute_dtype=m.compute_dtype, attention_impl=m.attention_impl,
        remat=m.remat)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    return init_weights(model, generator).to(dev).eval()
