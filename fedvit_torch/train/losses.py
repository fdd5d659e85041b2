"""Loss functions on (logits, integer targets) — ``fedvit_tpu/train/losses.py``.

Every loss computes in fp32 whatever the logits' dtype:

* ``asymmetric_focal_loss`` — the current generation's loss (JAX :34-71);
* ``cross_entropy_loss`` with class weights and label smoothing, with
  ``torch.nn.CrossEntropyLoss`` semantics (JAX :78-106);
* ``focal_loss`` (JAX :109-126);
* ``bce_dice_loss`` and ``joint_loss`` — the old generation's segmentation
  term and its cls + λ·seg objective (JAX :133-172);
* ``mixup_criterion`` — the λ-weighted two-target loss (JAX :176-184);
* ``build_loss`` — from the config, with ``loss.class_weights`` honoured.

Inside a data-parallel SPMD step each returns the rank's share of the whole
micro-batch's loss (its rows' sum over the whole micro-batch's count or
class weight, ``parallel/data.py``): the shares sum over the ranks to the
unsharded loss, and their gradients to its gradient.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from fedvit_torch.core.config import Config
from fedvit_torch.parallel.data import (element_mean, own_sum, row_sum,
                                        weight_sum)

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def asymmetric_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                          gamma_neg: float = 4.0, gamma_pos: float = 1.0,
                          clip: float = 0.05, eps: float = 1e-8
                          ) -> torch.Tensor:
    """Asymmetric focal loss for single-label multi-class classification:
    softmax probabilities p, clamped p_pos = max(p, eps), p_neg = max(min(p,
    1 - eps) - clip, eps); loss = -[(1-p)^γ+ y log p_pos + p^γ- (1-y)
    log(1 - p_neg)], summed over classes, averaged over the batch.
    logits (B, C), targets (B,) int."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    one_hot = F.one_hot(targets.long(), logits.shape[-1]).float()
    p_pos = torch.clamp(probs, min=eps)
    p_neg = torch.clamp(probs, max=1.0 - eps)
    if clip > 0:
        p_neg = torch.clamp(p_neg - clip, min=eps)
    loss_pos = one_hot * torch.log(p_pos)
    loss_neg = (1.0 - one_hot) * torch.log(1.0 - p_neg)
    w_pos = torch.clamp(1.0 - probs, min=0.0) ** gamma_pos
    w_neg = torch.clamp(probs, min=0.0) ** gamma_neg
    loss = -(w_pos * loss_pos + w_neg * loss_neg)
    return row_sum(loss.sum(-1))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """(Optionally weighted, label-smoothed) softmax cross-entropy with
    ``torch.nn.CrossEntropyLoss`` semantics: the smoothing term is weighted
    per class w_j, the NLL term per target w_y, and the mean is normalised
    by Σ_i w_{y_i}."""
    num_classes = logits.shape[-1]
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(targets.long(), num_classes).float()
    eps = label_smoothing
    if class_weights is None:
        q = one_hot * (1.0 - eps) + eps / num_classes if eps > 0 else one_hot
        return row_sum(-(q * log_probs).sum(-1))
    w = class_weights.float().to(logits.device)
    w_y = w[targets.long()]
    nll = -(one_hot * log_probs).sum(-1) * w_y
    if eps > 0:
        smooth = -(log_probs * w[None, :]).sum(-1) / num_classes
        per_sample = (1.0 - eps) * nll + eps * smooth
    else:
        per_sample = nll
    return own_sum(per_sample) / torch.clamp(weight_sum(w_y), min=1e-12)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0,
               class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-class focal loss: the mean over the batch of (1-p_t)^γ · CE_t,
    weighted by w_{y_i} and normalised by their sum when class weights are
    given."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(targets.long(), logits.shape[-1]).float()
    log_pt = (one_hot * log_probs).sum(-1)
    per_sample = -((1.0 - torch.exp(log_pt)) ** gamma) * log_pt
    if class_weights is not None:
        w = class_weights.float().to(logits.device)[targets.long()]
        return own_sum(per_sample * w) / torch.clamp(weight_sum(w),
                                                     min=1e-12)
    return row_sum(per_sample)


def bce_dice_loss(seg_logits: torch.Tensor, seg_targets: torch.Tensor,
                  bce_weight: float = 0.5, smooth: float = 1.0) -> torch.Tensor:
    """Binary cross-entropy with logits plus the Dice loss of a predicted
    mask, in fp32: the BCE is the mean over every element, the Dice ratio
    is taken per sample and then averaged. seg_logits and seg_targets are
    (B, H, W, 1), the targets in [0, 1]."""
    x = seg_logits.float()
    t = seg_targets.float()
    bce = element_mean(torch.clamp(x, min=0) - x * t
                       + torch.log1p(torch.exp(-x.abs())))
    probs = torch.sigmoid(x)
    axes = tuple(range(1, x.dim()))
    inter = (probs * t).sum(dim=axes)
    union = probs.sum(dim=axes) + t.sum(dim=axes)
    dice = 1.0 - row_sum((2.0 * inter + smooth) / (union + smooth))
    return bce_weight * bce + (1.0 - bce_weight) * dice


def joint_loss(cls_loss_fn: LossFn, logits: torch.Tensor,
               targets: torch.Tensor,
               seg_logits: Optional[torch.Tensor] = None,
               seg_targets: Optional[torch.Tensor] = None,
               seg_weight: float = 0.3) -> torch.Tensor:
    """cls + λ·seg (reference train_old.py:392-396); the seg term only with
    both seg tensors and λ > 0."""
    loss = cls_loss_fn(logits, targets)
    if seg_logits is not None and seg_targets is not None and seg_weight > 0:
        loss = loss + seg_weight * bce_dice_loss(seg_logits, seg_targets)
    return loss


def mixup_criterion(criterion: LossFn, logits: torch.Tensor,
                    targets_a: torch.Tensor, targets_b: torch.Tensor,
                    lam) -> torch.Tensor:
    """λ · loss(targets_a) + (1 − λ) · loss(targets_b)."""
    return (lam * criterion(logits, targets_a)
            + (1.0 - lam) * criterion(logits, targets_b))


def build_loss(cfg: Config,
               class_weights: Optional[torch.Tensor] = None) -> LossFn:
    """The classification loss of ``cfg.loss``; ``class_weights`` (C,) reach
    the focal and CE losses only when ``loss.class_weights`` is set."""
    lc = cfg.loss
    weights = class_weights if lc.class_weights else None
    if lc.type == "asymmetric":
        return partial(asymmetric_focal_loss,
                       gamma_neg=lc.asymmetric.gamma_neg,
                       gamma_pos=lc.asymmetric.gamma_pos,
                       clip=lc.asymmetric.clip)
    if lc.type == "focal":
        return partial(focal_loss, gamma=lc.focal_gamma, class_weights=weights)
    if lc.type == "ce":
        return partial(cross_entropy_loss, class_weights=weights,
                       label_smoothing=lc.label_smoothing)
    raise ValueError(f"Unknown loss type: {lc.type}")
