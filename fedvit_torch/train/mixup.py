"""MixUp / CutMix on NHWC batches (``fedvit_tpu/train/mixup.py``).

The JAX functions draw everything from one PRNG key. Here λ, the
CutMix-or-MixUp choice and the box centre come from a seeded
``numpy.random.Generator`` on the host (``torch.distributions.Beta`` and
``torch._standard_gamma`` take no generator), and the permutation from
``torch.randperm`` with the step's ``torch.Generator`` on the batch's device;
nothing waits on the device. Every function also takes an explicit λ,
permutation and box, so that a test can hand both packages the same values.

Each returns (mixed, labels_a, labels_b, lam), with lam a Python float.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

Box = Tuple[int, int, int, int]   # (y1, x1, y2, x2), rows [y1, y2), cols [x1, x2)
Mixed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]


def mixup(images: torch.Tensor, labels: torch.Tensor, alpha: float = 0.4, *,
          rng: Optional[np.random.Generator] = None,
          generator: Optional[torch.Generator] = None,
          lam: Optional[float] = None,
          perm: Optional[torch.Tensor] = None) -> Mixed:
    """Convex combination with a permuted batch: λ ~ Beta(α, α) (1 when
    α = 0), mixed = λ·x + (1−λ)·x[perm]."""
    if lam is None:
        lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    if perm is None:
        perm = torch.randperm(images.shape[0], generator=generator,
                              device=images.device)
    mixed = lam * images + (1.0 - lam) * images[perm]
    return mixed, labels, labels[perm], lam


def rand_bbox(h: int, w: int, lam: float, cy: int, cx: int) -> Box:
    """The square-image box of ``_rand_bbox``: side ⌊size·√(1−λ)⌋ (float32,
    truncated), centred at (cy, cx), clipped to the image."""
    cut = np.sqrt(np.float32(1.0) - np.float32(lam))
    ch = int(np.float32(h) * cut)
    cw = int(np.float32(w) * cut)
    return (int(np.clip(cy - ch // 2, 0, h)), int(np.clip(cx - cw // 2, 0, w)),
            int(np.clip(cy + ch // 2, 0, h)), int(np.clip(cx + cw // 2, 0, w)))


def cutmix(images: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0, *,
           rng: Optional[np.random.Generator] = None,
           generator: Optional[torch.Generator] = None,
           perm: Optional[torch.Tensor] = None,
           box: Optional[Box] = None) -> Mixed:
    """Paste the box of the permuted batch; λ is corrected to the pasted
    area: λ = 1 − area / (H·W)."""
    b, h, w = images.shape[:3]
    if box is None:
        lam0 = float(rng.beta(alpha, alpha))
        box = rand_bbox(h, w, lam0, int(rng.integers(0, h)),
                        int(rng.integers(0, w)))
    if perm is None:
        perm = torch.randperm(b, generator=generator, device=images.device)
    y1, x1, y2, x2 = box
    mixed = images.clone()
    mixed[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
    lam = 1.0 - float(np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w))
    return mixed, labels, labels[perm], lam


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                 mixup_alpha: float = 0.4, cutmix_alpha: float = 1.0,
                 cutmix_prob: float = 0.7, *,
                 rng: Optional[np.random.Generator] = None,
                 generator: Optional[torch.Generator] = None,
                 use_cutmix: Optional[bool] = None,
                 lam: Optional[float] = None,
                 perm: Optional[torch.Tensor] = None,
                 box: Optional[Box] = None) -> Mixed:
    """CutMix with probability ``cutmix_prob``, else MixUp."""
    if use_cutmix is None:
        use_cutmix = bool(rng.random() < cutmix_prob)
    if use_cutmix:
        return cutmix(images, labels, cutmix_alpha, rng=rng,
                      generator=generator, perm=perm, box=box)
    return mixup(images, labels, mixup_alpha, rng=rng, generator=generator,
                 lam=lam, perm=perm)


def make_mix_fn(aug_cfg) -> Optional[Callable[..., Mixed]]:
    """mix(images, labels, rng=..., generator=...) for an
    ``AugmentationConfig``, or None when neither mix is on."""
    mixup_on = aug_cfg.mixup.enabled and aug_cfg.mixup.alpha > 0
    cutmix_on = aug_cfg.cutmix.enabled and aug_cfg.cutmix.prob > 0
    if mixup_on and cutmix_on:
        return lambda x, y, **kw: mixup_cutmix(
            x, y, aug_cfg.mixup.alpha, aug_cfg.cutmix.alpha,
            aug_cfg.cutmix.prob, **kw)
    if mixup_on:
        return lambda x, y, **kw: mixup(x, y, aug_cfg.mixup.alpha, **kw)
    if cutmix_on:
        return lambda x, y, **kw: mixup_cutmix(
            x, y, 0.0, aug_cfg.cutmix.alpha, aug_cfg.cutmix.prob, **kw)
    return None
