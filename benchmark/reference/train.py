"""Plain reference of a training step: mix, loss, gradient, AdamW with
layer-wise LR decay, EMA.

One step on a macro batch of ``accum`` micro-batches (the three cells train
with one):

1. per micro-batch, MixUp (λ ~ Beta(0.4, 0.4)) or, with probability 0.7,
   CutMix (a box of area 1 − λ', λ' ~ Beta(1, 1), λ corrected to the pasted
   area) against a random permutation of the micro-batch; the choice, λ and
   the box from a ``numpy.random.Generator``, the permutation from the step's
   ``torch.Generator``, which then draws the forward's masks;
2. the asymmetric focal loss (γ− 4, γ+ 1, clip 0.05), λ·L(y) + (1−λ)·L(y[perm]);
3. the gradients averaged over the micro-batches, clipped to global norm 1
   (scaled by c/‖g‖ when ‖g‖ ≥ c), Adam (β 0.9, 0.999, ε 1e-8, bias
   corrected), plus weight decay · p, times the parameter's LLRD scale, times
   −lr of the epoch the step lies in (linear warm-up, then cosine to min_lr);
4. the EMA s ← d·s + (1−d)·p, kept in float64.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models
from benchmark.reference.models import Params, Precision


def asymmetric_focal(logits: torch.Tensor, y: torch.Tensor, gamma_neg: float,
                     gamma_pos: float, clip: float, eps: float = 1e-8
                     ) -> torch.Tensor:
    p = torch.softmax(logits, -1)
    t = F.one_hot(y, logits.shape[-1]).to(p.dtype)
    p_neg = torch.clamp(torch.clamp(p, max=1.0 - eps) - clip, min=eps)
    pos = t * (1.0 - p) ** gamma_pos * torch.log(torch.clamp(p, min=eps))
    neg = (1.0 - t) * p ** gamma_neg * torch.log(1.0 - p_neg)
    return -(pos + neg).sum(-1).mean()


def draw_mix(x: torch.Tensor, rng: np.random.Generator, g: torch.Generator,
             mix: Dict) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mixed images, permutation, λ) of one micro-batch (B, H, W, C)."""
    b, h, w = x.shape[:3]
    if bool(rng.random() < mix["cutmix_prob"]):
        lam0 = float(rng.beta(mix["cutmix_alpha"], mix["cutmix_alpha"]))
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        cut = np.sqrt(np.float32(1.0) - np.float32(lam0))
        ch, cw = int(np.float32(h) * cut), int(np.float32(w) * cut)
        y1, y2 = int(np.clip(cy - ch // 2, 0, h)), int(np.clip(cy + ch // 2, 0, h))
        x1, x2 = int(np.clip(cx - cw // 2, 0, w)), int(np.clip(cx + cw // 2, 0, w))
        perm = torch.randperm(b, generator=g, device=x.device)
        out = x.clone()
        out[:, y1:y2, x1:x2] = x[perm][:, y1:y2, x1:x2]
        lam = 1.0 - float(np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w))
        return out, perm, lam
    lam = float(rng.beta(mix["mixup_alpha"], mix["mixup_alpha"]))
    perm = torch.randperm(b, generator=g, device=x.device)
    return lam * x + (1.0 - lam) * x[perm], perm, lam


_STAGE = re.compile(r"^backbone\.(blocks|layers)\.(\d+)\.")


def llrd_scales(names: List[str], decay: float, head_mult: float
                ) -> Dict[str, float]:
    """Each parameter's LR multiplier: with n the backbone's number of
    blocks (ViT) or stages (SwinV2), the patch embedding, class token and
    position embedding d^(n+1); block or stage i d^(n−i), a SwinV2 patch
    merging taking the scale of the stage before the one it feeds; the
    backbone's last norm 1; the head and the metadata MLP ``head_mult``."""
    stages = [int(m.group(2)) for m in map(_STAGE.match, names) if m]
    n = max(stages) + 1 if stages else 0
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] != "backbone":
            out[name] = head_mult
        elif parts[1] in ("patch_embed", "cls_token", "pos_embed"):
            out[name] = decay ** (n + 1)
        elif _STAGE.match(name):
            i = int(parts[2]) - (parts[3] == "downsample")
            out[name] = decay ** (n - i)
        else:
            out[name] = 1.0
    return out


def learning_rate(step: int, steps_per_epoch: int, base: float, warmup: int,
                  epochs: int, min_lr: float) -> float:
    e = step // steps_per_epoch
    if e < warmup:
        return base * e / max(1, warmup)
    prog = (e - warmup) / max(1, epochs - warmup)
    return min_lr + (base - min_lr) * 0.5 * (1.0 + math.cos(math.pi * prog))


class Trainer:
    """The reference's training state and step over named fp32 tensors."""

    def __init__(self, arch: Dict, recipe: Dict, params: Params,
                 prec: Precision, steps_per_epoch: int):
        self.arch, self.recipe, self.prec = arch, recipe, prec
        self.steps_per_epoch = steps_per_epoch
        self.p = {n: t.detach().clone().float().requires_grad_(True)
                  for n, t in params.items()}
        self.m = {n: torch.zeros_like(t) for n, t in self.p.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.p.items()}
        self.ema = {n: t.detach().double() for n, t in self.p.items()}
        self.count = 0
        self.scales = llrd_scales(list(self.p), recipe["llrd_decay"],
                                  recipe["head_lr_mult"])
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def micro_loss(self, x: torch.Tensor, y: torch.Tensor, meta: torch.Tensor,
                   rng: np.random.Generator, g: torch.Generator,
                   rows: Optional[slice] = None) -> torch.Tensor:
        r = self.recipe
        x, perm, lam = draw_mix(x, rng, g, r["mix"])
        masks = models.draw_masks(self.arch, x.shape[0], g, x.device)
        yb = y[perm]
        if rows is not None:        # a fault: a share of the rows left out
            x, y, yb, meta = x[rows], y[rows], yb[rows], meta[rows]
            masks = {k: None if v is None else v[rows] for k, v in masks.items()}
        logits = models.classifier(x, meta, self.p, self.arch, masks, self.prec,
                                   train=True, remat=True)
        loss_fn = lambda t: asymmetric_focal(logits, t, *r["loss"])  # noqa: E731
        return lam * loss_fn(y) + (1.0 - lam) * loss_fn(yb)

    def step(self, images: torch.Tensor, labels: torch.Tensor,
             meta: torch.Tensor, rng: np.random.Generator, g: torch.Generator,
             accum: int, rows: Optional[slice] = None) -> float:
        """One optimizer step on augmented images (B, S, S, 4) fp32; returns
        the loss. ``rows`` keeps a slice of each micro-batch (a planted
        fault)."""
        r = self.recipe
        micro = images.shape[0] // accum
        grads = {n: torch.zeros_like(t) for n, t in self.p.items()}
        total = 0.0
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            loss = self.micro_loss(images[sl], labels[sl], meta[sl],
                                           rng, g, rows)
            gs = torch.autograd.grad(loss, list(self.p.values()),
                                     allow_unused=True)
            for (n, _), gi in zip(self.p.items(), gs):
                if gi is not None:
                    grads[n] += gi / accum
            total += float(loss.detach()) / accum
        self.update(grads)
        return total

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        r = self.recipe
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        clip = r["grad_clip"]
        factor = 1.0 if (not clip or float(norm) < clip) else clip / float(norm)
        grads = {n: g * factor for n, g in grads.items()}
        if self.first_grads is None:
            self.first_grads = {n: g.clone() for n, g in grads.items()}
        lr = learning_rate(self.count, self.steps_per_epoch, r["lr"],
                           r["warmup_epochs"], r["epochs"], r["min_lr"])
        self.count += 1
        b1, b2, eps = r["betas"][0], r["betas"][1], r["eps"]
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for n, p in self.p.items():
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + eps)
            u = u + r["weight_decay"] * p
            p.sub_(lr * self.scales[n] * u)
            self.ema[n].mul_(r["ema_decay"]).add_(p, alpha=1.0 - r["ema_decay"])


def recipe_of(program: Dict) -> Dict:
    """The training recipe from a configuration's program section (the
    fedvit_torch schema, as the configuration file holds it)."""
    t, aug, loss = program["training"], program["augmentation"], program["loss"]
    opt, sch = t["optimizer"], t["scheduler"]
    asym = loss["asymmetric"]
    if loss["type"] != "asymmetric":
        raise ValueError("the reference trains with the asymmetric loss")
    return {"lr": opt["lr"], "weight_decay": opt["weight_decay"],
            "betas": (opt["b1"], opt["b2"]), "eps": opt["eps"],
            "warmup_epochs": sch["warmup_epochs"], "min_lr": sch["min_lr"],
            "epochs": t["epochs"], "grad_clip": t["grad_clip"],
            "llrd_decay": t["llrd"]["decay_rate"],
            "head_lr_mult": t["llrd"]["head_lr_mult"],
            "ema_decay": t["ema"]["decay"],
            "loss": (asym["gamma_neg"], asym["gamma_pos"], asym["clip"]),
            "mix": {"mixup_alpha": aug["mixup"]["alpha"],
                    "cutmix_alpha": aug["cutmix"]["alpha"],
                    "cutmix_prob": aug["cutmix"]["prob"]}}
