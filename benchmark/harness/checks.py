"""The numbers that decide ``correct``, each held to the limit of its cell.

Training (the first three optimizer steps of the object the window then
drives, against the reference's three steps from the same inputs):

- ``loss_gap``: the largest |loss − reference loss| / |reference loss| of
  the three steps;
- ``grad_gap``: the first step's gradient as the optimizer got it (after the
  clip), leaf by leaf: the largest gap between the program's norm and the
  reference's, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``change_gap``: the same for the parameters' change over the three steps,
  ‖p₃ − p₀‖, leaving out the elements whose first reference gradient is
  under a thousandth of the median leaf's RMS gradient: they move under Adam
  by round-off alone (a key's bias under softmax; the port keeps it in one
  leaf with the query's and value's biases, so the rule goes element by
  element);
- ``grad_gap.median``: the median over the leaves of ``grad_gap``'s gaps.
  The largest gap is one leaf's bf16 noise (the class token's, as a rule)
  and swings from seed to seed as far as the fp8 control's reading does;
  the median is steady and parts the two;
- ``ema_gap``: the EMA's change over the three steps as a share of the
  parameters' change, ‖s₃ − p₀‖ / ‖p₃ − p₀‖ over all the parameters at
  once, against the reference's share. The EMA's change follows the
  parameters' (which ``change_gap`` compares); the share isolates the EMA
  update itself. At decay 0.9995 a step moves the shadow by 5e-4 of the
  parameters' change, below the resolution of an fp32 shadow of values
  near 1 (a LayerNorm's scale), so no single leaf of it is a sound
  reading.

Serving (a sample, drawn from the seed, of the answers the window produced):

- ``logit_gap``: the largest |logit − reference logit| of the sampled
  answers, over the RMS of the reference's logits of the sample.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SMALL_GRAD = 1e-3     # a leaf under this share of the median leaf's gradient


def leaf_norms(tensors: Dict[str, torch.Tensor],
               minus: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, float]:
    """‖t‖ (or ‖t − minus‖) of each named tensor, in fp64 on the host."""
    names = list(tensors)
    with torch.no_grad():
        if minus is None:
            vals = [tensors[n].detach().double() for n in names]
        else:
            vals = [tensors[n].detach().double() - minus[n].detach().double()
                    for n in names]
        norms = torch.stack([torch.linalg.vector_norm(v) for v in vals])
    return dict(zip(names, norms.cpu().tolist()))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float]
              ) -> Dict[str, float]:
    """Each leaf's |got − want| over max(want, median want)."""
    med = float(np.median(list(want.values())))
    return {n: abs(got.get(n, float("nan")) - w) / max(w, med, 1e-30)
            for n, w in want.items()}


def leaf_gap(got: Dict[str, float], want: Dict[str, float]
             ) -> Tuple[float, str]:
    """(largest gap, its leaf) of ``leaf_gaps``."""
    worst, which = 0.0, ""
    for n, gap in leaf_gaps(got, want).items():
        if not math.isfinite(gap):
            return float("inf"), n
        if gap > worst:
            worst, which = gap, n
    return worst, which


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float]
                    ) -> Tuple[float, str]:
    """(median of ``leaf_gaps``, "median leaf"); not finite where a leaf's
    gap is not."""
    gaps = list(leaf_gaps(got, want).values())
    if not all(map(math.isfinite, gaps)):
        return float("inf"), "a leaf is missing or not finite"
    return float(np.median(gaps)), "median leaf"


def global_norm(norms: Dict[str, float]) -> float:
    return math.sqrt(sum(v ** 2 for v in norms.values()))


def ema_share_gap(prog: Dict, ref: Dict) -> Tuple[float, str]:
    """(|ρ − ρ_ref| / ρ_ref, "all leaves"), ρ = ‖s₃ − p₀‖ / ‖p₃ − p₀‖ over
    all the parameters."""
    def share(side):
        change = global_norm(leaf_norms(side["delta"]))
        return global_norm(side["ema"]) / max(change, 1e-30)
    a, b = share(prog), share(ref)
    gap = abs(a - b) / max(b, 1e-30)
    return (gap if math.isfinite(gap) else float("inf")), "all leaves"


def moving(ref_grad: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's mask of the elements whose reference gradient is at
    least ``SMALL_GRAD`` of the median leaf's RMS gradient."""
    rms = [float(torch.linalg.vector_norm(g.double())) / math.sqrt(g.numel())
           for g in ref_grad.values()]
    floor = SMALL_GRAD * float(np.median(rms))
    return {n: g.detach().abs() >= floor for n, g in ref_grad.items()}


def change_norms(delta: Dict[str, torch.Tensor],
                 keep: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """‖Δ‖ of each leaf over its kept elements; leaves with none left out."""
    out = {}
    for n, k in keep.items():
        if bool(k.any()):
            d = delta[n].to(k.device).double()
            out[n] = float(torch.linalg.vector_norm(d[k]))
    return out


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Each training number with the leaf or step that set it. ``prog`` and
    ``ref`` hold ``loss`` (one a step), ``grad`` and ``ema`` (a norm a
    leaf) and ``delta`` (each leaf's change, a tensor); ``ref`` also
    ``grads``, its first gradient a leaf."""
    losses = [abs(a - b) / abs(b) if b else float("inf")
              for a, b in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]) or not all(map(math.isfinite, losses)):
        loss = (float("inf"), "a loss is missing or not finite")
    else:
        k = int(np.argmax(losses))
        loss = (losses[k], f"step {k + 1}")
    keep = moving(ref["grads"])
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "grad_gap.median": median_leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(change_norms(prog["delta"], keep),
                                   change_norms(ref["delta"], keep)),
            "ema_gap": ema_share_gap(prog, ref)}


def logit_gap(got: np.ndarray, want: np.ndarray) -> Tuple[float, str]:
    """(largest |got − want| over the RMS of ``want``, the answer it is)."""
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf"), "logits missing or not finite"
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    err = np.abs(got.astype(np.float64) - want).max(-1)
    k = int(np.argmax(err))
    return float(err[k]) / max(rms, 1e-30), f"answer {k}"


def judge(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {number: {value, limit, at}}): correct when every number
    is finite and within its limit."""
    out, ok = {}, True
    for name, (value, at) in numbers.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit, "at": at}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
