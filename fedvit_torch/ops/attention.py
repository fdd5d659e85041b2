"""Plain PyTorch attention — the counterpart of ``fedvit_tpu/ops/attention.py``'s
XLA branch, and the reference the CUDA kernel is held to.

Layout as in the JAX package: q, k, v are (B, N, H, Dh); the packed QKV
projection output is (B, N, 3E) with heads head-major along the last dim; the
Swin path's operands are flat (W0·B, N, E), window-major.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v on (B, N, H, Dh) operands, scale 1/√Dh by default.

    Scores accumulate in fp32 and are scaled there; softmax runs in fp32 and
    its weights are cast back to the input dtype; P·V accumulates in fp32 and
    the output is cast to the input dtype."""
    orig = q.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(orig)
    out = torch.einsum("bhnm,bmhd->bnhd", weights.float(), v.float())
    return out.to(orig)


def attention_from_qkvb(qkv: torch.Tensor, bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Attention on the bias-free packed (B, N, 3E) projection output plus the
    projection bias (3E,), which is cast to qkv's dtype and added first.
    Returns (B, N, E)."""
    b, n, e3 = qkv.shape
    e = e3 // 3
    d = e // num_heads
    x = qkv + bias.reshape(1, 1, -1).to(qkv.dtype)
    q, k, v = (x[..., i * e:(i + 1) * e].reshape(b, n, num_heads, d)
               for i in range(3))
    return xla_attention(q, k, v).reshape(b, n, e)


def windowed_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, mask: Optional[torch.Tensor],
                            num_heads: int) -> torch.Tensor:
    """softmax(q_h·k_hᵀ + bias[h] + mask[w])·v_h on flat window-major operands
    (the XLA branch of ``fedvit_tpu/ops/attention.py::windowed_attention_flat``).

    q, k, v: (W0·B, N, E) with rows [w·B, (w+1)·B) belonging to window w and
    heads head-major along E. bias: (H, N, N); mask: (W0, N, N) additive, or
    None (zeros (1, N, N)). No score scale: the caller folds it into q.
    Scores accumulate in fp32, bias and mask are added there, softmax runs in
    fp32 and its weights are cast to q's dtype; P·V accumulates in fp32 and
    the output is cast to q's dtype."""
    wb, n, e = q.shape
    d = e // num_heads
    if mask is None:
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=q.device)
    w0 = mask.shape[0]
    if wb % w0:
        raise ValueError(f"rows {wb} not divisible by windows {w0}")
    b = wb // w0
    qh, kh, vh = (t.reshape(w0, b, n, num_heads, d).float() for t in (q, k, v))
    logits = torch.einsum("wbnhd,wbmhd->wbhnm", qh, kh)
    logits = logits + bias[None, None].float()
    logits = logits + mask[:, None, None].float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("wbhnm,wbmhd->wbnhd", weights.float(), vh)
    return out.to(q.dtype).reshape(wb, n, e)
