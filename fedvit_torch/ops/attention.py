"""Plain PyTorch attention — the counterpart of ``fedvit_tpu/ops/attention.py``'s
XLA branch, and the reference the CUDA kernels are held to.

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


def dot_product_attention_flat(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Bias-free attention on flat (B, N, E) operands, heads head-major along
    E: the plain branch of ``fedvit_tpu/ops/attention.py::
    dot_product_attention_flat``. Returns (B, N, E)."""
    b, n, e = q.shape
    d = e // num_heads
    out = xla_attention(q.reshape(b, n, num_heads, d),
                        k.reshape(b, n, num_heads, d),
                        v.reshape(b, n, num_heads, d))
    return out.reshape(b, n, e)


def attention_from_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Bias-free attention on the packed (B, N, 3E) projection output (the
    XLA branch of ``fedvit_tpu/ops/attention.py::attention_from_qkv``): the
    plain version of K10. Returns (B, N, E)."""
    e = qkv.shape[-1] // 3
    return dot_product_attention_flat(qkv[..., :e], qkv[..., e:2 * e],
                                      qkv[..., 2 * e:], num_heads)


def attention_from_qkvb(qkv: torch.Tensor, bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Attention on the bias-free packed (B, N, 3E) projection output plus the
    projection bias (3E,), which is cast to qkv's dtype and added first: the
    plain version of K1-K3. Returns (B, N, E)."""
    return attention_from_qkv(qkv + bias.reshape(1, 1, -1).to(qkv.dtype),
                              num_heads)


def attention_from_x(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """The QKV projection and attention, attention(x·W + b), as the XLA
    branch of ``fedvit_tpu/ops/attention.py::attention_from_x``: the plain
    version of K11. x (B, N, D); w (D, 3E) packed [Wq | Wk | Wv], heads
    head-major within each third; b (3E,). The products of x and W (cast to
    x's dtype) are summed in fp32, the fp32 bias added, and qkv rounded once
    to x's dtype. Returns (B, N, E)."""
    qkv = (torch.matmul(x.float(), w.to(x.dtype).float())
           + b.float()).to(x.dtype)
    return attention_from_qkv(qkv, num_heads)


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
