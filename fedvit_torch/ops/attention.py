"""Plain PyTorch attention — the counterpart of ``fedvit_tpu/ops/attention.py``'s
XLA branch, and the reference the CUDA kernels are held to — and the op-level
attention entries with JAX's ``impl``.

Layout as in the JAX package: q, k, v are (B, N, H, Dh); the packed QKV
projection output is (B, N, 3E) with heads head-major along the last dim; the
Swin path's operands are flat (W0·B, N, E), window-major.

``impl`` of ``dot_product_attention_flat``, ``dot_product_attention`` and
``windowed_cosine_attention_flat`` has JAX's meaning: ``pallas`` (and
``mega``, which only changes the ViT's composition) runs the kernel entry of
``ops/flash_attention.py``, which launches a CUDA kernel on a CUDA tensor and
runs the plain body under autograd on a CPU tensor; ``xla`` runs the plain
body; ``auto`` is ``pallas`` on a CUDA tensor and ``xla`` elsewhere, as JAX's
is ``pallas`` on a TPU. The kernel module imports this one, so it is imported
lazily, as JAX does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

IMPLS = ("auto", "pallas", "mega", "xla")
COS_EPS = 1e-6   # the cosine attention's norm clamp, as the JAX package's


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether ``impl`` takes the kernel entry for operands like ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return x.device.type == "cuda"
    return impl != "xla"


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale [+ bias])·v on (B, N, H, Dh) operands, scale 1/√Dh
    by default.

    bias: an optional additive fp32 term: (H, N, N), broadcast over the
    batch; or (W0, H, N, N) with B % W0 == 0, where batch element b takes
    window b % W0 (window-minor, as JAX's; a (B, H, N, N) per-sample bias is
    W0 == B). Scores accumulate in fp32 and are scaled there, the bias is
    added in fp32; softmax runs in fp32 and its weights are cast back to the
    input dtype; P·V accumulates in fp32 and the output is cast to the input
    dtype."""
    orig = q.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        if bias.dim() == 3:
            logits = logits + bias[None].float()
        else:
            b, w0 = q.shape[0], bias.shape[0]
            logits = (logits.reshape((b // w0, w0) + logits.shape[1:])
                      + bias[None].float()).reshape(logits.shape)
    weights = torch.softmax(logits, dim=-1).to(orig)
    out = torch.einsum("bhnm,bmhd->bnhd", weights.float(), v.float())
    return out.to(orig)


def dot_product_attention_flat(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int,
                               impl: str = "auto") -> torch.Tensor:
    """Bias-free attention on flat (B, N, E) operands, heads head-major along
    E, as ``fedvit_tpu/ops/attention.py::dot_product_attention_flat``.
    Returns (B, N, E).

    ``impl="xla"`` is the plain version of K9; the others take
    ``flash_attention_flat`` (see the module's docstring)."""
    if _use_kernel(impl, q):
        from fedvit_torch.ops.flash_attention import flash_attention_flat
        return flash_attention_flat(q, k, v, num_heads)
    b, n, e = q.shape
    d = e // num_heads
    out = xla_attention(q.reshape(b, n, num_heads, d),
                        k.reshape(b, n, num_heads, d),
                        v.reshape(b, n, num_heads, d))
    return out.reshape(b, n, e)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          impl: str = "auto",
                          scale: Optional[float] = None) -> torch.Tensor:
    """Attention on (B, N, H, D) operands, as ``fedvit_tpu/ops/attention.py::
    dot_product_attention``: with no bias the kernel path is
    ``flash_attention`` (K9), which scales the scores by 1/√D and, as JAX's
    does, ignores ``scale``; with a bias, or ``impl="xla"``, the plain
    ``xla_attention``, which honours it (no kernel takes a bias here)."""
    if _use_kernel(impl, q) and bias is None:
        from fedvit_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v)
    return xla_attention(q, k, v, bias=bias, scale=scale)


def attention_from_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Bias-free attention on the packed (B, N, 3E) projection output (the
    XLA branch of ``fedvit_tpu/ops/attention.py::attention_from_qkv``): the
    plain version of K10. Returns (B, N, E). Its attention is the plain body
    (``impl="xla"``, as JAX's XLA branch passes), never K9."""
    e = qkv.shape[-1] // 3
    return dot_product_attention_flat(qkv[..., :e], qkv[..., e:2 * e],
                                      qkv[..., 2 * e:], num_heads, impl="xla")


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
    return attention_from_qkv(product_plain(x, w.to(x.dtype), b), num_heads)


def product_plain(a: torch.Tensor, b: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a·b (+ bias) as K11's products compute it: the products summed in
    fp32, the fp32 bias added, the result rounded once to a's dtype. The
    plain version of ``ops/flash_attention.py::gemm_product``."""
    out = torch.matmul(a.float(), b.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(a.dtype)


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


def windowed_cosine_attention_flat(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor,
                                   mask: Optional[torch.Tensor],
                                   num_heads: int,
                                   impl: str = "auto") -> torch.Tensor:
    """SwinV2's scaled-cosine windowed attention on RAW flat operands, as
    ``fedvit_tpu/ops/attention.py::windowed_cosine_attention_flat``:
    softmax(scale_h·q̂_h·k̂_hᵀ + bias[h] + mask[w])·v_h with
    x̂ = x / max(‖x‖, 1e-6) over each row's head slice.

    q, k, v: (W0·B, N, E) window-major flat (rows [w·B, (w+1)·B) belong to
    window w); scale: (H,) per-head logit scale; bias (H, N, N); mask
    (W0, N, N) additive, or None. ``impl="xla"`` is the plain version of K12
    with the XLA branch's casts: q̂·scale and k̂ in fp32, rounded to q's
    dtype; fp32 scores with the fp32 bias and mask; an fp32 softmax whose
    weights are rounded to q's dtype; P·V summed in fp32. The norm is
    ``torch.linalg.vector_norm``, whose gradient at a row of zeros is 0, so
    a clamped row's gradient is the finite x̂ = x·1e6 branch, as K12's: JAX's
    XLA branch gives NaN there. The other impls take
    ``flash_attention_cosine_flat``."""
    if _use_kernel(impl, q):
        from fedvit_torch.ops.flash_attention import flash_attention_cosine_flat
        return flash_attention_cosine_flat(q, k, v, scale, bias, mask,
                                           num_heads)
    wb, n, e = q.shape
    d = e // num_heads
    if mask is None:
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=q.device)
    w0 = mask.shape[0]
    if wb % w0:
        raise ValueError(f"rows {wb} not divisible by windows {w0}")
    b = wb // w0

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=COS_EPS)

    qh, kh = (t.reshape(w0, b, n, num_heads, d).float() for t in (q, k))
    vh = v.reshape(w0, b, n, num_heads, d)
    qh = unit(qh) * scale.float().reshape(1, 1, 1, num_heads, 1)
    kh = unit(kh)
    logits = torch.einsum("wbnhd,wbmhd->wbhnm", qh.to(q.dtype).float(),
                          kh.to(q.dtype).float())
    logits = logits + bias[None, None].float()
    logits = logits + mask[:, None, None].float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("wbhnm,wbmhd->wbnhd", weights.float(), vh.float())
    return out.to(q.dtype).reshape(wb, n, e)


def windowed_cosine_dscale(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], dout: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """The gradient of ``windowed_cosine_attention_flat`` with respect to
    ``scale``, (H,) in scale's dtype, in the order of the TPU kernel
    (``fedvit_tpu/ops/flash_attention.py::_wcos_bwd_kernel``): the fp32
    softmax P of the rounded q̂·scale and k̂; dP = dout·vᵀ and
    dS = P∘(dP − rowsum(dP∘P)) in fp32; dS rounded to q's dtype before
    dq̂n = dS·k̂ is summed in fp32; dscale[h] = Σ q̂·dq̂n over every row, q̂
    the unscaled fp32 unit row.

    Autograd of the plain version keeps dS in fp32 and rounds dq̂n instead.
    dscale is a sum that cancels (each row of dS sums to 0), so in bf16 the
    two orders differ by more than either rounding; the TPU kernel and K12
    round dS, and K12's dscale is held to this."""
    wb, n, e = q.shape
    d = e // num_heads
    if mask is None:
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=q.device)
    w0 = mask.shape[0]
    b = wb // w0

    def split(t):
        return t.reshape(w0, b, n, num_heads, d).float()

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=COS_EPS)

    qh, kh = unit(split(q)), unit(split(k))
    qn = (qh * scale.float().reshape(1, 1, 1, num_heads, 1)).to(q.dtype).float()
    kn = kh.to(q.dtype).float()
    logits = torch.einsum("wbnhd,wbmhd->wbhnm", qn, kn)
    logits = logits + bias[None, None].float() + mask[:, None, None].float()
    p = torch.softmax(logits, dim=-1)
    dp = torch.einsum("wbnhd,wbmhd->wbhnm", split(dout.to(q.dtype)), split(v))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqn = torch.einsum("wbhnm,wbmhd->wbnhd", ds.to(q.dtype).float(), kn)
    return (qh * dqn).sum(dim=(0, 1, 2, 4)).to(scale.dtype)
