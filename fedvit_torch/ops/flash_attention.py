"""Fused attention: on the packed QKV projection with its backward (ViT),
and windowed with a relative-position bias and a shift mask (SwinV2).

Three ViT attentions, one for each ``model.attention_impl``, each the port of
the ``fedvit_tpu/ops/flash_attention.py`` function of the same name. On a CPU
tensor each runs its plain version in ``ops/attention.py`` under torch
autograd; the kernels are held to it. On a CUDA tensor each launches
hand-written kernels, with no fallback: the plain forward when no gradient is
needed, else a ``torch.autograd.Function`` whose forward also keeps each
row's log-sum-exp and whose backward is a kernel too.

- ``flash_attention_qkvb`` (``auto``, ``pallas``): the bias-free projection
  output plus the bias, added inside the op. K1 (``csrc/qkvb_attention.cu::
  qkvb_attention_fwd``, replaces ``_qkvb_fwd_kernel``); under grad
  ``QkvbAttention``: K2 (``qkvb_attention_fwd_lse``, replaces
  ``_qkvb_fwd_stats_kernel``) and K3 (``csrc/qkvb_attention_bwd.cu``;
  replaces ``_qkvb_bwd_kernel``, ``_qkvb_bwd_stats_kernel`` and
  ``_qkvb_bwd_delta_kernel``), which returns dqkv and the bias gradient, so
  the bias-free projection never counts it.
- ``flash_attention_qkv`` (``packed``): the projection output with its bias
  already added. K10 (``qkv_attention_fwd``, ``qkv_attention_fwd_lse`` and
  ``qkv_attention_bwd`` in the same two sources; replaces ``_qkv_fwd_kernel``
  and ``_qkv_bwd_kernel``), the same kernels compiled without a bias; under
  grad ``QkvAttention``, whose backward returns dqkv only.
- ``flash_attention_xqkv`` (``mega``): the projection and the attention,
  attention(x·W + b). K11 (``csrc/xqkv_attention.cu``,
  ``csrc/xqkv_attention_bwd.cu``; replaces ``_xqkv_fwd_kernel`` and
  ``_xqkv_bwd_kernel``), whose products run in its own tensor-core GEMM; under
  grad ``XqkvAttention``, whose backward returns dx, dW and db.

All of them take heads of d = 64 (ViT-Ti/S/B/L) or 80 (ViT-H), as does the
op-level attention on flat q, k and v:

- ``flash_attention_flat`` (``ops/attention.py::dot_product_attention_flat``
  with ``impl`` ``auto`` on the card, ``pallas`` or ``mega``), and
  ``flash_attention`` on (B, N, H, D) operands, a free reshape around it. K9
  (``flat_attention_fwd``, ``flat_attention_fwd_lse`` and
  ``flat_attention_bwd`` in ``csrc/qkvb_attention.cu`` and
  ``qkvb_attention_bwd.cu``; replaces ``_flat_fwd_kernel`` and
  ``_flat_bwd_kernel``): K10's kernels reading three (B, N, E) tensors in
  place, with the same bits; under grad ``FlatAttention``, whose backward
  returns dq, dk and dv.

``flash_attention_bias_flat`` is the port of ``fedvit_tpu/ops/
flash_attention.py::flash_attention_bias_flat``. On a CPU tensor it runs the
plain ``ops/attention.py::windowed_attention_flat`` under torch autograd; on a
CUDA tensor, with no fallback:

- K5 (``csrc/window_attention.cu::window_attention_fwd``, replaces
  ``_wflat_fwd_kernel``) when no gradient is needed: serving;
- under grad, the ``torch.autograd.Function`` ``WindowAttention``: its forward
  launches K5's log-sum-exp entry (``window_attention_fwd_lse``, replaces
  ``_wflat_fwd_stats_kernel``; it also keeps the output before its rounding,
  in fp32, for the backward's delta) and its backward K6
  (``csrc/window_attention_bwd.cu``; replaces ``_wflat_bwd_kernel``,
  ``_wflat_bwd_stats_kernel`` and ``_wflat_bwd_delta_kernel``), which returns
  dq, dk, dv and the bias gradient. The mask is a constant: one that needs a
  gradient is refused, it never silently gets zeros.

``flash_attention_cosine_flat`` is the port of the JAX function of that name,
SwinV2's scaled-cosine attention on raw q and k (``ops/attention.py::
windowed_cosine_attention_flat`` with a kernel ``impl``). On a CPU tensor it
runs that plain version under torch autograd; on a CUDA tensor K12
(``cosine_window_attention_fwd``, ``_fwd_lse`` and ``_bwd`` in the two
window sources, K5 and K6 compiled with the norm inside; replaces
``_wcos_fwd_kernel`` and ``_wcos_bwd_kernel``), under grad through
``CosineWindowAttention``, whose backward returns dq, dk, dv, the scale's
gradient and the bias's. All windowed kernels take d = 32.

Beside the backward kernels stand their plain versions in the kernels' own
order, which is the TPU kernels' (P and dS rounded to the operands' type
before their products, fp32 sums), taking the kernel entry's inputs:
``flat_attention_bwd_plain`` (K9), ``qkvb_attention_bwd_plain`` (K3, and
K10's with no bias), ``xqkv_attention_bwd_plain`` (K11),
``window_attention_bwd_plain`` (K6) and ``cosine_window_attention_bwd_plain``
(K12). The card holds each backward to them; no model path calls them. The
windowed forward has one too, ``window_attention_fwd_plain`` (K5, and K12's
with its ``scale``): the online softmax over 64-key tiles with the
unnormalised P rounded before P·V, the tensor-core kernel's order.

Each kernel's wrapper counts its launches in its ``launches`` attribute:
``flash_attention_qkvb.launches`` (K1), ``qkvb_attention_lse_cuda.launches``
(K2), ``qkvb_attention_bwd_cuda.launches`` (K3),
``flash_attention_qkv.launches`` (K10), ``qkv_attention_lse_cuda.launches``
(K10 with the log-sum-exp), ``qkv_attention_bwd_cuda.launches`` (K10's
backward), ``flash_attention_xqkv.launches`` (K11),
``xqkv_attention_lse_cuda.launches`` (K11 with the log-sum-exp),
``xqkv_attention_bwd_cuda.launches`` (K11's backward),
``gemm_product.launches`` (one K11 product alone),
``flash_attention_bias_flat.launches`` (K5),
``window_attention_lse_cuda.launches`` (K5 with the log-sum-exp),
``window_attention_bwd_cuda.launches`` (K6), ``flash_attention_flat.launches``
(K9), ``flat_attention_lse_cuda.launches`` (K9 with the log-sum-exp),
``flat_attention_bwd_cuda.launches`` (K9's backward),
``flash_attention_cosine_flat.launches`` (K12),
``cosine_window_attention_lse_cuda.launches`` (K12 with the log-sum-exp),
``cosine_window_attention_bwd_cuda.launches`` (K12's backward).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from fedvit_torch.core import kernels
from fedvit_torch.ops.attention import (COS_EPS, attention_from_qkv,
                                        attention_from_qkvb, attention_from_x,
                                        dot_product_attention_flat,
                                        product_plain,
                                        windowed_attention_flat,
                                        windowed_cosine_attention_flat)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80)       # K1-K3, K10, K11: ViT-Ti/S/B/L d = 64, ViT-H 80
_WINDOW_HEAD_DIMS = (32,)   # K5, K6: every SwinV2 the registry builds has d = 32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("qkvb_attention")
    lib.qkvb_attention_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
    lib.qkvb_attention_fwd_lse.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _F, _P]
    lib.qkv_attention_fwd.argtypes = [_P, _P, _I, _I, _I, _I, _I, _F, _P]
    lib.qkv_attention_fwd_lse.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F,
                                          _P]
    lib.flat_attention_fwd.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
    lib.flat_attention_fwd_lse.argtypes = [_P] * 5 + [_I] * 5 + [_F, _P]
    for name in ("qkvb_attention_fwd", "qkvb_attention_fwd_lse",
                 "qkv_attention_fwd", "qkv_attention_fwd_lse",
                 "flat_attention_fwd", "flat_attention_fwd_lse"):
        getattr(lib, name).restype = _I
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = kernels.load("qkvb_attention_bwd")
    lib.qkvb_attention_bwd.argtypes = [_P] * 9 + [_I] * 5 + [_F, _I, _P]
    lib.qkvb_attention_bwd_workspace_rows.argtypes = [_I, _I]
    lib.qkv_attention_bwd.argtypes = [_P] * 6 + [_I] * 5 + [_F, _P]
    lib.flat_attention_bwd.argtypes = [_P] * 10 + [_I] * 5 + [_F, _P]
    for name in ("qkvb_attention_bwd", "qkvb_attention_bwd_workspace_rows",
                 "qkv_attention_bwd", "flat_attention_bwd"):
        getattr(lib, name).restype = _I
    return lib


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int]:
    """Raise on a packed projection output the kernels do not take; returns
    (B, N, E)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv must be on a CUDA device, got {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported "
                        f"(float32 or bfloat16)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, N, 3E), got {tuple(qkv.shape)}")
    b, n, e3 = qkv.shape
    e = e3 // 3
    if e % num_heads or e // num_heads not in _HEAD_DIMS:
        raise ValueError(f"E={e} with {num_heads} heads: head dim must be one "
                         f"of {_HEAD_DIMS}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    return b, n, e


def _check(qkv: torch.Tensor, bias: torch.Tensor,
           num_heads: int) -> Tuple[int, int, int, torch.Tensor]:
    """Raise on what K1-K3 do not take; returns (B, N, E) and the bias in
    qkv's type."""
    if bias.device != qkv.device:
        raise ValueError(f"qkv and bias must be on one CUDA device, got "
                         f"{qkv.device} and {bias.device}")
    b, n, e = _check_qkv(qkv, num_heads)
    if bias.shape != (3 * e,):
        raise ValueError(f"bias must be ({3 * e},), got {tuple(bias.shape)}")
    bias = bias.to(qkv.dtype).contiguous()
    if bias.data_ptr() % 16:
        raise ValueError("bias must be 16-byte aligned")
    return b, n, e, bias


def _check_saved(ref: torch.Tensor, named) -> None:
    """Raise unless each (name, tensor, shape, dtype) of ``named`` is a
    contiguous, 16-byte aligned tensor of that shape and dtype on ``ref``'s
    device."""
    for name, t, shape, dtype in named:
        if (t.shape != shape or t.dtype != dtype or t.device != ref.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, aligned {shape} "
                             f"{dtype} tensor on {ref.device}")


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, head_dims) -> Tuple[int, int, int]:
    """Raise unless q, k and v are contiguous, 16-byte aligned tensors of one
    (rows, N, E) shape and one dtype the kernels take, on one CUDA device,
    with heads of a width in ``head_dims``; returns (rows, N, E)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must be on one CUDA device, got "
                         f"{q.device}, {k.device} and {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype} and {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share a (rows, N, E) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    rows, n, e = q.shape
    if e % num_heads or e // num_heads not in head_dims:
        raise ValueError(f"E={e} with {num_heads} heads: head dim must be one "
                         f"of {head_dims}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return rows, n, e


def _scale(e: int, num_heads: int) -> float:
    return 1.0 / math.sqrt(e // num_heads)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(rows, N, E) → (rows, H, N, d) fp32."""
    rows, n, e = t.shape
    return t.reshape(rows, n, num_heads, e // num_heads).transpose(1, 2).float()


def _merge(t: torch.Tensor, dtype) -> torch.Tensor:
    """(rows, H, N, d) → (rows, N, E) in ``dtype``."""
    rows, h, n, d = t.shape
    return t.transpose(1, 2).reshape(rows, n, h * d).to(dtype)


def flat_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor,
                             num_heads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K9's backward in the order of the kernels and of
    the TPU kernel (``fedvit_tpu/ops/flash_attention.py::_flat_bwd_kernel``),
    from the kernel entry's inputs: P = exp(s − lse), s = q·kᵀ/√d in fp32;
    delta = Σ dout∘out; dS = P∘(dout·vᵀ − delta) in fp32; P and dS rounded to
    q's dtype before dv = Pᵀ·dout, dq = dS·k/√d and dk = dSᵀ·q/√d, each summed
    in fp32 and rounded once. Returns (dq, dk, dv). The kernels are held to
    it on the card; no model path calls it."""
    dtype = q.dtype
    scale = _scale(q.shape[-1], num_heads)
    qh, kh, vh, oh, gh = (_heads(t, num_heads) for t in (q, k, v, out, dout))
    p = torch.exp(qh @ kh.transpose(-1, -2) * scale - lse[..., None])
    delta = (gh * oh).sum(-1, keepdim=True)
    ds = (p * (gh @ vh.transpose(-1, -2) - delta)).to(dtype).float()
    dv = p.to(dtype).float().transpose(-1, -2) @ gh
    dq = ds @ kh * scale
    dk = ds.transpose(-1, -2) @ qh * scale
    return tuple(_merge(t, dtype) for t in (dq, dk, dv))


def qkvb_attention_bwd_plain(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                             out: torch.Tensor, dout: torch.Tensor,
                             lse: torch.Tensor, num_heads: int
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of K3's backward (``bias`` given) and K10's (None)
    in the kernels' order, from the kernel entry's inputs: the bias cast to
    qkv's dtype and added (one rounding), then ``flat_attention_bwd_plain``
    on the thirds. Returns dqkv and, with a bias, dbias: the fp32 column sums
    of the rounded dqkv."""
    e = qkv.shape[-1] // 3
    x = qkv if bias is None else qkv + bias.to(qkv.dtype)
    dqkv = torch.cat(flat_attention_bwd_plain(
        x[..., :e], x[..., e:2 * e], x[..., 2 * e:], out, dout, lse,
        num_heads), dim=-1)
    return dqkv, None if bias is None else dqkv.float().sum(dim=(0, 1))


def qkvb_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """K1 on (B, N, 3E) ``qkv`` and (3E,) ``bias``; returns a new (B, N, E)
    tensor. Raises on anything it does not take."""
    b, n, e, bias = _check(qkv, bias, num_heads)
    out = torch.empty((b, n, e), dtype=qkv.dtype, device=qkv.device)
    _raise_on(_library().qkvb_attention_fwd(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n, e, num_heads,
        _DTYPES[qkv.dtype], _scale(e, num_heads), _stream(qkv)),
        "qkvb_attention_fwd")
    flash_attention_qkvb.launches += 1
    return out


def qkvb_attention_lse_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                            num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: K1's output, bit for bit, and each row's log-sum-exp of the scaled
    scores, (B, H, N) fp32."""
    b, n, e, bias = _check(qkv, bias, num_heads)
    out = torch.empty((b, n, e), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    _raise_on(_library().qkvb_attention_fwd_lse(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n,
        e, num_heads, _DTYPES[qkv.dtype], _scale(e, num_heads),
        _stream(qkv)), "qkvb_attention_fwd_lse")
    qkvb_attention_lse_cuda.launches += 1
    return out, lse


def qkvb_attention_bwd_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, num_heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dqkv (B, N, 3E) in qkv's type, dbias (3E,) fp32) from the
    forward's inputs, its output and lse, and the output's gradient."""
    b, n, e, bias = _check(qkv, bias, num_heads)
    _check_saved(qkv, (("out", out, (b, n, e), qkv.dtype),
                       ("dout", dout, (b, n, e), qkv.dtype),
                       ("lse", lse, (b, num_heads, n), torch.float32)))
    lib = _bwd_library()
    f32 = dict(dtype=torch.float32, device=qkv.device)
    delta = torch.empty((b, num_heads, n), **f32)
    rows = lib.qkvb_attention_bwd_workspace_rows(b, n)
    partial = torch.empty((rows, 3 * e), **f32)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((3 * e,), **f32)
    _raise_on(lib.qkvb_attention_bwd(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), partial.data_ptr(), dqkv.data_ptr(),
        dbias.data_ptr(), b, n, e, num_heads, _DTYPES[qkv.dtype],
        _scale(e, num_heads), rows, _stream(qkv)),
        "qkvb_attention_bwd")
    qkvb_attention_bwd_cuda.launches += 1
    return dqkv, dbias


class QkvbAttention(torch.autograd.Function):
    """K2 forward, K3 backward. Saves qkv, the bias, the output and the
    log-sum-exp; the bias gradient comes back in the bias's dtype."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads):
        out, lse = qkvb_attention_lse_cuda(qkv, bias, num_heads)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv, dbias = qkvb_attention_bwd_cuda(
            qkv, bias, out, dout.to(qkv.dtype).contiguous(), lse, ctx.num_heads)
        return dqkv, dbias.to(bias.dtype), None


def flash_attention_qkvb(qkv: torch.Tensor, bias: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Attention on the bias-free packed (B, N, 3E) projection output with the
    projection bias (3E,) applied inside the op; returns (B, N, E).

    CPU tensors take the plain version; CUDA tensors the kernels: K2 and K3
    when a gradient is needed, else K1. ``flash_attention_qkvb.launches``
    counts K1's launches."""
    if qkv.device.type == "cpu":
        return attention_from_qkvb(qkv, bias, num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return QkvbAttention.apply(qkv, bias, num_heads)
    return qkvb_attention_cuda(qkv, bias, num_heads)


flash_attention_qkvb.launches = 0
qkvb_attention_lse_cuda.launches = 0
qkvb_attention_bwd_cuda.launches = 0


# --- K10: attention on the packed projection output with its bias ----------

def qkv_attention_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K10 on the packed (B, N, 3E) ``qkv`` (its bias already added); returns
    a new (B, N, E) tensor. Raises on anything it does not take."""
    b, n, e = _check_qkv(qkv, num_heads)
    out = torch.empty((b, n, e), dtype=qkv.dtype, device=qkv.device)
    _raise_on(_library().qkv_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, n, e, num_heads, _DTYPES[qkv.dtype],
        _scale(e, num_heads), _stream(qkv)), "qkv_attention_fwd")
    flash_attention_qkv.launches += 1
    return out


def qkv_attention_lse_cuda(qkv: torch.Tensor, num_heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's output, bit for bit, and each row's log-sum-exp of the scaled
    scores, (B, H, N) fp32."""
    b, n, e = _check_qkv(qkv, num_heads)
    out = torch.empty((b, n, e), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    _raise_on(_library().qkv_attention_fwd_lse(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, e, num_heads,
        _DTYPES[qkv.dtype], _scale(e, num_heads), _stream(qkv)),
        "qkv_attention_fwd_lse")
    qkv_attention_lse_cuda.launches += 1
    return out, lse


def qkv_attention_bwd_cuda(qkv: torch.Tensor, out: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """K10's backward: dqkv (B, N, 3E) in qkv's type and layout from the
    forward's input, its output and lse, and the output's gradient."""
    b, n, e = _check_qkv(qkv, num_heads)
    _check_saved(qkv, (("out", out, (b, n, e), qkv.dtype),
                       ("dout", dout, (b, n, e), qkv.dtype),
                       ("lse", lse, (b, num_heads, n), torch.float32)))
    delta = torch.empty((b, num_heads, n), dtype=torch.float32,
                        device=qkv.device)
    dqkv = torch.empty_like(qkv)
    _raise_on(_bwd_library().qkv_attention_bwd(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), b, n, e, num_heads,
        _DTYPES[qkv.dtype], _scale(e, num_heads), _stream(qkv)),
        "qkv_attention_bwd")
    qkv_attention_bwd_cuda.launches += 1
    return dqkv


class QkvAttention(torch.autograd.Function):
    """K10's log-sum-exp entry forward, K10's backward. Saves qkv, the output
    and the log-sum-exp."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        out, lse = qkv_attention_lse_cuda(qkv, num_heads)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = qkv_attention_bwd_cuda(qkv, out, dout.to(qkv.dtype).contiguous(),
                                      lse, ctx.num_heads)
        return dqkv, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention on the packed (B, N, 3E) projection output, its bias already
    added; returns (B, N, E).

    CPU tensors take the plain version; CUDA tensors the kernels: K10's
    log-sum-exp entry and backward when a gradient is needed, else K10.
    ``flash_attention_qkv.launches`` counts K10's serving launches."""
    if qkv.device.type == "cpu":
        return attention_from_qkv(qkv, num_heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return QkvAttention.apply(qkv, num_heads)
    return qkv_attention_cuda(qkv, num_heads)


flash_attention_qkv.launches = 0
qkv_attention_lse_cuda.launches = 0
qkv_attention_bwd_cuda.launches = 0


# --- K9: attention on flat q, k and v ----------------------------------------

def flat_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """K9 on flat (B, N, E) ``q``, ``k`` and ``v``; returns a new (B, N, E)
    tensor. Raises on anything it does not take."""
    b, n, e = _check_operands(q, k, v, num_heads, _HEAD_DIMS)
    out = torch.empty_like(q)
    _raise_on(_library().flat_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, e,
        num_heads, _DTYPES[q.dtype], _scale(e, num_heads), _stream(q)),
        "flat_attention_fwd")
    flash_attention_flat.launches += 1
    return out


def flat_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's output, bit for bit, and each row's log-sum-exp of the scaled
    scores, (B, H, N) fp32."""
    b, n, e = _check_operands(q, k, v, num_heads, _HEAD_DIMS)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=q.device)
    _raise_on(_library().flat_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, n, e, num_heads, _DTYPES[q.dtype],
        _scale(e, num_heads), _stream(q)), "flat_attention_fwd_lse")
    flat_attention_lse_cuda.launches += 1
    return out, lse


def flat_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, num_heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9's backward: (dq, dk, dv), each (B, N, E) in q's type, from the
    forward's inputs, its output and lse, and the output's gradient."""
    b, n, e = _check_operands(q, k, v, num_heads, _HEAD_DIMS)
    _check_saved(q, (("out", out, (b, n, e), q.dtype),
                     ("dout", dout, (b, n, e), q.dtype),
                     ("lse", lse, (b, num_heads, n), torch.float32)))
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    _raise_on(_bwd_library().flat_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, n, e, num_heads, _DTYPES[q.dtype],
        _scale(e, num_heads), _stream(q)), "flat_attention_bwd")
    flat_attention_bwd_cuda.launches += 1
    return dq, dk, dv


class FlatAttention(torch.autograd.Function):
    """K9's log-sum-exp entry forward, K9's backward. Saves q, k, v, the
    output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        out, lse = flat_attention_lse_cuda(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flat_attention_bwd_cuda(
            q, k, v, out, dout.to(q.dtype).contiguous(), lse, ctx.num_heads)
        return dq, dk, dv, None


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """softmax(q_h·k_hᵀ/√d)·v_h per head on flat (B, N, E) operands, heads
    head-major along E (d = E / num_heads); returns (B, N, E).

    CPU tensors take the plain version; CUDA tensors the kernels: K9's
    log-sum-exp entry and backward when a gradient is needed, else K9.
    ``flash_attention_flat.launches`` counts K9's serving launches."""
    if q.device.type == "cpu":
        return dot_product_attention_flat(q, k, v, num_heads, impl="xla")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlatAttention.apply(q, k, v, num_heads)
    return flat_attention_cuda(q, k, v, num_heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``flash_attention_flat`` on (B, N, H, D) operands → (B, N, H, D): the
    (H, D) dims merge into heads head-major along E, a free reshape of a
    contiguous tensor. Scale 1/√D."""
    b, n, h, d = q.shape
    out = flash_attention_flat(q.reshape(b, n, h * d), k.reshape(b, n, h * d),
                               v.reshape(b, n, h * d), h)
    return out.reshape(b, n, h, d)


flash_attention_flat.launches = 0
flat_attention_lse_cuda.launches = 0
flat_attention_bwd_cuda.launches = 0


# --- K11: the QKV projection and the attention --------------------------------

@functools.cache
def _xqkv_library() -> ctypes.CDLL:
    lib = kernels.load("xqkv_attention")
    lib.xqkv_attention_fwd.argtypes = [_P] * 5 + [_I] * 6 + [_F, _P]
    lib.xqkv_attention_fwd_lse.argtypes = [_P] * 6 + [_I] * 6 + [_F, _P]
    lib.gemm_product.argtypes = [_P, _I, _I, _P, _I, _I, _P, _P] + [_I] * 5 + [_P]
    for name in ("xqkv_attention_fwd", "xqkv_attention_fwd_lse",
                 "gemm_product"):
        getattr(lib, name).restype = _I
    return lib


@functools.cache
def _xqkv_bwd_library() -> ctypes.CDLL:
    lib = kernels.load("xqkv_attention_bwd")
    lib.xqkv_attention_bwd.argtypes = [_P] * 13 + [_I] * 6 + [_F, _I, _P]
    lib.xqkv_attention_bwd_workspace_rows.argtypes = [_I, _I]
    lib.xqkv_attention_bwd.restype = _I
    lib.xqkv_attention_bwd_workspace_rows.restype = _I
    return lib


def _check_x(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             num_heads: int) -> Tuple[int, int, int, int]:
    """Raise on what K11 does not take; returns (B, N, D, E)."""
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w and b must be on one CUDA device, got "
                         f"{x.device}, {w.device} and {b.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"x, w and b must share a dtype of float32 or "
                        f"bfloat16, got {x.dtype}, {w.dtype} and {b.dtype}")
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[-1] or \
            w.shape[1] % 3 or b.shape != (w.shape[1],):
        raise ValueError(f"x must be (B, N, D), w (D, 3E) and b (3E,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")
    bsz, n, dim = x.shape
    e = w.shape[1] // 3
    if e % num_heads or e // num_heads not in _HEAD_DIMS:
        raise ValueError(f"E={e} with {num_heads} heads: head dim must be one "
                         f"of {_HEAD_DIMS}")
    if dim % 8:
        raise ValueError(f"D={dim} must be a multiple of 8")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return bsz, n, dim, e


def _xqkv_forward(x, w, b, num_heads, lse: bool):
    bsz, n, dim, e = _check_x(x, w, b, num_heads)
    qkv = torch.empty((bsz, n, 3 * e), dtype=x.dtype, device=x.device)
    out = torch.empty((bsz, n, e), dtype=x.dtype, device=x.device)
    args = (bsz, n, dim, e, num_heads, _DTYPES[x.dtype], _scale(e, num_heads),
            _stream(x))
    lib = _xqkv_library()
    if not lse:
        _raise_on(lib.xqkv_attention_fwd(x.data_ptr(), w.data_ptr(),
                                         b.data_ptr(), qkv.data_ptr(),
                                         out.data_ptr(), *args),
                  "xqkv_attention_fwd")
        return out, None
    lse_t = torch.empty((bsz, num_heads, n), dtype=torch.float32,
                        device=x.device)
    _raise_on(lib.xqkv_attention_fwd_lse(x.data_ptr(), w.data_ptr(),
                                         b.data_ptr(), qkv.data_ptr(),
                                         out.data_ptr(), lse_t.data_ptr(),
                                         *args), "xqkv_attention_fwd_lse")
    return out, lse_t


def xqkv_attention_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """K11 on x (B, N, D), w (D, 3E) and b (3E,), all of one dtype; returns a
    new (B, N, E) tensor. Raises on anything it does not take."""
    out, _ = _xqkv_forward(x, w, b, num_heads, lse=False)
    flash_attention_xqkv.launches += 1
    return out


def xqkv_attention_lse_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's output, bit for bit, and each row's log-sum-exp of the scaled
    scores, (B, H, N) fp32."""
    out, lse = _xqkv_forward(x, w, b, num_heads, lse=True)
    xqkv_attention_lse_cuda.launches += 1
    return out, lse


def xqkv_attention_bwd_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, num_heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11's backward: (dx (B, N, D), dw (D, 3E), db (3E,)) in x's dtype from
    the forward's inputs, its output and lse, and the output's gradient."""
    bsz, n, dim, e = _check_x(x, w, b, num_heads)
    _check_saved(x, (("out", out, (bsz, n, e), x.dtype),
                     ("dout", dout, (bsz, n, e), x.dtype),
                     ("lse", lse, (bsz, num_heads, n), torch.float32)))
    lib = _xqkv_bwd_library()
    rows = lib.xqkv_attention_bwd_workspace_rows(bsz, n)
    f32 = dict(dtype=torch.float32, device=x.device)
    qkv = torch.empty((bsz, n, 3 * e), dtype=x.dtype, device=x.device)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((bsz, num_heads, n), **f32)
    partial = torch.empty((rows, 3 * e), **f32)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    db = torch.empty((3 * e,), **f32)
    _raise_on(lib.xqkv_attention_bwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), qkv.data_ptr(), dqkv.data_ptr(),
        delta.data_ptr(), partial.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), bsz, n, dim, e, num_heads, _DTYPES[x.dtype],
        _scale(e, num_heads), rows, _stream(x)), "xqkv_attention_bwd")
    xqkv_attention_bwd_cuda.launches += 1
    return dx, dw, db.to(b.dtype)


def xqkv_attention_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor,
                             num_heads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K11's backward in its order: qkv = x·W + b
    recomputed and rounded once, dqkv from ``qkvb_attention_bwd_plain``,
    then dx = dqkv·Wᵀ and dW = xᵀ·dqkv summed in fp32 and rounded once, and
    db the fp32 column sums of dqkv in b's dtype."""
    bsz, n, dim = x.shape
    qkv = product_plain(x, w, b)
    dqkv, _ = qkvb_attention_bwd_plain(qkv, None, out, dout, lse, num_heads)
    flat = dqkv.reshape(bsz * n, -1)
    dx = product_plain(flat, w.t()).reshape(x.shape)
    dw = product_plain(x.reshape(bsz * n, dim).t(), flat)
    return dx, dw, dqkv.float().sum(dim=(0, 1)).to(b.dtype)


class XqkvAttention(torch.autograd.Function):
    """K11's log-sum-exp entry forward, K11's backward. Saves x, w, b, the
    output and the log-sum-exp (qkv is recomputed in the backward)."""

    @staticmethod
    def forward(ctx, x, w, b, num_heads):
        out, lse = xqkv_attention_lse_cuda(x, w, b, num_heads)
        ctx.save_for_backward(x, w, b, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, b, out, lse = ctx.saved_tensors
        dx, dw, db = xqkv_attention_bwd_cuda(
            x, w, b, out, dout.to(x.dtype).contiguous(), lse, ctx.num_heads)
        return dx, dw, db, None


def flash_attention_xqkv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """The QKV projection and attention, attention(x·W + b): x (B, N, D), w
    (D, 3E) packed [Wq | Wk | Wv] with heads head-major within each third
    (the JAX Dense kernel's layout), b (3E,); returns (B, N, E). On the card
    x, w and b share one dtype.

    CPU tensors take the plain version; CUDA tensors the kernels: K11's
    log-sum-exp entry and backward when a gradient is needed, else K11.
    ``flash_attention_xqkv.launches`` counts K11's serving launches."""
    if x.device.type == "cpu":
        return attention_from_x(x, w, b, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return XqkvAttention.apply(x, w, b, num_heads)
    return xqkv_attention_cuda(x, w, b, num_heads)


flash_attention_xqkv.launches = 0
xqkv_attention_lse_cuda.launches = 0
xqkv_attention_bwd_cuda.launches = 0


def gemm_product(a: torch.Tensor, b: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 transpose_a: bool = False,
                 transpose_b: bool = False) -> torch.Tensor:
    """One product of K11's GEMM (``csrc/gemm.cuh``) by itself: op(a)·op(b)
    (+ bias), op(t) = tᵀ when ``transpose_*``, summed in fp32, the fp32 bias
    added and rounded once to a's dtype; returns a new (M, N) tensor. a and b
    are contiguous 2-D tensors read in place, so op(a) is k-contiguous unless
    ``transpose_a`` and op(b) n-contiguous unless ``transpose_b``: K11 makes
    x·W, dqkv·Wᵀ (``transpose_b``) and xᵀ·dqkv (``transpose_a``). For timing
    and tests; the model reaches the kernel through K11.

    CPU tensors take the plain version (``ops/attention.py::product_plain``),
    CUDA tensors the kernel. ``gemm_product.launches`` counts its launches."""
    op_a = a.t() if transpose_a else a
    op_b = b.t() if transpose_b else b
    if a.device.type == "cpu":
        return product_plain(op_a, op_b, bias)
    if b.device != a.device or (bias is not None and bias.device != a.device):
        raise ValueError("a, b and bias must be on one CUDA device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype or (
            bias is not None and bias.dtype != a.dtype):
        raise TypeError(f"a, b and bias must share a dtype of float32 or "
                        f"bfloat16, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or op_a.shape[1] != op_b.shape[0]:
        raise ValueError(f"op(a) (M, K) and op(b) (K, N) do not multiply: "
                         f"{tuple(op_a.shape)} and {tuple(op_b.shape)}")
    m, k = op_a.shape
    n = op_b.shape[1]
    if m % 8 or n % 8 or k % 8:
        raise ValueError(f"M={m}, N={n} and K={k} must be multiples of 8")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _raise_on(_xqkv_library().gemm_product(
        a.data_ptr(), a.shape[1], int(not transpose_a), b.data_ptr(),
        b.shape[1], int(transpose_b), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, m, n, k, _DTYPES[a.dtype], _stream(a)),
        "gemm_product")
    gemm_product.launches += 1
    return out


gemm_product.launches = 0


# --- windowed attention with a bias and a mask (SwinV2) ----------------------

@functools.cache
def _window_library() -> ctypes.CDLL:
    lib = kernels.load("window_attention")
    lib.window_attention_fwd.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.window_attention_fwd_lse.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.cosine_window_attention_fwd.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib.cosine_window_attention_fwd_lse.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    for name in ("window_attention_fwd", "window_attention_fwd_lse",
                 "cosine_window_attention_fwd",
                 "cosine_window_attention_fwd_lse"):
        getattr(lib, name).restype = _I
    return lib


def _check_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, mask: Optional[torch.Tensor],
                  num_heads: int) -> Tuple[int, int, int, int, torch.Tensor,
                                           torch.Tensor]:
    """Raise on what K5 and K6 do not take; returns (W0·B, N, E, W0) and the
    bias and mask as contiguous fp32 (the mask zeros (1, N, N) for None)."""
    if bias.device != q.device or (mask is not None and mask.device != q.device):
        raise ValueError(f"q, bias and mask must be on one CUDA device, got "
                         f"q on {q.device}, bias on {bias.device}")
    rows, n, e = _check_operands(q, k, v, num_heads, _WINDOW_HEAD_DIMS)
    if bias.shape != (num_heads, n, n):
        raise ValueError(f"bias must be ({num_heads}, {n}, {n}), got "
                         f"{tuple(bias.shape)}")
    if mask is None:
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=q.device)
    if mask.dim() != 3 or mask.shape[1:] != (n, n) or rows % mask.shape[0]:
        raise ValueError(f"mask must be (W0, {n}, {n}) with W0 dividing the "
                         f"{rows} rows, got {tuple(mask.shape)}")
    return (rows, n, e, mask.shape[0], bias.float().contiguous(),
            mask.float().contiguous())


def _mask_ptr(mask: Optional[torch.Tensor], checked: torch.Tensor):
    """The mask's pointer for a kernel entry: None (no mask, which the
    kernels read from nowhere) when the caller gave none."""
    return None if mask is None else checked.data_ptr()


def window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          num_heads: int) -> torch.Tensor:
    """K5 on (W0·B, N, E) window-major ``q``, ``k``, ``v``, (H, N, N) ``bias``
    and (W0, N, N) ``mask`` (or None); returns a new (W0·B, N, E) tensor.
    Raises on anything it does not take."""
    rows, n, e, w0, bias, mask_t = _check_window(q, k, v, bias, mask,
                                                 num_heads)
    out = torch.empty_like(q)
    _raise_on(_window_library().window_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _mask_ptr(mask, mask_t), out.data_ptr(), rows, n, e, num_heads, w0,
        _DTYPES[q.dtype], _stream(q)), "window_attention_fwd")
    flash_attention_bias_flat.launches += 1
    return out


def window_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              mask: Optional[torch.Tensor], num_heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K5's output, bit for bit, and what K6 reads: each row's log-sum-exp of
    the biased, masked scores, (W0·B, H, N) fp32, and the output before its
    rounding to q's type, (W0·B, N, E) fp32."""
    rows, n, e, w0, bias, mask_t = _check_window(q, k, v, bias, mask,
                                                 num_heads)
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty((rows, num_heads, n), **f32)
    out32 = torch.empty((rows, n, e), **f32)
    _raise_on(_window_library().window_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _mask_ptr(mask, mask_t), out.data_ptr(), lse.data_ptr(),
        out32.data_ptr(), rows, n, e, num_heads, w0, _DTYPES[q.dtype],
        _stream(q)),
        "window_attention_fwd_lse")
    window_attention_lse_cuda.launches += 1
    return out, lse, out32


@functools.cache
def _window_bwd_library() -> ctypes.CDLL:
    lib = kernels.load("window_attention_bwd")
    lib.window_attention_bwd.argtypes = [_P] * 14 + [_I] * 7 + [_P]
    lib.window_attention_bwd_row_groups.argtypes = [_I] * 6
    lib.window_attention_bwd_max_n.argtypes = []
    lib.cosine_window_attention_bwd.argtypes = [_P] * 17 + [_I] * 8 + [_P]
    lib.cosine_window_attention_bwd_row_groups.argtypes = [_I] * 6
    lib.cosine_window_attention_bwd_max_n.argtypes = []
    for name in ("window_attention_bwd", "window_attention_bwd_row_groups",
                 "window_attention_bwd_max_n", "cosine_window_attention_bwd",
                 "cosine_window_attention_bwd_row_groups",
                 "cosine_window_attention_bwd_max_n"):
        getattr(lib, name).restype = _I
    return lib


def window_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              mask: Optional[torch.Tensor], out32: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor,
                              num_heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """K6: (dq, dk, dv (W0·B, N, E) in q's type, dbias (H, N, N) fp32) from
    the forward's inputs, its unrounded fp32 output and lse
    (``window_attention_lse_cuda``), and the output's gradient. The mask gets
    no gradient; None reaches the kernel as no mask, which reads none."""
    rows, n, e, w0, bias, zeros_or_mask = _check_window(q, k, v, bias, mask,
                                                        num_heads)
    mask_ptr = _mask_ptr(mask, zeros_or_mask)
    for name, t, shape, dtype in (
            ("out32", out32, (rows, n, e), torch.float32),
            ("dout", dout, (rows, n, e), q.dtype),
            ("lse", lse, (rows, num_heads, n), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, aligned {shape} "
                             f"{dtype} tensor on {q.device}")
    lib = _window_bwd_library()
    if n > lib.window_attention_bwd_max_n():
        raise ValueError(f"N={n}: the windowed attention's backward takes at "
                         f"most {lib.window_attention_bwd_max_n()} tokens")
    groups = lib.window_attention_bwd_row_groups(rows, n, e, num_heads, w0,
                                                 _DTYPES[q.dtype])
    if groups < 1:
        raise RuntimeError("window_attention_bwd_row_groups failed")
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((rows, num_heads, n), **f32)
    # fp32: one group of rows writes dbias itself, more write a tile each;
    # bf16 sums dbias in a pass of its own and reads no tiles
    tiles = groups if groups > 1 and q.dtype == torch.float32 else 0
    partial = torch.empty((tiles, num_heads, n, n), **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dbias = torch.empty((num_heads, n, n), **f32)
    _raise_on(lib.window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask_ptr,
        out32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), partial.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dbias.data_ptr(), rows, n, e, num_heads, w0,
        _DTYPES[q.dtype], partial.shape[0], _stream(q)), "window_attention_bwd")
    window_attention_bwd_cuda.launches += 1
    return dq, dk, dv, dbias


def _window_bwd_fp32(q, k, v, bias, mask, out32, dout, lse, num_heads):
    """K6's backward in its order, the gradients of q, k and v unrounded:
    fp32 (dq, dk, dv, dbias)."""
    rows, n, _ = q.shape
    dtype = q.dtype
    if mask is None:
        mask = torch.zeros((1, n, n), dtype=torch.float32, device=q.device)
    add = bias.float()[None] + mask.float()[:, None]      # (W0, H, N, N)
    add = add.repeat_interleave(rows // mask.shape[0], dim=0)
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, dout))
    p = torch.exp(qh @ kh.transpose(-1, -2) + add - lse[..., None])
    delta = (gh * _heads(out32, num_heads)).sum(-1, keepdim=True)
    ds = p * (gh @ vh.transpose(-1, -2) - delta)
    dsr = ds.to(dtype).float()
    dv = p.to(dtype).float().transpose(-1, -2) @ gh
    return dsr @ kh, dsr.transpose(-1, -2) @ qh, dv, ds.sum(dim=0)


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor],
                               out32: torch.Tensor, dout: torch.Tensor,
                               lse: torch.Tensor, num_heads: int
                               ) -> Tuple[torch.Tensor, ...]:
    """The plain version of K6 in the order of the kernel and of the TPU
    kernel (``fedvit_tpu/ops/flash_attention.py::_wflat_bwd_kernel``), from
    the kernel entry's inputs: P = exp(q·kᵀ + (bias + mask) − lse) in fp32;
    delta = Σ dout∘out32; dS = P∘(dout·vᵀ − delta) in fp32; P and dS rounded
    to q's dtype before dv = Pᵀ·dout, dq = dS·k and dk = dSᵀ·q, each summed in
    fp32 and rounded once; dbias = Σ over the rows of the unrounded dS.
    Returns (dq, dk, dv, dbias). The kernel is held to it on the card; no
    model path calls it."""
    dq, dk, dv, dbias = _window_bwd_fp32(q, k, v, bias, mask, out32, dout,
                                         lse, num_heads)
    return (*(_merge(t, q.dtype) for t in (dq, dk, dv)), dbias)


def window_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor], num_heads: int,
                               scale: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The plain version of K5's forward (and, given the per-head ``scale``
    (H,), of K12's) in the order of the tensor-core kernel
    (``csrc/window_attention.cu::window_mma_fwd_kernel``), from the kernel
    entry's inputs: K12 first rounds q̂ = q·(r_q·scale) and k̂ = k·r_k to q's dtype
    (r = 1/max(‖x‖, 1e-6)); scores s = q·kᵀ + (bias + mask) in fp32, the two
    terms summed first; then, over tiles of 64 keys, the online softmax with
    fp32 running max m and sum l, the unnormalised P = exp(s − m) rounded to
    q's dtype before P·V is summed in fp32; out32 = o / l at the end. Returns
    (out32 rounded to q's dtype, lse = m + log l (W0·B, H, N) fp32, out32
    (W0·B, N, E) fp32). The kernel is held to it on the card; no model path
    calls it. In fp32 it is ``windowed_attention_flat`` to fp32 rounding."""
    rows, n, e = q.shape
    dtype = q.dtype
    w0 = 1 if mask is None else mask.shape[0]
    b, d = rows // w0, e // num_heads

    def split(t):    # (W0·B, N, E) → (W0, B, H, N, d) fp32
        return t.reshape(w0, b, n, num_heads, d).transpose(2, 3).float()

    qh, kh, vh = split(q), split(k), split(v)
    if scale is not None:
        def unit(x, mul):
            norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            return (x * (1.0 / torch.clamp(norm, min=COS_EPS) * mul)).to(
                dtype).float()

        qh = unit(qh, scale.float().reshape(1, 1, num_heads, 1, 1))
        kh = unit(kh, 1.0)
    add = bias.float()[None, None]
    if mask is not None:
        add = add + mask.float()[:, None, None]
    m = torch.full(qh.shape[:-1], -math.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for k0 in range(0, n, 64):
        s = qh @ kh[..., k0:k0 + 64, :].transpose(-1, -2) + add[..., k0:k0 + 64]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.to(dtype).float() @ vh[..., k0:k0 + 64, :]
        m = m_new
    out32 = (o / l[..., None]).transpose(2, 3).reshape(rows, n, e)
    lse = (m + torch.log(l)).reshape(rows, num_heads, n)
    return out32.to(dtype), lse, out32


class WindowAttention(torch.autograd.Function):
    """K5's log-sum-exp entry forward, K6 backward. Saves q, k, v, the bias,
    the mask, the unrounded fp32 output and the log-sum-exp; the bias gradient
    comes back in the bias's dtype and the mask gets none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_heads):
        out, lse, out32 = window_attention_lse_cuda(q, k, v, bias, mask,
                                                    num_heads)
        ctx.save_for_backward(q, k, v, bias, mask, out32, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, mask, out32, lse = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd_cuda(
            q, k, v, bias, mask, out32, dout.to(q.dtype).contiguous(), lse,
            ctx.num_heads)
        return dq, dk, dv, dbias.to(bias.dtype), None, None


def flash_attention_bias_flat(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              mask: Optional[torch.Tensor],
                              num_heads: int) -> torch.Tensor:
    """Windowed attention softmax(q_h·k_hᵀ + bias[h] + mask[w])·v_h.

    q, k, v: (W0·B, N, E) window-major flat; bias (H, N, N); mask (W0, N, N)
    additive, or None. The caller folds any score scale into q. The mask is a
    constant: one that needs a gradient raises. CPU tensors take the plain
    version; CUDA tensors the kernels: K5's log-sum-exp entry and K6 when a
    gradient is needed, else K5.
    ``flash_attention_bias_flat.launches`` counts K5's launches."""
    if mask is not None and mask.requires_grad:
        raise ValueError("the mask of flash_attention_bias_flat is a constant "
                         "and gets no gradient; detach it")
    if q.device.type == "cpu":
        return windowed_attention_flat(q, k, v, bias, mask, num_heads)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        return WindowAttention.apply(q, k, v, bias, mask, num_heads)
    return window_attention_cuda(q, k, v, bias, mask, num_heads)


flash_attention_bias_flat.launches = 0
window_attention_lse_cuda.launches = 0
window_attention_bwd_cuda.launches = 0


# --- K12: the scaled-cosine windowed attention (SwinV2) ----------------------

def _check_cosine(q, k, v, scale, bias, mask, num_heads):
    """Raise on what K12 does not take; returns K5's checks and the scale as a
    contiguous fp32 (H,)."""
    checked = _check_window(q, k, v, bias, mask, num_heads)
    if scale.device != q.device or scale.shape != (num_heads,):
        raise ValueError(f"scale must be ({num_heads},) on {q.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    return (*checked, scale.float().contiguous())


def _cosine_forward(q, k, v, scale, bias, mask, num_heads, lse: bool):
    rows, n, e, w0, bias, mask_t, scale = _check_cosine(q, k, v, scale, bias,
                                                        mask, num_heads)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), _mask_ptr(mask, mask_t), out.data_ptr())
    args = (rows, n, e, num_heads, w0, _DTYPES[q.dtype], _stream(q))
    if not lse:
        _raise_on(_window_library().cosine_window_attention_fwd(*ptrs, *args),
                  "cosine_window_attention_fwd")
        return out, None, None
    f32 = dict(dtype=torch.float32, device=q.device)
    lse_t = torch.empty((rows, num_heads, n), **f32)
    out32 = torch.empty((rows, n, e), **f32)
    _raise_on(_window_library().cosine_window_attention_fwd_lse(
        *ptrs, lse_t.data_ptr(), out32.data_ptr(), *args),
        "cosine_window_attention_fwd_lse")
    return out, lse_t, out32


def cosine_window_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, scale: torch.Tensor,
                                 bias: torch.Tensor,
                                 mask: Optional[torch.Tensor],
                                 num_heads: int) -> torch.Tensor:
    """K12 on (W0·B, N, E) window-major RAW ``q``, ``k``, ``v``, the per-head
    ``scale`` (H,), (H, N, N) ``bias`` and (W0, N, N) ``mask`` (or None);
    returns a new (W0·B, N, E) tensor. Raises on anything it does not take."""
    out, _, _ = _cosine_forward(q, k, v, scale, bias, mask, num_heads, False)
    flash_attention_cosine_flat.launches += 1
    return out


def cosine_window_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, scale: torch.Tensor,
                                     bias: torch.Tensor,
                                     mask: Optional[torch.Tensor],
                                     num_heads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """K12's output, bit for bit, and what its backward reads: each row's
    log-sum-exp of the scaled, biased, masked scores, (W0·B, H, N) fp32, and
    the output before its rounding, (W0·B, N, E) fp32."""
    out = _cosine_forward(q, k, v, scale, bias, mask, num_heads, True)
    cosine_window_attention_lse_cuda.launches += 1
    return out


def cosine_window_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, scale: torch.Tensor,
                                     bias: torch.Tensor,
                                     mask: Optional[torch.Tensor],
                                     out32: torch.Tensor, dout: torch.Tensor,
                                     lse: torch.Tensor, num_heads: int
                                     ) -> Tuple[torch.Tensor, ...]:
    """K12's backward: (dq, dk, dv (W0·B, N, E) in q's type, dscale (H,) fp32,
    dbias (H, N, N) fp32) from the forward's inputs, its unrounded fp32
    output and lse (``cosine_window_attention_lse_cuda``), and the output's
    gradient. The mask gets no gradient; None reaches the kernel as no mask,
    which reads none."""
    rows, n, e, w0, bias, zeros_or_mask, scale = _check_cosine(
        q, k, v, scale, bias, mask, num_heads)
    mask_ptr = _mask_ptr(mask, zeros_or_mask)
    _check_saved(q, (("out32", out32, (rows, n, e), torch.float32),
                     ("dout", dout, (rows, n, e), q.dtype),
                     ("lse", lse, (rows, num_heads, n), torch.float32)))
    lib = _window_bwd_library()
    if n > lib.cosine_window_attention_bwd_max_n():
        raise ValueError(f"N={n}: the cosine attention's backward takes at "
                         f"most {lib.cosine_window_attention_bwd_max_n()} tokens")
    groups = lib.cosine_window_attention_bwd_row_groups(
        rows, n, e, num_heads, w0, _DTYPES[q.dtype])
    if groups < 1:
        raise RuntimeError("cosine_window_attention_bwd_row_groups failed")
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((rows, num_heads, n), **f32)
    # fp32: one group of rows writes dbias itself, more write a tile each;
    # bf16 sums dbias in a pass of its own and reads no tiles
    tiles = groups if groups > 1 and q.dtype == torch.float32 else 0
    partial = torch.empty((tiles, num_heads, n, n), **f32)
    scale_partial = torch.empty((num_heads * -(-n // 32) * groups,), **f32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dbias = torch.empty((num_heads, n, n), **f32)
    dscale = torch.empty((num_heads,), **f32)
    _raise_on(lib.cosine_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), mask_ptr, out32.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), partial.data_ptr(),
        scale_partial.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr(), dscale.data_ptr(), rows, n, e, num_heads, w0,
        _DTYPES[q.dtype], partial.shape[0], scale_partial.numel(), _stream(q)),
        "cosine_window_attention_bwd")
    cosine_window_attention_bwd_cuda.launches += 1
    return dq, dk, dv, dscale, dbias


def cosine_window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, scale: torch.Tensor,
                                      bias: torch.Tensor,
                                      mask: Optional[torch.Tensor],
                                      out32: torch.Tensor, dout: torch.Tensor,
                                      lse: torch.Tensor, num_heads: int
                                      ) -> Tuple[torch.Tensor, ...]:
    """The plain version of K12's backward in the kernel's order, from the
    kernel entry's inputs: q̂ = q·(r_q·scale) and k̂ = k·r_k rounded to q's
    dtype (r = 1/max(‖x‖, 1e-6)); K6's backward in its order on them, its
    dq̂ and dk̂ unrounded; then the chain rule through x̂ = x·r,
    dx = mul·r·(dx̂ − [‖x‖ > 1e-6]·x̂·(x̂·dx̂)) with mul = scale for q and 1
    for k, and dscale[h] = Σ q̂·dq̂ over every row. Returns (dq, dk, dv,
    dscale, dbias)."""
    dtype = q.dtype
    sh = scale.float().reshape(1, num_heads, 1, 1)

    def unit(x, mul):
        xh = _heads(x, num_heads)
        norm = torch.linalg.vector_norm(xh, dim=-1, keepdim=True)
        return xh, norm, 1.0 / torch.clamp(norm, min=COS_EPS), mul

    (qh, qnorm, qr, qmul), (kh, knorm, kr, kmul) = unit(q, sh), unit(k, 1.0)
    qn, kn = _merge(qh * (qr * qmul), dtype), _merge(kh * kr, dtype)
    dqn, dkn, dv, dbias = _window_bwd_fp32(qn, kn, v, bias, mask, out32, dout,
                                           lse, num_heads)

    def chain(xh, norm, r, mul, g):
        unit_x = xh * r
        dot = (unit_x * g).sum(-1, keepdim=True)
        radial = torch.where(norm > COS_EPS, g - unit_x * dot, g)
        return mul * r * radial, dot

    dq, qdot = chain(qh, qnorm, qr, qmul, dqn)
    dk, _ = chain(kh, knorm, kr, kmul, dkn)
    return (_merge(dq, dtype), _merge(dk, dtype), _merge(dv, dtype),
            qdot.sum(dim=(0, 2, 3)), dbias)


class CosineWindowAttention(torch.autograd.Function):
    """K12's log-sum-exp entry forward, K12's backward. Saves q, k, v, the
    scale, the bias, the mask, the unrounded fp32 output and the log-sum-exp;
    the scale's and the bias's gradients come back in their dtypes and the
    mask gets none."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bias, mask, num_heads):
        out, lse, out32 = cosine_window_attention_lse_cuda(
            q, k, v, scale, bias, mask, num_heads)
        ctx.save_for_backward(q, k, v, scale, bias, mask, out32, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, scale, bias, mask, out32, lse = ctx.saved_tensors
        dq, dk, dv, dscale, dbias = cosine_window_attention_bwd_cuda(
            q, k, v, scale, bias, mask, out32, dout.to(q.dtype).contiguous(),
            lse, ctx.num_heads)
        return (dq, dk, dv, dscale.to(scale.dtype), dbias.to(bias.dtype), None,
                None)


def flash_attention_cosine_flat(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                num_heads: int) -> torch.Tensor:
    """SwinV2's scaled-cosine windowed attention on RAW operands,
    softmax(scale_h·q̂_h·k̂_hᵀ + bias[h] + mask[w])·v_h with
    x̂ = x / max(‖x‖, 1e-6) per head.

    q, k, v: (W0·B, N, E) window-major flat; scale (H,) and bias (H, N, N)
    get gradients; mask (W0, N, N) additive, or None, is a constant: one that
    needs a gradient raises. CPU tensors take the plain version; CUDA tensors
    the kernels: K12's log-sum-exp entry and backward when a gradient is
    needed, else K12. ``flash_attention_cosine_flat.launches`` counts K12's
    launches."""
    if mask is not None and mask.requires_grad:
        raise ValueError("the mask of flash_attention_cosine_flat is a "
                         "constant and gets no gradient; detach it")
    if q.device.type == "cpu":
        return windowed_cosine_attention_flat(q, k, v, scale, bias, mask,
                                              num_heads, impl="xla")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, scale, bias)):
        return CosineWindowAttention.apply(q, k, v, scale, bias, mask,
                                           num_heads)
    return cosine_window_attention_cuda(q, k, v, scale, bias, mask, num_heads)


flash_attention_cosine_flat.launches = 0
cosine_window_attention_lse_cuda.launches = 0
cosine_window_attention_bwd_cuda.launches = 0
