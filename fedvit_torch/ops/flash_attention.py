"""Fused attention on the packed QKV projection, with its backward.

``flash_attention_qkvb`` is the port of ``fedvit_tpu/ops/flash_attention.py::
flash_attention_qkvb``. On a CPU tensor it runs the plain version,
``ops/attention.py::attention_from_qkvb``, under torch autograd; the kernels
are held to it. On a CUDA tensor it launches hand-written kernels, with no
fallback:

- K1 (``csrc/qkvb_attention.cu::qkvb_attention_fwd``, replaces
  ``_qkvb_fwd_kernel``) when no gradient is needed: serving;
- under grad, the ``torch.autograd.Function`` ``QkvbAttention``: its forward
  launches K2 (``qkvb_attention_fwd_lse``, K1 plus each row's log-sum-exp;
  replaces ``_qkvb_fwd_stats_kernel``) and its backward K3
  (``csrc/qkvb_attention_bwd.cu``; replaces ``_qkvb_bwd_kernel``,
  ``_qkvb_bwd_stats_kernel`` and ``_qkvb_bwd_delta_kernel``), which returns
  dqkv and the bias gradient, so the bias-free projection never counts it.

Each kernel's wrapper counts its launches in its ``launches`` attribute:
``flash_attention_qkvb.launches`` (K1), ``qkvb_attention_lse_cuda.launches``
(K2), ``qkvb_attention_bwd_cuda.launches`` (K3).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from fedvit_torch.core import kernels
from fedvit_torch.ops.attention import attention_from_qkvb

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)   # ViT-Ti/S/B/L all have d = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("qkvb_attention")
    lib.qkvb_attention_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
    lib.qkvb_attention_fwd_lse.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _F, _P]
    lib.qkvb_attention_fwd.restype = lib.qkvb_attention_fwd_lse.restype = _I
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = kernels.load("qkvb_attention_bwd")
    lib.qkvb_attention_bwd.argtypes = [_P] * 9 + [_I] * 5 + [_F, _I, _P]
    lib.qkvb_attention_bwd_workspace_rows.argtypes = [_I, _I]
    lib.qkvb_attention_bwd.restype = _I
    lib.qkvb_attention_bwd_workspace_rows.restype = _I
    return lib


def _check(qkv: torch.Tensor, bias: torch.Tensor,
           num_heads: int) -> Tuple[int, int, int, torch.Tensor]:
    """Raise on what the kernels do not take; returns (B, N, E) and the bias
    in qkv's type."""
    if qkv.device.type != "cuda" or bias.device != qkv.device:
        raise ValueError(f"qkv and bias must be on one CUDA device, got "
                         f"{qkv.device} and {bias.device}")
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
    if bias.shape != (e3,):
        raise ValueError(f"bias must be ({e3},), got {tuple(bias.shape)}")
    bias = bias.to(qkv.dtype).contiguous()
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("qkv and bias must be 16-byte aligned")
    return b, n, e, bias


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def qkvb_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """K1 on (B, N, 3E) ``qkv`` and (3E,) ``bias``; returns a new (B, N, E)
    tensor. Raises on anything it does not take."""
    b, n, e, bias = _check(qkv, bias, num_heads)
    out = torch.empty((b, n, e), dtype=qkv.dtype, device=qkv.device)
    _raise_on(_library().qkvb_attention_fwd(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n, e, num_heads,
        _DTYPES[qkv.dtype], 1.0 / math.sqrt(e // num_heads), _stream(qkv)),
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
        e, num_heads, _DTYPES[qkv.dtype], 1.0 / math.sqrt(e // num_heads),
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
    for name, t, shape, dtype in (("out", out, (b, n, e), qkv.dtype),
                                  ("dout", dout, (b, n, e), qkv.dtype),
                                  ("lse", lse, (b, num_heads, n), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != qkv.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, aligned {shape} "
                             f"{dtype} tensor on {qkv.device}")
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
        1.0 / math.sqrt(e // num_heads), rows, _stream(qkv)),
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
