"""Rotary position embeddings on flat q and k: EVA-02's 2-D RoPE.

timm's ``RotaryEmbeddingCat(in_pixels=False)`` with ``apply_rot_embed_cat``,
on the flat (B, N, E) q and k that K9 (``ops/flash_attention.py::
flash_attention_flat``) takes: per head of width d, pairs (2j, 2j + 1)
interleaved along the head, each turned by its token's angle,
y = x·cos + rot(x)·sin with rot(x) = (−x₁, x₀, −x₃, x₂, …). Token 0, the
class token, is not turned; patch token t takes row t − 1 of the table.

``rope_table`` gives the angles' (P, d / 2) cosines and sines in fp32 for a
square grid of P patches: the first d / 4 pairs of a head take the row's
(y) frequencies, the last d / 4 the column's (x), 1 / T^(i / (d/4)) with
positions scaled to the pretraining grid (``ref_grid``). ``rotary_qk``
turns q and k: under grad through ``RotaryQK``, a ``torch.autograd.
Function`` whose backward is the rotation by −θ (the same function with sin
negated), saving nothing but the table. On a CUDA tensor both are the
hand-written kernel (``csrc/rotary.cu``), which raises on what it does not
take; on a CPU tensor the plain version ``rotate_plain``, which the kernel is
held to on the card (the same roundings: the same bits).
``rotary_qk_cuda.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fedvit_torch.core import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rope_table(grid: int, head_dim: int, ref_grid: int,
               temperature: float = 10000.0, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (grid², head_dim / 2) fp32, of the patches of a
    ``grid`` × ``grid`` image in row-major order (timm's
    ``build_rotary_pos_embed`` with ``in_pixels=False`` and
    ``ref_feat_shape`` (ref_grid, ref_grid), before its interleaving)."""
    if head_dim % 4:
        raise ValueError(f"head dim {head_dim} must be a multiple of 4")
    bands = head_dim // 4
    freq = 1.0 / (temperature ** (torch.arange(bands, dtype=torch.float32,
                                               device=device) / bands))
    t = torch.arange(grid, dtype=torch.float32, device=device) / grid * ref_grid
    ty, tx = torch.meshgrid(t, t, indexing="ij")
    ang = torch.cat([ty.reshape(-1, 1) * freq, tx.reshape(-1, 1) * freq], -1)
    return torch.cos(ang), torch.sin(ang)


def rotate_plain(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, N, E) with its patch tokens 1..N−1 turned by the table (N − 1,
    d / 2): y₂ⱼ = x₂ⱼ·c − x₂ⱼ₊₁·s, y₂ⱼ₊₁ = x₂ⱼ₊₁·c + x₂ⱼ·s in fp32 (fp64 for
    fp64 x), rounded once to x's type; token 0 as it is."""
    b, n, e = x.shape
    half = cos.shape[-1]
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = x[:, 1:].to(wide).reshape(b, n - 1, e // (2 * half), half, 2)
    c = cos.to(wide)[:, None, :]
    s = sin.to(wide)[:, None, :]
    x0, x1 = xp[..., 0], xp[..., 1]
    y = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1)
    return torch.cat([x[:, :1], y.reshape(b, n - 1, e).to(x.dtype)], 1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("rotary")
    lib.rotary_qk.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.rotary_qk.restype = ctypes.c_int
    return lib


def rotary_qk_cuda(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, sign: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA (B, N, E) ``q`` and ``k`` of one dtype and the
    (N − 1, d / 2) fp32 table: q and k turned by ``sign``·θ, into new
    tensors. Raises on anything it does not take."""
    if q.device.type != "cuda" or k.device != q.device or \
            cos.device != q.device or sin.device != q.device:
        raise ValueError(f"q, k and the table must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {cos.device}, {sin.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"q and k must share a dtype of float32 or bfloat16, "
                        f"got {q.dtype} and {k.dtype}")
    if q.dim() != 3 or k.shape != q.shape:
        raise ValueError(f"q and k must share a (B, N, E) shape, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, n, e = q.shape
    half = cos.shape[-1] if cos.dim() == 2 else 0
    vec = 16 // q.element_size()
    if cos.shape != (n - 1, half) or sin.shape != cos.shape or \
            cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError(f"the table must be two ({n - 1}, d/2) fp32 tensors, "
                         f"got {tuple(cos.shape)} {cos.dtype} and "
                         f"{tuple(sin.shape)} {sin.dtype}")
    if n < 2 or half == 0 or (2 * half) % vec or e % (2 * half):
        raise ValueError(f"N={n}, E={e}, head dim {2 * half}: the head dim "
                         f"must be a multiple of {vec} dividing E, N at least 2")
    for name, t in (("q", q), ("k", k), ("cos", cos), ("sin", sin)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    err = _library().rotary_qk(
        q.data_ptr(), k.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), b, n, e, half, _DTYPES[q.dtype],
        float(sign), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"rotary_qk launch failed: CUDA error {err}")
    rotary_qk_cuda.launches += 1
    return q_out, k_out


rotary_qk_cuda.launches = 0


def _rotate(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor, sign: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        s = sin if sign > 0 else -sin
        return rotate_plain(q, cos, s), rotate_plain(k, cos, s)
    return rotary_qk_cuda(q.contiguous(), k.contiguous(), cos, sin, sign)


class RotaryQK(torch.autograd.Function):
    """q and k turned by θ; the backward turns dq and dk by −θ."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rotate(q, k, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        dq, dk = _rotate(dq, dk, cos, sin, -1.0)
        return dq, dk, None, None


def rotary_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k (B, N, E), their patch tokens turned by the (N − 1, d / 2)
    table; the class token as it is. The kernel on a CUDA tensor, the plain
    version on a CPU one; under grad through ``RotaryQK``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return RotaryQK.apply(q, k, cos, sin)
    return _rotate(q, k, cos, sin, 1.0)
