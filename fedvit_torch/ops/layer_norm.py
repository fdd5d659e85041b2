"""LayerNorm with fp32 statistics and a fused backward
(``fedvit_tpu/ops/layer_norm.py``).

The forward is ``layer_norm_fwd``: on a CUDA tensor the hand-written kernel
``csrc/layer_norm_fwd.cu`` (one launch and one pass over the row, where JAX
leaves the forward to XLA's fusion and ``layer_norm_plain`` would launch 14
kernels), on a CPU tensor the plain version ``layer_norm_plain``, which the
kernel is held to on the card.
Rows whose size is a multiple of 4 bytes but not of 16, or whose D is over
2048 (EVA-02-L's SwiGLU norm: D 2,730), up to D 4096, take kernels of their
own (``ln_fwd_ragged_kernel``, ``ln_bwd_ragged_kernel``): the same arithmetic
in 4-byte words; every row the 16-byte kernels take keeps them.
``layer_norm_fwd_cuda.launches`` counts the kernel's launches, the ragged
kernel's among them, and ``layer_norm_fwd_cuda.ragged_launches`` the ragged
kernel's alone (``layer_norm_bwd_cuda``'s two counters likewise). Under grad the
forward runs inside ``LayerNormFn``, a ``torch.autograd.Function`` that saves
only x and the weight (``_ln_fwd_rule``) and whose backward is
``layer_norm_bwd``: on a CUDA tensor the hand-written kernel K4
(``csrc/layer_norm_bwd.cu``, replaces ``_ln_bwd_kernel``), on a CPU tensor
its plain version ``ln_bwd_plain`` (``_ln_bwd_xla``), which K4 is held to on
the card. ``layer_norm_bwd_cuda.launches`` counts K4's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch import nn

from fedvit_torch.core import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LN_MAX_D = 2048   # the forward kernel's largest D, K4's too (kMaxD in both)
_LN_RAGGED_MAX_D = 4096   # the ragged kernels' (ln_ragged::kMaxD)


def _ragged(d: int, element_size: int, *tensors: torch.Tensor) -> bool:
    """Whether rows of D elements of ``element_size`` bytes at ``tensors``
    fit the ragged kernels: a multiple of 4 bytes, D at most 4096, 4-byte
    aligned."""
    return (d * element_size) % 4 == 0 and 0 < d <= _LN_RAGGED_MAX_D and \
        all(t.data_ptr() % 4 == 0 for t in tensors)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6,
                     dtype: torch.dtype = None) -> torch.Tensor:
    """LayerNorm over the last axis: E[x] and E[x²] in one fp32 pass, output
    cast to ``dtype`` (default: x's dtype)."""
    dtype = dtype or x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mu * mu, min=0.0)
    xhat = (x32 - mu) * torch.rsqrt(var + eps)
    return (xhat * weight.float() + bias.float()).to(dtype)


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = kernels.load("layer_norm_fwd")
    lib.layer_norm_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.layer_norm_fwd.restype = ctypes.c_int
    lib.layer_norm_fwd_ragged.argtypes = lib.layer_norm_fwd.argtypes
    lib.layer_norm_fwd_ragged.restype = ctypes.c_int
    return lib


def layer_norm_fwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-6,
                        dtype: torch.dtype = None) -> torch.Tensor:
    """The forward kernel on a CUDA ``x`` (..., D) and the (D,) weight and
    bias: y in ``dtype`` (default: x's dtype) and x's shape; the ragged
    kernel for rows the 16-byte one does not take. Raises on anything
    neither takes."""
    dtype = dtype or x.dtype
    if x.device.type != "cuda" or weight.device != x.device or \
            bias.device != x.device:
        raise ValueError(f"x, weight and bias must be on one CUDA device, got "
                         f"{x.device}, {weight.device} and {bias.device}")
    if x.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"x and the output must be float32 or bfloat16, got "
                        f"{x.dtype} and {dtype}")
    d = x.shape[-1] if x.dim() else 0
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"x {tuple(x.shape)}, weight {tuple(weight.shape)} "
                         f"and bias {tuple(bias.shape)} do not match")
    vec = 16 // x.element_size()
    rows = x.numel() // d if d else 0
    if not 0 < rows < 2 ** 31:
        raise ValueError(f"{rows} rows: the kernel takes 1 to 2^31 - 1")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    w, b = weight.float().contiguous(), bias.float().contiguous()
    if w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("weight and bias must be 16-byte aligned")
    lib = _fwd_library()
    if d % vec == 0 and d <= _LN_MAX_D and x.data_ptr() % 16 == 0:
        entry = lib.layer_norm_fwd
    elif _ragged(d, x.element_size(), x):
        entry = lib.layer_norm_fwd_ragged
    else:
        raise ValueError(
            f"D={d} of {x.dtype}: rows must be a multiple of 4 bytes with D at "
            f"most {_LN_RAGGED_MAX_D} and x 4-byte aligned (a multiple of "
            f"{vec} up to {_LN_MAX_D}, 16-byte aligned, for the 16-byte kernel)")
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    err = entry(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), rows,
        d, _DTYPES[x.dtype], _DTYPES[dtype], eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm_fwd launch failed: CUDA error {err}")
    layer_norm_fwd_cuda.launches += 1
    layer_norm_fwd_cuda.ragged_launches += entry is lib.layer_norm_fwd_ragged
    return y


layer_norm_fwd_cuda.launches = 0
layer_norm_fwd_cuda.ragged_launches = 0


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6, dtype: torch.dtype = None
                   ) -> torch.Tensor:
    """The LayerNorm forward: the kernel on a CUDA tensor,
    ``layer_norm_plain`` on a CPU one."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, dtype)
    return layer_norm_fwd_cuda(x.contiguous(), weight, bias, eps, dtype)


def ln_bwd_plain(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic LayerNorm backward over the last axis, as ``_ln_bwd_xla``:
    (dx in x's dtype and shape, dgamma (D,) fp32, dbeta (D,) fp32)."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    dy32 = dy.reshape(-1, d).float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = xc * r
    g = dy32 * weight.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    dx = (r * (g - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    return dx, (dy32 * xhat).sum(0), dy32.sum(0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("layer_norm_bwd")
    lib.layer_norm_bwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.layer_norm_bwd.restype = ctypes.c_int
    lib.layer_norm_bwd_ragged.argtypes = lib.layer_norm_bwd.argtypes
    lib.layer_norm_bwd_ragged.restype = ctypes.c_int
    for name in ("layer_norm_bwd_max_d", "layer_norm_bwd_workspace_rows",
                 "layer_norm_bwd_ragged_workspace_rows"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def layer_norm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                        dy: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on CUDA ``x`` and ``dy`` (..., D) of one dtype and the (D,)
    weight: (dx in x's dtype, dgamma fp32, dbeta fp32); its ragged pass for
    rows the 16-byte one does not take. Raises on anything neither takes."""
    if x.device.type != "cuda" or dy.device != x.device or \
            weight.device != x.device:
        raise ValueError(f"x, dy and weight must be on one CUDA device, got "
                         f"{x.device}, {dy.device} and {weight.device}")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must share a dtype of float32 or bfloat16, "
                        f"got {x.dtype} and {dy.dtype}")
    d = x.shape[-1]
    if dy.shape != x.shape or weight.shape != (d,):
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)} and "
                         f"weight {tuple(weight.shape)} do not match")
    lib = _library()
    dtype = _DTYPES[x.dtype]
    vec = 16 // x.element_size()
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    max_d = lib.layer_norm_bwd_max_d(dtype)
    rows = x.numel() // d if d else 0
    if d % vec == 0 and d <= max_d and x.data_ptr() % 16 == 0 and \
            dy.data_ptr() % 16 == 0:
        entry, blocks = lib.layer_norm_bwd, lib.layer_norm_bwd_workspace_rows(rows)
    elif _ragged(d, x.element_size(), x, dy) and rows > 0:
        entry = lib.layer_norm_bwd_ragged
        blocks = lib.layer_norm_bwd_ragged_workspace_rows(rows)
    else:
        raise ValueError(
            f"D={d} of {x.dtype}: rows must be a multiple of 4 bytes with D at "
            f"most {_LN_RAGGED_MAX_D} and x and dy 4-byte aligned (a multiple "
            f"of {vec} up to {max_d}, 16-byte aligned, for the 16-byte kernel)")
    w = weight.float().contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    part_g = torch.empty((blocks, d), **f32)
    part_b = torch.empty((blocks, d), **f32)
    dx = torch.empty_like(x)
    dgamma = torch.empty((d,), **f32)
    dbeta = torch.empty((d,), **f32)
    err = entry(
        x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
        part_g.data_ptr(), part_b.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), rows, d, dtype, eps, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm_bwd launch failed: CUDA error {err}")
    layer_norm_bwd_cuda.launches += 1
    layer_norm_bwd_cuda.ragged_launches += entry is lib.layer_norm_bwd_ragged
    return dx, dgamma, dbeta


layer_norm_bwd_cuda.launches = 0
layer_norm_bwd_cuda.ragged_launches = 0


def layer_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LayerNorm backward: K4 on a CUDA tensor, ``ln_bwd_plain`` on a CPU
    one. dy is taken in x's dtype."""
    if x.device.type == "cpu":
        return ln_bwd_plain(x, weight, dy, eps)
    return layer_norm_bwd_cuda(x, weight, dy.to(x.dtype).contiguous(), eps)


class LayerNormFn(torch.autograd.Function):
    """Forward through ``layer_norm_fwd``, backward through
    ``layer_norm_bwd``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return layer_norm_fwd(x, weight, bias, eps, dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, weight, dy, ctx.eps)
        return (dx, dgamma.to(weight.dtype), dbeta.to(ctx.bias_dtype), None,
                None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, dtype: torch.dtype = None) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, output in ``dtype``
    (default: x's dtype); under grad, its backward is the fused one."""
    if torch.is_grad_enabled():
        return LayerNormFn.apply(x, weight, bias, eps, dtype or x.dtype)
    return layer_norm_fwd(x, weight, bias, eps, dtype)


class LayerNorm(nn.Module):
    """timm-named (``weight``/``bias``) LayerNorm, eps 1e-6, fp32 params,
    output in the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps,
                          self.compute_dtype)
