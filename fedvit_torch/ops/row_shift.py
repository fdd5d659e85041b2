"""Row and column shifts with zero fill — the geometry of the on-device train
augment (``fedvit_tpu/ops/row_shift.py``).

Every geometric op of the augment (rotation by the Paeth 3-shear, RandAugment's
shear and translate) is a shift of each row along W, or of each column along H,
by its own rounded amount:

    row_shift: out[b, y, x] = img[b, y, x + s[b, y]]
    col_shift: out[b, y, x] = img[b, y + s[b, x], x]

with s = clip(round(shift), ±extent) (round half to even, as ``jnp.round``)
and 0 where the source lies outside the image.

On a CUDA tensor both launch K7 (``csrc/row_shift.cu``, replaces
``_row_shift_kernel`` and ``_col_shift_kernel``), with no fallback; on a CPU
tensor they run the plain versions ``row_shift_plain`` and
``col_shift_plain`` (the counterparts of ``_row_shift_xla`` and
``_col_shift_xla``), which K7 equals bit for bit. ``shift_cuda.launches``
counts K7's launches. Callers reach these functions through this module
(``row_shift.row_shift``), so that a run can put the plain versions in their
place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fedvit_torch.core import kernels

_P, _I = ctypes.c_void_p, ctypes.c_int


def _shift_amount(shift: torch.Tensor, extent: int) -> torch.Tensor:
    """clip(round(shift), −extent, extent) as int32; ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(shift.float()), -extent, extent).to(torch.int32)


def _shifted(img: torch.Tensor, s: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain shift by integer amounts ``s``: a gather along ``axis`` (2
    for rows, 1 for columns) at index + s, zero where that leaves the image."""
    b, h, w, c = img.shape
    if axis == 2:
        src = torch.arange(w, device=img.device).view(1, 1, w) + s.view(b, h, 1)
        extent = w
    else:
        src = torch.arange(h, device=img.device).view(1, h, 1) + s.view(b, 1, w)
        extent = h
    inside = (src >= 0) & (src < extent)
    idx = src.clamp(0, extent - 1).unsqueeze(-1).expand(b, h, w, c)
    return torch.where(inside.unsqueeze(-1), torch.gather(img, axis, idx),
                       torch.zeros((), dtype=img.dtype, device=img.device))


def row_shift_plain(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); shift (B, H) float → each row moved by its rounded
    shift (``_row_shift_xla``)."""
    return _shifted(img, _shift_amount(shift, img.shape[2]), 2)


def col_shift_plain(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); shift (B, W) float → each column moved by its
    rounded shift (``_col_shift_xla``)."""
    return _shifted(img, _shift_amount(shift, img.shape[1]), 1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("row_shift")
    lib.shift_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.shift_fwd.restype = _I
    return lib


def shift_cuda(img: torch.Tensor, s: torch.Tensor, axis: int) -> torch.Tensor:
    """K7 on a contiguous fp32 CUDA ``img`` (B, H, W, C) and int32 shifts
    ``s``, already rounded and clipped: (B, H) for rows (``axis`` 2) or
    (B, W) for columns (``axis`` 1). Returns a new tensor; raises on
    anything it does not take."""
    if img.device.type != "cuda" or s.device != img.device:
        raise ValueError(f"img and shifts must be on one CUDA device, got "
                         f"{img.device} and {s.device}")
    if img.dtype != torch.float32 or s.dtype != torch.int32:
        raise TypeError(f"img must be float32 and shifts int32, got {img.dtype} "
                        f"and {s.dtype}")
    if img.dim() != 4 or axis not in (1, 2):
        raise ValueError(f"img must be (B, H, W, C) and axis 1 or 2, got "
                         f"{tuple(img.shape)} and {axis}")
    b, h, w, c = img.shape
    want = (b, h) if axis == 2 else (b, w)
    if tuple(s.shape) != want:
        raise ValueError(f"shifts must be {want}, got {tuple(s.shape)}")
    if not (img.is_contiguous() and s.is_contiguous()):
        raise ValueError("img and shifts must be contiguous")
    out = torch.empty_like(img)
    err = _library().shift_fwd(img.data_ptr(), s.data_ptr(), out.data_ptr(),
                               b, h, w, c, 0 if axis == 2 else 1,
                               torch.cuda.current_stream(img.device).cuda_stream)
    if err:
        raise RuntimeError(f"shift_fwd launch failed: CUDA error {err}")
    shift_cuda.launches += 1
    return out


shift_cuda.launches = 0


def row_shift(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) fp32; shift (B, H) float → out[b, y, x] =
    img[b, y, x + s[b, y]], zero fill: K7 on CUDA, the plain version on the
    CPU."""
    if img.device.type == "cpu":
        return row_shift_plain(img, shift)
    return shift_cuda(img.contiguous(), _shift_amount(shift, img.shape[2]), 2)


def col_shift(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) fp32; shift (B, W) float → out[b, y, x] =
    img[b, y + s[b, x], x], zero fill: K7 on CUDA, the plain version on the
    CPU."""
    if img.device.type == "cpu":
        return col_shift_plain(img, shift)
    return shift_cuda(img.contiguous(), _shift_amount(shift, img.shape[1]), 1)
