"""RandAugment, batched (``fedvit_tpu/ops/randaugment.py``): torchvision's op
space with num_bins 31 (the reference runs n = 3, m = 12):

  Identity, ShearX/Y (±0..0.3), TranslateX/Y (±0..150/331·size px),
  Rotate (±0..30°), Brightness/Color/Contrast/Sharpness (1 ± 0..0.9),
  Posterize (8→4 bits), Solarize (255→0 threshold), AutoContrast, Equalize

The execution model is the JAX package's: each round computes every op once
on the WHOLE batch (with per-sample signs) and a per-sample ``where`` keeps
the op each sample drew. So every round launches the same kernels whatever
the draws: the geometric chain (three row/column shifts, K7 on a CUDA tensor,
through ``ops/row_shift.py``) and ``equalize`` (K8 on a CUDA tensor).

``equalize`` is the port of ``equalize`` :261: on a CUDA tensor it launches
K8 (``csrc/equalize.cu``, replaces ``_eq_kernel``), with no fallback; on a
CPU tensor it runs ``equalize_plain``, the exact formula of ``_equalize_xla``
(:161), which K8 equals bit for bit. ``equalize_cuda.launches`` counts K8's
launches. ``randaugment`` calls ``equalize`` through this module's namespace, so a
run can put the plain version in its place.

Geometry ops use nearest and zero fill (torchvision's defaults). Images are
float32 [0, 1] NHWC.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import torch

from fedvit_torch.core import kernels
from fedvit_torch.ops import row_shift
from fedvit_torch.ops.image import (_bshape, _centred, adjust_brightness,
                                    adjust_contrast, adjust_saturation, div)

NUM_BINS = 31
NUM_OPS = 14


# ---------------------------------------------------------------------------
# Geometry: one parametrised chain of shifts (x-shift → y-shift → x-shift)
# ---------------------------------------------------------------------------

def geometric_chain(img: torch.Tensor, m1: torch.Tensor, t1: torch.Tensor,
                    m2: torch.Tensor, t2: torch.Tensor, m3: torch.Tensor,
                    pad: int) -> torch.Tensor:
    """x-shift(m1·(y−cy) + t1) → y-shift(m2·(x−cx) + t2) → x-shift(m3·(y−cy))
    on a canvas padded by ``pad`` (so that rotation's intermediate shears do
    not clip content that comes back inside). All parameters per sample
    (B,)."""
    b, h, w, _ = img.shape
    big = torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))
    yy = _centred(h + 2 * pad, b, img.device)
    xx = _centred(w + 2 * pad, b, img.device)
    big = row_shift.row_shift(big, m1[:, None] * yy + t1[:, None])
    big = row_shift.col_shift(big, m2[:, None] * xx + t2[:, None])
    big = row_shift.row_shift(big, m3[:, None] * yy)
    return big[:, pad:pad + h, pad:pad + w, :]


def shear_x(img: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Inverse map src_x = x + mag·(y − cy): torchvision's ShearX. mag (B,)."""
    b, h = img.shape[0], img.shape[1]
    return row_shift.row_shift(img, mag[:, None] * _centred(h, b, img.device))


def shear_y(img: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    b, w = img.shape[0], img.shape[2]
    return row_shift.col_shift(img, mag[:, None] * _centred(w, b, img.device))


def translate_x(img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    b, h = img.shape[0], img.shape[1]
    return row_shift.row_shift(img, (-px[:, None]).expand(b, h))


def translate_y(img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    b, w = img.shape[0], img.shape[2]
    return row_shift.col_shift(img, (-px[:, None]).expand(b, w))


def rotate_deg(img: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Per-sample rotation by the Paeth 3-shear: inverse-map factors
    a = −tan(θ/2) on the x-passes, sin θ on the y-pass, on a canvas padded by
    H // 3 (``ops/image.py::rotate``'s nearest path too)."""
    th = torch.deg2rad(deg)
    a = -torch.tan(th / 2.0)
    zero = torch.zeros_like(a)
    return geometric_chain(img, a, zero, torch.sin(th), zero, a,
                           img.shape[1] // 3)


# ---------------------------------------------------------------------------
# Photometric ops (factor: (B,))
# ---------------------------------------------------------------------------

# the blends shared with ColorJitter (ops/image.py)
brightness = adjust_brightness
color = adjust_saturation
contrast = adjust_contrast

_SHARP_W = (1.0 / 13.0, 5.0 / 13.0)   # the 3×3 kernel [[1,1,1],[1,5,1],[1,1,1]]/13


def sharpness(img: torch.Tensor, factor) -> torch.Tensor:
    """torchvision adjust_sharpness: blend with the 3×3 smoothed image, the
    border pixels kept. The smoothing is the kernel's nine fp32 products
    summed over zero-padded shifts of the image (no convolution library, so
    no TF32 on the card)."""
    _, h, w, _ = img.shape
    w1, w5 = (torch.tensor(v, dtype=torch.float32, device=img.device)
              for v in _SHARP_W)
    x = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    sm = None
    for dy in range(3):
        for dx in range(3):
            tap = x[:, dy:dy + h, dx:dx + w] * (w5 if dy == dx == 1 else w1)
            sm = tap if sm is None else sm + tap
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = ((yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))[..., None]
    sm = torch.where(interior, sm, img)
    f = _bshape(factor, img)
    return torch.clamp(f * img + (1.0 - f) * sm, 0.0, 1.0)


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    v = torch.round(img * 255.0).to(torch.int32)
    shift = 8 - int(bits)
    v = (v >> shift) << shift
    return div(v.float(), 255.0)


def solarize(img: torch.Tensor, threshold255: float) -> torch.Tensor:
    return torch.where(img >= threshold255 / 255.0, 1.0 - img, img)


def autocontrast(img: torch.Tensor, _=None) -> torch.Tensor:
    mn = img.amin(dim=(1, 2), keepdim=True)
    mx = img.amax(dim=(1, 2), keepdim=True)
    spread = mx > mn
    one = torch.ones((), dtype=img.dtype, device=img.device)
    scale = torch.where(spread, div(one, torch.where(spread, mx - mn, one)), one)
    out = torch.where(spread, (img - mn) * scale, img)
    return torch.clamp(out, 0.0, 1.0)


def equalize_plain(img: torch.Tensor) -> torch.Tensor:
    """Per-(sample, channel) histogram equalization, the exact formula of
    ``_equalize_xla`` (torchvision's ``_scale_channel``): 256-bin histogram of
    clip(floor(255·x)), the LUT from its cumulative sum, lut[v] / 255; a
    channel whose step is 0 passes through unchanged."""
    b, h, w, c = img.shape
    v = torch.clamp(torch.floor(img * 255.0), 0, 255).long()
    v_flat = v.permute(0, 3, 1, 2).reshape(b * c, h * w)
    hist = torch.zeros(b * c, 256, dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, v_flat, torch.ones_like(v_flat, dtype=torch.float32))
    bins = torch.arange(256, device=img.device)
    last_nz = torch.where(hist > 0, bins, -1).amax(-1, keepdim=True)
    last_val = hist.gather(1, last_nz)[:, 0]
    step = torch.floor(div(float(h * w) - last_val, 255.0))
    cum = torch.cumsum(hist, dim=-1)
    step_safe = torch.where(step == 0, torch.ones_like(step), step)[:, None]
    lut = torch.floor(div(cum + torch.floor(div(step, 2.0))[:, None], step_safe))
    lut = torch.clamp(torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], -1),
                      0, 255)
    out = div(lut.gather(1, v_flat), 255.0)
    out = out.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return torch.where((step == 0).reshape(b, 1, 1, c), img, out)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("equalize")
    lib.equalize_fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.equalize_fwd.restype = ctypes.c_int
    return lib


def equalize_cuda(img: torch.Tensor) -> torch.Tensor:
    """K8 on a contiguous fp32 CUDA ``img`` (B, H, W, C); returns a new
    tensor. Raises on anything it does not take."""
    if img.device.type != "cuda":
        raise ValueError(f"img must be on a CUDA device, got {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"img must be float32, got {img.dtype}")
    if img.dim() != 4 or img.shape[1] * img.shape[2] >= 2 ** 24:
        raise ValueError(f"img must be (B, H, W, C) with H·W < 2^24, got "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    err = _library().equalize_fwd(img.data_ptr(), out.data_ptr(), b, h, w, c,
                                  torch.cuda.current_stream(img.device).cuda_stream)
    if err:
        raise RuntimeError(f"equalize_fwd launch failed: CUDA error {err}")
    equalize_cuda.launches += 1
    return out


equalize_cuda.launches = 0


def equalize(img: torch.Tensor, _=None) -> torch.Tensor:
    """Per-(sample, channel) histogram equalization (torchvision's math): K8
    on a CUDA tensor, ``equalize_plain`` on a CPU one."""
    if img.device.type == "cpu":
        return equalize_plain(img)
    return equalize_cuda(img.contiguous())


# ---------------------------------------------------------------------------
# The RandAugment rounds
# ---------------------------------------------------------------------------

def _magnitudes(magnitude: int, size: int) -> dict:
    frac = magnitude / (NUM_BINS - 1)
    return {
        "shear": 0.3 * frac,
        "translate": (150.0 / 331.0) * size * frac,
        "rotate": 30.0 * frac,
        "enhance": 0.9 * frac,
        "posterize": 8 - round(frac * 4),
        "solarize": 255.0 * (1.0 - frac),
    }


def draw_randaugment(generator: torch.Generator, b: int, num_ops: int = 3
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per round, (op index (B,) uniform over the 14 ops, sign (B,) ±1.0 from
    a fair coin), from ``generator`` on its device (the JAX package's laws)."""
    dev = generator.device
    rounds = []
    for _ in range(num_ops):
        op = torch.randint(0, NUM_OPS, (b,), generator=generator, device=dev)
        heads = torch.rand(b, generator=generator, device=dev) < 0.5
        rounds.append((op, torch.where(heads, 1.0, -1.0)))
    return rounds


def randaugment(img: torch.Tensor,
                rounds: List[Tuple[torch.Tensor, torch.Tensor]],
                magnitude: int = 12) -> torch.Tensor:
    """RandAugment on a batch (B, H, W, C) of [0, 1] floats with the given
    draws (``draw_randaugment``): one round per (op index, sign) pair.

    Channels beyond RGB (e.g. a packed mask) must NOT be passed here — the
    reference applies RandAugment to the image only (data.py:143-144)."""
    size = img.shape[2]
    mags = _magnitudes(magnitude, size)
    rot_pad = max(8, int(math.tan(math.radians(mags["rotate"]) / 2)
                         * (size / 2)) + 2)
    zero = torch.zeros((), device=img.device)
    for op_idx, sign in rounds:
        sign = sign.float()
        enh = 1.0 + sign * mags["enhance"]
        # one geometric chain covers ops 1..5 (identity for the others)
        theta = torch.deg2rad(sign * mags["rotate"])
        a_rot = -torch.tan(theta / 2.0)
        s_rot = torch.sin(theta)
        is_rot = op_idx == 5
        m1 = torch.where(op_idx == 1, sign * mags["shear"],
                         torch.where(is_rot, a_rot, zero))
        t1 = torch.where(op_idx == 3, -sign * mags["translate"], zero)
        m2 = torch.where(op_idx == 2, sign * mags["shear"],
                         torch.where(is_rot, s_rot, zero))
        t2 = torch.where(op_idx == 4, -sign * mags["translate"], zero)
        m3 = torch.where(is_rot, a_rot, zero)
        geo = geometric_chain(img, m1, t1, m2, t2, m3, rot_pad)

        sel = op_idx.reshape(-1, 1, 1, 1)
        out = torch.where((sel >= 1) & (sel <= 5), geo, img)
        for o, cand in (
            (6, brightness(img, enh)),
            (7, color(img, enh)),
            (8, contrast(img, enh)),
            (9, sharpness(img, enh)),
            (10, posterize(img, mags["posterize"])),
            (11, solarize(img, mags["solarize"])),
            (12, autocontrast(img)),
            (13, equalize(img)),
        ):
            out = torch.where(sel == o, cand, out)
        img = out
    return img
