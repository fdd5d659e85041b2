"""Batched on-device image ops (``fedvit_tpu/ops/image.py``): the eval
transform and TTA views for serving, and the train transform.

NHWC float32 in [0, 1], every op batched over the leading axis, on whatever
device the input lies. ``resize`` reproduces ``jax.image.resize``: bicubic
with the Keys kernel (a = -0.5), or linear with the triangle kernel, the
kernel widened by 1/scale when downsampling (antialias), weights normalised
per output sample and samples whose centre falls outside the input dropped.
The weights depend only on the sizes, so they are built once in numpy and
applied as two matmuls, rows then columns. (``F.interpolate``'s bicubic uses
a = -0.75, other edge rules and no antialias, and does not match.) ``crop_and_resize`` does the same per
sample, for the RandomResizedCrop of training: its (B, out, in) weights are
built on the device in ``jax.image.scale_and_translate``'s order of
operations and applied as two batched matmuls.

The train transform (reference TrainTransform, data.py:82-155) is split into
its draws and its arithmetic. ``draw_train`` draws every random parameter of
a batch from one ``torch.Generator`` on the batch's device, with the laws of
the JAX package's draws (which come from a JAX key and cannot be shared);
``train_transform`` applies given draws. The geometry (rotation here,
shear/translate/rotate in ``ops/randaugment.py``) is one chain of row and
column shifts (``ops/row_shift.py``, K7 on a CUDA tensor).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from fedvit_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD


def to_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → float32 [0, 1] (other dtypes are cast to float32)."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b, correctly rounded on every device. (A CUDA tensor divided by a
    Python number is multiplied by the number's reciprocal instead, one ulp
    off at times; JAX divides.)"""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """Channel-wise (x − mean) / std (reference data.py:150)."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def normalize_mask(mask: torch.Tensor) -> torch.Tensor:
    """(x − .5) / .5 (reference data.py:153-154)."""
    return (mask - 0.5) / 0.5


_F32 = np.float32
_EPS_GUARD = 1000.0 * float(np.finfo(np.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = −0.5) of |x|, in x's fp32, JAX's order."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros((), device=x.device), out)


def _weight_mat(in_size: int, out_size: int, kernel) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix of ``jax.image.resize``
    (``jax/_src/image/scale.py::compute_weight_mat`` with zero translation,
    antialias on) for ``kernel`` of |x|, in float32 in JAX's order of
    operations."""
    inv = 1.0 / (out_size / in_size)
    kernel_scale = _F32(max(inv, 1.0))
    sample = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(inv) - _F32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=_F32)[:, None])
    w = kernel(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=_F32)
    w = np.where(np.abs(total) > _EPS_GUARD,
                 w / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, _F32(0.0)).T
                                ).astype(_F32)


@functools.lru_cache(maxsize=32)
def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """The cubic method's matrix. It is computed in float32 in JAX's order:
    the Keys polynomial cancels near |x| = 2, so a float64 matrix differs
    from JAX's by ~3e-5."""
    return _weight_mat(in_size, out_size,
                       lambda x: _keys_cubic(torch.from_numpy(x)).numpy())


@functools.lru_cache(maxsize=32)
def linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """The linear method's matrix: the triangle kernel max(0, 1 − |x|)."""
    return _weight_mat(in_size, out_size,
                       lambda x: np.maximum(_F32(0.0), _F32(1.0) - x))


@functools.lru_cache(maxsize=32)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output sample, ``jax.image.resize``'s nearest
    rule: floor((o + 0.5) · in / out), in float32."""
    o = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    return np.floor(o * np.float32(in_size) / np.float32(out_size)
                    ).astype(np.int64)


def resize(img: torch.Tensor, size: Tuple[int, int],
           method: str = "cubic") -> torch.Tensor:
    """Batched NHWC resize, method "cubic" (bicubic), "linear" (both
    antialiased, as ``jax.image.resize``) or "nearest"; a spatial dim whose
    size does not change is left as it is, as in JAX."""
    _, h, w, _ = img.shape
    oh, ow = size
    if method == "nearest":
        if oh != h:
            img = img[:, torch.from_numpy(nearest_indices(h, oh)).to(img.device)]
        if ow != w:
            img = img[:, :, torch.from_numpy(nearest_indices(w, ow)).to(img.device)]
        return img
    weights = {"cubic": cubic_weights, "linear": linear_weights}.get(method)
    if weights is None:
        raise ValueError(f"resize method must be 'cubic', 'linear' or "
                         f"'nearest', got {method!r}")
    img = img.float()
    if oh != h:
        wh = torch.from_numpy(weights(h, oh)).to(img.device)
        img = torch.einsum("oh,bhwc->bowc", wh, img)
    if ow != w:
        ww = torch.from_numpy(weights(w, ow)).to(img.device)
        img = torch.einsum("pw,bhwc->bhpc", ww, img)
    return img


def center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    h, w = img.shape[1], img.shape[2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[:, top:top + size, left:left + size, :]


def hflip(img: torch.Tensor) -> torch.Tensor:
    return img.flip(2)


def vflip(img: torch.Tensor) -> torch.Tensor:
    return img.flip(1)


def rot90k(img: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate by k·90° counter-clockwise (``jnp.rot90`` over axes (1, 2))."""
    return torch.rot90(img, k, dims=(1, 2))


def _bshape(factor, img: torch.Tensor):
    """A per-sample (B,) factor broadcast to the image's rank; a number or a
    0-dim tensor as it is."""
    if not isinstance(factor, torch.Tensor) or factor.dim() == 0:
        return factor
    return factor.reshape((-1,) + (1,) * (img.dim() - 1))


# ---------------------------------------------------------------------------
# Per-sample crop-and-resize (the RandomResizedCrop engine)
# ---------------------------------------------------------------------------

def scale_translate_weights(in_size: int, out_size: int, start: torch.Tensor,
                            extent: torch.Tensor) -> torch.Tensor:
    """(B, out_size, in_size) fp32 cubic weights that map each sample's
    window [start, start + extent) of the input axis onto ``out_size``
    outputs: ``jax.image.scale_and_translate``'s ``compute_weight_mat`` with
    scale out/extent and translation −start·scale, antialias on, in its
    order of operations (sample_f = (o + 0.5)·inv − t·inv − 0.5, the 1000·eps
    guard on the weight sum, and the mask −0.5 ≤ sample_f ≤ in − 0.5)."""
    scale = div(torch.full_like(extent, float(out_size)), extent)
    translation = -start * scale
    inv = div(torch.ones_like(scale), scale)
    kernel_scale = torch.clamp(inv, min=1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=start.device)
    sample = ((o[None] + 0.5) * inv[:, None] - (translation * inv)[:, None]) - 0.5
    k = torch.arange(in_size, dtype=torch.float32, device=start.device)
    x = div((sample[:, :, None] - k[None, None]).abs(), kernel_scale[:, None, None])
    w = _keys_cubic(x)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > _EPS_GUARD,
                    div(w, torch.where(total != 0, total, torch.ones_like(total))),
                    torch.zeros((), device=w.device))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros((), device=w.device))


def crop_and_resize(img: torch.Tensor, boxes: torch.Tensor, out_size: int,
                    method: str = "cubic") -> torch.Tensor:
    """Crop per-sample boxes (i, j, h, w) (B, 4) float and resize each to
    (out_size, out_size), ``fedvit_tpu``'s ``crop_and_resize``.

    "cubic": ``jax.image.scale_and_translate`` with antialias, output o maps
    to input (o + 0.5)/s + start − 0.5 with s = out/extent (torchvision's
    resized_crop mapping), as two batched matmuls in fp32 (rows, then
    columns). "nearest": src = clip(floor((o + 0.5)·extent/out + start)), the
    PIL convention, as a gather."""
    b, height, width, c = img.shape
    boxes = boxes.float()
    i, j, h, w = boxes.unbind(-1)
    if method == "nearest":
        o = torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5
        ys = torch.floor(div(o[None] * h[:, None], float(out_size)) + i[:, None])
        xs = torch.floor(div(o[None] * w[:, None], float(out_size)) + j[:, None])
        ys = ys.long().clamp(0, height - 1)
        xs = xs.long().clamp(0, width - 1)
        bi = torch.arange(b, device=img.device)[:, None, None]
        return img[bi, ys[:, :, None], xs[:, None, :]]
    if method != "cubic":
        raise ValueError(f"method must be 'cubic' or 'nearest', got {method!r}")
    wy = scale_translate_weights(height, out_size, i, h)        # (B, out, H)
    wx = scale_translate_weights(width, out_size, j, w)         # (B, out, W)
    rows = torch.bmm(wy, img.float().reshape(b, height, width * c))
    rows = rows.reshape(b, out_size, width, c).permute(0, 2, 1, 3)
    out = torch.bmm(wx, rows.reshape(b, width, out_size * c))   # (B, out_x, out_y·C)
    return out.reshape(b, out_size, out_size, c).permute(0, 2, 1, 3).contiguous()


def random_resized_crop_params(generator: torch.Generator, batch: int,
                               height: int, width: int,
                               scale: Tuple[float, float] = (0.7, 1.0),
                               ratio: Tuple[float, float] = (0.9, 1.1)
                               ) -> torch.Tensor:
    """(B, 4) float32 boxes (i, j, h, w) drawn with torchvision's algorithm
    (RandomResizedCrop.get_params: 10 attempts, then the centre fallback),
    from ``generator`` on its device, as the JAX package draws them."""
    dev = generator.device
    area = float(height * width)
    lr0, lr1 = float(np.log(np.float32(ratio[0]))), float(np.log(np.float32(ratio[1])))
    u = torch.rand(batch, 10, generator=generator, device=dev)
    target_area = area * (scale[0] + u * (scale[1] - scale[0]))
    u = torch.rand(batch, 10, generator=generator, device=dev)
    aspect = torch.exp(lr0 + u * (lr1 - lr0))
    w = torch.round(torch.sqrt(target_area * aspect))
    h = torch.round(torch.sqrt(div(target_area, aspect)))
    valid = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    idx = valid.int().argmax(-1, keepdim=True)            # first valid attempt
    any_valid = valid.any(-1)
    w_sel, h_sel = w.gather(-1, idx)[:, 0], h.gather(-1, idx)[:, 0]
    u_ij = torch.rand(batch, 2, generator=generator, device=dev)
    i_sel = torch.floor(u_ij[:, 0] * (height - h_sel + 1.0))
    j_sel = torch.floor(u_ij[:, 1] * (width - w_sel + 1.0))
    # fallback: clamp the aspect, centre crop (torchvision's fallback branch)
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w_fb, h_fb = float(width), float(np.round(np.float32(width / ratio[0])))
    elif in_ratio > ratio[1]:
        w_fb, h_fb = float(np.round(np.float32(height * ratio[1]))), float(height)
    else:
        w_fb, h_fb = float(width), float(height)
    i_fb = float(np.round(np.float32((height - h_fb) / 2.0)))
    j_fb = float(np.round(np.float32((width - w_fb) / 2.0)))

    def pick(sel, fb):
        return torch.where(any_valid, sel, torch.full_like(sel, fb))

    return torch.stack([pick(i_sel, i_fb), pick(j_sel, j_fb),
                        pick(h_sel, h_fb), pick(w_sel, w_fb)], dim=-1)


# ---------------------------------------------------------------------------
# Arbitrary-angle rotation (nearest, zero fill — TF.rotate defaults)
# ---------------------------------------------------------------------------

def _centred(n: int, b: int, device) -> torch.Tensor:
    """(B, n) fp32 coordinates of n pixels about their centre: k − (n − 1)/2."""
    return (torch.arange(n, dtype=torch.float32, device=device)
            - (n - 1) / 2.0).expand(b, n)


def rotate(img: torch.Tensor, angles_deg: torch.Tensor,
           method: str = "nearest") -> torch.Tensor:
    """Rotate each sample by its own angle (degrees, counter-clockwise as
    PIL) about the image centre, zero fill; method "nearest" or "bilinear".

    "nearest" is the Paeth 3-shear (``ops/randaugment.py::rotate_deg``): a
    row shift by −tan(θ/2)·(y − cy), a column shift by sin(θ)·(x − cx), the
    row shift again, on a canvas padded by H // 3 (three K7 launches on a
    CUDA tensor). "bilinear" is the exact inverse map, four gathers."""
    b, h, w, c = img.shape
    if method == "nearest":
        from fedvit_torch.ops.randaugment import rotate_deg
        return rotate_deg(img, angles_deg.float())
    if method != "bilinear":
        raise ValueError(f"method must be 'nearest' or 'bilinear', got {method!r}")
    theta = torch.deg2rad(angles_deg.float())
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    src_x = cos * xx[None] - sin * yy[None] + cx
    src_y = sin * xx[None] + cos * yy[None] + cy
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    dx, dy = src_x - x0, src_y - y0
    bi = torch.arange(b, device=img.device)[:, None, None]
    out = torch.zeros_like(img)
    for oy, ox, wgt in ((0, 0, (1 - dy) * (1 - dx)), (0, 1, (1 - dy) * dx),
                        (1, 0, dy * (1 - dx)), (1, 1, dy * dx)):
        xi = (x0 + ox).long()
        yi = (y0 + oy).long()
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = img[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        out = out + vals * (wgt * inb)[..., None]
    return out


# ---------------------------------------------------------------------------
# Photometric ops (torchvision functional semantics, [0, 1] floats); a factor
# is a number or one per sample (B,)
# ---------------------------------------------------------------------------

_GRAY_W = (0.2989, 0.587, 0.114)   # ITU-R 601-2 (PIL "L")


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """(…, 3) → (…, 1), PIL/torchvision luma weights; extra channels
    ignored."""
    wgt = torch.tensor(_GRAY_W, dtype=torch.float32, device=img.device)
    return (img[..., :3] * wgt).sum(-1, keepdim=True)


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * _bshape(factor, img), 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the mean of the grayscale image (torchvision: the mean
    over the whole image of rgb_to_grayscale)."""
    factor = _bshape(factor, img)
    mean = grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(factor * img + (1 - factor) * mean, 0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    factor = _bshape(factor, img)
    return torch.clamp(factor * img + (1 - factor) * grayscale(img), 0.0, 1.0)


def adjust_hue(img: torch.Tensor, factor) -> torch.Tensor:
    """Hue shift by ``factor`` (in turns, [−0.5, 0.5]) via HSV."""
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0:1] + _bshape(factor, img), 1.0)
    return hsv_to_rgb(torch.cat([h, hsv[..., 1:]], dim=-1))


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    one = torch.ones((), dtype=rgb.dtype, device=rgb.device)
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    safe = torch.where(d == 0, one, d)
    h = div(torch.where(mx == r, torch.remainder(div(g - b, safe), 6.0),
                        torch.where(mx == g, div(b - r, safe) + 2.0,
                                    div(r - g, safe) + 4.0)), 6.0)
    h = torch.where(d == 0, zero, h)
    s = torch.where(mx == 0, zero, div(d, torch.where(mx == 0, one, mx)))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6).clamp(0, 5).unsqueeze(-1)

    def choose(*cands):
        return torch.stack(cands, dim=-1).gather(-1, i)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def color_jitter(img: torch.Tensor, factors: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter with per-sample factors AND per-sample op order
    (the reference applies it per item, each with its own order).

    ``factors`` (B, n): brightness, contrast, saturation [, hue] (n = 4 when
    hue jitter is on); ``order`` (B, n) int, each row a permutation of
    range(n). Each of the n steps computes all n ops on the whole batch and
    keeps, per sample, the one its order names."""
    ops = [adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue]
    n = factors.shape[1]
    for step in range(n):
        which = order[:, step].reshape((-1,) + (1,) * (img.dim() - 1))
        out = img
        for i in range(n):
            out = torch.where(which == i, ops[i](img, factors[:, i]), out)
        img = out
    return img


def draw_color_jitter(generator: torch.Generator, b: int,
                      brightness: float = 0.2, contrast: float = 0.2,
                      saturation: float = 0.2, hue: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(factors (B, n), order (B, n)) for ``color_jitter``, JAX's laws: each
    enhance factor U(max(0, 1 − x), 1 + x) (1 when x = 0), the hue shift
    U(−hue, hue) (n = 4 only when hue > 0), the order an argsort of uniforms."""
    dev = generator.device

    def uniform(lo, hi):
        return lo + torch.rand(b, generator=generator, device=dev) * (hi - lo)

    cols = [uniform(max(0.0, 1 - x), 1 + x) if x > 0
            else torch.ones(b, device=dev)
            for x in (brightness, contrast, saturation)]
    if hue > 0:
        cols.append(uniform(-hue, hue))
    order = torch.rand(b, len(cols), generator=generator, device=dev).argsort(-1)
    return torch.stack(cols, dim=-1), order


# ---------------------------------------------------------------------------
# The train transform (reference TrainTransform, data.py:82-155)
# ---------------------------------------------------------------------------

@dataclass
class TrainDraws:
    """Every random parameter of one batch's train transform; None where the
    step is off.

    boxes (B, 4) crop boxes (i, j, h, w); hflip, vflip (B,) bool; angles (B,)
    degrees; jitter (factors, order) of ``color_jitter``; randaugment a list
    of (op index (B,) int, sign (B,) ±1.0), one per round."""
    boxes: torch.Tensor
    hflip: Optional[torch.Tensor] = None
    vflip: Optional[torch.Tensor] = None
    angles: Optional[torch.Tensor] = None
    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    randaugment: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


def draw_train(generator: torch.Generator, b: int, height: int, width: int,
               scale=(0.7, 1.0), ratio=(0.9, 1.1), do_hflip: bool = True,
               do_vflip: bool = True, rotation: float = 30.0,
               cj=(0.2, 0.2, 0.2, 0.0), randaugment_n: int = 3) -> TrainDraws:
    """The draws of ``train_transform`` for a batch of ``b`` images of
    ``height`` × ``width``, from ``generator`` on its device, with the laws
    of ``fedvit_tpu``'s train_transform: the crop boxes, a fair coin for each
    flip, the angle U(−rotation, rotation), ColorJitter's factors and order,
    and per RandAugment round an op U{0..13} and a fair sign."""
    from fedvit_torch.ops.randaugment import draw_randaugment
    dev = generator.device

    def coin():
        return torch.rand(b, generator=generator, device=dev) < 0.5

    draws = TrainDraws(
        boxes=random_resized_crop_params(generator, b, height, width,
                                         scale, ratio))
    if do_hflip:
        draws.hflip = coin()
    if do_vflip:
        draws.vflip = coin()
    if rotation > 0:
        draws.angles = -rotation + torch.rand(
            b, generator=generator, device=dev) * (2 * rotation)
    if any(x > 0 for x in cj):
        draws.jitter = draw_color_jitter(generator, b, *cj)
    if randaugment_n > 0:
        draws.randaugment = draw_randaugment(generator, b, randaugment_n)
    return draws


def train_transform(img: torch.Tensor, mask: Optional[torch.Tensor],
                    draws: TrainDraws, out_size: int = 384,
                    randaugment_m: int = 12):
    """The reference TrainTransform on a batch, with the given draws:
    RandomResizedCrop (bicubic, clipped; nearest for the mask) → HFlip →
    VFlip → rotation (nearest, zero fill; image and mask as one 4-channel
    rotation) → ColorJitter (image only) → RandAugment (image only) →
    normalize (ImageNet stats; mask (x − .5)/.5).

    img (B, H, W, 3) in [0, 1]; mask (B, H, W, 1) or None, sharing the
    geometry. Returns (img', mask')."""
    img = torch.clamp(crop_and_resize(img, draws.boxes, out_size, "cubic"),
                      0.0, 1.0)
    if mask is not None:
        mask = crop_and_resize(mask, draws.boxes, out_size, "nearest")
    for sel, flip in ((draws.hflip, hflip), (draws.vflip, vflip)):
        if sel is not None:
            sel = sel.reshape(-1, 1, 1, 1)
            img = torch.where(sel, flip(img), img)
            if mask is not None:
                mask = torch.where(sel, flip(mask), mask)
    if draws.angles is not None:
        if mask is not None:
            packed = rotate(torch.cat([img, mask], dim=-1), draws.angles)
            img, mask = packed[..., :3], packed[..., 3:]
        else:
            img = rotate(img, draws.angles)
    if draws.jitter is not None:
        img = color_jitter(img, *draws.jitter)
    if draws.randaugment:
        from fedvit_torch.ops.randaugment import randaugment
        img = randaugment(img, draws.randaugment, randaugment_m)
    img = normalize(img)
    if mask is not None:
        mask = normalize_mask(mask)
    return img, mask


# ---------------------------------------------------------------------------
# Eval transform and TTA views
# ---------------------------------------------------------------------------

def eval_transform(img: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   out_size: int = 384):
    """Resize to 1.14·size (bicubic; nearest for the mask) → CenterCrop(size)
    → normalize (reference data.py:162-182)."""
    rs = int(out_size * 1.14)
    img = torch.clamp(resize(img, (rs, rs), "cubic"), 0.0, 1.0)
    img = normalize(center_crop(img, out_size))
    if mask is not None:
        mask = normalize_mask(
            center_crop(resize(mask, (rs, rs), "nearest"), out_size))
    return img, mask


def tta_views(img: torch.Tensor, mask: Optional[torch.Tensor] = None,
              out_size: int = 384):
    """The 8 deterministic TTA views (reference data.py:241-336), stacked on
    a new axis 1: original, hflip, vflip, rot90, rot180, rot270, brightness
    ×1.15, ×0.85. Each view is built from the raw image, then goes through
    ``eval_transform``. Returns (B, 8, S, S, C) [, (B, 8, S, S, 1)]."""
    pairs = [(img, mask),
             (hflip(img), None if mask is None else hflip(mask)),
             (vflip(img), None if mask is None else vflip(mask))]
    pairs += [(rot90k(img, k), None if mask is None else rot90k(mask, k))
              for k in (1, 2, 3)]
    pairs += [(adjust_brightness(img, 1.15), mask),
              (adjust_brightness(img, 0.85), mask)]
    out = [eval_transform(i, m, out_size) for i, m in pairs]
    views = torch.stack([i for i, _ in out], dim=1)
    mviews = None if mask is None else torch.stack([m for _, m in out], dim=1)
    return views, mviews


def tta_views_named(img: torch.Tensor, names, out_size: int = 384
                    ) -> torch.Tensor:
    """The old generation's named TTA views (reference data_old.py:208-304):
    a cubic resize to 1.14·size clipped to [0, 1], then per name:
    ``original``, ``hflip`` and ``vflip`` of the centre crop, ``crop_tl`` and
    ``crop_br`` the corners of the resized image, ``crop_center`` (and any
    unknown name) the centre crop. Returns (B, len(names), S, S, C),
    normalised."""
    rs = int(out_size * 1.14)
    big = torch.clamp(resize(img, (rs, rs), "cubic"), 0.0, 1.0)
    center = center_crop(big, out_size)
    views = []
    for name in names:
        if name == "hflip":
            v = hflip(center)
        elif name == "vflip":
            v = vflip(center)
        elif name == "crop_tl":
            v = big[:, :out_size, :out_size, :]
        elif name == "crop_br":
            v = big[:, -out_size:, -out_size:, :]
        else:
            v = center
        views.append(normalize(v))
    return torch.stack(views, dim=1)
