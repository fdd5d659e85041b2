"""Plain reference of the train and eval transforms, one image at a time.

The transforms are the reference classifier's (torchvision semantics on
[0, 1] floats, the mask as a 4th channel that shares the geometry):

    train: RandomResizedCrop (scale 0.7-1, ratio 0.9-1.1; bicubic with the
           Keys kernel a = −0.5, antialiased, for the image; nearest for the
           mask) → horizontal flip → vertical flip → rotation (±30°,
           nearest, zero fill: three shears) → ColorJitter 0.2/0.2/0.2 in a
           random order → RandAugment n 3, m 12 of 30 bins (the image only)
           → normalise (ImageNet statistics; the mask (m − 0.5) / 0.5)
    eval:  resize to int(1.14·size) (bicubic; nearest for the mask) →
           centre crop → normalise

Each image's geometry and arithmetic run on its own, in float64. The random
parameters are drawn from a ``torch.Generator`` by ``draw_train``, batch by
batch, in the order and with the laws the program's batched augment uses, so
that one generator seed gives both the same parameters.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GRAY = (0.2989, 0.587, 0.114)
NUM_OPS = 14          # RandAugment's op space (torchvision, num_bins 31)
BINS = 31


def augment_generator(base: int, i: int, device) -> torch.Generator:
    """The generator of batch ``i`` of an epoch with base ``base``: seeded
    from numpy's SeedSequence of the two numbers."""
    seed = np.random.SeedSequence([base % 2 ** 63, i]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def draw_train(g: torch.Generator, b: int, height: int, width: int,
               recipe: Dict) -> Dict[str, torch.Tensor]:
    """The batch's random parameters: crop boxes (torchvision's ten
    attempts, then the centred fallback), flip coins, the angle, the
    jitter factors and order, and per RandAugment round an op and a sign."""
    dev = g.device
    s0, s1 = recipe["crop_scale"]
    r0, r1 = recipe["crop_ratio"]
    area = float(height * width)
    lr0 = float(np.log(np.float32(r0)))
    lr1 = float(np.log(np.float32(r1)))
    target = area * (s0 + torch.rand(b, 10, generator=g, device=dev) * (s1 - s0))
    aspect = torch.exp(lr0 + torch.rand(b, 10, generator=g, device=dev)
                       * (lr1 - lr0))
    w = torch.round(torch.sqrt(target * aspect))
    h = torch.round(torch.sqrt(target / aspect))
    ok = (w > 0) & (w <= width) & (h > 0) & (h <= height)
    first = ok.int().argmax(-1, keepdim=True)
    w = w.gather(-1, first)[:, 0]
    h = h.gather(-1, first)[:, 0]
    u = torch.rand(b, 2, generator=g, device=dev)
    top = torch.floor(u[:, 0] * (height - h + 1.0))
    left = torch.floor(u[:, 1] * (width - w + 1.0))
    any_ok = ok.any(-1)
    # the fallback: the whole image when its aspect lies in the ratio range
    ratio = width / height
    if ratio < r0:
        fw, fh = float(width), float(np.round(np.float32(width / r0)))
    elif ratio > r1:
        fw, fh = float(np.round(np.float32(height * r1))), float(height)
    else:
        fw, fh = float(width), float(height)
    fi = float(np.round(np.float32((height - fh) / 2.0)))
    fj = float(np.round(np.float32((width - fw) / 2.0)))
    box = torch.stack([torch.where(any_ok, top, fi), torch.where(any_ok, left, fj),
                       torch.where(any_ok, h, fh), torch.where(any_ok, w, fw)], -1)
    out = {"box": box}
    out["hflip"] = torch.rand(b, generator=g, device=dev) < 0.5
    out["vflip"] = torch.rand(b, generator=g, device=dev) < 0.5
    rot = recipe["rotation"]
    out["angle"] = -rot + torch.rand(b, generator=g, device=dev) * (2 * rot)
    factors = []
    for x in recipe["jitter"]:           # brightness, contrast, saturation
        factors.append(max(0.0, 1 - x) + torch.rand(b, generator=g, device=dev)
                       * ((1 + x) - max(0.0, 1 - x)))
    out["jitter"] = torch.stack(factors, -1)
    out["jitter_order"] = torch.rand(b, len(factors), generator=g,
                                     device=dev).argsort(-1)
    ops, signs = [], []
    for _ in range(recipe["randaugment_n"]):
        ops.append(torch.randint(0, NUM_OPS, (b,), generator=g, device=dev))
        signs.append(torch.where(torch.rand(b, generator=g, device=dev) < 0.5,
                                 1.0, -1.0))
    out["ra_op"] = torch.stack(ops, -1)
    out["ra_sign"] = torch.stack(signs, -1)
    return out


# ---------------------------------------------------------------------------
# One image: (H, W, C) float64
# ---------------------------------------------------------------------------

def keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = −0.5 at |x|."""
    x = x.abs()
    near = (1.5 * x - 2.5) * x * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far,
                                                  torch.zeros_like(x)))


def cubic_matrix(in_size: int, out_size: int, start: float, extent: float,
                 device) -> torch.Tensor:
    """(out, in) weights mapping the window [start, start + extent) of an
    axis onto ``out_size`` samples: output o samples the input at
    (o + 0.5)·extent/out + start − 0.5, the kernel widened by extent/out
    when that exceeds 1 (antialias), weights normalised to sum 1, and an
    output whose sample point lies outside the input left at 0."""
    inv = extent / out_size
    widen = max(inv, 1.0)
    o = torch.arange(out_size, dtype=torch.float64, device=device)
    pos = (o + 0.5) * inv + start - 0.5
    k = torch.arange(in_size, dtype=torch.float64, device=device)
    wt = keys_cubic((pos[:, None] - k[None, :]) / widen)
    total = wt.sum(1, keepdim=True)
    wt = torch.where(total.abs() > 1000 * 1.1920929e-07, wt / total,
                     torch.zeros_like(wt))
    inside = (pos >= -0.5) & (pos <= in_size - 0.5)
    return wt * inside[:, None]


def resample(img: torch.Tensor, my: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    return torch.einsum("oh,hwc,pw->opc", my, img, mx)


def nearest_indices(out_size: int, start: float, extent: float, limit: int,
                    device) -> torch.Tensor:
    o = torch.arange(out_size, dtype=torch.float64, device=device) + 0.5
    return torch.floor(o * extent / out_size + start).long().clamp(0, limit - 1)


def shift_rows(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[y, x] = img[y, x + s[y]], zero where that leaves the image."""
    h, w, c = img.shape
    src = torch.arange(w, device=img.device)[None, :] + s[:, None]
    inside = (src >= 0) & (src < w)
    out = torch.gather(img, 1, src.clamp(0, w - 1)[..., None].expand(h, w, c))
    return out * inside[..., None]


def shift_cols(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[y, x] = img[y + s[x], x]."""
    return shift_rows(img.transpose(0, 1), s).transpose(0, 1)


def rounded(v: torch.Tensor) -> torch.Tensor:
    """Round half to even, as integer shifts."""
    return torch.round(v).long()


def centred(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float64, device=device) - (n - 1) / 2.0


def three_shears(img: torch.Tensor, degrees: float, pad: int) -> torch.Tensor:
    """Rotation about the centre by ``degrees`` counter-clockwise with
    nearest sampling and zero fill, as three shears (rows by
    −tan(θ/2)·(y − cy), columns by sin θ·(x − cx), rows again) on the image
    padded by ``pad``."""
    h, w, _ = img.shape
    th = math.radians(degrees)
    a, s = -math.tan(th / 2.0), math.sin(th)
    big = torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))
    yy = centred(h + 2 * pad, img.device)
    xx = centred(w + 2 * pad, img.device)
    big = shift_rows(big, rounded(a * yy))
    big = shift_cols(big, rounded(s * xx))
    big = shift_rows(big, rounded(a * yy))
    return big[pad:pad + h, pad:pad + w]


def gray(img: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(GRAY, dtype=img.dtype, device=img.device)
    return (img[..., :3] * w).sum(-1, keepdim=True)


def blend(img: torch.Tensor, other, f: float) -> torch.Tensor:
    return torch.clamp(f * img + (1.0 - f) * other, 0.0, 1.0)


def brightness(img, f):
    return torch.clamp(img * f, 0.0, 1.0)


def saturation(img, f):
    return blend(img, gray(img), f)


def contrast(img, f):
    return blend(img, gray(img).mean(), f)


def sharpness(img: torch.Tensor, f: float) -> torch.Tensor:
    """Blend with the image smoothed by [[1,1,1],[1,5,1],[1,1,1]]/13, the
    border pixels of the smoothed image being the image's own."""
    h, w, _ = img.shape
    pad = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    sm = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            sm = sm + pad[dy:dy + h, dx:dx + w] * ((5.0 if dy == dx == 1 else 1.0)
                                                  / 13.0)
    sm[0], sm[-1], sm[:, 0], sm[:, -1] = img[0], img[-1], img[:, 0], img[:, -1]
    return blend(img, sm, f)


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    v = torch.round(img * 255.0).long()
    return ((v >> (8 - bits)) << (8 - bits)).to(img.dtype) / 255.0


def solarize(img: torch.Tensor, threshold: float) -> torch.Tensor:
    return torch.where(img >= threshold, 1.0 - img, img)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    lo = img.amin((0, 1), keepdim=True)
    hi = img.amax((0, 1), keepdim=True)
    spread = hi > lo
    out = (img - lo) / torch.where(spread, hi - lo, torch.ones_like(hi))
    return torch.clamp(torch.where(spread, out, img), 0.0, 1.0)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Histogram equalisation of each channel (torchvision's
    ``_scale_channel``): the look-up table from the cumulative histogram of
    floor(255·x), a channel whose step is 0 left as it is."""
    h, w, c = img.shape
    out = img.clone()
    for ch in range(c):
        v = torch.clamp(torch.floor(img[..., ch] * 255.0), 0, 255).long().reshape(-1)
        hist = torch.bincount(v, minlength=256).to(torch.float64)
        last = int(torch.nonzero(hist).max())
        step = math.floor((h * w - float(hist[last])) / 255.0)
        if step == 0:
            continue
        lut = torch.floor((torch.cumsum(hist, 0) + step // 2) / step)
        lut = torch.clamp(torch.cat([lut.new_zeros(1), lut[:-1]]), 0, 255)
        out[..., ch] = (lut[v] / 255.0).reshape(h, w)
    return out


def magnitudes(m: int, size: int) -> Dict[str, float]:
    frac = m / (BINS - 1)
    return {"shear": 0.3 * frac, "translate": 150.0 / 331.0 * size * frac,
            "rotate": 30.0 * frac, "enhance": 0.9 * frac,
            "posterize": 8 - round(frac * 4), "solarize": 1.0 - frac}


def randaugment_op(img: torch.Tensor, op: int, sign: float, m: int) -> torch.Tensor:
    """One RandAugment op on an RGB image of side ``size``: identity, shear
    x / y, translate x / y, rotate, brightness, color, contrast, sharpness,
    posterize, solarize, autocontrast, equalize (torchvision's order)."""
    size = img.shape[1]
    mag = magnitudes(m, size)
    h, w, _ = img.shape
    if op == 1:
        return shift_rows(img, rounded(sign * mag["shear"] * centred(h, img.device)))
    if op == 2:
        return shift_cols(img, rounded(sign * mag["shear"] * centred(w, img.device)))
    if op in (3, 4):
        s = rounded(torch.full((h if op == 3 else w,), -sign * mag["translate"],
                               dtype=torch.float64, device=img.device))
        return shift_rows(img, s) if op == 3 else shift_cols(img, s)
    if op == 5:
        pad = max(8, int(math.tan(math.radians(mag["rotate"]) / 2)
                         * (size / 2)) + 2)
        return three_shears(img, sign * mag["rotate"], pad)
    enh = 1.0 + sign * mag["enhance"]
    if op == 6:
        return brightness(img, enh)
    if op == 7:
        return saturation(img, enh)
    if op == 8:
        return contrast(img, enh)
    if op == 9:
        return sharpness(img, enh)
    if op == 10:
        return posterize(img, mag["posterize"])
    if op == 11:
        return solarize(img, mag["solarize"])
    if op == 12:
        return autocontrast(img)
    if op == 13:
        return equalize(img)
    return img


def normalise(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(STD, dtype=img.dtype, device=img.device)
    return torch.cat([(img - mean) / std, (mask - 0.5) / 0.5], -1)


def train_image(canvas: torch.Tensor, d: Dict[str, torch.Tensor], k: int,
                size: int, recipe: Dict) -> torch.Tensor:
    """Image ``k`` of a batch: its uint8 canvas (H, W, 4) and the batch's
    draws ``d`` → (size, size, 4) float64, normalised."""
    x = canvas.to(torch.float64) / 255.0
    img, mask = x[..., :3], x[..., 3:4]
    ch, cw = x.shape[:2]
    top, left, bh, bw = (float(v) for v in d["box"][k])
    img = torch.clamp(resample(img, cubic_matrix(ch, size, top, bh, x.device),
                               cubic_matrix(cw, size, left, bw, x.device)), 0, 1)
    ys = nearest_indices(size, top, bh, ch, x.device)
    xs = nearest_indices(size, left, bw, cw, x.device)
    mask = mask[ys][:, xs]
    both = torch.cat([img, mask], -1)
    if bool(d["hflip"][k]):
        both = both.flip(1)
    if bool(d["vflip"][k]):
        both = both.flip(0)
    both = three_shears(both, float(d["angle"][k]), size // 3)
    img, mask = both[..., :3], both[..., 3:]
    ops = (brightness, contrast, saturation)
    for which in d["jitter_order"][k].tolist():
        img = ops[which](img, float(d["jitter"][k, which]))
    for op, sign in zip(d["ra_op"][k].tolist(), d["ra_sign"][k].tolist()):
        img = randaugment_op(img, op, sign, recipe["randaugment_m"])
    return normalise(img, mask)


def train_batch(canvases: torch.Tensor, g: torch.Generator, size: int,
                recipe: Dict) -> torch.Tensor:
    """A batch of uint8 canvases (B, H, W, 4) through the train transform
    with parameters drawn from ``g``: (B, size, size, 4) float32."""
    b, h, w, _ = canvases.shape
    d = draw_train(g, b, h, w, recipe)
    return torch.stack([train_image(canvases[k], d, k, size, recipe)
                        for k in range(b)]).float()


def eval_image(canvas: torch.Tensor, size: int) -> torch.Tensor:
    x = canvas.to(torch.float64) / 255.0
    img, mask = x[..., :3], x[..., 3:4]
    h, w = x.shape[:2]
    rs = int(size * 1.14)
    img = torch.clamp(resample(img, cubic_matrix(h, rs, 0.0, h, x.device),
                               cubic_matrix(w, rs, 0.0, w, x.device)), 0, 1)
    ys = nearest_indices(rs, 0.0, h, h, x.device)
    xs = nearest_indices(rs, 0.0, w, w, x.device)
    mask = mask[ys][:, xs]
    t = (rs - size) // 2
    return normalise(img[t:t + size, t:t + size], mask[t:t + size, t:t + size])


def eval_batch(canvases: torch.Tensor, size: int) -> torch.Tensor:
    return torch.stack([eval_image(c, size) for c in canvases]).float()


def recipe_of(train_aug: Dict) -> Dict:
    """The transform's parameters from a configuration's
    ``augmentation.train`` section."""
    cj = train_aug["color_jitter"]
    if cj.get("hue", 0.0):
        raise ValueError("the reference's jitter has no hue step")
    return {"crop_scale": tuple(train_aug["random_resized_crop"]["scale"]),
            "crop_ratio": tuple(train_aug["random_resized_crop"]["ratio"]),
            "rotation": float(train_aug["rotation"]),
            "jitter": (cj["brightness"], cj["contrast"], cj["saturation"]),
            "randaugment_n": int(train_aug["randaugment"]["n"]),
            "randaugment_m": int(train_aug["randaugment"]["m"])}
