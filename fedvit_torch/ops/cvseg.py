"""Batched lesion segmentation on the device (``fedvit_tpu/ops/cvseg.py``).

The reference's offline OpenCV pipeline (precompute_masks.py:35-93), in the
JAX package's stage order:

  resize → RGB→LAB L channel → Gaussian blur (σ 5, 41 taps, reflect-101) →
  truncate to int → Otsu (inverted) → circular ROI (r = 0.45·min(h, w)) →
  close ×3, open ×2 (7×7 ellipse) → largest 8-connected component (else a
  centred ellipse) → dilate ×1

Plain PyTorch on tensors, on whatever device the input lies: the JAX
package has no Pallas kernel here (its blur and morphology are
``lax.conv_general_dilated``, so these are ``F.conv1d`` and ``F.conv2d``).
Every stage takes the whole batch on its leading axis, where JAX vmaps one
image: one histogram, one argmax and one component loop for the batch.

- The float stages (the resize and the blur) run in IEEE fp32 whatever the
  process's TF32 settings: where cuDNN may run an fp32 convolution in TF32
  (its flag is on by default) or cuBLAS a product, the inputs round to a
  10-bit mantissa, ~0.1 at L ≈ 255, and the truncation to gray levels turns
  that into a moved Otsu threshold. ``_ieee_fp32`` sets the flags for the
  call and restores them; the 0/1 morphology sums are exact either way.
- Otsu's prefix sums pass 2^24 at a 272² image (73,984 × 255), so their
  float32 rounding depends on the order of summation: ``_cumsum_xla`` adds in
  the order XLA's CPU compiler gives ``jnp.cumsum`` (16-long sequential runs,
  then their carries), and the threshold is JAX's to the bit.
- The component loop runs its sweeps in blocks of ``SWEEP_BLOCKS``, never
  more than JAX's 64 sweeps, and after each block reads which images its
  last sweep changed: an unchanged image is at its fixed point (a sweep
  there changes nothing), so it leaves the working set, as JAX's vmapped
  loop leaves it as it is. The labels are JAX's exactly, a mask still
  unconverged at sweep 64 included, with at most 3 host syncs a batch.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fedvit_torch.ops import image as I

# cv2.getStructuringElement(MORPH_ELLIPSE, (7, 7))
ELLIPSE_7x7 = np.array(
    [[0, 0, 0, 1, 0, 0, 0],
     [0, 1, 1, 1, 1, 1, 0],
     [1, 1, 1, 1, 1, 1, 1],
     [1, 1, 1, 1, 1, 1, 1],
     [1, 1, 1, 1, 1, 1, 1],
     [0, 1, 1, 1, 1, 1, 0],
     [0, 0, 0, 1, 0, 0, 0]], dtype=np.float32)

MAX_SWEEPS = 64          # JAX's cap on the component loop
# sweeps between two host reads of the images still changing: most lesion
# masks converge in 8 or 16, a few run to the cap
SWEEP_BLOCKS = (8, 8, 16, 32)


@contextlib.contextmanager
def _ieee_fp32():
    """cuDNN convolutions and cuBLAS products in IEEE fp32 inside the block
    (no TF32), whatever the process set; its settings come back after."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


# ---------------------------------------------------------------------------
# Color: RGB → LAB L channel (OpenCV formula, L scaled to [0, 255])
# ---------------------------------------------------------------------------

def rgb_to_lab_l(rgb: torch.Tensor) -> torch.Tensor:
    """rgb (…, 3) in [0, 1] → L channel in [0, 255] (cv2.COLOR_BGR2LAB
    scale). torch has no cube root: ``pow(y, 1/3)``, within an ulp or two
    of JAX's ``cbrt``."""
    rgb = rgb.float()
    lin = torch.where(rgb > 0.04045, I.div(rgb + 0.055, 1.055) ** 2.4,
                      I.div(rgb, 12.92))
    y = (0.212671 * lin[..., 0] + 0.715160 * lin[..., 1]
         + 0.072169 * lin[..., 2])
    fy = torch.where(y > 0.008856, torch.pow(y, 1.0 / 3.0),
                     7.787 * y + 16.0 / 116.0)
    return (116.0 * fy - 16.0) * (255.0 / 100.0)


# ---------------------------------------------------------------------------
# Gaussian blur (σ = 5, ksize 41 as cv2 picks for float input, reflect-101)
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float = 5.0,
                  ksize: int = 41) -> torch.Tensor:
    """Separable blur of (B, H, W), rows then columns, in IEEE fp32.
    ``F.pad``'s "reflect" leaves the edge sample out, as ``jnp.pad``'s and
    cv2's reflect-101 do; it needs H, W > ksize // 2."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma, ksize)).to(img.device)
    k = k.view(1, 1, ksize)
    pad = ksize // 2

    def blur_axis(x, axis):
        x = x.movedim(axis, -1)
        shape = x.shape
        xp = F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
        return F.conv1d(xp, k).reshape(shape).movedim(-1, axis)

    with _ieee_fp32():
        return blur_axis(blur_axis(img.float(), 1), 2)


# ---------------------------------------------------------------------------
# Otsu threshold (inverted binary), 256-bin histogram
# ---------------------------------------------------------------------------

_XLA_SCAN_RUN = 16


def _cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, added in the order XLA's CPU
    compiler gives ``jnp.cumsum``: the axis cut into runs of 16, each run
    summed left to right, the runs' totals summed the same way
    (recursively), and each run's carry added to it last."""
    n, run = x.shape[-1], _XLA_SCAN_RUN

    def sequential(v):
        cols = [v[..., 0]]
        for j in range(1, v.shape[-1]):
            cols.append(cols[-1] + v[..., j])
        return torch.stack(cols, dim=-1)

    if n <= run:
        return sequential(x)
    rows = -(-n // run)
    xp = F.pad(x, (0, rows * run - n)).reshape(x.shape[:-1] + (rows, run))
    inner = sequential(xp)
    outer = _cumsum_xla(inner[..., -1])
    carry = F.pad(outer[..., :-1], (1, 0))
    return (inner + carry[..., None]).flatten(-2)[..., :n]


def otsu_threshold(gray: torch.Tensor) -> torch.Tensor:
    """gray (B, H, W) integers in [0, 255] → (B,) int64 Otsu thresholds, the
    first argmax of the between-class variance (cv2), in JAX's formula."""
    b = gray.shape[0]
    flat = gray.reshape(b, -1).long()
    hist = torch.zeros(b, 256, device=gray.device).scatter_add_(
        1, flat, torch.ones(flat.shape, device=gray.device))
    total = hist.sum(-1, keepdim=True)
    bins = torch.arange(256, dtype=torch.float32, device=gray.device)
    w0 = _cumsum_xla(hist)
    w1 = total - w0
    sum0 = _cumsum_xla(hist * bins)
    mu_total = sum0[:, -1:]
    one = torch.ones((), device=gray.device)
    mu0 = sum0 / torch.where(w0 == 0, one, w0)
    mu1 = (mu_total - sum0) / torch.where(w1 == 0, one, w1)
    d = mu0 - mu1
    var_b = w0 * w1 * (d * d)
    var_b = torch.where((w0 == 0) | (w1 == 0), -one, var_b)
    return var_b.argmax(-1)


def otsu_binary_inv(gray: torch.Tensor) -> torch.Tensor:
    """THRESH_BINARY_INV + THRESH_OTSU: gray > t → background, else
    foreground (bool (B, H, W))."""
    return gray <= otsu_threshold(gray).view(-1, 1, 1)


# ---------------------------------------------------------------------------
# Morphology (binary; counts of the structuring element by convolution)
# ---------------------------------------------------------------------------

def _conv2d_same_zero(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """(B, H, W) float SAME cross-correlation with an odd kernel, zero
    border."""
    k = torch.from_numpy(np.ascontiguousarray(kernel, np.float32)).to(x.device)
    return F.conv2d(x[:, None], k[None, None],
                    padding=(kernel.shape[0] // 2, kernel.shape[1] // 2))[:, 0]


def dilate(binary: torch.Tensor, se: np.ndarray = ELLIPSE_7x7,
           iterations: int = 1) -> torch.Tensor:
    """Binary dilation; the border acts as background (cv2's default)."""
    x = binary.float()
    for _ in range(iterations):
        x = (_conv2d_same_zero(x, se) > 0.5).float()
    return x > 0.5


def erode(binary: torch.Tensor, se: np.ndarray = ELLIPSE_7x7,
          iterations: int = 1) -> torch.Tensor:
    """Binary erosion; the border acts as foreground (cv2's default)."""
    inv = 1.0 - binary.float()
    for _ in range(iterations):
        inv = (_conv2d_same_zero(inv, se) > 0.5).float()
    return inv < 0.5


def morph_close(binary, se=ELLIPSE_7x7, iterations: int = 1):
    """cv2 morphologyEx(CLOSE, iterations=n) = dilate ×n, then erode ×n."""
    return erode(dilate(binary, se, iterations), se, iterations)


def morph_open(binary, se=ELLIPSE_7x7, iterations: int = 1):
    """cv2 morphologyEx(OPEN, iterations=n) = erode ×n, then dilate ×n."""
    return dilate(erode(binary, se, iterations), se, iterations)


# ---------------------------------------------------------------------------
# Connected components (8-connectivity) and the largest one
# ---------------------------------------------------------------------------

def _min_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3 minimum of (B, H, W), stride 1. JAX pads with big = h·w, max_pool
    with −∞ (+∞ here): the centre is in every window and no label passes
    big, so the minima are the same."""
    return -F.max_pool2d(-x[:, None], 3, 1, 1)[:, 0]


def propagate_labels(binary: torch.Tensor, max_iters: int = MAX_SWEEPS
                     ) -> Tuple[torch.Tensor, int]:
    """``connected_components``' labels of a (B, H, W) bool batch, and the
    sweeps run: min-label propagation with pointer jumping, ``max_iters``
    sweeps at most, in blocks of ``SWEEP_BLOCKS``. After each block one host
    read finds the images that its last sweep changed; the others are at
    their fixed point and leave the working set. Labels are float32 flat
    indices, exact below 2^24 pixels."""
    b, h, w = binary.shape
    hw = h * w
    if hw >= 2 ** 24:
        raise ValueError(f"{h}x{w} has too many pixels for float32 labels")
    big = torch.full((), float(hw), device=binary.device)
    idx = torch.arange(hw, dtype=torch.float32, device=binary.device)
    lab = torch.where(binary, idx.view(1, h, w), big)

    def sweep(cur, fg):
        new = torch.where(fg, _min_pool_3x3(cur), big)
        flat = new.reshape(-1, hw)
        src = flat.long()
        # pointer jumping: a label ← the label of its own pixel
        jumped = torch.where(src < hw, flat.gather(1, src.clamp(0, hw - 1)),
                             big).view(-1, h, w)
        return torch.where(fg, torch.minimum(new, jumped), big)

    active = torch.arange(b, device=binary.device)
    cur, fg, sweeps = lab, binary, 0
    blocks = iter(SWEEP_BLOCKS)
    while True:
        n = min(next(blocks, SWEEP_BLOCKS[-1]), max_iters - sweeps)
        for _ in range(n - 1):
            cur = sweep(cur, fg)
        last = sweep(cur, fg)
        sweeps += n
        lab.index_copy_(0, active, last)
        if sweeps >= max_iters:
            break
        keep = (last != cur).flatten(1).any(1).nonzero()[:, 0]  # host read
        if keep.numel() == 0:
            break
        active, cur, fg = active[keep], last[keep], fg[keep]
    return lab, sweeps


def connected_components(binary: torch.Tensor,
                         max_iters: int = MAX_SWEEPS) -> torch.Tensor:
    """Labels of the 8-connected components of a (B, H, W) bool batch: int32,
    −1 for background, each component the smallest flat index in it (JAX's
    labels, its 64-sweep cap included)."""
    lab, _ = propagate_labels(binary, max_iters)
    return torch.where(binary, lab.int(), -1)


def largest_component(binary: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The largest 8-connected component of each image, the first label on
    a tie in area: (mask bool (B, H, W), any foreground bool (B,))."""
    b, h, w = binary.shape
    labels = connected_components(binary)
    flat = labels.reshape(b, h * w)
    areas = torch.zeros(b, h * w, device=binary.device).scatter_add_(
        1, flat.clamp(0, h * w - 1).long(), (flat >= 0).float())
    best = areas.argmax(-1)                       # the first maximum
    any_fg = binary.reshape(b, -1).any(-1)
    return (labels == best.view(b, 1, 1)) & any_fg.view(b, 1, 1), any_fg


# ---------------------------------------------------------------------------
# The whole pipeline
# ---------------------------------------------------------------------------

def _circle_mask(h: int, w: int, device) -> torch.Tensor:
    cy, cx = h // 2, w // 2
    r = int(min(h, w) * 0.45)
    yy = torch.arange(h, device=device) - cy
    xx = torch.arange(w, device=device) - cx
    return (yy * yy)[:, None] + (xx * xx)[None, :] <= r * r


def _fallback_ellipse(h: int, w: int, device) -> torch.Tensor:
    cy, cx = h // 2, w // 2
    ay, ax = h // 3, w // 3
    yy = I.div(torch.arange(h, dtype=torch.float32, device=device) - cy,
               float(ay))
    xx = I.div(torch.arange(w, dtype=torch.float32, device=device) - cx,
               float(ax))
    return (yy * yy)[:, None] + (xx * xx)[None, :] <= 1.0


def segment_lesion(rgb: torch.Tensor) -> torch.Tensor:
    """The segmentation of a (B, H, W, 3) batch in [0, 1], already at the
    target size: (B, H, W) bool masks, in the reference's stage order
    (precompute_masks.py:35-93)."""
    h, w = rgb.shape[1], rgb.shape[2]
    blurred = gaussian_blur(rgb_to_lab_l(rgb), 5.0)
    gray = blurred.clamp(0, 255).int()                      # truncates
    binary = otsu_binary_inv(gray) & _circle_mask(h, w, rgb.device)
    binary = morph_close(binary, ELLIPSE_7x7, 3)
    binary = morph_open(binary, ELLIPSE_7x7, 2)
    largest, any_fg = largest_component(binary)
    mask = torch.where(any_fg.view(-1, 1, 1), largest,
                       _fallback_ellipse(h, w, rgb.device))
    return dilate(mask, ELLIPSE_7x7, 1)


def segment_lesion_batch(rgb: torch.Tensor, target_size: int = 224
                         ) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → (B, S, S, 1) float32 masks in {0, 1}, first
    resized to S = ``target_size`` where the size differs (antialiased
    linear, ``jax.image.resize``'s; cv2.INTER_AREA in the reference)."""
    if rgb.shape[1] != target_size or rgb.shape[2] != target_size:
        with _ieee_fp32():
            rgb = I.resize(rgb, (target_size, target_size), method="linear")
    return segment_lesion(rgb).float()[..., None]
