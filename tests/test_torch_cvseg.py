"""The port's lesion segmenter (``fedvit_torch/ops/cvseg.py``) against the
JAX package's (``fedvit_tpu/ops/cvseg.py``), stage by stage, on the CPU.

Each stage gets the JAX stage's own input, so the integer stages are
compared bit for bit. The JAX stages run under ``jit(vmap(...))``, as in
``segment_lesion_batch``. Tolerances:

- ``rgb_to_lab_l`` atol 1e-4 on [0, 255]: ``pow(y, 1/3)`` for ``cbrt`` and
  ``pow(x, 2.4)`` differ from XLA's by an ulp or two (3e-5 seen);
- the blur atol 1e-3: two 41-tap convolutions summed in other orders (1e-4
  seen);
- the Otsu threshold: the same, or one step off only where JAX's
  between-class variance at the two bins ties within float32 rounding
  (4 ulps). The port adds the prefix sums in XLA's order, so the
  thresholds have been equal in every case, those past 2^24 included;
- morphology, components, the largest component, the circle and the
  fallback ellipse: bit for bit;
- ``segment_lesion_batch``: at least 0.999 of each image's pixels equal,
  and every pixel where the two packages' gray levels agree for the whole
  image (a gray level truncated the other way can move the threshold);
- the linear antialiased ``resize``: atol 1e-5 (two fp32 matmuls against
  ``jax.image.resize``'s contraction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.ops import cvseg as T
from fedvit_torch.ops import image as TI
from fedvit_tpu.ops import cvseg as J

SE = J.ELLIPSE_7x7


def lesions(b, size, seed):
    """(b, size, size, 3) float32 in [0, 1]: dark soft-edged ellipses with a
    wavy border over skin tones, with pixel noise."""
    rng = np.random.default_rng(seed)
    out = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(b):
        cy, cx = rng.uniform(0.35, 0.65, 2) * size
        ry, rx = rng.uniform(0.12, 0.3, 2) * size
        a = rng.uniform(0, np.pi)
        u = ((xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)) / rx
        v = ((yy - cy) * np.cos(a) - (xx - cx) * np.sin(a)) / ry
        wave = 0.15 * np.sin(rng.uniform(2, 6) * np.arctan2(v, u))
        lesion = 1 / (1 + np.exp(np.clip(8 * (u * u + v * v + wave - 1),
                                         -30, 30)))
        skin = rng.uniform((0.75, 0.55, 0.45), (0.95, 0.75, 0.65))
        pigment = rng.uniform((0.2, 0.1, 0.1), (0.6, 0.4, 0.35))
        img = (skin * (1 - lesion[..., None]) + pigment * lesion[..., None]
               + rng.normal(0, 0.03, (size, size, 3)))
        out.append(np.clip(img, 0, 1))
    return np.stack(out).astype(np.float32)


def jit_vmap(fn):
    return jax.jit(jax.vmap(fn))


def gray_levels(x):
    """JAX's gray levels of a batch: L, blur, truncation."""
    blurred = J.gaussian_blur(jax.vmap(J.rgb_to_lab_l)(jnp.asarray(x)), 5.0)
    return np.asarray(jnp.clip(blurred, 0, 255).astype(jnp.int32))


def jax_binaries(x):
    """JAX's Otsu foreground inside the circle, after the morphology."""
    def stages(gray):
        h, w = gray.shape
        b = J.otsu_binary_inv(gray) & J._circle_mask(h, w)
        return J.morph_open(J.morph_close(b, SE, 3), SE, 2)
    return np.array(jit_vmap(stages)(jnp.asarray(gray_levels(x))))


def test_rgb_to_lab_l_matches_jax():
    x = lesions(3, 40, seed=1)
    x[0, :4, :4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.04045, 0.01, 0.5],
                    [0.02, 0.03, 0.04]]                  # both branches
    want = np.asarray(jit_vmap(J.rgb_to_lab_l)(jnp.asarray(x)))
    got = T.rgb_to_lab_l(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 33, 50)],
                         ids=["64", "33x50"])
def test_gaussian_blur_matches_jax(shape):
    x = np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax.jit(J.gaussian_blur)(jnp.asarray(x)))
    got = T.gaussian_blur(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_float_stages_leave_the_tf32_settings_as_they_were():
    before = (torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with T._ieee_fp32():
            inside = (torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        T.gaussian_blur(torch.zeros(1, 24, 24))
        after = (torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    assert inside == (False, "highest")
    assert after == (True, "high")


def _otsu_jax_var_b(gray):
    """JAX's between-class variance, as ``otsu_threshold`` computes it."""
    hist = jax.ops.segment_sum(jnp.ones(gray.size, jnp.float32),
                               gray.reshape(-1), num_segments=256)
    bins = jnp.arange(256, dtype=jnp.float32)
    w0 = jnp.cumsum(hist)
    w1 = hist.sum() - w0
    sum0 = jnp.cumsum(hist * bins)
    mu0 = sum0 / jnp.where(w0 == 0, 1.0, w0)
    mu1 = (sum0[-1] - sum0) / jnp.where(w1 == 0, 1.0, w1)
    var_b = w0 * w1 * (mu0 - mu1) ** 2
    return jnp.where((w0 == 0) | (w1 == 0), -1.0, var_b), sum0[-1]


def bimodal(b, size, seed):
    """Gray levels from two seeded modes: a lesion's (dark, a sixteenth of
    the pixels) and bright skin's, bright enough that the histogram's
    weighted sum passes 2^24 at 272²."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        n = size * size
        lo = rng.normal(rng.uniform(60, 140), rng.uniform(8, 25), n // 16)
        hi = rng.normal(rng.uniform(240, 252), rng.uniform(2, 6), n - n // 16)
        g = np.clip(np.concatenate([lo, hi]), 0, 255).astype(np.int32)
        rng.shuffle(g)
        out.append(g.reshape(size, size))
    return np.stack(out)


@pytest.mark.parametrize("size", [64, 272])
def test_otsu_threshold_matches_jax(size):
    gray = bimodal(6, size, seed=size)
    if size == 272:
        gray[0] = 255                     # one image at the histogram's edge
        gray[0, :8] = 3
    want = np.asarray(jit_vmap(J.otsu_threshold)(jnp.asarray(gray)))
    var_b, sums = jit_vmap(_otsu_jax_var_b)(jnp.asarray(gray))
    var_b, sums = np.asarray(var_b), np.asarray(sums)
    got = T.otsu_threshold(torch.from_numpy(gray)).numpy()
    if size == 272:
        assert (sums > 2 ** 24).sum() >= 4, sums   # the rounded case
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        tie = abs(var_b[i, g] - var_b[i, w]) <= 4 * np.spacing(var_b[i, w])
        assert abs(int(g) - int(w)) == 1 and tie, (i, g, w)
    same = got == want
    np.testing.assert_array_equal(
        T.otsu_binary_inv(torch.from_numpy(gray)).numpy()[same],
        np.asarray(jit_vmap(J.otsu_binary_inv)(jnp.asarray(gray)))[same])


def test_morphology_bit_equal():
    binary = np.random.default_rng(3).uniform(size=(2, 64, 64)) > 0.6
    tb, jb = torch.from_numpy(binary), jnp.asarray(binary)
    for name, t, j in (
            ("dilate", T.dilate(tb), jit_vmap(J.dilate)(jb)),
            ("erode", T.erode(tb), jit_vmap(J.erode)(jb)),
            ("close x3", T.morph_close(tb, SE, 3),
             jit_vmap(lambda m: J.morph_close(m, SE, 3))(jb)),
            ("open x2", T.morph_open(tb, SE, 2),
             jit_vmap(lambda m: J.morph_open(m, SE, 2))(jb))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def spiral(n):
    """A 1-pixel path spiralling inward on an n×n grid, a gap of one pixel
    between its turns: one component whose labels travel ~a pixel a sweep."""
    m = np.zeros((n, n), bool)
    y, x, dy, dx, turns = 0, 0, 0, 1, 0
    m[0, 0] = True
    while turns < 2:
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        ahead = 0 <= ay < n and 0 <= ax < n and m[ay, ax]
        if 0 <= ny < n and 0 <= nx < n and not m[ny, nx] and not ahead:
            y, x, turns = ny, nx, 0
            m[y, x] = True
        else:
            dy, dx, turns = dx, -dy, turns + 1
    return m


def component_cases():
    seeded = jax_binaries(lesions(3, 64, seed=4))
    diagonal = np.zeros((1, 48, 48), bool)
    diagonal[0, np.arange(48), np.arange(48)] = True           # 8-connected
    diagonal[0, np.arange(40), 47 - np.arange(40)] = True
    # images that converge in the first block, later, and never (the
    # spiral): each leaves the working set after its own last change
    yy, xx = np.mgrid[0:48, 0:48]
    later = np.zeros((48, 48), bool)
    later[:20, :20] = spiral(20)                    # converges at sweep ~40
    mixed = np.stack([spiral(48), (yy - 20) ** 2 + (xx - 30) ** 2 < 100,
                      np.zeros((48, 48), bool), later])
    return {"lesions": seeded, "diagonal": diagonal,
            "empty": np.zeros((2, 32, 32), bool),
            "spiral": spiral(48)[None], "mixed": mixed}


@pytest.mark.parametrize("case", ["lesions", "diagonal", "empty", "spiral",
                                  "mixed"])
def test_connected_components_bit_equal(case):
    binary = component_cases()[case]
    want = np.asarray(jit_vmap(J.connected_components)(jnp.asarray(binary)))
    got = T.connected_components(torch.from_numpy(binary))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    _, sweeps = T.propagate_labels(torch.from_numpy(binary))
    assert sweeps in (8, 16, 32, 64) and sweeps <= T.MAX_SWEEPS
    if case == "spiral":
        # JAX stops at its 64-sweep cap with the path not yet one label
        assert len(np.unique(want[want >= 0])) > 1 and sweeps == 64
        full = np.asarray(J.connected_components(jnp.asarray(binary[0]),
                                                 max_iters=10 ** 6))
        assert len(np.unique(full[full >= 0])) == 1
    if case == "diagonal":
        assert set(np.unique(want)) == {-1, 0}


def test_largest_component_bit_equal_with_a_tie_in_area():
    tie = np.zeros((1, 40, 40), bool)
    tie[0, 25:31, 2:8] = True             # 36 pixels, the larger label
    tie[0, 3:9, 30:36] = True             # 36 pixels, the first label
    tie[0, 15:17, 15:17] = True
    binary = np.concatenate([tie, np.zeros((1, 40, 40), bool),
                             jax_binaries(lesions(2, 40, seed=5))])
    jm, jany = jit_vmap(J.largest_component)(jnp.asarray(binary))
    tm, tany = T.largest_component(torch.from_numpy(binary))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tany.numpy(), np.asarray(jany))
    assert tm[0, 3:9, 30:36].all() and not tm[0, 25:31, 2:8].any()
    assert not tany[1]


@pytest.mark.parametrize("h,w", [(64, 64), (272, 272), (33, 50)])
def test_circle_and_fallback_ellipse_bit_equal(h, w):
    np.testing.assert_array_equal(T._circle_mask(h, w, "cpu").numpy(),
                                  np.asarray(J._circle_mask(h, w)))
    np.testing.assert_array_equal(T._fallback_ellipse(h, w, "cpu").numpy(),
                                  np.asarray(J._fallback_ellipse(h, w)))


@pytest.mark.parametrize("size,source", [(64, 64), (96, 96), (48, 96)],
                         ids=["64", "96", "96to48"])
def test_segment_lesion_batch_matches_jax(size, source):
    x = lesions(4, source, seed=size + source)
    x[-1] = 0.8                           # no foreground: the fallback ellipse
    want = np.asarray(J.segment_lesion_batch(jnp.asarray(x), size))
    got = T.segment_lesion_batch(torch.from_numpy(x), size)
    assert got.shape == (4, size, size, 1) and got.dtype == torch.float32
    got = got.numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    agree = (got == want).mean(axis=(1, 2, 3))
    assert (agree >= 0.999).all(), agree
    if source == size:                    # gray levels of the same input
        same_gray = (gray_levels(x) == T.gaussian_blur(T.rgb_to_lab_l(
            torch.from_numpy(x))).clamp(0, 255).int().numpy()).all((1, 2))
        assert same_gray.sum() >= 2
        np.testing.assert_array_equal(got[same_gray], want[same_gray])
    np.testing.assert_array_equal(
        got[-1, ..., 0], np.asarray(J.dilate(J._fallback_ellipse(size, size))))


@pytest.mark.parametrize("in_size,out_size", [(64, 32), (96, 48), (20, 37)],
                         ids=["half", "half_96", "up"])
def test_linear_resize_matches_jax(in_size, out_size):
    x = np.random.default_rng(in_size).random(
        (2, in_size, in_size + 3, 3)).astype(np.float32)
    size = (out_size, out_size + 1)
    want = jax.image.resize(jnp.asarray(x), (2,) + size + (3,),
                            method="linear", antialias=True)
    got = TI.resize(torch.from_numpy(x), size, "linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
