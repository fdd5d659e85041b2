"""The port's train augment against the JAX package's, on the CPU, fp32, on
the same seeded numpy images. JAX draws its parameters from a key and the
port from a ``torch.Generator``, which cannot agree; so each op is held to
its JAX counterpart on identical parameters, rebuilt here from the JAX key
the way the JAX function splits it, and the port's own draws are held to
JAX's laws.

Tolerances, with their reasons:

- K7's and K8's plain versions (row/column shift, equalize): exact. A shift
  moves values; equalize's fp32 values are integers below 2^24 and its two
  divisions are correctly rounded in both frameworks. The JAX references run
  jitted (one compile, where eager JAX compiles every op), except where a
  result is held exactly and divides by a constant: XLA compiles x / 255 as
  x · (1/255), one ulp off at times, so those run eagerly, as the JAX
  package's own tests run them.
- crop_and_resize: cubic atol 1e-6 (two fp32 weighted sums over ≤ 8 taps in
  another order, values in [0, 1]); nearest exact (the same fp32 index
  arithmetic and floor).
- rotate (nearest) and geometric_chain: the shift fields m·(y − cy) + t are
  rounded half to even in both, but tan and sin of the angle may differ by an
  ulp between XLA and torch and turn a tie the other way: the pixels that
  differ are counted, at most 1% of them (a flipped tie moves the rest of its
  row by one pixel; the seeds here flip none or a few rows of ~100).
- rotate (bilinear): atol 1e-5 (the source coordinates carry the ulp of cos and
  sin times coordinates of ~30 into the interpolation weights).
- photometric ops: atol 1e-6, except where a threshold turns an upstream ulp
  into a step (posterize, solarize, equalize: exact on exactly the same
  input, and their inputs here are the same arrays).
- color_jitter: atol 1e-6 (three blends of clipped fp32 arithmetic).
- randaugment and train_transform, composites: a tight atol for most elements
  and a bounded share of larger differences. An upstream difference of ~1e-7
  (contrast's mean, sharpness's sums, the cubic crop) can cross a threshold:
  floor(255·x) in equalize, round in posterize, ≥ in solarize, a tie in a
  shift. That moves an element by a step of 1/255 or more, or a row by a
  pixel. So: 99% of elements within 1e-5, the rest unbounded but at most 1%.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedvit_torch.data import pipeline as tpipe
from fedvit_torch.data import sampling as tsamp
from fedvit_torch.ops import image as TI
from fedvit_torch.ops import randaugment as TR
from fedvit_torch.ops import row_shift as TS
from fedvit_tpu.data import sampling as jsamp
from fedvit_tpu.ops import image as JI
from fedvit_tpu.ops import randaugment as JR
from fedvit_tpu.ops import row_shift as JS

from tests.torch_parity import configs


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one torch thread: these ops are small, and the suite
    runs one process per core, where torch's thread pool would only wait on
    the other processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jit(fn, *static):
    """``fn`` jitted: one XLA compile, where eager JAX compiles every op."""
    return jax.jit(fn, static_argnums=static)


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# --- K7 and K8, plain versions: exact ------------------------------------------

def _shifts(b, n, extent, seed):
    """Float shifts with ties (±0.5, 1.5, 2.5), integers, and values past
    ±extent."""
    s = np.random.default_rng(seed).uniform(-1.6 * extent, 1.6 * extent,
                                            size=(b, n)).astype(np.float32)
    ties = np.array([0.5, -0.5, 1.5, -2.5, 2.5, 3.0, -extent - 0.5, extent + 0.5],
                    np.float32)
    s[0, :len(ties)] = ties[:n]
    return s


def _shape_param(shape):
    return pytest.param(shape, id="x".join(map(str, shape)))


# the edge shapes of the card tests (tests/test_torch_cuda.py), kept small:
# C = 4 at odd W, B = 1, C = 1, C = 3 rows whose starts are not 16-byte
# aligned, rows shorter than 4 floats, and a C the kernels take at run time
EDGE_SHAPES = [(2, 37, 29, 4), (1, 11, 25, 3), (2, 13, 33, 1), (2, 6, 3, 1),
               (2, 7, 9, 5)]


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("shape", [pytest.param((3, 14, 19, c), id=str(c))
                                   for c in (1, 3, 4)]   # H ≠ W, ragged W
                         + [_shape_param(s) for s in EDGE_SHAPES])
def test_k7_plain_matches_jax_exactly(axis, shape):
    b, h, w, c = shape
    img = _images(shape, seed=c)
    if axis == "rows":
        sh = _shifts(b, h, w, seed=c + 10)
        got = TS.row_shift(_t(img), _t(sh))
        xla = _jit(JS._row_shift_xla)(img, sh)
        pallas = _jit(lambda a, b: JS.row_shift(a, b, impl="pallas"))(img, sh)
    else:
        sh = _shifts(b, w, h, seed=c + 20)
        got = TS.col_shift(_t(img), _t(sh))
        xla = _jit(JS._col_shift_xla)(img, sh)
        pallas = _jit(lambda a, b: JS.col_shift(a, b, impl="pallas"))(img, sh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    assert (got.numpy() == 0).any() and (got.numpy() != 0).any()


@pytest.mark.parametrize("shape", [_shape_param((2, 24, 20, 3))]
                         + [_shape_param(s) for s in
                            [(2, 37, 29, 4), (1, 37, 41, 3), (2, 40, 33, 1),
                             (2, 9, 11, 2)]])
def test_k8_plain_matches_jax_exactly(shape):
    c = shape[3]
    img = _images(shape)
    img[0, ..., c // 2] = 0.25
    img[0, :2, :3, c // 2] = np.float32(0.9)              # one value, a few others
    img[-1, ..., -1] = 0.5                                 # step == 0: passthrough
    got = TR.equalize(_t(img)).numpy()
    # eagerly, as the JAX package's own test runs them: under jit, XLA turns
    # the division by 255 into a product with its reciprocal, one ulp off
    np.testing.assert_array_equal(got, np.asarray(JR._equalize_xla(jnp.asarray(img))))
    np.testing.assert_array_equal(
        got, np.asarray(JR.equalize(jnp.asarray(img), impl="pallas")))
    np.testing.assert_array_equal(got[-1, ..., -1], img[-1, ..., -1])


def test_kernel_wrappers_launch_nothing_on_the_cpu():
    before = (TS.shift_cuda.launches, TR.equalize_cuda.launches)
    img = _t(_images((2, 8, 8, 3)))
    TS.row_shift(img, torch.ones(2, 8))
    TS.col_shift(img, torch.ones(2, 8))
    TR.equalize(img)
    assert (TS.shift_cuda.launches, TR.equalize_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        TS.shift_cuda(img, torch.ones(2, 8, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        TR.equalize_cuda(img)


# --- single ops on identical parameters -----------------------------------------

@pytest.mark.parametrize("method", ["cubic", "nearest"])
def test_crop_and_resize_matches_jax(method):
    canvas = _images((5, 48, 44, 3), seed=1)
    boxes = np.array(_jit(JI.random_resized_crop_params, 1, 2, 3)(
        jax.random.key(1), 5, 48, 44))
    boxes[0] = [0, 0, 48, 44]                     # the whole canvas
    boxes[1] = [3, 5, 20, 17]                     # upsampled from a small box
    want = np.asarray(_jit(lambda x, bx: JI.crop_and_resize(
        x, bx, 32, method, antialias=method == "cubic"))(canvas, boxes))
    got = TI.crop_and_resize(_t(canvas), _t(boxes), 32, method).numpy()
    if method == "cubic":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _differing_pixels(got, want):
    return float((got != want).any(-1).mean())


def test_rotate_matches_jax():
    img = _images((6, 30, 30, 4), seed=2)
    ang = np.array([-30, -12.5, 0, 7.25, 12, 29.9], np.float32)
    got = TI.rotate(_t(img), _t(ang)).numpy()
    want = np.asarray(_jit(JI.rotate)(img, ang))
    assert _differing_pixels(got, want) <= 0.01
    np.testing.assert_array_equal(got[2], img[2])          # 0°: unchanged
    got = TI.rotate(_t(img), _t(ang), "bilinear").numpy()
    want = np.asarray(_jit(JI.rotate, 2)(img, ang, "bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_geometric_chain_matches_jax():
    img = _images((5, 28, 28, 3), seed=3)
    rng = np.random.default_rng(3)
    m1, m2, m3 = (rng.uniform(-0.3, 0.3, 5).astype(np.float32) for _ in range(3))
    t1, t2 = (rng.uniform(-9, 9, 5).astype(np.float32) for _ in range(2))
    args = [m1, t1, m2, t2, m3]
    got = TR.geometric_chain(_t(img), *map(_t, args), 8).numpy()
    want = np.asarray(_jit(JR.geometric_chain, 6)(img, *args, 8))
    assert _differing_pixels(got, want) <= 0.01
    names = ("shear_x", "shear_y", "translate_x", "translate_y", "rotate_deg")
    mags = [(rng.uniform(-30, 30, 5) if name == "rotate_deg"
             else rng.uniform(-0.3, 0.3, 5) if "shear" in name
             else rng.uniform(-8, 8, 5)).astype(np.float32) for name in names]
    wants = _jit(lambda x, ms: [getattr(JR, n)(x, m) for n, m in zip(names, ms)])(
        img, mags)
    for name, mag, want in zip(names, mags, wants):
        got = getattr(TR, name)(_t(img), _t(mag)).numpy()
        assert _differing_pixels(got, np.asarray(want)) <= 0.01, name


FACTOR = np.array([0.64, 1.0, 1.36, 0.9], np.float32)
PHOTOMETRIC = {
    "grayscale": (lambda x: TI.grayscale(x), lambda x: JI.grayscale(x)),
    "brightness": (lambda x: TR.brightness(x, _t(FACTOR)),
                   lambda x: JR.brightness(x, jnp.asarray(FACTOR))),
    "color": (lambda x: TR.color(x, _t(FACTOR)),
              lambda x: JR.color(x, jnp.asarray(FACTOR))),
    "contrast": (lambda x: TR.contrast(x, _t(FACTOR)),
                 lambda x: JR.contrast(x, jnp.asarray(FACTOR))),
    "hue": (lambda x: TI.adjust_hue(x, _t(FACTOR - 1.0)),
            lambda x: JI.adjust_hue(x, jnp.asarray(FACTOR - 1.0))),
    "hsv_round_trip": (lambda x: TI.hsv_to_rgb(TI.rgb_to_hsv(x)),
                       lambda x: JI.hsv_to_rgb(JI.rgb_to_hsv(x))),
    "sharpness": (lambda x: TR.sharpness(x, _t(FACTOR)),
                  lambda x: JR.sharpness(x, jnp.asarray(FACTOR))),
    "posterize": (lambda x: TR.posterize(x, 6), lambda x: JR.posterize(x, 6)),
    "solarize": (lambda x: TR.solarize(x, 153.0),
                 lambda x: JR.solarize(x, 153.0)),
    "autocontrast": (TR.autocontrast, JR.autocontrast),
}   # equalize: test_k8_plain_matches_jax_exactly
EXACT = ("posterize", "solarize", "grayscale")


@pytest.mark.parametrize("name", list(PHOTOMETRIC))
def test_photometric_op_matches_jax(name):
    img = _images((4, 12, 10, 3), seed=4)
    img[3] = 0.5 * img[3] + 0.25                    # autocontrast has work to do
    img[2, :3, :3] = [0.2, 0.2, 0.2]                # grey pixels: hue 0
    tfn, jfn = PHOTOMETRIC[name]
    got = tfn(_t(img)).numpy()
    # the exact ops eagerly: under jit, XLA multiplies by the reciprocal of
    # 255 where they divide by it
    want = np.asarray(jfn(jnp.asarray(img)) if name in EXACT else _jit(jfn)(img))
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --- draws rebuilt from JAX keys -----------------------------------------------------

def jax_jitter_draws(key, b, cj):
    """``color_jitter``'s draws from its key, as it splits it."""
    brightness, contrast, saturation, hue = cj
    k_f, k_o = jax.random.split(key)
    kb, kc, ks, kh = jax.random.split(k_f, 4)

    def factors(k, x):
        return (jax.random.uniform(k, (b,), minval=max(0.0, 1 - x), maxval=1 + x)
                if x > 0 else jnp.ones((b,)))

    cols = [factors(kb, brightness), factors(kc, contrast),
            factors(ks, saturation)]
    if hue > 0:
        cols.append(jax.random.uniform(kh, (b,), minval=-hue, maxval=hue))
    order = jnp.argsort(jax.random.uniform(k_o, (b, len(cols))), axis=-1)
    return _t(np.stack([np.asarray(c) for c in cols], -1)), _t(order).long()


def jax_randaugment_draws(key, b, num_ops):
    """``randaugment``'s per-round (op, sign), from its key."""
    rounds = []
    for _ in range(num_ops):
        key, k_op, k_sign = jax.random.split(key, 3)
        op = jax.random.randint(k_op, (b,), 0, JR.NUM_OPS)
        sign = jnp.where(jax.random.bernoulli(k_sign, 0.5, (b,)), 1.0, -1.0)
        rounds.append((_t(op).long(), _t(sign)))
    return rounds


def jax_train_draws(key, b, h, w, cj=(0.2, 0.2, 0.2, 0.0), rotation=30.0,
                    scale=(0.7, 1.0), ratio=(0.9, 1.1), ra_n=3):
    """``train_transform``'s draws from its key: its split(key, 6) and each
    op's own splits."""
    k_crop, k_hf, k_vf, k_rot, k_cj, k_ra = jax.random.split(key, 6)
    return TI.TrainDraws(
        boxes=_t(_jit(JI.random_resized_crop_params, 1, 2, 3, 4, 5)(
            k_crop, b, h, w, scale, ratio)),
        hflip=_t(jax.random.bernoulli(k_hf, 0.5, (b,))),
        vflip=_t(jax.random.bernoulli(k_vf, 0.5, (b,))),
        angles=_t(jax.random.uniform(k_rot, (b,), minval=-rotation,
                                     maxval=rotation)),
        jitter=jax_jitter_draws(k_cj, b, cj) if any(x > 0 for x in cj) else None,
        randaugment=jax_randaugment_draws(k_ra, b, ra_n) if ra_n else None)


def _composite_close(got, want, share=0.01, atol=1e-5):
    assert got.shape == want.shape and np.isfinite(got).all()
    off = np.abs(got - want) > atol
    assert off.mean() <= share, f"{off.mean():.4f} of elements beyond {atol}"


@pytest.mark.parametrize("hue", [0.0, 0.1])
def test_color_jitter_matches_jax(hue):
    img = _images((6, 12, 12, 3), seed=5)
    cj = (0.2, 0.2, 0.2, hue)
    key = jax.random.key(5)
    want = np.asarray(_jit(lambda k, x: JI.color_jitter(k, x, *cj))(key, img))
    got = TI.color_jitter(_t(img), *jax_jitter_draws(key, 6, cj)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_randaugment_matches_jax():
    b = 28                                # two samples of each op, on average
    img = _images((b, 24, 24, 3), seed=6)
    key = jax.random.key(6)
    rounds = jax_randaugment_draws(key, b, 3)
    assert len(set(np.concatenate([_np(op) for op, _ in rounds]))) >= 12
    want = np.asarray(_jit(JR.randaugment, 2, 3)(key, img, 3, 12))
    got = TR.randaugment(_t(img), rounds, 12).numpy()
    _composite_close(got, want)


@pytest.mark.parametrize("with_mask", [True, False])
def test_train_transform_matches_jax(with_mask):
    b, canvas, size = 8, 48, 32
    img = _images((b, canvas, canvas, 3), seed=7)
    mask = ((_images((b, canvas, canvas, 1), seed=8) > 0.5).astype(np.float32)
            if with_mask else None)
    key = jax.random.key(7)
    want_img, want_mask = _jit(lambda k, x, m: JI.train_transform(
        k, x, m, out_size=size))(key, img, mask)
    draws = jax_train_draws(key, b, canvas, canvas)
    got_img, got_mask = TI.train_transform(
        _t(img), None if mask is None else _t(mask), draws, out_size=size)
    _composite_close(got_img.numpy(), np.asarray(want_img))
    if with_mask:
        assert set(np.unique(got_mask.numpy())) <= {-1.0, 1.0}
        _composite_close(got_mask.numpy(), np.asarray(want_mask))
    else:
        assert got_mask is None and want_mask is None


# --- the port's draws follow JAX's laws ------------------------------------------

def test_draws_follow_jax_laws():
    """About 10k draws a law on each side; each statistic within a few
    standard errors of JAX's (stated per line)."""
    n, h, w = 10_000, 48, 40
    g = torch.Generator().manual_seed(0)
    d = TI.draw_train(g, n, h, w, cj=(0.2, 0.2, 0.2, 0.1))
    jd = jax_train_draws(jax.random.key(0), n, h, w, cj=(0.2, 0.2, 0.2, 0.1))
    for draws in (d, jd):
        boxes = _np(draws.boxes)
        assert (boxes[:, 0] >= 0).all() and (boxes[:, 0] + boxes[:, 2] <= h).all()
        assert (boxes[:, 1] >= 0).all() and (boxes[:, 1] + boxes[:, 3] <= w).all()
    area = [(_np(x.boxes)[:, 2] * _np(x.boxes)[:, 3]).mean() / (h * w)
            for x in (d, jd)]
    aspect = [(_np(x.boxes)[:, 3] / _np(x.boxes)[:, 2]).mean() for x in (d, jd)]
    assert abs(area[0] - area[1]) < 0.005          # U(0.7, 1) of the area: se 0.001
    assert abs(aspect[0] - aspect[1]) < 0.005      # ratio 0.9-1.1 rounded: se 0.0008
    for flip in ("hflip", "vflip"):
        rate = _np(getattr(d, flip)).mean()
        assert abs(rate - 0.5) < 0.02              # fair coin: se 0.005
    ang = _np(d.angles)
    assert -30 <= ang.min() and ang.max() <= 30
    assert abs(ang.mean()) < 0.6 and abs(ang.std() - 60 / np.sqrt(12)) < 0.4
    f, jf = _np(d.jitter[0]), _np(jd.jitter[0])
    assert f.shape == jf.shape == (n, 4)
    assert (f[:, :3] >= 0.8).all() and (f[:, :3] <= 1.2).all()
    assert (np.abs(f[:, 3]) <= 0.1).all()
    np.testing.assert_allclose(f.mean(0), jf.mean(0), atol=0.005)   # se 0.0012
    np.testing.assert_allclose(f.std(0), jf.std(0), atol=0.005)
    order = _np(d.jitter[1])
    assert (np.sort(order, -1) == np.arange(4)).all()
    first = np.bincount(order[:, 0], minlength=4) / n
    np.testing.assert_allclose(first, 0.25, atol=0.02)             # se 0.0043
    for (op, sign), (jop, jsign) in zip(d.randaugment, jd.randaugment):
        hist = np.bincount(_np(op), minlength=14) / n
        jhist = np.bincount(_np(jop), minlength=14) / n
        assert hist.shape == (14,)
        np.testing.assert_allclose(hist, jhist, atol=0.015)          # se 0.0035
        assert set(np.unique(_np(sign))) == {-1.0, 1.0}
        assert abs(_np(sign).mean() - _np(jsign).mean()) < 0.05     # se 0.014


# --- the device augment -----------------------------------------------------------

@pytest.mark.parametrize("channels", [4, 3])
def test_make_device_augment_train(channels):
    _, tcfg = configs(use_mask=True)
    augment = tpipe.make_device_augment(tcfg, train=True)
    raw = np.random.default_rng(9).integers(0, 256, (4, 48, 48, channels),
                                            dtype=np.uint8)
    if channels == 4:
        raw[..., 3] = np.where(raw[..., 3] > 127, 255, 0)
    batch = {"image": _t(raw), "label": torch.zeros(4, dtype=torch.int32)}
    outs = [augment(batch, torch.Generator().manual_seed(s))["image"]
            for s in (1, 1, 2)]
    assert outs[0].shape == (4, 32, 32, 4) and outs[0].dtype == torch.float32
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    mask = outs[0][..., 3].numpy()
    assert set(np.unique(mask)) <= ({-1.0, 1.0} if channels == 4 else {-1.0})
    with pytest.raises(ValueError, match="Generator"):
        augment(batch)


# --- the sampler ----------------------------------------------------------------------

@pytest.mark.parametrize("weighted,drop_last", [(True, True), (False, True),
                                                (True, False)])
def test_epoch_indices_match_jax(weighted, drop_last):
    labels = np.random.default_rng(0).integers(0, 6, 37)   # classes 6, 7 empty
    got = tsamp.epoch_indices(labels, 8, np.random.default_rng(3), weighted,
                              drop_last)
    want = jsamp.epoch_indices(labels, 8, np.random.default_rng(3), weighted,
                               drop_last)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsamp.compute_class_weights(labels),
                                  jsamp.compute_class_weights(labels))
    np.testing.assert_array_equal(tsamp.class_balanced_weights(labels),
                                  jsamp.class_balanced_weights(labels))
