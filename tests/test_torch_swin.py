"""The port's SwinV2 against the JAX package's, on the CPU, in fp32.

The same seeded numpy inputs and the same weights (JAX variables converted
with ``state_dict_from_jax``) go through ``fedvit_tpu/models/swin.py`` and
``fedvit_torch/models/swin.py``: the window helpers, ``WindowAttentionV2`` and
``PatchMergingV2`` alone, and the slice as a whole, an ``ISICClassifier`` on a
two-stage SwinV2 (``torch_parity.SWIN_SPEC``: at image_size 32 one stage
shifts and takes the mask, the other clamps its window to the map) through the
forward and through ``_evaluate``. On the CPU the port's attention is the
plain version of K5 and, under grad, of K6. The gradients of
``WindowAttentionV2`` and of one shifted ``SwinBlockV2`` (input and every
parameter) are held to ``jax.grad`` of the JAX modules on the same weights.

Tolerances: the integer and table helpers are exact; module outputs atol 1e-5
and model logits, features and probabilities atol 1e-4 — fp32 throughout, the
two frameworks sum in other orders through 4 blocks, as for the ViT. Module
gradients: atol 1e-4 plus rtol 1e-4 (sums over up to 192 rows of 16 tokens of
terms of size ~1, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.data import pipeline as tpipe
from fedvit_torch.eval import serve
from fedvit_torch.models import swin as tswin
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_tpu.data import pipeline as jpipe
from fedvit_tpu.models import swin as jswin
from fedvit_tpu.models.import_weights import import_torch_isic
from fedvit_tpu.train import loop as jloop
from fedvit_tpu.train.step import make_eval_step as jax_make_eval_step

from torch_parity import (SWIN_SPEC, configs, flat, jax_variables,
                          torch_model)

ATOL = 1e-4
MODULE_ATOL = 1e-5
GRAD_ATOL = 1e-4


# --- helpers -----------------------------------------------------------------

@pytest.mark.parametrize("major", [True, False], ids=["window_major", "batch_major"])
def test_window_partition_matches_jax_and_round_trips(major):
    x = np.random.default_rng(0).normal(size=(3, 8, 12, 5)).astype(np.float32)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), 4, major=major))
    got = tswin.window_partition(torch.from_numpy(x), 4, major=major)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_unpartition(got, 4, 8, 12, major=major)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jswin.window_unpartition(jnp.asarray(want), 4, 8, 12,
                                            major=major)), x)


def test_window_major_rows_of_one_window_are_contiguous():
    """Rows [w·B, (w+1)·B) hold window w of every batch element."""
    b, h, w, win = 3, 8, 8, 4
    x = torch.arange(b * h * w, dtype=torch.float32).reshape(b, h, w, 1)
    rows = tswin.window_partition(x, win, major=True)
    assert rows.shape == (4 * b, win * win, 1)
    for wi, (r0, c0) in enumerate([(0, 0), (0, 4), (4, 0), (4, 4)]):
        for bi in range(b):
            want = x[bi, r0:r0 + win, c0:c0 + win].reshape(-1, 1)
            assert torch.equal(rows[wi * b + bi], want)


@pytest.mark.parametrize("window,pretrained", [(4, 2), (7, 0), (24, 12), (12, 6),
                                               (1, 0)])
def test_tables_and_index_equal_jax(window, pretrained):
    np.testing.assert_array_equal(
        tswin.relative_coords_table(window, pretrained),
        jswin.relative_coords_table(window, pretrained))
    np.testing.assert_array_equal(tswin.relative_position_index(window),
                                  jswin.relative_position_index(window))


@pytest.mark.parametrize("h,w,window,shift", [(8, 8, 4, 2), (16, 8, 4, 2),
                                              (14, 14, 7, 3), (8, 8, 4, 0)])
def test_shift_attention_mask_equals_jax(h, w, window, shift):
    got = tswin.shift_attention_mask(h, w, window, shift)
    want = jswin.shift_attention_mask(h, w, window, shift)
    if shift == 0:
        assert got is None and want is None
        return
    assert got.shape == ((h // window) * (w // window), window ** 2, window ** 2)
    np.testing.assert_array_equal(got, want)
    assert len({m.tobytes() for m in got}) > 1     # the masks differ by window


@pytest.mark.parametrize("window,heads", [(4, 2), (7, 3), (12, 6)])
def test_expand_bias_table_equals_jax_and_the_index_gather(window, heads):
    table = np.random.default_rng(window).normal(
        size=(2 * window - 1, 2 * window - 1, heads)).astype(np.float32)
    got = tswin.expand_bias_table(torch.from_numpy(table), window).numpy()
    want = np.asarray(jswin.expand_bias_table(jnp.asarray(table), window))
    np.testing.assert_array_equal(got, want)
    gather = table.reshape(-1, heads)[tswin.relative_position_index(window)]
    np.testing.assert_array_equal(got, gather.transpose(2, 0, 1))


# --- modules alone -------------------------------------------------------------

def _moved(variables, seed):
    """Every leaf moved by seeded noise, so zero biases and the constant logit
    scale are exercised; numpy float32."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0, 0.05, np.shape(a)).astype(np.float32), variables)


@pytest.mark.parametrize("masked", [True, False], ids=["shift_mask", "no_mask"])
def test_window_attention_v2_matches_jax(masked):
    heads, window, c, b = 2, 4, 64, 3
    mask = jswin.shift_attention_mask(8, 8, window, 2) if masked else None
    w0 = 4 if masked else 1
    x = np.random.default_rng(1).normal(size=(w0 * b, window ** 2, c)).astype(
        np.float32)
    jmod = jswin.WindowAttentionV2(heads, window, pretrained_window=2,
                                   attention_impl="xla")
    variables = _moved(jax.device_get(
        jmod.init(jax.random.key(0), jnp.asarray(x), mask)), seed=2)
    want = jmod.apply(variables, jnp.asarray(x), mask)

    tmod = tswin.WindowAttentionV2(c, heads, window, pretrained_window=2)
    sd = state_dict_from_jax({"params": {"backbone": {"layers_0": {"blocks_0": {
        "attn": variables["params"]}}}}})
    tmod.load_state_dict({k.split("attn.", 1)[1]: v for k, v in sd.items()})
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_ATOL)


def _grads_match(tmod, prefix, jgrads, x_t, jgx):
    """Every parameter's gradient and the input's against the JAX ones, the
    parameter tree renamed by ``state_dict_from_jax`` under ``prefix``."""
    want = state_dict_from_jax({"params": jgrads})
    got = dict(tmod.named_parameters())
    assert {prefix + n for n in got} == set(want)
    for n, p in got.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, n
        np.testing.assert_allclose(p.grad.numpy(), want[prefix + n].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL, err_msg=n)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(jgx),
                               atol=GRAD_ATOL, rtol=GRAD_ATOL)


@pytest.mark.parametrize("masked", [True, False], ids=["shift_mask", "no_mask"])
def test_window_attention_v2_grads_match_jax(masked):
    """Through the clamped logit scale, the cosine norms, the q and v biases
    and the CPB MLP (reached only through the bias's gradient and the
    expansion of the bias table)."""
    heads, window, c, b = 2, 4, 64, 3
    mask = jswin.shift_attention_mask(8, 8, window, 2) if masked else None
    w0 = 4 if masked else 1
    rng = np.random.default_rng(11)
    x = rng.normal(size=(w0 * b, window ** 2, c)).astype(np.float32)
    dout = rng.normal(size=x.shape).astype(np.float32)
    jmod = jswin.WindowAttentionV2(heads, window, pretrained_window=2,
                                   attention_impl="xla")
    variables = _moved(jax.device_get(
        jmod.init(jax.random.key(0), jnp.asarray(x), mask)), seed=12)
    jgp, jgx = jax.grad(
        lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx, mask) * dout),
        argnums=(0, 1))(variables["params"], jnp.asarray(x))

    tmod = tswin.WindowAttentionV2(c, heads, window, pretrained_window=2)
    prefix = "backbone.layers.0.blocks.0.attn."
    nest = lambda t: {"backbone": {"layers_0": {"blocks_0": {"attn": t}}}}
    sd = state_dict_from_jax({"params": nest(variables["params"])})
    tmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    x_t = torch.from_numpy(x).requires_grad_()
    out = tmod(x_t, None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(dout))
    _grads_match(tmod, prefix, nest(jax.device_get(jgp)), x_t, jgx)


def test_shifted_swin_block_v2_grads_match_jax():
    """One post-norm block with a shift: the roll, the window partition and
    its inverse, the real shift mask, both LayerNorms and the MLP under
    grad."""
    heads, window, c, b = 2, 4, 64, 3
    rng = np.random.default_rng(13)
    x = rng.normal(size=(b, 8, 8, c)).astype(np.float32)
    dout = rng.normal(size=x.shape).astype(np.float32)
    jmod = jswin.SwinBlockV2(heads, window, shift=2, pretrained_window=2,
                             attention_impl="xla")
    variables = _moved(jax.device_get(
        jmod.init(jax.random.key(0), jnp.asarray(x))), seed=14)
    jgp, jgx = jax.grad(
        lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * dout),
        argnums=(0, 1))(variables["params"], jnp.asarray(x))

    tmod = tswin.SwinBlockV2(c, (8, 8), heads, window, shift=2,
                             pretrained_window=2)
    assert tuple(tmod.attn_mask.shape) == (4, 16, 16)
    prefix = "backbone.layers.0.blocks.1."
    nest = lambda t: {"backbone": {"layers_0": {"blocks_1": t}}}
    sd = state_dict_from_jax({"params": nest(variables["params"])})
    tmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    tmod.eval()                                    # drop-path off, as in JAX
    x_t = torch.from_numpy(x).requires_grad_()
    tmod(x_t).backward(torch.from_numpy(dout))
    _grads_match(tmod, prefix, nest(jax.device_get(jgp)), x_t, jgx)


def test_relative_position_bias_matches_jax_cpb():
    """16·sigmoid of the CPB MLP over the table, expanded: (H, n, n) fp32.
    Values reach 16, where an fp32 ulp is 1.9e-6, and the 512-wide sums run in
    another order: rtol 1e-5 beside the module atol."""
    heads, window = 3, 4
    tmod = tswin.WindowAttentionV2(96, heads, window, pretrained_window=2)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in tmod.cpb_mlp.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
    w1, b1, w2 = (p.detach().numpy() for p in tmod.cpb_mlp.parameters())
    table = jswin.relative_coords_table(window, 2)
    cpb = np.maximum(table @ w1.T + b1, 0) @ w2.T
    want = jswin.expand_bias_table(16.0 * jax.nn.sigmoid(jnp.asarray(cpb[0])),
                                   window)
    got = tmod.relative_position_bias()
    assert got.shape == (heads, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=MODULE_ATOL)


def test_patch_merging_v2_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 6, 4, 8)).astype(np.float32)
    jmod = jswin.PatchMergingV2()
    variables = _moved(jax.device_get(
        jmod.init(jax.random.key(0), jnp.asarray(x))), seed=5)
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = tswin.PatchMergingV2(8)
    sd = state_dict_from_jax({"params": {"backbone": {"layers_0": {
        "downsample": variables["params"]}}}})
    tmod.load_state_dict({k.split("downsample.", 1)[1]: v for k, v in sd.items()})
    assert all(k.startswith("backbone.layers.1.downsample.") for k in sd)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 3, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_ATOL)


# --- the slice: ISICClassifier on a SwinV2 ------------------------------------

@pytest.fixture(scope="module")
def swin4():
    """4 channels with metadata: configs, the JAX model and variables, and the
    port's model with those variables."""
    jcfg, tcfg = configs(use_mask=True, backbone="swin")
    jmodel, variables = jax_variables(jcfg, seed=1)
    return jcfg, tcfg, jmodel, variables, torch_model(tcfg, variables)


def _compare_forward(jmodel, variables, tmodel, in_channels, with_meta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 32, 32, in_channels)).astype(np.float32)
    meta = rng.normal(size=(3, 13)).astype(np.float32) if with_meta else None
    want = jmodel.apply(variables, jnp.asarray(x),
                        None if meta is None else jnp.asarray(meta),
                        deterministic=True)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x),
                     None if meta is None else torch.from_numpy(meta))
    assert got["features"].shape == (3, 64) and got["logits"].shape == (3, 8)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), atol=ATOL)


@pytest.mark.parametrize("with_meta", [True, False], ids=["4ch", "no_metadata"])
def test_swin_logits_match_jax(swin4, with_meta):
    _, _, jmodel, variables, tmodel = swin4
    _compare_forward(jmodel, variables, tmodel, 4, with_meta)


def test_swin_logits_match_jax_3ch():
    jcfg, tcfg = configs(use_mask=False, backbone="swin")
    jmodel, variables = jax_variables(jcfg, seed=3)
    _compare_forward(jmodel, variables, torch_model(tcfg, variables), 3, True)


def test_swin_geometry_one_stage_shifts_and_one_clamps(swin4):
    blocks = [(b.window, b.shift, None if b.attn_mask is None
               else tuple(b.attn_mask.shape), b.attn.relative_coords_table.shape[1])
              for b in swin4[4].backbone.modules()
              if isinstance(b, tswin.SwinBlockV2)]
    assert blocks == [(4, 0, None, 7), (4, 2, (4, 16, 16), 7),
                      (4, 0, None, 7), (4, 0, None, 7)]


def test_swin_evaluate_matches_jax_with_a_ragged_batch(swin4):
    jcfg, tcfg, jmodel, variables, tmodel = swin4
    rng = np.random.default_rng(0)
    data = {"image": rng.integers(0, 256, size=(7, 48, 48, 4), dtype=np.uint8),
            "label": rng.integers(0, 8, size=7).astype(np.int32),
            "metadata": rng.normal(size=(7, 13)).astype(np.float32)}
    jstep = jax_make_eval_step(jmodel.apply, jcfg,
                               augment=jpipe.make_device_augment(jcfg, False))
    want = jloop._evaluate(jstep, variables["params"],
                           variables["batch_stats"],
                           jpipe.ArrayDataSource(data), 4, 8)
    tstep = serve.make_eval_step(tmodel, tcfg,
                                 augment=tpipe.make_device_augment(tcfg, False))
    got = serve._evaluate(tstep, tpipe.ArrayDataSource(data), 4, 8)
    assert got["logits"].shape == (7, 8)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=ATOL)


# --- weights cross between the packages ----------------------------------------

def test_swin_state_dict_round_trip_through_import_torch_isic(swin4):
    """port state_dict → import_torch_isic (Swin branch) → the original JAX
    variables, exactly."""
    _, _, _, variables, tmodel = swin4
    back = import_torch_isic(tmodel.state_dict(), variables,
                             depth=SWIN_SPEC["depths"])
    for group in ("params", "batch_stats"):
        want, got = flat(variables[group]), flat(back[group])
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_swin_state_dict_names_are_timms(swin4):
    sd = swin4[4].state_dict()
    backbone = {k[len("backbone."):] for k in sd if k.startswith("backbone.")}
    blocks = [f"layers.{s}.blocks.{b}." for s in (0, 1) for b in (0, 1)]
    per_block = ["attn.qkv.weight", "attn.q_bias", "attn.v_bias",
                 "attn.logit_scale", "attn.cpb_mlp.0.weight",
                 "attn.cpb_mlp.0.bias", "attn.cpb_mlp.2.weight",
                 "attn.proj.weight", "attn.proj.bias", "norm1.weight",
                 "norm1.bias", "norm2.weight", "norm2.bias", "mlp.fc1.weight",
                 "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias"]
    want = {"patch_embed.proj.weight", "patch_embed.proj.bias",
            "patch_embed.norm.weight", "patch_embed.norm.bias",
            "layers.1.downsample.reduction.weight",
            "layers.1.downsample.norm.weight", "layers.1.downsample.norm.bias",
            "norm.weight", "norm.bias"}
    want |= {blk + leaf for blk in blocks for leaf in per_block}
    assert backbone == want       # no table, index or mask buffer among them
    assert sd["backbone.patch_embed.proj.weight"].shape == (32, 4, 4, 4)
    assert sd["backbone.layers.0.blocks.0.attn.logit_scale"].shape == (1, 1, 1)
    assert sd["backbone.layers.1.downsample.reduction.weight"].shape == (64, 128)


def test_swin_init_weights_follow_the_jax_init():
    """logit_scale log 10, q/v bias zeros, trunc-normal(0.02) weights, unit
    norms — not the 1.0 a blanket "everything else" fill would give."""
    from fedvit_torch.models import build_model
    _, tcfg = configs(use_mask=True, backbone="swin")
    model = build_model(tcfg, device="cpu")
    attn = model.backbone.layers[0].blocks[1].attn
    torch.testing.assert_close(attn.logit_scale,
                               torch.full((1, 1, 1), float(np.log(10.0))))
    assert not attn.q_bias.any() and not attn.v_bias.any()
    assert not attn.cpb_mlp[0].bias.any()
    for w in (attn.qkv.weight, attn.cpb_mlp[0].weight, attn.cpb_mlp[2].weight,
              model.backbone.layers[1].downsample.reduction.weight):
        assert 0 < float(w.detach().abs().max()) <= 0.04 + 1e-6
    assert torch.equal(model.backbone.layers[0].blocks[0].norm1.weight,
                       torch.ones(32))


@pytest.mark.parametrize("name,size,window,dims", [
    ("swinv2_large_window12to24_192to384.ms_in22k_ft_in1k", 384, 24, (192, 1536)),
    ("swin_small_patch4_window12_384", 384, 12, (96, 768)),
    ("swinv2_base_window12to16_192to256", 256, 16, (128, 1024)),
    ("swinv2_tiny_window8_256", 256, 8, (96, 768))])
def test_registry_parses_swin_names_like_jax(name, size, window, dims):
    """The registry's spec for a Swin name equals the JAX registry's module
    fields (built on the meta device: no weights are allocated), and each
    stage's window clamps to its map and then loses its shift."""
    from fedvit_torch.models.registry import build_backbone
    from fedvit_tpu.models.registry import build_backbone as jax_build_backbone
    jmod, jdim = jax_build_backbone(name, size)
    with torch.device("meta"):
        tmod, tdim = build_backbone(name, size)
    assert tdim == jdim == dims[1]
    assert tmod.patch_embed.proj.weight.shape[0] == jmod.embed_dim == dims[0]
    assert tuple(len(s.blocks) for s in tmod.layers) == tuple(jmod.depths)
    assert [s.blocks[0].attn.num_heads for s in tmod.layers] == list(jmod.num_heads)
    assert jmod.window_size == window
    for s, stage in enumerate(tmod.layers):
        side = size // 4 >> s
        blk = stage.blocks[1]
        assert blk.window == min(window, side)
        assert blk.shift == (0 if window >= side else window // 2)
        assert (blk.attn_mask is None) == (blk.shift == 0)
    with pytest.raises(ValueError, match="Unknown swin backbone"):
        build_backbone("swin_nano_window7", 224)
