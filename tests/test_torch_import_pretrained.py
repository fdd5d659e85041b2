"""The port's pretrained-weight import (``models/import_weights.py``'s file
half, ``cli/import_weights.py``) against the JAX package's
``import_pretrained_file`` followed by ``state_dict_from_jax``, on the CPU.

Tolerances: the imported tensors fp32 atol 1e-6. Copies are exact; the
4-channel surgery's mean of three fp32 values may round one ulp apart in
another order; the position-embedding resample is ``ops/image.py::resize``
against ``jax.image.resize`` (the same float32 weight matrices, products
summed in another order, on values of ~0.02). The ``.safetensors`` reader
and the container unwrapping: exact."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.cli import import_weights as tcli
from fedvit_torch.core import config as tconfig
from fedvit_torch.models import build_model as build_torch_model
from fedvit_torch.models import import_weights as tiw
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_torch.train import checkpoint as tckpt
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.models import build_model as build_jax_model
from fedvit_tpu.models import import_weights as jiw

from tests.torch_parity import raw_config, shallow_vit


@pytest.fixture
def shallow():
    with shallow_vit():
        yield


def _configs(backbone="vit", image_size=None):
    raw = raw_config(backbone=backbone)
    if image_size:
        raw["model"]["image_size"] = image_size
    return (jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw),
            raw)


def _jax_variables(jcfg, seed=0):
    model = build_jax_model(jcfg)
    s = jcfg.model.image_size
    x = jnp.zeros((2, s, s, jcfg.in_channels), jnp.float32)
    meta = jnp.zeros((2, 13), jnp.float32)
    init = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x, meta))
    return dict(jax.device_get(init(jax.random.key(seed))))


def _target(tcfg):
    return build_torch_model(tcfg, device="cpu",
                             generator=torch.Generator().manual_seed(0)
                             ).state_dict()


def _source(target, seed, grid=None, prefix="backbone.", extra=()):
    """A seeded file in the target's names (``prefix`` stripped, keys outside
    it dropped when it is ``backbone.``): a 3-channel patch embed, a
    ``grid``² position embedding, plus ``extra`` keys no model has."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, fresh in target.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        shape = list(fresh.shape)
        if name.endswith("patch_embed.proj.weight"):
            shape[1] = 3
        if name.endswith("pos_embed") and grid is not None:
            shape[1] = 1 + grid * grid
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.tensor(0)
        elif name.endswith("running_var"):
            sd[name] = torch.from_numpy(
                rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            sd[name] = torch.from_numpy(
                rng.normal(0.0, 0.02, shape).astype(np.float32))
    for name in extra:
        sd[name] = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    return sd


def _jax_import(sd, jcfg, seed=0):
    variables = _jax_variables(jcfg, seed)
    out = jiw.import_pretrained_file({k: v.numpy() for k, v in sd.items()},
                                     jcfg, variables)
    return state_dict_from_jax(out)


def _close(got, want, keys):
    assert keys
    for key in keys:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("grid", (2, 4, 7), ids=("up", "same", "down"))
def test_vit_backbone_file_matches_jax(shallow, grid):
    """A timm ViT backbone state dict (RGB, a head timm keeps): the 4th
    patch-embed channel the mean of the RGB kernels, the position grid
    resampled up from 2² and down (antialiased) from 7² to 4²."""
    jcfg, tcfg, _ = _configs(image_size=64)
    target = _target(tcfg)
    sd = _source(target, grid, grid=grid, extra=("head.weight",))
    got = tiw.import_pretrained_file(sd, tcfg, target)
    want = _jax_import(sd, jcfg)
    _close(got, want, [k for k in got if k.startswith("backbone.")])
    w = sd["patch_embed.proj.weight"]
    assert torch.equal(got["backbone.patch_embed.proj.weight"][:, :3], w)
    assert torch.equal(got["backbone.patch_embed.proj.weight"][:, 3],
                       w.mean(dim=1))
    for key in target:                 # a backbone file keeps the fresh head
        if not key.startswith("backbone."):
            assert torch.equal(got[key], target[key]), key


def test_swin_backbone_file_matches_jax():
    """A timm SwinV2 backbone (``swinv2_parity_window4``): the merging at the
    start of timm's stage 1 lands where JAX's import puts it, and timm's
    index buffers are left out."""
    jcfg, tcfg, _ = _configs(backbone="swin")
    target = _target(tcfg)
    sd = _source(target, 3, extra=(
        "layers.0.blocks.0.attn.relative_position_index",
        "layers.0.blocks.0.attn.relative_coords_table", "head.fc.weight"))
    got = tiw.import_pretrained_file(sd, tcfg, target)
    want = _jax_import(sd, jcfg)
    _close(got, want, [k for k in got if k.startswith("backbone.")])


def test_full_classifier_file_matches_jax_on_every_key(shallow):
    """A full reference ISICClassifier state dict (RGB, a 7² grid): every
    tensor imported, head and metadata branch included."""
    jcfg, tcfg, _ = _configs(image_size=64)
    target = _target(tcfg)
    sd = _source(target, 5, grid=7, prefix="")
    got = tiw.import_pretrained_file(sd, tcfg, target)
    want = _jax_import(sd, jcfg)
    assert set(got) == set(want) == set(target)
    _close(got, want, sorted(got))
    assert torch.equal(got["classifier.3.weight"], sd["classifier.3.weight"])


def test_import_refuses_other_depths_and_shapes(shallow):
    _, tcfg, _ = _configs()
    target = _target(tcfg)
    sd = _source(target, 0)
    deeper = dict(sd, **{"blocks.2.norm1.weight": sd["blocks.0.norm1.weight"]})
    with pytest.raises(ValueError, match="blocks 3"):
        tiw.import_pretrained_file(deeper, tcfg, target)
    missing = {k: v for k, v in sd.items() if k != "norm.bias"}
    with pytest.raises(KeyError, match="backbone.norm.bias"):
        tiw.import_pretrained_file(missing, tcfg, target)
    wide = dict(sd, **{"norm.bias": torch.zeros(7)})
    with pytest.raises(ValueError, match="backbone.norm.bias"):
        tiw.import_pretrained_file(wide, tcfg, target)


def test_unwrap_state_dict_matches_jax(tmp_path):
    t = {"a.weight": torch.ones(2), "b": torch.zeros(1)}
    for obj in ({"model": t}, {"state_dict": {"module." + k: v
                                              for k, v in t.items()}},
                {"model_state_dict": t, "epoch": 3}, t):
        got = tiw._unwrap_state_dict(obj)
        assert list(got) == list(jiw._unwrap_state_dict(obj)) == list(t)
        path = tmp_path / "w.pt"
        torch.save(obj, path)
        loaded = tiw.load_torch_file(str(path))
        assert list(loaded) == list(t)
        assert all(torch.equal(loaded[k], t[k]) for k in t)


def test_safetensors_reader_matches_the_package(tmp_path):
    """F32, F16 and I64 (and an empty and a 0-d tensor) against
    ``safetensors.numpy.load_file``; BF16 against the torch values written."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(size=(3, 5, 2)).astype(np.float32),
              "h": rng.normal(size=(7,)).astype(np.float16),
              "i": rng.integers(-2 ** 40, 2 ** 40, (4, 3)),
              "empty": np.zeros((0, 4), np.float32),
              "scalar": np.array(2.5, np.float32)}
    path = tmp_path / "a.safetensors"
    save_file(arrays, str(path), metadata={"format": "np"})
    got = tiw.load_torch_file(str(path))
    want = load_file(str(path))
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value)

    bf16 = {"x": torch.randn(6, 4, generator=torch.Generator().manual_seed(0)
                             ).to(torch.bfloat16)}
    save_torch(bf16, str(tmp_path / "b.safetensors"))
    got = tiw.read_safetensors(str(tmp_path / "b.safetensors"))
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], bf16["x"])

    npz = tmp_path / "c.npz"
    np.savez(npz, **{k: v for k, v in arrays.items() if k != "scalar"})
    got = tiw.load_torch_file(str(npz))
    for key in ("w", "h", "i"):
        np.testing.assert_array_equal(got[key].numpy(), arrays[key])


def test_cli_writes_what_load_pretrained_takes(shallow, tmp_path):
    """The CLI on the CPU: a timm backbone ``.pt`` → ``save_pretrained``
    output that ``load_pretrained`` takes for the config, with the RGB mean
    as the mask channel, and refuses for another backbone."""
    _, tcfg, raw = _configs()
    sd = _source(_target(tcfg), 11)
    weights = tmp_path / "vit.pt"
    torch.save({"model": sd}, weights)
    config = tmp_path / "c.yaml"
    config.write_text(json.dumps(raw))
    out = tmp_path / "pretrained"
    assert tcli.main(["--weights", str(weights), "--config", str(config),
                      "--output", str(out), "--device", "cpu"]) == 0
    assert tckpt.pretrained_exists(str(out))
    model = build_torch_model(tcfg, device="cpu")
    tckpt.load_pretrained(str(out), model, tcfg)
    got = model.state_dict()
    w = sd["patch_embed.proj.weight"]
    assert torch.equal(got["backbone.patch_embed.proj.weight"],
                       torch.cat([w, w.mean(dim=1, keepdim=True)], dim=1))
    assert all(torch.equal(got["backbone." + k], v) for k, v in sd.items()
               if k != "patch_embed.proj.weight")
    _, swin_cfg, _ = _configs(backbone="swin")
    with pytest.raises(ValueError, match="backbone"):
        tckpt.load_pretrained(str(out), build_torch_model(swin_cfg,
                                                          device="cpu"),
                              swin_cfg)


# --- EVA-02: timm's names (the JAX package has no EVA-02 block) -------------

def _eva_config():
    return tconfig.from_dict({
        "model": {"backbone": "eva02_tiny_patch14_224", "image_size": 28,
                  "compute_dtype": "float32", "pool": "mean"},
        "data": {"use_segmentation_mask": True}})


def test_eva02_timm_file_loads_with_4th_channel_and_resampled_grid():
    """A timm-named EVA-02 backbone file (3 input channels, a 4 × 4 grid,
    timm's ImageNet head) onto a 28 px, 4-channel EVA-02 (2 × 2 grid): the
    patch embed widened by the RGB kernels' mean, the position embedding
    resampled, every other backbone tensor as in the file, the head and the
    metadata branch fresh, and the result loads strictly."""
    tcfg = _eva_config()
    target = _target(tcfg)
    sd = _source(target, 3, grid=4, extra=("head.weight", "head.bias"))
    assert "blocks.0.attn.k_proj.weight" in sd and "fc_norm.bias" in sd
    assert "blocks.0.attn.k_proj.bias" not in sd
    out = tiw.import_pretrained_file(sd, tcfg, target)
    w = out["backbone.patch_embed.proj.weight"]
    assert w.shape[1] == 4
    assert torch.equal(w[:, :3], sd["patch_embed.proj.weight"])
    torch.testing.assert_close(w[:, 3], sd["patch_embed.proj.weight"].mean(1),
                               atol=1e-7, rtol=0)
    assert out["backbone.pos_embed"].shape == (1, 5, 192)
    assert torch.equal(out["backbone.pos_embed"],
                       tiw.resample_vit_pos_embed(sd["pos_embed"], 4))
    for key, value in sd.items():
        if key.startswith("head.") or key in ("patch_embed.proj.weight",
                                              "pos_embed"):
            continue
        assert torch.equal(out["backbone." + key], value), key
    for key in target:
        if not key.startswith("backbone."):
            assert torch.equal(out[key], target[key]), key
    build_torch_model(tcfg, device="cpu").load_state_dict(out, strict=True)


@pytest.mark.parametrize("key", ["blocks.0.attn.k_proj.bias",
                                 "blocks.1.attn.qkv.weight", "norm.weight"])
def test_eva02_import_refuses_an_unknown_key(key):
    tcfg = _eva_config()
    target = _target(tcfg)
    sd = _source(target, 4, extra=(key,))
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        tiw.import_pretrained_file(sd, tcfg, target)


@pytest.mark.parametrize("key", ["blocks.1.mlp.norm.weight", "fc_norm.bias",
                                 "blocks.0.attn.v_proj.bias"])
def test_eva02_import_refuses_a_missing_key(key):
    tcfg = _eva_config()
    target = _target(tcfg)
    sd = {k: v for k, v in _source(target, 5).items() if k != key}
    with pytest.raises(KeyError, match=f"backbone.{key}".replace(".", r"\.")):
        tiw.import_pretrained_file(sd, tcfg, target)
