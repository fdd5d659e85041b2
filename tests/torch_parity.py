"""Shared fixtures of the fedvit_torch parity tests: one raw config read by
both packages' schemas, seeded JAX variables, and the port's model built on
the CPU from those same variables."""

from __future__ import annotations

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedvit_torch.core import config as tconfig
from fedvit_torch.models import build_model as build_torch_model
from fedvit_torch.models import registry as tregistry
from fedvit_torch.models import vit as tvit
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.models import build_model as build_jax_model
from fedvit_tpu.models import registry as jregistry
from fedvit_tpu.models import vit as jvit

TINY = {
    "model": {"backbone": "vit_tiny_patch16_224", "image_size": 32,
              "compute_dtype": "float32", "drop_path_rate": 0.0,
              "metadata": {"enabled": True}},
    "data": {"use_segmentation_mask": True},
    "training": {"batch_size": 8, "num_workers": 1},
}

# A two-stage SwinV2 small enough for the CPU, under a name both registries
# know: at image_size 32 stage 0 is an 8×8 map of four 4×4 windows (its second
# block shifts and takes the mask), stage 1 a 4×4 map that the window covers
# (clamped, no shift). Heads of 32, as in every SwinV2 the registries build.
SWIN_NAME = "swinv2_parity_window4"
SWIN_SPEC = dict(family="swinv2", embed_dim=32, depths=(2, 2),
                 num_heads=(1, 2), window_size=4,
                 pretrained_window_sizes=(2, 2))
jregistry.BACKBONE_SPECS[SWIN_NAME] = SWIN_SPEC
tregistry.BACKBONE_SPECS[SWIN_NAME] = SWIN_SPEC
BACKBONES = {"vit": TINY["model"]["backbone"], "swin": SWIN_NAME}


@contextlib.contextmanager
def shallow_vit():
    """``vit_tiny`` cut to 2 blocks in both packages' ``VIT_CONFIGS`` inside
    the block: its width and heads, a sixth of the XLA compile of a step."""
    with pytest.MonkeyPatch.context() as mp:
        for configs_ in (jvit.VIT_CONFIGS, tvit.VIT_CONFIGS):
            mp.setitem(configs_, "tiny", dict(configs_["tiny"], depth=2))
        yield


def raw_config(use_mask: bool = True, metadata: bool = True,
               backbone: str = "vit") -> dict:
    raw = copy.deepcopy(TINY)
    raw["data"]["use_segmentation_mask"] = use_mask
    raw["model"]["metadata"]["enabled"] = metadata
    raw["model"]["backbone"] = BACKBONES[backbone]
    return raw


def configs(use_mask: bool = True, metadata: bool = True,
            backbone: str = "vit"):
    """(JAX Config, port Config) from one raw dict."""
    raw = raw_config(use_mask, metadata, backbone)
    return jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)


def jax_variables(cfg, seed: int = 0):
    """Initialised JAX ISICClassifier variables, every leaf then moved by
    seeded numpy noise (so zero-initialised biases and unit BN statistics
    are exercised too), as nested dicts of float32 numpy arrays."""
    model = build_jax_model(cfg)
    s = cfg.model.image_size
    x = jnp.zeros((2, s, s, cfg.in_channels), jnp.float32)
    meta = jnp.zeros((2, 13), jnp.float32)
    key = jax.random.key(seed)
    # jitted: one XLA compile, where an eager init compiles op by op
    init = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x, meta))
    v = jax.device_get(init(key))
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        noise = rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(leaf + noise) + 0.5
        return leaf + noise

    v = jax.tree_util.tree_map_with_path(move, dict(v))
    return model, {"params": v["params"], "batch_stats": v["batch_stats"]}


def torch_model(tcfg, variables, **kw):
    """The port's ISICClassifier on the CPU with the JAX variables loaded."""
    model = build_torch_model(tcfg, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


def flat(tree, prefix=()):
    """A nested dict of arrays as {path tuple: numpy array}."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, prefix + (k,)))
    return out
