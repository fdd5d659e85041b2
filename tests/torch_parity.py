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


ISIC_COLUMNS = ["MEL", "NV", "BCC", "AK", "BKL", "DF", "VASC", "SCC", "UNK"]


def write_isic_tree(root, n_train=40, test="labelled", n_test=12, seed=0,
                    site_column="anatom_site_general", masks=None):
    """A seeded ISIC-2019 layout under ``root``: one-hot ground truth with
    UNK rows, metadata with NaN ages, mixed-case sex, unknown and missing
    sites and lesions of 1-3 images, small JPEGs of two sizes, a few CSV rows
    without a JPEG; a test split that is ``"labelled"``, ``"unlabelled"``
    (metadata and images only) or None; with ``masks`` a directory, one mask
    PNG per image there. Returns ``root``."""
    from pathlib import Path

    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = Path(root)
    masks = None if masks is None else Path(masks)
    if masks is not None:
        masks.mkdir(parents=True, exist_ok=True)

    def split(name, names, labels, missing):
        img_dir = root / f"ISIC_2019_{name}_Input"
        img_dir.mkdir(parents=True, exist_ok=True)
        onehot = np.zeros((len(names), 9))
        onehot[np.arange(len(names)), labels] = 1.0
        gt = pd.DataFrame(onehot, columns=ISIC_COLUMNS)
        gt.insert(0, "image", names)
        sizes = rng.integers(1, 4, len(names))
        lesions = np.repeat(np.arange(len(names)), sizes)[:len(names)]
        ages = rng.choice([np.nan, 15.0, 40.0, 55.0, 85.0, 95.0], len(names))
        meta = pd.DataFrame({
            "image": names, "age_approx": ages,
            "sex": rng.choice(["male", "Female", "MALE", "female", None],
                              len(names)),
            site_column: rng.choice(["head/neck", "Anterior Torso",
                                     "lower extremity", "palms/soles",
                                     "nowhere", None], len(names)),
            "lesion_id": [f"{name}_L{i}" for i in lesions]})
        for i, nm in enumerate(names):
            if i in missing:
                continue
            h, w = ((30, 40), (48, 48))[i % 2]
            y, x = np.mgrid[0:h, 0:w]
            blob = np.exp(-((y - h / 2) ** 2 + (x - w / 2) ** 2) / (h * w / 8))
            img = (200 - 120 * blob[..., None] * rng.uniform(0.5, 1.0, 3)
                   + rng.normal(0, 8, (h, w, 3)))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                img_dir / f"{nm}.jpg", quality=90)
            if masks is not None:
                Image.fromarray((blob > 0.5).astype(np.uint8) * 255).save(
                    masks / f"{nm}.png")
        return gt, meta

    names = [f"ISIC_{i:07d}" for i in range(n_train)]
    labels = np.arange(n_train) % 8
    labels[[5, 17]] = 8                                   # UNK: dropped
    gt, meta = split("Training", names, labels, missing={3, 17, 30})
    gt.to_csv(root / "ISIC_2019_Training_GroundTruth.csv", index=False)
    meta.to_csv(root / "ISIC_2019_Training_Metadata.csv", index=False)
    if test is not None:
        names = [f"ISIC_{i:07d}" for i in range(1000, 1000 + n_test)]
        labels = rng.permutation(np.arange(n_test) % 8)
        labels[-1] = 8                                    # UNK: dropped
        gt, meta = split("Test", names, labels, missing={n_test - 2})
        meta.drop(columns="lesion_id").to_csv(
            root / "ISIC_2019_Test_Metadata.csv", index=False)
        if test == "labelled":
            gt.to_csv(root / "ISIC_2019_Test_GroundTruth.csv", index=False)
    return root
