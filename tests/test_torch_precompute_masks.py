"""The wiring of the port's lesion segmenter against the JAX package's, on the
CPU: ``cli/precompute_masks.py``, ``HostDataSource`` and
``make_device_augment`` under ``data.on_device_masks``, the TTA refusal, and
the CLIs with masks segmented on the device.

The ISIC-2019 layout is written here: 24 training and 8 test lesion-like
JPEGs of 40×32, with a mask PNG each of 255 everywhere (so a mask that is
read shows). Tolerance: a mask from the segmenter agrees with JAX's on at
least 0.999 of each image's pixels (``tests/test_torch_cvseg.py`` says
why); the eval augment's image channels atol 1e-5 (its bicubic resize,
``tests/test_torch_image.py``).
"""

import copy
import json
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from fedvit_torch.cli import precompute_masks as tprecompute
from fedvit_torch.cli import predict as tpredict
from fedvit_torch.cli import train as tcli
from fedvit_torch.cli import train_federated as tfed_cli
from fedvit_torch.core import config as tconfig
from fedvit_torch.data import pipeline as tpipeline
from fedvit_torch.data.isic import load_isic_data
from fedvit_torch.eval import serve as tserve
from fedvit_tpu.cli import precompute_masks as jprecompute
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.data import pipeline as jpipeline
from fedvit_tpu.train import loop as jloop
from fedvit_tpu.utils import jaxcache

from tests.torch_parity import TINY, jax_variables, shallow_vit, torch_model

CLASSES = ["MEL", "NV", "BCC", "AK", "BKL", "DF", "VASC", "SCC", "UNK"]


def _split(root, masks, split, names):
    img_dir = root / f"ISIC_2019_{split}_Input"
    img_dir.mkdir(parents=True)
    onehot = np.zeros((len(names), 9))
    onehot[np.arange(len(names)), np.arange(len(names)) % 8] = 1
    gt = pd.DataFrame(onehot, columns=CLASSES)
    gt.insert(0, "image", names)
    gt.to_csv(root / f"ISIC_2019_{split}_GroundTruth.csv", index=False)
    pd.DataFrame({"image": names, "age_approx": 40.0,
                  "sex": ["male", "female"] * (len(names) // 2),
                  "anatom_site_general": "head/neck",
                  "lesion_id": [f"{split}_L{i // 2}" for i in range(len(names))]
                  }).to_csv(root / f"ISIC_2019_{split}_Metadata.csv",
                            index=False)
    rng = np.random.default_rng(len(split))
    yy, xx = np.mgrid[0:32, 0:40].astype(np.float32)
    for nm in names:
        cy, cx = rng.uniform(12, 20), rng.uniform(14, 26)
        r2 = ((yy - cy) / rng.uniform(5, 9)) ** 2 + \
            ((xx - cx) / rng.uniform(5, 9)) ** 2
        lesion = 1 / (1 + np.exp(np.clip(6 * (r2 - 1), -30, 30)))[..., None]
        img = (rng.uniform(190, 240, 3) * (1 - lesion)
               + rng.uniform(50, 120, 3) * lesion + rng.normal(0, 6, (32, 40, 3)))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            img_dir / f"{nm}.jpg", quality=90)
        Image.fromarray(np.full((32, 40), 255, np.uint8)).save(
            masks / f"{nm}.png")


@pytest.fixture
def isic_tree(tmp_path):
    root, masks = tmp_path / "ISIC", tmp_path / "masks"
    root.mkdir()
    masks.mkdir()
    _split(root, masks, "Training", [f"ISIC_{i:07d}" for i in range(24)])
    _split(root, masks, "Test", [f"ISIC_{i:07d}" for i in range(100, 108)])
    return root


def _raw(root, **data):
    raw = copy.deepcopy(TINY)
    raw["data"].update({"isic_dir": str(root), "use_segmentation_mask": True,
                        "on_device_masks": True, **data})
    raw["training"].update({"batch_size": 4, "num_workers": 2})
    return raw


def test_precompute_masks_matches_jax_cli(isic_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(jaxcache, "enable_compilation_cache", lambda: None)
    argv = ["--isic_dir", str(isic_tree), "--image_size", "32",
            "--workers", "2", "--batch", "8"]
    assert jprecompute.main(argv + ["--output_dir", str(tmp_path / "j")]) == 0
    assert tprecompute.main(argv + ["--output_dir", str(tmp_path / "t"),
                                    "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert len(names) == 32
    assert sorted(p.name for p in (tmp_path / "t").glob("*.png")) == names
    for name in names:
        want = np.asarray(Image.open(tmp_path / "j" / name))
        got = np.asarray(Image.open(tmp_path / "t" / name))
        assert got.shape == want.shape == (32, 32) and got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        assert (got == want).mean() >= 0.999, name
    lesion = np.asarray(Image.open(tmp_path / "t" / names[0])) > 0
    assert 0.03 < lesion.mean() < 0.6


def test_host_data_source_reads_no_mask_under_on_device_masks(isic_tree):
    train_df, _ = load_isic_data(str(isic_tree), log=lambda s: None)
    masks = str(isic_tree.parent / "masks")
    on = tconfig.from_dict(_raw(isic_tree, segmentation_mask_dir=masks))
    off = tconfig.from_dict(_raw(isic_tree, segmentation_mask_dir=masks,
                                 on_device_masks=False))
    src = tpipeline.HostDataSource(train_df, on)
    assert src.mask_dir is None
    got = src.gather(np.arange(4))["image"]
    assert got.shape == (4, 48, 48, 3) and got.dtype == np.uint8
    assert tpipeline.DeviceDataSource.nbytes_estimate(src) == 24 * 48 * 48 * 3
    both = tpipeline.HostDataSource(train_df, off).gather(np.arange(4))
    np.testing.assert_array_equal(both["image"][..., :3], got)
    assert (both["image"][..., 3] == 255).all()
    jsrc = jpipeline.HostDataSource(train_df, jconfig.from_dict(
        _raw(isic_tree, segmentation_mask_dir=masks)))
    np.testing.assert_array_equal(jsrc.gather(np.arange(4))["image"], got)


def _canvases(isic_tree):
    train_df, _ = load_isic_data(str(isic_tree), log=lambda s: None)
    cfg = tconfig.from_dict(_raw(isic_tree))
    return tpipeline.HostDataSource(train_df, cfg).gather(np.arange(6))


def test_eval_augment_segments_as_jax(isic_tree):
    batch = _canvases(isic_tree)
    raw = _raw(isic_tree)
    want = jax.jit(jpipeline.make_device_augment(
        jconfig.from_dict(copy.deepcopy(raw)), False))(
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    want = np.asarray(want["image"])
    got = tpipeline.make_device_augment(tconfig.from_dict(raw), False)(
        {k: torch.from_numpy(v) for k, v in batch.items()})["image"].numpy()
    assert got.shape == want.shape == (6, 32, 32, 4)
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-5)
    assert set(np.unique(got[..., 3])) <= {-1.0, 1.0}
    agree = (got[..., 3] == want[..., 3]).mean(axis=(1, 2))
    assert (agree >= 0.999).all(), agree
    assert (got[..., 3] == 1.0).mean() > 0.03


def test_train_augment_segments_each_call_and_a_packed_mask_wins(
        isic_tree, monkeypatch):
    batch = {k: torch.from_numpy(v) for k, v in _canvases(isic_tree).items()}
    calls = []
    segment = tpipeline.segment_lesion_batch

    def counted(img, size):
        calls.append((tuple(img.shape), size))
        return segment(img, size)

    monkeypatch.setattr(tpipeline, "segment_lesion_batch", counted)
    augment = tpipeline.make_device_augment(
        tconfig.from_dict(_raw(isic_tree)), True)
    out = augment(batch, torch.Generator().manual_seed(0))["image"]
    assert out.shape == (6, 32, 32, 4) and torch.isfinite(out).all()
    assert set(out[..., 3].unique().tolist()) <= {-1.0, 1.0}
    assert calls == [((6, 48, 48, 3), 48)]
    packed = dict(batch, image=torch.cat(
        [batch["image"], torch.zeros_like(batch["image"][..., :1])], -1))
    out = augment(packed, torch.Generator().manual_seed(0))["image"]
    assert len(calls) == 1 and (out[..., 3] == -1.0).all()


def test_tta_refuses_three_channel_canvases_of_a_mask_model_in_both(
        isic_tree):
    """JAX's TTA step takes a mask only from a 4th channel and never
    segments: the 4-channel model fails on the 3-channel canvases of
    on-device masks. The port refuses the same call with a ValueError."""
    batch = _canvases(isic_tree)
    raw = _raw(isic_tree)
    raw["training"]["tta"] = {"enabled": True}
    jcfg, tcfg = jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)
    with shallow_vit():
        model, variables = jax_variables(jcfg)
        source = jpipeline.ArrayDataSource(batch)
        with pytest.raises(flax.errors.ScopeParamShapeError):
            jloop.evaluate_with_tta(jcfg, model, variables["params"],
                                    variables["batch_stats"], source)
        tmodel = torch_model(tcfg, variables)
    with pytest.raises(ValueError, match="on_device_masks.*TTA|TTA.*"
                                         "on_device_masks"):
        tserve.evaluate_with_tta(tcfg, tmodel,
                                 tpipeline.ArrayDataSource(batch))


def _yaml(tmp_path, root, tta):
    raw = _raw(root)
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["training"].update({
        "epochs": 1, "gradient_accumulation_steps": 1, "cv": {"n_splits": 2},
        "scheduler": {"warmup_epochs": 0}, "tta": {"enabled": tta}})
    raw["federated"] = {"local_steps": 1}
    path = tmp_path / f"tta_{tta}.yaml"
    path.write_text(json.dumps(raw))
    return str(path)


def test_clis_train_and_predict_from_masks_segmented_on_the_device(
        isic_tree, tmp_path, capsys):
    config = _yaml(tmp_path, isic_tree, tta=False)
    logs = tmp_path / "log"
    with shallow_vit():
        assert tcli.main(["--config", config, "--fold", "0", "--log",
                          str(logs), "--device", "cpu"]) == 0
        ens = np.load(logs / "ensemble_logits.npy")
        assert ens.shape == (8, 8) and np.isfinite(ens).all()
        argv = ["--config", config, "--isic_dir", str(isic_tree),
                "--checkpoint", str(logs / "fold0" / "best_fold0"),
                "--output", str(tmp_path / "p.csv"), "--logits_out",
                str(tmp_path / "p.npy"), "--device", "cpu"]
        assert tpredict.main(argv) == 0
        logits = np.load(tmp_path / "p.npy")
        assert logits.shape == (8, 8) and np.isfinite(logits).all()
        with pytest.raises(ValueError, match="on_device_masks"):
            tpredict.main(argv + ["--tta"])
        assert tfed_cli.main(["--config", config, "--clients", "2",
                              "--rounds", "1", "--log", str(tmp_path / "fed"),
                              "--device", "cpu"]) == 0
        # the fold's TTA test on the 3-channel test canvases
        with pytest.raises(ValueError, match="on_device_masks"):
            tcli.main(["--config", _yaml(tmp_path, isic_tree, tta=True),
                       "--fold", "0", "--log", str(tmp_path / "log_tta"),
                       "--device", "cpu"])
    history = json.loads((tmp_path / "fed" / "federated_history.json")
                         .read_text())
    assert len(history) == 1 and np.isfinite(history[0]["loss"])


def test_precompute_masks_needs_a_card_unless_told_cpu(isic_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match=re.escape("device='cpu'")):
        tprecompute.main(["--isic_dir", str(isic_tree), "--output_dir",
                          str(tmp_path / "m")])
    assert not (tmp_path / "m").exists()
