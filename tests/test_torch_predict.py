"""The predict CLI on the fold checkpoints that the port's ``train_fold``
writes, on the CPU.

One epoch of ``train_fold`` on ``vit_tiny_patch16_224`` at ``image_size`` 32,
cut to 2 blocks (``torch_parity.shallow_vit``), writes ``best_fold0``. The CLI
serves that directory with the EMA shadow in the model's parameters, as
``fedvit_tpu/cli/predict.py`` serves ``state.eval_params()``, and with the
trained parameters under ``--no-ema``; ``--no-ema`` with a bare ``.pt`` is
refused. Tolerance: exact — the CLI and the reference run the same code on
the same CPU, batch for batch.
"""

import copy

import numpy as np
import pytest
import torch
import yaml

from fedvit_torch.cli import predict
from fedvit_torch.core import config as tconfig
from fedvit_torch.data import pipeline as tpipe
from fedvit_torch.eval import serve
from fedvit_torch.train import checkpoint as tckpt
from fedvit_torch.train import loop as tloop

from tests.torch_parity import TINY, shallow_vit

RAW = copy.deepcopy(TINY)
RAW["data"]["use_segmentation_mask"] = False
RAW["training"].update({"batch_size": 4, "epochs": 1,
                        "gradient_accumulation_steps": 1,
                        "scheduler": {"warmup_epochs": 0},
                        "optimizer": {"lr": 1e-3}, "ema": {"decay": 0.9},
                        "tta": {"enabled": False}})


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return tpipe.ArrayDataSource({
        "image": rng.integers(0, 256, (n, 48, 48, 3), dtype=np.uint8),
        "label": rng.integers(0, 8, n).astype(np.int32),
        "metadata": rng.random((n, 13)).astype(np.float32)})


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """(config path, best_fold0, images directory) after one epoch."""
    from PIL import Image

    root = tmp_path_factory.mktemp("predict_fold")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(5)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)
                        ).save(images / f"lesion_{i}.png")
    cfg_path = root / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(RAW))
    torch.manual_seed(0)
    with shallow_vit():
        tloop.train_fold(tconfig.from_dict(copy.deepcopy(RAW)), 0, _data(8, 1),
                         _data(4, 2), workdir=str(root), log=lambda s: None,
                         device="cpu")
        yield cfg_path, root / "best_fold0", images


def _predict(fold, tmp_path, *extra):
    cfg_path, best, images = fold
    out = tmp_path / "logits.npy"
    assert predict.main(["--config", str(cfg_path), "--checkpoint", str(best),
                         "--images", str(images), "--output",
                         str(tmp_path / "pred.csv"), "--logits_out", str(out),
                         "--device", "cpu", *extra]) == 0
    return np.load(out)


def _served(fold, ema):
    """The logits ``_evaluate`` gives on the restored state, inside
    ``state.ema_weights()`` or outside it."""
    cfg_path, best, images = fold
    cfg = tconfig.load_config(str(cfg_path))
    _, state = tloop.init_model_state(cfg, cfg.seed, device="cpu",
                                      steps_per_epoch=2)
    tckpt.load_checkpoint(str(best), state)
    source = tpipe.HostDataSource(predict._images_dataframe(str(images)), cfg)
    augment = tpipe.make_device_augment(cfg, False)
    bs = cfg.training.batch_size
    if not ema:
        step = serve.make_eval_step(state.model, cfg, augment=augment)
        return serve._evaluate(step, source, bs, cfg.num_classes)["logits"]
    with state.ema_weights() as model:
        step = serve.make_eval_step(model, cfg, augment=augment)
        return serve._evaluate(step, source, bs, cfg.num_classes)["logits"]


def test_predict_serves_the_fold_checkpoints_ema_shadow(fold, tmp_path):
    want = _served(fold, ema=True)
    np.testing.assert_array_equal(_predict(fold, tmp_path), want)
    # the shadow is not the trained parameters: the check can tell them apart
    assert not np.allclose(want, _served(fold, ema=False), atol=1e-4)


def test_predict_no_ema_serves_the_trained_parameters(fold, tmp_path):
    np.testing.assert_array_equal(_predict(fold, tmp_path, "--no-ema"),
                                  _served(fold, ema=False))


def test_predict_refuses_no_ema_on_a_state_dict(fold, tmp_path):
    cfg_path, _, images = fold
    pt = tmp_path / "fold0.pt"
    torch.save({}, pt)
    with pytest.raises(SystemExit, match="--no-ema needs checkpoint"):
        predict.main(["--config", str(cfg_path), "--checkpoint", str(pt),
                      "--images", str(images), "--no-ema", "--device", "cpu"])
