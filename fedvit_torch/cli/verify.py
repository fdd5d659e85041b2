"""Verification harness — the port of ``fedvit_tpu/cli/verify.py``.

    python -m fedvit_torch.cli.verify [--device cuda|cpu]

The same 14 synthetic-data smoke checks on the same tiny configuration
(``vit_tiny_patch16_224`` at 32 px, fp32, batch 8 as 2 accumulations, EMA
0.99, asymmetric loss), each through the port's counterpart of the JAX call:
the model forward with and without metadata, the loss, EMA, MixUp/CutMix, the
LR schedule, the train/eval transforms, the metadata encoding, the synthetic
dataset and its source, the TTA views, a full train step (accumulation, LLRD,
clip, EMA), the bf16 path, a checkpoint round trip and the device augment.
Explicit ``torch.Generator``s take the place of JAX's keys. Each check prints
PASS or FAIL; the command exits 1 if any failed. It runs on the card unless
``--device cpu`` is given, and fails without one: on the card the model's
forwards run K1, the train step K2-K4 and the augment K7 and K8 at this
configuration's shapes.
"""

from __future__ import annotations

import argparse
import copy
import sys
import tempfile
import traceback
from typing import Callable, Dict


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Synthetic smoke-test suite")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from torch import nn

    from fedvit_torch.core.config import from_dict
    from fedvit_torch.core.device import resolve_device
    from fedvit_torch.data.constants import encode_metadata_vector
    from fedvit_torch.data.pipeline import ArrayDataSource, make_device_augment
    from fedvit_torch.data.synthetic import make_synthetic_dataset
    from fedvit_torch.models import build_model
    from fedvit_torch.ops import image as I
    from fedvit_torch.train import checkpoint as ckpt
    from fedvit_torch.train.ema import ema_init, ema_update
    from fedvit_torch.train.losses import build_loss
    from fedvit_torch.train.mixup import cutmix, mixup, mixup_cutmix
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.schedule import lr_curve
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    print(f"Device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    results: Dict[str, str] = {}

    def test(name: str):
        def deco(fn: Callable):
            def run():
                try:
                    fn()
                    results[name] = "PASS"
                    print(f"  [PASS] {name}")
                except Exception as e:
                    results[name] = f"FAIL: {e!r}"
                    print(f"  [FAIL] {name}: {e!r}")
                    traceback.print_exc()
            return run
        return deco

    def generator(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = from_dict({
        "model": {"backbone": "vit_tiny_patch16_224", "image_size": 32,
                  "compute_dtype": "float32", "drop_path_rate": 0.0},
        "data": {"use_segmentation_mask": False},
        "training": {"batch_size": 8, "gradient_accumulation_steps": 2,
                     "ema": {"enabled": True, "decay": 0.99}},
        "loss": {"type": "asymmetric"},
    })
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(4, 32, 32, 3)).astype(np.float32)).to(dev)
    meta = torch.zeros((4, 13), device=dev)
    loss_fn = build_loss(cfg)

    @test("model forward with metadata")
    def t1():
        with torch.no_grad():
            out = model(x, meta)
        assert out["logits"].shape == (4, 8)

    @test("model forward without metadata (zero-filled embedding)")
    def t2():
        with torch.no_grad():
            out = model(x, None)
        assert out["logits"].shape == (4, 8)

    @test("loss positive scalar")
    def t3():
        v = loss_fn(torch.zeros((4, 8), device=dev),
                    torch.zeros((4,), dtype=torch.long, device=dev))
        assert v.shape == () and float(v) > 0

    @test("EMA update/swap semantics")
    def t4():
        m = nn.Module()
        m.w = nn.Parameter(torch.ones(3, device=dev))
        s = ema_init(m)
        with torch.no_grad():
            m.w.mul_(3)
        ema_update(s, m, 0.9)
        assert np.allclose(s["w"].cpu().numpy(), 1.2)

    @test("MixUp / CutMix / combinator")
    def t5():
        labels = torch.zeros((4,), dtype=torch.long, device=dev)
        for fn in (mixup, cutmix):
            mixed, la, lb, lam = fn(x, labels, rng=np.random.default_rng(0),
                                    generator=generator(0))
            assert mixed.shape == x.shape and 0 <= lam <= 1
        mixed, *_ = mixup_cutmix(x, labels, rng=np.random.default_rng(1),
                                 generator=generator(1))
        assert mixed.shape == x.shape

    @test("scheduler warmup then cosine decay")
    def t6():
        c = lr_curve(1e-4, 5, 20, 1e-6)
        assert c[0] == 0.0 and c[1] < c[5] and c[-1] < c[6]

    @test("train/eval transforms (paired mask shapes)")
    def t7():
        m = torch.ones(x.shape[:3] + (1,), device=dev)
        draws = I.draw_train(generator(0), 4, 32, 32, randaugment_n=1)
        img, mk = I.train_transform(x, m, draws, out_size=24, randaugment_m=5)
        assert img.shape == (4, 24, 24, 3) and mk.shape == (4, 24, 24, 1)
        img, mk = I.eval_transform(x, m, out_size=24)
        assert img.shape == (4, 24, 24, 3)

    @test("metadata one-hot positions")
    def t8():
        v = encode_metadata_vector(0.5, 1, 3)
        assert v[0] == 0.5 and v[2] == 1.0 and v[1 + 3 + 3] == 1.0
        assert v.sum() == 2.5

    @test("synthetic dataset + source")
    def t9():
        data = make_synthetic_dataset(n=16, image_size=32)
        src = ArrayDataSource(data)
        b = src.gather(np.arange(4))
        assert b["image"].shape == (4, 32, 32, 3)
        assert b["metadata"].shape == (4, 13)

    @test("TTA views (8, deterministic)")
    def t10():
        views, _ = I.tta_views(x, out_size=24)
        assert views.shape == (4, 8, 24, 24, 3)
        v2, _ = I.tta_views(x, out_size=24)
        assert torch.allclose(views, v2)

    @test("full train step: accum+LLRD+clip+EMA")
    def t11():
        m = copy.deepcopy(model)
        tx, _ = build_optimizer(cfg, m, 4)
        state = TrainState.create(m, tx, seed=1)
        step = make_train_step(cfg, loss_fn)
        batch = {"image": torch.cat([x, x]),
                 "label": torch.zeros((8,), dtype=torch.long, device=dev),
                 "metadata": torch.zeros((8, 13), device=dev)}
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"])) and state.step == 1

    @test("bfloat16 compute path")
    def t12():
        cfg_bf = from_dict({"model": {"backbone": "vit_tiny_patch16_224",
                                      "image_size": 32,
                                      "compute_dtype": "bfloat16"},
                            "data": {"use_segmentation_mask": False}})
        m_bf = build_model(cfg_bf, device=args.device,
                           generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            out = m_bf(x, meta)
        assert out["logits"].dtype == torch.float32
        assert torch.isfinite(out["logits"]).all()

    @test("checkpoint save/load round-trip")
    def t13():
        m = copy.deepcopy(model)
        tx, _ = build_optimizer(cfg, m, 4)
        state = TrainState.create(m, tx, seed=1)
        first = next(m.parameters())
        saved = first.detach().clone()
        with tempfile.TemporaryDirectory() as d:
            ckpt.save_checkpoint(f"{d}/c", state, 3, 0.5, 1, cfg)
            with torch.no_grad():
                first.zero_()
            meta_d = ckpt.load_checkpoint(f"{d}/c", state)
            assert meta_d["epoch"] == 3 and meta_d["best_metric"] == 0.5
            assert torch.equal(first, saved)

    @test("device augment pipeline (uint8 → normalized)")
    def t14():
        aug = make_device_augment(cfg, train=True)
        raw = {"image": (x * 255).to(torch.uint8),
               "label": torch.zeros((4,), dtype=torch.long, device=dev),
               "metadata": torch.zeros((4, 13), device=dev)}
        out = aug(raw, generator(0))
        assert out["image"].shape == (4, 32, 32, 3)

    for fn in (t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11, t12, t13, t14):
        fn()

    n_pass = sum(1 for v in results.values() if v == "PASS")
    print(f"\n{'='*50}\n  {n_pass}/{len(results)} tests passed\n{'='*50}")
    if n_pass < len(results):
        for k, v in results.items():
            if v != "PASS":
                print(f"  FAILED: {k} — {v}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
