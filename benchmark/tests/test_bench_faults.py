"""A run whose timed path is broken underneath comes out not correct, once
for each fault the cells can have; and so does the control, the reference
computed in fp8 in the program's place. The runs skip the look for a card
and run on the CPU at a tiny size, held to the real cells' limits."""

import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import checks, manifest
from benchmark.tests.tiny import CPU, tiny_cell

SEED = 3 * 10 ** 9 + 17
TRAIN_CELL = "vitb224-train-1x128"


def limits(name):
    return manifest.load_cell(name).limits


def run_tiny(cell):
    code, out = run.execute(cell, SEED, 1.0, False, time.time(), "cpu",
                            log=lambda s: None)
    assert code == 0
    return out


@pytest.fixture
def vit_train():
    return tiny_cell("vit", resident=16, limits=limits(TRAIN_CELL))


def test_a_sound_run_is_correct(vit_train):
    assert run_tiny(vit_train)["correct"]


def test_a_step_that_returns_its_state_unchanged(vit_train, monkeypatch):
    from fedvit_torch.train import step as step_mod
    from fedvit_torch.train.optim import global_norm

    def unchanged(self, state, grads):
        state.step += 1
        return global_norm(grads.values())

    monkeypatch.setattr(step_mod.TrainStep, "apply_update", unchanged)
    out = run_tiny(vit_train)
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(vit_train, monkeypatch):
    from fedvit_torch.train import step as step_mod
    whole = step_mod.TrainStep._micro_loss

    def half(self, model, state, x, y, meta, ya, yb, lam):
        h = x.shape[0] // 2
        cut = lambda t: None if t is None else t[:h]  # noqa: E731
        return whole(self, model, state, x[:h], y[:h], cut(meta), cut(ya),
                     cut(yb), lam)

    monkeypatch.setattr(step_mod.TrainStep, "_micro_loss", half)
    assert not run_tiny(vit_train)["correct"]


def test_a_loss_altered_where_it_is_produced(vit_train, monkeypatch):
    from fedvit_torch.train import step as step_mod
    whole = step_mod.TrainStep.__call__

    def altered(self, state, batch):
        state, m = whole(self, state, batch)
        return state, dict(m, loss=m["loss"] * 1.1)

    monkeypatch.setattr(step_mod.TrainStep, "__call__", altered)
    assert not run_tiny(vit_train)["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from fedvit_torch.eval import serve
    make = serve.make_eval_step

    def altered(*a, **k):
        step = make(*a, **k)

        def eval_step(batch):
            logits = step(batch).clone()
            logits[:, 0] += 1.0
            return logits
        return eval_step

    monkeypatch.setattr(serve, "make_eval_step", altered)
    cell = tiny_cell("swinv2", mode="predict", resident=16,
                     limits=limits("swinv2l384-predict-b32"))
    assert not run_tiny(cell)["correct"]


def test_the_fp8_control_of_a_training_cell_fails():
    cell = tiny_cell("vit")
    mode = manifest.mode_module("train_epoch")
    ref = mode.reference_readings(cell, SEED, CPU)
    low = mode.reference_readings(cell, SEED, CPU, precision="fp8")
    ok, compared = checks.judge(checks.training_numbers(low, ref),
                                limits(TRAIN_CELL))
    assert not ok, compared


def test_the_fp8_control_of_the_serving_cell_fails():
    cell = tiny_cell("swinv2", mode="predict", resident=16)
    mode = manifest.mode_module("predict")
    images = np.arange(8)
    ref = mode.reference_logits(cell, SEED, images, CPU)
    low = mode.reference_logits(cell, SEED, images, CPU, precision="fp8")
    ok, compared = checks.judge({"logit_gap": checks.logit_gap(low, ref)},
                                limits("swinv2l384-predict-b32"))
    assert not ok, compared


def test_torch_default_tf32_flags_come_back_after_the_reference():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    from benchmark.reference.models import fp32_products
    with fp32_products():
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
