"""The plain reference against the program's plain path at a tiny size in
fp32 on the CPU: the same three training steps (augment, mix, masks,
forward, loss, gradients, AdamW-LLRD, EMA) and the same served logits."""

import time

import pytest

from benchmark.harness import checks, manifest, report
from benchmark.tests.tiny import CPU, FAMILIES, tiny_cell

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("family", FAMILIES)
def test_three_training_steps_match_the_program(family):
    cell = tiny_cell(family)
    mode = manifest.mode_module("train_epoch")
    objs = mode.build(cell, SEED, CPU)
    prog = mode.first_steps(cell, SEED, objs, CPU)
    ref = mode.reference_readings(cell, SEED, CPU)
    numbers = checks.training_numbers(prog, ref)
    assert all(v < 1e-3 for v, _ in numbers.values()), numbers


@pytest.mark.parametrize("family", FAMILIES)
def test_served_logits_match_the_program(family):
    cell = tiny_cell(family, mode="predict", resident=16, micro=4)
    ctx = report.Context(cell, SEED, 1.0, False, time.time(), CPU)
    m = manifest.mode_module("predict").run(ctx)
    assert m.attempted > 0
    assert m.numbers["logit_gap"][0] < 1e-4
