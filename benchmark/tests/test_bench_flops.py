"""The operation and byte counts the rooflines and MFU divide by."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops, inputs, manifest
from benchmark.harness.manifest import BENCH_DIR
from benchmark.reference import models as ref_models
from benchmark.tests.tiny import FAMILIES, tiny_cell


def arch_of(name):
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("batch", [1, 3])
def test_forward_flops_match_the_flop_counter(family, batch):
    """Every product of the reference's forward, as torch counts them."""
    arch = tiny_cell(family).config["model"]
    spec = ref_models.param_spec(arch)
    w = inputs.make_weights(spec, 5, "cpu")
    run = inputs.running_stats(spec, "cpu")
    x = torch.randn(batch, arch["image_size"], arch["image_size"], 4)
    meta = torch.randn(batch, 13)
    with FlopCounterMode(display=False) as counter:
        ref_models.classifier(x, meta, w, arch, None, ref_models.Precision(),
                              train=False, running=run)
    assert counter.get_total_flops() == flops.forward_flops(arch, batch)


def test_published_sizes_match_the_analytic_counts():
    """The JAX package's bench.py counted 35.20 GFLOP a ViT-B/16@224 forward
    and 232.04 a SwinV2-L@384 one (4-channel embedding); these counts add
    the head and metadata MLP, and amortise SwinV2's position-bias MLP over
    the batch."""
    vit, swin = arch_of("vit-base-224"), arch_of("swinv2-large-384")
    assert flops.forward_flops(vit, 1) == pytest.approx(35.2032e9, rel=1e-4)
    assert flops.forward_flops(swin, 1) == pytest.approx(232.0364e9, rel=1e-4)
    assert flops.train_flops(swin, 16) == 3 * flops.forward_flops(swin, 16)


# chip_smoke.py's bounds beside its kernel checks, frozen: K2 (qkvb forward
# with lse), K3 (its backward), K5 (windowed forward) and its lse entry, K6
def k2(b, n, heads, d):
    e = heads * d
    qkv, bias, out, lse = b * n * 3 * e, 3 * e, b * n * e, b * heads * n
    return (qkv + bias + out) * 2 + lse * 4, 4.0 * b * heads * n * n * d


def k3(b, n, heads, d):
    e = heads * d
    qkv, dout, bias = b * n * 3 * e, b * n * e, 3 * e
    return (2 * qkv + dout + bias) * 2 + bias * 4, 10.0 * b * heads * n * n * d


def k5(rows, n, heads, masked):
    q = rows * n * heads * 32
    extra = heads * n * n * 4 + (masked * n * n * 4 if masked else 0)
    return 4 * q * 2 + extra, 4.0 * rows * heads * n * n * 32


def k6(rows, n, heads, masked):
    q = rows * n * heads * 32
    extra = (heads * n * n + (masked * n * n if masked else 0)) * 4
    return 7 * q * 2 + extra + heads * n * n * 4, 10.0 * rows * heads * n * n * 32


@pytest.mark.parametrize("b", [64, 128])
def test_vit_attention_counts_are_chip_smokes(b):
    vit_call = manifest.family_module("vit").vit_call
    assert vit_call(b, 197, 768, 12, 64, "train_fwd") == k2(b, 197, 12, 64)
    assert vit_call(b, 197, 768, 12, 64, "train_bwd") == k3(b, 197, 12, 64)


@pytest.mark.parametrize("stage", [(16, 576, 6, 16), (4, 576, 12, 4),
                                   (1, 576, 24, 0), (1, 144, 48, 0)])
def test_window_attention_counts_are_chip_smokes(stage):
    windows, n, heads, masked = stage
    rows = 8 * windows
    c = heads * 32
    window_call = manifest.family_module("swinv2").window_call
    fwd = k5(rows, n, heads, masked)
    assert window_call(rows, n, c, heads, masked, "serve") == fwd
    lse = (fwd[0] + rows * heads * n * 4, fwd[1])
    assert window_call(rows, n, c, heads, masked, "train_fwd") == lse
    assert window_call(rows, n, c, heads, masked, "train_bwd") == \
        k6(rows, n, heads, masked)


def test_swin_attention_calls_follow_the_stages():
    calls = flops.attention_calls(arch_of("swinv2-large-384"), 8, "serve")
    assert len(calls) == 24
    # stage 0's odd blocks carry the shift mask of 16 windows
    assert calls[1][0] - calls[0][0] == 16 * 576 * 576 * 4
    assert flops.attention_least_seconds(arch_of("vit-base-224"), 2,
                                         ("serve",)) > 0
