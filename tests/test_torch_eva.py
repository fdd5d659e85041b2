"""EVA-02 in the port (``models/eva.py``, ``ops/rotary.py``) against the
benchmark's plain reference of it (``benchmark/families/eva02.py``, written
from timm's equations, which imports nothing of the program), on the CPU in
fp32 at the family's tiny size (timm's EVA-02-Ti widths: E 192, 12 blocks of
3 heads of 64, SwiGLU width 512; 28 px, 2 × 2 patches of 14), seeded. The
JAX package has no EVA-02 block, so the reference stands in for it.

Tolerances: features and logits within 1e-5 of the reference's largest
|value| (the same fp32 function in another order: the rotation's table in
fp32 against the reference's in fp64, the attention's and norms' sums);
the three training losses rtol 1e-5; each leaf's first clipped gradient
within 1e-5 of the larger of its norm and the median leaf's, in the norm
(a bias before a BatchNorm has a zero gradient but for rounding); the
harness's numbers under 1e-3, as ``benchmark/tests`` holds every family
(the EMA's change, a share of the parameters' over three steps at decay
0.9995, reads the fp32 shadow's rounding against the reference's fp64 one:
about 2e-4). The rotation: the class token exact and each pair's norm to
fp32 rounding; its backward by ``gradcheck`` in fp64; θ then −θ the
identity to the fp32 table's rounding (cos² + sin² is 1 to about 1e-7).
"""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import checks, inputs, manifest, program
from benchmark.reference import models as ref_models
from benchmark.tests.tiny import tiny_cell
from fedvit_torch.models import build_model
from fedvit_torch.models.eva import Eva
from fedvit_torch.models.registry import build_backbone
from fedvit_torch.ops import rotary

SEED = 2 ** 31 + 2323
CPU = torch.device("cpu")
EVA = manifest.family_module("eva02")


def _program_and_weights(cell):
    cfg = program.program_config(cell)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    spec = ref_models.param_spec(cell.config["model"])
    w = inputs.make_weights(spec, SEED, CPU)
    running = inputs.running_stats(spec, CPU)
    program.load_weights(model, w, running)
    return model, w, running


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def test_features_and_logits_match_the_reference():
    cell = tiny_cell("eva02")
    arch = cell.config["model"]
    model, w, running = _program_and_weights(cell)
    g = torch.Generator().manual_seed(3)
    s = arch["image_size"]
    x = torch.randn(5, s, s, 4, generator=g)
    meta = torch.randn(5, 13, generator=g)
    with torch.no_grad():
        out = model.eval()(x, meta)
        feats = EVA.features(x, w, arch, {}, ref_models.Precision(), False)
        logits = ref_models.classifier(x, meta, w, arch, None,
                                       ref_models.Precision(), train=False,
                                       running=running)
    assert isinstance(model.backbone, Eva)
    assert _gap(out["features"], feats) < 1e-5
    assert _gap(out["logits"], logits) < 1e-5


class _FullGrads:
    """The train step as the epoch loop calls it, keeping each step's loss
    and the first step's whole clipped gradient (Adam's first moment after
    one step over 1 − β₁)."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.grads = None

    def __getattr__(self, name):
        return getattr(self.recorder, name)

    def __call__(self, state, batch):
        state, m = self.recorder(state, batch)
        if self.grads is None:
            b1 = self.recorder.b1
            self.grads = {n: t.float() / (1.0 - b1)
                          for n, t in state.opt_state["mu"].items()}
        return state, m


def test_three_training_steps_match_the_reference():
    """``TrainStep`` through the epoch loop (augment, mix, drop-path,
    forward, asymmetric focal loss, backward, clip, AdamW-LLRD, EMA): the
    three losses, every leaf's first gradient, the parameters' change and
    the EMA's against the reference's three steps from the same inputs."""
    cell = tiny_cell("eva02", resident=24, micro=4)
    mode = manifest.mode_module("train_epoch")
    objs = mode.build(cell, SEED, CPU)
    full = _FullGrads(objs["step"])
    objs["step"] = full
    prog = mode.first_steps(cell, SEED, objs, CPU)
    ref = mode.reference_readings(cell, SEED, CPU)
    np.testing.assert_allclose(prog["loss"], ref["loss"], rtol=1e-5)
    assert set(full.grads) == set(ref["grads"])
    # a leaf's gap over the larger of its norm and the median leaf's (a bias
    # before a BatchNorm has a zero gradient but for rounding)
    norms = {n: float(t.norm()) for n, t in ref["grads"].items()}
    median = float(np.median(list(norms.values())))
    for name, want in ref["grads"].items():
        gap = float((full.grads[name] - want).norm())
        assert gap <= 1e-5 * max(norms[name], median), (name, gap, norms[name])
    numbers = checks.training_numbers(prog, ref)
    assert all(v < 1e-3 for v, _ in numbers.values()), numbers


def _table(grid=4, head_dim=64):
    return rotary.rope_table(grid, head_dim, 16)


def test_the_table_is_the_equations():
    """``rope_table`` against the reference's angles from the equations (in
    fp64): rows then columns, the first quarter of a head's pairs the row's
    frequencies, positions scaled to the 16-patch pretraining grid."""
    arch = {"image_size": 14 * 32, "patch_size": 14, "embed_dim": 1024,
            "num_heads": 16, "rope_ref_grid": 16}
    cos, sin = rotary.rope_table(32, 64, 16)
    theta = EVA.rope_angles(arch, "cpu")
    assert cos.shape == sin.shape == theta.shape == (1024, 32)
    torch.testing.assert_close(cos.double(), torch.cos(theta), atol=2e-6,
                               rtol=0)
    torch.testing.assert_close(sin.double(), torch.sin(theta), atol=2e-6,
                               rtol=0)
    # patch (row 1, column 0) turns its row pairs by 16/32 · T^(−j/16)
    assert float(theta[32, 0]) == 0.5 and float(theta[32, 16]) == 0.0
    assert float(theta[1, 16]) == 0.5 and float(theta[1, 0]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_rotation_keeps_the_class_token_and_each_pair_norm(dtype):
    cos, sin = _table()
    x = torch.randn(3, 17, 128, generator=torch.Generator().manual_seed(5),
                    dtype=dtype)
    y = rotary.rotate_plain(x, cos, sin)
    assert y.dtype == dtype and torch.equal(y[:, 0], x[:, 0])
    pairs = lambda t: t[:, 1:].reshape(3, 16, 64, 2).square().sum(-1)  # noqa: E731
    torch.testing.assert_close(pairs(y), pairs(x), rtol=1e-6, atol=1e-6)
    want = EVA.rotate(x.double(), cos.double(), sin.double(), 2)
    torch.testing.assert_close(y.double(), want, rtol=0,
                               atol=1e-6 if dtype == torch.float32 else 1e-12)


def test_the_backward_is_the_rotation_by_minus_theta():
    cos, sin = _table(grid=3)
    g = torch.Generator().manual_seed(6)
    q, k = (torch.randn(2, 10, 128, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b: rotary.rotary_qk(a, b, cos, sin), (q, k))
    dq, dk = torch.randn_like(q), torch.randn_like(k)
    qo, ko = rotary.rotary_qk(q, k, cos, sin)
    torch.autograd.backward([qo, ko], [dq, dk])
    assert torch.equal(q.grad, rotary.rotate_plain(dq, cos, -sin))
    assert torch.equal(k.grad, rotary.rotate_plain(dk, cos, -sin))
    # turning by θ then by −θ is the identity to the table's rounding
    back = rotary.rotate_plain(rotary.rotate_plain(q, cos, sin), cos, -sin)
    torch.testing.assert_close(back, q, rtol=0, atol=1e-6)


def test_the_registry_builds_eva02_large_at_its_published_widths():
    with torch.device("meta"):
        mod, dim = build_backbone(
            "eva02_large_patch14_448.mim_m38m_ft_in22k_in1k", 448, 4, 0.2,
            "mean", "bfloat16")
    assert isinstance(mod, Eva) and dim == 1024
    assert len(mod.blocks) == 24
    blk = mod.blocks[0]
    assert blk.attn.num_heads == 16 and blk.attn.q_proj.weight.shape == (1024,
                                                                          1024)
    assert blk.mlp.fc1_g.weight.shape == (2730, 1024)
    assert blk.mlp.norm.weight.shape == (2730,)
    assert mod.pos_embed.shape == (1, 1025, 1024)
    assert mod.rope_cos.shape == (1024, 32)
    names = {n for n, _ in mod.named_parameters()}
    assert "blocks.0.attn.k_proj.bias" not in names
    assert {"blocks.0.attn.q_proj.bias", "blocks.0.attn.v_proj.bias",
            "fc_norm.weight"} <= names
    assert not any(n.startswith("norm.") for n in names)
    count = sum(p.numel() for p in mod.parameters())
    assert abs(count - 304e6) < 1e6, count
    assert not any(k.startswith("rope") for k in mod.state_dict())


@pytest.mark.parametrize("size,width,depth,heads,hidden", [
    ("tiny", 192, 12, 3, 512), ("small", 384, 12, 6, 1024),
    ("base", 768, 12, 12, 2048)])
def test_the_smaller_names_build_the_same_block(size, width, depth, heads,
                                                hidden):
    with torch.device("meta"):
        mod, dim = build_backbone(f"eva02_{size}_patch14_224", 224, 4)
    assert isinstance(mod, Eva) and dim == width and len(mod.blocks) == depth
    assert mod.blocks[0].attn.num_heads == heads
    assert mod.blocks[0].mlp.fc1_x.weight.shape == (hidden, width)
    assert mod.pos_embed.shape == (1, 257, width)


def test_vit_names_stay_vits():
    from fedvit_torch.models.vit import VisionTransformer
    with torch.device("meta"):
        mod, _ = build_backbone("vit_tiny_patch16_224", 32)
    assert isinstance(mod, VisionTransformer)
    with pytest.raises(ValueError, match="Unknown backbone"):
        build_backbone("eva_large_patch14_448", 448)


def test_remat_gives_the_same_loss_and_gradients():
    """``model.remat`` rematerialises each EVA block through
    ``layers.py::run_blocks``: the same features and gradients bit for bit,
    drop-path masks included."""
    kw = dict(image_size=28, patch_size=14, in_channels=4, embed_dim=128,
              depth=3, num_heads=2, mlp_hidden=342, drop_path_rate=0.3)
    torch.manual_seed(0)
    plain = Eva(**kw).train()
    remat = Eva(remat=True, **kw).train()
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(4, 28, 28, 4, generator=torch.Generator().manual_seed(1))
    outs = []
    for m in (plain, remat):
        y = m(x, torch.Generator().manual_seed(7))
        y.square().sum().backward()
        outs.append((y, [p.grad for p in m.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert math.isfinite(float(outs[0][0].detach().sum()))
