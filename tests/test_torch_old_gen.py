"""The old generation's modules in the port against the JAX package's, on the
CPU: the Attention U-Net (``models/unet.py``), the three fusions
(``models/fusion.py``), ``MetadataEmbedding``, the LayerNorm head and the
whole HybridViT ``ISICClassifier``. Weights cross by ``state_dict_from_jax``;
inputs are seeded numpy.

Tolerances, with their reasons: everything runs in fp32, and the two sides
differ only by summation order (convolutions, matmuls, the BatchNorm and
LayerNorm statistics, the resize's contractions), some 1e-6 of the values;
each comparison allows 1e-4 of the reference's largest |value| (``close``).
The running statistics are fp32 means over the batch, held the same way.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.models import build_model
from fedvit_torch.models import fusion as tfusion
from fedvit_torch.models import unet as tunet
from fedvit_torch.models.heads import ClassifierHead as TorchHead
from fedvit_torch.models.import_weights import (load_jax_variables,
                                                state_dict_from_jax)
from fedvit_torch.models.metadata import MetadataEmbedding as TorchEmbedding
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.models import fusion as jfusion
from fedvit_tpu.models import unet as junet
from fedvit_tpu.models.heads import ClassifierHead as JaxHead
from fedvit_tpu.models.metadata import MetadataEmbedding as JaxEmbedding

from tests.torch_parity import jax_variables, raw_config, shallow_vit

ENC, DEC = (8, 16, 32, 64), (32, 16, 8, 4)
RTOL = 1e-4


def close(got, want, what=""):
    """|got − want| ≤ 1e-4 × max |want| (fp32 summation order)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def seeded(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def nested(prefix, tree):
    for p in reversed(prefix):
        tree = {p: tree}
    return tree


def jax_init(module, *args, seed=0):
    """``module``'s variables, every leaf moved by seeded noise (running
    variances kept positive), as nested dicts of numpy arrays."""
    v = jax.device_get(jax.jit(module.init)(jax.random.key(seed), *args))
    rng = np.random.default_rng(seed + 1)

    def move(path, leaf):
        leaf = np.asarray(leaf, np.float32) + rng.normal(
            0.0, 0.1, np.shape(leaf)).astype(np.float32)
        return np.abs(leaf) + 0.5 if path[-1].key == "var" else leaf

    v = jax.tree_util.tree_map_with_path(move, dict(v))
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def load(module, variables, prefix):
    """``variables`` of a JAX submodule at ``prefix`` of the ISICClassifier
    tree, loaded strictly into the port's counterpart ``module``."""
    sd = state_dict_from_jax({
        "params": nested(prefix, variables["params"]),
        "batch_stats": nested(prefix, variables["batch_stats"])})
    head = ".".join(prefix) + "."
    module.load_state_dict({k[len(head):]: v for k, v in sd.items()})
    return module


def stats_of(module):
    return {n: b.clone() for n, b in module.named_buffers()}


def jax_stats(batch_stats):
    """The flax tree's statistics under the port's buffer names."""
    sd = state_dict_from_jax({"params": {}, "batch_stats": nested(
        ("seg_branch", "m"), batch_stats)})
    return {k[len("seg_branch.m."):]: v for k, v in sd.items()}


def run_both(jmod, tmod, variables, inputs, train):
    """Both modules on each entry of ``inputs`` in turn (a tuple of numpy
    arguments), in training or evaluation mode; the outputs compared, and
    in training the running statistics after each call."""
    tmod.train(train)
    v = variables
    # jitted: one XLA compile of the module, where an eager apply compiles
    # op by op
    if train:
        apply = jax.jit(lambda v_, *a: jmod.apply(
            v_, *a, deterministic=False, mutable=["batch_stats"]))
    else:
        apply = jax.jit(lambda v_, *a: jmod.apply(v_, *a, deterministic=True))
    for i, args in enumerate(inputs):
        if train:
            jout, mutated = apply(v, *map(jnp.asarray, args))
            v = {"params": v["params"], "batch_stats": mutated["batch_stats"]}
        else:
            jout = apply(v, *map(jnp.asarray, args))
        with torch.no_grad():
            tout = tmod(*map(torch.from_numpy, args))
        jflat, tflat = jax.tree.leaves(jout), []
        for t in (tout if isinstance(tout, (tuple, list)) else [tout]):
            tflat.extend(t if isinstance(t, list) else [t])
        assert len(jflat) == len(tflat)
        for k, (a, b) in enumerate(zip(tflat, jflat)):
            close(a, b, f"call {i} output {k}")
        if train:
            want = jax_stats(v["batch_stats"])
            got = stats_of(tmod)
            assert got.keys() == want.keys()
            for n in want:
                close(got[n], want[n].numpy(), f"call {i} {n}")


# --- the Attention U-Net --------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_block_matches_jax(train):
    x = [(seeded(2, 8, 8, 3, seed=s),) for s in (1, 2)]
    jmod = junet.ConvBlock(8)
    v = jax_init(jmod, jnp.asarray(x[0][0]))
    tmod = load(tunet.ConvBlock(3, 8), v, ("seg_branch", "encoder", "enc0"))
    run_both(jmod, tmod, v, x, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_attention_gate_matches_jax(train):
    """The gate at half the skip's size: the linear resize runs."""
    x = [(seeded(2, 4, 4, 6, seed=s), seeded(2, 8, 8, 5, seed=s + 10))
         for s in (1, 2)]
    jmod = junet.AttentionGate(3)
    v = jax_init(jmod, *map(jnp.asarray, x[0]))
    tmod = load(tunet.AttentionGate(6, 5, 3), v,
                ("seg_branch", "decoder", "attn0"))
    run_both(jmod, tmod, v, x, train)


@pytest.mark.parametrize("size", [32, 40])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_segmentation_branch_matches_jax(size, train):
    """At 40 the encoder floors 5 to 2 and the decoder resizes 4 to 5."""
    x = [(seeded(2, size, size, 3, seed=s),) for s in (1, 2)]
    jmod = junet.SegmentationBranch(3, ENC, DEC)
    v = jax_init(jmod, jnp.asarray(x[0][0]))
    tmod = load(tunet.SegmentationBranch(3, ENC, DEC), v, ("seg_branch",))
    run_both(jmod, tmod, v, x, train)


def test_conv_transpose_needs_the_kernel_flip():
    """flax's ConvTranspose correlates: the import flips the kernel, and the
    same weights without the flip give another output."""
    from flax import linen as fnn
    x = seeded(2, 3, 5, 6)
    jmod = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    v = jax_init(jmod, jnp.asarray(x))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    tmod = load(tunet.ConvTranspose2d(6, 4), v, ("seg_branch", "decoder", "up0"))
    with torch.no_grad():
        close(tmod(torch.from_numpy(x)), want)
        kernel = np.asarray(v["params"]["kernel"])
        tmod.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy()))
        unflipped = tmod(torch.from_numpy(x)).numpy()
    assert np.abs(unflipped - want).max() > 100 * RTOL * np.abs(want).max()


# --- fusions, metadata embedding, head ----------------------------------------

FUSIONS = {"attention": (jfusion.AttentionFusion(24), tfusion.AttentionFusion,
                         dict(seg_channels=4)),
           "concat": (jfusion.ConcatFusion(24), tfusion.ConcatFusion,
                      dict(seg_channels=4, output_dim=24)),
           "cross_attention": (jfusion.CrossAttentionFusion(24, 24),
                               tfusion.CrossAttentionFusion,
                               dict(seg_channels=4, output_dim=24))}


@pytest.mark.parametrize("kind", list(FUSIONS))
def test_fusion_matches_jax(kind):
    """Evaluation mode (ConcatFusion's dropout off): the output, and the
    gradients of the parameters and both inputs for a seeded cotangent. The
    cross-attention's key bias has an exact gradient of 0 (a softmax does not
    see a constant added to every key), rounding noise on both sides: it is
    held to 1e-4 of the largest parameter gradient instead of its own."""
    jmod, cls, kw = FUSIONS[kind]
    trans, seg = seeded(3, 24, seed=1), seeded(3, 6, 5, 4, seed=2)
    v = jax_init(jmod, jnp.asarray(trans), jnp.asarray(seg))
    tmod = load(cls(24, **kw), v, ("fusion",)).eval()
    want, vjp = jax.vjp(lambda p, t, s_: jmod.apply({"params": p}, t, s_),
                        v["params"], jnp.asarray(trans), jnp.asarray(seg))
    cot = seeded(*want.shape, seed=3)
    jgrads = vjp(jnp.asarray(cot))
    tt, ts = (torch.from_numpy(a).requires_grad_() for a in (trans, seg))
    got = tmod(tt, ts)
    close(got, want)
    (got * torch.from_numpy(cot)).sum().backward()
    close(tt.grad, jgrads[1], "d trans")
    close(ts.grad, jgrads[2], "d seg")
    wgrads = {k[len("fusion."):]: g for k, g in state_dict_from_jax(
        {"params": {"fusion": jax.device_get(jgrads[0])}}).items()}
    top = max(float(g.abs().max()) for g in wgrads.values())
    for n, p in tmod.named_parameters():
        if n == "k_proj.bias":
            assert float((p.grad - wgrads[n]).abs().max()) <= RTOL * top
        else:
            close(p.grad, wgrads[n].numpy(), n)
    built = tfusion.build_fusion_module(kind, 24, 4, 24)
    assert isinstance(built, cls)
    assert set(built.state_dict()) == set(tmod.state_dict())


def test_metadata_embedding_matches_jax():
    rng = np.random.default_rng(3)
    age = rng.uniform(0, 1, 5).astype(np.float32)
    sex = rng.integers(0, 3, 5).astype(np.int32)
    site = rng.integers(0, 9, 5).astype(np.int32)
    jmod = JaxEmbedding(32)
    v = jax_init(jmod, *map(jnp.asarray, (age, sex, site)))
    tmod = load(TorchEmbedding(32), v, ("metadata_branch",)).eval()
    want = jmod.apply(v, *map(jnp.asarray, (age, sex, site)))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (age, sex, site)))
        close(got, want)
        close(tmod(torch.from_numpy(age[:, None]), *map(torch.from_numpy,
                                                         (sex, site))), want)


def test_layer_norm_head_matches_jax():
    x = seeded(4, 40, seed=4)
    jmod = JaxHead(8, 16, 0.5, layer_norm=True)
    v = jax_init(jmod, jnp.asarray(x))
    tmod = load(TorchHead(40, 8, 16, 0.5, layer_norm=True), v,
                ("classifier",)).eval()
    assert set(tmod.state_dict()) == {"0.weight", "0.bias", "2.weight",
                                      "2.bias", "4.weight", "4.bias"}
    with torch.no_grad():
        close(tmod(torch.from_numpy(x)), jmod.apply(v, jnp.asarray(x)))
    plain = TorchHead(40, 8, 16, 0.5)
    assert set(plain.state_dict()) == {"0.weight", "0.bias", "3.weight",
                                       "3.bias"}


# --- the whole HybridViT ---------------------------------------------------------

def old_gen_raw(fusion="attention", size=48, joint=True, style="embedding",
                head_ln=True):
    """A tiny HybridViT: vit_tiny (2 blocks inside ``shallow_vit``), the
    U-Net at ENC/DEC. ``joint``: JointLoss mode (3-channel model, the 4th
    channel a target); at 48 the decoder resizes 2 to 3."""
    raw = raw_config(True, True)
    raw["model"].update({
        "image_size": size,
        "segmentation": {"enabled": True, "encoder_channels": list(ENC),
                         "decoder_channels": list(DEC),
                         "fusion_type": fusion},
        "classifier": {"layer_norm": head_ln}})
    raw["model"]["metadata"]["style"] = style
    raw["loss"] = {"seg_weight": 0.3 if joint else 0.0}
    return raw


CLASSIFIERS = {f: old_gen_raw(f) for f in ("attention", "concat",
                                           "cross_attention")}


@pytest.mark.parametrize("case", list(CLASSIFIERS))
def test_old_generation_classifier_matches_jax(case):
    """JointLoss mode (the 4th channel sliced off), the embedding style with
    no ``metadata_raw``, the LayerNorm head; ``tests/test_torch_joint_loss.py``
    serves a 3-channel one with the MLP branch and the plain head."""
    raw = CLASSIFIERS[case]
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    tcfg = tconfig.from_dict(copy.deepcopy(raw))
    s = raw["model"]["image_size"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, s, s, 4)).astype(np.float32)
    meta = rng.random((3, 13)).astype(np.float32)
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg)
        model = build_model(tcfg, device="cpu")
        want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(meta),
                            deterministic=True)
    before = {n: p.clone() for n, p in model.named_parameters()
              if n.startswith("metadata_branch.")}
    load_jax_variables(model, variables)
    # the embedding branch, absent from JAX's tree, keeps the port's init
    assert before and all(torch.equal(p, before[n]) for n, p in
                          model.named_parameters() if n in before)
    joint = raw["loss"]["seg_weight"] > 0
    assert model.mask_as_target == joint
    assert model.backbone.patch_embed.proj.weight.shape[1] == (3 if joint
                                                               else 4)
    embedding = raw["model"]["metadata"]["style"] == "embedding"
    # fact: JAX's embedding style makes no metadata parameters
    assert ("metadata_branch" in variables["params"]) != embedding
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(meta))
    assert set(got) == {"logits", "features", "seg_mask"}
    for k in ("logits", "features", "seg_mask"):
        close(got[k], want[k], k)
    assert got["seg_mask"].shape == (3, s, s, 1)
    if embedding:
        # no metadata_raw: a zero embedding, whatever the flat metadata
        with torch.no_grad():
            again = model(torch.from_numpy(x))["logits"]
        close(again, want["logits"])
    # any other leaf missing is refused, and so is a module the port does
    # not have; the U-Net's statistics carry no num_batches_tracked
    params = copy.deepcopy(variables["params"])
    del params["seg_branch"]["decoder"]["final_conv"]
    with pytest.raises(KeyError, match="seg_branch.decoder.final_conv"):
        load_jax_variables(model, {"params": params,
                                   "batch_stats": variables["batch_stats"]})
    with pytest.raises(NotImplementedError, match="nowhere"):
        state_dict_from_jax({"params": {"nowhere": {"kernel": np.ones(2)}}})
    sd = state_dict_from_jax(variables)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    assert sd["seg_branch.decoder.up0.weight"].shape == (128, DEC[0], 2, 2)
    assert sd["seg_branch.encoder.enc0.conv1.weight"].shape == (ENC[0], 3, 3, 3)


def test_embedding_style_uses_metadata_raw_when_given():
    """The port's branch runs on ``metadata_raw`` (JAX's would fail: it has
    no parameters for it) and changes the logits; the zero embedding is
    what the classifier sees without it."""
    raw = old_gen_raw("attention", 32)
    tcfg = tconfig.from_dict(raw)
    with shallow_vit():
        model = build_model(tcfg, device="cpu")
    x = torch.from_numpy(seeded(2, 32, 32, 4, seed=6))
    fields = {"age": torch.tensor([0.3, 0.7]), "sex": torch.tensor([0, 2]),
              "site": torch.tensor([1, 8])}
    with torch.no_grad():
        base = model(x)
        with_raw = model(x, metadata_raw=fields)
        emb = model.metadata_branch(fields["age"], fields["sex"],
                                    fields["site"])
    assert emb.shape == (2, 64) and emb.abs().sum() > 0
    assert not torch.allclose(base["logits"], with_raw["logits"])
    torch.testing.assert_close(base["seg_mask"], with_raw["seg_mask"])


def test_old_generation_refusals_are_gone():
    """Every old-generation option builds, and so does model.remat, whose
    HybridViT takes a train step. training.data_parallel no longer refuses
    either: it trains over the ranks of a process group (``train/loop.py``,
    ``tests/test_torch_ddp.py``)."""
    from fedvit_torch.train.losses import build_loss, joint_loss
    from fedvit_torch.train.optim import build_optimizer
    from fedvit_torch.train.state import TrainState
    from fedvit_torch.train.step import make_train_step
    for fusion in ("attention", "concat", "cross_attention"):
        tcfg = tconfig.from_dict(old_gen_raw(fusion, 32))
        with shallow_vit():
            model = build_model(tcfg, device="cpu")
        assert model.seg_enabled and model.mask_as_target
        assert make_train_step(tcfg, build_loss(tcfg)).seg_weight == 0.3
    loss = joint_loss(lambda a, b: a.sum() * 0, torch.zeros(2, 8),
                      torch.zeros(2), torch.zeros(2, 4, 4, 1),
                      torch.ones(2, 4, 4, 1), 0.3)
    assert float(loss) > 0
    raw = old_gen_raw("attention", 32)
    raw["model"]["remat"] = True
    remat = tconfig.from_dict(raw)
    with shallow_vit():
        model = build_model(remat, device="cpu")
    tx, _ = build_optimizer(remat, model, steps_per_epoch=4)
    state = TrainState.create(model, tx, seed=0)
    batch = {"image": seeded(4, 32, 32, 4, seed=8),
             "label": np.arange(4) % 8, "metadata": seeded(4, 13, seed=9)}
    state, metrics = make_train_step(remat, build_loss(remat))(state, batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
