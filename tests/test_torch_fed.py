"""The port's FedAvg — the local optimizer, one round, and ``train_federated``
— against the JAX package's, on the CPU, fp32, ``vit_tiny`` cut to 2 blocks
at ``image_size`` 32.

Both sides are deterministic: ``federated.augment`` off (the eval
transform, which draws nothing), no MixUp/CutMix, dropout and drop-path 0,
so the JAX round's PRNG keys and the port's generators decide nothing. Both
start from the same weights (seeded JAX variables moved by seeded noise,
loaded into the port through ``state_dict_from_jax``) and the same batches.
The JAX rounds run on a one-device client mesh (``vmap`` over the clients).

Tolerances, with their reasons:

- the local optimizer against the optax chain of
  ``fedvit_tpu/fed/fedavg.py:34``, 3 updates with the clip acting: 1e-7,
  absolute and relative (fp32 Adam in another order on parameters of size
  ~1: the last rounding of p − lr·u can fall an ulp apart, 1.2e-7 at 1.0);
- one round's mean loss rtol 1e-4 (fp32 sums in other orders through 3
  steps); each parameter and statistic atol 2·lr·local_steps: every Adam
  update is ±lr whatever the gradient's size, so a gradient within rounding
  of 0 can take the other sign and move an element by 2·lr a step; the RMS
  difference of each leaf's update is held to 2% of the update's RMS (but
  on the two leaves of ``ZERO_GRAD``; the port reads at most 0.4%, and a
  round averaged with equal weights in place of the split's 0.47 / 0.53
  reads 6% at the median leaf), so a wrong update cannot hide under that
  bound;
- the aggregation alone, clients with identical parameters and statistics
  (LR 0, the same batches): 1e-7, absolute and relative (w₀θ + w₁θ rounds
  within an ulp of θ, 1.2e-7 at 1.0, and XLA may fuse its product and sum);
- ``train_federated``: the same clients and indices drawn, history losses
  rtol 1e-4, accuracy, balanced accuracy and macro F1 equal (the argmax of
  probabilities that agree to ~1e-5 does not flip on these seeds).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedvit_torch.core import config as tconfig
from fedvit_torch.fed import fedavg as tfedavg
from fedvit_torch.fed import server as tserver
from fedvit_torch.models import build_model
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_torch.train.losses import build_loss as tbuild_loss
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.data.synthetic import make_synthetic_dataset
from fedvit_tpu.fed import fedavg as jfedavg
from fedvit_tpu.fed import server as jserver
from fedvit_tpu.fed.partition import client_weights, partition
from fedvit_tpu.parallel.mesh import make_mesh
from fedvit_tpu.train.losses import build_loss as jbuild_loss

from tests.torch_parity import TINY, jax_variables, shallow_vit, torch_model

LR, STEPS = 1e-3, 3
# The biases of the metadata branch's two Dense layers feed a BatchNorm in
# training mode, which subtracts the batch mean: their gradient is 0 in exact
# arithmetic and rounding noise here, which Adam turns into ±lr of either
# sign. They are held to the elementwise bound only.
ZERO_GRAD = ("metadata_branch.net.0.bias", "metadata_branch.net.4.bias")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def shallow():
    with shallow_vit():
        yield


def _configs(lr=LR, weight_decay=1e-5, class_weights=False, **fed):
    raw = copy.deepcopy(TINY)
    raw["model"]["metadata"]["dropout"] = 0.0
    raw["model"]["classifier"] = {"dropout": 0.0}
    raw["training"].update({"batch_size": 4, "ema": {"decay": 0.9},
                            "optimizer": {"lr": lr,
                                          "weight_decay": weight_decay}})
    raw["loss"] = {"class_weights": class_weights}
    raw["augmentation"] = {"mixup": {"enabled": False},
                           "cutmix": {"enabled": False}}
    raw["federated"] = {"enabled": True, "num_clients": 2,
                        "local_steps": STEPS, "augment": False, **fed}
    return jconfig.from_dict(copy.deepcopy(raw)), tconfig.from_dict(raw)


def _data(n, seed=0):
    """The synthetic fixture with its mask as the 4th channel."""
    data = make_synthetic_dataset(n=n, image_size=32, seed=seed, noise=0.15)
    data["image"] = np.concatenate([data["image"], data["mask"]], -1)
    return data


def _round_batches(data, seed=42, same=False):
    parts = partition("dirichlet", data["label"], 2, seed=seed)
    rng = np.random.default_rng(0)
    per_client = [jserver.sample_client_batches(data, parts[c], STEPS, 4, rng)
                  for c in range(2)]
    if same:
        per_client = [per_client[0], per_client[0]]
    return jfedavg.stack_client_batches(per_client), client_weights(parts)


def _both_rounds(jcfg, tcfg, batches, weights):
    """(JAX's new variables as a port state dict, JAX's loss, the port's
    server after the round, the port's loss, the initial state dict)."""
    jmodel, variables = jax_variables(jcfg, 0)
    mesh = make_mesh([1], ["client"], jax.devices()[:1])
    jround = jfedavg.make_federated_round(jcfg, jmodel.apply,
                                          jbuild_loss(jcfg), mesh,
                                          donate=False)
    p, bs, m = jround(variables["params"], variables["batch_stats"],
                      {k: jnp.asarray(v) for k, v in batches.items()},
                      jnp.asarray(weights), jax.random.key(7))
    want = state_dict_from_jax({"params": jax.device_get(p),
                                "batch_stats": jax.device_get(bs)})
    server = torch_model(tcfg, variables)
    initial = {k: v.clone() for k, v in server.state_dict().items()}
    work = copy.deepcopy(server)
    tround = tfedavg.make_federated_round(tcfg, tbuild_loss(tcfg))
    metrics = tround(server, work, {k: torch.from_numpy(v)
                                    for k, v in batches.items()},
                     weights, [0, 1], 1, 0)
    return want, float(m["loss"]), server, float(metrics["loss"]), initial


def _leaves(state):
    return {k: v for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def test_local_optimizer_matches_optax(shallow):
    jcfg, tcfg = _configs(weight_decay=1e-2)
    _, variables = jax_variables(jcfg, 0)
    params = variables["params"]
    tx = jfedavg.build_local_optimizer(jcfg)
    model = torch_model(tcfg, variables)
    ttx = tfedavg.build_local_optimizer(tcfg, model)
    opt_state, tstate = tx.init(params), ttx.init(model)
    assert set(tstate["nu"]) == {n for n, _ in model.named_parameters()}
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u),
                                                     s2))(*tx.update(g, s, p)))
    rng = np.random.default_rng(0)
    for i in range(3):
        size = 1e-4 if i == 1 else 1.0       # the clip acting, idle, acting
        grads = jax.tree.map(lambda p: (size * rng.normal(size=p.shape)
                                        ).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        tgrads = dict(state_dict_from_jax({"params": grads}))
        norm = ttx.step(model, tgrads, tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-5)
        assert (float(norm) > 1.0) == (i != 1)
    want = state_dict_from_jax({"params": params})
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-7, rtol=1e-7, err_msg=n)


def test_round_matches_jax(shallow):
    jcfg, tcfg = _configs()
    batches, weights = _round_batches(_data(64))
    assert abs(weights[0] - weights[1]) > 0.05      # a skewed split
    want, jloss, server, tloss, initial = _both_rounds(jcfg, tcfg, batches,
                                                       weights)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    got = _leaves(server.state_dict())
    assert got.keys() == _leaves(want).keys()
    moved = 0
    for n, g in got.items():
        w, g0 = want[n].numpy(), initial[n].numpy()
        g = g.numpy()
        np.testing.assert_allclose(g, w, atol=2 * LR * STEPS, rtol=0,
                                   err_msg=n)
        upd = w - g0
        rms = float(np.sqrt(np.mean(upd.astype(np.float64) ** 2)))
        moved += rms > 0
        if n not in ZERO_GRAD:
            err = float(np.sqrt(np.mean((g - w).astype(np.float64) ** 2)))
            assert err <= 0.02 * rms, (n, err, rms)
    assert moved == len(got)
    # the global BatchNorm counts advance by the round's local steps
    counts = {k: int(v) for k, v in server.state_dict().items()
              if k.endswith("num_batches_tracked")}
    assert counts and set(counts.values()) == {STEPS}


def test_client_copies_start_from_the_global_counts(shallow):
    """Each client's working copy takes the global BatchNorm counts with the
    leaves, so after a round the last client's copy and the server both
    count the local steps on their own path: the round's, not every
    client's."""
    _, tcfg = _configs()
    batches, weights = _round_batches(_data(64))
    server = build_model(tcfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    work = copy.deepcopy(server)
    tround = tfedavg.make_federated_round(tcfg, tbuild_loss(tcfg))
    batches = {k: torch.from_numpy(v) for k, v in batches.items()}
    for rnd in (1, 2):
        tround(server, work, batches, weights, [0, 1], rnd, 0)
        for model in (server, work):
            counts = {int(v) for k, v in model.state_dict().items()
                      if k.endswith("num_batches_tracked")}
            assert counts == {rnd * STEPS}


def test_aggregation_alone_matches_jax(shallow):
    """LR 0 and the same batches for both clients: every client ends with
    the global parameters and the same statistics, so the round is the
    weighted average of identical trees and the server step alone."""
    jcfg, tcfg = _configs(lr=0.0, local_steps=1)
    batches, weights = _round_batches(_data(48, seed=1), same=True)
    batches = {k: v[:, :1] for k, v in batches.items()}
    want, jloss, server, tloss, initial = _both_rounds(jcfg, tcfg, batches,
                                                       weights)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    stats = 0
    for n, g in _leaves(server.state_dict()).items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-7,
                                   rtol=1e-7, err_msg=n)
        if n.endswith(("running_mean", "running_var")):
            stats += 1
            assert not torch.equal(g, initial[n])        # the batch moved them
        else:
            np.testing.assert_allclose(g.numpy(), initial[n].numpy(),
                                       atol=1e-7, rtol=1e-7, err_msg=n)
    assert stats == 4


def test_train_federated_matches_jax(shallow, monkeypatch):
    jcfg, tcfg = _configs(class_weights=True, num_clients=4,
                          clients_per_round=2, rounds=2)
    data = _data(96, seed=3)
    eval_data = {k: v[:20] for k, v in data.items()}
    train_data = {k: v[20:] for k, v in data.items()}
    jmodel, variables = jax_variables(jcfg, 0)
    drawn = {"jax": [], "torch": []}

    def recording(fn, into):
        def wrapped(labels, part, *args, **kwargs):
            into.append(part.copy())
            out = fn(labels, part, *args, **kwargs)
            into.append(out.copy())
            return out
        return wrapped

    monkeypatch.setattr(jserver, "sample_client_indices",
                        recording(jserver.sample_client_indices, drawn["jax"]))
    monkeypatch.setattr(tserver, "sample_client_indices",
                        recording(tserver.sample_client_indices,
                                  drawn["torch"]))
    model = torch_model(tcfg, variables)
    want = jserver.train_federated(
        jcfg, jmodel, variables, train_data, eval_data,
        mesh=make_mesh([1], ["client"], jax.devices()[:1]),
        log_fn=lambda s: None, eval_batch_size=8)
    got = tserver.train_federated(tcfg, model, train_data, eval_data,
                                  log_fn=lambda s: None, eval_batch_size=8,
                                  device="cpu")
    # 2 rounds × 2 active clients, each its partition and its indices
    assert len(drawn["torch"]) == len(drawn["jax"]) == 8
    for t, j in zip(drawn["torch"], drawn["jax"]):
        np.testing.assert_array_equal(t, j)
    assert len(got.history) == len(want.history) == 2
    for t, j in zip(got.history, want.history):
        assert t["round"] == j["round"] and t["local_steps"] == STEPS
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        for key in ("accuracy", "balanced_accuracy", "macro_f1"):
            assert t[key] == j[key], key
