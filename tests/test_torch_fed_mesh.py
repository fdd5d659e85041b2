"""The port's FedAvg over a mesh of ranks on the CPU — a client mesh of 2
ranks and a 1 × 2 client × data mesh under gloo (``tests/torch_dist.py``) —
against the single-process round and JAX's mesh rounds, fp32, ``vit_tiny``
cut to 2 blocks at ``image_size`` 32, deterministic as in
``test_torch_fed.py`` (augment off, no mix, dropout and drop-path 0).

Tolerances, with their reasons:

- each client's trained leaves on the client mesh: bit-equal to the
  single-process round's (a client's training depends on its id, its
  batches and the global model alone, and the CPU's kernels are
  deterministic);
- the global leaves: rtol 1e-6, atol 1e-7 (the ranks' partial sums
  w₀θ₀ + w₁θ₁ and w₂θ₂ + w₃θ₃ are added in another order than the single
  process's running sum: a few fp32 roundings of values of size ~1);
- the control, where rank 1 adds none of its clients: off by the dropped
  clients' weight (about half of every leaf), far outside that;
- against JAX's round on ``make_mesh([2], ["client"])``:
  ``test_torch_fed.py``'s loss rtol 1e-4 and each leaf atol 2·lr·steps;
- the 1 × 2 client × data round against the 1-D round: JAX's own contract
  (``tests/test_federated.py:231-245``), the pre-update loss within
  1e-4 · (1 + |loss|) and each parameter within 3·lr·steps;
- ``train_federated`` over 2 ranks with a resume, against the
  single-process run: the same history but for fp32 summation order (loss
  rtol 1e-4, accuracy and F1 equal, ``test_torch_fed.py``'s), and the two
  ranks' final models bit-equal.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedvit_torch.cli import train_federated as fed_cli
from fedvit_torch.models.import_weights import state_dict_from_jax
from fedvit_tpu.core import config as jconfig
from fedvit_tpu.fed import fedavg as jfedavg
from fedvit_tpu.fed import server as jserver
from fedvit_tpu.fed.partition import client_weights, partition
from fedvit_tpu.parallel.mesh import make_mesh
from fedvit_tpu.train.losses import build_loss as jbuild_loss

from tests import torch_dist
from tests.test_torch_fed import _data
from tests.torch_parity import TINY, jax_variables, shallow_vit

LR, STEPS = 1e-3, 3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw(metadata=True, **fed):
    raw = copy.deepcopy(TINY)
    raw["model"]["metadata"] = {"enabled": metadata, "dropout": 0.0}
    raw["model"]["classifier"] = {"dropout": 0.0}
    raw["training"].update({"batch_size": 4, "ema": {"decay": 0.9},
                            "optimizer": {"lr": LR, "weight_decay": 1e-5}})
    raw["augmentation"] = {"mixup": {"enabled": False},
                           "cutmix": {"enabled": False}}
    raw["federated"] = {"enabled": True, "num_clients": 4,
                        "local_steps": STEPS, "augment": False, **fed}
    return raw


def _round_inputs(raw, clients=4, steps=STEPS, batch=4, seed=42):
    data = _data(96, seed=3)
    parts = partition("dirichlet", data["label"], clients, seed=seed)
    rng = np.random.default_rng(0)
    per_client = [jserver.sample_client_batches(data, parts[c], steps, batch,
                                                rng)
                  for c in range(clients)]
    batches = jfedavg.stack_client_batches(per_client)
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    with shallow_vit():
        jmodel, variables = jax_variables(jcfg, 0)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    return jcfg, jmodel, variables, sd, batches, client_weights(parts)


def _leaves(sd):
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def test_client_mesh_round_matches_one_process_and_jax(tmp_path):
    raw = _raw()
    jcfg, jmodel, variables, sd, batches, weights = _round_inputs(raw)
    clients = [0, 1, 2, 3]
    want = torch_dist.fed_round(raw, sd, batches, weights, clients)
    got = torch_dist.run_world(torch_dist.fed_round, 2, tmp_path, raw, sd,
                               batches, weights, clients, (2,))
    assert sorted(got[0]["clients"]) == [0, 1]
    assert sorted(got[1]["clients"]) == [2, 3]
    for rank in got:
        for client, leaves in rank["clients"].items():
            for a, b in zip(leaves, want["clients"][client]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(rank["loss"], want["loss"], rtol=1e-6)
        for name, w in _leaves(want["params"]).items():
            np.testing.assert_allclose(rank["params"][name], w, rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    for name, value in got[0]["params"].items():
        np.testing.assert_array_equal(value, got[1]["params"][name])

    with shallow_vit():
        jround = jfedavg.make_federated_round(
            jcfg, jmodel.apply, jbuild_loss(jcfg),
            make_mesh([2], ["client"], jax.devices()[:2]), donate=False)
        p, bs, m = jround(variables["params"], variables["batch_stats"],
                          {k: jnp.asarray(v) for k, v in batches.items()},
                          jnp.asarray(weights), jax.random.key(7))
    jax_sd = state_dict_from_jax({"params": jax.device_get(p),
                                  "batch_stats": jax.device_get(bs)})
    np.testing.assert_allclose(got[0]["loss"], float(m["loss"]), rtol=1e-4)
    for name, w in _leaves(jax_sd).items():
        np.testing.assert_allclose(got[0]["params"][name], w.numpy(),
                                   atol=2 * LR * STEPS, rtol=0, err_msg=name)


def test_client_mesh_round_fails_when_a_rank_drops_its_clients(tmp_path):
    raw = _raw()
    _, _, _, sd, batches, weights = _round_inputs(raw)
    clients = [0, 1, 2, 3]
    want = torch_dist.fed_round(raw, sd, batches, weights, clients)
    got = torch_dist.run_world(torch_dist.fed_round, 2, tmp_path, raw, sd,
                               batches, weights, clients, (2,), True)
    name = "backbone.blocks.0.attn.qkv.weight"
    err = np.max(np.abs(got[0]["params"][name] - want["params"][name]))
    assert err > 1e3 * (1e-7 + 1e-6 * np.max(np.abs(want["params"][name])))


def test_client_by_data_round_meets_jax_contract(tmp_path):
    """1 client rank × 2 data ranks, 2 clients of batch 8 (4 rows a data
    rank), one local step, against the 1-D round of one process."""
    raw = _raw(metadata=False, num_clients=2, local_steps=1)
    raw["training"]["batch_size"] = 8
    data = _data(96, seed=3)
    parts = partition("iid", data["label"], 2, seed=3)
    rng = np.random.default_rng(0)
    batches = jfedavg.stack_client_batches(
        [jserver.sample_client_batches(data, parts[c], 1, 8, rng)
         for c in range(2)])
    weights, sd = client_weights(parts), None      # the seeded model
    want = torch_dist.fed_round(raw, sd, batches, weights, [0, 1])
    got = torch_dist.run_world(torch_dist.fed_round, 2, tmp_path, raw, sd,
                               batches, weights, [0, 1], (1, 2))
    for rank in got:
        assert abs(rank["loss"] - want["loss"]) < 1e-4 * (1 + abs(want["loss"]))
        for name, w in _leaves(want["params"]).items():
            assert np.max(np.abs(rank["params"][name] - w)) <= 3 * LR * 1, name
    for name, value in got[0]["params"].items():
        np.testing.assert_array_equal(value, got[1]["params"][name])


def test_train_federated_over_two_ranks_with_resume(tmp_path):
    raw = _raw(clients_per_round=2)
    raw["loss"] = {"class_weights": True}
    jcfg = jconfig.from_dict(copy.deepcopy(raw))
    with shallow_vit():
        _, variables = jax_variables(jcfg, 0)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}
    data = _data(96, seed=3)
    eval_data = {k: v[:20] for k, v in data.items()}
    train_data = {k: v[20:] for k, v in data.items()}
    want = torch_dist.federated(raw, sd, train_data, eval_data, None, 3)
    workdir = str(tmp_path / "fed")
    torch_dist.run_world(torch_dist.federated, 2, tmp_path, raw, sd,
                         train_data, eval_data, workdir, 2)
    got = torch_dist.run_world(torch_dist.federated, 2, tmp_path, raw, sd,
                               train_data, eval_data, workdir, 3, True)
    assert got[0]["history"] == got[1]["history"]
    assert len(got[0]["history"]) == len(want["history"]) == 3
    for t, w in zip(got[0]["history"], want["history"]):
        assert t["round"] == w["round"]
        np.testing.assert_allclose(t["loss"], w["loss"], rtol=1e-4)
        for key in ("accuracy", "balanced_accuracy", "macro_f1"):
            assert t[key] == w[key], key
    for name, value in got[0]["params"].items():
        np.testing.assert_array_equal(value, got[1]["params"][name])


def test_train_federated_cli_over_two_ranks(tmp_path):
    """``cli.train_federated --synthetic 48 --device cpu`` in a world of 2
    (the clients over a client mesh) against one process: the same history
    but for fp32 summation order (``test_torch_fed.py``'s loss rtol 1e-4,
    accuracy equal); rank 0 alone writes the history."""
    raw = _raw()
    # PyYAML reads JSON's 1e-05 as a string, in both packages' load_config
    raw["training"]["optimizer"]["weight_decay"] = 0.0001
    config = tmp_path / "fed.yaml"
    config.write_text(json.dumps(raw))
    argv = ["--config", str(config), "--synthetic", "48", "--clients", "4",
            "--rounds", "2", "--device", "cpu"]
    with torch_dist.shallow():
        assert fed_cli.main(argv + ["--log", str(tmp_path / "one")]) == 0
    got = torch_dist.run_world(torch_dist.cli, 2, tmp_path,
                               "train_federated",
                               argv + ["--log", str(tmp_path / "two")])
    assert [r["rc"] for r in got] == [0, 0]
    assert got[0]["stdout"] and not got[1]["stdout"]
    want, two = (json.loads((tmp_path / d / "federated_history.json")
                            .read_text()) for d in ("one", "two"))
    assert len(two) == len(want) == 2
    for t, w in zip(two, want):
        np.testing.assert_allclose(t["loss"], w["loss"], rtol=1e-4)
        assert t["accuracy"] == w["accuracy"]
