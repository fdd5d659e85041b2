"""The port's federated data side — partitioners, client weights, the server's
client sampling and the synthetic fixture — against the JAX package's, on
the CPU. All of it is numpy on both sides, drawn from the same generators:
every result must be equal, bit for bit."""

import numpy as np
import pytest

from fedvit_torch.data import synthetic as tsynth
from fedvit_torch.fed import fedavg as tfedavg
from fedvit_torch.fed import partition as tpart
from fedvit_torch.fed import server as tserver
from fedvit_tpu.data import synthetic as jsynth
from fedvit_tpu.fed import fedavg as jfedavg
from fedvit_tpu.fed import partition as jpart
from fedvit_tpu.fed import server as jserver


def _labels(n, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        return rng.choice(8, size=n, p=[.45, .25, .1, .08, .05, .04, .02, .01])
    return rng.integers(0, 8, n)


def _equal_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["iid", "dirichlet", "shards"])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_partition_matches_jax(kind, seed):
    labels = _labels(300, seed, skew=seed == 7)
    for clients, alpha in ((4, 0.5), (10, 0.1), (3, 5.0)):
        got = tpart.partition(kind, labels, clients, alpha=alpha, seed=seed)
        want = jpart.partition(kind, labels, clients, alpha=alpha, seed=seed)
        _equal_parts(got, want)
        w = tpart.client_weights(got)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, jpart.client_weights(want))


def test_dirichlet_retry_and_refusal_match_jax():
    """Small α with many clients needs the retry loop (draws continue from
    one generator); an impossible minimum raises in both."""
    labels = _labels(40, 3)
    got = tpart.dirichlet_partition(labels, 12, alpha=0.05, seed=3,
                                    min_samples=1)
    _equal_parts(got, jpart.dirichlet_partition(labels, 12, alpha=0.05,
                                                seed=3, min_samples=1))
    with pytest.raises(RuntimeError):
        tpart.dirichlet_partition(labels, 5, seed=0, min_samples=100)
    with pytest.raises(ValueError):
        tpart.partition("bogus", labels, 2)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("seed", [0, 11])
def test_client_sampling_matches_jax(weighted, seed):
    data = jsynth.make_synthetic_dataset(n=96, image_size=8, seed=seed)
    parts = jpart.partition("dirichlet", data["label"], 4, seed=seed)
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for part in parts:
        got = tserver.sample_client_indices(data["label"], part, 3, 5, rng_t,
                                            weighted=weighted)
        want = jserver.sample_client_indices(data["label"], part, 3, 5,
                                             rng_j, weighted=weighted)
        np.testing.assert_array_equal(got, want)
        got_b = tserver.sample_client_batches(data, part, 2, 4, rng_t,
                                              weighted=weighted)
        want_b = jserver.sample_client_batches(data, part, 2, 4, rng_j,
                                               weighted=weighted)
        assert got_b.keys() == want_b.keys() == {"image", "label", "metadata"}
        for k in got_b:
            np.testing.assert_array_equal(got_b[k], want_b[k])
    # both generators are left in the same state
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    per_client = [tserver.sample_client_batches(data, p, 2, 4, rng_t)
                  for p in parts]
    stacked = tfedavg.stack_client_batches(per_client)
    want = jfedavg.stack_client_batches(per_client)
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k])
    assert stacked["image"].shape == (4, 2, 4, 8, 8, 3)


@pytest.mark.parametrize("kwargs", [
    dict(n=24, image_size=16, seed=0),
    dict(n=17, image_size=12, channels=1, seed=5, noise=0.1),
    dict(n=30, image_size=8, seed=2,
         class_skew=np.array([.3, .2, .1, .1, .1, .1, .05, .05])),
])
def test_synthetic_dataset_matches_jax(kwargs):
    got = tsynth.make_synthetic_dataset(**kwargs)
    want = jsynth.make_synthetic_dataset(**kwargs)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    batches_t = list(tsynth.batch_iterator(got, 4, seed=1, epochs=2,
                                           include_mask_channel=True))
    batches_j = list(jsynth.batch_iterator(want, 4, seed=1, epochs=2,
                                           include_mask_channel=True))
    assert len(batches_t) == len(batches_j) == 2 * (kwargs["n"] // 4)
    for bt, bj in zip(batches_t, batches_j):
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])
