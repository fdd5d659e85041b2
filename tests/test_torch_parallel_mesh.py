"""The port's meshes (``fedvit_torch/parallel/mesh.py``) against JAX's
(``fedvit_tpu/parallel/mesh.py``): which rank sits where, for the shapes
the package uses, held exactly to JAX's device ids on its 8 CPU devices (no
process group needed), the refusals with JAX's messages, the backend rule,
and one world of 2 ranks under gloo building a mesh, sharding a batch and
replicating a tensor."""

import sys
import time

import numpy as np
import pytest

import jax
from fedvit_tpu.parallel import mesh as jmesh

from fedvit_torch.parallel import mesh as tmesh
from tests import torch_dist

RANKS = list(range(8))


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("sizes,names", [
    ([8], ["data"]), ([2, 4], ["client", "data"]),
    ([-1, 2], ["client", "data"]), ([1, 2], ["client", "data"])],
    ids=["8", "2x4", "-1x2", "1x2"])
def test_layout_matches_jax(sizes, names):
    want = _ids(jmesh.make_mesh(sizes, names))
    np.testing.assert_array_equal(tmesh.mesh_layout(sizes, names, RANKS), want)


def test_client_data_and_hybrid_layouts_match_jax():
    np.testing.assert_array_equal(tmesh.mesh_layout([8], ["client"], RANKS),
                                  _ids(jmesh.client_mesh()))
    np.testing.assert_array_equal(tmesh.mesh_layout([4], ["data"], RANKS[:4]),
                                  _ids(jmesh.data_mesh(4)))
    for slices, per in ((2, 4), (4, 2), (1, 2)):
        np.testing.assert_array_equal(tmesh.hybrid_layout(slices, per, RANKS),
                                      _ids(jmesh.hybrid_mesh(slices, per)))


@pytest.mark.parametrize("sizes,names", [
    ([16], ["data"]), ([3, 4], ["client", "data"])], ids=["16", "3x4"])
def test_make_mesh_refuses_as_jax(sizes, names):
    with pytest.raises(AssertionError) as want:
        jmesh.make_mesh(sizes, names)
    with pytest.raises(ValueError) as got:
        tmesh.mesh_layout(sizes, names, RANKS)
    assert str(got.value) == str(want.value)


def test_hybrid_mesh_refuses_as_jax():
    with pytest.raises(AssertionError) as want:
        jmesh.hybrid_mesh(4, 4)
    with pytest.raises(ValueError) as got:
        tmesh.hybrid_layout(4, 4, RANKS)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,parts", [(8, 2), (7, 2), (3, 4), (1, 2)])
def test_row_pieces_are_numpy_array_split(n, parts):
    want = np.array_split(np.arange(n), parts)
    for i, piece in enumerate(want):
        lo, hi = tmesh.row_piece(n, parts, i)
        np.testing.assert_array_equal(np.arange(n)[lo:hi], piece)


def test_backend_rule():
    assert tmesh.choose_backend("cpu", 2, 0)[0] == "gloo"
    assert tmesh.choose_backend("cuda", 4, 4)[0] == "nccl"
    assert tmesh.choose_backend("cuda", 1, 1)[0] == "nccl"
    assert tmesh.choose_backend("cuda", 2, 1)[0] == "gloo"


def test_meshes_of_two_ranks(tmp_path):
    """A 1-D data mesh and a 1 × 2 client × data mesh at world 2: their
    ranks, each rank's coordinate, its rows of a batch of 6 and rank 0's
    value replicated."""
    assert len(jax.devices()) == 8
    for sizes, names in (([2], ["data"]), ([1, 2], ["client", "data"])):
        got = torch_dist.run_world(torch_dist.mesh_facts, 2, tmp_path, sizes,
                                   names)
        for r, rank in enumerate(got):
            assert rank["mesh"] == tmesh.mesh_layout(sizes, names,
                                                     [0, 1]).tolist()
            assert list(rank["coordinate"]) == ([r] if len(sizes) == 1
                                                else [0, r])
            np.testing.assert_array_equal(
                rank["shard"], np.arange(12.0).reshape(6, 2)[3 * r:3 * r + 3])
            np.testing.assert_array_equal(rank["replicated"], np.zeros(3))


def test_launch_ranks_gives_each_rank_its_environment():
    code = ("import os, sys; e = os.environ; sys.exit(0 if e['RANK'] == "
            "e['LOCAL_RANK'] and e['WORLD_SIZE'] == e['LOCAL_WORLD_SIZE'] "
            "== '3' and e['MASTER_ADDR'] == 'localhost' and "
            "int(e['MASTER_PORT']) > 0 else 1)")
    assert tmesh.launch_ranks(3, [sys.executable, "-c", code]) == 0


def test_launch_ranks_stops_the_others_when_one_fails():
    """Rank 1 exits 3 at once; rank 0 would sleep a minute: the launch
    returns 3 within seconds."""
    code = ("import os, sys, time; r = os.environ['RANK']; "
            "sys.exit(3) if r == '1' else time.sleep(60)")
    t0 = time.monotonic()
    assert tmesh.launch_ranks(2, [sys.executable, "-c", code]) == 3
    assert time.monotonic() - t0 < 30
