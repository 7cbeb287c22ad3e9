"""The port's rank mesh, collectives and runtime (`parallel/mesh.py`,
`collectives.py`, `runtime.py`, `distributed_smoke.py`).

The mesh arithmetic and its refusals are held to the JAX package's
message for message; multi-host layouts are planted by monkeypatching
the host accessor (tests/test_runtime.py's method).  Each collective
runs on gloo at 1, 2 and 4 ranks (uint8, int32 and bool) against a
numpy oracle, and the distributed smoke runs as two real processes.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from go_avalanche_tpu.parallel import mesh as jmesh
from go_avalanche_tpu_torch.parallel import mesh, runtime
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS
from go_avalanche_tpu_torch.parallel.ranks import RankPool
import torch_ranks

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


@pytest.fixture
def fake_world(monkeypatch):
    """A world of `size` ranks (this process rank 0) whose groups are
    placeholders: the mesh arithmetic without a process group."""
    def plant(size, hosts=None):
        monkeypatch.setattr(mesh, "world", lambda: (size, 0))
        monkeypatch.setattr(runtime, "world", lambda: (size, 0))
        monkeypatch.setattr(mesh.dist, "new_group",
                            lambda ranks: tuple(ranks))
        if hosts is not None:
            monkeypatch.setattr(runtime, "_host_of", lambda r: hosts[r])
    return plant


@pytest.mark.parametrize("args", [
    dict(), dict(n_tx_shards=2), dict(n_node_shards=2, n_tx_shards=4),
    dict(n_tx_shards=3), dict(n_node_shards=3, n_tx_shards=2),
])
def test_make_mesh_arithmetic_matches_jax(fake_world, args):
    import jax

    fake_world(8)
    try:
        want = jmesh.make_mesh(devices=jax.devices()[:8], **args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.make_mesh(**args)
        assert str(got.value) == str(e)
        return
    got = mesh.make_mesh(**args)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids)


def test_single_process_mesh_and_runtime_noop():
    assert runtime.initialize_runtime() == 0
    one = mesh.make_mesh()
    assert one.shape == {NODES_AXIS: 1, TXS_AXIS: 1}
    assert one.coords == {NODES_AXIS: 0, TXS_AXIS: 0}
    assert one.group(NODES_AXIS) is None
    assert runtime.group_devices_by_slice() == [[0]]
    assert runtime.make_runtime_mesh().shape == one.shape


def test_runtime_mesh_multi_host_keeps_nodes_inside_a_host(fake_world):
    fake_world(8, hosts=["a"] * 4 + ["b"] * 4)
    m = runtime.make_runtime_mesh()
    assert m.shape == {NODES_AXIS: 4, TXS_AXIS: 2}
    for col in range(m.ranks.shape[1]):
        assert len({runtime._host_of(int(r)) for r in m.ranks[:, col]}) == 1
    fake_world(8, hosts=["a"] * 4 + ["b"] * 4)
    m4 = runtime.make_runtime_mesh(n_tx_shards=4)
    assert m4.shape == {NODES_AXIS: 2, TXS_AXIS: 4}
    np.testing.assert_array_equal(m4.ranks, [[0, 1, 4, 5], [2, 3, 6, 7]])


@pytest.mark.parametrize("hosts,tx,match", [
    (["a"] * 4 + ["b"] * 4, 3, "multiple of the slice count"),
    (["a"] * 3 + ["b"] * 5, None, "unequal device counts"),
    (["a"] * 4 + ["b"] * 4, 6, "not divisible by 3 tx shards"),
])
def test_runtime_mesh_refusals(fake_world, hosts, tx, match):
    fake_world(8, hosts=hosts)
    with pytest.raises(ValueError, match=match):
        runtime.make_runtime_mesh(n_tx_shards=tx)


def test_backend_follows_the_device():
    assert runtime.select_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="CUDA tensors"):
        runtime.select_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        runtime.select_backend("cpu", 2, "mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            runtime.select_backend("cuda", 1)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (4, 1), (2, 2)])
def test_collectives_match_numpy(pool, shape):
    world = shape[0] * shape[1]
    results = pool.run(world, torch_ranks.collectives_case, shape, 11)
    grid = results[0][2]
    inputs = [r[0] for r in results]
    for rank, (_, out, _) in enumerate(results):
        i, j = (int(x) for x in np.argwhere(grid == rank)[0])
        assert out["index"] == (i, j)
        for name in ("u8", "i32", "bool"):
            col = [inputs[int(r)][name] for r in grid[:, j]]
            row = [inputs[int(r)][name] for r in grid[i, :]]
            every = [inputs[int(r)][name] for r in grid.ravel()]
            got = out[name]
            np.testing.assert_array_equal(got["gather_nodes"],
                                          np.concatenate(col))
            np.testing.assert_array_equal(got["gather_txs_dim1"],
                                          np.concatenate(row, axis=1))
            np.testing.assert_array_equal(got["gather_both"],
                                          np.concatenate(every))
            n = shape[0]
            blocks = [np.split(x, n)[i] for x in col]
            np.testing.assert_array_equal(got["to_all_nodes"],
                                          np.concatenate(blocks))
            if name != "bool":
                dt = every[0].dtype
                np.testing.assert_array_equal(
                    got["psum_both"], np.sum(every, axis=0, dtype=dt))
                np.testing.assert_array_equal(
                    got["psum_txs"], np.sum(row, axis=0, dtype=dt))
                assert got["psum_both"].dtype == dt


def test_two_process_distributed_smoke(tmp_path):
    """The one place `initialize_runtime` brings up a real process group
    itself: two processes run two sharded rounds on a 2x1 mesh and read
    the same psum'd telemetry."""
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "go_avalanche_tpu_torch.parallel."
         "distributed_smoke", "--init-method", store, "--world-size", "2",
         "--rank", str(r), "--device", "cpu"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert {o["process"] for o in outs} == {0, 1}
    for o in outs:
        assert o["processes"] == 2 and o["devices"] == 2
        assert o["round"] == 2
    assert outs[0]["polls"] == outs[1]["polls"] == 16 * 8 > 0
    assert outs[0]["votes_applied"] == outs[1]["votes_applied"]
