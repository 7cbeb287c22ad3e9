"""The port's trial-sharded fleet (`parallel/sharded_fleet.py`) against
the JAX package's dense and sharded fleets.

Each rank of a fleet mesh runs F/D whole trials; the gathered per-trial
vectors, realizations, stacked telemetry and trace planes must equal the
JAX dense fleet's and the JAX sharded fleet's (which are the same by
the reference's design), and the summary and phase-grid rows must be
the reference's.  Also the refusal of an indivisible fleet, message for
message, and the one-rank mesh collapsing to the dense loop.  The port
runs in spawned gloo ranks (`parallel/ranks.RankPool`); tolerance 0.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from go_avalanche_tpu import fleet as jfleet
from go_avalanche_tpu.parallel import sharded_fleet as jsf
from go_avalanche_tpu_torch import fleet as tfleet
from go_avalanche_tpu_torch.parallel import sharded_fleet
from test_torch_avalanche import _configs
from test_torch_fleet import assert_tree_equal
from test_torch_sharded import start_port
from go_avalanche_tpu_torch.parallel.ranks import RankPool
import torch_ranks

TIMING = dict(time_step_s=1.0, request_timeout_s=3.0)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


def jax_fleet_mesh(shape):
    return jsf.make_fleet_mesh(*shape)


def check_sharded_fleet(pool, model, knobs, shape, jax_sharded=False,
                        **kw):
    jcfg, _ = _configs(knobs)
    port = start_port(pool, shape[0] * shape[1], torch_ranks.fleet_case,
                      model, knobs, kw, shape)
    wants = [jfleet.run_fleet(model, jcfg, **kw)]
    if jax_sharded:
        wants.append(jfleet.run_fleet(model, jcfg, mesh=jax_fleet_mesh(shape),
                                      **kw))
    results = port.result()
    for want in wants:
        for vectors, tel, trace, summary, realized, recorded in results:
            assert recorded == sharded_fleet.DECLARED_COLLECTIVES
            assert recorded == jsf.DECLARED_COLLECTIVES
            for name in torch_ranks.FLEET_VECTORS:
                assert_tree_equal(getattr(want, name), vectors[name], name)
            assert_tree_equal(jax.tree.map(np.asarray, want.telemetry), tel,
                              "telemetry")
            assert summary == want.summary()
            assert realized == want.realizations()
            if want.trace is None:
                assert trace is None
            else:
                np.testing.assert_array_equal(np.asarray(want.trace.data),
                                              trace[0])
                np.testing.assert_array_equal(np.asarray(want.trace.cursor),
                                              trace[1])
    return results


@pytest.mark.parametrize("model,knobs,kw,shape", [
    ("snowball", dict(finalization_score=12, byzantine_fraction=0.3,
                      adversary_policy="split_vote", trace_every=2),
     dict(fleet=8, n_nodes=24, n_rounds=14, yes_fraction=0.5), (2, 2)),
    ("dag", dict(finalization_score=8, byzantine_fraction=0.25),
     dict(fleet=4, n_nodes=16, n_txs=12, n_rounds=10, conflict_size=3),
     (4, 1)),
    ("backlog", dict(finalization_score=6, arrival_mode="poisson",
                     arrival_rate=2.0),
     dict(fleet=4, n_nodes=12, n_txs=24, n_rounds=16, window=8), (1, 2)),
], ids=["snowball-traced-2x2", "dag-4x1", "backlog-1x2"])
def test_sharded_fleet_matches_jax_dense(pool, model, knobs, kw, shape):
    check_sharded_fleet(pool, model, knobs, shape, **kw)


def test_sharded_fleet_realizations_match_jax_dense_and_sharded(pool):
    """The avalanche fleet under a stochastic partition realized per
    trial from each trial's key: the gathered realizations and vectors
    equal both JAX fleets'."""
    knobs = dict(finalization_score=10, byzantine_fraction=0.2,
                 adversary_policy="timing", latency_mode="fixed",
                 latency_rounds=1, inflight_engine="coalesced",
                 fault_script=(("stochastic_partition", (2, 4), (2, 5),
                                (0.3, 0.6)),), **TIMING)
    results = check_sharded_fleet(pool, "avalanche", knobs, (2, 2),
                                  jax_sharded=True, fleet=4, n_nodes=12,
                                  n_txs=8, n_rounds=10)
    assert "cut" in results[0][4]


def test_sharded_phase_grid_rows_match_jax(pool):
    base = dict(finalization_score=12, byzantine_fraction=0.3)
    jcfg, _ = _configs(base)
    grid = {"adversary_policy": ["off", "split_vote"]}
    kw = dict(fleet=4, n_nodes=16, n_txs=8, n_rounds=10)
    want = jfleet.run_phase_grid("avalanche", jcfg, grid, **kw)
    for rows in pool.run(2, torch_ranks.phase_grid_case, "avalanche", base,
                         grid, kw, (2, 1)):
        assert rows == want


def test_indivisible_fleet_is_refused_as_in_jax(pool):
    with pytest.raises(ValueError) as want:
        jfleet.run_fleet("snowball", _configs({})[0], fleet=3, n_nodes=8,
                         n_rounds=1, mesh=jax_fleet_mesh((2, 1)))
    got = pool.run(2, torch_ranks.fleet_refusal_case, 3, (2, 1))
    assert got == [str(want.value)] * 2


def test_fleet_mesh_arithmetic_refusals():
    with pytest.raises(ValueError, match="must be >= 1") as got:
        sharded_fleet.make_fleet_mesh(0)
    with pytest.raises(ValueError) as want:
        jsf.make_fleet_mesh(0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs 2 devices, found 1"):
        sharded_fleet.make_fleet_mesh(2)
    assert sharded_fleet.mesh_devices(None) == 0


def test_one_rank_mesh_collapses_to_the_dense_loop():
    cfg = _configs(dict(finalization_score=8))[1]
    kw = dict(fleet=3, n_nodes=12, n_txs=8, n_rounds=6)
    one = tfleet.run_fleet("avalanche", cfg, device="cpu",
                           mesh=sharded_fleet.make_fleet_mesh(1), **kw)
    dense = tfleet.run_fleet("avalanche", cfg, device="cpu", **kw)
    assert one.summary() == dense.summary()
    for name in torch_ranks.FLEET_VECTORS:
        assert_tree_equal(getattr(dense, name), getattr(one, name), name)
