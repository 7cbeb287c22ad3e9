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


# ---------------------------------------- the donated fleet scan program

# The reference's flagship config (`benchmarks/workload.flagship_config`)
# at 32 txs, as plain knobs for the ranks.
FLAGSHIP_KNOBS = dict(finalization_score=0x7FFE, k=8, gossip=False,
                      max_element_poll=4096)


def _port_fleet_numpy(jstate):
    from go_avalanche_tpu_torch import convert
    from test_torch_avalanche import _jax_numpy

    return convert.state_to_numpy(convert.state_from_numpy(
        _jax_numpy(jstate), device="cpu"))


def test_fleet_flagship_state_matches_jax():
    from benchmarks import workload as jwl
    from go_avalanche_tpu_torch import convert, workload
    from test_torch_sharded import assert_tree

    for fleet in (1, 4):
        jstate, jcfg = jwl.fleet_flagship_state(fleet, 32, 32)
        state, cfg = workload.fleet_flagship_state(fleet, 32, 32,
                                                   device="cpu")
        assert_tree(_port_fleet_numpy(jstate),
                    convert.state_to_numpy(state), f"fleet {fleet}")
        assert (cfg.finalization_score, cfg.k, cfg.gossip,
                cfg.max_element_poll) == (jcfg.finalization_score, jcfg.k,
                                          jcfg.gossip, jcfg.max_element_poll)


def test_fleet_scan_program_matches_jax(pool):
    """F = 8 at 32 x 32 on a 2x2 fleet mesh, 2 rounds: every rank's
    gathered stack equals the JAX `fleet_scan_program` on its 2x2
    virtual-device mesh; the scan calls no collective and updates its
    block in place."""
    from benchmarks import workload as jwl
    from test_torch_avalanche import _jax_numpy
    from test_torch_sharded import assert_tree

    jstate, jcfg = jwl.fleet_flagship_state(8, 32, 32)
    start = _port_fleet_numpy(jstate)
    mesh = jax_fleet_mesh((2, 2))
    jout = jsf.fleet_scan_program(mesh, jcfg, 2)(
        jsf.shard_fleet_state(jstate, mesh))
    want = _jax_numpy(jout)
    for got, recorded, in_place in pool.run(
            4, torch_ranks.fleet_scan_case, start, FLAGSHIP_KNOBS, (2, 2),
            2):
        assert_tree(want, got, "fleet scan")
        assert recorded == set()
        assert in_place


def test_fleet_state_specs_footprints_match_jax():
    import jax

    from benchmarks import workload as jwl
    from go_avalanche_tpu.obs import resources as jres
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.obs import resources

    mesh = jsf.make_fleet_mesh(2, 2, devices=jax.devices()[:4])
    jstate = jax.eval_shape(lambda: jwl.fleet_flagship_state(8, 32, 32)[0])
    want = jres.footprint(jstate, jsf.fleet_state_specs(jstate), mesh)
    state, _ = workload.fleet_flagship_state(8, 32, 32, device="cpu")
    got = resources.footprint(state, sharded_fleet.fleet_state_specs(state),
                              {"trials": 2, "nodes": 2}, dtypes="reference")
    assert got == want
    assert sharded_fleet.FLEET_SPEC == (tuple(jsf.FLEET_SPEC[0]),)


def test_compiled_fleet_program_is_what_run_fleet_runs(monkeypatch):
    """`run_fleet` runs the memoised program `compiled_fleet_program`
    gives, and that program's vectors are the JAX program's on the same
    keys."""
    from go_avalanche_tpu_torch import prng

    jcfg, cfg = _configs(dict(finalization_score=8, byzantine_fraction=0.2))
    args = ("avalanche", cfg, 12, 8, 6, 2, 0.5, True, 64)
    taken = []
    real = tfleet.compiled_fleet_program

    def spy(*a, **kw):
        taken.append(real(*a, **kw))
        return taken[-1]

    monkeypatch.setattr(tfleet, "compiled_fleet_program", spy)
    res = tfleet.run_fleet("avalanche", cfg, fleet=3, n_nodes=12, n_txs=8,
                           n_rounds=6, device="cpu")
    program = real(*args, device="cpu")
    assert taken == [program] and real(*args, device="cpu") is program
    outcome, _, _ = program(prng.split(prng.key(0, "cpu"), 3))
    np.testing.assert_array_equal(outcome.violation.numpy(), res.violations)
    want, _, _ = jfleet.compiled_fleet_program(
        "avalanche", jcfg, 12, 8, 6, 2, 0.5, True, 64)(
        jax.random.split(jax.random.key(0), 3))
    for name in ("violation", "settled", "finality_round",
                 "finalized_fraction", "stalled"):
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(outcome, name).numpy(),
                                      err_msg=name)
