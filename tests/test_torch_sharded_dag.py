"""The port's sharded conflict-set DAG (`parallel/sharded_dag.py`) against
the JAX package's `shard_map` driver: the cases of
tests/test_sharded_dag.py on the same mesh shapes, each held leaf-exact
(tolerance 0) against `run_sharded_dag` or the JAX step, plus the
placement refusals message for message.  The port runs in spawned gloo
ranks (`parallel/ranks.RankPool`)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu.parallel import sharded_dag as jsd
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.parallel import sharded_dag
from test_torch_avalanche import _configs, _jax_numpy
from test_torch_sharded import (assert_telemetry, assert_tree, jax_mesh,
                                port_numpy, start_port)
from go_avalanche_tpu_torch.parallel.ranks import RankPool
import torch_ranks


# The JAX package's dense DAG round, compiled once per config.
flat_round = jax.jit(jdag.round_step, static_argnums=1)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


def jax_dag_state(knobs, n=32, t=16, set_size=2, seed=0, cs=None,
                  weights=None):
    jcfg, _ = _configs(knobs)
    if cs is None:
        cs = jnp.arange(t, dtype=jnp.int32) // set_size
    state = jdag.init(jax.random.key(seed), n, jnp.asarray(cs, jnp.int32),
                      jcfg)
    if weights is not None:
        state = dataclasses.replace(
            state, base=state.base._replace(latency_weight=weights))
    if knobs.get("trace_every"):
        state = jdag.with_trace(state, jcfg, 8)
    return jcfg, state


def check_dag(pool, knobs, shape, rounds=3, mode="step", **kw):
    """Both drivers from one DAG state on one mesh shape."""
    jcfg, state = jax_dag_state(knobs, **kw)
    port = start_port(pool, shape[0] * shape[1], torch_ranks.dag_case,
                      port_numpy(state, dag=True), knobs, shape, mode,
                      rounds)
    mesh = jax_mesh(shape)
    placed = jsd.shard_dag_state(state, mesh)
    jtel = None
    if mode == "run":
        jfinal = jsd.run_sharded_dag(mesh, placed, jcfg, max_rounds=rounds)
    else:
        step = jsd.make_sharded_dag_round_step(mesh, jcfg)
        rows, jfinal = [], placed
        for _ in range(rounds):
            jfinal, row = step(jfinal)
            rows.append(row)
        jtel = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
    results = port.result()
    want = _jax_numpy(jfinal)
    for r, (got, tel, _, _) in enumerate(results):
        assert_tree(want, got, f"rank {r}")
        if jtel is not None:
            assert_telemetry(jtel, tel)
    return state, jfinal, results


@pytest.mark.parametrize("cs,match", [
    ([0, 0, 1, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 6, 7], "straddles"),
    ([0, 0, 1, 1, 0, 2, 2, 3] * 2, "sorted"),
])
def test_shard_dag_state_refusals_match(cs, match):
    from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS

    jstate = jdag.init(jax.random.key(0), 8, jnp.asarray(cs, jnp.int32),
                       JaxConfig())
    with pytest.raises(ValueError, match=match) as want:
        jsd.shard_dag_state(jstate, jax_mesh((4, 2)))
    tstate = convert.dag_state_from_numpy(_jax_numpy(jstate), device="cpu")

    class TwoTxShards:      # the placement checks read the txs width only
        shape = {NODES_AXIS: 1, TXS_AXIS: 2}

    with pytest.raises(ValueError, match=match) as got:
        sharded_dag.shard_dag_state(tstate, TwoTxShards())
    assert str(got.value) == str(want.value)


def test_one_round_shapes_and_telemetry(pool):
    _, _, results = check_dag(pool, {}, (2, 2), rounds=1)
    got, tel, _, _ = results[0]
    assert int(got.base.round) == 1
    assert got.base.records.votes.shape == (32, 16)
    assert int(tel["polls"][0]) == 32 * 16


def test_honest_network_resolves_every_set(pool):
    n, t, set_size = 32, 16, 2
    _, _, results = check_dag(pool, {}, (2, 2), rounds=400, mode="run")
    conf = results[0][0].base.records.confidence
    fin_acc = (np.asarray(jvr.has_finalized(jnp.asarray(conf)))
               & np.asarray(jvr.is_accepted(jnp.asarray(conf))))
    winners = fin_acc.reshape(n, t // set_size, set_size).sum(axis=2)
    assert (winners == 1).all()
    assert (fin_acc.argmax(axis=1) == fin_acc.argmax(axis=1)[0]).all()


@pytest.mark.parametrize("strategy", ["flip", "oppose_majority",
                                      "equivocate"])
def test_every_strategy_matches_jax(pool, strategy):
    check_dag(pool, dict(byzantine_fraction=0.25, flip_probability=1.0,
                         adversary_strategy=strategy), (2, 2), rounds=3)


def test_equivocation_stalls_and_flip_resolves_as_in_jax(pool):
    """The liveness attack survives sharding in the port as in the
    reference: equivocate stalls, flip resolves; both trajectories the
    reference's."""
    frac = {}
    for strategy in ("flip", "equivocate"):
        knobs = dict(byzantine_fraction=0.2, flip_probability=1.0,
                     adversary_strategy=strategy)
        _, _, results = check_dag(pool, knobs, (2, 2), rounds=60,
                                  mode="run")
        conf = results[0][0].base.records.confidence
        frac[strategy] = np.asarray(
            jvr.has_finalized(jnp.asarray(conf), _configs(knobs)[0])).mean()
    assert frac["flip"] > 0.9 and frac["equivocate"] < 0.1, frac


def test_nodes_only_mesh_matches_jax(pool):
    _, _, results = check_dag(pool, {}, (4, 1), rounds=400, mode="run",
                              n=64)
    conf = jnp.asarray(results[0][0].base.records.confidence)
    assert np.asarray(jvr.has_finalized(conf)).all()


def test_churn_toggles_membership_as_flat(pool):
    """At churn 1.0 every node toggles whatever the stream, so the
    sharded round's alive plane equals the flat round's."""
    knobs = dict(churn_probability=1.0)
    state, _, results = check_dag(pool, knobs, (2, 2), rounds=1)
    flat_new, _ = flat_round(state, _configs(knobs)[0])
    alive = results[0][0].base.alive
    assert not alive.any()
    np.testing.assert_array_equal(alive, np.asarray(flat_new.base.alive))


def test_weighted_sampling_deterministic_limit_matches_flat(pool):
    """All weight on node 0: every draw is node 0 on both paths, so the
    sharded confidence planes equal the flat round's too."""
    weights = jnp.zeros((32,), jnp.float32).at[0].set(1.0)
    knobs = dict(weighted_sampling=True)
    state, _, results = check_dag(pool, knobs, (2, 2), rounds=5,
                                  weights=weights)
    flat = state
    for _ in range(5):
        flat, _ = flat_round(flat, _configs(knobs)[0])
    np.testing.assert_array_equal(
        results[0][0].base.records.confidence,
        np.asarray(flat.base.records.confidence))


def test_arbitrary_sorted_partition_matches_jax(pool):
    """Sets of uneven size (no fixed set_size): the segment path."""
    cs = [0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 4, 4, 4, 5, 5, 5]
    check_dag(pool, dict(byzantine_fraction=0.2), (2, 2), rounds=4, cs=cs)


@pytest.mark.parametrize("knobs", [
    dict(byzantine_fraction=0.3, adversary_policy="split_vote"),
    dict(trace_every=2, drop_probability=0.1, max_element_poll=5),
    dict(ingest_engine="swar32", byzantine_fraction=0.2),
], ids=["split_vote", "traced-capped", "swar32"])
def test_policies_cap_and_trace_match_jax(pool, knobs):
    check_dag(pool, knobs, (2, 2), rounds=4)
