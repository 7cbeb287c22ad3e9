"""The async query ring on the port's sharded drivers against the JAX
package's: the cases of tests/test_inflight_sharded.py for the
avalanche and DAG drivers — latency-0 parity with the synchronous
round, a geometric-latency run to settlement under `donate`, the
partition cut on global node ids, and the coalesced ring at per-shard
widths that are not byte multiples (t=20 and t=26 over 2 tx shards) on
all three delivery engines.  Every final leaf and telemetry row is held
to the JAX driver's on the same mesh shape (tolerance 0); the port runs
in spawned gloo ranks (`parallel/ranks.RankPool`)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu.parallel import sharded as jsh
from test_torch_avalanche import _configs, _jax_numpy
from test_torch_sharded import (assert_tree, check_avalanche,
                                jax_avalanche_state, jax_mesh, port_numpy,
                                start_port)
from test_torch_sharded_dag import check_dag, jax_dag_state
from go_avalanche_tpu_torch.parallel.ranks import RankPool
import torch_ranks

TIMING = dict(time_step_s=1.0, request_timeout_s=3.0)
ASYNC0 = dict(latency_mode="fixed", latency_rounds=0, **TIMING)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


def port_run(pool, knobs, shape, state, case="avalanche_case", **kw):
    """The port's sharded drive alone (no JAX side): rank 0's result."""
    return pool.run(shape[0] * shape[1], f"torch_ranks:{case}", state, knobs,
                    shape, kw.get("mode", "scan"), kw["rounds"])[0]


def test_latency0_parity_with_the_sync_round(pool):
    """Latency 0 through the ring (held to JAX) walks the synchronous
    round's trajectory in the port."""
    sync = dict(finalization_score=16)
    _, start = jax_avalanche_state(sync, 16, 16, seed=0)
    port = start_port(pool, 4, torch_ranks.avalanche_case,
                      port_numpy(start), sync, (2, 2), "scan", 8)
    b = check_avalanche(pool, dict(sync, **ASYNC0), (2, 2), n=16, t=16,
                        rounds=8, seed=0)
    a = port.result()
    np.testing.assert_array_equal(a[0][0].records.confidence,
                                  b[0][0].records.confidence)
    np.testing.assert_array_equal(a[0][1]["votes_applied"],
                                  b[0][1]["votes_applied"])
    assert b[0][0].inflight is not None


def test_dag_latency0_parity_with_the_sync_round(pool):
    sync = dict(finalization_score=16)
    _, _, b = check_dag(pool, dict(sync, **ASYNC0), (2, 2), rounds=8, n=16,
                        seed=2)
    _, start = jax_dag_state(sync, n=16, seed=2)
    a = [port_run(pool, sync, (2, 2), port_numpy(start, dag=True),
                  case="dag_case", mode="step", rounds=8)]
    np.testing.assert_array_equal(a[0][0].base.records.confidence,
                                  b[0][0].base.records.confidence)


def test_geometric_latency_settles_with_donation(pool):
    """Real latency through the settle driver (`run_sharded`, donated in
    the reference) on the walk engine; the other two engines are held
    to it below."""
    knobs = dict(finalization_score=16, latency_mode="geometric",
                 latency_rounds=2, time_step_s=1.0, request_timeout_s=6.0)
    results = check_avalanche(pool, knobs, (2, 2), n=16, t=16, rounds=300,
                              mode="run", seed=1)
    conf = jnp.asarray(results[0][0].records.confidence)
    assert np.asarray(jvr.has_finalized(conf, _configs(knobs)[0])).all()


def test_partition_cut_uses_global_node_ids(pool):
    """A partition for the whole run with opposite unanimous priors on
    its sides: side A (global rows < N/2) keeps YES, side B NO — across
    node shards only if each rank offsets its rows."""
    n, t = 16, 16
    knobs = dict(finalization_score=16, skip_absent_votes=True,
                 partition_spec=(0, 10_000, 0.5), **TIMING)
    pref = jnp.concatenate([jnp.ones((n // 2, t), jnp.bool_),
                            jnp.zeros((n // 2, t), jnp.bool_)])
    jcfg = _configs(knobs)[0]
    state = jav.init(jax.random.key(3), n, t, jcfg, init_pref=pref)
    port = start_port(pool, 4, torch_ranks.avalanche_case, port_numpy(state),
                      knobs, (4, 1), "step", 30)
    mesh = jax_mesh((4, 1))
    step = jsh.make_sharded_round_step(mesh, jcfg)
    placed = jsh.shard_state(state, mesh)
    for _ in range(30):
        placed, _ = step(placed)
    got = port.result()[0]
    assert_tree(_jax_numpy(placed), got[0])
    acc = (got[0].records.confidence & 1).astype(bool)
    assert acc[: n // 2].all() and not acc[n // 2:].any()
    assert got[1]["partition_blocked"].sum() > 0


_WALK = {}     # t -> the port's walk-engine run, shared by both engines


@pytest.mark.parametrize("t", [20, 26])
@pytest.mark.parametrize("engine", ["walk_earlyout", "coalesced"])
def test_unaligned_shard_width_matches_jax_and_walk(pool, t, engine):
    """The coalesced ring's poll-mask plane packs each tx shard's
    columns into its own bytes (t/2 columns padded per shard); under
    geometric latency every engine walks the walk engine's trajectory
    and the JAX driver's, the ring planes included."""
    walk = dict(finalization_score=16, latency_mode="geometric",
                latency_rounds=2, **TIMING)
    if t not in _WALK:     # the walk engine is held to JAX above
        _, start = jax_avalanche_state(walk, 16, t, seed=5)
        _WALK[t] = [port_run(pool, walk, (2, 2), port_numpy(start),
                             rounds=7)]
    ref = _WALK[t]
    got = check_avalanche(pool, dict(walk, inflight_engine=engine), (2, 2),
                          n=16, t=t, rounds=7, seed=5)
    for leaf in ("votes", "consider", "confidence"):
        np.testing.assert_array_equal(getattr(ref[0][0].records, leaf),
                                      getattr(got[0][0].records, leaf))
    np.testing.assert_array_equal(ref[0][1]["votes_applied"],
                                  got[0][1]["votes_applied"])
    if engine == "coalesced":
        # two shards of ceil((t/2)/8) bytes each
        assert got[0][0].inflight.polled.shape[-1] == 2 * (-(-(t // 2)
                                                              // 8))


@pytest.mark.parametrize("engine", ["walk", "coalesced"])
def test_dag_async_matches_jax(pool, engine):
    knobs = dict(finalization_score=16, latency_mode="geometric",
                 latency_rounds=1, inflight_engine=engine,
                 byzantine_fraction=0.2, **TIMING)
    check_dag(pool, knobs, (2, 2), rounds=6, n=16, t=20)
