"""The port's sharded avalanche round (`parallel/sharded.py`) against the
JAX package's `shard_map` driver on the same mesh shape.

The JAX side runs here over the 8 virtual CPU devices; the port's side
runs in spawned gloo ranks (`parallel/ranks.RankPool`, one pool for the
module).  Both start from ONE global state (the JAX `init`, carried with
`convert.py`); the port's `gather_state` result must equal the JAX
global state leaf by leaf, and every telemetry row must be equal.
Tolerance 0.  Also: the poll cap's search and the packed gossip against
their flat oracles, the tx-only contract (a mesh with only tx shards
walks the 1x1 trajectory), each round's recorded collectives against
`DECLARED_COLLECTIVES`, and the megakernel refusal.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.parallel import sharded as jsh
from go_avalanche_tpu.parallel import sharded_dag as jsd
from go_avalanche_tpu.parallel.mesh import make_mesh as jmake_mesh
from go_avalanche_tpu_torch import convert
from test_torch_avalanche import _configs, _jax_numpy
from go_avalanche_tpu_torch.parallel.ranks import RankPool
import torch_ranks


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


_PORT_SIDE = concurrent.futures.ThreadPoolExecutor(1)


def start_port(pool, world, fn, *args):
    """`pool.run` in a thread, so that the ranks run while this process
    compiles the JAX side; ``.result()`` gives the ranks' results."""
    return _PORT_SIDE.submit(pool.run, world, fn, *args)


def jax_mesh(shape):
    return jmake_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])


def port_numpy(jstate, dag: bool = False):
    """A JAX state as the port's numpy tree (port classes only, so the
    ranks unpickle it without JAX)."""
    if dag:
        return convert.dag_state_to_numpy(convert.dag_state_from_numpy(
            _jax_numpy(jstate), device="cpu"))
    return convert.state_to_numpy(convert.state_from_numpy(
        _jax_numpy(jstate), device="cpu"))


def assert_tree(want, got, where="state"):
    """Two numpy state trees (NamedTuples, or the reference's
    dataclass DAG state) equal leaf by leaf, dtypes included; a trace
    buffer by data, cursor, columns and stride."""
    if want is None or got is None:
        assert want is None and got is None, where
        return
    if hasattr(want, "cursor"):
        assert tuple(want.columns) == tuple(got.columns), where
        assert want.stride == got.stride, where
        assert_tree(np.asarray(want.data), np.asarray(got.data),
                    f"{where}.data")
        assert_tree(np.asarray(want.cursor), np.asarray(got.cursor),
                    f"{where}.cursor")
        return
    names = (want._fields if hasattr(want, "_fields") else
             [f.name for f in dataclasses.fields(want)]
             if dataclasses.is_dataclass(want) else None)
    if names is not None:
        for name in names:
            assert_tree(getattr(want, name), getattr(got, name),
                        f"{where}.{name}")
        return
    if isinstance(want, int):
        assert want == got, where
        return
    w, g = np.asarray(want), np.asarray(got)
    assert w.dtype == g.dtype, (where, w.dtype, g.dtype)
    np.testing.assert_array_equal(w, g, err_msg=where)


def assert_telemetry(jtel, tel):
    assert set(tel) == set(jtel._fields)
    for name in jtel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jtel, name)),
                                      tel[name], err_msg=name)


def jax_avalanche_state(knobs, n, t, seed=3, contested=True, added=None,
                        weights=None, track=True, trace_rounds=0):
    jcfg, _ = _configs(knobs)
    pref = jav.contested_init_pref(seed, n, t) if contested else None
    state = jav.init(jax.random.key(seed), n, t, jcfg, init_pref=pref,
                     added=added, latency_weights=weights,
                     track_finality=track)
    if trace_rounds:
        state = jav.with_trace(state, jcfg, trace_rounds)
    return jcfg, state


def check_avalanche(pool, knobs, shape, n=32, t=16, rounds=4,
                    mode="scan", **init_kw):
    """Both drivers from one state on one mesh shape; returns the
    ranks' results."""
    jcfg, state = jax_avalanche_state(knobs, n, t, trace_rounds=(
        rounds if knobs.get("trace_every") else 0), **init_kw)
    port = start_port(pool, shape[0] * shape[1], torch_ranks.avalanche_case,
                      port_numpy(state), knobs, shape, mode, rounds)
    mesh = jax_mesh(shape)
    placed = jsh.shard_state(state, mesh)
    if mode == "run":
        jfinal, jtel = jsh.run_sharded(mesh, placed, jcfg,
                                       max_rounds=rounds), None
    elif mode == "step":
        step = jsh.make_sharded_round_step(mesh, jcfg)
        rows, jfinal = [], placed
        for _ in range(rounds):
            jfinal, row = step(jfinal)
            rows.append(row)
        jtel = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
    else:
        jfinal, jtel = jsh.run_scan_sharded(mesh, placed, jcfg,
                                            n_rounds=rounds)
    results = port.result()
    want = _jax_numpy(jfinal)
    for r, (got, tel, _, _) in enumerate(results):
        assert_tree(want, got, f"rank {r}")
        if jtel is not None:
            assert_telemetry(jtel, tel)
    return results


BYZ = dict(byzantine_fraction=0.25, drop_probability=0.2)
# One JAX program each (its compile is most of a case's time), so the
# knobs share cases where they do not interact.
CASES = [
    (BYZ, (1, 1)),
    (BYZ, (2, 1)),
    (dict(BYZ, adversary_strategy="oppose_majority"), (4, 1)),
    (dict(BYZ, adversary_strategy="equivocate", ingest_engine="swar32"),
     (2, 2)),
    (dict(byzantine_fraction=0.3, adversary_policy="split_vote"), (2, 2)),
    (dict(byzantine_fraction=0.3, adversary_policy="withhold_near_quorum",
          max_element_poll=7), (1, 4)),
    (dict(byzantine_fraction=0.2, adversary_policy="stake_eclipse",
          stake_mode="zipf"), (2, 2)),
    (dict(BYZ, max_element_poll=5), (2, 2)),
    (dict(churn_probability=0.1), (4, 1)),
    (dict(fault_script=(("churn_burst", 1, 0.5),)), (2, 2)),
    (dict(weighted_sampling=True), (2, 2)),
    (dict(n_clusters=2, cluster_locality=0.7), (4, 1)),
    (dict(stake_mode="zipf", n_clusters=2), (2, 2)),
    (dict(vote_mode="majority", byzantine_fraction=0.2), (1, 2)),
    (dict(trace_every=2, byzantine_fraction=0.2), (2, 2)),
]


@pytest.mark.parametrize("knobs,shape", CASES,
                         ids=[f"{'-'.join(k)}-{a}x{b}"
                              for k, (a, b) in CASES])
def test_scan_matches_jax(pool, knobs, shape):
    weights = None
    if knobs.get("weighted_sampling"):
        weights = jnp.asarray(np.random.default_rng(4).random(32) + 0.1,
                              jnp.float32)
    check_avalanche(pool, knobs, shape, weights=weights)


@pytest.mark.parametrize("fused", [False, True])
def test_gossip_both_engines_match_jax(pool, fused):
    # Only the first rows know the targets: gossip must spread them.
    added = jnp.zeros((32, 16), jnp.bool_).at[:4, :].set(True)
    results = check_avalanche(pool, dict(fused_sharded_gossip=fused),
                              (2, 2), rounds=5, added=added,
                              contested=False)
    assert results[0][1]["admissions"].sum() > 0


def test_run_sharded_matches_jax_and_reads_once_a_round(pool):
    """The default config to settlement."""
    results = check_avalanche(pool, {}, (2, 2), rounds=200, mode="run")
    state, _, _, reads = results[0]
    # one read of the start round, then one of the flag per round and
    # one before the first
    assert reads == int(state.round) + 2


def test_track_finality_off_matches_jax(pool):
    results = check_avalanche(pool, dict(finalization_score=16), (2, 2),
                              rounds=100, mode="run", track=False)
    assert results[0][0].finalized_at is None


def test_tx_only_meshes_walk_the_node_only_trajectory(pool):
    """The contract of the per-shard keys: tx sharding changes nothing
    (1x2 == 1x4 == 1x1, 2x2 == 2x1), in the port alone."""
    knobs = dict(BYZ, gossip=True, max_element_poll=20)
    _, state = jax_avalanche_state(knobs, 64, 48)
    start = port_numpy(state)

    def run(shape):
        return pool.run(shape[0] * shape[1], torch_ranks.avalanche_case,
                        start, knobs, shape, "scan", 6)[0]

    for base, others in (((1, 1), [(1, 2), (1, 4)]), ((2, 1), [(2, 2)])):
        want = run(base)
        for shape in others:
            got = run(shape)
            assert_tree(want[0], got[0], f"{shape} vs {base}")
            for name in want[1]:
                np.testing.assert_array_equal(want[1][name], got[1][name])
    assert not np.array_equal(run((1, 1))[0].records.votes,
                              run((2, 1))[0].records.votes)


def test_round_records_its_declared_collectives(pool):
    """One round that exercises every collective of the driver records
    exactly `DECLARED_COLLECTIVES`: the packed plane's and the alive
    vector's gathers, the gossip all-to-all, the minority and ring
    psums over nodes, the telemetry psum over both axes — and the poll
    cap's psum over txs, which the reference's manifest omits."""
    from go_avalanche_tpu_torch.parallel import sharded
    from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS

    knobs = dict(byzantine_fraction=0.25,
                 adversary_strategy="oppose_majority",
                 churn_probability=0.1, max_element_poll=5,
                 latency_mode="fixed", latency_rounds=1, time_step_s=1.0,
                 request_timeout_s=3.0)
    _, state = jax_avalanche_state(knobs, 32, 16)
    results = pool.run(4, torch_ranks.avalanche_case, port_numpy(state),
                       knobs, (2, 2), "step", 1)
    for _, _, recorded, _ in results:
        assert recorded == sharded.DECLARED_COLLECTIVES
    assert jsh.DECLARED_COLLECTIVES | {("all_reduce", (TXS_AXIS,))} == {
        (kind, tuple(axes)) for kind, axes in sharded.DECLARED_COLLECTIVES}
    assert (NODES_AXIS, TXS_AXIS) == ("nodes", "txs")


def test_dag_round_records_its_declared_collectives(pool):
    from go_avalanche_tpu_torch.parallel import sharded_dag

    knobs = dict(byzantine_fraction=0.25,
                 adversary_strategy="oppose_majority",
                 churn_probability=0.1, max_element_poll=5,
                 latency_mode="fixed", latency_rounds=1, time_step_s=1.0,
                 request_timeout_s=3.0)
    jcfg, _ = _configs(knobs)
    state = jdag.init(jax.random.key(1), 32,
                      jnp.arange(16, dtype=jnp.int32) // 2, jcfg)
    results = pool.run(4, torch_ranks.dag_case, port_numpy(state, dag=True),
                       knobs, (2, 2), "step", 1)
    for _, _, recorded, _ in results:
        assert recorded == sharded_dag.DECLARED_COLLECTIVES
    from go_avalanche_tpu_torch.parallel.mesh import TXS_AXIS
    assert jsd.DECLARED_COLLECTIVES | {("all_reduce", (TXS_AXIS,))} == (
        sharded_dag.DECLARED_COLLECTIVES)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_global_capped_poll_mask_matches_flat_oracle(pool, shape):
    n, t, cap = 16, 64, 10
    rng = np.random.default_rng(0)
    pollable = rng.random((n, t)) < 0.6
    rank = rng.permutation(t).astype(np.int32)
    flat = np.asarray(jav.capped_poll_mask(jnp.asarray(pollable),
                                           jnp.asarray(rank), cap))
    outs = pool.run(shape[0] * shape[1], torch_ranks.poll_cap_case,
                    pollable, rank, cap, shape)
    for out in outs:
        np.testing.assert_array_equal(out, flat)
    full = pollable.sum(axis=1) >= cap
    assert (flat.sum(axis=1)[full] == cap).all()


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_gossip_heard_packed_matches_oracle(pool, shape):
    """Both scatter engines equal the dense 'any pollster polled me
    about t' relation, duplicate draws included."""
    n, t, k = 32, 32, 4
    rng = np.random.default_rng(1)
    peers = rng.integers(0, 5, (n, k)).astype(np.int32)
    polled = rng.random((n, t)) < 0.5
    expected = np.zeros((n, t), bool)
    for i in range(n):
        for j in range(k):
            expected[peers[i, j]] |= polled[i]
    for fused in (False, True):
        outs = pool.run(shape[0] * shape[1], torch_ranks.gossip_case,
                        peers, polled, fused, shape)
        for out in outs:
            np.testing.assert_array_equal(out, expected)


def test_megakernel_is_refused_with_the_reference_message():
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.parallel import sharded, sharded_dag
    from go_avalanche_tpu.config import AvalancheConfig as JaxConfig

    with pytest.raises(ValueError) as want:
        jsh._reject_round_engine(JaxConfig(round_engine="megakernel"))
    for build in (sharded.make_sharded_round_step,
                  sharded_dag.make_sharded_dag_round_step):
        with pytest.raises(ValueError) as got:
            build(None, AvalancheConfig(round_engine="megakernel"))
        assert str(got.value) == str(want.value)
