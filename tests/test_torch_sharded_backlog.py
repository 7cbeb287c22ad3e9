"""The port's sharded streaming backlog and node stream
(`parallel/sharded_backlog.py`, `parallel/sharded_node_stream.py`)
against the JAX package's `shard_map` drivers on the same mesh shapes.

The JAX side runs here over the 8 virtual CPU devices, each driver's
step program compiled once per (driver, mesh shape, config) and reused;
the port's side runs in one module-scoped `parallel/ranks.RankPool` of 4
spawned gloo ranks (`tests/torch_ranks.stream_case`).  Both start from
one global state; every gathered leaf and every stacked telemetry row
must be equal (tolerance 0), except the node stream's float
`resident_stake`, held within 2 ulp (its float64 sum, ROADMAP.md Queue
3).  Also: the tx-only contract, each driver's recorded collectives
against its `DECLARED_COLLECTIVES`, and the refusals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu.parallel import sharded_backlog as jsbl
from go_avalanche_tpu.parallel import sharded_node_stream as jsns
from go_avalanche_tpu.parallel import sharded_streaming_dag as jssd
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.parallel.ranks import RankPool
from test_torch_avalanche import _configs, _jax_numpy
from test_torch_sharded import assert_tree, jax_mesh, start_port
import torch_ranks


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


# kind -> (JAX sharded module, placement, step builder, the port's numpy
# carrier)
JAX_DRIVERS = {
    "backlog": (jsbl, "shard_backlog_state", "make_sharded_backlog_step",
                "backlog_state"),
    "streaming_dag": (jssd, "shard_streaming_dag_state",
                      "make_sharded_streaming_dag_step",
                      "streaming_dag_state"),
    "node_stream": (jsns, "shard_node_stream_state", None,
                    "node_stream_state"),
}
_PROGRAMS: dict = {}
# The poll-order rank leaves: per tx shard by design (module docstrings).
RANK_LEAVES = ("score_rank", "poll_order", "poll_order_inv")


def port_numpy(kind: str, jstate):
    """A JAX state of `kind` as the port's numpy tree (port classes
    only, so the ranks unpickle it without JAX)."""
    carrier = JAX_DRIVERS[kind][3]
    return getattr(convert, f"{carrier}_to_numpy")(getattr(
        convert, f"{carrier}_from_numpy")(_jax_numpy(jstate), device="cpu"))


def jax_program(kind: str, jstate, knobs: dict, shape, mode: str,
                rounds: int):
    """The JAX driver's program for `mode` on `shape`: the step ("step",
    "scan"), the settle program ("run") or, for the node stream, the
    scan program; built once per (driver, mesh shape, config, state
    layout, and the rounds of a settle or scan program) and reused, so
    no case repeats a compile."""
    leaves, tree = jax.tree.flatten(jstate)
    key = (kind, shape, tuple(sorted(knobs.items())),
           (mode, rounds) if mode == "run" or kind == "node_stream"
           else "step", str(tree), tuple(x.shape for x in leaves))
    if key not in _PROGRAMS:
        mod, _, make, _ = JAX_DRIVERS[kind]
        mesh, jcfg = jax_mesh(shape), _configs(knobs)[0]
        if kind == "node_stream":      # the reference has no step builder
            _PROGRAMS[key] = jsns.scan_program(mesh, jstate, jcfg, rounds)
        elif mode == "run":
            _PROGRAMS[key] = mod.settle_program(mesh, jstate, jcfg, rounds)
        else:
            _PROGRAMS[key] = getattr(mod, make)(mesh, jcfg)
    return _PROGRAMS[key]


def jax_drive(kind, jstate, knobs, shape, mode, rounds):
    """The JAX driver from `jstate`: `rounds` steps ("step"/"scan", with
    the stacked telemetry) or the settle driver ("run")."""
    mod, place, _, _ = JAX_DRIVERS[kind]
    placed = getattr(mod, place)(jstate, jax_mesh(shape))
    program = jax_program(kind, jstate, knobs, shape, mode, rounds)
    if kind == "node_stream":
        return program(placed)
    if mode == "run":
        return program(placed), None
    rows = []
    for _ in range(rounds):
        placed, row = program(placed)
        rows.append(row)
    return placed, jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def assert_tel(jtel, tel, where="telemetry"):
    """A JAX telemetry tree against the ranks' nested dicts;
    `resident_stake` within 2 ulp, every other field equal."""
    if jtel is None:
        assert tel is None, where
        return
    if hasattr(jtel, "_fields"):
        assert set(tel) == set(jtel._fields), where
        for name in jtel._fields:
            assert_tel(getattr(jtel, name), tel[name], f"{where}.{name}")
        return
    want = np.asarray(jtel)
    if where.endswith("resident_stake"):
        np.testing.assert_array_max_ulp(want, tel, maxulp=2)
        return
    assert want.dtype == tel.dtype, where
    np.testing.assert_array_equal(want, tel, err_msg=where)


def check_stream(pool, kind, jstate, knobs, shape, mode="step", rounds=8,
                 compare=True):
    """Both drivers of `kind` from `jstate` on one mesh shape; every
    rank's gathered state and telemetry against the JAX driver's.
    Returns the ranks' results and the JAX final state."""
    port = start_port(pool, shape[0] * shape[1], torch_ranks.stream_case,
                      kind, port_numpy(kind, jstate), knobs, shape, mode,
                      rounds)
    jfinal, jtel = jax_drive(kind, jstate, knobs, shape, mode, rounds)
    results = port.result()
    if compare:
        want = _jax_numpy(jfinal)
        for r, (got, tel, _, _) in enumerate(results):
            assert_tree(want, got, f"rank {r}")
            assert_tel(jtel, tel)
    return results, jfinal


def backlog_state(knobs, n_txs=24, n_nodes=16, slots=8, seed=0,
                  valid=None, trace_rounds=0):
    jcfg = _configs(knobs)[0]
    b = jbl.make_backlog(jnp.arange(n_txs, dtype=jnp.int32), valid=valid)
    state = jbl.init(jax.random.key(seed), n_nodes, slots, b, jcfg)
    if trace_rounds:
        state = jbl.with_trace(state, jcfg, trace_rounds)
    return state


def node_stream_state(knobs, n_txs=8, seed=1):
    return jns.init(jax.random.key(seed), n_txs, _configs(knobs)[0])


NODE_STREAM = dict(stake_mode="zipf", registry_nodes=24, active_nodes=8,
                   node_churn_rate=0.3)
ASYNC = dict(finalization_score=8, latency_mode="fixed", latency_rounds=1,
             time_step_s=1.0, request_timeout_s=4.0)
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_backlog_settles_as_jax(pool, shape):
    """The default config to settlement, harvest pass included."""
    results, _ = check_stream(pool, "backlog", backlog_state({}), {}, shape,
                              mode="run", rounds=2000)
    out = results[0][0].outputs
    assert out.settled.all() and out.accepted.all()
    assert (out.settle_round > out.admit_round).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_node_stream_matches_jax(pool, shape):
    knobs = dict(NODE_STREAM, byzantine_fraction=0.25)
    results, _ = check_stream(pool, "node_stream", node_stream_state(knobs),
                              knobs, shape, rounds=6)
    assert int(results[0][0].churned_in) > 0


# FLIP on the swar32 engine under a global poll cap, through the step
# builder and through the scan driver (one JAX step program for both).
FLIP = dict(ingest_engine="swar32", byzantine_fraction=0.2,
            flip_probability=1.0, drop_probability=0.1, max_element_poll=5)


@pytest.mark.parametrize("knobs,shape,mode,rounds", [
    (FLIP, (2, 2), "step", 10),
    (dict(ASYNC), (2, 2), "run", 3000),
    (dict(trace_every=2, byzantine_fraction=0.2), (1, 2), "scan", 6),
    (FLIP, (2, 2), "scan", 6),
], ids=["flip", "async", "traced", "swar32-capped"])
def test_backlog_configs_match_jax(pool, knobs, shape, mode, rounds):
    check_stream(pool, "backlog", backlog_state(
        knobs, trace_rounds=rounds if knobs.get("trace_every") else 0),
        knobs, shape, mode, rounds)


def test_invalid_txs_drop_as_jax(pool):
    """tests/test_sharded_backlog.py's invalid txs (the lowest-scored,
    admitted last): every tx settles, the invalid ones with no accept
    votes."""
    valid = jnp.arange(24) >= 8
    results, _ = check_stream(pool, "backlog", backlog_state(
        {}, valid=valid), {}, (2, 2), mode="run", rounds=2000)
    out = results[0][0].outputs
    assert out.settled.all()
    assert (out.accept_votes[-8:] == 0).all()
    assert (out.accept_votes[:-8] > 0).all()


def test_arrival_sequence_dense_vs_sharded(pool):
    """tests/test_traffic.py's pin: the sharded arrival sequence is the
    dense scheduler's (the port's, which tests/test_torch_traffic.py
    holds to the JAX one), and the port's telemetry the JAX driver's."""
    from go_avalanche_tpu_torch.models import backlog as tbl

    knobs = dict(arrival_mode="poisson", arrival_rate=3.0)
    start = backlog_state(knobs, n_txs=48, slots=16)
    results, _ = check_stream(pool, "backlog", start, knobs, (2, 2),
                              mode="scan", rounds=22)
    dense_tel = tbl.run_scan(convert.backlog_state_from_numpy(
        _jax_numpy(start), device="cpu"), _configs(knobs)[1], 22,
        device="cpu")[1].traffic
    tel = results[0][1]["traffic"]
    np.testing.assert_array_equal(dense_tel.arrivals.numpy(),
                                  tel["arrivals"])
    np.testing.assert_array_equal(dense_tel.arrived_total.numpy(),
                                  tel["arrived_total"])
    assert tel["lat_count"][-1] > 0


def test_node_stream_working_set_parity_dense_vs_sharded(pool):
    """tests/test_node_stream.py's pin on 2x2: the port's sharded
    working set (slot_node, resident, stake, churn counters, the
    row-propensity plane, departures) equals the port's dense
    scheduler's (which tests/test_torch_node_stream.py holds to the JAX
    one)."""
    from go_avalanche_tpu_torch.models import node_stream as tns

    knobs = dict(NODE_STREAM, byzantine_fraction=0.25)
    start = node_stream_state(knobs)
    results, _ = check_stream(pool, "node_stream", start, knobs, (2, 2),
                              rounds=6)
    tdense, ttel = tns.run_scan(
        convert.node_stream_state_from_numpy(_jax_numpy(start),
                                             device="cpu"),
        _configs(knobs)[1], 6, device="cpu")
    tdense = convert.node_stream_state_to_numpy(tdense)
    got, tel = results[0][0], results[0][1]
    for leaf in ("slot_node", "resident", "stake", "churned_in",
                 "churned_out"):
        np.testing.assert_array_equal(getattr(got, leaf),
                                      getattr(tdense, leaf), err_msg=leaf)
    np.testing.assert_array_equal(got.sim.latency_weight,
                                  tdense.sim.latency_weight)
    np.testing.assert_array_equal(tel["departed"], ttel.departed.numpy())
    np.testing.assert_array_equal(tel["resident_stake"],
                                  ttel.resident_stake.numpy())
    assert int(got.churned_in) > 0


def _flat(tree, prefix=""):
    if tree is None or isinstance(tree, int):
        return {}
    if hasattr(tree, "_fields"):
        out = {}
        for name in tree._fields:
            out.update(_flat(getattr(tree, name), f"{prefix}.{name}"))
        return out
    if hasattr(tree, "cursor"):
        return {f"{prefix}.data": np.asarray(tree.data)}
    return {prefix: np.asarray(tree)}


def assert_tx_only(pool, kind, start_np, knobs, rounds, ranks_differ):
    """1x2 walks 1x1 and 2x2 walks 2x1 (the tx-only contract, as the JAX
    drivers show it), apart from the per-shard rank leaves when
    `ranks_differ`; and the node-sharded run differs from 1x1."""
    def run(shape):
        return pool.run(shape[0] * shape[1], torch_ranks.stream_case, kind,
                        start_np, knobs, shape, "step", rounds)[0]

    runs = {s: run(s) for s in SHAPES}
    for tx_only, twin in (((1, 2), (1, 1)), ((2, 2), (2, 1))):
        want, got = _flat(runs[twin][0]), _flat(runs[tx_only][0])
        for name, leaf in want.items():
            if name.rsplit(".", 1)[-1] in RANK_LEAVES and ranks_differ:
                continue
            np.testing.assert_array_equal(leaf, got[name],
                                          err_msg=f"{tx_only} {name}")
        assert runs[twin][1].keys() == runs[tx_only][1].keys()
    assert not np.array_equal(_flat(runs[(1, 1)][0])[".sim.records.votes"],
                              _flat(runs[(2, 1)][0])[".sim.records.votes"])


def test_tx_only_meshes_walk_the_node_only_trajectory(pool):
    """The JAX drivers walk the same trajectory on 1x2 as on 1x1 and on
    2x2 as on 2x1, every leaf but the backlog's per-shard rank leaves;
    the port's drivers must too."""
    knobs = dict(byzantine_fraction=0.2, flip_probability=1.0)
    assert_tx_only(pool, "backlog", port_numpy("backlog",
                                               backlog_state(knobs)),
                   knobs, 8, ranks_differ=True)
    nknobs = dict(NODE_STREAM, byzantine_fraction=0.2)
    assert_tx_only(pool, "node_stream",
                   port_numpy("node_stream", node_stream_state(nknobs)),
                   nknobs, 5, ranks_differ=False)


def test_steps_record_their_declared_collectives(pool):
    """One step that reaches every collective of each driver records
    exactly its `DECLARED_COLLECTIVES`; the backlog's equals the
    reference's manifest, the node stream's adds the inner round's psum
    over txs (the poll cap), which the reference's omits."""
    from go_avalanche_tpu_torch.parallel import (sharded_backlog,
                                                 sharded_node_stream)
    from go_avalanche_tpu_torch.parallel.mesh import TXS_AXIS

    knobs = dict(byzantine_fraction=0.25, gossip=True,
                 adversary_strategy="oppose_majority", max_element_poll=3,
                 arrival_mode="poisson", arrival_rate=3.0)
    results = pool.run(4, torch_ranks.stream_case, "backlog",
                       port_numpy("backlog", backlog_state(knobs)), knobs,
                       (2, 2), "step", 2)
    for _, _, recorded, _ in results:
        assert recorded == sharded_backlog.DECLARED_COLLECTIVES
    assert sharded_backlog.DECLARED_COLLECTIVES == jsbl.DECLARED_COLLECTIVES
    nknobs = dict(NODE_STREAM, byzantine_fraction=0.25, gossip=True,
                  adversary_strategy="oppose_majority", max_element_poll=3)
    results = pool.run(4, torch_ranks.stream_case, "node_stream",
                       port_numpy("node_stream", node_stream_state(nknobs)),
                       nknobs, (2, 2), "step", 1)
    for _, _, recorded, _ in results:
        assert recorded == sharded_node_stream.DECLARED_COLLECTIVES
    assert (jsns.DECLARED_COLLECTIVES | {("all_reduce", (TXS_AXIS,))}
            == sharded_node_stream.DECLARED_COLLECTIVES)


def test_settle_driver_reads_once_a_round(pool):
    results, jfinal = check_stream(pool, "backlog", backlog_state({}), {},
                                   (2, 1), mode="run", rounds=2000)
    state, _, _, reads = results[0]
    # one read of the start round, one of the flag before the first step
    # and one after every step
    assert reads == int(state.sim.round) + 2


def test_megakernel_is_refused_with_the_reference_message():
    """Where the reference refuses the megakernel knob it is refused
    with the reference's message: the donated fleet scan
    (`sharded_fleet.fleet_scan_program`, the reference's
    `parallel/sharded_fleet.py:225-226`).  The streaming drivers do not
    refuse it (`test_streaming_drivers_ignore_the_round_engine`)."""
    from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
    from go_avalanche_tpu.parallel import sharded as jsh
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.parallel import sharded_fleet

    with pytest.raises(ValueError) as want:
        jsh._reject_round_engine(JaxConfig(round_engine="megakernel"))
    with pytest.raises(ValueError) as got:
        sharded_fleet.fleet_scan_program(
            None, AvalancheConfig(round_engine="megakernel"), 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["backlog", "streaming_dag",
                                  "node_stream"])
def test_streaming_drivers_ignore_the_round_engine(pool, kind):
    """The reference's streaming drivers never read `round_engine`: a
    megakernel config runs their phased local round.  The port's ranks
    give the JAX `shard_map` driver's leaves on 2x2, and the same leaves
    as the phased config."""
    from test_torch_sharded_streaming_dag import sdag_state

    extra = dict(NODE_STREAM) if kind == "node_stream" else {}
    mega = dict(extra, round_engine="megakernel", byzantine_fraction=0.2)
    phased = dict(extra, byzantine_fraction=0.2)
    build = {"backlog": backlog_state, "streaming_dag": sdag_state,
             "node_stream": node_stream_state}[kind]
    results, _ = check_stream(pool, kind, build(mega), mega, (2, 2),
                              rounds=4)
    twin = pool.run(4, torch_ranks.stream_case, kind,
                    port_numpy(kind, build(phased)), phased, (2, 2),
                    "step", 4)
    for (got, tel, _, _), (want, want_tel, _, _) in zip(results, twin):
        assert_tree(want, got, kind)
        assert _flat_tel(tel) == _flat_tel(want_tel)


def _flat_tel(tel, prefix=""):
    if isinstance(tel, dict):
        out = {}
        for name, value in tel.items():
            out.update(_flat_tel(value, f"{prefix}.{name}"))
        return out
    return {prefix: None if tel is None else np.asarray(tel).tobytes()}
