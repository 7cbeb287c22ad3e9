"""The port's async query ring (`ops/inflight.py`) against the JAX one.

Unit cases feed seeded numpy inputs through each function of both
packages; trajectory cases start both packages from one JAX `init`
(carried with `convert.py`, ring and fault parameters included) and run
the same rounds on each delivery engine: every state leaf and every
per-round telemetry scalar must be equal.  Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu.ops import inflight as jif
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu_torch import convert, prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import backlog as tbl
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.models import node_stream as tns
from go_avalanche_tpu_torch.models import snowball as tsb
from go_avalanche_tpu_torch.models import streaming_dag as tsd
from go_avalanche_tpu_torch.ops import inflight as tif
from go_avalanche_tpu_torch.ops import voterecord as tvr
from test_torch_avalanche import (_configs, _jax_numpy, assert_leaves_equal,
                                  assert_states_equal)
from test_torch_backlog import assert_trees_equal, jax_tree, torch_tree

ENGINES = ("walk", "walk_earlyout", "coalesced")
# One-second rounds and a 3 s request timeout: timeout_rounds() == 4.
TIMING = dict(time_step_s=1.0, request_timeout_s=3.0)


def configs(**knobs):
    return JaxConfig(**knobs), AvalancheConfig(**knobs)


def key_words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key),
                                       np.uint32).astype(np.int64))


def jkey(seed):
    return jax.random.key(seed)


def assert_ring_equal(want, got, where):
    assert_leaves_equal(None if want is None else _jax_numpy(want),
                        convert._np_tree(got), where)


# --------------------------------------------------------------- unit cases


@pytest.mark.parametrize("mode,rounds", [
    ("fixed", 2), ("fixed", 9), ("geometric", 2), ("geometric", 0),
    ("geometric", 5), ("weighted", 3), ("none", 0),
])
def test_draw_latency_matches_jax(mode, rounds):
    """Every mode bit for bit, geometric over 32768 draws (XLA:CPU's
    float32 log1p and the float32 divisor)."""
    knobs = dict(latency_mode=mode, latency_rounds=rounds, **TIMING)
    if mode == "none":
        knobs = dict(partition_spec=(0, 4, 0.5), **TIMING)
    jcfg, tcfg = configs(**knobs)
    rng = np.random.default_rng(rounds)
    n = 4096
    peers = rng.integers(0, n, (n, 8)).astype(np.int32)
    weight = rng.uniform(0.1, 4.0, n).astype(np.float32)
    want = jif.draw_latency(jkey(5), jcfg, jnp.asarray(peers),
                            jnp.asarray(weight), n)
    got = tif.draw_latency(key_words(jkey(5)), tcfg, torch.from_numpy(peers),
                           torch.from_numpy(weight), n)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if mode == "geometric" and rounds:
        assert len(np.unique(got.numpy())) > 3


@pytest.mark.parametrize("matrix", [((2, 2), (2, 2)),
                                    ((0, 3, 1), (3, 1, 5), (1, 5, 2))])
def test_draw_latency_rtt_matches_jax(matrix):
    c = len(matrix)
    jcfg, tcfg = configs(latency_mode="rtt", rtt_matrix=matrix, n_clusters=c,
                         **TIMING)
    rng = np.random.default_rng(c)
    n = 301
    peers = rng.integers(0, n, (n, 8)).astype(np.int32)
    for offset in (0, 17):
        want = jif.draw_latency(jkey(1), jcfg, jnp.asarray(peers),
                                jnp.ones(n, jnp.float32), n + 40, offset)
        got = tif.draw_latency(key_words(jkey(1)), tcfg,
                               torch.from_numpy(peers), torch.ones(n),
                               n + 40, offset)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def random_ring(jcfg, rows, t, rng, packed):
    d, k = jif.ring_depth(jcfg), jcfg.k
    polled = rng.random((d, rows, t)) < 0.6
    if packed:
        polled = np.asarray(jax.device_get(
            jif.pack_bool_plane(jnp.asarray(polled))))
    return jif.InflightState(
        peers=jnp.asarray(rng.integers(0, rows, (d, rows, k)), jnp.int32),
        lat=jnp.asarray(rng.integers(0, jcfg.timeout_rounds() + 1,
                                     (d, rows, k)), jnp.int32),
        responded=jnp.asarray(rng.random((d, rows, k)) < 0.8),
        lie=jnp.asarray(rng.random((d, rows, k)) < 0.2),
        polled=jnp.asarray(polled))


def torch_ring(jring):
    return convert._ring_from_numpy(_jax_numpy(jring))


@pytest.mark.parametrize("engine", ["walk", "coalesced"])
def test_init_ring_and_enqueue_match_jax(engine):
    jcfg, tcfg = configs(latency_mode="fixed", latency_rounds=1,
                         inflight_engine=engine, **TIMING)
    rng = np.random.default_rng(3)
    rows, t = 12, 21
    jring = jif.init_ring(jcfg, rows, t)
    tring = tif.init_ring(tcfg, rows, t, device="cpu")
    assert_ring_equal(jring, tring, "init")
    assert tring.polled.shape[-1] == (tif.packed_polled_width(t)
                                      if engine == "coalesced" else t)
    for r in range(7):
        peers = rng.integers(0, rows, (rows, 8)).astype(np.int32)
        lat = rng.integers(0, 5, (rows, 8)).astype(np.int32)
        resp, lie = rng.random((rows, 8)) < 0.7, rng.random((rows, 8)) < 0.3
        polled = rng.random((rows, t)) < 0.5
        jring = jif.enqueue(jring, jnp.int32(r), jnp.asarray(peers),
                            jnp.asarray(lat), jnp.asarray(resp),
                            jnp.asarray(lie), jnp.asarray(polled))
        tring = tif.enqueue(tring, torch.tensor(r, dtype=torch.int32),
                            *(torch.from_numpy(x) for x in
                              (peers, lat, resp, lie, polled)))
        assert_ring_equal(jring, tring, f"enqueue {r}")
    # Snowball's [D, rows] bool mask.
    assert_ring_equal(jif.init_ring(jcfg, rows),
                      tif.init_ring(tcfg, rows, device="cpu"), "1d")


def test_packed_polled_width_matches_jax():
    for t in (1, 7, 8, 9, 64, 1001):
        assert tif.packed_polled_width(t) == jif.packed_polled_width(t)
    assert tif.packed_polled_width(26, 2) == jif.packed_polled_width(26, 2)
    with pytest.raises(ValueError):
        tif.packed_polled_width(25, 2)


@pytest.mark.parametrize("skip", [False, True])
def test_ring_telemetry_matches_jax(skip):
    jcfg, tcfg = configs(latency_mode="geometric", latency_rounds=2,
                         skip_absent_votes=skip, **TIMING)
    rng = np.random.default_rng(int(skip))
    jring = random_ring(jcfg, 40, 16, rng, packed=False)
    tring = torch_ring(jring)
    for r in (0, 2, 4, 9):
        want = jif.ring_telemetry(jring, jcfg, jnp.int32(r))
        got = tif.ring_telemetry(tring, tcfg,
                                 torch.tensor(r, dtype=torch.int32))
        assert [int(x) for x in want] == [int(x) for x in got], r
    zero = tif.ring_telemetry(None, tcfg, torch.tensor(3, dtype=torch.int32))
    assert [int(x) for x in zero] == [0, 0, 0]


@pytest.mark.parametrize("packed", [False, True])
def test_clear_columns_and_rows_match_jax(packed):
    jcfg, _ = configs(latency_mode="fixed", latency_rounds=1, **TIMING)
    rng = np.random.default_rng(11)
    rows, t = 24, 19
    jring = random_ring(jcfg, rows, t, rng, packed)
    tring = torch_ring(jring)
    cols = rng.random(t) < 0.4
    assert_ring_equal(jif.clear_columns(jring, jnp.asarray(cols)),
                      tif.clear_columns(tring, torch.from_numpy(cols)),
                      "columns")
    swap = rng.random(rows) < 0.3
    peer_rows = rng.random(rows) < 0.3
    assert_ring_equal(jif.clear_rows(jring, jnp.asarray(swap)),
                      tif.clear_rows(tring, torch.from_numpy(swap)), "rows")
    assert_ring_equal(
        jif.clear_rows(jring, jnp.asarray(swap), jnp.asarray(peer_rows)),
        tif.clear_rows(tring, torch.from_numpy(swap),
                       torch.from_numpy(peer_rows)), "peer rows")
    assert tif.clear_columns(None, torch.from_numpy(cols)) is None
    assert tif.clear_rows(None, torch.from_numpy(swap)) is None


def test_clear_rows_single_decree_ring_matches_jax():
    jcfg, _ = configs(latency_mode="fixed", latency_rounds=1, **TIMING)
    rng = np.random.default_rng(12)
    jring = random_ring(jcfg, 30, 4, rng, False)
    jring = jring._replace(polled=jnp.asarray(
        rng.random(jring.polled.shape[:2]) < 0.5))
    swap = rng.random(30) < 0.3
    assert_ring_equal(jif.clear_rows(jring, jnp.asarray(swap)),
                      tif.clear_rows(torch_ring(jring),
                                     torch.from_numpy(swap)), "1d rows")


@pytest.mark.parametrize("k", range(1, 9))
def test_register_packed_votes_present_matches_jax(k):
    """Random records (confidence across the whole u16 range, finalized
    and saturated words included), random yes/consider/present planes
    and a random update mask."""
    cfg = dict(finalization_score=40, window=8, quorum=7)
    jcfg, tcfg = configs(**cfg)
    rng = np.random.default_rng(100 + k)
    shape = (33, 47)
    votes = rng.integers(0, 256, shape, dtype=np.uint8)
    consider = rng.integers(0, 256, shape, dtype=np.uint8)
    confidence = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    confidence[:3] = 0xFFFF - rng.integers(0, 4, (3, shape[1]))
    planes = [rng.integers(0, 1 << k, shape, dtype=np.uint8)
              for _ in range(3)]
    mask = rng.random(shape) < 0.8
    jstate = jvr.VoteRecordState(jnp.asarray(votes), jnp.asarray(consider),
                                 jnp.asarray(confidence))
    want, wch = jvr.register_packed_votes_present(
        jstate, *(jnp.asarray(p) for p in planes), k, jcfg,
        update_mask=jnp.asarray(mask))
    tstate = convert._records_from_numpy(dict(votes=votes, consider=consider,
                                              confidence=confidence))
    got, gch = tvr.register_packed_votes_present(
        tstate, *(torch.from_numpy(p) for p in planes), k, tcfg,
        update_mask=torch.from_numpy(mask))
    for leaf in ("votes", "consider"):
        np.testing.assert_array_equal(np.asarray(getattr(want, leaf)),
                                      getattr(got, leaf).numpy())
    np.testing.assert_array_equal(np.asarray(want.confidence),
                                  got.confidence.numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(wch), gch.numpy())
    # present all ones is the two-plane ingest with delivered neutrals
    ones = np.full(shape, (1 << k) - 1, np.uint8)
    a, ach = tvr.register_packed_votes_present(
        tstate, torch.from_numpy(planes[0]), torch.from_numpy(planes[1]),
        torch.from_numpy(ones), k, tcfg)
    b, bch = tvr.register_packed_votes(
        tstate, torch.from_numpy(planes[0]), torch.from_numpy(planes[1]), k,
        tcfg, absent_is_skip=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ach, bch)


# -------------------------------------------------------- trajectories


def avalanche_pair(knobs, n=32, t=40, seed=7, weights=None):
    jcfg, tcfg = _configs(knobs)
    jstate = jav.init(jkey(seed), n, t, jcfg,
                      init_pref=jav.contested_init_pref(seed, n, t),
                      latency_weights=weights)
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    return jstate, tstate, jcfg, tcfg


def check_run_scan(knobs, rounds=8, **kw):
    """Both packages' `run_scan` (the JAX one jitted) from one state:
    final state and stacked telemetry equal; returns the port's."""
    jstate, tstate, jcfg, tcfg = avalanche_pair(knobs, **kw)
    assert_ring_equal(jstate.inflight, tstate.inflight, "carried ring")
    want, wtel = jav.run_scan(jstate, jcfg, n_rounds=rounds)
    got, gtel = tav.run_scan(tstate, tcfg, n_rounds=rounds, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel),
                        "telemetry")
    assert_states_equal(want, got, f"after {rounds} rounds")
    return got, gtel


LATENCY_CASES = {
    "fixed0": dict(latency_mode="fixed", latency_rounds=0,
                   drop_probability=0.1),
    "fixed2": dict(latency_mode="fixed", latency_rounds=2),
    "geometric": dict(latency_mode="geometric", latency_rounds=2,
                      byzantine_fraction=0.2,
                      adversary_strategy="equivocate"),
    "weighted": dict(latency_mode="weighted", latency_rounds=3,
                     weighted_sampling=True),
    "rtt_uniform": dict(latency_mode="rtt", rtt_matrix=((1, 1), (1, 1)),
                        n_clusters=2),
    "rtt_skewed": dict(latency_mode="rtt", n_clusters=3,
                       rtt_matrix=((0, 2, 3), (2, 1, 5), (3, 5, 0))),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(LATENCY_CASES))
def test_avalanche_latency_trajectory_matches_jax(case, engine):
    knobs = dict(LATENCY_CASES[case], finalization_score=6,
                 inflight_engine=engine, **TIMING)
    weights = None
    if case == "weighted":
        weights = jnp.asarray(np.random.default_rng(0).uniform(
            0.2, 3.0, 32).astype(np.float32))
    _, tel = check_run_scan(knobs, weights=weights)
    if case == "fixed2":
        np.testing.assert_array_equal(tel.deliveries[:2].numpy(), 0)
        assert (tel.deliveries[2:] > 0).all()


def test_latency_zero_equals_the_synchronous_round():
    """Latency 0 on every engine gives the synchronous round's records
    and telemetry (apart from the ring counters)."""
    base = dict(finalization_score=6, drop_probability=0.1)
    sync_cfg = AvalancheConfig(**base)
    start = tav.init(prng.key(4, "cpu"), 24, 32, sync_cfg,
                     init_pref=tav.contested_init_pref(4, 24, 32, "cpu"),
                     device="cpu")
    want, wtel = tav.run_scan(start, sync_cfg, n_rounds=6, device="cpu")
    for engine in ENGINES:
        cfg = AvalancheConfig(latency_mode="fixed", latency_rounds=0,
                              inflight_engine=engine, time_step_s=1.0,
                              request_timeout_s=1.0, **base)
        s = start._replace(inflight=tif.init_ring(cfg, 24, 32, device="cpu"))
        got, gtel = tav.run_scan(s, cfg, n_rounds=6, device="cpu")
        for x, y in zip(want.records, got.records):
            assert torch.equal(x, y), engine
        assert torch.equal(want.finalized_at, got.finalized_at)
        for f in ("polls", "votes_applied", "flips", "finalizations",
                  "admissions", "gossip_writes"):
            assert torch.equal(getattr(wtel, f), getattr(gtel, f)), (engine,
                                                                      f)


@pytest.mark.parametrize("engine", ENGINES)
def test_skip_absent_votes_under_latency_matches_jax(engine):
    check_run_scan(dict(latency_mode="geometric", latency_rounds=1,
                        drop_probability=0.3, skip_absent_votes=True,
                        finalization_score=6, inflight_engine=engine,
                        **TIMING))


@pytest.mark.parametrize("engine", ENGINES)
def test_dead_querier_freeze_matches_jax(engine):
    """Churn kills queriers while their queries fly: their records stay
    frozen on delivery (`live_rows`)."""
    _, tel = check_run_scan(dict(latency_mode="fixed", latency_rounds=2,
                                 churn_probability=0.3, finalization_score=6,
                                 inflight_engine=engine, **TIMING),
                            rounds=10)
    assert int(tel.deliveries.sum()) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_multi_age_collision_matches_jax(engine):
    """Two ring entries in one draw slot deliver the same round (an
    entry sent one round earlier with latency one more): built on
    the JAX state, carried through `convert`, one round on each side."""
    knobs = dict(latency_mode="geometric", latency_rounds=2,
                 finalization_score=6, inflight_engine=engine, **TIMING)
    jstate, _, jcfg, tcfg = avalanche_pair(knobs, n=16, t=24, seed=3)
    jstate, _ = jav.run_scan(jstate, jcfg, n_rounds=3)
    ring = jstate.inflight
    d = ring.lat.shape[0]
    r = int(jstate.round)
    prev, prev2 = (r - 1) % d, (r - 2) % d
    lat = ring.lat.at[prev].set(1).at[prev2].set(2)
    jstate = jstate._replace(inflight=ring._replace(lat=lat))
    tstate = convert.state_from_numpy(_jax_numpy(jstate), device="cpu")
    want, wtel = jav.round_step(jstate, jcfg)
    got, gtel = tav.round_step(tstate, tcfg)
    assert_states_equal(want, got, "collision")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert int(gtel.deliveries) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_dag_async_trajectory_matches_jax(engine):
    jcfg, tcfg = configs(latency_mode="fixed", latency_rounds=1,
                         drop_probability=0.1, finalization_score=8,
                         inflight_engine=engine, **TIMING)
    conflict = jnp.arange(24, dtype=jnp.int32) // 2
    jstate = jdag.init(jkey(2), 20, conflict, jcfg)
    tstate = convert.dag_state_from_numpy(_jax_numpy(jstate), device="cpu")
    want, wtel = jdag.run_scan(jstate, jcfg, n_rounds=10)
    got, gtel = tdag.run_scan(tstate, tcfg, n_rounds=10, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_trees_equal(_jax_numpy(want), convert.dag_state_to_numpy(got),
                       "dag")


@pytest.mark.parametrize("engine", ENGINES)
def test_snowball_async_trajectory_matches_jax(engine):
    jcfg, tcfg = configs(latency_mode="geometric", latency_rounds=2,
                         byzantine_fraction=0.1, churn_probability=0.05,
                         finalization_score=10, inflight_engine=engine,
                         **TIMING)
    jstate = jsb.init(jkey(9), 64, jcfg)
    tstate = convert.family_state_from_numpy(
        "snowball", _jax_numpy(jstate), device="cpu")
    want, wtel = jsb.run_scan(jstate, jcfg, n_rounds=12)
    got, gtel = tsb.run_scan(tstate, tcfg, n_rounds=12, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_trees_equal(_jax_numpy(want), convert.family_state_to_numpy(got),
                       "snowball")
    assert int(gtel.deliveries.sum()) > 0


@pytest.mark.parametrize("engine", ["walk", "coalesced"])
def test_backlog_under_latency_matches_jax(engine):
    """The backlog scheduler's retire/refill clears the freed columns of
    the ring (bool and bit-packed layouts): 30 steps, then `run`."""
    jcfg, tcfg = configs(latency_mode="fixed", latency_rounds=1,
                         finalization_score=6, inflight_engine=engine,
                         **TIMING)
    queue = jbl.make_backlog(jnp.asarray(
        np.random.default_rng(5).integers(0, 9, 40), jnp.int32))
    jstate = jbl.init(jkey(1), 12, 9, queue, jcfg)
    tstate = convert.backlog_state_from_numpy(_jax_numpy(jstate),
                                              device="cpu")
    jstep = jax.jit(jbl.step, static_argnames=("cfg",))
    for r in range(30):
        jstate, jtel = jstep(jstate, jcfg)
        tstate, ttel = tbl.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel), f"tel {r}")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), "30 steps")
    want = jbl.run(jstate, jcfg)
    got = tbl.run(tstate, tcfg, device="cpu")
    assert_trees_equal(_jax_numpy(want), convert.backlog_state_to_numpy(got),
                       "run")


@pytest.mark.parametrize("engine", ["walk", "coalesced"])
def test_streaming_dag_under_latency_matches_jax(engine):
    jcfg, tcfg = configs(latency_mode="fixed", latency_rounds=1,
                         finalization_score=6, inflight_engine=engine,
                         **TIMING)
    scores = np.random.default_rng(2).integers(0, 7, (12, 2)).astype(
        np.int32)
    jstate = jsd.init(jkey(4), 12, 3, jsd.make_set_backlog(
        jnp.asarray(scores)), jcfg)
    tstate = convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                    device="cpu")
    want, wtel = jsd.run_scan(jstate, jcfg, n_rounds=40)
    got, gtel = tsd.run_scan(tstate, tcfg, n_rounds=40, device="cpu")
    assert_trees_equal(jax_tree(wtel), torch_tree(gtel), "tel")
    assert_trees_equal(_jax_numpy(want),
                       convert.streaming_dag_state_to_numpy(got), "state")
    assert int(got.next_idx) > 3


def test_node_stream_under_latency_matches_jax():
    """Churned-out rows leave the ring as queriers and as peers."""
    knobs = dict(stake_mode="zipf", registry_nodes=24, active_nodes=8,
                 node_churn_rate=0.5, latency_mode="fixed", latency_rounds=1,
                 finalization_score=6, **TIMING)
    jcfg, tcfg = configs(**knobs)
    jstate = jns.init(jkey(6), 4, jcfg)
    tstate = convert.node_stream_state_from_numpy(_jax_numpy(jstate),
                                                  device="cpu")
    want, wtel = jax.jit(jns.run_scan, static_argnames=("cfg", "n_rounds"))(
        jstate, jcfg, 12)
    got, gtel = tns.run_scan(tstate, tcfg, n_rounds=12, device="cpu")
    assert_trees_equal(_jax_numpy(want),
                       convert.node_stream_state_to_numpy(got), "state")
    assert_trees_equal(jax_tree(wtel).round, torch_tree(gtel).round, "tel")
    assert int(gtel.departed.sum()) > 0


def check_flagship_ring_counters(tel, n, k, faults):
    """The ring counters chip_smoke.py gates on at 16384²: under fixed
    latency 2 nothing delivers in rounds 0-1 and every draw from round 2
    on; a cut draw expires at age 6 (the timeout), so each round's
    blocked count comes back as expiries six rounds later, and a spiked
    latency of 4 stays below the timeout."""
    deliveries = tel.deliveries.tolist()
    expiries = tel.expiries.tolist()
    blocked = tel.partition_blocked.tolist()
    if not faults:
        assert deliveries[:2] == [0, 0]
        assert deliveries[2:] == [n * k] * (len(deliveries) - 2)
        assert expiries == [0] * len(expiries)
        return
    assert [r for r, b in enumerate(blocked) if b] == [5, 6, 7, 8, 9]
    for r in range(len(blocked) - 6):
        assert expiries[r + 6] == blocked[r], r
    assert sum(expiries) == sum(blocked)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("faults", [False, True])
def test_flagship_async_lane_matches_jax(faults, engine):
    """The reference bench's async lane (`flagship_async`, and
    `flagship_faults` with its script) at 32 x 64: both packages' ring
    counters hold the expected values, and the runs are leaf-equal."""
    from benchmarks import workload as jwl
    from go_avalanche_tpu.config import fault_script_from_json
    from go_avalanche_tpu_torch import workload as twl

    script = twl.FLAGSHIP_FAULTS if faults else None
    rounds = 18 if faults else 10
    n, t = 32, 64
    jstate, jcfg = jwl.flagship_state(n, t, latency=2,
                                      inflight_engine=engine)
    if faults:
        jcfg = dataclasses.replace(
            jcfg, fault_script=fault_script_from_json(script))
        jstate = jav.init(jax.random.key(0), n, t, jcfg)
    tstate, tcfg = twl.flagship_state(n, t, latency=2, inflight_engine=engine,
                                      faults=script, device="cpu")
    for field in tcfg.__dataclass_fields__:
        w, g = getattr(jcfg, field), getattr(tcfg, field)
        assert getattr(w, "value", w) == getattr(g, "value", g), field
    assert tcfg.timeout_rounds() == 6 and tif.ring_depth(tcfg) == 7
    assert_states_equal(jstate, tstate, "init")
    want, wtel = jav.run_scan(jstate, jcfg, n_rounds=rounds)
    got, gtel = tav.run_scan(tstate, tcfg, n_rounds=rounds, device="cpu")
    assert_leaves_equal(_jax_numpy(wtel), convert._np_tree(gtel), "tel")
    assert_states_equal(want, got, "flagship async")
    check_flagship_ring_counters(wtel, n, 8, faults)
    check_flagship_ring_counters(gtel, n, 8, faults)
