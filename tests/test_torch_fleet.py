"""The port's Monte-Carlo fleet (`go_avalanche_tpu_torch/fleet.py`) and
engine tag (`obs/tags.py`) against the JAX package's.

The port runs its trials one after another on the CPU; the reference
vmaps them.  Per-trial keys are the same, so every per-trial vector,
the stacked telemetry, the summary row and the phase-grid rows (tags
included) must be equal.  The detectors run on planted states; the
grid validation and every refusal are held message for message.
Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu import fleet as jfleet
from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.obs import tag_from_config
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch import fleet as tfleet
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.obs.tags import config_tag
from test_torch_avalanche import _configs, _jax_numpy
from test_torch_inflight import TIMING

VECTORS = ("violations", "settled", "finality_round", "finalized_fraction",
           "stalled", "cut_windows", "cut_split", "spike_windows",
           "region_windows", "lat_percentiles", "arrived")


def assert_tree_equal(want, got, where):
    if want is None or got is None:
        assert want is None and got is None, where
        return
    if isinstance(want, tuple):
        for i, (w, g) in enumerate(zip(want, got)):
            name = want._fields[i] if hasattr(want, "_fields") else i
            assert_tree_equal(w, g, f"{where}.{name}")
        return
    w, g = np.asarray(want), np.asarray(got)
    assert w.dtype == g.dtype, (where, w.dtype, g.dtype)
    np.testing.assert_array_equal(w, g, err_msg=where)


def check_fleet(model, knobs, **kw):
    """Both packages' `run_fleet` on one config point: every per-trial
    vector, the telemetry and the summary row equal."""
    jcfg, tcfg = _configs(knobs)
    want = jfleet.run_fleet(model, jcfg, **kw)
    got = tfleet.run_fleet(model, tcfg, device="cpu", **kw)
    for name in VECTORS:
        assert_tree_equal(getattr(want, name), getattr(got, name), name)
    want_tel = jax.tree.map(np.asarray, want.telemetry)
    assert_tree_equal(want_tel, got.telemetry, "telemetry")
    assert got.summary() == want.summary()
    assert got.realizations() == want.realizations()
    assert got.trace is None
    return got


# ------------------------------------------------------------ statistics


@pytest.mark.parametrize("successes,trials", [
    (0, 1), (1, 1), (0, 512), (1, 512), (512, 512), (256, 512), (3, 7),
    (47, 48)])
def test_wilson_interval_matches_jax(successes, trials):
    assert (tfleet.wilson_interval(successes, trials)
            == jfleet.wilson_interval(successes, trials))


def test_wilson_interval_pins_and_refusals():
    lo, hi = tfleet.wilson_interval(0, 512)
    assert lo == 0.0 and 0.0 < hi < 0.01
    assert tfleet.wilson_interval(1, 512)[0] > 0.0
    for bad in ((1, 0), (5, 4), (-1, 3)):
        with pytest.raises(ValueError) as terr:
            tfleet.wilson_interval(*bad)
        with pytest.raises(ValueError) as jerr:
            jfleet.wilson_interval(*bad)
        assert str(terr.value) == str(jerr.value)


GRIDS = [
    {"byzantine_fraction": [0.0, 0.2], "k": [8, 16, 32]},
    {"adversary_strategy": ["oppose_majority", "flip"]},
    {"adversary_policy": ["off", "split_vote", "timing"]},
    {"k": [8.0], "alpha": [0.6, 0.9]},
    {"stake_zipf_s": [0.5, 1.0, 2.0], "arrival_rate": [1, 2.5]},
    {"bogus_axis": [1]}, {"k": []}, {"k": ["x"]}, {"k": [True]},
    {"k": [8.5]}, {}, [1, 2], {"adversary_strategy": [3]},
    {"adversary_policy": ["nope"]}, {"adversary_policy": [1]},
    {"adversary_strategy": ["sideways"]}, {"latency_rounds": "3"},
]


@pytest.mark.parametrize("grid", GRIDS, ids=[str(i) for i in range(len(GRIDS))])
def test_phase_points_match_jax(grid):
    def outcome(mod):
        try:
            return mod.phase_points(grid)
        except ValueError as err:
            return str(err)

    assert outcome(tfleet) == outcome(jfleet)


ADVERSARY_GRIDS = [
    ({"byzantine_fraction": [0.0, 0.2]}, dict(policy_base="split_vote")),
    ({"adversary_policy": ["split_vote"]}, dict(byz_base=0.0)),
    ({"flip_probability": [0.5]}, dict(byz_base=0.0)),
    ({"adversary_strategy": ["equivocate"], "byzantine_fraction": [0.0]}, {}),
    ({"adversary_policy": ["timing"]}, {}),
    ({"adversary_policy": ["timing"]}, dict(async_base=True)),
    ({"adversary_policy": ["split_vote", "stake_eclipse"]}, {}),
    ({"adversary_policy": ["stake_eclipse"]}, dict(stake_base="zipf")),
    ({"adversary_policy": ["withhold_near_quorum", "split_vote"]},
     dict(policy_base="withhold_near_quorum", margin_base=3)),
    ({"adversary_policy": ["withhold_near_quorum"]},
     dict(policy_base="withhold_near_quorum", margin_base=3)),
    ({"adversary_policy": ["split_vote"],
      "adversary_strategy": ["equivocate"]}, {}),
    ({"byzantine_fraction": [0.1, 0.4]}, {}),
]


@pytest.mark.parametrize("grid,base", ADVERSARY_GRIDS,
                         ids=[str(i) for i in range(len(ADVERSARY_GRIDS))])
def test_check_adversary_grid_matches_jax(grid, base):
    kw = dict(byz_base=0.2, strategy_base="flip", flip_base=1.0,
              policy_base="off", async_base=False)
    kw.update(base)

    def outcome(mod):
        try:
            mod.check_adversary_grid(grid, **kw)
        except ValueError as err:
            return str(err)
        return None

    assert outcome(tfleet) == outcome(jfleet)


@pytest.mark.parametrize("point", [
    {"byzantine_fraction": 0.25, "adversary_strategy": "oppose_majority"},
    {"adversary_policy": "split_vote", "byzantine_fraction": 0.3},
    {"k": 4, "quorum": 3, "window": 4},
    {"byzantine_fraction": 0.0, "adversary_policy": "split_vote"},
    {"adversary_policy": "stake_eclipse", "byzantine_fraction": 0.2},
])
def test_point_config_matches_jax(point):
    def outcome(mod, cfg):
        try:
            return mod.point_config(cfg, point)
        except ValueError as err:
            return str(err)

    jcfg, tcfg = _configs(dict(finalization_score=16))
    want, got = outcome(jfleet, jcfg), outcome(tfleet, tcfg)
    if isinstance(want, str):
        assert got == want
        return
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if isinstance(w, JaxStrategy):
            w, g = w.value, g.value
        if field.name == "vote_mode":
            w, g = w.value, g.value
        assert w == g, field.name
    if "adversary_strategy" in point:
        assert got.adversary_strategy is AdversaryStrategy(
            point["adversary_strategy"])


# ------------------------------------------------------------ detectors


def jitted(outcome):
    """A JAX outcome reduction compiled, as the reference's fleet program
    runs it: XLA turns its division by a static width into a product
    with the width's float32 reciprocal, which the port reproduces."""
    return jax.jit(outcome, static_argnames="cfg")


def _confidence(fin_score, finalized, accepted):
    counter = np.where(finalized, fin_score, 0)
    return ((counter << 1) | accepted.astype(np.uint16)).astype(np.uint16)


def planted(jstate, fin, acc, byz, alive=None):
    """The JAX state with planted confidence, byzantine and alive
    planes, and the port's copy of it."""
    fin, acc, byz = (np.asarray(x) for x in (fin, acc, byz))
    base = getattr(jstate, "base", jstate)
    new = base._replace(
        records=base.records._replace(
            confidence=jnp.asarray(_confidence(16, fin, acc))),
        byzantine=jnp.asarray(byz),
        alive=jnp.asarray(np.ones(byz.shape, bool) if alive is None
                          else np.asarray(alive)),
        finalized_at=jnp.asarray(np.where(fin, 3, -1).astype(np.int32)))
    if hasattr(jstate, "base"):
        return jdag.DagSimState(new, jstate.conflict_set, jstate.n_sets,
                                jstate.set_size)
    return new


SNOWBALL_PLANTS = [   # finalized, accepted, byzantine, alive
    ([1, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0], None),
    ([1, 1, 0, 0], [1, 0, 0, 0], [0, 1, 0, 0], None),
    ([1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 0], None),
    ([1, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0], None),
    ([1, 1, 0, 0], [1, 1, 0, 0], [1, 1, 0, 0], None),
    ([0, 0, 0, 0], [0, 0, 0, 0], [1, 1, 1, 0], None),
    ([0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [1, 0, 0, 1]),
    ([1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0], None),
]


@pytest.mark.parametrize("plant", SNOWBALL_PLANTS,
                         ids=[str(i) for i in range(len(SNOWBALL_PLANTS))])
def test_snowball_detectors_and_outcome_match_jax(plant):
    jcfg, tcfg = _configs(dict(finalization_score=16))
    fin, acc, byz, alive = (None if x is None else np.asarray(x, bool)
                            for x in plant)
    jstate = planted(jsb.init(jax.random.key(0), 4, jcfg), fin, acc, byz,
                     alive)
    tstate = convert.family_state_from_numpy("snowball", _jax_numpy(jstate),
                                             device="cpu")
    assert (bool(tfleet.snowball_safety_violated(tstate, tcfg))
            == bool(jfleet.snowball_safety_violated(jstate, jcfg)))
    assert_tree_equal(_jax_numpy(jitted(jfleet._outcome_snowball)(jstate, jcfg)),
                      convert._np_tree(tfleet._outcome_snowball(tstate,
                                                                tcfg)),
                      "outcome")


def test_avalanche_detectors_and_outcome_match_jax():
    jcfg, tcfg = _configs(dict(finalization_score=16))
    jstate = jav.init(jax.random.key(0), 3, 4, jcfg)
    rng = np.random.default_rng(0)
    cases = [(np.eye(3, 4, 1, dtype=bool) | np.eye(3, 4, -1, dtype=bool),
              np.eye(3, 4, 1, dtype=bool), [False] * 3)]
    fin = np.zeros((3, 4), bool)
    fin[0, 1] = fin[2, 1] = True
    acc = np.zeros((3, 4), bool)
    acc[0, 1] = True
    cases += [(fin, acc, [False] * 3), (fin, acc, [False, False, True]),
              (np.ones((3, 4), bool), np.ones((3, 4), bool), [True, False,
                                                              False])]
    cases += [(rng.random((3, 4)) < 0.6, rng.random((3, 4)) < 0.5,
               rng.random(3) < 0.3) for _ in range(6)]
    for i, (fin, acc, byz) in enumerate(cases):
        js = planted(jstate, fin, acc, byz)
        ts = convert.state_from_numpy(_jax_numpy(js), device="cpu")
        assert (bool(tfleet.avalanche_safety_violated(ts, tcfg))
                == bool(jfleet.avalanche_safety_violated(js, jcfg))), i
        assert_tree_equal(_jax_numpy(jitted(jfleet._outcome_avalanche)(js, jcfg)),
                          convert._np_tree(tfleet._outcome_avalanche(ts,
                                                                     tcfg)),
                          f"outcome {i}")
    assert bool(tfleet.avalanche_safety_violated(
        convert.state_from_numpy(_jax_numpy(planted(
            jstate, fin=cases[1][0], acc=cases[1][1], byz=[False] * 3)),
            device="cpu"), tcfg))


@pytest.mark.parametrize("set_size", [2, None])
def test_dag_detectors_and_outcome_match_jax(set_size):
    jcfg, tcfg = _configs(dict(finalization_score=16))
    conflict = jnp.arange(6, dtype=jnp.int32) // 2
    jstate = jdag.init(jax.random.key(0), 3, conflict, jcfg)
    jstate = jdag.DagSimState(jstate.base, jstate.conflict_set,
                              jstate.n_sets, set_size)
    rng = np.random.default_rng(1)
    fin = np.zeros((3, 6), bool)
    fin[0, 0] = fin[2, 1] = True
    cases = [(fin, fin, [False] * 3), (fin, fin, [True, False, False]),
             (fin, np.eye(3, 6, dtype=bool), [False] * 3),
             (np.ones((3, 6), bool), np.tile([1, 0], (3, 3)).astype(bool),
              [False] * 3)]
    cases += [(rng.random((3, 6)) < 0.6, rng.random((3, 6)) < 0.5,
               rng.random(3) < 0.3) for _ in range(6)]
    for i, (fin, acc, byz) in enumerate(cases):
        js = planted(jstate, fin, acc, byz)
        ts = convert.dag_state_from_numpy(_jax_numpy(js), device="cpu")
        assert ts.set_size == set_size
        assert (bool(tfleet.dag_safety_violated(ts, tcfg))
                == bool(jfleet.dag_safety_violated(js, jcfg))), i
        assert_tree_equal(_jax_numpy(jitted(jfleet._outcome_dag)(js, jcfg)),
                          convert._np_tree(tfleet._outcome_dag(ts, tcfg)),
                          f"outcome {i}")
    assert bool(tfleet.dag_safety_violated(
        convert.dag_state_from_numpy(_jax_numpy(planted(
            jstate, fin, fin, [False] * 3)), device="cpu"), tcfg))


@pytest.mark.parametrize("shape", [(3,), (3, 4), (8,), (8, 5)])
def test_liveness_stalled_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    n = shape[0]
    planes = [np.zeros(shape, bool), np.ones(shape, bool)]
    planes += [rng.random(shape) < p for p in (0.05, 0.2, 0.5)]
    for fin in planes:
        for byz in (np.zeros(n, bool), np.arange(n) < 1,
                    np.arange(n) < (n + 1) // 2, rng.random(n) < 0.4):
            for alive in (np.ones(n, bool), rng.random(n) < 0.6):
                want = jfleet.liveness_stalled(jnp.asarray(fin),
                                               jnp.asarray(byz),
                                               jnp.asarray(alive))
                got = tfleet.liveness_stalled(torch.from_numpy(fin),
                                              torch.from_numpy(byz),
                                              torch.from_numpy(alive))
                assert bool(got) == bool(want)
    # byzantine finalization alone is not progress
    byz = np.arange(n) < 1
    fin = np.zeros(shape, bool)
    fin[0] = True
    assert bool(tfleet.liveness_stalled(torch.from_numpy(fin),
                                        torch.from_numpy(byz),
                                        torch.ones(n, dtype=torch.bool)))


# ------------------------------------------------------------ fleets


@pytest.mark.parametrize("model,knobs,kw", [
    ("snowball", dict(finalization_score=12, byzantine_fraction=0.3,
                      adversary_policy="split_vote"),
     dict(n_nodes=24, n_rounds=14, yes_fraction=0.5)),
    ("snowball", dict(finalization_score=8, byzantine_fraction=0.2,
                      adversary_strategy="oppose_majority"),
     dict(n_nodes=16, n_rounds=16, yes_fraction=0.7, seed=3)),
    ("avalanche", dict(finalization_score=8, byzantine_fraction=0.2,
                       adversary_policy="withhold_near_quorum",
                       adversary_margin=2),
     dict(n_nodes=16, n_txs=12, n_rounds=12)),
    ("avalanche", dict(finalization_score=6),
     dict(n_nodes=12, n_txs=8, n_rounds=10, contested=False, seed=5)),
    ("dag", dict(finalization_score=8, byzantine_fraction=0.25,
                 adversary_policy="split_vote"),
     dict(n_nodes=16, n_txs=12, n_rounds=10, conflict_size=3)),
    ("backlog", dict(finalization_score=6),
     dict(n_nodes=12, n_txs=20, n_rounds=16, window=8)),
], ids=["snowball_split", "snowball_oppose", "avalanche_withhold",
        "avalanche_unanimous", "dag_split", "backlog"])
def test_run_fleet_matches_jax(model, knobs, kw):
    got = check_fleet(model, knobs, fleet=3, **kw)
    assert got.violations.shape == (3,)
    assert got.finalized_fraction.dtype == np.float32


def test_run_fleet_realizations_match_jax():
    """A stochastic partition realized per trial from each trial's key,
    under latency and the timing policy."""
    knobs = dict(finalization_score=10, byzantine_fraction=0.2,
                 adversary_policy="timing", latency_mode="fixed",
                 latency_rounds=1, inflight_engine="coalesced",
                 fault_script=(("stochastic_partition", (2, 4), (2, 5),
                                (0.3, 0.6)),), **TIMING)
    got = check_fleet("avalanche", knobs, fleet=3, n_nodes=12, n_txs=8,
                      n_rounds=10)
    assert got.cut_windows.shape == (3, 1, 2)
    assert "cut" in got.realizations()


def test_run_fleet_backlog_traffic_matches_jax():
    """The backlog fleet with poisson arrivals: per-trial finality-latency
    percentiles and arrivals."""
    got = check_fleet("backlog", dict(finalization_score=6,
                                      arrival_mode="poisson",
                                      arrival_rate=2.0),
                      fleet=3, n_nodes=12, n_txs=24, n_rounds=16, window=8)
    assert got.lat_percentiles.shape == (3, 3)
    assert "lat_p99_max" in got.summary()


def test_run_phase_grid_policy_axis_matches_jax():
    """A phase grid over the adversary-policy axis: rows, tags included,
    equal; rows reach the sink as they land."""
    base = dict(finalization_score=12, byzantine_fraction=0.3)
    jcfg, tcfg = _configs(base)
    grid = {"adversary_policy": ["off", "split_vote",
                                 "withhold_near_quorum"]}
    kw = dict(fleet=2, n_nodes=16, n_txs=8, n_rounds=10)
    want = jfleet.run_phase_grid("avalanche", jcfg, grid, **kw)

    class Sink:
        rows = []

        def write(self, row):
            self.rows.append(row)

    sink = Sink()
    got = tfleet.run_phase_grid("avalanche", tcfg, grid, sink=sink,
                                device="cpu", **kw)
    assert got == want
    assert sink.rows == got
    assert [r["tag"] for r in got] == ["", ", split_vote-adversary",
                                       ", withhold_near_quorum-adversary"]


def test_run_phase_grid_byzantine_axis_snowball_matches_jax():
    jcfg, tcfg = _configs(dict(finalization_score=10, byzantine_fraction=0.1,
                               adversary_policy="split_vote"))
    grid = {"byzantine_fraction": [0.1, 0.4], "k": [4, 8]}
    kw = dict(fleet=2, n_nodes=16, n_rounds=12)
    assert (tfleet.run_phase_grid("snowball", tcfg, grid, device="cpu", **kw)
            == jfleet.run_phase_grid("snowball", jcfg, grid, **kw))


# ------------------------------------------------------------ refusals


REFUSALS = [
    ("snowball", dict(), dict(fleet=0, n_nodes=8)),
    ("slush", dict(), dict(fleet=2, n_nodes=8)),
    ("dag", dict(), dict(fleet=2, n_nodes=8, n_txs=9)),
    ("avalanche", dict(arrival_mode="poisson", arrival_rate=1.0),
     dict(fleet=2, n_nodes=8)),
    ("backlog", dict(arrival_mode="external"), dict(fleet=2, n_nodes=8)),
    ("snowball", dict(stake_mode="uniform"), dict(fleet=2, n_nodes=8)),
    ("avalanche", dict(stake_mode="zipf", registry_nodes=64,
                       active_nodes=16), dict(fleet=2, n_nodes=8)),
]


@pytest.mark.parametrize("model,knobs,kw", REFUSALS,
                         ids=[str(i) for i in range(len(REFUSALS))])
def test_run_fleet_refusals_match_jax(model, knobs, kw):
    jcfg, tcfg = _configs(knobs)
    with pytest.raises(ValueError) as jerr:
        jfleet.run_fleet(model, jcfg, **kw)
    with pytest.raises(ValueError) as terr:
        tfleet.run_fleet(model, tcfg, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


GRID_REFUSALS = [
    ("snowball", dict(), {"latency_rounds": [1, 3]}),
    ("snowball", dict(), {"arrival_rate": [1.0, 2.0]}),
    ("snowball", dict(arrival_mode="poisson", arrival_rate=1.0),
     {"arrival_rate": [1.0, 2.0]}),
    ("avalanche", dict(), {"stake_zipf_s": [1.0, 2.0]}),
    ("snowball", dict(byzantine_fraction=0.2, adversary_policy="split_vote"),
     {"byzantine_fraction": [0.0, 0.2]}),
    ("snowball", dict(), {"adversary_policy": ["split_vote"]}),
    ("snowball", dict(byzantine_fraction=0.2), {"adversary_policy":
                                                ["timing"]}),
    ("avalanche", dict(byzantine_fraction=0.2),
     {"adversary_policy": ["split_vote", "stake_eclipse"]}),
    ("snowball", dict(byzantine_fraction=0.2,
                      adversary_policy="withhold_near_quorum",
                      adversary_margin=3),
     {"adversary_policy": ["withhold_near_quorum", "split_vote"]}),
    ("snowball", dict(byzantine_fraction=0.2),
     {"adversary_policy": ["split_vote"],
      "adversary_strategy": ["equivocate"]}),
    ("snowball", dict(), {"k": [8.5]}),
]


@pytest.mark.parametrize("model,knobs,grid", GRID_REFUSALS,
                         ids=[str(i) for i in range(len(GRID_REFUSALS))])
def test_run_phase_grid_refusals_match_jax(model, knobs, grid):
    jcfg, tcfg = _configs(knobs)
    kw = dict(fleet=2, n_nodes=8, n_txs=4, n_rounds=4)
    with pytest.raises(ValueError) as jerr:
        jfleet.run_phase_grid(model, jcfg, grid, **kw)
    with pytest.raises(ValueError) as terr:
        tfleet.run_phase_grid(model, tcfg, grid, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_unported_fleet_surfaces_name_their_item():
    # The trial-sharded mesh (item 15) is ported: a one-rank fleet mesh
    # runs the dense loop (tests/test_torch_sharded_fleet.py holds the
    # multi-rank meshes).
    from go_avalanche_tpu_torch.parallel.sharded_fleet import make_fleet_mesh

    cfg = AvalancheConfig(finalization_score=8)
    one = tfleet.run_fleet("snowball", cfg, fleet=2, n_nodes=8,
                           mesh=make_fleet_mesh(1), device="cpu")
    dense = tfleet.run_fleet("snowball", cfg, fleet=2, n_nodes=8,
                             device="cpu")
    assert one.summary() == dense.summary()
    np.testing.assert_array_equal(one.finality_round, dense.finality_round)
    # The per-trial trace plane (item 14) is ported: both decoders give
    # the fleet-stacked records the JAX package gives.
    knobs = dict(finalization_score=8, trace_every=1)
    jcfg, tcfg = _configs(knobs)
    kw = dict(fleet=2, n_nodes=8, n_rounds=2)
    want = jfleet.run_fleet("snowball", jcfg, **kw)
    res = tfleet.run_fleet("snowball", tcfg, device="cpu", **kw)
    assert res.trace_records() == want.trace_records()
    assert (tfleet.fleet_trace_records(res.telemetry, 2)
            == jfleet.fleet_trace_records(want.telemetry, 2))
    off = tfleet.run_fleet("snowball", cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="without the trace plane"):
        off.trace_records()


# ------------------------------------------------------------ tags


TAG_CASES = [
    dict(),
    dict(fused_exchange=False, ingest_engine="swar32"),
    dict(round_engine="megakernel"),
    dict(latency_mode="fixed", latency_rounds=2, time_step_s=1.0,
         request_timeout_s=5.0, inflight_engine="coalesced"),
    dict(latency_mode="geometric", latency_rounds=1, **TIMING),
    dict(partition_spec=(1, 4, 0.5), **TIMING),
    dict(byzantine_fraction=0.2, adversary_policy="split_vote"),
    dict(byzantine_fraction=0.2, adversary_policy="stake_eclipse",
         stake_mode="zipf", stake_zipf_s=1.5, n_clusters=3),
    dict(stake_mode="uniform", registry_nodes=64, active_nodes=16),
    dict(arrival_mode="bursty", arrival_rate=2.5, arrival_period=8,
         arrival_burst_factor=3.0, arrival_backpressure=(0.5, 0.9)),
    dict(arrival_mode="poisson", arrival_rate=1.0, n_clusters=2,
         arrival_cluster_weights=(1.0, 2.0)),
]


@pytest.mark.parametrize("knobs", TAG_CASES,
                         ids=[str(i) for i in range(len(TAG_CASES))])
def test_config_tag_matches_tag_from_config(knobs):
    jcfg, tcfg = JaxConfig(**knobs), AvalancheConfig(**knobs)
    assert config_tag(tcfg) == tag_from_config(jcfg)


def test_default_timeout_rounds_has_one_copy():
    from go_avalanche_tpu.obs.tags import default_timeout_rounds as jdef
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.obs import tags

    assert workload.default_timeout_rounds is tags.default_timeout_rounds
    assert [tags.default_timeout_rounds(x) for x in range(5)] == [
        jdef(x) for x in range(5)]


def test_atlas_fleet_record_reproduces():
    """The JAX package reproduces the committed row of the atlas's most
    hostile point (`workload.FLEET_RECORDS`), and the port's first four
    trials there equal the JAX fleet's (`chip_smoke.py` runs all 16, and
    the policy grid at 4096 x 1024, on the card)."""
    from go_avalanche_tpu_torch import workload

    case = workload.FLEET_CASES["atlas_hostile"]
    jcfg, tcfg = _configs(case["knobs"])
    res = jfleet.run_fleet(case["model"], jcfg, **case["kw"])
    row = {**res.summary(), "tag": tag_from_config(jcfg)}
    assert [row] == workload.FLEET_RECORDS["atlas_hostile"]
    assert config_tag(tcfg) == row["tag"]
    check_fleet(case["model"], case["knobs"], **dict(case["kw"], fleet=4))


def test_fleet_records_name_their_cases():
    from go_avalanche_tpu_torch import workload

    assert set(workload.FLEET_RECORDS) == set(workload.FLEET_CASES)
    grid = workload.FLEET_CASES["policy_grid"]
    rows = workload.FLEET_RECORDS["policy_grid"]
    assert [r["point"] for r in rows] == tfleet.phase_points(grid["grid"])
    assert [r["point"] for r in rows] == jfleet.phase_points(grid["grid"])
    for r in rows:
        assert r["tag"] == config_tag(tfleet.point_config(
            AvalancheConfig(**grid["knobs"]), r["point"]))
        assert r["fleet"] == grid["kw"]["fleet"]


def test_atlas_fleet_trace_record_reproduces():
    """The adversary atlas's traced spot-check point
    (`workload.FLEET_TRACE_RECORDS`): the JAX package's fleet-stacked
    trace JSONL reproduces the committed digest, the port's 8 trials
    give the same bytes, and every trial's stall verdict agrees with its
    trace finality curve (`examples/adversary_atlas.spot_check`)."""
    from go_avalanche_tpu_torch import workload

    case = workload.FLEET_CASES["atlas_hostile"]
    rec = workload.FLEET_TRACE_RECORDS["atlas_hostile"]
    jcfg, tcfg = _configs(dict(case["knobs"], trace_every=1))
    kw = dict(case["kw"], fleet=rec["fleet"])
    want = jfleet.run_fleet(case["model"], jcfg, **kw)
    got = tfleet.run_fleet(case["model"], tcfg, device="cpu", **kw)
    assert workload.trace_jsonl_digest(want.trace_records()) == rec["sha256"]
    records = got.trace_records()
    assert len(records) == rec["rows"]
    assert workload.trace_jsonl_digest(records) == rec["sha256"]
    n_byz = int(round(tcfg.byzantine_fraction * kw["n_nodes"]))
    for i in range(rec["fleet"]):
        total = sum(r["finalizations"][i] for r in records)
        if got.stalled[i]:
            assert total <= n_byz
        elif got.finalized_fraction[i] > 0:
            assert total > 0
