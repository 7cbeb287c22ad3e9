"""The port's node-axis streaming scheduler (`models/node_stream.py`)
against the JAX one: init (the Gumbel top-k working-set draw), churn and
whole `run_scan` trajectories leaf by leaf, on the cases
`tests/test_node_stream.py` pins.  Tolerance 0 on every integer and bool
leaf; the float telemetry `resident_stake` sums in float64 rounded once
where XLA:CPU sums in float32 in its own order, held here within 2 ulp
(ROADMAP.md Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu_torch import convert, prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import node_stream as tns
from go_avalanche_tpu_torch.ops import voterecord as vr
from test_torch_avalanche import _jax_numpy
from test_torch_backlog import assert_trees_equal, jax_tree, torch_tree

STAKE_ULPS = 2


def configs(**kw):
    base = dict(stake_mode="zipf", registry_nodes=24, active_nodes=8)
    base.update(kw)
    return JaxConfig(**base), AvalancheConfig(**base)


def check(want, got, where):
    assert_trees_equal(_jax_numpy(want),
                       convert.node_stream_state_to_numpy(got), where)


def check_telemetry(want, got, where):
    """Every telemetry leaf equal, `resident_stake` within STAKE_ULPS."""
    want, got = jax_tree(want), torch_tree(got)
    assert_trees_equal(want.round, got.round, f"{where}.round")
    np.testing.assert_array_equal(np.asarray(want.departed), got.departed)
    a = np.asarray(want.resident_stake, np.float32).view(np.int32)
    b = got.resident_stake.view(np.int32)
    assert np.abs(a.astype(np.int64) - b).max() <= STAKE_ULPS, where


INITS = {
    "zipf": dict(),
    "zipf_s2": dict(stake_zipf_s=2.0),
    "uniform": dict(stake_mode="uniform", registry_nodes=40,
                    active_nodes=16),
    "explicit": dict(stake_mode="explicit", registry_nodes=12,
                     active_nodes=5,
                     stake_weights=tuple(float(x) for x in
                                         np.random.default_rng(0).uniform(
                                             0.1, 3.0, 12))),
    "byzantine": dict(byzantine_fraction=0.25),
}


@pytest.mark.parametrize("case", sorted(INITS))
def test_init_matches_jax(case):
    jcfg, tcfg = configs(**INITS[case])
    want = jns.init(jax.random.key(1), 6, jcfg)
    got = tns.init(prng.key(1, "cpu"), 6, tcfg, device="cpu")
    check(want, got, case)
    slot = got.slot_node.numpy()
    assert len(set(slot.tolist())) == tcfg.active_nodes
    assert got.resident.numpy()[slot].all()
    np.testing.assert_array_equal(got.sim.latency_weight.numpy(),
                                  got.stake.numpy()[slot])


RUNS = {
    "churn_0.5_s2": dict(stake_zipf_s=2.0, node_churn_rate=0.5),
    "churn_all": dict(node_churn_rate=1.0, registry_nodes=32),
    "churn_byzantine_swar32": dict(node_churn_rate=0.3,
                                   byzantine_fraction=0.25,
                                   ingest_engine="swar32"),
    "no_churn": dict(),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_scan_matches_jax(case):
    jcfg, tcfg = configs(**RUNS[case])
    pref = jnp.asarray([True, False, True, True], jnp.bool_)
    jstate = jns.init(jax.random.key(6), 4, jcfg, init_pref=pref)
    tstate = convert.node_stream_state_from_numpy(_jax_numpy(jstate),
                                                  device="cpu")
    want, wtel = jax.jit(jns.run_scan, static_argnames=("cfg", "n_rounds"))(
        jstate, jcfg, 12)
    got, gtel = tns.run_scan(tstate, tcfg, n_rounds=12, device="cpu")
    check(want, got, case)
    check_telemetry(wtel, gtel, case)
    summary = tns.window_summary(got, tcfg)
    assert summary["resident_count"] == tcfg.active_nodes
    assert summary["churned_in"] == summary["churned_out"] == int(
        gtel.departed.sum())


def test_churn_step_by_step_matches_jax():
    """`churn_swaps` (the reference's `draw_churn_swaps`) and `churn`
    alone, on a dirtied window: swapped rows take the registry prior,
    survivors keep their records."""
    jcfg, tcfg = configs(node_churn_rate=0.5)
    jstate = jns.init(jax.random.key(2), 4, jcfg)
    dirty = jstate.sim.records._replace(
        confidence=jnp.full_like(jstate.sim.records.confidence, 77))
    jstate = jstate._replace(sim=jstate.sim._replace(records=dirty))
    tstate = convert.node_stream_state_from_numpy(_jax_numpy(jstate),
                                                  device="cpu")
    for r in range(6):
        jswaps = jns.draw_churn_swaps(jstate, jcfg)
        tswaps = tns.churn_swaps(tstate, tcfg)
        for w, g in zip(jswaps[:4], tswaps[:4]):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        jstate, jn = jns.churn(jstate, jcfg)
        tstate, tn = tns.churn(tstate, tcfg)
        assert int(jn) == int(tn)
        check(jstate, tstate, f"churn {r}")
        if r == 0:
            conf = vr.widen_confidence(tstate.sim.records.confidence)
            kept = (conf == 77).all(dim=1)
            assert kept.any() and not kept.all()


def test_churn_zero_passes_the_state_through():
    _, tcfg = configs()
    state = tns.init(prng.key(4, "cpu"), 4, tcfg, device="cpu")
    out, swapped = tns.churn(state, tcfg)
    assert out is state and int(swapped) == 0


def test_init_requires_registry_and_registry_skips_stake_fold():
    with pytest.raises(ValueError, match="registry_nodes"):
        tns.init(prng.key(0, "cpu"), 4, AvalancheConfig(), device="cpu")
    _, tcfg = configs()
    state = tns.init(prng.key(5, "cpu"), 4, tcfg, device="cpu")
    # The window's propensities are the residents' registry stakes, not
    # the positional stake of rows 0..W-1.
    assert not torch.equal(state.sim.latency_weight,
                           state.stake[:tcfg.active_nodes])


@pytest.mark.parametrize("kwargs", [
    dict(registry_nodes=8), dict(active_nodes=8),
    dict(registry_nodes=8, active_nodes=4),
    dict(stake_mode="zipf", registry_nodes=8, active_nodes=8),
    dict(stake_mode="zipf", node_churn_rate=0.1),
    dict(stake_mode="zipf", registry_nodes=8, active_nodes=4,
         node_churn_rate=1.5),
    dict(stake_mode="explicit", stake_weights=(1.0, 2.0),
         registry_nodes=3, active_nodes=1),
])
def test_registry_config_rejections_match_jax(kwargs):
    with pytest.raises(ValueError):
        JaxConfig(**kwargs)
    with pytest.raises(ValueError):
        AvalancheConfig(**kwargs)


def resident_stake_ulps(registry: int, active: int, rounds: int) -> int:
    """The largest distance, in ulp, between the JAX package's
    `resident_stake` telemetry and the port's over `rounds` churned steps
    at a `registry`-node registry (zipf stake) from one state."""
    jcfg, tcfg = configs(registry_nodes=registry, active_nodes=active,
                         node_churn_rate=1e-3)
    jstate = jns.init(jax.random.key(0), 4, jcfg)
    tstate = convert.node_stream_state_from_numpy(_jax_numpy(jstate),
                                                  device="cpu")
    _, wtel = jax.jit(jns.run_scan, static_argnames=("cfg", "n_rounds"))(
        jstate, jcfg, rounds)
    _, gtel = tns.run_scan(tstate, tcfg, n_rounds=rounds, device="cpu")
    a = np.asarray(wtel.resident_stake, np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64)
                      - gtel.resident_stake.numpy().view(np.int32)).max())


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_node_stream.py
    # Up to the chip run's 1M-node registry (~35 s on the CPU; not part of
    # the test run).
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({f"R={r}": resident_stake_ulps(r, w, 5) for r, w in
                      ((24, 8), (4096, 64), (1_000_000, 1024))}))
