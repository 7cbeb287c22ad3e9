"""The port's conflict-DAG model (`models/dag.py`) against the JAX one.

Set preference, set reductions and `init`'s partition handling are held
against the JAX functions on seeded numpy inputs; whole trajectories
start from ONE state (the JAX `init`, carried over with
`convert.dag_state_from_numpy`) and every state leaf and per-round
telemetry scalar must be equal.  Tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu_torch import convert, prng
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.ops import voterecord as vr


def _configs(knobs):
    jkw, tkw = dict(knobs), dict(knobs)
    if "adversary_strategy" in knobs:
        jkw["adversary_strategy"] = JaxStrategy(knobs["adversary_strategy"])
        tkw["adversary_strategy"] = AdversaryStrategy(
            knobs["adversary_strategy"])
    return JaxConfig(**jkw), AvalancheConfig(**tkw)


def _np(x):
    if x is None:
        return None
    if jax.dtypes.issubdtype(getattr(x, "dtype", None), jax.dtypes.prng_key):
        x = jax.random.key_data(x)
    return np.asarray(x)


def _jax_numpy(state):
    return jax.tree.map(_np, state, is_leaf=lambda x: x is None)


def assert_dag_states_equal(jstate, tstate, where):
    want = _jax_numpy(jstate)
    got = convert.dag_state_to_numpy(tstate)
    assert (want.n_sets, want.set_size) == (got.n_sets, got.set_size), where
    np.testing.assert_array_equal(want.conflict_set, got.conflict_set)
    for field in got.base._fields:
        w, g = getattr(want.base, field), getattr(got.base, field)
        if field == "records":
            for leaf in w._fields:
                wl, gl = getattr(w, leaf), getattr(g, leaf)
                assert wl.dtype == gl.dtype, (where, leaf)
                np.testing.assert_array_equal(wl, gl,
                                              err_msg=f"{where} {leaf}")
        elif w is None:
            assert g is None, (where, field)
        else:
            assert w.dtype == g.dtype, (where, field, w.dtype, g.dtype)
            np.testing.assert_array_equal(w, g, err_msg=f"{where} {field}")


def _random_confidence(rng, shape):
    """u16 words over the whole range: counters >= 0x4000 make the word
    >= 0x8000, which int16 storage reads negative; many ties too."""
    conf = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    conf[rng.random(shape) < 0.3] = 0xFFFF
    conf[rng.random(shape) < 0.2] = 0x8001
    conf[rng.random(shape) < 0.2] = 2
    return conf


def _torch_conf(conf):
    return torch.from_numpy(conf.view(np.int16).copy())


def test_preferred_in_set_matches_jax():
    rng = np.random.default_rng(0)
    n, t, n_sets = 12, 50, 9
    conf = _random_confidence(rng, (n, t))
    cs = rng.integers(0, n_sets - 1, t).astype(np.int32)   # set 8 empty
    want = jdag.preferred_in_set(jnp.asarray(conf), jnp.asarray(cs), n_sets)
    got = tdag.preferred_in_set(_torch_conf(conf), torch.from_numpy(cs),
                                n_sets)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("set_size", [1, 2, 3, 5])
def test_preferred_in_set_fixed_matches_jax(set_size):
    rng = np.random.default_rng(set_size)
    n, t = 10, 30
    conf = _random_confidence(rng, (n, t))
    want = jdag.preferred_in_set_fixed(jnp.asarray(conf), set_size)
    got = tdag.preferred_in_set_fixed(_torch_conf(conf), set_size)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # ... and the segment path agrees on the same partition.
    cs = np.arange(t, dtype=np.int32) // set_size
    np.testing.assert_array_equal(
        got.numpy(), tdag.preferred_in_set(_torch_conf(conf),
                                           torch.from_numpy(cs),
                                           t // set_size).numpy())


def test_set_any_fixed_and_winners_match_jax():
    rng = np.random.default_rng(4)
    plane = rng.random((7, 24)) < 0.15
    for c in (2, 3, 4):
        np.testing.assert_array_equal(
            np.asarray(jdag.set_any_fixed(jnp.asarray(plane), c)),
            tdag.set_any_fixed(torch.from_numpy(plane), c).numpy())
        np.testing.assert_array_equal(
            np.asarray(jdag.winners_per_set(plane, c)),
            tdag.winners_per_set(torch.from_numpy(plane), c).numpy())


@pytest.mark.parametrize("cs,kw", [
    (np.arange(12) // 3, {}),                       # detected: c = 3
    (np.arange(12) // 4, dict(n_sets=3, set_size=4)),
    (np.array([0, 0, 1, 2, 1, 2, 3, 3, 3, 1]), {}),  # arbitrary
    (np.array([0, 1, 1, 0]), dict(n_sets=5)),        # empty sets 2..4
])
def test_init_matches_jax(cs, kw):
    cs = cs.astype(np.int32)
    jcfg, tcfg = _configs({})
    jstate = jdag.init(jax.random.key(2), 6, jnp.asarray(cs), jcfg, **kw)
    tstate = tdag.init(prng.key(2, "cpu"), 6, torch.from_numpy(cs), tcfg,
                       device="cpu", **kw)
    assert_dag_states_equal(jstate, tstate, "init")


@pytest.mark.parametrize("cs,kw,match", [
    (np.arange(8) // 2, dict(set_size=2), "requires n_sets"),
    (np.arange(8) // 2, dict(n_sets=3, set_size=2), "does not tile"),
    (np.array([0, 1, 0, 1]), dict(n_sets=2, set_size=2), "contiguous"),
    (np.array([0, 1, 2, 3]), dict(n_sets=3), "undercounts"),
])
def test_init_errors_match_jax(cs, kw, match):
    cs = cs.astype(np.int32)
    jcfg, tcfg = _configs({})
    with pytest.raises(ValueError, match=match):
        jdag.init(jax.random.key(0), 4, jnp.asarray(cs), jcfg, **kw)
    with pytest.raises(ValueError, match=match):
        tdag.init(prng.key(0, "cpu"), 4, torch.from_numpy(cs), tcfg,
                  device="cpu", **kw)


def _start(knobs, n, cs, seed, init_pref=None):
    jcfg, tcfg = _configs(knobs)
    jstate = jdag.init(jax.random.key(seed), n, jnp.asarray(cs), jcfg,
                       init_pref=None if init_pref is None
                       else jnp.asarray(init_pref))
    tstate = convert.dag_state_from_numpy(_jax_numpy(jstate), device="cpu")
    assert_dag_states_equal(jstate, tstate, "start")
    return jcfg, tcfg, jstate, tstate


# Partitions: sets of 2 (the fixed fast path), a 3-way conflict, an
# arbitrary partition (the segment path).
def _pairs(t):
    return np.arange(t, dtype=np.int32) // 2


def _triples(t):
    return np.arange(t, dtype=np.int32) // 3


def _arbitrary(t):
    return np.random.default_rng(t).integers(0, t // 3, t).astype(np.int32)


AXES = {
    "pairs": (dict(), _pairs, 64, 32),
    "triples_contested": (dict(max_element_poll=20, finalization_score=12),
                          _triples, 64, 48),
    "arbitrary": (dict(finalization_score=10), _arbitrary, 64, 40),
    "flip_byz0.2": (dict(byzantine_fraction=0.2), _pairs, 64, 16),
    "equivocate_byz0.2": (dict(byzantine_fraction=0.2,
                               adversary_strategy="equivocate"), _arbitrary,
                          64, 24),
    "drop0.05": (dict(drop_probability=0.05, churn_probability=0.02),
                 _triples, 64, 63),
}


@pytest.mark.parametrize("engine", ["u8", "swar32"])
@pytest.mark.parametrize("axis", sorted(AXES))
def test_run_scan_trajectory_matches_jax(axis, engine):
    knobs, partition, n, t = AXES[axis]
    cs = partition(t)
    pref = (np.random.default_rng(t).random(t) < 0.5
            if axis == "triples_contested" else None)
    jcfg, tcfg, jstate, tstate = _start(dict(knobs, ingest_engine=engine),
                                        n, cs, seed=t, init_pref=pref)
    rounds = 12
    jfinal, jtel = jdag.run_scan(jstate, jcfg, n_rounds=rounds)
    tfinal, ttel = tdag.run_scan(tstate, tcfg, n_rounds=rounds,
                                 device="cpu")
    for field in jtel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jtel, field)),
                                      getattr(ttel, field).numpy(),
                                      err_msg=field)
    assert_dag_states_equal(jfinal, tfinal, f"{axis} round {rounds}")
    if "finalization_score" in knobs:    # sets settle: rivals freeze
        assert int(ttel.finalizations.sum()) > 0


@pytest.mark.parametrize("engine", ["u8", "swar32"])
def test_run_to_settlement_matches_jax(engine):
    jcfg, tcfg, jstate, tstate = _start(dict(ingest_engine=engine), 32,
                                        _pairs(32), seed=5)
    jfinal = jdag.run(jstate, jcfg, max_rounds=60)
    tfinal = tdag.run(tstate, tcfg, max_rounds=60, device="cpu")
    assert_dag_states_equal(jfinal, tfinal, "run")
    assert bool(tdag.settled(tfinal, tcfg))
    assert bool(jdag.settled(jfinal, jcfg))
    conf = tfinal.base.records.confidence
    fin_acc = vr.has_finalized(conf, tcfg) & vr.is_accepted(conf)
    assert bool((tdag.winners_per_set(fin_acc, 2) == 1).all())


def test_round_step_rejects_megakernel_and_defaults_to_cuda():
    cs = torch.from_numpy(_pairs(8))
    state = tdag.init(prng.key(0, "cpu"), 4, cs, device="cpu")
    with pytest.raises(ValueError, match="dag model keeps the phased"):
        tdag.round_step(state, AvalancheConfig(round_engine="megakernel"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tdag.init(prng.key(0, "cpu"), 4, cs)
    with pytest.raises(RuntimeError, match="cuda"):
        tdag.run(state, max_rounds=1)


def test_dag_baseline_workload_matches_reference_config():
    """`workload.dag_baseline_*` is `baseline_suite.config2_dag`'s setup
    (at a small width here)."""
    from go_avalanche_tpu_torch import workload

    n, t = 16, 24
    jcfg = JaxConfig(max_element_poll=max(4096, t))
    jstate = jdag.init(jax.random.key(0), n,
                       jnp.arange(t, dtype=jnp.int32) // 2, jcfg)
    tstate, tcfg = workload.dag_baseline_state(n, t, device="cpu")
    for field in tcfg.__dataclass_fields__:
        want, got = getattr(jcfg, field), getattr(tcfg, field)
        assert getattr(want, "value", want) == getattr(got, "value", got), \
            field
    assert_dag_states_equal(jstate, tstate, "dag baseline init")
