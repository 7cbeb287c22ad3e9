"""The port's streaming backlog scheduler (`models/backlog.py`) against
the JAX one.

Both packages start from one state (the JAX `init`, carried over with
`convert.backlog_state_from_numpy`) and run the same steps; every state
leaf and every per-step telemetry scalar must be equal, step by step and
over whole `run` / `run_scan` calls, on the cases `tests/test_backlog.py`
pins.  Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import backlog as tbl
from test_torch_avalanche import _jax_numpy


def assert_trees_equal(want, got, where):
    """Every leaf of the port's (numpy) tree `got` equals the same field
    of the reference's `want`, dtype included; fields the reference has
    and the port does not (the async ring, trace plane) are skipped."""
    if got is None:
        assert want is None, where
    elif hasattr(got, "_fields"):
        for field in got._fields:
            assert_trees_equal(getattr(want, field), getattr(got, field),
                               f"{where}.{field}")
    elif isinstance(got, (int, str)):
        assert want == got, where
    else:
        w = np.asarray(want)
        assert w.dtype == got.dtype, (where, w.dtype, got.dtype)
        np.testing.assert_array_equal(w, got, err_msg=where)


def jax_tree(tree):
    return None if tree is None else _jax_numpy(tree)


def torch_tree(tree):
    """A port telemetry tree as numpy leaves."""
    return convert._np_tree(tree)


def configs(**knobs):
    return JaxConfig(**knobs), AvalancheConfig(**knobs)


def pair(n_nodes=16, n_txs=24, window=8, seed=0, scores=None, valid=None,
         init_pref=None, **knobs):
    """(jax state, port state, jax cfg, port cfg) from one JAX init."""
    jcfg, tcfg = configs(**knobs)
    if scores is None:
        scores = jnp.arange(n_txs, dtype=jnp.int32)
    backlog = jbl.make_backlog(scores, init_pref=init_pref, valid=valid)
    jstate = jbl.init(jax.random.key(seed), n_nodes, window, backlog, jcfg)
    tstate = convert.backlog_state_from_numpy(_jax_numpy(jstate),
                                              device="cpu")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), "carried")
    return jstate, tstate, jcfg, tcfg


def test_make_backlog_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 16, 300).astype(np.int32)
    pref = rng.random(300) < 0.5
    valid = rng.random(300) < 0.9
    want = jbl.make_backlog(jnp.asarray(scores), jnp.asarray(pref),
                            jnp.asarray(valid))
    got = tbl.make_backlog(torch.from_numpy(scores), torch.from_numpy(pref),
                           torch.from_numpy(valid))
    assert_trees_equal(jax_tree(want), torch_tree(got), "backlog")


def test_init_matches_jax():
    cfg = AvalancheConfig()
    scores = np.arange(24, dtype=np.int32)
    jstate = jbl.init(jax.random.key(3), 16, 8,
                      jbl.make_backlog(jnp.asarray(scores)), JaxConfig())
    tstate = tbl.init(torch.tensor([0, 3]), 16, 8,
                      tbl.make_backlog(torch.from_numpy(scores)), cfg,
                      device="cpu")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), "init")


CASES = {
    "default": dict(),
    "rejected_prior_invalid_txs": dict(
        n_txs=12, window=4, init_pref=jnp.arange(12) % 2 == 0,
        valid=jnp.arange(12) >= 4),
    "byzantine": dict(n_nodes=32, n_txs=8, window=4, byzantine_fraction=0.25),
    "tied_scores_gossip_off_capped_poll": dict(
        n_txs=40, window=12, gossip=False, max_element_poll=5,
        scores=jnp.asarray(np.random.default_rng(1).integers(0, 4, 40),
                           jnp.int32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_then_run_match_jax(case):
    """20 steps compared step by step (state and telemetry), then `run`
    from there to the end."""
    jstate, tstate, jcfg, tcfg = pair(**CASES[case])
    jstep = jax.jit(jbl.step, static_argnames=("cfg",))
    for r in range(20):
        jstate, jtel = jstep(jstate, jcfg)
        tstate, ttel = tbl.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel),
                           f"{case} round {r} telemetry")
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), case)
    want = jax.jit(jbl.run, static_argnames=("cfg", "max_rounds"))(
        jstate, jcfg, 5000)
    got = tbl.run(tstate, tcfg, max_rounds=5000, device="cpu")
    assert_trees_equal(_jax_numpy(want), convert.backlog_state_to_numpy(got),
                       case)
    assert bool(tbl.drained(got, tcfg)) == bool(jbl.drained(want, jcfg))


def test_capped_run_harvest_matches_jax():
    """A max_rounds-capped run: the harvest records the settled window
    without admitting replacements (tests/test_backlog.py)."""
    jstate, tstate, jcfg, tcfg = pair(n_nodes=8, n_txs=40, window=4)
    want = jax.jit(jbl.run, static_argnames=("cfg", "max_rounds"))(
        jstate, jcfg, 17)
    got = tbl.run(tstate, tcfg, max_rounds=17, device="cpu")
    assert_trees_equal(_jax_numpy(want), convert.backlog_state_to_numpy(got),
                       "capped")
    assert int(got.outputs.settled.sum()) == 4 and int(got.next_idx) == 4
    assert not bool(tbl.drained(got, tcfg))


def test_run_scan_untracked_matches_jax():
    """`run_scan` with stacked telemetry, on a state without the
    finality plane (`track_finality=False`)."""
    jcfg, tcfg = configs()
    backlog = jbl.make_backlog(jnp.arange(12, dtype=jnp.int32))
    jstate = jbl.init(jax.random.key(1), 8, 4, backlog, jcfg,
                      track_finality=False)
    tstate = convert.backlog_state_from_numpy(_jax_numpy(jstate),
                                              device="cpu")
    assert tstate.sim.finalized_at is None
    want, wtel = jax.jit(jbl.run_scan, static_argnames=("cfg", "n_rounds"))(
        jstate, jcfg, 60)
    got, gtel = tbl.run_scan(tstate, tcfg, n_rounds=60, device="cpu")
    assert_trees_equal(_jax_numpy(want), convert.backlog_state_to_numpy(got),
                       "run_scan")
    assert_trees_equal(jax_tree(wtel), torch_tree(gtel), "telemetry")
    assert int(gtel.retired.sum()) == int(got.outputs.settled.sum())


def test_megakernel_round_engine_rejected():
    _, tstate, _, tcfg = pair()
    with pytest.raises(ValueError, match="megakernel"):
        tbl.step(tstate, dataclasses.replace(tcfg, round_engine="megakernel"))
