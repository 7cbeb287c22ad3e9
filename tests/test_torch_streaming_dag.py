"""The port's streaming conflict-DAG scheduler (`models/streaming_dag.py`)
against the JAX one: step by step, whole `run`, `run_chunked` (= `run`),
`run_scan` and the sparse retire cap (= the dense path when the cap
covers the window), on the cases `tests/test_streaming_dag.py` pins.
Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.models import streaming_dag as tsd
from test_torch_avalanche import _jax_numpy
from test_torch_backlog import assert_trees_equal, jax_tree, torch_tree


def configs(**knobs):
    jkw, tkw = dict(knobs), dict(knobs)
    if "adversary_strategy" in knobs:
        jkw["adversary_strategy"] = JaxStrategy(knobs["adversary_strategy"])
        tkw["adversary_strategy"] = AdversaryStrategy(
            knobs["adversary_strategy"])
    return JaxConfig(**jkw), AvalancheConfig(**tkw)


def make_backlog(n_sets, c, seed=0):
    scores = jax.random.randint(jax.random.key(seed + 100), (n_sets, c), 0,
                                1000)
    return jsd.make_set_backlog(scores)


def pair(n=16, n_sets=10, c=2, w_sets=3, seed=7, backlog=None, **knobs):
    jcfg, tcfg = configs(**knobs)
    backlog = make_backlog(n_sets, c) if backlog is None else backlog
    jstate = jsd.init(jax.random.key(seed), n, w_sets, backlog, jcfg)
    tstate = convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                    device="cpu")
    return jstate, tstate, jcfg, tcfg


def check(want, got, where):
    assert_trees_equal(_jax_numpy(want),
                       convert.streaming_dag_state_to_numpy(got), where)


def test_make_set_backlog_matches_jax_with_ties_and_padding():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 8, (200, 3)).astype(np.int32)
    valid = rng.random((200, 3)) < 0.8
    valid[5] = False                       # a set with no valid member
    want = jsd.make_set_backlog(jnp.asarray(scores), valid=jnp.asarray(valid))
    got = tsd.make_set_backlog(torch.from_numpy(scores),
                               valid=torch.from_numpy(valid))
    assert_trees_equal(jax_tree(want), torch_tree(got), "set backlog")


def test_init_matches_jax():
    jcfg, tcfg = configs()
    scores = np.random.default_rng(1).integers(0, 50, (12, 2)).astype(
        np.int32)
    jstate = jsd.init(jax.random.key(4), 16, 4,
                      jsd.make_set_backlog(jnp.asarray(scores)), jcfg)
    tstate = tsd.init(torch.tensor([0, 4]), 16, 4,
                      tsd.make_set_backlog(torch.from_numpy(scores)), tcfg,
                      device="cpu")
    check(jstate, tstate, "init")


CASES = {
    "default": dict(),
    "faults": dict(n=24, n_sets=12, byzantine_fraction=0.2,
                   drop_probability=0.1, churn_probability=0.01,
                   adversary_strategy="equivocate"),
    "flip_c3": dict(n=20, n_sets=9, c=3, w_sets=3, byzantine_fraction=0.15,
                    adversary_strategy="flip"),
    "retire_cap_2": dict(n=16, n_sets=12, w_sets=4, stream_retire_cap=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_then_run_and_run_chunked_match_jax(case):
    """20 steps compared step by step, then `run` and `run_chunked` (a
    chunk that does not divide the round count) from there: both end
    where the JAX `run` does.  The equivocating case does not drain, so
    every run stops at 100 rounds."""
    jstate, tstate, jcfg, tcfg = pair(**CASES[case])
    jstep = jax.jit(jsd.step, static_argnames=("cfg",))
    for r in range(20):
        jstate, jtel = jstep(jstate, jcfg)
        tstate, ttel = tsd.step(tstate, tcfg)
        assert_trees_equal(jax_tree(jtel), torch_tree(ttel),
                           f"{case} round {r} telemetry")
    check(jstate, tstate, case)
    want = jax.jit(jsd.run, static_argnames=("cfg", "max_rounds"))(
        jstate, jcfg, 100)
    got = tsd.run(tstate, tcfg, max_rounds=100, device="cpu")
    check(want, got, f"{case} run")
    seen = []
    chunked = tsd.run_chunked(tstate, tcfg, max_rounds=100, chunk=17,
                              progress=lambda r, s: seen.append(r),
                              device="cpu")
    check(want, chunked, f"{case} run_chunked")
    assert seen[-1] == int(chunked.dag.base.round)
    assert all(b - a <= 17 for a, b in zip([20] + seen, seen))
    assert tsd.resolution_summary(got) == jsd.resolution_summary(want)


def test_retire_cap_at_window_size_equals_dense():
    """cap >= window sets: nothing defers, so the sparse path writes what
    the dense one writes, step by step — and both equal JAX."""
    jstate, tstate, jcfg, tcfg = pair(n_sets=12, w_sets=4, seed=0)
    cap_cfg = dataclasses.replace(tcfg, stream_retire_cap=4)
    jstep = jax.jit(jsd.step, static_argnames=("cfg",))
    dense = sparse = tstate
    for r in range(40):
        jstate, _ = jstep(jstate, jcfg)
        dense, dtel = tsd.step(dense, tcfg)
        sparse, stel = tsd.step(sparse, cap_cfg)
        assert_trees_equal(torch_tree(dtel), torch_tree(stel), f"round {r}")
    check(jstate, dense, "dense")
    check(jstate, sparse, "cap = window")


def test_run_scan_and_track_finality_off_match_jax():
    jcfg, tcfg = configs(byzantine_fraction=0.2, drop_probability=0.05,
                         adversary_strategy="equivocate")
    backlog = make_backlog(8, 2)
    jstate = jsd.init(jax.random.key(5), 16, 3, backlog, jcfg,
                      track_finality=False)
    tstate = convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                    device="cpu")
    assert tstate.dag.base.finalized_at is None
    want, wtel = jax.jit(jsd.run_scan, static_argnames=("cfg", "n_rounds"))(
        jstate, jcfg, 30)
    got, gtel = tsd.run_scan(tstate, tcfg, n_rounds=30, device="cpu")
    check(want, got, "run_scan")
    assert_trees_equal(jax_tree(wtel), torch_tree(gtel), "telemetry")


def test_run_chunked_rejects_bad_knobs_and_checkpoints(tmp_path):
    _, tstate, _, tcfg = pair(n_sets=4, w_sets=2)
    with pytest.raises(ValueError, match="chunk"):
        tsd.run_chunked(tstate, tcfg, max_rounds=10, chunk=0, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_every_chunks"):
        tsd.run_chunked(tstate, tcfg, max_rounds=10, chunk=2,
                        checkpoint_path="x.npz", checkpoint_every_chunks=0,
                        device="cpu")
    # checkpoints are ported: a checkpointed run saves and ends where the
    # plain run does
    path = tmp_path / "x.npz"
    saved = tsd.run_chunked(tstate, tcfg, max_rounds=10, chunk=2,
                            checkpoint_path=str(path),
                            checkpoint_every_chunks=1, device="cpu")
    plain = tsd.run_chunked(tstate, tcfg, max_rounds=10, chunk=2,
                            device="cpu")
    assert path.exists()
    assert int(saved.dag.base.round) == int(plain.dag.base.round)
    assert torch.equal(saved.dag.base.records.confidence,
                       plain.dag.base.records.confidence)
