"""The port's sharded streaming conflict DAG
(`parallel/sharded_streaming_dag.py`) against the JAX package's
`shard_map` driver, and the `torch.distributed.checkpoint` pair
(`utils/checkpoint.save_checkpoint_dcp` / `restore_checkpoint_dcp`).

As in tests/test_torch_sharded_backlog.py: the JAX side over the 8
virtual CPU devices (one step program per mesh shape and config), the
port's in one module-scoped `RankPool` of 4 gloo ranks, every gathered
leaf and telemetry row equal (tolerance 0).  The DCP cases save a
sharded state after 5 rounds on 2x1, resume it there (equal to the
uninterrupted run), reshard it onto 1x2 and one device (equal to the
gathered state), hold the one-device restore against the JAX package's
orbax pair, and check that a save killed before its rename leaves no
readable checkpoint.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu.parallel import sharded_streaming_dag as jssd
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.parallel.ranks import RankPool
from test_torch_avalanche import _configs, _jax_numpy
from test_torch_sharded import assert_tree, jax_mesh
from test_torch_sharded_backlog import (RANK_LEAVES, SHAPES, _flat,
                                        check_stream, jax_drive, port_numpy)
import torch_ranks


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


def sdag_state(knobs, n_nodes=16, n_sets=12, c=2, window_sets=4, seed=0,
               scores=None, track_finality=True, trace_rounds=0):
    jcfg = _configs(knobs)[0]
    if scores is None:
        scores = jnp.arange(n_sets * c, dtype=jnp.int32).reshape(n_sets, c)
    state = jsd.init(jax.random.key(seed), n_nodes, window_sets,
                     jsd.make_set_backlog(scores), jcfg,
                     track_finality=track_finality)
    if trace_rounds:
        state = jsd.with_trace(state, jcfg, trace_rounds)
    return state


# The traced case's config (`test_configs_match_jax`), so the JAX side
# reuses its step program, and the trace buffer goes through DCP too.
DCP_KNOBS = dict(trace_every=2, byzantine_fraction=0.2)


def dcp_start():
    return sdag_state(DCP_KNOBS, trace_rounds=6)


def check(pool, jstate, knobs, shape, mode="step", rounds=8):
    return check_stream(pool, "streaming_dag", jstate, knobs, shape, mode,
                        rounds)


def summary(tree):
    """`resolution_summary` of a numpy streaming-DAG tree."""
    from go_avalanche_tpu_torch.models import streaming_dag as tsd

    return tsd.resolution_summary(
        convert.streaming_dag_state_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_streaming_dag_settles_as_jax(pool, shape):
    """The default config to settlement: every set settles with one
    winner, the initially preferred lane."""
    results, _ = check(pool, sdag_state({}, n_sets=8), {}, shape,
                       mode="run", rounds=4000)
    got = results[0][0]
    s = summary(got)
    assert s["sets_settled_fraction"] == 1.0
    assert s["sets_one_winner_fraction"] == 1.0
    assert got.outputs.accepted[:, 0].all()
    assert not got.outputs.accepted[:, 1:].any()


def test_byzantine_flip_matches_jax(pool):
    """tests/test_sharded_streaming_dag.py's byzantine FLIP, driven to
    settlement."""
    knobs = dict(byzantine_fraction=0.15, flip_probability=1.0,
                 adversary_strategy="flip")
    results, _ = check(pool, sdag_state(knobs, n_nodes=16, n_sets=6), knobs,
                       (2, 2), mode="run", rounds=6000)
    assert summary(results[0][0])["sets_settled_fraction"] == 1.0


def test_track_finality_off_matches_jax(pool):
    scores = jnp.full((4, 2), 5, jnp.int32)
    results, _ = check(pool, sdag_state({}, n_sets=4, window_sets=2,
                                        scores=scores, track_finality=False),
                       {}, (2, 1), mode="run", rounds=5000)
    assert results[0][0].dag.base.finalized_at is None


def test_retire_cap_matches_jax_and_the_dense_scheduler(pool):
    """tests/test_sharded_streaming_dag.py's pin: under a deferring cap
    of 2 the sharded trajectory is the unsharded one bit for bit (the
    global participation rank is the dense cumsum order), apart from the
    per-shard rank leaves; here against the port's dense `step` as well
    as the JAX driver."""
    from go_avalanche_tpu_torch.models import streaming_dag as tsd

    knobs = dict(stream_retire_cap=2)
    start = sdag_state(knobs)
    results, _ = check(pool, start, knobs, (2, 2), rounds=40)
    dense = convert.streaming_dag_state_from_numpy(_jax_numpy(start),
                                                   device="cpu")
    tcfg = _configs(knobs)[1]
    for _ in range(40):
        dense = tsd.step(dense, tcfg)[0]
    want = _flat(convert.streaming_dag_state_to_numpy(dense))
    got = _flat(results[0][0])
    for name, leaf in want.items():
        if name.rsplit(".", 1)[-1] in RANK_LEAVES or name.endswith(".key"):
            continue
        np.testing.assert_array_equal(leaf, got[name], err_msg=name)


@pytest.mark.parametrize("knobs,shape,mode,rounds", [
    (dict(finalization_score=8, latency_mode="fixed", latency_rounds=1,
          time_step_s=1.0, request_timeout_s=4.0), (2, 2), "run", 3000),
    (DCP_KNOBS, (2, 1), "step", 6),
    (dict(ingest_engine="swar32", byzantine_fraction=0.2,
          drop_probability=0.1, max_element_poll=3), (1, 2), "step", 8),
], ids=["async", "traced", "swar32-capped"])
def test_configs_match_jax(pool, knobs, shape, mode, rounds):
    start = sdag_state(knobs, trace_rounds=rounds if knobs.get(
        "trace_every") else 0)
    results, _ = check(pool, start, knobs, shape, mode, rounds)
    if mode == "run":
        assert summary(results[0][0])["sets_settled_fraction"] == 1.0


def test_arrival_sequence_dense_vs_sharded(pool):
    """tests/test_traffic.py's pin for the set scheduler, against the
    port's dense scheduler (held to the JAX one in
    tests/test_torch_traffic.py)."""
    from go_avalanche_tpu_torch.models import streaming_dag as tsd

    knobs = dict(arrival_mode="poisson", arrival_rate=3.0)
    scores = jnp.arange(24, dtype=jnp.int32).reshape(12, 2)
    start = sdag_state(knobs, scores=scores)
    results, _ = check(pool, start, knobs, (2, 2), mode="scan", rounds=16)
    dense_tel = tsd.run_scan(convert.streaming_dag_state_from_numpy(
        _jax_numpy(start), device="cpu"), _configs(knobs)[1], 16,
        device="cpu")[1].traffic
    np.testing.assert_array_equal(dense_tel.arrivals.numpy(),
                                  results[0][1]["traffic"]["arrivals"])


def test_tx_only_meshes_walk_the_node_only_trajectory(pool):
    """The JAX driver walks the same trajectory on 1x2 as on 1x1 and on
    2x2 as on 2x1, every leaf but the per-shard rank leaves; the port's
    must too."""
    knobs = dict(byzantine_fraction=0.2, flip_probability=1.0)
    start = port_numpy("streaming_dag", sdag_state(knobs))

    def run(shape):
        return _flat(pool.run(shape[0] * shape[1], torch_ranks.stream_case,
                              "streaming_dag", start, knobs, shape, "step",
                              10)[0][0])

    runs = {s: run(s) for s in SHAPES}
    for tx_only, twin in (((1, 2), (1, 1)), ((2, 2), (2, 1))):
        for name, leaf in runs[twin].items():
            if name.rsplit(".", 1)[-1] not in RANK_LEAVES:
                np.testing.assert_array_equal(
                    leaf, runs[tx_only][name], err_msg=f"{tx_only} {name}")
    votes = ".dag.base.records.votes"
    assert not np.array_equal(runs[(1, 1)][votes], runs[(2, 1)][votes])


@pytest.mark.parametrize("window_sets,c,match", [
    (3, 2, "multiple of the set capacity"),
    (3, 3, "must divide by tx shards"),
])
def test_placement_refusals_match(window_sets, c, match):
    """Whole-set tx sharding, message for message."""
    from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd
    from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, TXS_AXIS

    scores = jnp.arange(6 * c, dtype=jnp.int32).reshape(6, c)
    jstate = sdag_state({}, window_sets=window_sets, c=c, scores=scores)
    with pytest.raises(ValueError, match=match) as want:
        jssd.shard_streaming_dag_state(jstate, jax_mesh((1, 2)))
    tstate = convert.streaming_dag_state_from_numpy(_jax_numpy(jstate),
                                                    device="cpu")

    class TwoTxShards:      # the placement checks read the txs width only
        shape = {NODES_AXIS: 1, TXS_AXIS: 2}

    with pytest.raises(ValueError, match=match) as got:
        ssd.shard_streaming_dag_state(tstate, TwoTxShards())
    assert str(got.value) == str(want.value)


def test_step_records_its_declared_collectives(pool):
    from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd

    knobs = dict(byzantine_fraction=0.25, adversary_strategy="oppose_majority",
                 max_element_poll=3, arrival_mode="poisson",
                 arrival_rate=3.0)
    results = pool.run(4, torch_ranks.stream_case, "streaming_dag",
                       port_numpy("streaming_dag", sdag_state(knobs)), knobs,
                       (2, 2), "step", 2)
    for _, _, recorded, _ in results:
        assert recorded == ssd.DECLARED_COLLECTIVES
    assert ssd.DECLARED_COLLECTIVES == jssd.DECLARED_COLLECTIVES


# ------------------------------------------------------------------ DCP



@pytest.fixture(scope="module")
def saved(pool, tmp_path_factory):
    """The streaming DAG after 5 rounds on 2x1, saved with the DCP pair:
    (start tree, checkpoint path, the gathered saved state)."""
    start = port_numpy("streaming_dag", dcp_start())
    path = str(tmp_path_factory.mktemp("dcp") / "ckpt")
    state = pool.run(2, torch_ranks.dcp_case, start, DCP_KNOBS, (2, 1), 5,
                     path, "save")[0]
    return start, path, state


def test_dcp_resume_equals_the_uninterrupted_run(pool, saved):
    start, path, _ = saved
    whole = pool.run(2, torch_ranks.stream_case, "streaming_dag", start,
                     DCP_KNOBS, (2, 1), "step", 10)[0][0]
    for got in pool.run(2, torch_ranks.dcp_case, start, DCP_KNOBS, (2, 1),
                        5, path, "resume"):
        assert_tree(whole, got)


def test_dcp_reshards_onto_another_mesh_and_one_device(pool, saved):
    from go_avalanche_tpu_torch.utils import checkpoint

    start, path, state = saved
    for got in pool.run(2, torch_ranks.dcp_case, start, DCP_KNOBS, (1, 2),
                        0, path, "restore"):
        assert_tree(state, got)
    template = convert.streaming_dag_state_from_numpy(start, device="cpu")
    dense = checkpoint.restore_checkpoint_dcp(path, template)
    assert_tree(state, convert.streaming_dag_state_to_numpy(dense))


def test_dcp_dense_restore_equals_the_orbax_pair(saved, tmp_path):
    """The one-device DCP restore equals the JAX package's orbax restore
    of the JAX sharded state after the same 5 rounds on 2x1."""
    pytest.importorskip("orbax.checkpoint")
    from go_avalanche_tpu.utils import checkpoint as jck
    from go_avalanche_tpu_torch.utils import checkpoint

    start, path, _ = saved
    jstate, _ = jax_drive("streaming_dag", dcp_start(), DCP_KNOBS, (2, 1),
                          "step", 5)
    jck.save_checkpoint_orbax(str(tmp_path / "orbax"), jstate)
    want = jck.restore_checkpoint_orbax(str(tmp_path / "orbax"), jstate)
    template = convert.streaming_dag_state_from_numpy(start, device="cpu")
    got = checkpoint.restore_checkpoint_dcp(path, template)
    assert_tree(port_numpy("streaming_dag", want),
                convert.streaming_dag_state_to_numpy(got))


def test_dcp_save_killed_before_the_rename_leaves_no_torn_checkpoint(
        tmp_path, monkeypatch):
    """A save that dies before its rename: with no earlier checkpoint
    nothing is readable; with one, the earlier one restores whole."""
    from go_avalanche_tpu_torch.models import streaming_dag as tsd
    from go_avalanche_tpu_torch.utils import checkpoint

    start = convert.streaming_dag_state_from_numpy(
        port_numpy("streaming_dag", dcp_start()), device="cpu")
    later = tsd.step(start, _configs(DCP_KNOBS)[1])[0]
    path = str(tmp_path / "ckpt")

    def killed(tmp, dest):
        raise KeyboardInterrupt("killed before the rename")

    with monkeypatch.context() as m:
        m.setattr(checkpoint, "_install", killed)
        with pytest.raises(KeyboardInterrupt):
            checkpoint.save_checkpoint_dcp(path, start)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint_dcp(path, start)
    checkpoint.save_checkpoint_dcp(path, start)
    with monkeypatch.context() as m:
        m.setattr(checkpoint, "_install", killed)
        with pytest.raises(KeyboardInterrupt):
            checkpoint.save_checkpoint_dcp(path, later)
    got = checkpoint.restore_checkpoint_dcp(path, later)
    assert_tree(convert.streaming_dag_state_to_numpy(start),
                convert.streaming_dag_state_to_numpy(got))


def test_dcp_refuses_another_structure(tmp_path):
    """A template of another structure fails loudly, as the npz
    backend's does; nothing is cast."""
    from go_avalanche_tpu_torch.utils import checkpoint

    start = convert.streaming_dag_state_from_numpy(
        port_numpy("streaming_dag", dcp_start()), device="cpu")
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint_dcp(path, start)
    untracked = start._replace(dag=start.dag._replace(
        base=start.dag.base._replace(finalized_at=None)))
    with pytest.raises(ValueError, match="leaves, template has"):
        checkpoint.restore_checkpoint_dcp(path, untracked)
    wider = start._replace(next_idx=start.next_idx.to(torch.int64))
    with pytest.raises(ValueError, match="leaf"):
        checkpoint.restore_checkpoint_dcp(path, wider)
