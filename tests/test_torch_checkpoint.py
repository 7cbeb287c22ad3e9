"""npz checkpoints of the port (`utils/checkpoint.py`) against the JAX
package's (`go_avalanche_tpu/utils/checkpoint.py`).

A state the port stepped is saved by the port, restored by JAX, saved
again by JAX and restored by the port: every leaf must come back
bit-equal, in JAX's leaf order, names and dtypes, for every state kind
both packages carry.  Also the refusals (leaf count, dtype, a missing
key), the bounded transfers, the fetch deadline, and a chunked
streaming run killed after a save and resumed from its checkpoint.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu import config as jconfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.models import family as jfam
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.models import streaming_dag as jsdg
from go_avalanche_tpu.utils import checkpoint as jck
from go_avalanche_tpu_torch import config as tconfig
from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import backlog as tbl
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.models import family as tfam
from go_avalanche_tpu_torch.models import node_stream as tns
from go_avalanche_tpu_torch.models import snowball as tsb
from go_avalanche_tpu_torch.models import streaming_dag as tsdg
from go_avalanche_tpu_torch.utils import checkpoint as tck

ASYNC = dict(latency_mode="fixed", latency_rounds=1, time_step_s=1.0,
             request_timeout_s=3.0)
STAKE = dict(stake_mode="zipf", registry_nodes=16, active_nodes=8)
ARRIVALS = dict(arrival_mode="poisson", arrival_rate=2.0)


def _cs(t, c):
    return np.arange(t, dtype=np.int32) // c


# name -> (config knobs, JAX init(cfg), port init(cfg), port step)
KINDS = {
    "avalanche": ({}, lambda c: jav.init(jax.random.key(0), 8, 16, c),
                  lambda c: tav.init(prng.key(0, "cpu"), 8, 16, c,
                                     device="cpu"),
                  lambda s, c: tav.round_step(s, c)[0]),
    "avalanche_async": (ASYNC,
                        lambda c: jav.init(jax.random.key(0), 8, 16, c),
                        lambda c: tav.init(prng.key(0, "cpu"), 8, 16, c,
                                           device="cpu"),
                        lambda s, c: tav.round_step(s, c)[0]),
    "avalanche_traced": (
        dict(trace_every=1),
        lambda c: jav.with_trace(jav.init(jax.random.key(0), 8, 16, c), c, 6),
        lambda c: tav.with_trace(tav.init(prng.key(0, "cpu"), 8, 16, c,
                                          device="cpu"), c, 6),
        lambda s, c: tav.round_step(s, c)[0]),
    "dag": ({}, lambda c: jdag.init(jax.random.key(0), 8,
                                    jnp.asarray(_cs(8, 2)), c),
            lambda c: tdag.init(prng.key(0, "cpu"), 8,
                                torch.from_numpy(_cs(8, 2)), c,
                                device="cpu"),
            lambda s, c: tdag.round_step(s, c)[0]),
    "snowball": ({}, lambda c: jsb.init(jax.random.key(0), 16, c),
                 lambda c: tsb.init(prng.key(0, "cpu"), 16, c, device="cpu"),
                 lambda s, c: tsb.round_step(s, c)[0]),
    "slush": ({}, lambda c: jfam.slush_init(jax.random.key(0), 16, c),
              lambda c: tfam.slush_init(prng.key(0, "cpu"), 16, c,
                                        device="cpu"),
              lambda s, c: tfam.slush_round(s, c)[0]),
    "backlog": (ARRIVALS,
                lambda c: jbl.init(jax.random.key(0), 8, 4, jbl.make_backlog(
                    jnp.arange(12, dtype=jnp.int32)), c),
                lambda c: tbl.init(prng.key(0, "cpu"), 8, 4, tbl.make_backlog(
                    torch.arange(12, dtype=torch.int32)), c, device="cpu"),
                lambda s, c: tbl.step(s, c)[0]),
    "streaming_dag": (
        {}, lambda c: jsdg.init(jax.random.key(0), 8, 2, jsdg.make_set_backlog(
            jnp.arange(12, dtype=jnp.int32).reshape(6, 2)), c),
        lambda c: tsdg.init(prng.key(0, "cpu"), 8, 2, tsdg.make_set_backlog(
            torch.arange(12, dtype=torch.int32).reshape(6, 2)), c,
            device="cpu"),
        lambda s, c: tsdg.step(s, c)[0]),
    "node_stream": (STAKE, lambda c: jns.init(jax.random.key(0), 8, c),
                    lambda c: tns.init(prng.key(0, "cpu"), 8, c,
                                       device="cpu"),
                    lambda s, c: tns.step(s, c)[0]),
}


def _jax_leaves(state):
    out = []
    for leaf in jax.tree_util.tree_leaves(state):
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out.append(np.asarray(leaf))
    return out


def _port_leaves(state):
    to_numpy, _ = tck._kind(state)
    return [np.asarray(x) for _, x in tck._leaves(to_numpy(state))]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


@pytest.mark.parametrize("kind", list(KINDS))
def test_cross_restore_both_directions(tmp_path, kind):
    knobs, j_init, t_init, t_step = KINDS[kind]
    cj, ct = (jconfig.AvalancheConfig(**knobs),
              tconfig.AvalancheConfig(**knobs))
    state = t_init(ct)
    for _ in range(2):
        state = t_step(state, ct)
    port_file, jax_file = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")

    tck.save_checkpoint(port_file, state)
    js = jck.restore_checkpoint(port_file, j_init(cj))
    _assert_leaves_equal(_jax_leaves(js), _port_leaves(state))

    jck.save_checkpoint(jax_file, js)
    back = tck.restore_checkpoint(jax_file, t_init(ct), device="cpu")
    _assert_leaves_equal(_port_leaves(back), _port_leaves(state))
    assert type(back) is type(state)
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])
    # the restored state steps on exactly as the saved one
    _assert_leaves_equal(_port_leaves(t_step(back, ct)),
                         _port_leaves(t_step(state, ct)))


def _saved_avalanche(tmp_path):
    cfg = tconfig.AvalancheConfig()
    state = tav.init(prng.key(1, "cpu"), 8, 16, cfg, device="cpu")
    path = str(tmp_path / "a.npz")
    tck.save_checkpoint(path, state)
    return path, state


def test_leaf_count_refusal_matches_reference(tmp_path):
    path, _ = _saved_avalanche(tmp_path)
    port_dag = KINDS["dag"][2](tconfig.AvalancheConfig())
    jax_dag = KINDS["dag"][1](jconfig.AvalancheConfig())
    with pytest.raises(ValueError) as got:
        tck.restore_checkpoint(path, port_dag, device="cpu")
    with pytest.raises(ValueError) as want:
        jck.restore_checkpoint(path, jax_dag)
    assert str(got.value) == str(want.value)
    assert "leaves, template has" in str(got.value)


@pytest.mark.parametrize("tamper", ["dtype", "shape", "key"])
def test_leaf_refusals_match_reference(tmp_path, tamper):
    path, state = _saved_avalanche(tmp_path)
    with np.load(path) as data:
        payload = dict(data)
    if tamper == "dtype":      # confidence as int16 instead of u16
        payload["leaf_2"] = payload["leaf_2"].view(np.int16)
    elif tamper == "shape":
        payload["leaf_3"] = payload["leaf_3"][:-1]
    else:
        key = next(n for n in payload if n.startswith("__prngkey__"))
        payload[key.replace("__prngkey__", "leaf_")] = payload.pop(key)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **payload)
    with pytest.raises(ValueError) as got:
        tck.restore_checkpoint(bad, state, device="cpu")
    with pytest.raises(ValueError) as want:
        jck.restore_checkpoint(bad, jav.init(jax.random.key(0), 8, 16,
                                             jconfig.AvalancheConfig()))
    assert str(got.value) == str(want.value)


def test_bounded_transfers(tmp_path, monkeypatch):
    knobs, _, t_init, _ = KINDS["streaming_dag"]
    cfg = tconfig.AvalancheConfig(**knobs)
    state = t_init(cfg)
    whole, bounded = str(tmp_path / "w.npz"), str(tmp_path / "b.npz")
    tck.save_checkpoint(whole, state)
    sizes = []
    copy = tck._copy_to_host

    def spy(block, stream):
        sizes.append(block.numel() * block.element_size())
        return copy(block, stream)

    monkeypatch.setattr(tck, "_copy_to_host", spy)
    cap = 16
    tck.save_checkpoint(bounded, state, max_fetch_bytes=cap)
    leaves = [t for t in _tensors(state)]
    row_bytes = max(t.numel() * t.element_size() // max(t.shape[0], 1)
                    if t.dim() else 0 for t in leaves)
    assert len(sizes) > len(leaves)
    assert max(sizes) <= max(cap, row_bytes)
    with np.load(whole) as a, np.load(bounded) as b:
        assert a.files == b.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    put = []
    real_put = tck._put_bounded
    monkeypatch.setattr(tck, "_put_bounded", lambda t, d, cap: put.append(
        cap) or real_put(t, d, cap))
    back = tck.restore_checkpoint(bounded, state, max_transfer_bytes=cap,
                                  device="cpu")
    assert set(put) == {cap}
    _assert_leaves_equal(_port_leaves(back), _port_leaves(state))
    assert list(tck._row_blocks((10, 4), 40, 16)) == [(0, 4), (4, 8),
                                                     (8, 10)]
    assert list(tck._row_blocks((10, 4), 40, None)) == []


def _tensors(state):
    out = []
    tck._map_tensors(state, lambda t: out.append(t) or t)
    return out


def test_fetch_timeout_aborts_before_any_write(tmp_path, monkeypatch):
    path, state = _saved_avalanche(tmp_path)
    target = str(tmp_path / "slow.npz")
    monkeypatch.setattr(tck, "_copy_to_host",
                        lambda block, stream: time.sleep(0.5) or block)
    with pytest.raises(tck.CheckpointFetchTimeout, match="exceeded"):
        tck.save_checkpoint(target, state, fetch_timeout_s=0.02)
    assert not (tmp_path / "slow.npz").exists()
    assert not (tmp_path / "slow.npz.tmp").exists()


def _streaming(track=True):
    cfg = tconfig.AvalancheConfig(finalization_score=16)
    backlog = tsdg.make_set_backlog(
        torch.arange(40, dtype=torch.int32).reshape(20, 2))
    return tsdg.init(prng.key(2, "cpu"), 8, 4, backlog, cfg,
                     device="cpu"), cfg


class _Killed(Exception):
    pass


def test_chunked_run_killed_and_resumed_equals_uninterrupted(tmp_path):
    state, cfg = _streaming()
    full = tsdg.run_chunked(state, cfg, max_rounds=40, chunk=4,
                            device="cpu")
    path = tmp_path / "run.npz"
    boundaries = {}

    def kill_after_save(rounds, s):
        # The first boundary's save starts after this hook returns; at
        # the second, wait for it to land, then kill the run.
        boundaries[rounds] = _port_leaves(s)
        if len(boundaries) == 2:
            deadline = time.time() + 30
            while not path.exists() and time.time() < deadline:
                time.sleep(0.01)
            raise _Killed(rounds)

    with pytest.raises(_Killed):
        tsdg.run_chunked(state, cfg, max_rounds=40, chunk=4,
                         checkpoint_path=str(path),
                         checkpoint_every_chunks=1,
                         progress=kill_after_save, device="cpu")
    resumed = tck.restore_checkpoint(str(path), _streaming()[0],
                                     device="cpu")
    saved_round = int(resumed.dag.base.round)
    assert saved_round == min(boundaries) == 4
    _assert_leaves_equal(_port_leaves(resumed), boundaries[saved_round])
    final = tsdg.run_chunked(resumed, cfg, max_rounds=40, chunk=4,
                             device="cpu")
    _assert_leaves_equal(_port_leaves(final), _port_leaves(full))
    assert not (tmp_path / "run.npz.tmp").exists()


def test_run_chunked_save_failure_warns_then_keeps_running(tmp_path,
                                                           monkeypatch):
    state, cfg = _streaming()
    calls = []
    real = tck.save_checkpoint

    def flaky(path, snapshot, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk full")
        real(path, snapshot, **kw)

    monkeypatch.setattr(tck, "save_checkpoint", flaky)
    path = str(tmp_path / "f.npz")
    with pytest.warns(RuntimeWarning, match="checkpoint save failed"):
        tsdg.run_chunked(state, cfg, max_rounds=24, chunk=2,
                         checkpoint_path=path, checkpoint_every_chunks=1,
                         progress=lambda r, s: time.sleep(0.05),
                         device="cpu")
    assert len(calls) >= 2 and (tmp_path / "f.npz").exists()


def test_run_chunked_no_save_ever_lands_raises(tmp_path, monkeypatch):
    state, cfg = _streaming()

    def broken(path, snapshot, **kw):
        raise OSError("read-only")

    monkeypatch.setattr(tck, "save_checkpoint", broken)
    with pytest.warns(RuntimeWarning), pytest.raises(OSError,
                                                     match="read-only"):
        tsdg.run_chunked(state, cfg, max_rounds=8, chunk=4,
                         checkpoint_path=str(tmp_path / "x.npz"),
                         checkpoint_every_chunks=1, device="cpu")


def test_unknown_state_kind_and_default_device(tmp_path):
    path, state = _saved_avalanche(tmp_path)
    with pytest.raises(TypeError, match="no checkpoint layout"):
        tck.save_checkpoint(path, dataclasses.make_dataclass("X", [])())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tck.restore_checkpoint(path, state)
