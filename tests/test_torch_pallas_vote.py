"""The port's ingest dispatcher (`ops/pallas_vote.py`) against the JAX
reference's Pallas kernels and dispatcher.

On CPU tensors `register_packed_votes_fused` runs the port's plain
engines, which must give the bits of JAX's `register_packed_votes_pallas`
and `register_packed_votes_pallas_swar` in interpret mode at shapes the
Pallas blocks tile, and of JAX's `register_packed_votes_fused` at shapes
they do not tile (where it takes its jnp engines).  The consider pack
comes in both forms a round hands over: the fused exchange's stride-0
``[N, 1] -> [N, T]`` view and the legacy exchange's contiguous plane.
Inputs from numpy seeds; tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import pallas_vote as jpv
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import pallas_vote as pv
from go_avalanche_tpu_torch.ops import voterecord as vr

ENGINES = ("u8", "swar32")


def _inputs(seed, n, t, cfg, pack_form):
    rng = np.random.default_rng(seed)
    wm = (1 << cfg.window) - 1
    counter = np.where(rng.random((n, t)) < 0.5,
                       rng.integers(0, 0x8000, (n, t)),
                       np.clip(cfg.finalization_score
                               - rng.integers(-2, 9, (n, t)), 0, 0x7FFF))
    conf = ((counter << 1) | rng.integers(0, 2, (n, t))).astype(np.uint16)
    votes = rng.integers(0, 256, (n, t), dtype=np.uint8) & wm
    consider = rng.integers(0, 256, (n, t), dtype=np.uint8) & wm
    yes = rng.integers(0, 256, (n, t), dtype=np.uint8)
    col = rng.integers(0, 256, (n,), dtype=np.uint8)
    mask = rng.random((n, t)) < 0.7
    jax_in = (jvr.VoteRecordState(jnp.asarray(votes), jnp.asarray(consider),
                                  jnp.asarray(conf)),
              jnp.asarray(yes), jnp.broadcast_to(jnp.asarray(col)[:, None],
                                                 (n, t)),
              jnp.asarray(mask))
    if pack_form == "stride0":
        cons_pack = torch.from_numpy(col)[:, None].expand(n, t)
        assert cons_pack.stride() == (1, 0)
    else:
        cons_pack = torch.from_numpy(np.broadcast_to(col[:, None],
                                                     (n, t)).copy())
    torch_in = (vr.VoteRecordState(torch.from_numpy(votes),
                                   torch.from_numpy(consider),
                                   torch.from_numpy(conf.view(np.int16))),
                torch.from_numpy(yes), cons_pack, torch.from_numpy(mask))
    return jax_in, torch_in


def _assert_same(jout, tout):
    (js, jc), (ts, tc) = jout, tout
    np.testing.assert_array_equal(np.asarray(js.votes), ts.votes.numpy())
    np.testing.assert_array_equal(np.asarray(js.consider),
                                  ts.consider.numpy())
    np.testing.assert_array_equal(np.asarray(js.confidence),
                                  ts.confidence.numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


def _run_port(torch_in, cfg):
    state, yes, cons, mask = torch_in
    before = dict(pv.launches)
    out = pv.register_packed_votes_fused(state, yes, cons, cfg.k, cfg, mask)
    assert pv.launches == before     # CPU tensors launch nothing
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(64, 512), (128, 1024)])
@pytest.mark.parametrize("pack_form", ["stride0", "plane"])
def test_cpu_route_matches_pallas_interpret(engine, shape, pack_form):
    n, t = shape
    kw = dict(ingest_engine=engine)
    jcfg, tcfg = JaxConfig(**kw), AvalancheConfig(**kw)
    jax_in, torch_in = _inputs(n + t, n, t, tcfg, pack_form)
    state, yes, cons, mask = jax_in
    launcher = (jpv.register_packed_votes_pallas_swar if engine == "swar32"
                else jpv.register_packed_votes_pallas)
    want = launcher(state, yes, cons, jcfg.k, jcfg, mask, interpret=True)
    _assert_same(want, _run_port(torch_in, tcfg))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(3, 7), (100, 1000), (10, 1001)])
@pytest.mark.parametrize("pack_form", ["stride0", "plane"])
def test_cpu_route_matches_jax_dispatcher_untileable(engine, shape,
                                                     pack_form):
    n, t = shape
    kw = dict(ingest_engine=engine, k=3, quorum=2, window=3,
              finalization_score=9)
    jcfg, tcfg = JaxConfig(**kw), AvalancheConfig(**kw)
    jax_in, torch_in = _inputs(n * t, n, t, tcfg, pack_form)
    state, yes, cons, mask = jax_in
    want = jpv.register_packed_votes_fused(state, yes, cons, jcfg.k, jcfg,
                                           mask, prefer_pallas=True)
    _assert_same(want, _run_port(torch_in, tcfg))


@pytest.mark.parametrize("engine", ENGINES)
def test_kernel_wrappers_run_plain_version_on_cpu(engine):
    cfg = AvalancheConfig(ingest_engine=engine, finalization_score=0x7FFF)
    _, (state, yes, cons, mask) = _inputs(3, 16, 40, cfg, "stride0")
    wrapper, plain = ((pv.register_packed_votes_cuda_swar,
                       pv.register_packed_votes_swar_plain)
                      if engine == "swar32" else
                      (pv.register_packed_votes_cuda,
                       pv.register_packed_votes_plain))
    before = dict(pv.launches)
    got = wrapper(state, yes, cons, cfg.k, cfg, mask)
    want = plain(state, yes, cons, cfg.k, cfg, mask)
    assert pv.launches == before
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("engine", ENGINES)
def test_skip_absent_votes_takes_the_engine(engine):
    """`skip_absent_votes` has no kernel in either package: the
    dispatcher runs the engine's skip semantics, as JAX's does."""
    kw = dict(ingest_engine=engine, skip_absent_votes=True)
    jcfg, tcfg = JaxConfig(**kw), AvalancheConfig(**kw)
    jax_in, torch_in = _inputs(4, 64, 512, tcfg, "plane")
    state, yes, cons, mask = jax_in
    want = jpv.register_packed_votes_fused(state, yes, cons, jcfg.k, jcfg,
                                           mask, prefer_pallas=True)
    _assert_same(want, _run_port(torch_in, tcfg))


def test_wrappers_refuse_other_devices():
    cfg = AvalancheConfig()
    meta = vr.VoteRecordState(
        torch.empty((4, 8), dtype=torch.uint8, device="meta"),
        torch.empty((4, 8), dtype=torch.uint8, device="meta"),
        torch.empty((4, 8), dtype=torch.int16, device="meta"))
    pack = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    for wrapper in (pv.register_packed_votes_cuda,
                    pv.register_packed_votes_cuda_swar):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            wrapper(meta, pack, pack, 8, cfg)
