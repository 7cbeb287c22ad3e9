"""The port's megakernel seam against the JAX reference's `fused_round`.

On the CPU the port's `fused_round` runs its plain version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_megakernel.py
does.  Inputs are made with numpy from a seed.  Tolerance 0: records and
`changed` compared bit for bit.  The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py and
`chip_smoke.py`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import megakernel as jmk
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu.ops.bitops import pack_bool_plane as jpack
from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig
from go_avalanche_tpu_torch.ops import megakernel as mk
from go_avalanche_tpu_torch.ops import voterecord as vr
from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

# The cases of tests/test_megakernel.py: (knobs, n, t).
CASES = {
    "base": (dict(), 64, 512),
    "flip": (dict(byzantine_fraction=0.2), 64, 512),
    "oppose": (dict(byzantine_fraction=0.25,
                    adversary_strategy="oppose_majority"), 64, 512),
    "k3q2": (dict(k=3, quorum=2), 64, 512),
    "t1184": (dict(), 96, 1184),
    "score7fff": (dict(finalization_score=0x7FFF), 64, 512),
    "k1w3q2": (dict(k=1, window=3, quorum=2), 64, 512),
    "t2080": (dict(), 40, 2080),
}


def _configs(knobs):
    strategy = knobs.get("adversary_strategy")
    rest = {k: v for k, v in knobs.items() if k != "adversary_strategy"}
    jkw, tkw = dict(rest), dict(rest)
    if strategy:
        jkw["adversary_strategy"] = JaxStrategy(strategy)
        tkw["adversary_strategy"] = AdversaryStrategy(strategy)
    return (JaxConfig(round_engine="megakernel", **jkw),
            AvalancheConfig(round_engine="megakernel", **tkw))


def make_inputs(rng, n, t, cfg):
    """numpy inputs of one round; lies only where the config attacks."""
    wm = (1 << cfg.window) - 1
    counter = np.where(rng.random((n, t)) < 0.5,
                       rng.integers(0, 0x8000, (n, t)),
                       cfg.finalization_score - rng.integers(-2, 9, (n, t)))
    counter = np.clip(counter, 0, 0x7FFF)
    return dict(
        votes=rng.integers(0, 256, (n, t), dtype=np.uint8) & wm,
        consider=rng.integers(0, 256, (n, t), dtype=np.uint8) & wm,
        confidence=((counter << 1) | rng.integers(0, 2, (n, t))
                    ).astype(np.uint16),
        prefs=rng.random((n, t)) < 0.5,
        peers=rng.integers(0, n, (n, cfg.k)).astype(np.int32),
        responded=rng.random((n, cfg.k)) < 0.85,
        lie=(rng.random((n, cfg.k)) < 0.4) & (cfg.byzantine_fraction > 0),
        minority=rng.random(t) < 0.5,
        polled=rng.random((n, t)) < 0.7,
    )


def run_jax(x, cfg):
    recs = jvr.VoteRecordState(jnp.asarray(x["votes"]),
                               jnp.asarray(x["consider"]),
                               jnp.asarray(x["confidence"]))
    out, changed = jmk.fused_round(
        recs, jpack(jnp.asarray(x["prefs"])), jnp.asarray(x["peers"]),
        jnp.asarray(x["responded"]), jnp.asarray(x["lie"]),
        jnp.asarray(x["minority"]), jnp.asarray(x["polled"]), cfg)
    return ([np.asarray(out.votes), np.asarray(out.consider),
             np.asarray(out.confidence)], np.asarray(changed))


def torch_args(x, device="cpu"):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    recs = vr.VoteRecordState(t(x["votes"]), t(x["consider"]),
                              t(x["confidence"].view(np.int16)))
    return (recs, pack_bool_plane(t(x["prefs"])), t(x["peers"]),
            t(x["responded"]), t(x["lie"]), t(x["minority"]), t(x["polled"]))


def as_numpy(out, changed):
    return ([out.votes.cpu().numpy(), out.consider.cpu().numpy(),
             out.confidence.cpu().numpy().view(np.uint16)],
            changed.cpu().numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_round_matches_jax(case):
    knobs, n, t = CASES[case]
    jcfg, tcfg = _configs(knobs)
    x = make_inputs(np.random.default_rng(sorted(CASES).index(case)), n, t,
                    tcfg)
    want_planes, want_changed = run_jax(x, jcfg)
    got_planes, got_changed = as_numpy(*mk.fused_round(*torch_args(x),
                                                       tcfg))
    for name, w, g in zip(("votes", "consider", "confidence"), want_planes,
                          got_planes):
        np.testing.assert_array_equal(w, g, err_msg=name)
    np.testing.assert_array_equal(want_changed, got_changed)


def test_plain_path_does_not_count_launches():
    knobs, n, t = CASES["base"]
    _, tcfg = _configs(knobs)
    before = mk.launches
    mk.fused_round(*torch_args(make_inputs(np.random.default_rng(5), 8, 32,
                                           tcfg)), tcfg)
    assert mk.launches == before


@pytest.mark.parametrize("plane", ["votes", "consider", "confidence",
                                   "polled"])
def test_launch_rejects_record_planes_off_16_bytes(plane):
    """The kernel reads each record plane as 16-byte chunks: a plane that
    starts 8 bytes into its storage is refused before any launch."""
    _, tcfg = _configs({})
    records, *rest = torch_args(make_inputs(np.random.default_rng(6), 8, 64,
                                            tcfg))
    planes = dict(records._asdict(), polled=rest[-1])
    src = planes[plane]
    shifted = torch.zeros(src.numel() * src.element_size() + 8,
                          dtype=torch.uint8)[8:].view(src.dtype)
    planes[plane] = shifted.view(src.shape).copy_(src)
    assert planes[plane].data_ptr() % 16 == 8
    records = vr.VoteRecordState(planes["votes"], planes["consider"],
                                 planes["confidence"])
    before = mk.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        mk._launch(records, *rest[:-1], planes["polled"], tcfg)
    assert mk.launches == before


def test_fused_round_rejects_bad_shapes():
    cfg = AvalancheConfig()
    x = make_inputs(np.random.default_rng(0), 8, 40, cfg)   # t % 32 != 0
    with pytest.raises(ValueError, match="divide by 32"):
        mk.fused_round(*torch_args(x), cfg)
    cfg9 = dataclasses.replace(cfg, k=9)
    x9 = make_inputs(np.random.default_rng(0), 8, 32, cfg9)
    with pytest.raises(ValueError, match=r"k must be in \(0, 8\]"):
        mk.fused_round(*torch_args(x9), cfg9)


@pytest.mark.parametrize("kwargs,match", [
    (dict(latency_mode="fixed", latency_rounds=2), "synchronous round only"),
    (dict(inflight_engine="coalesced"), "inflight_engine"),
    (dict(adversary_policy="split_vote", byzantine_fraction=0.2),
     "adversary_policy"),
    (dict(skip_absent_votes=True), "skip_absent_votes"),
    (dict(byzantine_fraction=0.2, adversary_strategy="equivocate"),
     "EQUIVOCATE"),
    (dict(vote_mode="majority"), "SEQUENTIAL"),
    (dict(round_engine="warp"), "phased.*megakernel"),
])
def test_config_rejections_match_jax(kwargs, match):
    from go_avalanche_tpu.config import VoteMode as JaxVoteMode
    from go_avalanche_tpu_torch.config import VoteMode

    def build(config_cls, strategy_cls, mode_cls):
        kw = dict(round_engine="megakernel")
        kw.update(kwargs)
        if "adversary_strategy" in kw:
            kw["adversary_strategy"] = strategy_cls(kw["adversary_strategy"])
        if "vote_mode" in kw:
            kw["vote_mode"] = mode_cls(kw["vote_mode"])
        return config_cls(**kw)

    with pytest.raises(ValueError, match=match):
        build(JaxConfig, JaxStrategy, JaxVoteMode)
    with pytest.raises(ValueError, match=match):
        build(AvalancheConfig, AdversaryStrategy, VoteMode)


@pytest.mark.parametrize("kwargs", [
    dict(strict_validation=True), dict(fused_sharded_gossip=True),
])
def test_unported_fields_raise_not_implemented(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AvalancheConfig(**kwargs)


@pytest.mark.parametrize("field", ["metrics_every", "trace_every"])
def test_tap_strides_validate_as_jax(field):
    """The two telemetry taps' strides, once refused as unported, are
    accepted and validated with the reference's rule and message."""
    for value in (0, 1, 3):
        assert getattr(AvalancheConfig(**{field: value}), field) == value
        JaxConfig(**{field: value})
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**{field: -1})
    with pytest.raises(ValueError) as terr:
        AvalancheConfig(**{field: -1})
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kwargs", [
    dict(stream_retire_cap=8), dict(stream_retire_cap=0),
    dict(active_nodes=8), dict(registry_nodes=8),
    dict(stake_mode="zipf", registry_nodes=8, active_nodes=4),
    dict(arrival_mode="poisson"),
    dict(arrival_mode="poisson", arrival_rate=2.0),
    dict(arrival_mode="diurnal", arrival_rate=2.0, arrival_period=24,
         arrival_depth=1.5),
])
def test_streaming_fields_validate_as_jax(kwargs):
    """The streaming schedulers' fields (ROADMAP.md Queue 1 item 12) are
    ported: each kwargs set is rejected with ValueError by both configs,
    or accepted by both."""
    def outcome(config_cls):
        try:
            config_cls(**kwargs)
        except ValueError:
            return "ValueError"
        return "accepted"

    assert outcome(AvalancheConfig) == outcome(JaxConfig)
