"""The port's SWAR lane primitives and swar32 ingest engine against the
JAX reference (`go_avalanche_tpu/ops/swar.py`,
`voterecord.register_packed_votes_swar`, `_confidence_closed_form`).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance 0: every output is an integer plane compared bit for bit
(words as uint32, confidence as uint16).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.ops import swar as jswar
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.ops import swar
from go_avalanche_tpu_torch.ops import voterecord as vr


def _words(x: torch.Tensor) -> np.ndarray:
    """Port words (uint32 values in int64) as numpy uint32."""
    return x.numpy().astype(np.uint32)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# ops/swar.py primitives
# ---------------------------------------------------------------------------

def test_pack_lane_order_is_little_endian():
    x = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.uint8)
    want = np.asarray(jswar.pack_u8_lanes(jnp.asarray(x)))
    got = _words(swar.pack_u8_lanes(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([0x04030201, 0x08070605],
                                                np.uint32))


@pytest.mark.parametrize("t", [1, 3, 4, 7, 8, 13])
def test_pack_unpack_roundtrip_ragged(t):
    rng = np.random.default_rng(t)
    x = rng.integers(0, 256, (5, t), dtype=np.uint8)
    want = np.asarray(jswar.pack_u8_lanes(jnp.asarray(x)))
    w = swar.pack_u8_lanes(torch.from_numpy(x))
    assert tuple(w.shape) == (5, -(-t // 4))
    np.testing.assert_array_equal(_words(w), want)
    np.testing.assert_array_equal(swar.unpack_u8_lanes(w, t).numpy(), x)
    np.testing.assert_array_equal(
        swar.unpack_u8_lanes(w, t).numpy(),
        np.asarray(jswar.unpack_u8_lanes(jnp.asarray(want), t)))


def test_pack_of_views_matches_jax():
    """A plane that starts off a word boundary, and a stride-0 broadcast
    view, pack like the plain plane."""
    rng = np.random.default_rng(2)
    flat = rng.integers(0, 256, 5 * 12 + 1, dtype=np.uint8)
    x = flat[1:].reshape(5, 12)
    want = np.asarray(jswar.pack_u8_lanes(jnp.asarray(x)))
    view = torch.from_numpy(flat)[1:].reshape(5, 12)
    assert view.storage_offset() == 1
    np.testing.assert_array_equal(_words(swar.pack_u8_lanes(view)), want)
    col = rng.integers(0, 256, (5, 1), dtype=np.uint8)
    np.testing.assert_array_equal(
        _words(swar.pack_u8_lanes(torch.from_numpy(col).expand(5, 12))),
        np.asarray(jswar.pack_u8_lanes(jnp.broadcast_to(jnp.asarray(col),
                                                        (5, 12)))))


def test_expand_lane_mask_matches_jax():
    rng = np.random.default_rng(11)
    w = _u32(rng, (6, 4)) & np.uint32(0x01000100)
    want = np.asarray(jswar.expand_lane_mask(jnp.asarray(w), 15))
    got = swar.expand_lane_mask(torch.from_numpy(w.astype(np.int64)), 15)
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount8_lanes_matches_jax():
    x = _u32(np.random.default_rng(0), 256)
    want = np.asarray(jswar.popcount8_lanes(jnp.asarray(x)))
    got = swar.popcount8_lanes(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(_words(got), want)


@pytest.mark.parametrize("threshold", [0, 3, 6, 7])
def test_lane_gt_matches_jax(threshold):
    # Lane values in the counters' range [0, 8]; lane 3 up to 8 sets
    # bit 31 of the biased word.
    lanes = np.random.default_rng(threshold).integers(0, 9, (64, 4),
                                                      dtype=np.uint8)
    w = lanes.view(np.uint32).reshape(-1)
    want = np.asarray(jswar.lane_gt(jnp.asarray(w), threshold))
    got = _words(swar.lane_gt(torch.from_numpy(w.astype(np.int64)),
                              threshold))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.uint8).reshape(-1, 4),
                                  np.where(lanes > threshold, 0x80, 0))


def test_lane_fill_shl1_and_const_match_jax():
    bits = np.array([0x00010001, 0x01010101, 0], np.uint32)
    w = np.array([0x80808080, 0xFFFFFFFF, 0x7F7F7F7F], np.uint32)
    tb = torch.from_numpy(bits.astype(np.int64))
    tw = torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(
        _words(swar.lane_fill(tb)), np.asarray(jswar.lane_fill(
            jnp.asarray(bits))))
    np.testing.assert_array_equal(
        _words(swar.lane_shl1(tw, tb)),
        np.asarray(jswar.lane_shl1(jnp.asarray(w), jnp.asarray(bits))))
    for byte in (0, 0x7F, 0xFF):
        assert swar.lane_const(byte) == int(jswar.lane_const(byte))
    assert swar.LANE_LSB == int(jswar.LANE_LSB)
    assert swar.LANE_MSB == int(jswar.LANE_MSB)
    with pytest.raises(ValueError, match="one byte"):
        swar.lane_const(0x100)
    with pytest.raises(ValueError, match="threshold"):
        swar.lane_gt(tw, 0x80)


# ---------------------------------------------------------------------------
# the swar32 engine and the closed form: a property matrix
# ---------------------------------------------------------------------------

SCORES = (1, 128, 0x7FFE, 0x7FFF)


def _case(rng, ndim, score, k, window, quorum, masked):
    shape = (tuple(int(x) for x in rng.integers(1, 28, 2)) if ndim == 2
             else (int(rng.integers(1, 40)),))
    conf = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    # Saturated 0x7FFF counters (both preferences) and the counters just
    # below the finalization score.
    sat = rng.random(shape) < 0.2
    conf[sat] = np.uint16(0xFFFE) + rng.integers(0, 2, int(sat.sum()))
    near = rng.random(shape) < 0.2
    conf[near] = ((np.clip(score - rng.integers(0, 9, int(near.sum())), 0,
                           0x7FFF) << 1)
                  | rng.integers(0, 2, int(near.sum()))).astype(np.uint16)
    recs = (rng.integers(0, 1 << window, shape).astype(np.uint8),
            rng.integers(0, 1 << window, shape).astype(np.uint8), conf)
    yes = rng.integers(0, 256, shape).astype(np.uint8)
    cons = rng.integers(0, 256, shape).astype(np.uint8)
    mask = rng.random(shape) < 0.8 if masked else None
    kw = dict(window=window, quorum=quorum, finalization_score=score, k=k)
    return recs, yes, cons, mask, kw


def _jax_state(votes, consider, confidence):
    return jvr.VoteRecordState(jnp.asarray(votes), jnp.asarray(consider),
                               jnp.asarray(confidence))


def _torch_state(votes, consider, confidence):
    return vr.VoteRecordState(torch.from_numpy(votes.copy()),
                              torch.from_numpy(consider.copy()),
                              torch.from_numpy(confidence.view(np.int16)
                                               .copy()))


def _assert_same(jout, tout):
    (js, jc), (ts, tc) = jout, tout
    np.testing.assert_array_equal(np.asarray(js.votes), ts.votes.numpy())
    np.testing.assert_array_equal(np.asarray(js.consider),
                                  ts.consider.numpy())
    np.testing.assert_array_equal(np.asarray(js.confidence),
                                  ts.confidence.numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


# k 1..8 with window / quorum corners (full window, quorum == window,
# quorum 1, a one-vote window).
WINDOWS = {1: (8, 7), 2: (1, 1), 3: (3, 2), 4: (8, 8), 5: (6, 4),
           6: (8, 1), 7: (5, 5), 8: (8, 7)}


@pytest.mark.parametrize("k", sorted(WINDOWS))
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_register_packed_votes_swar_matches_jax(k, skip, masked):
    window, quorum = WINDOWS[k]
    rng = np.random.default_rng(100 * k + 10 * skip + masked)
    for i, score in enumerate(SCORES):
        recs, yes, cons, mask, kw = _case(rng, 2 - (i % 2), score, k,
                                          window, quorum, masked)
        want = jvr.register_packed_votes_swar(
            _jax_state(*recs), jnp.asarray(yes), jnp.asarray(cons), k,
            JaxConfig(**kw), None if mask is None else jnp.asarray(mask),
            absent_is_skip=skip)
        got = vr.register_packed_votes_swar(
            _torch_state(*recs), torch.from_numpy(yes),
            torch.from_numpy(cons), k, AvalancheConfig(**kw),
            None if mask is None else torch.from_numpy(mask),
            absent_is_skip=skip)
        _assert_same(want, got)
        # ... and the u8 engine gives the same bits.
        _assert_same(want, vr.register_packed_votes(
            _torch_state(*recs), torch.from_numpy(yes),
            torch.from_numpy(cons), k, AvalancheConfig(**kw),
            None if mask is None else torch.from_numpy(mask),
            absent_is_skip=skip))


@pytest.mark.parametrize("score", SCORES)
def test_confidence_closed_form_matches_jax(score):
    rng = np.random.default_rng(score)
    shape = (40, 33)
    conf = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    conf[:, :8] = np.uint16(0xFFFE) + rng.integers(0, 2, (40, 8))
    conf[:, 8:16] = ((np.clip(score - rng.integers(0, 9, (40, 8)), 0, 0x7FFF)
                      << 1) | rng.integers(0, 2, (40, 8))).astype(np.uint16)
    concl = rng.integers(0, 256, shape).astype(np.uint16)
    concl[rng.random(shape) < 0.2] = 0
    outcome16 = (concl << 8) | rng.integers(0, 256, shape).astype(np.uint16)
    jconf, jch = jvr._confidence_closed_form(
        jnp.asarray(conf), jnp.asarray(outcome16),
        JaxConfig(finalization_score=score))
    tconf, tch = vr._confidence_closed_form(
        torch.from_numpy(conf.view(np.int16).copy()),
        torch.from_numpy(outcome16.astype(np.int32)),
        AvalancheConfig(finalization_score=score))
    np.testing.assert_array_equal(np.asarray(jconf),
                                  tconf.numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(jch), tch.numpy())


@pytest.mark.parametrize("engine", ["u8", "swar32"])
def test_engine_dispatch_matches_jax(engine):
    rng = np.random.default_rng(5)
    recs, yes, cons, mask, kw = _case(rng, 2, 128, 8, 8, 7, True)
    want = jvr.register_packed_votes_engine(
        _jax_state(*recs), jnp.asarray(yes), jnp.asarray(cons), 8,
        JaxConfig(ingest_engine=engine, **kw), jnp.asarray(mask))
    got = vr.register_packed_votes_engine(
        _torch_state(*recs), torch.from_numpy(yes), torch.from_numpy(cons),
        8, AvalancheConfig(ingest_engine=engine, **kw),
        torch.from_numpy(mask))
    _assert_same(want, got)


def test_closed_form_finalization_crossing_corners():
    """The exact crossing, already past, not reached, saturated at
    score 0x7FFF (re-reports) and a flip there, on both engines."""
    full = np.array([0xFF], np.uint8)
    for score, counter0, votes_yes, want_changed in [
            (16, 15, True, True), (16, 16, True, False),
            (16, 4, True, False), (0x7FFF, 0x7FFF, True, True),
            (0x7FFF, 0x7FFF, False, True)]:
        conf = np.array([(counter0 << 1) | 1], np.uint16)
        yes = np.array([0xFF if votes_yes else 0], np.uint8)
        for engine in ("u8", "swar32"):
            cfg = AvalancheConfig(finalization_score=score, k=1,
                                  ingest_engine=engine)
            _, changed = vr.register_packed_votes_engine(
                _torch_state(full, full, conf), torch.from_numpy(yes),
                torch.from_numpy(full), 1, cfg)
            assert bool(changed[0]) == want_changed, (engine, score,
                                                      counter0, votes_yes)


def test_swar_rejects_k_above_8_and_config_accepts_swar32():
    state = vr.init_state(torch.zeros(4, dtype=torch.bool))
    pack = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"k must be in \(0, 8\]"):
        vr.register_packed_votes_swar(state, pack, pack, 9)
    assert AvalancheConfig(ingest_engine="swar32").ingest_engine == "swar32"
    with pytest.raises(ValueError, match="ingest_engine"):
        AvalancheConfig(ingest_engine="u4")


def test_register_votes_sequence_matches_jax():
    rng = np.random.default_rng(9)
    cfg = dataclasses.replace(AvalancheConfig(), finalization_score=5)
    jcfg = JaxConfig(finalization_score=5)
    shape = (6, 10)
    recs = (rng.integers(0, 256, shape).astype(np.uint8),
            rng.integers(0, 256, shape).astype(np.uint8),
            rng.integers(0, 24, shape).astype(np.uint16))
    errs = rng.integers(-1, 2, (12, *shape)).astype(np.int32)
    mask = rng.random(shape) < 0.7
    js, jch = jvr.register_votes_sequence(_jax_state(*recs),
                                          jnp.asarray(errs), jcfg,
                                          jnp.asarray(mask))
    ts, tch = vr.register_votes_sequence(_torch_state(*recs),
                                         torch.from_numpy(errs), cfg,
                                         torch.from_numpy(mask))
    assert tuple(tch.shape) == (12, *shape)
    _assert_same((js, jch), (ts, tch))
