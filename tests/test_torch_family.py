"""Slush and Snowflake trajectories of the port against the JAX
reference, at the reference's own test shapes (`tests/test_family.py`).

The port's `init` must build the reference's state from the same key,
and `slush_run` / `snowflake_run` must end in the same state, with the
same per-round telemetry for Slush.  Each is also run from the JAX
state carried across.  Tolerance 0.
"""

import jax
import numpy as np
import pytest

from go_avalanche_tpu.models import family as jfam
from go_avalanche_tpu_torch import convert, prng
from go_avalanche_tpu_torch.models import family as tfam
from test_torch_avalanche import _configs, _jax_numpy


def assert_states_equal(jstate, tstate, where):
    want = _jax_numpy(jstate)
    got = convert.family_state_to_numpy(tstate)
    for field in got._fields:
        w, g = getattr(want, field), getattr(got, field)
        assert w.dtype == g.dtype, (where, field, w.dtype, g.dtype)
        np.testing.assert_array_equal(w, g, err_msg=f"{where} {field}")


SLUSH = {                     # seed, nodes, yes_fraction, config knobs
    "even_split": (0, 512, 0.5, dict()),
    "biased_split": (1, 512, 0.9, dict()),
    "faults": (6, 200, 0.5, dict(byzantine_fraction=0.2,
                                 adversary_strategy="equivocate",
                                 drop_probability=0.1,
                                 churn_probability=0.02)),
    "oppose": (7, 128, 0.6, dict(byzantine_fraction=0.1,
                                 adversary_strategy="oppose_majority")),
}

SNOWFLAKE = {                 # seed, nodes, yes_fraction, knobs, max rounds
    "unanimous": (2, 256, 1.0, dict(finalization_score=16), 2000),
    "split": (3, 256, 0.5, dict(finalization_score=8), 4000),
    "drops": (4, 128, 1.0, dict(finalization_score=8,
                                drop_probability=0.15), 4000),
    "byzantine": (5, 256, 1.0, dict(finalization_score=8,
                                    byzantine_fraction=0.1), 4000),
    "deterministic": (9, 64, 0.5, dict(finalization_score=8), 2000),
    "churn_oppose": (8, 96, 0.5, dict(finalization_score=8,
                                      byzantine_fraction=0.2,
                                      adversary_strategy="oppose_majority",
                                      churn_probability=0.01), 300),
}


@pytest.mark.parametrize("case", list(SLUSH))
def test_slush_matches_jax(case):
    seed, n, yes, knobs = SLUSH[case]
    jcfg, tcfg = _configs(knobs)
    jstate = jfam.slush_init(jax.random.key(seed), n, jcfg, yes_fraction=yes)
    tstate = tfam.slush_init(prng.key(seed, "cpu"), n, tcfg,
                             yes_fraction=yes, device="cpu")
    assert_states_equal(jstate, tstate, "init")
    jfinal, jtel = jax.jit(jfam.slush_run,
                           static_argnames=("cfg", "m_rounds"))(jstate, jcfg,
                                                                80)
    for start in (tstate, convert.family_state_from_numpy(
            "slush", _jax_numpy(jstate), device="cpu")):
        tfinal, ttel = tfam.slush_run(start, tcfg, 80, device="cpu")
        assert_states_equal(jfinal, tfinal, "slush_run")
        for field in jtel._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jtel, field)),
                                          getattr(ttel, field).numpy())


@pytest.mark.parametrize("case", list(SNOWFLAKE))
def test_snowflake_matches_jax(case):
    seed, n, yes, knobs, max_rounds = SNOWFLAKE[case]
    jcfg, tcfg = _configs(knobs)
    jstate = jfam.snowflake_init(jax.random.key(seed), n, jcfg,
                                 yes_fraction=yes)
    tstate = tfam.snowflake_init(prng.key(seed, "cpu"), n, tcfg,
                                 yes_fraction=yes, device="cpu")
    assert_states_equal(jstate, tstate, "init")
    jfinal = jax.jit(jfam.snowflake_run,
                     static_argnames=("cfg", "max_rounds"))(jstate, jcfg,
                                                            max_rounds)
    tfinal = tfam.snowflake_run(tstate, tcfg, max_rounds, device="cpu")
    assert_states_equal(jfinal, tfinal, "snowflake_run")
    assert int(tfinal.round) > 0


def test_snowflake_round_telemetry_matches_jax():
    jcfg, tcfg = _configs(dict(finalization_score=6, drop_probability=0.1))
    jstate = jfam.snowflake_init(jax.random.key(12), 80, jcfg)
    tstate = convert.family_state_from_numpy("snowflake", _jax_numpy(jstate),
                                             device="cpu")
    step = jax.jit(lambda s: jfam.snowflake_round(s, jcfg))
    for r in range(25):
        jstate, jtel = step(jstate)
        tstate, ttel = tfam.snowflake_round(tstate, tcfg)
        for field in jtel._fields:
            assert int(getattr(jtel, field)) == int(getattr(ttel, field)), (
                r, field)
    assert_states_equal(jstate, tstate, "round 25")
