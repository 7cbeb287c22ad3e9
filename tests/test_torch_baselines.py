"""BASELINE configs 0, 3, 4, 5 and 6 through the port's workload builders
and entry points, against the JAX package on the same inputs.

Config 0 runs at its full 100 x 100 shape and must also meet the
reference's recorded result; configs 3 and 4 run at the suite's
`--quick` shapes.  Config 4 runs twice: on the reference's own weights
carried across (`jnp.exp(jax.random.normal(key(42)) * 0.5)`) and on the
port's (`workload.config4_weights`) handed to the JAX package.  Every
state leaf must be equal at the end.  Configs 5 and 6 run at the
suite's `--quick` shapes and must also give the JAX package's own result
there (`workload.REFERENCE_QUICK`).  Tolerance 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_avalanche_tpu.config import AdversaryStrategy as JaxStrategy
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import avalanche as jav
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.ops import voterecord as jvr
from go_avalanche_tpu_torch import workload
from go_avalanche_tpu_torch.models import avalanche as tav
from go_avalanche_tpu_torch.models import dag as tdag
from go_avalanche_tpu_torch.ops import voterecord as vr
from test_torch_avalanche import _jax_numpy, assert_states_equal
from test_torch_dag import assert_dag_states_equal


def _fields_equal(jcfg, tcfg):
    for field in tcfg.__dataclass_fields__:
        want, got = getattr(jcfg, field), getattr(tcfg, field)
        assert getattr(want, "value", want) == getattr(got, "value", got), \
            field


def test_config0_matches_jax_and_the_record():
    jcfg = JaxConfig()
    jfinal = jav.run(jav.init(jax.random.key(0), 100, 100, jcfg), jcfg,
                     max_rounds=2000)
    tstate, tcfg = workload.config0_state(device="cpu")
    _fields_equal(jcfg, tcfg)
    tfinal = tav.run(tstate, tcfg, max_rounds=2000, device="cpu")
    assert_states_equal(jfinal, tfinal, "config 0")
    fin = vr.has_finalized(tfinal.records.confidence, tcfg)
    fat = tfinal.finalized_at.numpy()
    got = {"rounds": int(tfinal.round),
           "nodes_fully_finalized": int(fin.all(dim=1).sum()),
           "finality_median": float(np.median(fat[fat >= 0]))}
    assert got == workload.REFERENCE["config0"]


@pytest.mark.parametrize("strategy", ["flip", "equivocate"])
def test_config3_quick_matches_jax(strategy):
    n, t, max_rounds = workload.config3_shape(quick=True)
    assert (n, t, max_rounds) == (512, 64, 400)
    jcfg = JaxConfig(byzantine_fraction=0.2, flip_probability=1.0,
                     adversary_strategy=JaxStrategy(strategy),
                     max_element_poll=max(4096, t))
    jstate = jdag.init(jax.random.key(0), n,
                       jnp.arange(t, dtype=jnp.int32) // 2, jcfg)
    tstate, tcfg = workload.config3_states(quick=True,
                                           device="cpu")[strategy]
    _fields_equal(jcfg, tcfg)
    assert_dag_states_equal(jstate, tstate, "config 3 init")
    jfinal = jdag.run(jstate, jcfg, max_rounds=max_rounds)
    tfinal = tdag.run(tstate, tcfg, max_rounds=max_rounds, device="cpu")
    assert_dag_states_equal(jfinal, tfinal, f"config 3 {strategy}")


def _jax_config4(weights, n, t):
    jcfg = JaxConfig(weighted_sampling=True, churn_probability=1e-4,
                     max_element_poll=max(4096, t))
    jstate = jav.init(jax.random.key(0), n, t, jcfg,
                      latency_weights=jnp.asarray(weights, jnp.float32))
    return jav.run(jstate, jcfg, max_rounds=2000), jcfg


@pytest.mark.parametrize("weights_from", ["jax", "port"])
@pytest.mark.parametrize("engine", ["phased", "megakernel"])
def test_config4_quick_matches_jax(weights_from, engine):
    n, t = 512, 32
    if weights_from == "jax":
        weights = np.array(jnp.exp(jax.random.normal(
            jax.random.key(42), (n,)) * 0.5).astype(jnp.float32))
    else:
        weights = workload.config4_weights(n).numpy()
    jfinal, jcfg = _jax_config4(weights, n, t)
    tstate, tcfg = workload.config4_state(
        quick=True, device="cpu", weights=torch.from_numpy(weights))
    _fields_equal(jcfg, tcfg)
    tfinal = tav.run(tstate, dataclasses.replace(tcfg, round_engine=engine),
                     max_rounds=2000, device="cpu")
    assert_states_equal(jfinal, tfinal, f"config 4 {weights_from}")


def test_config4_default_weights_are_the_ports():
    state, _ = workload.config4_state(quick=True, device="cpu")
    np.testing.assert_array_equal(state.latency_weight.numpy(),
                                  workload.config4_weights(512).numpy())


def config4_full_shape_gate() -> dict:
    """The JAX package's `avalanche.run` at config 4's full 100000 x 256
    shape on the CPU, on the port's weights and on jax's own: the
    numbers config 4's gate rests on (`workload.REFERENCE`)."""
    n, t = 100_000, 256
    out = {}
    for name, weights in (
            ("port_weights", workload.config4_weights(n).numpy()),
            ("jax_weights", np.array(jnp.exp(jax.random.normal(
                jax.random.key(42), (n,)) * 0.5).astype(jnp.float32)))):
        final, cfg = _jax_config4(weights, n, t)
        fin = np.asarray(jvr.has_finalized(final.records.confidence, cfg))
        fat = np.asarray(final.finalized_at)
        out[name] = {"rounds": int(final.round),
                     "unfinalized_records": int((~fin).sum()),
                     "finalized_fraction": float(fin.mean()),
                     "finality_median": float(np.median(fat[fat >= 0]))}
    return out


def test_config5_quick_matches_jax_and_its_result():
    from go_avalanche_tpu.models import backlog as jbl
    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.models import backlog as tbl
    from test_torch_backlog import assert_trees_equal

    n, b, w = workload.config5_shape(quick=True)
    jcfg = JaxConfig(gossip=False, max_element_poll=w)
    jstate = jbl.init(jax.random.key(0), n, w, jbl.make_backlog(
        jax.random.randint(jax.random.key(1), (b,), 0, 1 << 20)), jcfg)
    tstate, tcfg = workload.config5_state(quick=True, device="cpu")
    _fields_equal(jcfg, tcfg)
    assert_trees_equal(_jax_numpy(jstate),
                       convert.backlog_state_to_numpy(tstate), "init")
    jfinal = jax.jit(jbl.run, static_argnames=("cfg", "max_rounds"))(
        jstate, jcfg, 200_000)
    tfinal = tbl.run(tstate, tcfg, max_rounds=200_000, device="cpu")
    assert_trees_equal(_jax_numpy(jfinal),
                       convert.backlog_state_to_numpy(tfinal), "config 5")
    got = {"rounds": int(tfinal.sim.round),
           "txs_settled_fraction": float(
               tfinal.outputs.settled.double().mean())}
    assert got == workload.REFERENCE_QUICK["config5"]


def test_config6_quick_matches_jax_and_its_result():
    from benchmarks.workload import QUICK, northstar_state
    from go_avalanche_tpu.models import streaming_dag as jsd
    from go_avalanche_tpu_torch import convert
    from go_avalanche_tpu_torch.models import streaming_dag as tsd
    from test_torch_backlog import assert_trees_equal

    assert workload.QUICK == QUICK
    jstate, jcfg = northstar_state(**QUICK)
    tstate, tcfg = workload.northstar_state(**workload.QUICK, device="cpu")
    _fields_equal(jcfg, tcfg)
    assert_trees_equal(_jax_numpy(jstate),
                       convert.streaming_dag_state_to_numpy(tstate), "init")
    jfinal = jsd.run_chunked(jstate, jcfg, max_rounds=500_000, chunk=64)
    tfinal = tsd.run_chunked(tstate, tcfg, max_rounds=500_000, chunk=64,
                             device="cpu")
    assert_trees_equal(_jax_numpy(jfinal),
                       convert.streaming_dag_state_to_numpy(tfinal),
                       "config 6")
    summary = tsd.resolution_summary(tfinal)
    got = {"rounds": int(tfinal.dag.base.round), **summary}
    want = workload.REFERENCE_QUICK["config6"]
    assert {key: got[key] for key in want} == want


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_baselines.py
    # (~10 s and ~1.5 GB on the CPU; not part of the test run).
    import json

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(config4_full_shape_gate()))
