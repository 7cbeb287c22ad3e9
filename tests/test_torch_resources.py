"""The port's resource plane (`obs/resources.py`) against the JAX one.

Per plane, `plane_bytes(..., dtypes="reference")` of a port state equals
the JAX package's `plane_bytes` of the same state (carried over with
`convert.py`, or its `jax.eval_shape`): the flagship, async, trace and
4-trial fleet families of `tests/test_resources.py` at two shapes, the
DAG, Snowball, backlog, streaming-DAG and node-stream states, and each
sharded driver's per-rank blocks on a 2x2 mesh.  `dtypes="device"`
differs only on the leaves `DEVICE_DTYPE_DIFFERENCES` names.
`check_memory` is held to a clean record and to planted clones on
synthetic records (the card's `memory_record` runs in `chip_smoke.py`).
Tolerance 0.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

from benchmarks.workload import flagship_state, fleet_flagship_state
from go_avalanche_tpu import parallel as jparallel
from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
from go_avalanche_tpu.models import backlog as jbl
from go_avalanche_tpu.models import dag as jdag
from go_avalanche_tpu.models import node_stream as jns
from go_avalanche_tpu.models import snowball as jsb
from go_avalanche_tpu.models import streaming_dag as jsd
from go_avalanche_tpu.obs import resources as jres
from go_avalanche_tpu.parallel import mesh as jmesh
from go_avalanche_tpu_torch import convert
from go_avalanche_tpu_torch.obs import resources
from test_torch_avalanche import _jax_numpy


def _flagship_family(family: str, nodes: int, txs: int):
    if family == "flagship":
        return flagship_state(nodes, txs, 8)[0]
    if family == "async":
        return flagship_state(nodes, txs, 8, 2,
                              inflight_engine="coalesced")[0]
    if family == "async_walk":
        return flagship_state(nodes, txs, 8, 2)[0]
    if family == "trace":
        return flagship_state(nodes, txs, 8, trace_every=2,
                              trace_rounds=8)[0]
    raise AssertionError(family)


def _dag():
    return jdag.init(jax.random.key(3), 16, jnp.arange(8) // 2,
                     JaxConfig(trace_every=1), n_sets=4, set_size=2)


def _snowball():
    return jsb.init(jax.random.key(4), 24, JaxConfig(latency_mode="fixed",
                                                     latency_rounds=1,
                                                     time_step_s=1.0,
                                                     request_timeout_s=3.0))


def _backlog():
    cfg = JaxConfig(arrival_mode="poisson", arrival_rate=4.0)
    return jbl.init(jax.random.key(5), 16, 8,
                    jbl.make_backlog(jnp.arange(24, dtype=jnp.int32)), cfg)


def _streaming_dag():
    scores = jax.random.randint(jax.random.key(9), (10, 2), 0, 1000)
    return jsd.init(jax.random.key(6), 16, 4, jsd.make_set_backlog(scores),
                    JaxConfig())


def _node_stream():
    cfg = JaxConfig(stake_mode="zipf", registry_nodes=24, active_nodes=8)
    return jns.init(jax.random.key(7), 4, cfg)


# family -> (JAX state builder, the port's `convert` carrier)
STATES = {
    **{(f, n, t): (lambda f=f, n=n, t=t: _flagship_family(f, n, t),
                   convert.state_from_numpy)
       for f in ("flagship", "async", "trace")
       for n, t in ((16, 8), (64, 32))},
    ("async_walk", 16, 8): (lambda: _flagship_family("async_walk", 16, 8),
                            convert.state_from_numpy),
    "dag": (_dag, convert.dag_state_from_numpy),
    "snowball": (_snowball, lambda tree, device: (
        convert.family_state_from_numpy("snowball", tree, device))),
    "backlog": (_backlog, convert.backlog_state_from_numpy),
    "streaming_dag": (_streaming_dag, convert.streaming_dag_state_from_numpy),
    "node_stream": (_node_stream, convert.node_stream_state_from_numpy),
}


def _pair(name):
    build, carry = STATES[name]
    jstate = build()
    return jstate, carry(_jax_numpy(jstate), device="cpu")


@pytest.mark.parametrize("name", list(STATES), ids=str)
def test_reference_dtypes_equal_jax_plane_for_plane(name):
    jstate, tstate = _pair(name)
    want = jres.plane_bytes(jax.eval_shape(lambda: jstate))
    got = resources.plane_bytes(tstate, dtypes="reference")
    assert got == want
    assert (resources.footprint(tstate, dtypes="reference")["total_bytes"]
            == jres.footprint(jstate)["total_bytes"])


@pytest.mark.parametrize("name", list(STATES), ids=str)
def test_device_dtypes_differ_only_on_listed_leaves(name):
    _, tstate = _pair(name)
    dev = resources.plane_bytes(tstate)
    ref = resources.plane_bytes(tstate, dtypes="reference")
    assert dev.keys() == ref.keys()
    differ = {p for p in dev if dev[p] != ref[p]}
    assert {p.rsplit(".", 1)[-1] for p in differ} <= set(
        resources.DEVICE_DTYPE_DIFFERENCES)
    # Every key the state holds: 16 B here, 8 B of key data there.
    assert all(dev[p] == 2 * ref[p] for p in differ)
    assert differ == {p for p in dev if p.endswith("key")}


def test_flagship_per_plane_bytes_pinned_like_the_reference():
    """The JAX pin of `tests/test_resources.py` (16 x 8), here in the
    port's device dtypes: the key is the one plane that differs."""
    _, tstate = _pair(("flagship", 16, 8))
    fp = resources.footprint(tstate)
    assert fp["planes"][".key"] == 16
    assert fp["total_bytes"] == 1364 + 8


@pytest.mark.parametrize("nodes,txs", [(16, 8), (64, 32)])
def test_fleet_is_trials_times_one_trial_like_the_stacked_reference(
        nodes, txs):
    """The reference's fleet stacks every leaf on a trial axis; the
    port's trial loop holds one trial, and 4 x its planes are the
    reference's layout (`run_sim --report-memory --fleet 4`)."""
    want = jres.footprint(jax.eval_shape(
        lambda: fleet_flagship_state(4, nodes, txs, 8)[0]))
    # The fleet's trial keys differ from the flagship's; shapes do not.
    _, one = _pair(("flagship", nodes, txs))
    planes = resources.plane_bytes(one, dtypes="reference")
    assert {path: 4 * n for path, n in planes.items()} == want["planes"]


def test_mesh_argument_forms_and_refusals():
    _, tstate = _pair(("flagship", 16, 8))
    from go_avalanche_tpu_torch.parallel import sharded

    specs = sharded.specs_of(tstate)
    as_dict = resources.plane_bytes(tstate, specs, {"nodes": 2, "txs": 2})
    as_mesh = resources.plane_bytes(
        tstate, specs, types.SimpleNamespace(shape={"nodes": 2, "txs": 2}))
    assert as_dict == as_mesh
    with pytest.raises(ValueError, match="specs without a mesh"):
        resources.plane_bytes(tstate, specs)
    with pytest.raises(ValueError, match="does not divide"):
        resources.plane_bytes(tstate, specs, {"nodes": 3, "txs": 2})
    with pytest.raises(ValueError, match="dtypes"):
        resources.plane_bytes(tstate, dtypes="host")


SHARDED = {"avalanche": (("flagship", 16, 8), "sharded"),
           # The walk engine's poll-mask ring is bool [D, N, T]; the
           # coalesced engine's bit-packed one is repacked per tx shard.
           "avalanche_async": (("async_walk", 16, 8), "sharded"),
           "dag": ("dag", "sharded_dag"),
           "backlog": ("backlog", "sharded_backlog"),
           "streaming_dag": ("streaming_dag", "sharded_streaming_dag"),
           "node_stream": ("node_stream", "sharded_node_stream")}


@pytest.mark.parametrize("driver", sorted(SHARDED))
def test_sharded_per_rank_bytes_equal_jax_on_2x2(driver):
    import importlib

    name, module = SHARDED[driver]
    jstate, tstate = _pair(name)
    jmesh_2x2 = jmesh.make_mesh(n_node_shards=2, n_tx_shards=2,
                                devices=jax.devices()[:4])
    state_abs = jax.eval_shape(lambda: jstate)
    want = jres.footprint(
        state_abs, jparallel._specs_for(driver.split("_async")[0],
                                        state_abs), jmesh_2x2)
    specs = importlib.import_module(
        f"go_avalanche_tpu_torch.parallel.{module}").specs_of(tstate)
    got = resources.footprint(tstate, specs, {"nodes": 2, "txs": 2},
                              dtypes="reference")
    assert got == want


# ------------------------------------------------------------ check_memory

TOTAL = 2_416_230_420     # the flagship's device footprint at 16384^2


def _record(arg=TOTAL, live=TOTAL):
    return {"argument_bytes": arg, "output_bytes": live,
            "shared_bytes": 0, "temp_bytes": 1 << 30, "live_bytes": live,
            "live_peak_bytes": arg + (1 << 30)}


def test_check_memory_clean_within_the_allocator_rounding():
    # 40 leaves rounded up to 512-byte blocks stay inside the tolerance.
    assert resources.check_memory(_record(TOTAL + 40 * 511,
                                          TOTAL + 40 * 511), TOTAL) == []
    assert resources.check_memory(_record(1400, 1400), 1372,
                                  abs_tol=4096) == []


def test_check_memory_catches_a_planted_clone_surviving_the_round():
    plane = 268_435_456       # one [16384, 16384] u8 plane
    failures = resources.check_memory(_record(live=TOTAL + plane), TOTAL,
                                      what="phased-u8")
    assert len(failures) == 1
    assert failures[0].startswith("phased-u8: live bytes after one round")
    assert f"{plane} bytes of state double-buffer" in failures[0]
    assert "unaccounted buffer clone" in failures[0]


def test_check_memory_catches_state_bytes_off_the_footprint():
    plane = 268_435_456
    over = resources.check_memory(_record(arg=TOTAL + plane), TOTAL)
    assert len(over) == 1 and "an unaccounted buffer rides the state" in \
        over[0]
    under = resources.check_memory(_record(arg=TOTAL - plane,
                                           live=TOTAL - plane), TOTAL)
    assert len(under) == 2
    assert "never reached the card" in under[0]
    assert "missing from the round's output" in under[1]
    tol = max(int(0.02 * 1000), 4096)
    assert f"(tol {tol})" in resources.check_memory(
        _record(9000, 1000), 1000)[0]


def test_memory_record_refuses_a_cpu_state():
    _, tstate = _pair(("flagship", 16, 8))
    with pytest.raises(ValueError, match="card's allocator"):
        resources.memory_record(lambda s: s, tstate)


def test_state_storages_count_whole_storages_once():
    _, tstate = _pair(("flagship", 16, 8))
    total = resources.footprint(tstate)["total_bytes"]

    def allocated(state):
        return sum(resources._storages(state).values())

    assert allocated(tstate) == total
    # A leaf viewing a larger buffer keeps the whole buffer alive; two
    # leaves on one storage count it once.
    big = torch.zeros(4 * 16 * 8, dtype=torch.uint8)
    viewing = tstate._replace(added=big.view(4, 16, 8)[0].view(torch.bool))
    shared = tstate._replace(added=tstate.records.votes.view(torch.bool))
    assert allocated(viewing) == total + 3 * 128
    assert allocated(shared) == total - 128


def test_banded_compare_is_the_reference_copy():
    a = {"argument_bytes": 10, "output_bytes": 10, "alias_bytes": 10,
         "temp_bytes": 1000, "generated_code_bytes": 100}
    for b in (dict(a), dict(a, temp_bytes=1050), dict(a, temp_bytes=2000),
              dict(a, alias_bytes=0)):
        assert resources.banded_compare(a, b) == jres.banded_compare(a, b)


# ---------------------------------------------------- run_sim --report-memory

RUN_SIM = ["--nodes", "16", "--txs", "8", "--slots", "4", "--max-rounds",
           "6", "--device", "cpu", "--json"]


@pytest.mark.parametrize("extra", [
    ["--model", "avalanche"], ["--model", "dag"], ["--model", "backlog"],
    ["--model", "avalanche", "--mesh", "1,1"],
    ["--model", "snowball", "--fleet", "4"]],
    ids=["avalanche", "dag", "backlog", "mesh", "fleet"])
def test_run_sim_report_memory_goes_to_stderr_and_keeps_the_result(
        extra, capsys):
    import json

    from go_avalanche_tpu_torch import run_sim

    run_sim.main(RUN_SIM + extra)
    plain = capsys.readouterr()
    assert plain.err == ""
    run_sim.main(RUN_SIM + extra + ["--report-memory"])
    reported = capsys.readouterr()

    def result(out):
        (line,) = out.strip().splitlines()
        return {k: v for k, v in json.loads(line).items()
                if k != "elapsed_s"}

    assert result(reported.out) == result(plain.out)
    err = reported.err.splitlines()
    assert err[0].startswith(f"memory report [{extra[1]}, ")
    assert err[1] == ("  no device ledger on the CPU: the analytic "
                      "footprint only")
    assert err[2].startswith("  analytic state footprint: ")
    if "--fleet" in extra:
        assert "4 x one trial" in reported.err
    if "--mesh" in extra:
        assert "per rank" in err[0]


def test_run_sim_report_memory_refusals_match_jax(capsys):
    from go_avalanche_tpu import run_sim as jrun_sim
    from go_avalanche_tpu_torch import run_sim

    for extra in (["--check-invariants"], ["--chunk", "2"],
                  ["--fleet", "2", "--phase-grid",
                   '{"byzantine_fraction": [0.1, 0.2]}']):
        argv = ["--model", "avalanche", "--report-memory"] + extra
        errs = []
        for main, dev in ((jrun_sim.main, []),
                          (run_sim.main, ["--device", "cpu"])):
            with pytest.raises(SystemExit):
                main(argv + dev)
            errs.append(capsys.readouterr().err.splitlines()[-1])
        assert errs[0] == errs[1], extra


# ------------------------------------------------ the sharded footprints


def test_footprint_cases_per_rank_bytes_equal_jax(tmp_path):
    """`parallel.footprint_cases` on the 2x2 audit mesh (4 gloo ranks):
    every driver's per-rank plane bytes, in the reference's dtypes,
    equal the JAX package's `parallel.footprint_cases` footprints."""
    from go_avalanche_tpu_torch.parallel.ranks import RankPool
    import torch_ranks

    want = {name: jres.footprint(case.state_abs, case.specs,
                                 case.mesh)["planes"]
            for name, case in jparallel.footprint_cases().items()}
    pool = RankPool(4, str(tmp_path))
    try:
        results = pool.run(4, torch_ranks.footprint_case)
    finally:
        pool.close()
    for got in results:
        assert got == want


def test_sharded_driver_records_refuse_the_cpu_and_a_single_rank():
    from go_avalanche_tpu_torch import parallel
    from go_avalanche_tpu_torch.analysis.audit import AuditUnavailable

    with pytest.raises(ValueError, match="reads the card's allocator"):
        resources.sharded_driver_records(device="cpu")
    with pytest.raises(AuditUnavailable, match="needs 4 ranks"):
        parallel.footprint_cases(device="cpu")
