"""The port's `run_sim` CLI against the JAX package's.

The same argv (plus ``--device cpu``) goes through both `main`s: the
result dicts must be equal apart from `backend` and `elapsed_s`, the
JSONL files of ``--metrics`` and ``--trace-out`` byte-equal, the parser's
refusals the same messages (`--audit`'s and `--fleet-shape`'s too).
`--audit` and `--fleet-shape auto` are held to their own contract (the
JAX package's `--audit` reads compiled XLA programs).  Shapes are tiny
so the JAX side compiles little.
"""

from __future__ import annotations

import json
import shutil

import pytest

from go_avalanche_tpu import run_sim as jrun
from go_avalanche_tpu_torch import run_sim as trun

SMALL = ["--nodes", "12", "--txs", "8", "--finalization-score", "8",
         "--max-rounds", "40", "--json"]


def _both(argv, capsys=None):
    want = jrun.main(list(argv))
    got = trun.main(list(argv) + ["--device", "cpu"])
    if capsys is not None:
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 2
        j_line, t_line = (json.loads(x) for x in lines)
        for d in (j_line, t_line):
            d.pop("elapsed_s"), d.pop("backend")
        assert t_line == j_line
    assert got["backend"] == "cpu"
    for d in (want, got):
        d.pop("elapsed_s"), d.pop("backend")
    assert got == want
    assert list(got) == list(want)
    return got


@pytest.mark.parametrize("argv", [
    ["--model", "slush", "--max-rounds", "12"],
    ["--model", "snowflake", "--max-rounds", "30"],
    ["--model", "snowball", "--yes-fraction", "0.7"],
    ["--model", "avalanche", "--contested", "--byzantine", "0.2"],
    ["--model", "dag", "--conflict-size", "4", "--drop", "0.1"],
    ["--model", "backlog", "--slots", "4", "--arrival-mode", "poisson",
     "--arrival-rate", "1.5"],
    ["--model", "streaming_dag", "--txs", "16", "--slots", "2"],
    ["--model", "node_stream", "--stake-mode", "zipf", "--registry-nodes",
     "24", "--active-nodes", "8", "--node-churn-rate", "0.1",
     "--max-rounds", "6"],
], ids=lambda a: a[1])
def test_every_model_matches(argv, capsys):
    _both(SMALL + argv, capsys)


def test_check_invariants_matches():
    got = _both(SMALL + ["--model", "avalanche", "--check-invariants",
                         "--latency-mode", "fixed", "--latency-rounds", "1"])
    assert got["invariant_checks"] > 0


def test_fleet_and_phase_grid_match(tmp_path):
    fleet = SMALL + ["--model", "snowball", "--fleet", "3",
                     "--byzantine", "0.25", "--adversary", "oppose_majority"]
    _both(fleet)
    metrics = str(tmp_path / "phase.jsonl")
    grid = SMALL + ["--model", "avalanche", "--fleet", "2", "--phase-grid",
                    json.dumps({"byzantine_fraction": [0.1, 0.3]}),
                    "--byzantine", "0.1", "--metrics", metrics]
    want = jrun.main(list(grid))
    with open(metrics) as fh:
        want_rows = [json.loads(x) for x in fh]
    got = trun.main(grid + ["--device", "cpu"])
    with open(metrics) as fh:
        got_rows = [json.loads(x) for x in fh]
    for d in (want, got):
        d.pop("elapsed_s"), d.pop("backend")
    assert got == want and got["phase_points"] == 2
    assert got_rows == want_rows


def test_chunked_checkpoint_resume_and_removal(tmp_path):
    base = SMALL + ["--model", "streaming_dag", "--txs", "24", "--slots",
                    "2", "--chunk", "1"]
    j_ckpt, t_ckpt = tmp_path / "j.npz", tmp_path / "t.npz"
    # capped after 8 chunks, the first save (every 8 chunks): each
    # package keeps its checkpoint
    capped = ["--max-rounds", "8"]
    _both_ckpt = []
    for main, path, extra in ((jrun.main, j_ckpt, []),
                              (trun.main, t_ckpt, ["--device", "cpu"])):
        res = main(base + capped + ["--checkpoint", str(path)] + extra)
        _both_ckpt.append(res)
        assert path.exists()
    for d in _both_ckpt:
        d.pop("elapsed_s"), d.pop("backend")
    assert _both_ckpt[0] == _both_ckpt[1]
    # the port resumes the JAX checkpoint, JAX the port's; drained runs
    # remove their checkpoint
    shutil.copy(j_ckpt, tmp_path / "from_jax.npz")
    shutil.copy(t_ckpt, tmp_path / "from_port.npz")
    want = jrun.main(base + ["--checkpoint", str(tmp_path / "from_port.npz")])
    got = trun.main(base + ["--checkpoint", str(tmp_path / "from_jax.npz"),
                            "--device", "cpu"])
    for d in (want, got):
        d.pop("elapsed_s"), d.pop("backend")
    assert got == want and got["sets_settled_fraction"] == 1.0
    assert not (tmp_path / "from_jax.npz").exists()
    assert not (tmp_path / "from_port.npz").exists()
    unchunked = trun.main(base[:-2] + ["--device", "cpu"])
    unchunked.pop("elapsed_s"), unchunked.pop("backend")
    assert unchunked == got


def test_metrics_tap_jsonl_matches(tmp_path):
    path = tmp_path / "m.jsonl"
    argv = SMALL + ["--model", "dag", "--metrics", str(path)]
    want = jrun.main(argv)
    # The JAX tap is an unordered callback: order its lines by round.
    want_lines = sorted(path.read_text().splitlines(),
                        key=lambda x: json.loads(x)["round"])
    got = trun.main(argv + ["--device", "cpu"])
    got_lines = path.read_text().splitlines()
    assert got_lines == want_lines and len(got_lines) == want["rounds"]
    for d in (want, got):
        d.pop("elapsed_s"), d.pop("backend")
    assert got == want and got["metrics_records"] == want["rounds"]


@pytest.mark.parametrize("model", ["snowball", "backlog"])
def test_trace_out_jsonl_byte_equal(tmp_path, model):
    out = tmp_path / "trace.jsonl"
    argv = SMALL + ["--model", model, "--slots", "4", "--trace-every", "2",
                    "--trace-out", str(out)]
    want = jrun.main(argv)
    want_bytes = out.read_bytes()
    got = trun.main(argv + ["--device", "cpu"])
    assert out.read_bytes() == want_bytes and want_bytes
    for d in (want, got):
        d.pop("elapsed_s"), d.pop("backend")
    assert got == want


REFUSALS = [
    ["--model", "dag", "--round-engine", "megakernel"],
    ["--round-engine", "megakernel", "--txs", "33"],
    ["--round-engine", "megakernel", "--latency-mode", "fixed"],
    ["--byzantine", "0", "--adversary", "equivocate"],
    ["--model", "slush", "--byzantine", "0.1", "--adversary-policy",
     "split_vote"],
    ["--fleet", "0"],
    ["--fleet", "4", "--model", "slush"],
    ["--fleet", "2", "--check-invariants"],
    ["--fleet", "2", "--model", "dag", "--txs", "7"],
    ["--phase-grid", '{"k": [4]}'],
    ["--fleet", "2", "--phase-grid", '{"bogus": [1]}'],
    ["--fleet", "2", "--phase-grid", '{"latency_rounds": [1, 2]}'],
    ["--fleet", "2", "--phase-grid", '{"byzantine_fraction": [0.0, 0.2]}',
     "--byzantine", "0.1", "--adversary", "oppose_majority"],
    ["--arrival-mode", "poisson", "--model", "avalanche"],
    ["--arrival-mode", "external", "--model", "backlog"],
    ["--stake-mode", "zipf", "--model", "snowball"],
    ["--stake-weights", "1,x"],
    ["--model", "node_stream"],
    ["--registry-nodes", "5"],
    ["--chunk", "4"],
    ["--model", "streaming_dag", "--chunk", "-1"],
    ["--checkpoint", "x.npz"],
    ["--check-invariants", "--model", "backlog"],
    ["--trace-every", "-1"],
    ["--trace-every", "2"],
    ["--trace-every", "50", "--max-rounds", "10", "--metrics", "m.jsonl"],
    ["--trace-out", "x.jsonl"],
    ["--metrics-every", "2"],
    ["--metrics", "m.jsonl", "--model", "slush"],
    ["--metrics", "m.jsonl", "--metrics-every", "1", "--trace-every", "1"],
    ["--rtt-matrix", "1,x"],
    ["--fault-script", "/nonexistent/script.json"],
    ["--k", "0"],
    ["--arrival-backpressure", "0.9"],
    ["--arrival-cluster-weights", "a,b"],
    ["--mesh", "1,1", "--round-engine", "megakernel"],
    ["--donate"],
    ["--mesh", "1,1", "--model", "snowball"],
    ["--mesh", "1,1", "--model", "streaming_dag", "--chunk", "2"],
    ["--mesh", "1,1", "--check-invariants"],
    ["--mesh", "1,1", "--metrics", "m.jsonl"],
    ["--fleet", "2", "--mesh", "1,1", "--donate"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a)[:40])
def test_refusals_match(argv, capsys):
    with pytest.raises(SystemExit) as want:
        jrun.main(list(argv))
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        trun.main(list(argv) + ["--device", "cpu"])
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code
    assert got_err == want_err


@pytest.mark.parametrize("argv", [
    ["--partition", "bad"],
    ["--latency-mode", "fixed", "--timeout-rounds", "0"],
])
def test_build_config_exits_match(argv):
    with pytest.raises(SystemExit) as want:
        jrun.main(list(argv))
    with pytest.raises(SystemExit) as got:
        trun.main(list(argv) + ["--device", "cpu"])
    assert got.value.code == want.value.code


@pytest.mark.parametrize("flag,item", [
    (["--fleet-shape", "auto", "--fleet", "2"], None),
    (["--audit"], "audit ok: snowball program passes its contracts"),
    (["--report-memory"], "memory report [snowball"),
], ids=["flag2-item 15", "flag3-item 17", "flag4-item 17"])
def test_unported_flags_name_their_item(flag, item, capsys):
    """Item 17's flags are all ported: `--fleet-shape auto` validates
    `--fleet` against the CPU's knee table and runs it, `--audit` and
    `--report-memory` report to stderr before the run
    (`tests/test_torch_audit.py`, `tests/test_torch_resources.py`)."""
    argv = flag + ["--model", "snowball", "--nodes", "16", "--max-rounds",
                   "3", "--device", "cpu"]
    result = trun.main(argv)
    err = capsys.readouterr().err
    if item is None:
        assert result["fleet"] == 2 and err == ""
    else:
        assert err.startswith(item)


AUDIT_REFUSALS = [
    ["--audit", "--fleet", "2", "--phase-grid", '{"k": [4, 8]}'],
    ["--audit", "--check-invariants"],
    ["--audit", "--model", "streaming_dag", "--chunk", "4"],
    ["--round-engine", "megakernel", "--fleet-shape", "auto"],
    ["--fleet-shape", "auto", "--mesh", "x"],
]


@pytest.mark.parametrize("argv", AUDIT_REFUSALS,
                         ids=lambda a: " ".join(a)[:40])
def test_audit_and_fleet_shape_refusals_match(argv, capsys):
    test_refusals_match(argv, capsys)


AUDITED = [
    ["--model", "snowball", "--nodes", "16"],
    ["--model", "avalanche", "--fleet", "3", "--contested"],
    ["--model", "avalanche", "--mesh", "1,1"],
    ["--model", "dag", "--metrics-every", "1", "--metrics", "{tmp}"],
]


@pytest.mark.parametrize("argv", AUDITED, ids=lambda a: " ".join(a[1:4]))
def test_audit_reports_ok_and_keeps_the_result(argv, tmp_path, capsys):
    """`--audit` audits one round of the run's program (dense, a fleet
    through `compiled_fleet_program`, a 1x1 mesh, a tapped run) and
    leaves the run's result as it was without the flag."""
    argv = [a.replace("{tmp}", str(tmp_path / "m.jsonl")) for a in argv]
    base = SMALL + argv + ["--device", "cpu"]
    want = trun.main(base)
    capsys.readouterr()
    got = trun.main(base + ["--audit"])
    err = capsys.readouterr().err
    assert err == (f"audit ok: {argv[1]} program passes its contracts "
                   f"(callbacks/dtype/collectives/donation)\n")
    for d in (want, got):
        d.pop("elapsed_s")
    assert got == want


def test_audit_failure_exits_1_before_the_run(monkeypatch, capsys):
    """A planted violation (a launch the program's budget does not
    name) prints the failures to stderr and exits 1, no result."""
    from go_avalanche_tpu_torch.analysis import audit

    monkeypatch.setattr(audit, "_model_kernels", lambda *a, **k: {})
    monkeypatch.setattr(audit.drift, "kernel_delta",
                        lambda before: {"vote_u8": 1})
    with pytest.raises(SystemExit) as got:
        trun.main(SMALL + ["--model", "avalanche", "--device", "cpu",
                           "--audit"])
    assert got.value.code == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.startswith("AUDIT FAILURES:\n  run_sim:avalanche: "
                              "undeclared kernel vote_u8")


def test_fleet_shape_auto_picks_and_validates_on_the_cpu():
    from benchmarks import vmem_knee
    from go_avalanche_tpu_torch.obs import knee

    args, _ = trun.parse_args(["--model", "snowball", "--nodes", "64",
                               "--txs", "64", "--fleet-shape", "auto",
                               "--device", "cpu"])
    want = vmem_knee.select_fleet_shape("cpu", 1, 64, 64)["fleet"]
    assert args.fleet == want == 4096
    args, _ = trun.parse_args(["--model", "snowball", "--nodes", "64",
                               "--fleet-shape", "auto", "--device", "cpu",
                               "--fleet", "8"])
    assert args.fleet == 8
    row = {r["fleet"]: r for r in knee.knee_table("cpu-ci")["rows"]}[64]
    assert row["largest_nt"] == 2048
    with pytest.raises(SystemExit) as got:
        trun.parse_args(["--model", "avalanche", "--nodes", "8192", "--txs",
                         "8192", "--fleet-shape", "auto", "--fleet", "64",
                         "--device", "cpu"])
    assert got.value.code == 2


def test_text_output_trace_and_cli(tmp_path, capsys):
    trace_dir = tmp_path / "prof"
    assert trun.cli(["--model", "snowball", "--nodes", "16",
                     "--finalization-score", "8", "--device", "cpu",
                     "--trace", str(trace_dir)]) == 0
    out = capsys.readouterr().out
    assert "model=snowball" in out and "backend=cpu" in out
    assert any(p.name.endswith(".json") for p in trace_dir.rglob("*"))


# ------------------------------------------------------------ --mesh


# The streaming models under --mesh (their sharded drivers).
STREAMING_MESH_ARGV = [
    ["--model", "backlog", "--slots", "4", "--byzantine", "0.2",
     "--donate"],
    ["--model", "streaming_dag", "--txs", "16", "--slots", "2",
     "--byzantine", "0.2"],
    ["--model", "node_stream", "--stake-mode", "zipf", "--registry-nodes",
     "24", "--active-nodes", "8", "--node-churn-rate", "0.2",
     "--max-rounds", "6"],
]


@pytest.fixture
def jax_devices(monkeypatch):
    """Give the JAX package's `make_mesh` the first `n` devices, so its
    ``--mesh A,B`` takes A*B of the 8 virtual devices, as the port's
    takes A*B ranks."""
    import jax

    real = jax.devices

    def take(n):
        monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:n])
    return take


@pytest.mark.parametrize("argv", [
    ["--model", "avalanche", "--contested", "--byzantine", "0.2",
     "--donate"],
    ["--model", "dag", "--conflict-size", "4", "--drop", "0.1"],
    ["--model", "avalanche", "--trace-every", "2", "--metrics", "TRACE"],
    ["--model", "snowball", "--fleet", "3"],
    ["--model", "avalanche", "--fleet", "2", "--phase-grid",
     '{"byzantine_fraction": [0.1, 0.3]}', "--byzantine", "0.1"],
] + STREAMING_MESH_ARGV,
    ids=["avalanche", "dag", "avalanche-traced", "fleet", "phase-grid",
         "backlog", "streaming_dag", "node_stream"])
def test_mesh_1x1_matches_jax(argv, jax_devices, tmp_path):
    jax_devices(1)
    argv = [str(tmp_path / "t.jsonl") if a == "TRACE" else a for a in argv]
    got = _both(SMALL + argv + ["--mesh", "1,1"])
    assert "rounds" in got or "grid_rows" in got


def test_mesh_2x1_on_two_ranks_matches_jax(jax_devices, tmp_path_factory):
    """Two spawned gloo ranks run `run_sim.main --mesh 2,1` for every
    model with a sharded driver; both return the result of the JAX
    package's `--mesh 2,1`."""
    import torch_ranks
    from go_avalanche_tpu_torch.parallel.ranks import RankPool

    jax_devices(2)
    pool = RankPool(2, str(tmp_path_factory.mktemp("ranks")))
    try:
        for extra in [["--model", "avalanche", "--contested", "--byzantine",
                       "0.2"],
                      ["--model", "dag", "--conflict-size", "2"],
                      *STREAMING_MESH_ARGV]:
            argv = SMALL + extra + ["--mesh", "2,1"]
            want = jrun.main(list(argv))
            got = pool.run(2, torch_ranks.run_sim_case,
                           argv + ["--device", "cpu"])
            for d in [want, *got]:
                d.pop("elapsed_s"), d.pop("backend")
            assert got == [want, want]
    finally:
        pool.close()
