"""The port's `run_sim` CLI against the JAX package's.

The same argv (plus ``--device cpu``) goes through both `main`s: the
result dicts must be equal apart from `backend` and `elapsed_s`, the
JSONL files of ``--metrics`` and ``--trace-out`` byte-equal, the parser's
refusals the same messages, and the flags of items not ported yet must
raise `NotImplementedError` naming the item.  Shapes are tiny so the
JAX side compiles little.
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
    (["--fleet-shape", "auto"], "item 17 part B"),
    (["--audit"], "item 17 part B"),
    (["--report-memory"], None),
], ids=["flag2-item 15", "flag3-item 17", "flag4-item 17"])
def test_unported_flags_name_their_item(flag, item, capsys):
    """The flags of the XLA resource tooling still to port (item 17 part
    B) name their item; `--report-memory` is ported and reports to
    stderr (`tests/test_torch_resources.py`), as `--mesh` (every model)
    and `--donate` are (the cases below)."""
    argv = flag + ["--model", "snowball", "--nodes", "16", "--max-rounds",
                   "3", "--device", "cpu"]
    if item is None:
        trun.main(argv)
        assert capsys.readouterr().err.startswith("memory report [snowball")
        return
    with pytest.raises(NotImplementedError, match=item):
        trun.main(argv)


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
