"""Import hygiene of the PyTorch port and of `chip_smoke.py`.

The port imports `torch` and never `jax` or anything of the JAX package
(`go_avalanche_tpu`); its entry points default to the CUDA device and
refuse to fall back to the CPU silently.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "go_avalanche_tpu_torch"
MODULES = ["go_avalanche_tpu_torch", "go_avalanche_tpu_torch.config",
           "go_avalanche_tpu_torch.prng", "go_avalanche_tpu_torch.convert",
           "go_avalanche_tpu_torch._build",
           "go_avalanche_tpu_torch.ops.bitops",
           "go_avalanche_tpu_torch.ops.voterecord",
           "go_avalanche_tpu_torch.ops.sampling",
           "go_avalanche_tpu_torch.ops.adversary",
           "go_avalanche_tpu_torch.ops.exchange",
           "go_avalanche_tpu_torch.ops.megakernel",
           "go_avalanche_tpu_torch.ops.swar",
           "go_avalanche_tpu_torch.ops.pallas_vote",
           "go_avalanche_tpu_torch.ops.inflight",
           "go_avalanche_tpu_torch.stake",
           "go_avalanche_tpu_torch.models.avalanche",
           "go_avalanche_tpu_torch.models.dag",
           "go_avalanche_tpu_torch.models.snowball",
           "go_avalanche_tpu_torch.models.family",
           "go_avalanche_tpu_torch.workload",
           "go_avalanche_tpu_torch.round_profile",
           "go_avalanche_tpu_torch.fleet",
           "go_avalanche_tpu_torch.obs.tags",
           "go_avalanche_tpu_torch.types", "go_avalanche_tpu_torch.clock",
           "go_avalanche_tpu_torch.net", "go_avalanche_tpu_torch.processor",
           "go_avalanche_tpu_torch.native",
           "go_avalanche_tpu_torch.utils.golden",
           "go_avalanche_tpu_torch.utils.checkpoint",
           "go_avalanche_tpu_torch.run_sim",
           "go_avalanche_tpu_torch.connector",
           "go_avalanche_tpu_torch.connector.server",
           "go_avalanche_tpu_torch.parallel",
           "go_avalanche_tpu_torch.parallel.mesh",
           "go_avalanche_tpu_torch.parallel.collectives",
           "go_avalanche_tpu_torch.parallel.runtime",
           "go_avalanche_tpu_torch.parallel.sharded",
           "go_avalanche_tpu_torch.parallel.sharded_dag",
           "go_avalanche_tpu_torch.parallel.sharded_fleet",
           "go_avalanche_tpu_torch.parallel.sharded_backlog",
           "go_avalanche_tpu_torch.parallel.sharded_streaming_dag",
           "go_avalanche_tpu_torch.parallel.sharded_node_stream",
           "go_avalanche_tpu_torch.parallel.distributed_smoke",
           "go_avalanche_tpu_torch.utils.tracing",
           "go_avalanche_tpu_torch.obs.resources",
           "go_avalanche_tpu_torch.analysis",
           "go_avalanche_tpu_torch.analysis.retrace",
           "go_avalanche_tpu_torch.analysis.lint",
           "go_avalanche_tpu_torch.analysis.cli",
           "go_avalanche_tpu_torch.connector.go_fixtures",
           "go_avalanche_tpu_torch.examples.recorded"]
STUDIES = ("adversary_atlas", "basic_preconsensus", "capacity_planning",
           "churn_tolerance", "committee_scaling", "equivocation_threshold",
           "family_curves", "fault_scenarios", "finality_curves",
           "oppose_scaling", "quorum_dial", "retire_cap_tradeoff",
           "window_scaling")
MODULES += [f"go_avalanche_tpu_torch.examples.{s}" for s in STUDIES]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "go_avalanche_tpu"
            or module.startswith("go_avalanche_tpu."))


def test_importing_the_port_loads_no_jax_module():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert "go_avalanche_tpu_torch.models.avalanche" in out
    assert [m for m in out if _forbidden(m)] == []


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_file_imports_jax(path):
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


def test_chip_smoke_imports_no_jax_and_fails_without_cuda():
    code = ("import sys, runpy\n"
            "try:\n"
            "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'go_avalanche_tpu'"
            " or m.startswith('go_avalanche_tpu.')]\n"
            "    print('BAD', bad)\n"
            "    sys.exit(e.code)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run")
    assert proc.returncode != 0
    assert "BAD []" in proc.stdout
    assert '"ok"' not in proc.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.models import avalanche as av

    key = prng.key(0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        av.init(key, 4, 32)
    state = av.init(key, 4, 32, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        av.run_scan(state, n_rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        av.run(state, max_rounds=1)

    from go_avalanche_tpu_torch import stake
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models import (backlog, node_stream,
                                               streaming_dag)

    key = prng.key(0, device="cpu")
    zipf = AvalancheConfig(stake_mode="zipf")
    with pytest.raises(RuntimeError, match="cuda"):
        stake.node_stake(zipf, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        stake.draw_working_set(key, torch.ones(8), 2)
    queue = backlog.make_backlog(torch.arange(6))
    sets = streaming_dag.make_set_backlog(torch.arange(8).reshape(4, 2))
    registry = AvalancheConfig(stake_mode="zipf", registry_nodes=8,
                               active_nodes=4)
    for init, args in ((backlog.init, (key, 4, 2, queue)),
                       (streaming_dag.init, (key, 4, 2, sets)),
                       (node_stream.init, (key, 4, registry))):
        with pytest.raises(RuntimeError, match="cuda"):
            init(*args)
    runs = {backlog: backlog.init(key, 4, 2, queue, device="cpu"),
            streaming_dag: streaming_dag.init(key, 4, 2, sets, device="cpu")}
    for module, state in runs.items():
        with pytest.raises(RuntimeError, match="cuda"):
            module.run(state, max_rounds=1)
        with pytest.raises(RuntimeError, match="cuda"):
            module.run_scan(state, n_rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        streaming_dag.run_chunked(runs[streaming_dag], max_rounds=1)
    state = node_stream.init(key, 4, registry, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        node_stream.run_scan(state, registry, n_rounds=1)

    from go_avalanche_tpu_torch import fleet

    policy = AvalancheConfig(byzantine_fraction=0.25,
                             adversary_policy="split_vote")
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.run_fleet("snowball", policy, fleet=2, n_nodes=8, n_rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        fleet.run_phase_grid("avalanche", policy,
                             {"adversary_policy": ["off", "split_vote"]},
                             fleet=2, n_nodes=8, n_txs=4, n_rounds=1)

    from go_avalanche_tpu_torch.parallel import distributed_smoke

    with pytest.raises(RuntimeError, match="cuda"):
        distributed_smoke.run()


def test_host_surfaces_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    from go_avalanche_tpu_torch import prng, run_sim
    from go_avalanche_tpu_torch.connector.server import ConnectorServer
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.utils import checkpoint

    with pytest.raises(RuntimeError, match="cuda"):
        run_sim.main(["--model", "snowball", "--nodes", "8"])
    state = av.init(prng.key(0, device="cpu"), 4, 32, device="cpu")
    path = str(tmp_path / "s.npz")
    checkpoint.save_checkpoint(path, state)
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.restore_checkpoint(path, state)
    with pytest.raises(RuntimeError, match="cuda"):
        ConnectorServer()


def test_round_profile_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the profile would run")
    proc = subprocess.run(
        [sys.executable, "-m", "go_avalanche_tpu_torch.round_profile"],
        cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_single_decree_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.models import family, snowball

    key = prng.key(0, device="cpu")
    for init in (snowball.init, family.slush_init, family.snowflake_init):
        with pytest.raises(RuntimeError, match="cuda"):
            init(key, 8)
    state = snowball.init(key, 8, device="cpu")
    for run in (snowball.run, snowball.run_scan):
        with pytest.raises(RuntimeError, match="cuda"):
            run(state)
    with pytest.raises(RuntimeError, match="cuda"):
        family.slush_run(family.slush_init(key, 8, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        family.snowflake_run(family.snowflake_init(key, 8, device="cpu"))


def test_every_study_has_a_twin():
    scripts = {p.stem for p in (REPO / "examples").glob("*.py")}
    twins = {p.stem for p in (PORT / "examples").glob("*.py")
             if not p.stem.startswith("_")} - {"recorded"}
    assert scripts == twins == set(STUDIES)


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("study", STUDIES)
def test_study_twins_default_to_cuda(study, monkeypatch):
    """Each twin's `main` defaults to the card, raises without one, and
    writes its artifact nowhere under the JAX package's `examples/`."""
    import argparse
    import importlib

    module = importlib.import_module(f"go_avalanche_tpu_torch.examples."
                                     f"{study}")
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["args"] = parse(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        module.main([])
    args = seen["args"]
    assert args.device == "cuda"
    for flag in ("json_out", "out"):
        path = getattr(args, flag, None)
        if path is not None:
            resolved = Path(path).resolve()
            assert REPO / "examples" not in resolved.parents, (flag, path)
            assert PORT / "examples" / "out" in resolved.parents
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])
