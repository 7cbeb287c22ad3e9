"""No module of the benchmark, and nothing a run loads, has the top-level
name `jax`, `jaxlib`, `flax` or `go_avalanche_tpu`; and the command
refuses to run where it cannot measure."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

REPO = Path(harness.__file__).resolve().parents[1]


def test_portbench_forbidden_names_are_whole_top_level_names():
    names = ["go_avalanche_tpu_torch", "go_avalanche_tpu_torch.models.dag",
             "jaxtyping", "portbench.run", "flaxen"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(
        names + ["go_avalanche_tpu.ops", "jax", "jaxlib.xla", "flax"]) == [
            "flax", "go_avalanche_tpu.ops", "jax", "jaxlib.xla"]


def test_portbench_run_loads_no_jax(tmp_path):
    code = (
        "import pkgutil, importlib, sys, time, torch\n"
        "import portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import run_tiny\n"
        "for cell in ('dag10k-settle', 'stream100k-saturated'):\n"
        "    assert run_tiny(cell)['correct']\n"
        "print(harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_portbench_run_refuses_without_card_or_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "dag10k-settle", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert out.stdout == ""


@pytest.mark.cuda
def test_portbench_cells_on_the_card(card):
    from portbench.tests.conftest import run_tiny
    for cell in ("dag10k-settle", "stream100k-saturated"):
        for trace in (False, True):
            line = run_tiny(cell, trace=trace, device=card)
            assert line["correct"], line["checks"]
