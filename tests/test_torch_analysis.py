"""The port's analysis package (`go_avalanche_tpu_torch/analysis/`): the
compile counter and phase-grid guard (`retrace.py`, against the JAX
package's cases), and the port-convention linter (`lint.py`, one planted
violation and one clean positive per rule, the template of
`tests/test_analysis.py`), its CLI, and the tree itself lint-clean.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from go_avalanche_tpu.analysis import retrace as jretrace
from go_avalanche_tpu_torch import _build
from go_avalanche_tpu_torch.analysis import cli, lint, retrace

REPO = Path(__file__).resolve().parents[1]
P = "go_avalanche_tpu_torch"


# -------------------------------------------------------------- retrace


@pytest.mark.parametrize("module", [jretrace, retrace],
                         ids=["jax", "port"])
def test_guard_fleet_point(module):
    module.guard_fleet_point(3, 4, {"k": 8})       # one compile: fine
    module.guard_fleet_point(5, 5, {"k": 8})       # cached: fine
    with pytest.raises(module.RetraceError,
                       match="dispatch-amortization"):
        module.guard_fleet_point(0, 2, {"k": 8})


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """`_build` with its nvcc run and its dlopen replaced: a build
    writes an empty library where nvcc would, a load returns a stub."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    runs = []

    def run(cmd, **kwargs):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info")

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    _build.load.cache_clear()
    yield runs
    _build.load.cache_clear()


def test_compile_counter_counts_builds_and_first_loads(fake_nvcc):
    with retrace.CompileCounter() as built:
        _build.build("vote_u8")             # nvcc runs
    assert built.count == 1 and len(fake_nvcc) == 1
    with retrace.CompileCounter() as current:
        _build.build("vote_u8")             # the library is current
    assert current.count == 0 and len(fake_nvcc) == 1
    current.expect_at_most(0, "a current library")
    with retrace.CompileCounter() as first:
        _build.load("vote_u8")              # first load of it
    assert first.count == 1
    with retrace.CompileCounter() as hit:
        _build.load("vote_u8")              # a cache hit
        _build.load("vote_u8")
    assert hit.count == 0
    with retrace.CompileCounter() as fresh:
        _build.load("vote_swar")            # load builds: one event
    assert fresh.count == 1 and len(fake_nvcc) == 2
    with pytest.raises(retrace.RetraceError, match="one-compile contract"):
        first.expect_at_most(0, "the timed loop")
    # The count froze at scope exit.
    _build.load.cache_clear()
    _build.load("megakernel")
    assert first.count == 1


def test_phase_grid_guards_each_point(monkeypatch):
    from go_avalanche_tpu_torch import fleet
    from go_avalanche_tpu_torch.config import AvalancheConfig

    base = AvalancheConfig(byzantine_fraction=0.25)
    grid = {"adversary_policy": ["off", "split_vote"]}
    kw = dict(fleet=2, n_nodes=8, n_txs=4, n_rounds=1, device="cpu")
    rows = fleet.run_phase_grid("snowball", base, grid, **kw)
    assert len(rows) == 2
    real = fleet.run_fleet

    def recompiling(*args, **kwargs):
        _build._count_compile()
        _build._count_compile()
        return real(*args, **kwargs)

    monkeypatch.setattr(fleet, "run_fleet", recompiling)
    with pytest.raises(retrace.RetraceError,
                       match="'adversary_policy': 'off'"):
        fleet.run_phase_grid("snowball", base, grid, **kw)


def test_package_reexports():
    from go_avalanche_tpu_torch import analysis

    assert analysis.CompileCounter is retrace.CompileCounter
    assert analysis.RetraceError is retrace.RetraceError


# ----------------------------------------------------------------- lint


def test_lint_canonical_spelling_rebind_and_assign():
    vs = lint.lint_source("def cluster_ids(x):\n    return x\n",
                          f"{P}/traffic.py")
    assert [v.rule for v in vs] == ["canonical-spelling"]
    assert "cluster_ids has ONE spelling" in vs[0].message
    assert f"{P}/ops/sampling.py" in vs[0].message
    vs = lint.lint_source("churn_swaps = None\n", "chip_smoke.py")
    assert [v.rule for v in vs] == ["canonical-spelling"]
    assert lint.lint_source("def churn_swaps(s, cfg):\n    return s\n",
                            f"{P}/models/node_stream.py") == []


def test_lint_canonical_spelling_import_sources():
    assert lint.lint_source(
        f"from {P}.ops.sampling import cluster_ids\n", f"{P}/traffic.py") \
        == []
    bad = lint.lint_source(f"from {P}.traffic import cluster_ids\n",
                           f"{P}/models/foo.py")
    assert [v.rule for v in bad] == ["canonical-spelling"]
    renamed = lint.lint_source(
        f"from {P}.config import AvalancheConfig as inner_round_config\n",
        f"{P}/models/foo.py")
    assert [v.rule for v in renamed] == ["canonical-spelling"]
    # The declared re-export: obs/__init__ imports config_tag, and
    # importing it from the obs package is canonical.
    assert lint.lint_source(f"from {P}.obs.tags import config_tag\n",
                            f"{P}/obs/__init__.py") == []
    assert lint.lint_source(f"from {P}.obs import config_tag\n",
                            f"{P}/fleet.py") == []
    vs = lint.lint_source("def config_tag(cfg):\n    return ''\n",
                          f"{P}/obs/__init__.py")
    assert [v.rule for v in vs] == ["canonical-spelling"]


def test_lint_config_torch_free():
    src = ("import torch\n"
           "class C:\n"
           "    def _validate_stake(self):\n"
           "        return torch.as_tensor(self.x)\n")
    vs = lint.lint_source(src, f"{P}/config.py")
    assert [v.rule for v in vs] == ["config-torch-free"] * 2
    assert "validation is plain python/math" in vs[0].message
    assert lint.lint_source("from torch import nn\n", f"{P}/config.py")
    # Same source under any other path: the rule is config.py-scoped.
    assert lint.lint_source(src, f"{P}/stake.py") == []
    assert lint.lint_source("import math\n", f"{P}/config.py") == []


@pytest.mark.parametrize("src", [
    "import numpy as np\ndef draw(n):\n    return np.random.rand(n)\n",
    "import random\n",
    "import torch\ndef draw(n):\n    return torch.rand(n)\n",
    "import torch\ndef draw(n):\n    return torch.randperm(n)\n",
    "import torch\ndef draw(p):\n    return torch.bernoulli(p)\n",
    "import torch\ndef draw(p):\n    return torch.multinomial(p, 1)\n",
    "import torch\ntorch.manual_seed(0)\n",
    "from torch import randint\n",
], ids=["np_random", "random", "torch_rand", "randperm", "bernoulli",
        "multinomial", "manual_seed", "from_torch"])
def test_lint_host_rng_in_traced_scope_only(src):
    for rel in (f"{P}/models/foo.py", f"{P}/ops/bar.py",
                f"{P}/parallel/baz.py", f"{P}/traffic.py", f"{P}/stake.py",
                f"{P}/fleet.py", f"{P}/obs/trace.py"):
        vs = lint.lint_source(src, rel)
        assert [v.rule for v in vs] == ["host-rng-in-traced"], rel
        assert "prng's threefry keys" in vs[0].message
    # Host-side modules are out of scope.
    assert lint.lint_source(src, f"{P}/processor.py") == []
    assert lint.lint_source(src, f"{P}/workload.py") == []


def test_lint_host_rng_allows_the_port_prng_and_seeded_tensors():
    src = ("import torch\nfrom go_avalanche_tpu_torch import prng\n"
           "def draw(key, n):\n"
           "    return prng.bernoulli(key, 0.5, (n,)) & torch.ones(n)\n")
    assert lint.lint_source(src, f"{P}/models/foo.py") == []


def test_lint_round_engine_seam():
    bad = (f"from {P}.ops import exchange\n"
           f"from {P}.ops import voterecord as vr\n"
           "def my_round(state, cfg, peers):\n"
           "    y, c = exchange.fused_vote_packs(state, peers)\n"
           "    return vr.register_packed_votes_engine(state, y, c,\n"
           "                                           cfg.k, cfg)\n")
    vs = lint.lint_source(bad, f"{P}/models/foo.py")
    assert [v.rule for v in vs] == ["round-engine-seam"]
    assert "megakernel" in vs[0].message
    assert vs[0].line == 5
    ok = bad.replace(
        "    y, c = exchange",
        "    if cfg.round_engine != 'phased':\n"
        "        raise ValueError('inert here')\n"
        "    y, c = exchange")
    assert lint.lint_source(ok, f"{P}/models/foo.py") == []
    assert lint.lint_source(bad, f"{P}/ops/foo.py") == []


def test_port_is_lint_clean():
    assert [str(v) for v in lint.lint_repo()] == []


PLANTS = {
    "canonical-spelling": ("fleet.py", "def cluster_ids(x):\n    return x\n"),
    "config-torch-free": ("config.py", "import torch\n"),
    "host-rng-in-traced": ("models/foo.py",
                           "import torch\nx = torch.randn(3)\n"),
    "round-engine-seam": ("parallel/foo.py",
                          "def f(s, p, cfg):\n"
                          "    y, c = gather_vote_packs(s, p)\n"
                          "    return register_packed_votes(s, y, c)\n"),
}


@pytest.mark.parametrize("rule", sorted(PLANTS))
def test_cli_lint_exits_1_on_a_planted_violation(rule, tmp_path, monkeypatch,
                                                 capsys):
    (tmp_path / "pyproject.toml").write_text("")
    where, src = PLANTS[rule]
    path = tmp_path / P / where
    path.parent.mkdir(parents=True)
    path.write_text(src)
    monkeypatch.setattr(lint, "REPO_ROOT", tmp_path)
    assert cli.main(["lint"]) == 1
    err = capsys.readouterr().err
    assert f"{P}/{where}" in err and f"[{rule}]" in err
    path.write_text("x = 1\n")
    assert cli.main(["lint"]) == 0
    assert capsys.readouterr().out == "ok: lint clean\n"


def test_cli_lint_runs_without_jax_and_audit_waits():
    code = ("import sys, runpy\n"
            "sys.argv = ['analysis', 'lint']\n"
            "try:\n"
            "    runpy.run_module('go_avalanche_tpu_torch.analysis',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.')]\n"
            "    print('BAD', bad)\n"
            "    sys.exit(e.code)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ok: lint clean" in proc.stdout and "BAD []" in proc.stdout
    # `audit` no longer waits: it runs the contract audit (below), and
    # the reference's compile-only flag is refused.
    with pytest.raises(SystemExit) as got:
        cli.main(["audit", "--no-compile-donation", "--device", "cpu"])
    assert got.value.code == 2


def test_cli_all_is_clean_on_the_cpu(capsys):
    """`all` (the default command) lints the checkout and audits the 14
    programs and, in a pool of 4 spawned ranks, the sharded drivers and
    the sharded fleet."""
    assert cli.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == "ok: contract audit + lint clean\n"


def test_cli_audit_exits_1_on_a_planted_failure(monkeypatch, capsys):
    from go_avalanche_tpu_torch.analysis import audit

    monkeypatch.setattr(audit, "run_sharded_audits", lambda device: [])
    assert cli.main(["audit", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == "ok: contract audit clean\n"
    monkeypatch.setitem(audit.HOST_READ_BUDGET, "flagship", 1)
    assert cli.main(["audit", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err == ("STATIC ANALYSIS FAILURES:\n  flagship: 0 counted host "
                   "read(s) a round (sync.reads), contract says exactly "
                   "1\n")


# ------------------------------------------------ the reference's public names


def test_score_ranks_matches_jax():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from go_avalanche_tpu.models import avalanche as jav
    from go_avalanche_tpu_torch.models import avalanche as tav

    rng = np.random.default_rng(22)
    for scores in (rng.integers(0, 5, 40), rng.integers(-9, 9, 7),
                   np.zeros(5, np.int64), np.arange(9)[::-1]):
        scores = scores.astype(np.int32)
        want = np.asarray(jav.score_ranks(jnp.asarray(scores)))
        got = tav.score_ranks(torch.from_numpy(scores))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_apply_partition_is_apply_faults_and_matches_jax():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from go_avalanche_tpu.config import AvalancheConfig as JaxConfig
    from go_avalanche_tpu.ops import inflight as jif
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.ops import inflight as tif

    assert tif.apply_partition is tif.apply_faults
    knobs = dict(latency_mode="fixed", latency_rounds=1, time_step_s=1.0,
                 request_timeout_s=3.0,
                 fault_script=(("partition", 2, 6, 0.5),
                               ("latency_spike", 1, 4, 2)))
    jcfg, tcfg = JaxConfig(**knobs), AvalancheConfig(**knobs)
    rng = np.random.default_rng(5)
    n, rows, offset = 64, 24, 16
    peers = rng.integers(0, n, (rows, 8)).astype(np.int32)
    lat = rng.integers(0, 3, (rows, 8)).astype(np.int32)
    for r in range(8):
        want = jif.apply_partition(jnp.asarray(lat), jcfg, jnp.int32(r),
                                   offset, jnp.asarray(peers), n)
        got = tif.apply_partition(torch.from_numpy(lat), tcfg,
                                  torch.tensor(r, dtype=torch.int32), offset,
                                  torch.from_numpy(peers), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
