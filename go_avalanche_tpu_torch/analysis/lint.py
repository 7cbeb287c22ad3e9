"""Port-convention AST linter — the port's `go_avalanche_tpu/analysis/lint.py`
with its rule tables pointed at `go_avalanche_tpu_torch/`.

Four rules, each with a canonical-location table, an allowlist and a
PINNED violation message (tests/test_torch_analysis.py asserts the
wording).  Pure stdlib `ast`: linting imports neither torch nor jax.

  canonical-spelling   the port's renamed copies of the reference's
                       one-spelling names — `cluster_ids`, `config_tag`,
                       `inner_round_config`, `churn_swaps` — are bound
                       in exactly one module each and imported from
                       there (or a declared re-exporter) only.
  config-torch-free    `config.py` never imports torch, and its
                       validators (`_validate_*`, `__post_init__`) never
                       touch `torch`: AvalancheConfig is a hashable
                       host-side value, validated in plain Python.
  host-rng-in-traced   no `np.random` / `random` module use, and no draw
                       from torch's global generator (`torch.rand*`,
                       `randperm`, `bernoulli`, `multinomial`, `normal`,
                       `poisson`, `manual_seed`, `seed`), in the round
                       code (`models/`, `ops/`, `parallel/`, `traffic`,
                       `stake`, `fleet`, `obs/trace`): every draw comes
                       from `prng`'s threefry keys, or the trajectories
                       leave the reference's.
  round-engine-seam    a module (outside ops/) that pairs a phased
                       exchange call (`gather_vote_packs` /
                       `fused_vote_packs` / `legacy_vote_packs`) with a
                       `register_packed_votes*` ingest call must also
                       reference `round_engine` — dispatching to the
                       megakernel or rejecting the knob as inert.

The reference's fifth rule, debug-print (`jax.debug.print` in compiled
code), has no torch counterpart: the port compiles no Python, and a
print in it is an ordinary host call.

Adding a rule: give it an id + pinned message here and a fixture test in
tests/test_torch_analysis.py (one planted violation, one clean positive).
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

REPO_ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "go_avalanche_tpu_torch"

# ---------------------------------------------------------------- rule tables

# name -> the ONE module (repo-relative posix path) allowed to bind it.
CANONICAL_MODULES: Dict[str, str] = {
    "cluster_ids": f"{PACKAGE}/ops/sampling.py",
    "config_tag": f"{PACKAGE}/obs/tags.py",
    "inner_round_config": f"{PACKAGE}/config.py",
    "churn_swaps": f"{PACKAGE}/models/node_stream.py",
}

# name -> module paths an `from X import name` may name.  The obs
# package __init__ is the one declared re-exporter of `config_tag`.
ALLOWED_IMPORT_SOURCES: Dict[str, Set[str]] = {
    "cluster_ids": {f"{PACKAGE}.ops.sampling"},
    "config_tag": {f"{PACKAGE}.obs.tags", f"{PACKAGE}.obs"},
    "inner_round_config": {f"{PACKAGE}.config"},
    "churn_swaps": {f"{PACKAGE}.models.node_stream"},
}

CONFIG_MODULE = f"{PACKAGE}/config.py"

# The round code's scope for host-rng-in-traced: directories (prefix
# match) + single files.
TRACED_SCOPE_PREFIXES = (
    f"{PACKAGE}/models/",
    f"{PACKAGE}/ops/",
    f"{PACKAGE}/parallel/",
)
TRACED_SCOPE_FILES = {
    f"{PACKAGE}/traffic.py",
    f"{PACKAGE}/stake.py",
    f"{PACKAGE}/fleet.py",
    f"{PACKAGE}/obs/trace.py",
}
# torch's global-generator draws (`torch.<name>`).
TORCH_GLOBAL_RNG = {"rand", "rand_like", "randn", "randn_like", "randint",
                    "randint_like", "randperm", "bernoulli", "multinomial",
                    "normal", "poisson", "manual_seed", "seed"}

# Library scope: the whole port package.
LIBRARY_SCOPE_PREFIX = f"{PACKAGE}/"

# round-engine-seam: the phased pipeline's two halves.  ops/ itself is
# out of scope — the engines and the megakernel live there.
ROUND_SEAM_OPS_PREFIX = f"{PACKAGE}/ops/"
ROUND_SEAM_EXCHANGE_CALLS = {"gather_vote_packs", "fused_vote_packs",
                             "legacy_vote_packs"}
ROUND_SEAM_INGEST_PREFIX = "register_packed_votes"

# Per-rule allowlist: rule -> set of repo-relative files exempted.
# Keep empty unless a reviewed exception exists.
ALLOWLIST: Dict[str, Set[str]] = {
    "canonical-spelling": set(),
    "config-torch-free": set(),
    "host-rng-in-traced": set(),
    "round-engine-seam": set(),
}

_MSG_CANONICAL = ("{name} has ONE spelling — bind/import it from "
                  "{canonical} only (a drifted copy diverges silently)")
_MSG_CONFIG_TORCH = ("config validators must stay torch-free: "
                     "AvalancheConfig is a hashable host-side value and "
                     "validation is plain python/math")
_MSG_HOST_RNG = ("host RNG in the round code: models/ops/parallel draw "
                 "ONLY from prng's threefry keys (np.random, the random "
                 "module and torch's global generator leave the "
                 "reference's trajectories and the fleet's per-trial key "
                 "contract)")
_MSG_ROUND_SEAM = ("phased exchange+ingest pair without a round-engine "
                   "seam: a module pairing gather_vote_packs with "
                   "register_packed_votes* must dispatch on "
                   "cfg.round_engine or reject it as inert — otherwise "
                   "the whole-round megakernel knob "
                   "(ops/megakernel.py) is silently ignored")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str      # repo-relative posix path
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _allowed(rule: str, rel: str) -> bool:
    return rel in ALLOWLIST.get(rule, ())


# ------------------------------------------------------------ rule visitors


def _canonical_spelling(tree: ast.AST, rel: str) -> List[Violation]:
    out: List[Violation] = []

    def flag(name: str, line: int) -> None:
        out.append(Violation(rel, line, "canonical-spelling",
                             _MSG_CANONICAL.format(
                                 name=name,
                                 canonical=CANONICAL_MODULES[name])))

    def foreign(name: str) -> bool:
        return name in CANONICAL_MODULES and rel != CANONICAL_MODULES[name]

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if foreign(node.name):
                flag(node.name, node.lineno)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for a in (*args.posonlyargs, *args.args, *args.kwonlyargs,
                          *filter(None, (args.vararg, args.kwarg))):
                    if foreign(a.arg):
                        flag(a.arg, a.lineno)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            if foreign(node.id):
                flag(node.id, node.lineno)
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            for alias in node.names:
                name = alias.asname or alias.name
                if not foreign(name):
                    continue
                renamed = alias.asname is not None and alias.name != name
                if renamed or module not in ALLOWED_IMPORT_SOURCES[name]:
                    flag(name, node.lineno)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname and foreign(alias.asname):
                    flag(alias.asname, node.lineno)
    return out


def _config_torch_free(tree: ast.AST, rel: str) -> List[Violation]:
    if rel != CONFIG_MODULE:
        return []
    out: List[Violation] = []

    def flag(line: int) -> None:
        out.append(Violation(rel, line, "config-torch-free",
                             _MSG_CONFIG_TORCH))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "torch" for a in node.names):
                flag(node.lineno)
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                flag(node.lineno)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not (node.name.startswith("_validate")
                    or node.name == "__post_init__"):
                continue
            for inner in ast.walk(node):
                if (isinstance(inner, ast.Name)
                        and isinstance(inner.ctx, ast.Load)
                        and inner.id == "torch"):
                    flag(inner.lineno)
    return out


def _in_traced_scope(rel: str) -> bool:
    return (rel in TRACED_SCOPE_FILES
            or any(rel.startswith(p) for p in TRACED_SCOPE_PREFIXES))


def _host_rng_in_traced(tree: ast.AST, rel: str) -> List[Violation]:
    if not _in_traced_scope(rel):
        return []
    out: List[Violation] = []

    def flag(line: int) -> None:
        out.append(Violation(rel, line, "host-rng-in-traced",
                             _MSG_HOST_RNG))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(alias.name == "random" for alias in node.names):
                flag(node.lineno)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "random" or (
                    node.module == "torch"
                    and any(a.name in TORCH_GLOBAL_RNG for a in node.names)):
                flag(node.lineno)
        elif isinstance(node, ast.Attribute) and isinstance(node.value,
                                                             ast.Name):
            if ((node.attr == "random" and node.value.id in ("np", "numpy"))
                    or (node.value.id == "torch"
                        and node.attr in TORCH_GLOBAL_RNG)):
                flag(node.lineno)
    return out


def _round_engine_seam(tree: ast.AST, rel: str) -> List[Violation]:
    if not rel.startswith(LIBRARY_SCOPE_PREFIX):
        return []
    if rel.startswith(ROUND_SEAM_OPS_PREFIX):
        return []
    exchange_line = ingest_line = None
    has_seam = False
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name in ROUND_SEAM_EXCHANGE_CALLS:
                if exchange_line is None:
                    exchange_line = node.lineno
            elif (name and name.startswith(ROUND_SEAM_INGEST_PREFIX)
                    and ingest_line is None):
                ingest_line = node.lineno
        # The seam is any `round_engine` touch: the cfg attribute, a
        # dispatch variable, or a `_reject_round_engine`-style guard.
        if ((isinstance(node, ast.Attribute)
                and "round_engine" in node.attr)
                or (isinstance(node, ast.Name)
                    and "round_engine" in node.id)):
            has_seam = True
    if exchange_line is not None and ingest_line is not None \
            and not has_seam:
        return [Violation(rel, max(exchange_line, ingest_line),
                          "round-engine-seam", _MSG_ROUND_SEAM)]
    return []


_RULES = (
    ("canonical-spelling", _canonical_spelling),
    ("config-torch-free", _config_torch_free),
    ("host-rng-in-traced", _host_rng_in_traced),
    ("round-engine-seam", _round_engine_seam),
)


# ----------------------------------------------------------------- drivers


def lint_source(src: str, rel: str) -> List[Violation]:
    """Lint one file's SOURCE under its repo-relative posix path —
    the unit tests' fixture entry point."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Violation(rel, e.lineno or 0, "parse-error",
                          f"file does not parse: {e.msg}")]
    out: List[Violation] = []
    for rule, fn in _RULES:
        if _allowed(rule, rel):
            continue
        out.extend(fn(tree, rel))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


_SKIP_DIRS = {"__pycache__", "build"}


def _require_checkout(root: Path) -> Path:
    """Refuse a directory that is not a source checkout: from an
    installed wheel, ``parents[2]`` is site-packages."""
    if (root / "pyproject.toml").exists() and (root / PACKAGE).is_dir():
        return root
    raise RuntimeError(
        f"{root} is not a go-avalanche-tpu source checkout (no "
        f"pyproject.toml + {PACKAGE}/ side by side) — the port linter "
        f"needs the repo; run it from the checkout or pass "
        f"lint_repo(root=...)")


def port_py_files(root: Path = REPO_ROOT) -> Iterable[Path]:
    """Every .py file of the port package, and `chip_smoke.py`."""
    for path in sorted((root / PACKAGE).rglob("*.py")):
        if not _SKIP_DIRS.intersection(path.relative_to(root).parts):
            yield path
    if (root / "chip_smoke.py").exists():
        yield root / "chip_smoke.py"


def lint_repo(root: Optional[Path] = None) -> List[Violation]:
    """Lint the port; [] means lint-clean.  Raises `RuntimeError` when
    no source checkout is findable."""
    root = _require_checkout(root or REPO_ROOT)
    out: List[Violation] = []
    for path in port_py_files(root):
        rel = path.relative_to(root).as_posix()
        out.extend(lint_source(path.read_text(), rel))
    return out
