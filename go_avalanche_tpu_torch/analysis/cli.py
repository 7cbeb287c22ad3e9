"""`python -m go_avalanche_tpu_torch.analysis` — the port's static-analysis
CLI (`go_avalanche_tpu/analysis/cli.py`).

Subcommands (default ``all``):

  audit   the contract audit (`analysis/audit.py`): one round of each of
          the 14 programs at its audit shape, then the five sharded
          drivers and the sharded fleet on 2x2 meshes in a pool of 4
          spawned ranks (gloo; on CUDA they share the card);
  lint    the port-convention AST linter (imports neither torch nor
          jax — runs anywhere);
  all     both.

``--device`` is ``cuda`` (the default, as for every entry point of the
port) or ``cpu``.  The reference's ``--no-compile-donation`` is refused:
the port compiles nothing, and its donation check (one round's
storages; on CUDA the memory ledger) always runs.  Exit status 1 on any
failure, 0 clean; one line per failure on stderr.
"""

from __future__ import annotations

import argparse
import sys


def run_audit(device: str = "cuda") -> list:
    """Every contract of the audit, as one failure list."""
    from go_avalanche_tpu_torch.analysis import audit
    from go_avalanche_tpu_torch.models.avalanche import _device

    dev = _device(device)
    return audit.audit_all_pinned(dev) + audit.run_sharded_audits(dev.type)


def run_lint() -> list:
    from go_avalanche_tpu_torch.analysis import lint

    try:
        return [str(v) for v in lint.lint_repo()]
    except RuntimeError as e:
        # No checkout in sight: an explicit failure line beats linting
        # all of site-packages.
        return [f"lint unavailable: {e}"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m go_avalanche_tpu_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("command", nargs="?", default="all",
                        choices=("audit", "lint", "all"),
                        help="which surface to run (default: all)")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="the device the audit's rounds run on")
    parser.add_argument("--no-compile-donation", action="store_true",
                        help="the reference's; refused here (see above)")
    args = parser.parse_args(argv)
    if args.no_compile_donation:
        parser.error("--no-compile-donation: the port compiles nothing — "
                     "its donation check (one round's storages, and the "
                     "memory ledger on CUDA) always runs")

    failures = []
    if args.command in ("lint", "all"):
        failures += run_lint()
    if args.command in ("audit", "all"):
        failures += run_audit(args.device)

    if failures:
        print("STATIC ANALYSIS FAILURES:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    what = {"audit": "contract audit", "lint": "lint",
            "all": "contract audit + lint"}[args.command]
    print(f"ok: {what} clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
