"""`python -m go_avalanche_tpu_torch.analysis` — the port's static-analysis
CLI (`go_avalanche_tpu/analysis/cli.py`).

Subcommands:

  lint    the port-convention AST linter (imports neither torch nor
          jax — runs anywhere);
  audit   the reference's contract audit of lowered and compiled XLA
          programs: not ported (ROADMAP.md Queue 1, item 17 part B);
  all     both.

Exit status 1 on any failure, 0 clean; one line per failure on stderr.
"""

from __future__ import annotations

import argparse
import sys


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
    parser.add_argument("command", nargs="?", default="lint",
                        choices=("audit", "lint", "all"),
                        help="which surface to run (default: lint)")
    args = parser.parse_args(argv)
    if args.command in ("audit", "all"):
        raise NotImplementedError(
            f"{args.command}: the PyTorch port does not implement the "
            f"contract audit yet (ROADMAP.md Queue 1, item 17 part B: "
            f"the torch counterpart of analysis/hlo_audit.py)")

    failures = run_lint()
    if failures:
        print("STATIC ANALYSIS FAILURES:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print("ok: lint clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
