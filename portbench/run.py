"""Run one cell of the benchmark of `go_avalanche_tpu_torch` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up, measures for `--seconds` (to the end of the running
simulation or segment), checks what the timed path produced against the
plain reference in `portbench/reference/`, and prints one JSON line
last on standard output.  With `--trace 0` the line's metrics are the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read
from a `torch.profiler` trace of a bounded window.

Exits non-zero without a result where there is no CUDA card, fewer
cards than the cell asks for, no program beside the benchmark, or where
JAX or the JAX package is loaded after set-up or after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's bytecode of everything a run imports (torch, numpy, the
# program), kept at a fixed path inside the checkout: where the
# environment says not to write bytecode (PYTHONDONTWRITEBYTECODE) and
# the installed packages carry none, every run would otherwise compile
# torch's sources again, some 8 s of set-up.
PYCACHE = Path(__file__).resolve().parents[1] / ".portbench_cache" / "pyc"


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    marks = {}
    from portbench import harness

    cells = {w["name"]: w for w in harness.benchmark()["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    marks["import_torch"] = time.perf_counter() - T_START
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the benchmark measures "
              "the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"{args.workload} needs {cells[args.workload]['chips']} "
              f"cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        __import__(harness.PROGRAM)
    except ImportError as e:
        print(f"the program {harness.PROGRAM} is not importable: {e}",
              file=sys.stderr)
        return 2
    marks["import_program"] = time.perf_counter() - T_START
    torch.set_num_threads(4)
    torch.zeros(1, device="cuda")
    marks["cuda_context"] = time.perf_counter() - T_START
    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                time.perf_counter, T_START, marks=marks)
    except harness.ForbiddenImport as e:
        print(f"forbidden module {e}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
