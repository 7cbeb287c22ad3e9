"""The control of the comparison that decides `correct`: the plain
reference put in the program's place with the configuration's
sequential-vote guarantee broken (`vote_mode` "majority": the round's k
answers fold into one vote, as the faster batched rule of the Avalanche
paper would), run through a whole cell at its own size.  Every run must
come out not correct; the numbers it prints are the readings the
limits in `PERF.md` were set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--seconds 1]

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_program(cell_name: str, device, shape=None):
    """The reference with `vote_mode` "majority", wrapped as the cell's
    driver wraps the program."""
    from portbench import harness
    cell = harness.load_cell(cell_name)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    shape = shape or cell.config["shape"]
    return driver.Reference(harness.config_fields(cell), device,
                            shape["set_size"], vote_mode="majority")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    from portbench import harness
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = harness.run_cell(
            args.workload, seed, args.seconds, False, device,
            time.perf_counter, t0,
            program=control_program(args.workload, device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "vote_mode majority",
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
