"""Static analysis and compile guards of the port — the port's
`go_avalanche_tpu/analysis/`.

  * `retrace` — the compile counter: a timed loop asserts that it builds
                and loads no kernel library, and `fleet.run_phase_grid`
                that a config point compiles at most once;
  * `lint`    — the port-convention AST linter: canonical-module
                spellings of the port's renamed copies, a torch-free
                `config.py`, no host or global-generator RNG in the
                round code, the round-engine seam.

CLI: ``python -m go_avalanche_tpu_torch.analysis lint`` (see `cli.py`).
The reference's `hlo_audit` (the contract audit of lowered and compiled
XLA programs, `run_sim --audit`) and `drift` (op histograms of
StableHLO text) read programs the port does not have; their torch
counterparts wait for ROADMAP item 17 part B.
"""

from go_avalanche_tpu_torch.analysis.retrace import (  # noqa: F401
    CompileCounter,
    RetraceError,
)
