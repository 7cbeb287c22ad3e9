"""Static analysis and compile guards of the port — the port's
`go_avalanche_tpu/analysis/`.

  * `retrace` — the compile counter: a timed loop asserts that it builds
                and loads no kernel library, and `fleet.run_phase_grid`
                that a config point compiles at most once;
  * `lint`    — the port-convention AST linter: canonical-module
                spellings of the port's renamed copies, a torch-free
                `config.py`, no host or global-generator RNG in the
                round code, the round-engine seam;
  * `drift`   — op-class histograms of one round (`op_histogram`, the
                dispatched operators and the hand-written kernels'
                launches) and the reference's `diff_histograms`;
  * `audit`   — the contract audit (the torch counterpart of the
                reference's `hlo_audit`): one round of each program
                under recorders — host reads, kernel launches, dtypes,
                collectives, donation — and `run_sim --audit`.

CLI: ``python -m go_avalanche_tpu_torch.analysis [audit|lint|all]``
(see `cli.py`).
"""

from go_avalanche_tpu_torch.analysis.retrace import (  # noqa: F401
    CompileCounter,
    RetraceError,
)
