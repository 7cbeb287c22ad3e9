"""The port's flight recorder — `go_avalanche_tpu/obs/`:

  * `sink`     — the JSONL metrics sink: host-side streaming of stacked
                 telemetry, and the in-loop tap (`emit_round`) every round
                 and scheduler step calls under `cfg.metrics_every`, whose
                 rows wait on the device until the sink drains them;
  * `manifest` — the run manifest (config, torch / CUDA versions, device
                 topology, git commit) next to a metrics file;
  * `trace`    — the trace plane: a `TraceBuffer` ``[S, M]`` carried in
                 the sim state and written by one `index_copy` per
                 emitted round (per-trial ``[F, S, M]`` in the fleet),
                 decoded to the same JSONL schema;
  * `tags`     — `config_tag`, the metric tag spelling;
  * `watchdog` — opt-in invariant checks between steps;
  * `recovery` — the recovery-curve checker of a fault script's cut
                 accounting, occupancy recovery and finality monotonicity.
"""

from go_avalanche_tpu_torch.obs.manifest import (  # noqa: F401
    manifest_dict,
    manifest_path_for,
    write_manifest,
)
from go_avalanche_tpu_torch.obs.sink import (  # noqa: F401
    MetricsSink,
    emit_round,
    metrics_sink,
)
from go_avalanche_tpu_torch.obs.recovery import (  # noqa: F401
    RecoveryReport,
    RecoveryViolation,
    check_recovery,
    verify_recovery,
    verify_recovery_fleet,
)
from go_avalanche_tpu_torch.obs.tags import config_tag  # noqa: F401
from go_avalanche_tpu_torch.obs.trace import (  # noqa: F401
    TraceBuffer,
    fleet_trace_records,
    trace_records,
    write_trace,
)
from go_avalanche_tpu_torch.obs.watchdog import (  # noqa: F401
    InvariantViolation,
    Watchdog,
    check_records,
    check_ring,
    check_ring_cut,
    check_trace,
)
