"""The metric engine tag of a config and the phase-span registry — the
port's copy of `go_avalanche_tpu/obs/tags.py`, host-only.

`config_tag` is the reference's `tag_from_config` under another name:
the JAX package's lint (`go_avalanche_tpu/analysis/lint.py`,
canonical-spelling) reserves that name to its own module, which the port
may not import.  The string is the reference's, fragment for fragment,
so a phase-grid row of the port carries the tag the reference's row
carries for the same config.

Format: empty for the all-default config; otherwise one ``", <axis>"``
fragment per non-default engine axis, in this fixed order: legacy
exchange, ingest engine, megakernel, latency (with its mode and a
timeout that differs from `default_timeout_rounds`), inflight engine,
partition, adversary policy, stake (zipf exponent, hierarchical
clusters), node registry, arrivals (backpressure, skew), metrics tap,
trace plane.
"""

from __future__ import annotations

from go_avalanche_tpu_torch.config import AvalancheConfig

# The canonical phase-span names, the reference's tuple
# (`go_avalanche_tpu/obs/tags.py:82-89`) copied exactly:
# `utils/tracing.annotate` refuses any other spelling, so every
# per-phase surface (the profiler timeline, `round_profile.py`,
# `tracing.collect_phase_times`) joins on the same keys.
PHASE_SPANS = (
    "poll_mask",          # capped per-(node, tx) pollable mask
    "sample_peers",       # committee peer draw (uniform/stake/hier)
    "gossip_admission",   # gossip scatter-max admission (gossip on)
    "gather_prefs",       # peer-preference gathers (exchange engines)
    "ingest_votes",       # RegisterVotes window ingest (u8/swar32)
    "fused_round",        # whole-round megakernel (gather+ingest+conf)
)

# Spans of the port's own: they wrap code the reference leaves
# unannotated, so they are registered beside `PHASE_SPANS`, not in it.
PORT_SPANS = (
    "retire_refill",      # a streaming scheduler's retire + refill step
    "metrics_tap",        # the in-loop telemetry tap (obs/sink.py)
    "trace_write",        # one trace-plane row write (obs/trace.py)
    # The conflict DAG round and the streaming step, whole: with the
    # spans above, every line of them that launches device work runs in
    # a named child of `round` / `stream_step`.
    "round",              # models/dag.round_step, outermost
    "stream_step",        # models/streaming_dag.step, outermost
    "key_split",          # the round's threefry key split
    "responses",          # lie draw, responded, self-draw and drop masks
    "finality",           # has_finalized tests and the finality stamp
    "telemetry",          # churn, telemetry sums, tap and trace write
    "arrivals",           # a streaming step's traffic arrivals
    "settled",            # models/dag.settled
    "init",               # models/dag.init, its host reads included
)


def default_timeout_rounds(latency_rounds: int) -> int:
    """The async bench lane's timeout: 2 * latency + 2 rounds (room for a
    round trip plus jitter before a draw is reaped).  The one copy in the
    port; `workload.flagship_config` derives its timeout from it."""
    return 2 * latency_rounds + 2


def config_tag(cfg: AvalancheConfig) -> str:
    """Metric tag fragment for this config's non-default engine axes,
    with a leading ", " (the reference's `tag_from_config`)."""
    tag = "" if cfg.fused_exchange else ", legacy-exchange"
    if cfg.ingest_engine != "u8":
        tag += f", {cfg.ingest_engine}-ingest"
    if cfg.round_engine != "phased":
        tag += ", megakernel"
    if cfg.async_queries():
        if cfg.latency_mode != "none":
            tag += f", latency{cfg.latency_rounds}"
            if cfg.latency_mode != "fixed":
                tag += f", {cfg.latency_mode}-latency"
            if cfg.timeout_rounds() != default_timeout_rounds(
                    cfg.latency_rounds):
                tag += f", timeout{cfg.timeout_rounds()}"
        if cfg.inflight_engine != "walk":
            tag += f", {cfg.inflight_engine}-inflight"
        if cfg.partition_spec is not None:
            tag += ", partition"
    if cfg.adversary_policy != "off":
        tag += f", {cfg.adversary_policy}-adversary"
    if cfg.stake_mode != "off":
        tag += f", {cfg.stake_mode}-stake"
        if cfg.stake_mode == "zipf":
            tag += f"{cfg.stake_zipf_s:g}"
        if cfg.n_clusters > 1:
            tag += f", hier{cfg.n_clusters}"
    if cfg.registry_nodes > 0:
        tag += f", registry{cfg.registry_nodes}/{cfg.active_nodes}"
    if cfg.arrivals_enabled():
        tag += f", {cfg.arrival_mode}-arrival{cfg.arrival_rate:g}"
        if cfg.arrival_backpressure is not None:
            tag += ", backpressure"
        if cfg.arrival_cluster_weights is not None:
            tag += ", arrival-skew"
    if cfg.metrics_every > 0:
        tag += f", metrics{cfg.metrics_every}"
    if cfg.trace_every > 0:
        tag += f", trace{cfg.trace_every}"
    return tag
