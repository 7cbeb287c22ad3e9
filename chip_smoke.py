#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (go_avalanche_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --config6-full-depth   # config 6 whole, one engine

Needs one NVIDIA GPU (Hopper, sm_90a) with nvcc; exits non-zero, before
printing any result, where `torch.cuda.is_available()` is false or the
package is missing.  Phases, each printing JSON lines:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel from csrc/, one nvcc per source,
               all started together;
  3. kernels — each kernel's wrapper on CUDA tensors against its plain
               PyTorch version on the same inputs, bit for bit, over the
               shapes and configs below (the two ingest kernels also
               with a ragged T, both consider-pack forms and at the DAG
               path's 10000 x 10000, each on both its paths; the two
               exchange kernels, `prefs_pack` with sets of 2 and
               `vote_packs` with k = 8, under FLIP and OPPOSE_MAJORITY
               at the DAG baseline's 10000 x 10000, config 6's 100000 x
               2048 and a ragged 333 x 2082);
  4. main    — the flagship round (16384 nodes x 16384 txs, k=8,
               `workload.flagship_state`, the reference bench's) through
               `models.avalanche.init` / `round_step`: the megakernel,
               phased-u8 (ingest kernel 1) and phased-swar32 (kernel 2)
               trajectories leaf-equal, timed rounds, and the launch
               counts of the kernels during that run (`vote_packs` once
               a phased round, `prefs_pack` never); the timed
               rounds inside `analysis.retrace.CompileCounter`, which
               must count 0 (no kernel library built or loaded there);
  5. dag     — the DAG baseline (10000 nodes x 10000 txs in 2-tx
               conflict sets, `workload.dag_baseline_state`) through
               `models.dag.run` to settlement and `run_scan`, on both
               ingest engines: leaf-equal, timed, compared with the
               reference's recorded result, launch counts (each
               exchange kernel once a round, no plain route);
  6. timing  — each kernel alone at the main path's shape, against its
               plain version and its bound, the timed launches guarded
               as phase 4's are; the exchange kernels at phase 3's two
               full shapes, under FLIP and OPPOSE_MAJORITY; the
               scheduler kernels (`settle_scan`, `refill`) at config
               6's 100000 x 2048 window, finality tracked and not;
  7. baselines — BASELINE configs 0, 1, 3 and 4 (`workload.config*`)
               through `avalanche.run`, `snowball.run` and `dag.run` on
               both ingest engines, config 4 also on the megakernel:
               leaf-equal across engines, each result compared with the
               reference's recorded one, ms per round, launches per
               kernel and per path the C entries chose, and peak
               memory; then each ingest kernel alone at Snowball's
               [1000, 1];
  8. streaming — BASELINE config 5 whole (`backlog.run`, 1024 nodes x
               4096 slots, 1,000,000 txs) and config 6 at full width
               and cut depth (`streaming_dag.run_chunked`, 100000 nodes
               x a 1024-set window of 2-tx sets, 6,400 sets), both on
               phased-u8 and phased-swar32 against the reference's
               recorded rounds and outcomes; the sparse retire cap at
               the window size against the dense run; live traffic
               (poisson arrivals with backpressure through
               `backlog.step`) with its arrivals held against a CPU
               replay of `traffic.arrive`; the node-stream registry
               (1,000,000 nodes, 16384 active, `node_stream.run_scan`)
               on all three engines with its churn held against a CPU
               replay of `churn_swaps`.  Each part prints ms per
               round, peak memory, launches per kernel and path, and
               host reads;
  9. async   — the in-flight query ring (`ops/inflight.py`, plain
               PyTorch by the reference's design: it launches none of
               the round kernels; its deliveries gather through
               `vote_packs` on the card).  Latency 0 at 16384 x 16384
               on the walk, walk_earlyout and coalesced engines, 3
               rounds leaf-equal to the synchronous round on phased-u8
               and phased-swar32 (which launch the two ingest
               kernels); the reference
               bench's `flagship_async` (latency 2, ring depth 7, 10
               rounds) and `flagship_faults` (a 50/50 partition over
               rounds [5, 10), a +2 latency spike over [12, 15); 18
               rounds) at 16384 x 16384 on the three engines, leaf-equal,
               with the ring counters gated (deliveries 0 in rounds 0-1
               and N*k after, no expiry; blocked draws exactly in rounds
               5-9, each coming back as expiries six rounds later); the
               fault studies of `examples/fault_scenarios.py` at 512 x 64
               on every engine against the JAX package's record
               (`workload.FAULT_STUDY_RECORDS`); and the DAG baseline
               (10000 x 10000, latency 1, to settlement), Snowball
               (config 1's 1000 nodes, geometric latency), `backlog.run`
               (config 5's width, latency 1, the coalesced engine, the
               backlog cut to 8192 txs) and the node stream (1,000,000
               registry nodes, 16384 active, 3 rounds) under latency,
               each against a CPU replay of the port from the same start
               (the DAG's replay cut to its first 2 rounds, the first
               with a delivery).  The replays run in a spawned process,
               started with the phase, beside the card's parts; each is
               held leaf by leaf (dtype, shape and the sha256 of the
               bytes).  Each engine prints ms per round (CUDA events),
               peak memory and host reads;
 10. adversary — the adaptive adversary (`adversary_policy`) and the
               Monte-Carlo fleet (`fleet.py`).  The flagship at
               16384 x 16384 with 20% byzantine under split_vote,
               withhold_near_quorum and stake_eclipse (zipf stake), 3
               rounds on phased-u8 and phased-swar32, leaf-equal, the
               ingest kernels launched once a round on their fast path,
               timed beside the policy-off round; the megakernel refusing
               every policy; `flagship_async` under timing and under
               withholding on the three delivery engines (walk 3
               rounds, the others 10), leaf-equal, the withheld draws
               counted as expiries; every `workload.POLICY_RECORDS` case
               on every engine it applies to, each equal to the JAX
               package's record; and the two `workload.FLEET_RECORDS`
               points (the adversary atlas's most hostile point, 16
               Snowball trials of 120 rounds, cut from the study's 48;
               an avalanche phase grid
               over the policy axis, 4 trials of 4096 x 1024), each row
               equal to the JAX package's.  Each part prints its wall
               seconds; the kernels line counts phase 4's launches and
               phase 10's;
 11. obs     — the flight recorder (`obs/`).  (a) The flagship at
               16384 x 16384 with the metrics tap and the trace plane on
               (``metrics_every=1``, ``trace_every=1``, inside a
               `metrics_sink`) bracketed by two taps-off runs, 5 rounds
               each on the megakernel, phased-u8 and phased-swar32 (the
               off time is their mean, so that neither side always runs
               first): each engine leaf-equal to its tap-off run, the
               trace rows equal to the run's stacked telemetry, the
               three trace planes equal, the tap's JSONL byte-identical
               to `write_trace`'s, each kernel launched once a round,
               the round loop's host reads those of the taps off with
               the drain read once; ms
               per round with the taps on and off; then ``trace_every=3``
               over 10 rounds (4 slots, `check_trace`) run on 6 rounds
               past the horizon (the clamp).  (b) The DAG baseline at
               10000 x 10000 on phased-u8 to settlement (17 rounds) with
               ``trace_every=1`` and `Watchdog.check` after every round.
               (c) The four fault studies at 512 x 64 on the coalesced
               engine, traced, the watchdog (`check_ring_cut` included)
               after every round, each `check_recovery` report equal to
               `workload.RECOVERY_RECORDS`.  (d) The atlas's most hostile
               point traced (8 Snowball trials) and the policy grid's
               split_vote point (4 trials of 4096 x 1024, launching
               `vote_u8` in the fleet), each fleet-stacked trace JSONL's
               sha256 equal to `workload.FLEET_TRACE_RECORDS`, the atlas's
               stall verdicts checked against the trace finality curves.
               (e) `backlog.run_scan` at config 5's width (200 rounds,
               ``trace_every=10``) and the node stream (1,000,000
               registry nodes, 16384 x 4096, 3 rounds), each trace equal
               to the stacked telemetry of the same call.  Phase 11's
               launches print on a line of their own, outside the
               kernels line;
 12. host    — the host surfaces.  (a) `run_sim.main` in process at the
               flagship's width (16384 x 16384, k=8, gossip off, the poll
               cap over every tx, score 32766, 5 rounds) on the
               megakernel, phased-u8 and phased-swar32: the three result
               dicts equal apart from `elapsed_s`, each equal to a direct
               `avalanche.run` at the config `run_sim.parse_args` gives,
               each engine's kernel launched once a round, wall seconds
               per engine.  (b) Config 6 at full width (100000 nodes, a
               1024-set window of 2-tx sets) cut to 3 chunks of 8
               rounds: `run_chunked` saving a checkpoint every chunk,
               killed at the second boundary once the first save landed,
               `restore_checkpoint` and run on to the same depth,
               leaf-equal to an uninterrupted run; save seconds, bytes
               and 64 MiB transfer blocks.  (c) `ConnectorServer` on the
               card over loopback, driven by the port's client: SIM_INIT
               avalanche at 16384 x 4096, SIM_RUN 5 + 5 equal to a direct
               10-round `run_scan`; an external-arrival backlog (config
               5's width) fed by SIM_SUBMIT, equal to the same pushes
               made directly; and the C++ harness
               (`native/connector/harness_main.cc`) against the server
               when `make -C native` builds.  The kernels line's launches
               add phase 12's.
 13. mesh    — the sharded drivers (`parallel/`) on the one card, every
               rank's ingest kernel on its block.  The kernels are built
               (phase 2) before any rank starts; ranks are spawned and
               only load them.  (a) A 1x1 mesh in this process (NCCL,
               world 1): the flagship at 16384 x 16384 with 20%
               byzantine (`workload.mesh_flagship_state`), 5 rounds of
               `run_scan_sharded` on phased-u8 and phased-swar32,
               leaf-equal, one launch a round each, ms a round beside
               the dense phased round.  (b) Gloo ranks sharing the card
               at 8192 x 8192: 1x2 and 1x4 leaf-equal to 1x1, 2x2 to 2x1
               (the tx-only contract), compared tile by tile
               (`tile_digests`), each mesh's ms a round, host-staged
               collectives and ingest paths.  (c) `workload.SHARDED_CASES`
               (4096 x 4096 on 1x1, 2x1, 4x1; the DAG at 2048 x 2048 to
               settlement on 1x1, 2x1), every leaf and telemetry digest
               equal to the JAX package's `SHARDED_RECORDS`, every set
               settled.  (d) The policy grid's "off" point over a 2-rank
               fleet mesh, equal to its `FLEET_RECORDS` row.  (e) The
               distributed smoke as two processes.  Part streaming, the
               streaming drivers: (f) config 6's width (100000 nodes, a
               1024-set window of 2-tx sets) with its backlog cut to
               2048 sets, to settlement through the sharded streaming
               DAG on the 1x1 NCCL mesh on u8 and swar32 (leaf-equal,
               one launch a round, all on the fast path, gated as phase
               8 is, beside the dense round), and on 1x2 gloo ranks
               equal to 1x1 tile by tile but for the per-shard rank
               leaves, saved with the DCP pair at round 17, restored and
               run on to an equal end; (g) config 5's width (1024 x a
               4096-slot window) with 16,384 txs through the sharded
               backlog to settlement on 1x1 and 2x1, equal outputs; (h)
               the 1M-node registry (16384 active x 4096 txs, 3 rounds)
               through the sharded node stream on 1x1 and 2x1, its
               working set equal to the dense `run_scan`'s; (i) every
               `workload.STREAMING_SHARDED_RECORDS` digest on 1x1, 2x1
               and 1x2.  A rank's failure or a rank silent for
               `MESH_TIMEOUT` s fails the phase, as does a DCP error.
               The kernels line's launches add phase 13's, every
               rank's.
 14. resources — the resource and tracing plane on the flagship
               (16384 x 16384, k=8).  (a) On the megakernel, phased-u8
               and phased-swar32: the state's analytic footprint
               (`obs/resources.footprint`, 2,416,230,412 bytes in the
               reference's dtypes, 8 more on the card for the key)
               against its allocation and one round's ledger
               (`memory_record`: allocated state, round peak, live
               bytes once the old state is released), held by
               `check_memory`; (b) two replays of one round from the
               same state, byte-equal (`utils/tracing.
               determinism_audit`); (c) `collect_phase_times` over 3
               phased-u8 rounds, wall ms per span, the spans' sum
               within the rounds' wall; (e) `run_sim --report-memory`
               at the flagship's width, its report on stderr and its
               stdout result equal to the same run's without the flag.
               (d), the compile guards of phases 4 and 6, prints here.
               The kernels line's launches add phase 14's.
 15. audit   — (a) `--fleet-shape auto` at 16384 x 16384 picks F from
               the card's knee table (`obs/knee.py`, the card's own
               memory); F flagship trials stacked in place
               (`workload.fleet_flagship_state`) and scanned 2 rounds
               by `parallel/sharded_fleet.fleet_scan_program` on a 1x1
               NCCL mesh: `vote_u8` launched 2F times, all on its fast
               path; the measured peak under the row's modelled peak
               under 90% of the card; `check_memory` clean on the
               stack (one more round); the first and last trial
               leaf-equal to the dense flagship round from their own
               keys; `--fleet 64` refused citing its row.  (b) The
               contract audit (`analysis/audit.py`) of the 14 programs
               at their audit shapes on the card, then of the three
               flagship engines at 16384 x 16384: clean, the kernel of
               each launched exactly once in its round, no sync outside
               `sync.py` (CUDA's sync debug mode), the op histogram of
               each.  (c) `obs/resources.sharded_driver_records` in 4
               gloo ranks sharing the card: each driver's allocated
               block equal to its analytic per-rank footprint.  (d)
               ``python -m go_avalanche_tpu_torch.analysis all`` exits
               0 on the card.  The kernels line's launches add phase
               15's (a), (b) and (c).
 16. examples — the protocol studies of `examples/` on their twins
               (`go_avalanche_tpu_torch/examples/`).  (a) The recorded
               cells the JAX package's own replays hold, at their
               recorded shapes, each equal to the value read from
               `examples/out/*.json` (`examples/recorded.py`; the
               quorum-dial safety cell on its first seed), with its
               seconds, rounds and `vote_u8` launches by path (the
               churn cell's skip semantics launches none, by design),
               each cell in a spawned process of its own.  (b) Every
               twin's `main` at a small shape on the card and
               with ``--device cpu``: the result dicts equal without
               their times, rates, `backend` and `card`; `vote_u8`
               launched in every study but `fault_scenarios` (the
               async ring, plain PyTorch by the reference's design),
               which launches no kernel; nothing launched on the CPU.
               The kernels line's launches add phase 16's card runs.

Phases 7-14 are bound by the host, so they run in three lanes at once
(`LANES`): the first lane in this process, each other one in a spawned
process, each lane its phases one after another (phase 8 in two parts:
config 5, then the rest).  Their lines print in phase order once every
lane has ended; a lane's failure fails the script and stops the other
lanes.  Phases 15 and 16 then run alone.  Every phase's seconds (its
own lane's) print on a line of their own before the kernels line.

With ``--config6-full-depth`` it builds the kernels and runs only BASELINE
config 6 at full width and full depth (500,000 sets, ~8313 rounds,
`streaming_dag.run_chunked` on phased-u8) against the reference's
recorded result, printing progress to stderr.

The second-to-last line is the kernels summary, the last line
``{"ok": true, "device": {...}}``.  `read_launches` and the phases'
checks count the round kernels (the megakernel and the two ingest
kernels, one launch a round on their engines); the exchange kernels,
which run inside the phased and DAG rounds, are counted by
`read_exchange` and held to the rounds in phases 4 and 5, and their
rows of the kernels line count those two phases' launches.  Any failure
raises and exits non-zero.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import sys
import time
from unittest import mock

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
# H100 SXM int32 rate outside the tensor cores: 132 SMs x 64 int32
# lanes x ~1.98 GHz (67e12/s is its fp32 FMA rate, not an integer one)
INT_OPS_PER_S = 1.67e13
TIMED_ROUNDS = 20
PHASED_TIMED_ROUNDS = 3
SOURCES = ("megakernel", "vote_u8", "vote_swar", "exchange", "scheduler")
# The megakernel: one thread per 16 columns, 256 a block, so 1184 and
# 2080 leave the last block of a row part empty.
KERNEL_SHAPES = ((2048, 2048), (1000, 1184), (333, 2080))
KERNEL_CASES = {
    "base": dict(),
    "flip_byz0.2": dict(byzantine_fraction=0.2),
    "oppose_byz0.2": dict(byzantine_fraction=0.2,
                          adversary_strategy="oppose_majority"),
    "k3_q2_w3": dict(k=3, quorum=2, window=3),
    "score7fff": dict(finalization_score=0x7FFF),
    "k1_w3_q2": dict(k=1, window=3, quorum=2),
}
# The ingest kernels: 333 x 1001 has N*T % 4 == 1, a ragged last word;
# 1000 x 1180 (T % 16 != 0) and 333 x 1001 take each kernel's general
# path, the others its fast path.
INGEST_SHAPES = ((2048, 2048), (1000, 1184), (333, 1001), (1000, 1180))
INGEST_CASES = {                # config knobs, consider-pack form, masked
    "base": (dict(), "stride0", True),
    "plane_pack": (dict(), "plane", True),
    "k3_q2_w3": (dict(k=3, quorum=2, window=3), "stride0", True),
    "saturated_score7fff": (dict(finalization_score=0x7FFF), "plane", True),
    "unmasked": (dict(), "stride0", False),
    "k1_w3_q2": (dict(k=1, window=3, quorum=2), "stride0", True),
    "k5_w6_q4_score1": (dict(k=5, window=6, quorum=4, finalization_score=1),
                        "plane", True),
}
# The exchange kernels: the DAG baseline's 10000 x 10000 and config 6's
# 100000 nodes x a 1024-set window of 2-tx sets (the two benchmark
# cells' shapes), timed in phase 6; 333 x 2082 (T % 8 != 0) takes each
# kernel's general path.  Sets of 2 and k = 8 throughout.
EXCHANGE_SHAPES = ((10_000, 10_000), (100_000, 2048))
EXCHANGE_CHECK_SHAPES = EXCHANGE_SHAPES + ((333, 2082),)
EXCHANGE_STRATEGIES = ("flip", "oppose_majority")
EXCHANGE_SET_SIZE = 2
# The scheduler kernels at config 6's window (100000 nodes x 1024 sets of
# 2), timed in phase 6 with finality tracking on and off.
SCHEDULER_SHAPE = (100_000, 2048)
# The reference's recorded DAG baseline (benchmarks/results.json, the
# "avalanche DAG (10000 nodes, 10000-tx UTXO conflict graph)" row).
DAG_REFERENCE = {"rounds": 17, "sets_resolved_fraction": 1.0,
                 "finality_median": 16.0}
DAG_MAX_ROUNDS = 100


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_config(torch_cfg, knobs: dict):
    knobs = dict(knobs)
    if "adversary_strategy" in knobs:
        knobs["adversary_strategy"] = torch_cfg.AdversaryStrategy(
            knobs["adversary_strategy"])
    return torch_cfg.AvalancheConfig(round_engine="megakernel", **knobs)


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def guarded_time_ms(fn, reps: int, what: str) -> tuple:
    """`time_ms` inside `analysis.retrace.CompileCounter`, which must
    count 0: the warm-up built and loaded every kernel library the timed
    loop launches.  Returns (ms, compiles)."""
    from go_avalanche_tpu_torch.analysis.retrace import CompileCounter

    with CompileCounter() as compiles:
        ms = time_ms(fn, reps)
    compiles.expect_at_most(0, what)
    return ms, compiles.count


def random_ints(g, lo: int, hi: int, shape, dtype=None):
    import torch

    return torch.randint(lo, hi, shape, generator=g, device=g.device,
                         dtype=dtype or torch.int64)


def random_records(n: int, t: int, cfg, g):
    """Random ``[N, T]`` records: windows of the config's width, counters
    spread over the whole range, around the finalization score and at
    the 0x7FFF ceiling (all at the ceiling when the score is 0x7FFF)."""
    import torch

    from go_avalanche_tpu_torch.ops import voterecord as vr

    wm = (1 << cfg.window) - 1
    kind = random_ints(g, 0, 3, (n, t))
    if cfg.finalization_score == 0x7FFF:
        kind = torch.where(kind == 0, 2, kind)
    counter = torch.where(
        kind == 0, random_ints(g, 0, 0x8000, (n, t)),
        torch.where(kind == 1,
                    (cfg.finalization_score
                     - random_ints(g, -2, 9, (n, t))).clamp(0, 0x7FFF),
                    0x7FFF - random_ints(g, 0, 3, (n, t))))
    confidence = (counter << 1) | random_ints(g, 0, 2, (n, t))
    return vr.VoteRecordState(
        random_ints(g, 0, 256, (n, t), torch.uint8) & wm,
        random_ints(g, 0, 256, (n, t), torch.uint8) & wm,
        vr.narrow_confidence(confidence))


def random_round_inputs(n: int, t: int, cfg, device, seed: int):
    """One round's megakernel inputs: random records, preferences,
    peers, flags and the polled mask.  A draw lies with the config's
    byzantine fraction, so the base config has no lies, as in the
    round."""
    import torch

    from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

    g = torch.Generator(device=device).manual_seed(seed)

    def coins(p, shape):
        return torch.rand(shape, generator=g, device=device) < p

    records = random_records(n, t, cfg, g)
    return (records, pack_bool_plane(coins(0.5, (n, t))),
            random_ints(g, 0, n, (n, cfg.k), torch.int32),
            coins(0.85, (n, cfg.k)),
            coins(cfg.byzantine_fraction, (n, cfg.k)), coins(0.5, (t,)),
            coins(0.7, (n, t)))


def outputs_max_abs_err(got, want) -> int:
    """Largest integer difference over every output plane (0 = equal)."""
    import torch

    (grec, gchanged), (wrec, wchanged) = got, want
    err = 0
    for a, b in zip((*grec, gchanged), (*wrec, wchanged)):
        if a.dtype == torch.int16:    # uint16 bit patterns
            a, b = a.to(torch.int32) & 0xFFFF, b.to(torch.int32) & 0xFFFF
        err = max(err, int((a.to(torch.int32) - b.to(torch.int32))
                           .abs().max()))
    return err


def megakernel_bound(n: int, t: int, k: int):
    """(bound_ms, bound_by): each input read once, each output written
    once, over the memory rate; N*T*k vote ingests (one operation each
    at least) over the 32-bit rate."""
    record_in = n * t * (1 + 1 + 2 + 1)     # votes, consider, conf, polled
    record_out = n * t * (1 + 1 + 2 + 1)    # votes, consider, conf, changed
    side = n * t // 8 + n * k * (4 + 1 + 1) + t // 8
    bytes_ms = (record_in + record_out + side) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * t * k / INT_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def random_ingest_inputs(n: int, t: int, cfg, device, seed: int,
                         pack_form: str = "stride0", masked: bool = True):
    """One ingest call's inputs: random records, a random yes pack, the
    consider pack as the fused exchange's stride-0 ``[N, 1] -> [N, T]``
    view or as a contiguous plane, and a random update mask (or None)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    records = random_records(n, t, cfg, g)
    column = random_ints(g, 0, 256, (n, 1), torch.uint8).expand(n, t)
    consider_pack = column if pack_form == "stride0" else column.contiguous()
    mask = (torch.rand((n, t), generator=g, device=device) < 0.7
            if masked else None)
    return (records, random_ints(g, 0, 256, (n, t), torch.uint8),
            consider_pack, mask)


def ingest_bound(n: int, t: int, k: int):
    """(bound_ms, bound_by) of one ingest launch: votes, consider, yes
    pack, mask (1 B) and confidence (2 B) read, votes, consider, changed
    (1 B) and confidence (2 B) written, per record, plus the N-byte
    broadcast consider pack; N*T*k vote ingests at one operation each."""
    bytes_ms = (n * t * (6 + 5) + n) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * t * k / INT_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                            "operations")


def ingest_kernels():
    """name -> (kernel wrapper, plain version) of the two ingest
    kernels."""
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    return {"vote_u8": (pv.register_packed_votes_cuda,
                        pv.register_packed_votes_plain),
            "vote_swar": (pv.register_packed_votes_cuda_swar,
                          pv.register_packed_votes_swar_plain)}


def check_ingest_cases(shapes, device="cuda") -> dict:
    """Phase 3, ingest kernels: each against its plain version, every
    shape in `shapes` and every case; returns each kernel's largest
    error (must be 0)."""
    import torch

    from go_avalanche_tpu_torch.config import AvalancheConfig

    worst = {}
    for name, (kernel, plain) in ingest_kernels().items():
        worst[name] = 0
        for n, t in shapes:
            for case, (knobs, pack_form, masked) in INGEST_CASES.items():
                cfg = AvalancheConfig(**knobs)
                args = random_ingest_inputs(n, t, cfg, device, n + t,
                                            pack_form, masked)
                got = kernel(*args[:3], cfg.k, cfg, args[3])
                torch.cuda.synchronize()
                want = plain(*args[:3], cfg.k, cfg, args[3])
                torch.cuda.synchronize()
                err = outputs_max_abs_err(got, want)
                emit({"phase": "kernel_check", "kernel": name,
                      "shape": [n, t], "case": case, "max_abs_err": err,
                      "tolerance": 0, "changed": int(got[1].sum())})
                if err:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {(n, t)} {case}: "
                                         f"max_abs_err {err}")
                worst[name] = max(worst[name], err)
    return worst


def check_kernel_cases(device="cuda") -> int:
    """Phase 3, megakernel: the kernel against its plain version, every shape and
    config; returns the largest error seen (must be 0)."""
    import torch

    from go_avalanche_tpu_torch import config as torch_cfg
    from go_avalanche_tpu_torch.ops import megakernel

    worst = 0
    for n, t in KERNEL_SHAPES:
        for name, knobs in KERNEL_CASES.items():
            cfg = kernel_config(torch_cfg, knobs)
            args = random_round_inputs(n, t, cfg, device, seed=n + t)
            got = megakernel.fused_round(*args, cfg)
            torch.cuda.synchronize()
            want = megakernel.fused_round_reference(*args, cfg)
            torch.cuda.synchronize()
            err = outputs_max_abs_err(got, want)
            emit({"phase": "kernel_check", "kernel": "megakernel",
                  "shape": [n, t], "case": name, "max_abs_err": err,
                  "tolerance": 0,
                  "changed": int(got[1].sum())})
            if err:
                raise AssertionError(f"megakernel disagrees with its plain "
                                     f"version at {(n, t)} {name}: "
                                     f"max_abs_err {err}")
            worst = max(worst, err)
    return worst


def exchange_config(strategy: str):
    """The exchange kernels' config: a fifth of the draws lie, by
    `strategy`."""
    from go_avalanche_tpu_torch.config import (AdversaryStrategy,
                                               AvalancheConfig)

    return AvalancheConfig(byzantine_fraction=0.2,
                           adversary_strategy=AdversaryStrategy(strategy))


def random_exchange_inputs(n: int, t: int, cfg, device, seed: int):
    """One DAG round's exchange inputs: ``(confidence, peers, responded,
    lie)``.  Half the int16 confidence words come from a few values (0,
    1, 0x7FFF, 0x8000, 0xFFFF as u16) so that sets hold ties and words
    the int16 reads as negative; peers, responded and lie draws as the
    round makes them (a draw lies with the config's byzantine
    fraction)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    few = torch.tensor([0, 1, 0x7FFF, -0x8000, -1], dtype=torch.int16,
                       device=device)
    confidence = torch.where(
        torch.rand((n, t), generator=g, device=device) < 0.5,
        few[random_ints(g, 0, len(few), (n, t))],
        random_ints(g, -0x8000, 0x8000, (n, t), torch.int16))
    return (confidence, random_ints(g, 0, n, (n, cfg.k), torch.int32),
            torch.rand((n, cfg.k), generator=g, device=device) < 0.85,
            torch.rand((n, cfg.k), generator=g, device=device)
            < cfg.byzantine_fraction)


def plain_prefs_pack(confidence, cfg) -> tuple:
    """`prefs_pack`'s plain version: the packed preferred-in-set plane
    of sets of `EXCHANGE_SET_SIZE`, and the minority colours under
    OPPOSE_MAJORITY (else the all-False ``[T]`` the kernel's wrapper
    hands on)."""
    import torch

    from go_avalanche_tpu_torch.config import AdversaryStrategy
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.ops import adversary
    from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

    prefs = dag.preferred_in_set_fixed(confidence, EXCHANGE_SET_SIZE)
    if cfg.adversary_strategy is AdversaryStrategy.OPPOSE_MAJORITY:
        minority = adversary.minority_plane(prefs)
    else:
        minority = torch.zeros(prefs.shape[1], dtype=torch.bool,
                               device=prefs.device)
    return pack_bool_plane(prefs), minority


def exchange_calls(n: int, t: int, strategy: str, device, seed: int):
    """kernel -> (kernel call, plain call) of the two exchange kernels
    on one set of `random_exchange_inputs`; `vote_packs` gathers the
    plain `prefs_pack`'s plane and colours."""
    from go_avalanche_tpu_torch.ops import exchange

    cfg = exchange_config(strategy)
    confidence, peers, responded, lie = random_exchange_inputs(
        n, t, cfg, device, seed)
    packed, minority = plain_prefs_pack(confidence, cfg)
    votes = (packed, peers, responded, lie)
    return {
        "prefs_pack": (
            lambda: exchange.prefs_pack(confidence, EXCHANGE_SET_SIZE, cfg),
            lambda: plain_prefs_pack(confidence, cfg)),
        "vote_packs": (
            lambda: exchange.vote_packs(*votes, cfg, minority, t),
            lambda: exchange.fused_vote_packs(*votes, None, cfg, minority,
                                              t)),
    }


def planes_max_abs_err(got, want) -> int:
    """Largest integer difference over two tuples of planes of the
    same shapes (0 = equal)."""
    import torch

    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape:
            raise AssertionError(f"shapes differ: {tuple(a.shape)} != "
                                 f"{tuple(b.shape)}")
        err = max(err, int((a.to(torch.int32) - b.to(torch.int32))
                           .abs().max()))
    return err


def check_exchange_cases(shapes, device="cuda") -> dict:
    """Phase 3, exchange kernels: each against its plain version at
    every shape in `shapes` under each of `EXCHANGE_STRATEGIES`; returns
    each kernel's largest error (must be 0)."""
    import torch

    worst = {"prefs_pack": 0, "vote_packs": 0}
    for n, t in shapes:
        for strategy in EXCHANGE_STRATEGIES:
            calls = exchange_calls(n, t, strategy, device, n + t)
            for name, (kernel, plain) in calls.items():
                got = kernel()
                _synchronize(device)
                err = planes_max_abs_err(got, plain())
                emit({"phase": "kernel_check", "kernel": name,
                      "shape": [n, t], "case": strategy,
                      "max_abs_err": err, "tolerance": 0})
                if err:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at {(n, t)} {strategy}: "
                                         f"max_abs_err {err}")
                worst[name] = max(worst[name], err)
            del calls
            _empty_cache(device)
    return worst


def assert_states_equal(a, b, where: str) -> None:
    import torch

    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if field == "records":
            for leaf, xx, yy in zip(x._fields, x, y):
                if not torch.equal(xx, yy):
                    raise AssertionError(f"{where}: records.{leaf} differ")
        elif (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{where}: {field} differs")


def assert_telemetry_equal(a, b, where: str) -> None:
    for field, x, y in zip(a._fields, a, b):
        if not bool((x == y).all()):
            raise AssertionError(f"{where}: telemetry.{field} differs")


def reset_launches() -> None:
    from go_avalanche_tpu_torch.ops import exchange, megakernel, scheduler
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    megakernel.launches = 0
    for name in pv.launches:
        pv.launches[name] = 0
        pv.path_launches[name] = {"fast": 0, "any": 0}
    for name in exchange.launches:
        exchange.launches[name] = 0
        exchange.plain_routes[name] = 0
    for name in scheduler.launches:
        scheduler.launches[name] = 0
        scheduler.plain_routes[name] = 0


def read_launches() -> dict:
    from go_avalanche_tpu_torch.ops import megakernel
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    return {"megakernel": megakernel.launches, **pv.launches}


def read_exchange() -> dict:
    """The exchange kernels' launches, and the calls on card tensors
    that took the plain path instead."""
    from go_avalanche_tpu_torch.ops import exchange

    return {"launches": dict(exchange.launches),
            "plain_routes": dict(exchange.plain_routes)}


def check_exchange(where: str, want: dict) -> dict:
    """`read_exchange`, which must count `want` launches and no plain
    route."""
    got = read_exchange()
    if got != {"launches": want, "plain_routes": dict.fromkeys(want, 0)}:
        raise AssertionError(f"{where}: exchange {got}, want {want} "
                             f"launches and no plain route")
    return got["launches"]


def read_scheduler() -> dict:
    """The scheduler kernels' launches, and the calls on card tensors
    that took the plain path instead."""
    from go_avalanche_tpu_torch.ops import scheduler

    return {"launches": dict(scheduler.launches),
            "plain_routes": dict(scheduler.plain_routes)}


def scheduler_want(device, scans: int, refills: int,
                   plain_refills: int = 0) -> dict:
    """`read_scheduler`'s count after `scans` settle tests and `refills`
    dense refills through the kernels and `plain_refills` retire-cap
    column rewrites: on CPU tensors nothing is counted."""
    on_card = torch_device_type(device) == "cuda"
    return {"launches": {"settle_scan": scans if on_card else 0,
                         "refill": refills if on_card else 0},
            "plain_routes": {"settle_scan": 0,
                             "refill": plain_refills if on_card else 0}}


def read_path_launches() -> dict:
    """Each ingest kernel's launches by the path its C entry took."""
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    return {name: dict(paths) for name, paths in pv.path_launches.items()}


def run_main_path(n: int, t: int, timed_rounds: int, device="cuda") -> dict:
    """Phase 4: the flagship round through the entry points, on the
    megakernel, phased-u8 and phased-swar32 engines.  Launch counts are
    reset just before and read just after."""
    import torch

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av

    start, mega_cfg = workload.flagship_state(n, t, round_engine="megakernel",
                                              device=device)
    cfgs = {"megakernel": mega_cfg,
            "vote_u8": workload.flagship_config(t),
            "vote_swar": dataclasses.replace(workload.flagship_config(t),
                                             ingest_engine="swar32")}
    rounds = dict.fromkeys(cfgs, 0)
    torch.cuda.synchronize()

    reset_launches()
    states = dict.fromkeys(cfgs, start)
    for r in range(3):
        tels = {}
        for name, cfg in cfgs.items():
            states[name], tels[name] = av.round_step(states[name], cfg)
            rounds[name] += 1
        for name in ("vote_u8", "vote_swar"):
            assert_telemetry_equal(tels["megakernel"], tels[name],
                                   f"round {r}, megakernel vs {name}")
    for name in ("vote_u8", "vote_swar"):
        assert_states_equal(states["megakernel"], states[name],
                            f"megakernel vs phased {name} after 3 rounds")

    compiles = {}

    def timed(name: str, warm: int, reps: int) -> float:
        def one_round():
            states[name] = av.round_step(states[name], cfgs[name])[0]
            rounds[name] += 1

        for _ in range(warm):
            one_round()
        torch.cuda.synchronize()
        ms, compiles[name] = guarded_time_ms(
            one_round, reps, f"phase 4's timed {name} rounds")
        return ms

    round_ms = timed("megakernel", 2, timed_rounds)
    phased_ms = {name: timed(name, 1, PHASED_TIMED_ROUNDS)
                 for name in ("vote_u8", "vote_swar")}
    launches = read_launches()
    if launches != rounds:
        raise AssertionError(f"launches {launches} != rounds per engine "
                             f"{rounds}")
    # The phased rounds gather through `vote_packs` on the card; the
    # megakernel gathers inside its own launch.
    phased = rounds["vote_u8"] + rounds["vote_swar"]
    exchange_launches = check_exchange("main", {
        "prefs_pack": 0,
        "vote_packs": phased if torch.device(device).type == "cuda" else 0})
    state = states["megakernel"]
    if int(state.round) != 3 + 2 + timed_rounds:
        raise AssertionError("round counter did not advance per round")
    if int(state.records.votes.sum()) == 0:
        raise AssertionError("no vote reached the windows")
    return {"launches": launches, "exchange_launches": exchange_launches,
            "rounds": rounds, "timed_compiles": compiles,
            "round_ms": round_ms,
            "phased_u8_round_ms": phased_ms["vote_u8"],
            "phased_swar32_round_ms": phased_ms["vote_swar"],
            "votes_per_s": n * t * mega_cfg.k / (round_ms / 1e3),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def assert_dag_states_equal(a, b, where: str) -> None:
    import torch

    if (a.n_sets, a.set_size) != (b.n_sets, b.set_size) or not torch.equal(
            a.conflict_set, b.conflict_set):
        raise AssertionError(f"{where}: partitions differ")
    assert_states_equal(a.base, b.base, where)


def finality_median(finalized_at) -> float:
    """The median finalization round over finalized records (numpy's
    `median`, from a histogram of the rounds)."""
    import torch

    done = finalized_at[finalized_at >= 0].long()
    counts = torch.bincount(done).cumsum(0)
    total = int(counts[-1])
    lo = int(torch.searchsorted(counts, (total - 1) // 2, right=True))
    hi = int(torch.searchsorted(counts, total // 2, right=True))
    return (lo + hi) / 2


def run_dag(n: int, t: int, device="cuda") -> dict:
    """Phase 5: the DAG baseline to settlement on both ingest engines
    (`dag.run`, timed), then the same rounds again by `dag.run_scan` for
    the per-round telemetry; everything leaf-equal across the engines.
    Launch counts are reset just before and read just after."""
    import torch

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.ops import voterecord as vr

    start, u8_cfg = workload.dag_baseline_state(n, t, device=device)
    cfgs = {"vote_u8": u8_cfg,
            "vote_swar": dataclasses.replace(u8_cfg, ingest_engine="swar32")}
    torch.cuda.synchronize()

    reset_launches()
    finals, rounds, ms_per_round, scans = {}, {}, {}, {}
    for name, cfg in cfgs.items():
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        finals[name] = dag.run(start, cfg, max_rounds=DAG_MAX_ROUNDS,
                               device=device)
        end.record()
        torch.cuda.synchronize()
        rounds[name] = int(finals[name].base.round)
        ms_per_round[name] = begin.elapsed_time(end) / rounds[name]
    for name, cfg in cfgs.items():
        scans[name] = dag.run_scan(start, cfg, n_rounds=rounds["vote_u8"],
                                   device=device)
    launches = read_launches()

    if rounds["vote_u8"] != rounds["vote_swar"]:
        raise AssertionError(f"rounds to settlement differ: {rounds}")
    assert_dag_states_equal(finals["vote_u8"], finals["vote_swar"],
                            "dag u8 vs swar32 at settlement")
    for name in cfgs:
        assert_dag_states_equal(scans[name][0], finals["vote_u8"],
                                f"dag run_scan {name} vs run")
    assert_telemetry_equal(scans["vote_u8"][1], scans["vote_swar"][1],
                           "dag run_scan u8 vs swar32")
    expect = {name: 2 * rounds[name] for name in cfgs}
    if {name: launches[name] for name in cfgs} != expect or launches[
            "megakernel"]:
        raise AssertionError(f"dag launches {launches} != {expect}")
    # One of each exchange kernel a round on the card.
    each = (sum(expect.values()) if torch.device(device).type == "cuda"
            else 0)
    exchange_launches = check_exchange("dag", {"prefs_pack": each,
                                               "vote_packs": each})

    final = finals["vote_u8"]
    if not bool(dag.settled(final, u8_cfg)):
        raise AssertionError("dag baseline did not settle in "
                             f"{DAG_MAX_ROUNDS} rounds")
    conf = final.base.records.confidence
    fin_acc = vr.has_finalized(conf, u8_cfg) & vr.is_accepted(conf)
    result = {
        "rounds": rounds["vote_u8"],
        "sets_resolved_fraction": float(
            (dag.winners_per_set(fin_acc, 2) == 1).float().mean()),
        "finality_median": finality_median(final.base.finalized_at),
    }
    if result != DAG_REFERENCE:
        raise AssertionError(f"dag baseline {result} != the reference's "
                             f"{DAG_REFERENCE}")
    tel = scans["vote_u8"][1]
    return {**result, "reference": DAG_REFERENCE,
            "ms_per_round": ms_per_round, "launches": launches,
            "exchange_launches": exchange_launches,
            "polls": int(tel.polls.sum()),
            "finalizations": int(tel.finalizations.sum()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


# Config 3's EQUIVOCATE runs to its gate at the quick shape (512 x 64,
# 400 rounds), on the JAX package's own result there: at 100000 x 512 its
# per-draw coin planes through the int64 threefry cost ~0.5 s a round,
# ~10 minutes for 600 rounds on both engines (PERF.md section 4).  The
# full shape runs this many rounds on each engine, timed and leaf-equal,
# to keep that cost measured.
EQUIVOCATE_FULL_ROUNDS = 3


def ingest_path(t: int) -> str:
    """Which path of an ingest kernel a round with T txs should take:
    T % 16 == 0 its fast path (`<kernel>_kernel<K, CONS_ROW>`), anything
    else its general path (`<kernel>_kernel_any`).  The rounds' planes
    are fresh allocations and their packs row broadcasts, so T decides;
    the baselines phase holds the C entries' own choice
    (`read_path_launches`) to this.  Snowball ingests [N, 1] records."""
    return "fast" if t % 16 == 0 else "any"


def timed_run(run, *args, **kwargs):
    """``(result, device ms)`` of one call, by CUDA events."""
    import torch

    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = run(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return out, begin.elapsed_time(end)


def finality_stats(finalized_at) -> dict:
    done = finalized_at[finalized_at >= 0]
    return {"finality_median": finality_median(finalized_at),
            "finality_min": int(done.min()), "finality_max": int(done.max())}


def check_result(name: str, got: dict, want: dict) -> None:
    picked = {key: got[key] for key in want}
    if picked != want:
        raise AssertionError(f"{name}: {picked} != the reference's {want}")


def run_engines(name: str, run, start, cfgs: dict, rounds_of, equal):
    """Run `start` on every engine config of `cfgs` with `run`; checks
    the finals leaf-equal to the first and returns ``(final, ms per
    round per engine, rounds per engine)``."""
    finals, ms, rounds = {}, {}, {}
    for engine, cfg in cfgs.items():
        finals[engine], total_ms = timed_run(run, start, cfg)
        rounds[engine] = rounds_of(finals[engine])
        ms[engine] = total_ms / max(rounds[engine], 1)
    first = next(iter(cfgs))
    for engine in cfgs:
        if rounds[engine] != rounds[first]:
            raise AssertionError(f"{name}: rounds differ {rounds}")
        equal(finals[engine], finals[first], f"{name} {engine} vs {first}")
    return finals[first], ms, rounds


def baseline_engines(cfg, megakernel: bool = False) -> dict:
    """engine -> config: phased u8 and swar32, and the megakernel."""
    cfgs = {"u8": dataclasses.replace(cfg, ingest_engine="u8"),
            "swar32": dataclasses.replace(cfg, ingest_engine="swar32")}
    if megakernel:
        cfgs["megakernel"] = dataclasses.replace(cfg,
                                                 round_engine="megakernel")
    return cfgs


def run_baselines(quick: bool = False, device="cuda") -> dict:
    """Phase 7: BASELINE configs 0, 1, 3 and 4 through the port's entry
    points on every engine, each compared with the reference's recorded
    result (`workload.REFERENCE`; at a quick shape the JAX package's own,
    `workload.REFERENCE_QUICK`).  Launch counts are reset just before
    and read just after; every launch must belong to a counted round,
    and each ingest kernel's launches must split between its paths as
    `ingest_path` expects."""
    import torch

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import dag, snowball
    from go_avalanche_tpu_torch.ops import voterecord as vr

    def av_rounds(s):
        return int(s.round)

    def dag_rounds(s):
        return int(s.base.round)

    def reference(name: str, small: bool) -> dict:
        return (workload.REFERENCE_QUICK if small
                else workload.REFERENCE)[name]

    configs = {}
    expect = {"vote_u8": 0, "vote_swar": 0, "megakernel": 0}
    by_path = {"vote_u8": {"fast": 0, "any": 0},
               "vote_swar": {"fast": 0, "any": 0}}
    kernel_of = {"u8": "vote_u8", "swar32": "vote_swar",
                 "megakernel": "megakernel"}
    torch.cuda.synchronize()
    reset_launches()

    def record(name, result, ms, rounds, reference, t):
        torch.cuda.synchronize()
        for engine, r in rounds.items():
            expect[kernel_of[engine]] += r
            if engine != "megakernel":
                by_path[kernel_of[engine]][ingest_path(t)] += r
        configs[name] = {**result, "reference": reference,
                         "ms_per_round": ms, "rounds_per_engine": rounds,
                         "ingest_path": ingest_path(t),
                         "peak_mem_gib":
                             torch.cuda.max_memory_allocated() / 2**30}
        torch.cuda.reset_peak_memory_stats()

    # config 0: the reference example, 100 x 100
    torch.cuda.reset_peak_memory_stats()
    start, cfg = workload.config0_state(device=device)
    final, ms, rounds = run_engines(
        "config0", lambda s, c: av.run(s, c, max_rounds=2000, device=device),
        start, baseline_engines(cfg), av_rounds, assert_states_equal)
    fin = vr.has_finalized(final.records.confidence, cfg)
    result = {"rounds": av_rounds(final),
              "nodes_fully_finalized": int(fin.all(dim=1).sum()),
              **finality_stats(final.finalized_at)}
    check_result("config0", result, reference("config0", quick))
    record("config0", result, ms, rounds, reference("config0", quick),
           start.records.votes.shape[1])

    # config 1: single-decree Snowball, 1000 nodes
    start, cfg = workload.config1_state(quick, device=device)
    final, ms, rounds = run_engines(
        "config1",
        lambda s, c: snowball.run(s, c, max_rounds=1000, device=device),
        start, baseline_engines(cfg), av_rounds, assert_states_equal)
    fin = vr.has_finalized(final.records.confidence, cfg)
    pref = vr.is_accepted(final.records.confidence)
    result = {"rounds": av_rounds(final),
              "finalized_fraction": float(fin.float().mean()),
              "agreed_one_value": bool(fin.any()) and (
                  bool(pref[fin].all()) or not bool(pref[fin].any())),
              **finality_stats(final.finalized_at)}
    check_result("config1", result, reference("config1", quick))
    record("config1", result, ms, rounds, reference("config1", quick), 1)

    # config 3: the byzantine mix over the conflict DAG, FLIP at full
    # size, EQUIVOCATE at its quick shape
    for strategy in ("flip", "equivocate"):
        small = quick or strategy == "equivocate"
        start, cfg = workload.config3_states(small, device=device)[strategy]
        n, t, max_rounds = workload.config3_shape(small)
        name = f"config3_{strategy}"
        final, ms, rounds = run_engines(
            name, lambda s, c: dag.run(s, c, max_rounds=max_rounds,
                                       device=device),
            start, baseline_engines(cfg), dag_rounds,
            assert_dag_states_equal)
        conf = final.base.records.confidence
        fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
        honest = ~final.base.byzantine
        result = {"nodes": n, "txs": t, "rounds": dag_rounds(final),
                  "honest_sets_resolved": float(
                      (dag.winners_per_set(fin_acc[honest], 2) == 1)
                      .float().mean())}
        if strategy == "flip":
            result.update(finality_stats(final.base.finalized_at))
        check_result(name, result, reference(name, small))
        record(name, result, ms, rounds, reference(name, small), t)

    if not quick:
        start, cfg = workload.config3_states(device=device)["equivocate"]
        n, t, _ = workload.config3_shape()
        name = "config3_equivocate_full_shape"
        final, ms, rounds = run_engines(
            name, lambda s, c: dag.run(s, c,
                                       max_rounds=EQUIVOCATE_FULL_ROUNDS,
                                       device=device),
            start, baseline_engines(cfg), dag_rounds,
            assert_dag_states_equal)
        result = {"nodes": n, "txs": t, "rounds": dag_rounds(final)}
        check_result(name, result, {"rounds": EQUIVOCATE_FULL_ROUNDS})
        record(name, result, ms, rounds, None, t)

    # config 4: churn + latency-weighted sampling, also on the megakernel
    start, cfg = workload.config4_state(quick, device=device)
    final, ms, rounds = run_engines(
        "config4", lambda s, c: av.run(s, c, max_rounds=2000, device=device),
        start, baseline_engines(cfg, megakernel=True), av_rounds,
        assert_states_equal)
    fin = vr.has_finalized(final.records.confidence, cfg)
    result = {"rounds": av_rounds(final),
              "unfinalized_records": int((~fin).sum()),
              "finalized_fraction": float(fin.double().mean()),
              **finality_stats(final.finalized_at)}
    check_result("config4", result, reference("config4", quick))
    record("config4", result, ms, rounds, reference("config4", quick),
           start.records.votes.shape[1])

    launches = read_launches()
    if launches != expect:
        raise AssertionError(f"baseline launches {launches} != rounds per "
                             f"kernel {expect}")
    paths = read_path_launches()
    if paths != by_path:
        raise AssertionError(f"baseline launches by path {paths} != the "
                             f"rounds' shapes' {by_path}")
    return {"configs": configs, "launches": launches,
            "launches_by_ingest_path": paths}


def time_megakernel(n: int, t: int, device="cuda") -> dict:
    """Phase 6, megakernel: the kernel alone at the main path's shape,
    checked against and timed beside its plain version."""
    import torch

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.ops import megakernel

    cfg = workload.flagship_config(t, round_engine="megakernel")
    args = random_round_inputs(n, t, cfg, device, seed=1)
    got = megakernel.fused_round(*args, cfg)
    want = megakernel.fused_round_reference(*args, cfg)
    err = outputs_max_abs_err(got, want)
    if err:
        raise AssertionError(f"megakernel disagrees at {(n, t)}: {err}")
    del got, want
    for _ in range(3):
        megakernel.fused_round(*args, cfg)
    kernel_ms, compiles = guarded_time_ms(
        lambda: megakernel.fused_round(*args, cfg), 20,
        "phase 6's timed megakernel launches")
    plain_ms = time_ms(lambda: megakernel.fused_round_reference(*args, cfg),
                       3)
    bound_ms, bound_by = megakernel_bound(n, t, cfg.k)
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "timed_compiles": compiles}


def device_ms_by_symbol(fn, reps: int, part: str) -> dict:
    """Device ms per call of every kernel whose symbol holds `part`,
    from a `torch.profiler` trace of `reps` calls of `fn`: the time the
    card ran the kernel, without the host's cost of launching it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {r.key: r.self_device_time_total / 1e3 / reps
            for r in prof.key_averages()
            if part in r.key and r.self_device_time_total > 0}


def time_ingest(name: str, n: int, t: int, device="cuda") -> dict:
    """Phase 6, ingest kernels: kernel `name` alone at the main path's
    shape and inputs (the stride-0 consider pack, a polled mask),
    checked against and timed beside its plain version.  `ms` is CUDA
    events around back-to-back calls (the wrapper's host cost shows
    where the launch is short); `device_ms` is the profiler's device
    time of the kernel's symbol."""
    import torch

    from go_avalanche_tpu_torch import workload

    kernel, plain = ingest_kernels()[name]
    cfg = workload.flagship_config(t)
    args = random_ingest_inputs(n, t, cfg, device, seed=2)
    got = kernel(*args[:3], cfg.k, cfg, args[3])
    want = plain(*args[:3], cfg.k, cfg, args[3])
    err = outputs_max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name} disagrees at {(n, t)}: {err}")
    del got, want
    for _ in range(3):
        kernel(*args[:3], cfg.k, cfg, args[3])
    kernel_ms, compiles = guarded_time_ms(
        lambda: kernel(*args[:3], cfg.k, cfg, args[3]), 20,
        f"phase 6's timed {name} launches")
    symbols = device_ms_by_symbol(
        lambda: kernel(*args[:3], cfg.k, cfg, args[3]), 20, f"{name}_kernel")
    if len(symbols) != 1:
        raise AssertionError(f"{name} at {(n, t)}: expected one kernel "
                             f"symbol in the trace, got {symbols}")
    plain_ms = time_ms(lambda: plain(*args[:3], cfg.k, cfg, args[3]), 3)
    bound_ms, bound_by = ingest_bound(n, t, cfg.k)
    torch.cuda.empty_cache()
    (symbol, device_ms), = symbols.items()
    return {"max_abs_err": err, "ms": kernel_ms, "device_ms": device_ms,
            "symbol": symbol, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "timed_compiles": compiles}


def exchange_bound(kernel: str, n: int, t: int, k: int, oppose: bool):
    """(bound_ms, bound_by) of one exchange launch with sets of 2.
    `prefs_pack` reads the int16 confidence once and writes the packed
    plane (and under OPPOSE_MAJORITY adds into the int32 ``[T]``
    counts); `vote_packs` reads the peer, responded and lie draws and the
    packed plane once (its k gathers hit the L2, which holds the plane
    at these shapes), the bool ``[T]`` colours under OPPOSE_MAJORITY,
    and writes the uint8 yes pack and the consider byte."""
    t8 = -(-t // 8)
    if kernel == "prefs_pack":
        nbytes = n * t * 2 + n * t8 + (4 * t if oppose else 0)
    else:
        nbytes = n * t8 + n * k * (4 + 1 + 1) + n * t + n + (
            t if oppose else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def timed_kernel_row(name: str, where: str, kernel, plain, err: int) -> dict:
    """Phase 6's row of one kernel call that equals its plain version
    (`err`, the largest difference, must be 0): `ms` by CUDA events
    around 20 back-to-back wrapper calls, `device_ms` the profiler's
    device time of the kernel's one symbol, `plain_ms` the plain call's
    time."""
    if err:
        raise AssertionError(f"{name} disagrees at {where}: {err}")
    for _ in range(3):
        kernel()
    kernel_ms, compiles = guarded_time_ms(
        kernel, 20, f"phase 6's timed {name} launches")
    symbols = device_ms_by_symbol(kernel, 20, f"{name}_kernel")
    if len(symbols) != 1:
        raise AssertionError(f"{name} at {where}: expected one kernel "
                             f"symbol in the trace, got {symbols}")
    (symbol, device_ms), = symbols.items()
    return {"kernel": name, "max_abs_err": err, "ms": kernel_ms,
            "device_ms": device_ms, "symbol": symbol,
            "plain_ms": time_ms(plain, 3), "timed_compiles": compiles}


def time_exchange(n: int, t: int, device="cuda") -> list:
    """Phase 6, exchange kernels: each alone at ``n x t`` under each of
    `EXCHANGE_STRATEGIES`, checked against and timed beside its plain
    version, one row each.  `ms` is CUDA events around back-to-back
    wrapper calls (with `prefs_pack`'s all-False placeholder or its
    zeroed counts); `device_ms` the profiler's device time of the
    kernel's symbol."""
    import torch

    rows = []
    for strategy in EXCHANGE_STRATEGIES:
        calls = exchange_calls(n, t, strategy, device, seed=3)
        for name, (kernel, plain) in calls.items():
            bound_ms, bound_by = exchange_bound(
                name, n, t, 8, strategy == "oppose_majority")
            rows.append({**timed_kernel_row(
                name, f"{(n, t)} {strategy}", kernel, plain,
                planes_max_abs_err(kernel(), plain())),
                "case": strategy, "bound_ms": bound_ms,
                "bound_by": bound_by})
        del calls
        torch.cuda.empty_cache()
    return rows


def scheduler_bound(kernel: str, n: int, w: int, tracked: bool):
    """(bound_ms, bound_by) of one scheduler launch: `settle_scan` reads
    each record's 2 B confidence and 1 B `added` once and writes a byte
    a set and a word a column; `refill` reads and writes each record's
    votes, consider, confidence and `added` (5 B) and its 4 B stamp
    where finality is tracked, and reads three bool ``[W]`` masks."""
    if kernel == "settle_scan":
        nbytes = n * w * 3 + n + w + w // 2 + 4 * w
    else:
        nbytes = 2 * n * w * (9 if tracked else 5) + 3 * w
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def scheduler_calls(n: int, w: int, tracked: bool, device, seed: int):
    """kernel -> (kernel call, plain call) of the two scheduler kernels
    on one random window of 2-tx sets: counters drawn across the whole
    range and around the finalization score, both preferences, 90% of
    records added, every tenth node dead, a tenth of the columns
    invalid, a third of the slots taken and two thirds occupied after."""
    import torch

    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models import streaming_dag as sdg
    from go_avalanche_tpu_torch.ops import scheduler
    from go_avalanche_tpu_torch.ops import voterecord as vr

    g = torch.Generator(device=device).manual_seed(seed)
    cfg = AvalancheConfig()
    counter = torch.where(
        torch.rand((n, w), generator=g, device=device) < 0.5,
        random_ints(g, 0, 0x8000, (n, w)),
        random_ints(g, cfg.finalization_score - 4,
                    cfg.finalization_score + 4, (n, w)))
    conf = ((counter << 1) | random_ints(g, 0, 2, (n, w))).to(torch.int16)
    added = torch.rand((n, w), generator=g, device=device) < 0.9
    alive = torch.arange(n, device=device) % 10 != 0
    valid = torch.rand(w, generator=g, device=device) < 0.9
    records = vr.VoteRecordState(random_ints(g, 0, 256, (n, w), torch.uint8),
                                 random_ints(g, 0, 256, (n, w), torch.uint8),
                                 conf)
    fin_at = (random_ints(g, -1, 500, (n, w), torch.int32) if tracked
              else None)
    slots = torch.rand(w // 2, generator=g, device=device)
    take = (slots < 1 / 3).repeat_interleave(2)
    occupied = (slots < 2 / 3).repeat_interleave(2)
    pref = torch.rand(w, generator=g, device=device) < 0.5
    scan = (conf, added, alive, valid, 2, cfg)
    refill = (records, added, fin_at, take, occupied, pref)
    return {"settle_scan": (lambda: scheduler.settle_scan(*scan),
                            lambda: sdg.settle_scan_plain(*scan)),
            "refill": (lambda: scheduler.refill(*refill),
                       lambda: sdg.refill_plain(*refill))}


def flat_planes(out) -> tuple:
    """A kernel's outputs as a flat tuple of tensors, None as a zero."""
    import torch

    if out is None:
        return (torch.zeros(1),)
    if isinstance(out, tuple):
        return tuple(p for o in out for p in flat_planes(o))
    return (out,)


def time_scheduler(n: int, w: int, device="cuda") -> list:
    """Phase 6, scheduler kernels: each alone at ``n x w``, with finality
    tracking on and off, checked bit for bit against and timed beside
    its plain version, one `timed_kernel_row` each (`ms` includes the
    wrapper's zeroed or fresh outputs)."""
    import torch

    rows = []
    for tracked in (True, False):
        calls = scheduler_calls(n, w, tracked, device, seed=5)
        for name, (kernel, plain) in calls.items():
            if name == "settle_scan" and not tracked:
                continue        # the scan reads no stamp
            bound_ms, bound_by = scheduler_bound(name, n, w, tracked)
            rows.append({**timed_kernel_row(
                name, str((n, w)), kernel, plain,
                planes_max_abs_err(flat_planes(kernel()),
                                   flat_planes(plain()))),
                "tracked": tracked, "bound_ms": bound_ms,
                "bound_by": bound_by})
        del calls
        torch.cuda.empty_cache()
    return rows


# Phase 8's shapes.  Config 6 runs at full width (100000 nodes, a 1024-set
# window of 2-tx sets) with its backlog cut from 500,000 sets to 6,400
# (7 waves of the window, the last one a quarter full; the whole backlog
# would take ~8313 rounds, about ten minutes per engine; phases 9, 13 and
# 16 took the time the other waves had); every wave settles in
# ceil(134 / k) = 17 rounds, so the cut run's gate is 7 * 17 = 119 rounds.
# The retire-cap check runs 3 waves.
STREAM_SHAPES = {
    "full": dict(config6_sets=6_400, cap_sets=3072, traffic_txs=65_536,
                 traffic_rate=200.0, node_txs=4096, registry=1_000_000,
                 active=16_384, node_rounds=40),
    "quick": dict(config6_sets=320, cap_sets=96, traffic_txs=4096,
                  traffic_rate=12.5, node_txs=256, registry=4096,
                  active=64, node_rounds=12),
}
WAVE_ROUNDS = 17
STREAM_MAX_ROUNDS = 200_000


def assert_trees_equal(a, b, where: str) -> None:
    """Every tensor leaf of two (nested) NamedTuple states equal."""
    import torch

    if a is None or b is None or not isinstance(a, tuple):
        if isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                raise AssertionError(f"{where} differs")
        elif a != b:
            raise AssertionError(f"{where} differs: {a} != {b}")
        return
    for field, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
        assert_trees_equal(x, y, f"{where}.{field}")


def counting(fn):
    """`fn`, counting its calls in `.calls`; unlike a mock it keeps no
    arguments (here, whole states on the card)."""
    def counted(*args, **kwargs):
        counted.calls += 1
        return fn(*args, **kwargs)

    counted.calls = 0
    return counted


class StreamPart:
    """One part of phase 8: launch counts, host reads and peak memory
    from its start, and the rounds each engine ran."""

    def __init__(self, name: str, txs: int):
        import torch

        from go_avalanche_tpu_torch import sync

        self.name, self.txs = name, txs
        self.rounds = {}
        self.ms_per_round = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync.reads = 0

    def run(self, engine: str, fn, *args, **kwargs):
        """Run `fn` timed by CUDA events; `fn` returns (out, rounds)."""
        (out, rounds), ms = timed_run(fn, *args, **kwargs)
        self.rounds[engine] = rounds
        self.ms_per_round[engine] = ms / max(rounds, 1)
        return out

    def close(self, expect: dict, totals: dict,
              scheduler: dict = None) -> dict:
        """Check the launches against the rounds each kernel's engine
        ran (`expect`: kernel -> rounds) and the scheduler kernels'
        counts against `scheduler` (`scheduler_want`; none launched
        where it is None), and add them to `totals`."""
        import torch

        from go_avalanche_tpu_torch import sync

        torch.cuda.synchronize()
        launches, paths = read_launches(), read_path_launches()
        want = {"vote_u8": 0, "vote_swar": 0, "megakernel": 0, **expect}
        if launches != want:
            raise AssertionError(f"{self.name}: launches {launches} != "
                                 f"rounds per kernel {want}")
        sched = read_scheduler()
        if scheduler is None:
            scheduler = scheduler_want("cpu", 0, 0)
        if sched != scheduler:
            raise AssertionError(f"{self.name}: scheduler kernels {sched} "
                                 f"!= {scheduler}")
        path = ingest_path(self.txs)
        want_paths = {k: {"fast": 0, "any": 0, path: want[k]}
                      for k in ("vote_u8", "vote_swar")}
        if paths != want_paths:
            raise AssertionError(f"{self.name}: launches by path {paths} "
                                 f"!= {want_paths}")
        for kernel, n in launches.items():
            totals["launches"][kernel] += n
        for kernel, by in paths.items():
            for key, n in by.items():
                totals["by_path"][kernel][key] += n
        for kernel, n in sched["launches"].items():
            totals["scheduler"][kernel] += n
        return {"part": self.name, "rounds_per_engine": self.rounds,
                "ms_per_round": self.ms_per_round, "launches": launches,
                "launches_by_ingest_path": paths, "ingest_path": path,
                "scheduler": sched,
                "host_reads": sync.reads,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


STREAM_PARTS = ("config5", "config6", "traffic", "node_stream")


def run_streaming(quick: bool = False, device="cuda",
                  parts: tuple = STREAM_PARTS) -> dict:
    """Phase 8: the streaming schedulers, the traffic plane and the node
    registry through their entry points on the card (module docstring);
    each part raises on any gate it misses.  `parts` names the parts to
    run, of `STREAM_PARTS` (config 6 with its retire-cap check)."""
    import torch

    from go_avalanche_tpu_torch import prng, sync
    from go_avalanche_tpu_torch import traffic as tf
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import backlog, node_stream
    from go_avalanche_tpu_torch.models import streaming_dag as sdg

    shape = STREAM_SHAPES["quick" if quick else "full"]
    reference = workload.REFERENCE_QUICK if quick else workload.REFERENCE
    totals = {"launches": {"vote_u8": 0, "vote_swar": 0, "megakernel": 0},
              "by_path": {k: {"fast": 0, "any": 0}
                          for k in ("vote_u8", "vote_swar")},
              "scheduler": {"settle_scan": 0, "refill": 0}}
    engines = {"u8": "vote_u8", "swar32": "vote_swar"}
    todo, parts = parts, []
    n5, b5, w5 = workload.config5_shape(quick)

    def phased(cfg):
        return {engine: dataclasses.replace(cfg, ingest_engine=engine)
                for engine in engines}

    # 1. config 5, whole
    if "config5" in todo:
        start, cfg = workload.config5_state(quick, device=device)
        part = StreamPart("config5", w5)
        finals = {}
        for engine, ecfg in phased(cfg).items():
            finals[engine] = part.run(
                engine, lambda s, c: (lambda f: (f, sync.read(f.sim.round)))(
                    backlog.run(s, c, max_rounds=STREAM_MAX_ROUNDS,
                                device=device)), start, ecfg)
        assert_trees_equal(finals["u8"], finals["swar32"],
                           "config5 u8 vs swar32")
        final = finals["u8"]
        result = {"nodes": n5, "backlog_txs": b5, "window": w5,
                  "rounds": int(final.sim.round),
                  "txs_settled_fraction": float(
                      final.outputs.settled.double().mean())}
        check_result("config5", result, reference["config5"])
        parts.append({**result, "reference": reference["config5"],
                      **part.close({engines[e]: r
                                    for e, r in part.rounds.items()}, totals)})
        del start, finals, final
        torch.cuda.empty_cache()

    # 2. config 6 at full width, cut in depth, by run_chunked
    if "config6" in todo:
        sets = shape["config6_sets"]
        star = dict(workload.QUICK if quick else workload.NORTH_STAR)
        star["backlog_sets"] = sets
        start, cfg = workload.northstar_state(**star, device=device)
        w6 = star["window_sets"] * star["set_cap"]
        part = StreamPart("config6", w6)
        finals = {}
        with mock.patch.object(sdg, "drained",
                               counting(sdg.drained)) as drained:
            for engine, ecfg in phased(cfg).items():
                finals[engine] = part.run(
                    engine, lambda s, c: (lambda f: (f, sync.read(
                        f.dag.base.round)))(sdg.run_chunked(
                            s, c, max_rounds=STREAM_MAX_ROUNDS, chunk=256,
                            device=device)), start, ecfg)
        assert_trees_equal(finals["u8"], finals["swar32"],
                           "config6 u8 vs swar32")
        summary = sdg.resolution_summary(finals["u8"])
        waves = -(-sets // star["window_sets"])
        want = {**reference["config6"], "rounds": waves * WAVE_ROUNDS}
        full = workload.QUICK if quick else workload.NORTH_STAR
        result = {"nodes": star["nodes"], "window_sets": star["window_sets"],
                  "set_cap": star["set_cap"], "backlog_sets": sets,
                  "full_backlog_sets": full["backlog_sets"],
                  "depth_cut": f"backlog cut to {sets} sets ({waves} waves) "
                               f"to fit the script's time limit; width "
                               f"unchanged",
                  "rounds": int(finals["u8"].dag.base.round), **summary}
        check_result("config6", result, want)
        # One settle test and one refill a step, a settle test for each
        # read of `drained`, and a dense harvest a run.
        steps, n_runs = sum(part.rounds.values()), len(finals)
        sched = scheduler_want(device, steps + drained.calls + n_runs,
                               steps + n_runs)
        parts.append({**result, "reference": want,
                      "drained_calls": drained.calls,
                      **part.close({engines[e]: r
                                    for e, r in part.rounds.items()}, totals,
                                   sched)})
        del start, finals
        torch.cuda.empty_cache()

        # 2b. the sparse retire cap at the window size against the dense run
        star["backlog_sets"] = shape["cap_sets"]
        start, cfg = workload.northstar_state(**star, device=device)
        part = StreamPart("config6_retire_cap", w6)
        runs = {"dense": cfg,
                "retire_cap": dataclasses.replace(
                    cfg, stream_retire_cap=star["window_sets"])}
        finals = {}
        with mock.patch.object(sdg, "drained",
                               counting(sdg.drained)) as drained:
            for name, rcfg in runs.items():
                finals[name] = part.run(
                    name, lambda s, c: (lambda f: (f, sync.read(
                        f.dag.base.round)))(sdg.run(
                            s, c, max_rounds=STREAM_MAX_ROUNDS,
                            device=device)),
                    start, rcfg)
        assert_trees_equal(finals["dense"], finals["retire_cap"],
                           "retire cap vs dense")
        cap_rounds = -(-shape["cap_sets"] // star["window_sets"]) * WAVE_ROUNDS
        if part.rounds["dense"] != cap_rounds:
            raise AssertionError(f"retire-cap check: {part.rounds} rounds, "
                                 f"expected {cap_rounds}")
        # The capped steps rewrite their columns plainly; both runs end
        # in a dense harvest.
        steps = sum(part.rounds.values())
        parts.append({"backlog_sets": shape["cap_sets"],
                      "stream_retire_cap": star["window_sets"],
                      "drained_calls": drained.calls,
                      **part.close({"vote_u8": steps}, totals,
                                   scheduler_want(
                                       device, steps + drained.calls + 2,
                                       part.rounds["dense"] + 2,
                                       part.rounds["retire_cap"]))})
        del start, finals
        torch.cuda.empty_cache()

    # 3. live traffic at config 5's width
    if "traffic" in todo:
        tcfg = AvalancheConfig(gossip=False, max_element_poll=w5,
                               arrival_mode="poisson",
                               arrival_rate=shape["traffic_rate"],
                               arrival_backpressure=(0.7, 0.95))
        queue = backlog.make_backlog(prng.randint(
            prng.key(1, device), (shape["traffic_txs"],), 0, 1 << 20))
        start = backlog.init(prng.key(0, device), n5, w5, queue, tcfg,
                             device=device)
        part = StreamPart("traffic", w5)

        def traffic_run(state, cfg):
            rows = []
            rounds = sync.read(state.sim.round)
            while (rounds < STREAM_MAX_ROUNDS
                   and not sync.read(backlog.drained(state, cfg))):
                state, tel = backlog.step(state, cfg)
                rows.append(tel)
                rounds += 1
            final = backlog._retire_and_refill(state, cfg, refill=False)[0]
            return (final, backlog.stack_tree(rows)), rounds

        runs = {}
        for engine, ecfg in phased(tcfg).items():
            runs[engine] = part.run(engine, traffic_run, start, ecfg)
        assert_trees_equal(runs["u8"], runs["swar32"], "traffic u8 vs swar32")
        final, tel = runs["u8"]
        out = final.outputs
        if not bool(out.settled.all()):
            raise AssertionError("traffic: not every tx settled")
        ingraph = tf.latency_percentiles(final.traffic)
        host = tf.latency_percentiles_host(
            final.traffic.arrival_round.cpu().numpy(),
            out.settle_round.cpu().numpy(),
            out.settled.cpu().numpy().astype("int64"),
            tcfg.arrival_latency_buckets)
        if {k: ingraph[k] for k in host} != host:
            raise AssertionError(f"traffic: in-graph percentiles {ingraph} != "
                                 f"the host's {host}")
        # The arrivals again on the CPU, fed the card's occupancy series (a
        # step's arrival draw reads the occupancy the previous step left).
        arrivals = tel.traffic.arrivals.cpu().tolist()
        occupied = [0] + tel.occupied.cpu().tolist()[:-1]
        replay = tf.init_traffic(tcfg, prng.key(0, "cpu"),
                                 shape["traffic_txs"])
        for r, (want_n, occ) in enumerate(zip(arrivals, occupied)):
            replay, got_n = tf.arrive(
                replay, tcfg, torch.tensor(r, dtype=torch.int32),
                torch.tensor(occ, dtype=torch.int32), w5)
            if int(got_n) != want_n:
                raise AssertionError(f"traffic: round {r} drew {want_n} "
                                     f"arrivals on the card, {int(got_n)} in "
                                     f"the CPU replay")
        if not torch.equal(replay.arrival_round,
                           final.traffic.arrival_round.cpu()):
            raise AssertionError("traffic: arrival rounds differ from the "
                                 "CPU replay")
        parts.append({"nodes": n5, "window": w5,
                      "backlog_txs": shape["traffic_txs"],
                      "arrival_rate": shape["traffic_rate"],
                      "arrival_backpressure": [0.7, 0.95],
                      "rounds": part.rounds["u8"], **ingraph,
                      "arrivals_replayed_on_cpu": len(arrivals),
                      **part.close({engines[e]: r
                                    for e, r in part.rounds.items()}, totals)})
        del start, runs, final, tel
        torch.cuda.empty_cache()

    # 4. the node-stream registry on all three engines
    if "node_stream" in todo:
        ncfg = AvalancheConfig(stake_mode="zipf", stake_zipf_s=1.0,
                               registry_nodes=shape["registry"],
                               active_nodes=shape["active"],
                               node_churn_rate=1e-3,
                               max_element_poll=max(4096, shape["node_txs"]))
        start = node_stream.init(prng.key(0, device), shape["node_txs"], ncfg,
                                 device=device)
        part = StreamPart("node_stream", shape["node_txs"])
        n_rounds = shape["node_rounds"]
        runs = {}
        for engine, ecfg in {**phased(ncfg), "megakernel": dataclasses.replace(
                ncfg, round_engine="megakernel")}.items():
            runs[engine] = part.run(
                engine, lambda s, c: (node_stream.run_scan(
                    s, c, n_rounds=n_rounds, device=device), n_rounds),
                start, ecfg)
        for engine in ("swar32", "megakernel"):
            assert_trees_equal(runs["u8"], runs[engine], f"node stream u8 vs "
                                                         f"{engine}")
        final, tel = runs["u8"]
        departed = int(tel.departed.sum())
        slot = final.slot_node
        if (int(torch.unique(slot).numel()) != shape["active"]
                or int(final.resident.sum()) != shape["active"]
                or not bool(final.resident[slot.long()].all())):
            raise AssertionError("node stream: the window is not full")
        if not int(final.churned_in) == int(final.churned_out) == departed:
            raise AssertionError("node stream: churn counters disagree")
        # The churn draws again on the CPU from the card's initial registry
        # planes: they read no consensus state.
        replay = av.move_leaves(start._replace(sim=None),
                                torch.device("cpu"))
        for r in range(n_rounds):
            swap, new_slot, resident, n_swapped, key = (
                node_stream.churn_swaps(replay, ncfg))
            if int(n_swapped) != int(tel.departed[r]):
                raise AssertionError(f"node stream: round {r} swapped "
                                     f"{int(tel.departed[r])} rows on the "
                                     f"card, {int(n_swapped)} in the CPU "
                                     f"replay")
            replay = replay._replace(slot_node=new_slot, resident=resident,
                                     churn_key=key)
        for field in ("slot_node", "resident", "churn_key"):
            if not torch.equal(getattr(replay, field),
                               getattr(final, field).cpu()):
                raise AssertionError(f"node stream: {field} differs from the "
                                     f"CPU replay")
        parts.append({"registry_nodes": shape["registry"],
                      "active_nodes": shape["active"],
                      "txs": shape["node_txs"],
                      "rounds": n_rounds, "departed": departed,
                      **node_stream.window_summary(final, ncfg),
                      **part.close({"vote_u8": n_rounds, "vote_swar": n_rounds,
                                    "megakernel": n_rounds}, totals)})
    return {"parts": parts, "launches": totals["launches"],
            "launches_by_ingest_path": totals["by_path"],
            "scheduler_launches": totals["scheduler"]}


def run_config6_full_depth(device="cuda") -> dict:
    """BASELINE config 6 whole: 100000 nodes x 500,000 2-tx sets through
    a 1024-set window by `run_chunked` on phased-u8, gated on the
    reference's recorded result; launches and host reads counted."""
    import torch

    from go_avalanche_tpu_torch import sync, workload
    from go_avalanche_tpu_torch.models import streaming_dag as sdg

    start, cfg = workload.northstar_state(**workload.NORTH_STAR,
                                          device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync.reads = 0
    t0 = time.perf_counter()

    def progress(rounds, state):
        print(f"config6: round {rounds}, {int(state.next_idx)} sets "
              f"admitted, {time.perf_counter() - t0:.0f} s", file=sys.stderr,
              flush=True)

    final, ms = timed_run(sdg.run_chunked, start, cfg,
                          max_rounds=STREAM_MAX_ROUNDS, chunk=256,
                          progress=progress, device=device)
    rounds = int(final.dag.base.round)
    result = {"rounds": rounds, **sdg.resolution_summary(final)}
    check_result("config6_full_depth", result, workload.REFERENCE["config6"])
    launches = read_launches()
    if launches != {"megakernel": 0, "vote_u8": rounds, "vote_swar": 0}:
        raise AssertionError(f"config6 launches {launches} != {rounds} "
                             f"rounds on vote_u8")
    return {**result, "reference": workload.REFERENCE["config6"],
            **workload.NORTH_STAR, "engine": "u8", "ms_per_round": ms / rounds,
            "wall_s": ms / 1e3, "launches": launches,
            "launches_by_ingest_path": read_path_launches(),
            "host_reads": sync.reads,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


# ----------------------------------------------------------------- phase 9

ASYNC_SHAPES = {
    "full": dict(flagship=(16_384, 16_384), dag=(10_000, 10_000),
                 snowball_quick=False, backlog_txs=8192, node_txs=4096,
                 registry=1_000_000, active=16_384, node_rounds=3,
                 node_churn=1e-3, dag_replay_rounds=2),
    "quick": dict(flagship=(256, 512), dag=(64, 64), snowball_quick=True,
                  backlog_txs=512, node_txs=256, registry=4096, active=64,
                  node_rounds=3, node_churn=0.05, dag_replay_rounds=2),
}
ASYNC_ENGINES = ("walk", "walk_earlyout", "coalesced")
ASYNC_ROUNDS = 10            # flagship_async
FAULT_ROUNDS = 18            # flagship_faults
LATENCY0_ROUNDS = 3
RING_COUNTERS = ("deliveries", "expiries", "ring_occupancy",
                 "partition_blocked")
ASYNC_REPLAY_TIMEOUT = 600   # seconds phase 9 waits for a CPU replay
# Latency 1 with the bench lane's timeout (2 * 1 + 2 = 4 rounds).
LATENCY1 = dict(latency_mode="fixed", latency_rounds=1, time_step_s=1.0,
                request_timeout_s=3.0)


def assert_async_trees_equal(a, b, where: str) -> None:
    """`assert_trees_equal` across ring layouts: a bool poll-mask plane
    (walk engines) is packed before it is held against a bit-packed one
    (coalesced)."""
    import torch

    from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

    if isinstance(a, tuple) and type(a).__name__ == "InflightState":
        pa, pb = a.polled, b.polled
        if pa.dtype != pb.dtype:
            pa, pb = [pack_bool_plane(p) if p.dtype == torch.bool else p
                      for p in (pa, pb)]
        a, b = a._replace(polled=pa), b._replace(polled=pb)
    if isinstance(a, tuple) and a is not None:
        for field, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            assert_async_trees_equal(x, y, f"{where}.{field}")
        return
    assert_trees_equal(a, b, where)


class AsyncRun:
    """One engine's run of phase 9: per-round CUDA-event times, peak
    memory above what was held before it, and the host reads its
    activity tests made."""

    def __init__(self):
        import torch

        from go_avalanche_tpu_torch import sync

        torch.cuda.synchronize()
        self.held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sync.reads = 0
        self.events = []

    def step(self, fn, *args):
        import torch

        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        out = fn(*args)
        end.record()
        self.events.append((begin, end))
        return out

    def close(self, steady_from: int = 0) -> dict:
        import torch

        from go_avalanche_tpu_torch import sync

        torch.cuda.synchronize()
        ms = [b.elapsed_time(e) for b, e in self.events]
        steady = ms[steady_from:] or ms
        return {"ms_per_round": sum(steady) / len(steady),
                "ms_per_round_all": sum(ms) / len(ms), "rounds": len(ms),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "peak_over_held_gib": (torch.cuda.max_memory_allocated()
                                       - self.held) / 2**30,
                "host_reads": sync.reads}


def run_rounds(start, cfg, n_rounds: int, steady_from: int = 0):
    """`n_rounds` of `avalanche.round_step`, each timed; returns
    ``(final state, stacked telemetry, timing row)``."""
    import torch

    from go_avalanche_tpu_torch.models import avalanche as av

    run = AsyncRun()
    state, rows = start, []
    for _ in range(n_rounds):
        state, tel = run.step(av.round_step, state, cfg)
        rows.append(tel)
    tel = av.SimTelemetry(*(torch.stack(col) for col in zip(*rows)))
    return state, tel, run.close(steady_from)


def check_no_launches(where: str) -> dict:
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"{where}: the async path launched round "
                             f"kernels {launches}; it has none by design")
    return launches


def run_async_latency0(n: int, t: int, device="cuda") -> dict:
    """Latency 0 on each delivery engine, leaf-equal to the synchronous
    round on phased-u8 and phased-swar32 (which launch the ingest
    kernels): records, finality stamps, alive, added, key and the
    telemetry apart from the ring counters."""
    import torch

    from go_avalanche_tpu_torch import prng, workload
    from go_avalanche_tpu_torch.models import avalanche as av

    sync_start, u8_cfg = workload.flagship_state(n, t, device=device)
    reset_launches()
    refs = {}
    for name, cfg in (("vote_u8", u8_cfg),
                      ("vote_swar", dataclasses.replace(
                          u8_cfg, ingest_engine="swar32"))):
        refs[name] = run_rounds(sync_start, cfg, LATENCY0_ROUNDS)
    launches = read_launches()
    if launches != {"megakernel": 0, "vote_u8": LATENCY0_ROUNDS,
                    "vote_swar": LATENCY0_ROUNDS}:
        raise AssertionError(f"latency-0 reference launches {launches}")
    del sync_start
    rows = {}
    for engine in ASYNC_ENGINES:
        cfg = dataclasses.replace(u8_cfg, latency_mode="fixed",
                                  latency_rounds=0, time_step_s=1.0,
                                  request_timeout_s=1.0,
                                  inflight_engine=engine)
        start = av.init(prng.key(0, device), n, t, cfg, device=device)
        reset_launches()
        final, tel, row = run_rounds(start, cfg, LATENCY0_ROUNDS)
        check_no_launches(f"latency 0 {engine}")
        for name, (want, wtel, _) in refs.items():
            where = f"latency 0 {engine} vs phased {name}"
            assert_trees_equal(want._replace(inflight=None),
                               final._replace(inflight=None), where)
            for field in wtel._fields:
                if field not in RING_COUNTERS and not torch.equal(
                        getattr(wtel, field), getattr(tel, field)):
                    raise AssertionError(f"{where}: telemetry.{field}")
        rows[engine] = {**row, "deliveries": tel.deliveries.tolist()}
        del start, final
    out = {"rounds": LATENCY0_ROUNDS, "reference_launches": launches,
           "engines": rows,
           "phased_ms_per_round": {name: r[2]["ms_per_round"]
                                   for name, r in refs.items()}}
    del refs
    torch.cuda.empty_cache()
    return out


def run_async_flagship(n: int, t: int, faults: bool, device="cuda") -> dict:
    """`flagship_async` (latency 2, depth 7, 10 rounds) or
    `flagship_faults` (its script, 18 rounds) on the three engines:
    leaf-equal, ring counters gated, timed per round."""
    import torch

    from go_avalanche_tpu_torch import workload

    script = workload.FLAGSHIP_FAULTS if faults else None
    n_rounds = FAULT_ROUNDS if faults else ASYNC_ROUNDS
    finals, rows = {}, {}
    reset_launches()
    for engine in ASYNC_ENGINES:
        start, cfg = workload.flagship_state(n, t, latency=2,
                                             inflight_engine=engine,
                                             faults=script, device=device)
        if cfg.timeout_rounds() != 6:
            raise AssertionError("flagship async: timeout is not 6 rounds")
        final, tel, row = run_rounds(start, cfg, n_rounds, steady_from=2)
        del start
        rows[engine] = row
        finals[engine] = (final, tel)
        if engine != ASYNC_ENGINES[0]:
            assert_async_trees_equal(finals[ASYNC_ENGINES[0]], (final, tel),
                                     f"{engine} vs {ASYNC_ENGINES[0]}")
            del finals[engine]
    launches = check_no_launches("flagship async")
    final, tel = finals[ASYNC_ENGINES[0]]
    deliveries = tel.deliveries.tolist()
    expiries = tel.expiries.tolist()
    blocked = tel.partition_blocked.tolist()
    k = cfg.k
    if not faults:
        if (deliveries[:2] != [0, 0]
                or deliveries[2:] != [n * k] * (n_rounds - 2)
                or any(expiries)):
            raise AssertionError(f"flagship async ring counters: "
                                 f"deliveries {deliveries}, expiries "
                                 f"{expiries}")
    else:
        if [r for r, b in enumerate(blocked) if b] != [5, 6, 7, 8, 9]:
            raise AssertionError(f"flagship faults: blocked {blocked}")
        if (any(expiries[r + 6] != blocked[r] for r in range(n_rounds - 6))
                or sum(expiries) != sum(blocked)):
            raise AssertionError(f"flagship faults: expiries {expiries} "
                                 f"!= blocked {blocked} six rounds later")
    if int(final.records.votes.sum()) == 0:
        raise AssertionError("flagship async: no vote reached the windows")
    out = {"nodes": n, "txs": t, "k": k, "latency": 2, "ring_depth": 7,
           "rounds": n_rounds, "faults": script, "engines": rows,
           "deliveries": deliveries, "expiries": expiries,
           "partition_blocked": blocked,
           "ring_occupancy": tel.ring_occupancy.tolist(),
           "launches": launches}
    del finals, final, tel
    torch.cuda.empty_cache()
    return out


def run_fault_studies(device="cuda") -> list:
    """`measure()` and the three scenarios of the fault-study example at
    512 x 64 on every engine, each against the JAX package's record."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.ops import voterecord as vr

    rows = []
    reset_launches()
    for name, want in workload.FAULT_STUDY_RECORDS.items():
        times = {}
        for engine in ASYNC_ENGINES:
            start, cfg, n_rounds = workload.fault_study_state(
                name, engine, device=device)
            (final, tel), ms = timed_run(av.run_scan, start, cfg, n_rounds,
                                         device=device)
            got = {f: getattr(tel, f).tolist() for f in
                   ("finalizations", "deliveries", "expiries",
                    "partition_blocked", "ring_occupancy")}
            got["finalized_fraction"] = float(vr.has_finalized(
                final.records.confidence, cfg).double().mean())
            if got != want:
                bad = [f for f in want if got[f] != want[f]]
                raise AssertionError(f"fault study {name} on {engine}: "
                                     f"{bad} differ from the record")
            times[engine] = ms / n_rounds
        rows.append({"study": name, "nodes": workload.FAULT_STUDY_SHAPE[0],
                     "txs": workload.FAULT_STUDY_SHAPE[1],
                     "rounds": len(want["finalizations"]),
                     "finalized_fraction": want["finalized_fraction"],
                     "expiries_total": sum(want["expiries"]),
                     "blocked_total": sum(want["partition_blocked"]),
                     "ms_per_round": times})
    check_no_launches("fault studies")
    return rows


def tree_digests(tree, where: str = "") -> dict:
    """Every leaf of a (nested) tuple or NamedTuple by path: a tensor's
    dtype, shape and the sha256 of its bytes, any other leaf's repr."""
    import hashlib

    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous().reshape(-1)
        return {where: (str(t.dtype), tuple(tree.shape), hashlib.sha256(
            t.view(torch.uint8).numpy().tobytes()).hexdigest())}
    if isinstance(tree, tuple):
        out = {}
        for field, x in zip(getattr(tree, "_fields", range(len(tree))), tree):
            out.update(tree_digests(x, f"{where}.{field}"))
        return out
    return {where: repr(tree)}


def assert_digests_equal(got: dict, want: dict, where: str) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{where}: the leaves differ: {list(got)} != "
                             f"{list(want)}")
    bad = [p for p in got if got[p] != want[p]]
    if bad:
        raise AssertionError(f"{where} differs at {bad}")


def node_stream_async_config(shape: dict):
    """The node stream's config in phase 9: zipf stake, latency 1, rows
    cleared from the ring."""
    from go_avalanche_tpu_torch.config import AvalancheConfig

    return AvalancheConfig(stake_mode="zipf", registry_nodes=shape["registry"],
                           active_nodes=shape["active"],
                           node_churn_rate=shape["node_churn"],
                           inflight_engine="coalesced",
                           max_element_poll=max(4096, shape["node_txs"]),
                           **LATENCY1)


def async_model_starts(shape: dict, device) -> dict:
    """Phase 9's part `models`: the start and config of each model's
    coalesced run, built on `device` and moved to the CPU, where its
    replay runs; the card's coalesced runs start from the same bytes."""
    import torch

    from go_avalanche_tpu_torch import prng, workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import node_stream

    cpu = torch.device("cpu")
    quick = shape["snowball_quick"]
    n, t = shape["dag"]
    ncfg = node_stream_async_config(shape)
    builds = {
        "dag": lambda: workload.dag_baseline_state(
            n, t, device=device, inflight_engine="coalesced", **LATENCY1),
        "snowball": lambda: workload.config1_state(
            quick, device=device, inflight_engine="coalesced",
            **dict(LATENCY1, latency_mode="geometric")),
        "backlog": lambda: workload.config5_state(
            quick, device=device, n_txs=shape["backlog_txs"],
            inflight_engine="coalesced", **LATENCY1),
        "node_stream": lambda: (node_stream.init(
            prng.key(0, device), shape["node_txs"], ncfg, device=device),
            ncfg),
    }
    starts = {}
    for model, build in builds.items():
        start, cfg = build()
        starts[model] = (av.move_leaves(start, cpu), cfg)
        del start
    _empty_cache(device)
    return starts


def replay_async_model(model: str, path: str, n_rounds: int) -> dict:
    """Phase 9, in a spawned process: one model's CPU replay from the
    start saved at `path`; the digests of what it ends with, the rounds
    it ran and its seconds."""
    import os

    import torch

    from go_avalanche_tpu_torch.models import backlog, dag, node_stream
    from go_avalanche_tpu_torch.models import snowball

    # Leave half the host's cores to the process that drives the card.
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    start, cfg = torch.load(path, weights_only=False)
    t0 = time.perf_counter()
    if model == "dag":
        replay = start
        for _ in range(n_rounds):
            replay = dag.round_step(replay, cfg)[0]
        rounds = n_rounds
    elif model == "snowball":
        replay = snowball.run(start, cfg, device="cpu")
        rounds = int(replay.round)
    elif model == "backlog":
        replay = backlog.run(start, cfg, device="cpu")
        rounds = int(replay.sim.round)
    else:
        replay = node_stream.run_scan(start, cfg, n_rounds=n_rounds,
                                      device="cpu")
        rounds = n_rounds
    return {"model": model, "digests": tree_digests(replay),
            "rounds": rounds, "seconds": time.perf_counter() - t0}


class AsyncReplays:
    """Phase 9's CPU replays in one spawned process, started before the
    card's parts: `start` saves each model's start and submits its
    replay; `take(model)` waits for it (the wait is reported)."""

    def __init__(self, shape: dict, device):
        import concurrent.futures
        import multiprocessing
        import os
        import tempfile

        import torch

        self.starts = async_model_starts(shape, device)
        self.work = tempfile.mkdtemp(prefix="chip_smoke_async_")
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        rounds = {"dag": shape["dag_replay_rounds"],
                  "node_stream": shape["node_rounds"]}
        self.futures = {}
        for model, (start, cfg) in self.starts.items():
            path = os.path.join(self.work, f"{model}.pt")
            torch.save((start, cfg), path)
            self.futures[model] = self.pool.submit(
                replay_async_model, model, path, rounds.get(model, 0))

    def take(self, model: str) -> dict:
        t0 = time.perf_counter()
        row = self.futures[model].result(timeout=ASYNC_REPLAY_TIMEOUT)
        return {**row, "waited_s": time.perf_counter() - t0}

    def close(self) -> None:
        import shutil

        self.pool.shutdown(cancel_futures=True)
        shutil.rmtree(self.work, ignore_errors=True)


def run_async_models(shape: dict, replays: AsyncReplays,
                     device="cuda") -> list:
    """The DAG, Snowball, backlog and node-stream models under latency,
    each held against the CPU replay of the port from the same start."""
    from go_avalanche_tpu_torch import sync, workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import backlog, dag, node_stream
    from go_avalanche_tpu_torch.models import snowball
    from go_avalanche_tpu_torch.ops import voterecord as vr

    rows = []

    # 1. the DAG baseline under fixed latency 1, to settlement
    t0 = time.perf_counter()
    n, t = shape["dag"]
    finals, times = {}, {}
    reset_launches()
    cpu_start, dag_cfg = replays.starts["dag"]
    for engine in ASYNC_ENGINES:
        if engine == "coalesced":
            start, cfg = dag.to_device(cpu_start, device), dag_cfg
        else:
            start, cfg = workload.dag_baseline_state(
                n, t, device=device, inflight_engine=engine, **LATENCY1)
        run = AsyncRun()
        state = start
        while (int(state.base.round) < DAG_MAX_ROUNDS
               and not bool(dag.settled(state, cfg))):
            state = run.step(lambda s: dag.round_step(s, cfg)[0], state)
        times[engine] = run.close()
        finals[engine] = state
        del start
    for engine in ASYNC_ENGINES[1:]:
        assert_async_trees_equal(finals["walk"], finals[engine],
                                 f"dag async {engine} vs walk")
    final = finals["coalesced"]
    if not bool(dag.settled(final, cfg)):
        raise AssertionError("dag async did not settle")
    conf = final.base.records.confidence
    fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
    resolved = float((dag.winners_per_set(fin_acc, 2) == 1).float().mean())
    if resolved != 1.0:
        raise AssertionError(f"dag async: {resolved} of sets resolved")
    # The CPU replay is cut to the first rounds: a 10000² round takes
    # seconds on the CPU.
    k_replay = shape["dag_replay_rounds"]
    again = dag.to_device(cpu_start, device)
    for _ in range(k_replay):
        again = dag.round_step(again, cfg)[0]
    replay = replays.take("dag")
    assert_digests_equal(tree_digests(again), replay["digests"],
                         f"dag async vs its CPU replay at round {k_replay}")
    rows.append({"model": "dag", "nodes": n, "txs": t, "latency": 1,
                 "timeout_rounds": cfg.timeout_rounds(),
                 "rounds": int(final.base.round),
                 "sets_resolved_fraction": resolved,
                 "finality_median": finality_median(final.base.finalized_at),
                 "cpu_replay_rounds": replay["rounds"],
                 "cpu_replay_s": replay["seconds"],
                 "cpu_replay_waited_s": replay["waited_s"], "engines": times,
                 "launches": check_no_launches("dag async"),
                 "wall_s": time.perf_counter() - t0})
    del finals, final, again, cpu_start
    _empty_cache(device)

    # 2. Snowball at config 1's width under geometric latency
    t0 = time.perf_counter()
    knobs = dict(LATENCY1, latency_mode="geometric")
    finals, times = {}, {}
    for engine in ASYNC_ENGINES:
        if engine == "coalesced":
            cpu_start, cfg = replays.starts["snowball"]
            start = snowball.to_device(cpu_start, device)
        else:
            start, cfg = workload.config1_state(
                shape["snowball_quick"], device=device,
                inflight_engine=engine, **knobs)
        (final, ms) = timed_run(snowball.run, start, cfg, device=device)
        finals[engine] = final
        times[engine] = ms / max(int(final.round), 1)
    for engine in ASYNC_ENGINES[1:]:
        assert_trees_equal(finals["walk"], finals[engine],
                           f"snowball async {engine} vs walk")
    replay = replays.take("snowball")
    assert_digests_equal(tree_digests(finals["coalesced"]),
                         replay["digests"],
                         "snowball async vs its CPU replay")
    final = finals["coalesced"]
    fin = vr.has_finalized(final.records.confidence, cfg)
    pref = vr.is_accepted(final.records.confidence)
    rows.append({"model": "snowball", "nodes": int(fin.numel()),
                 "latency_mode": "geometric", "latency_rounds": 1,
                 "rounds": int(final.round),
                 "finalized_fraction": float(fin.float().mean()),
                 "agreed_one_value": bool((pref == pref[0]).all()),
                 "cpu_replay_rounds": replay["rounds"],
                 "cpu_replay_s": replay["seconds"],
                 "cpu_replay_waited_s": replay["waited_s"],
                 "ms_per_round": times,
                 "launches": check_no_launches("snowball async"),
                 "wall_s": time.perf_counter() - t0})

    # 3. backlog.run at config 5's width, coalesced, backlog cut
    t0 = time.perf_counter()
    n5, _, w5 = workload.config5_shape(shape["snowball_quick"])
    cpu_start, cfg = replays.starts["backlog"]
    start = av.move_leaves(cpu_start, device)
    sync.reads = 0
    final, ms = timed_run(backlog.run, start, cfg, max_rounds=STREAM_MAX_ROUNDS,
                          device=device)
    reads = sync.reads
    replay = replays.take("backlog")
    assert_digests_equal(tree_digests(final), replay["digests"],
                         "backlog async vs its CPU replay")
    if not bool(final.outputs.settled.all()):
        raise AssertionError("backlog async: not every tx settled")
    rounds = int(final.sim.round)
    rows.append({"model": "backlog", "nodes": n5, "window": w5,
                 "backlog_txs": shape["backlog_txs"], "latency": 1,
                 "engine": "coalesced", "rounds": rounds,
                 "ms_per_round": ms / rounds, "host_reads": reads,
                 "cpu_replay_rounds": replay["rounds"],
                 "cpu_replay_s": replay["seconds"],
                 "cpu_replay_waited_s": replay["waited_s"],
                 "launches": check_no_launches("backlog async"),
                 "wall_s": time.perf_counter() - t0})
    del start, final
    _empty_cache(device)

    # 4. the node stream under latency 1 (rows cleared from the ring)
    t0 = time.perf_counter()
    cpu_start, ncfg = replays.starts["node_stream"]
    start = av.move_leaves(cpu_start, device)
    n_rounds = shape["node_rounds"]
    (final, tel), ms = timed_run(node_stream.run_scan, start, ncfg,
                                 n_rounds=n_rounds, device=device)
    replay = replays.take("node_stream")
    assert_digests_equal(tree_digests((final, tel)), replay["digests"],
                         "node stream async vs its CPU replay")
    if int(tel.departed.sum()) == 0 or int(tel.round.deliveries.sum()) == 0:
        raise AssertionError("node stream async: no churn or no delivery")
    rows.append({"model": "node_stream", "registry_nodes": shape["registry"],
                 "active_nodes": shape["active"], "txs": shape["node_txs"],
                 "latency": 1, "engine": "coalesced", "rounds": n_rounds,
                 "departed": int(tel.departed.sum()),
                 "ms_per_round": ms / n_rounds,
                 "cpu_replay_rounds": replay["rounds"],
                 "cpu_replay_s": replay["seconds"],
                 "cpu_replay_waited_s": replay["waited_s"],
                 "launches": check_no_launches("node stream async"),
                 "wall_s": time.perf_counter() - t0})
    del start, final
    _empty_cache(device)
    return rows


def run_async(quick: bool = False, device="cuda") -> dict:
    """Phase 9: the async query ring (module docstring); each part's
    rows carry its wall seconds (host clock, the wait for a CPU replay
    included).  The part `models`' CPU replays start first, in a spawned
    process, and run beside the card's parts."""
    shape = ASYNC_SHAPES["quick" if quick else "full"]
    n, t = shape["flagship"]
    t0 = time.perf_counter()
    replays = AsyncReplays(shape, device)
    out = {"replay_starts": {"wall_s": time.perf_counter() - t0}}
    parts = {"latency0": lambda: run_async_latency0(n, t, device),
             "flagship_async": lambda: run_async_flagship(n, t, False,
                                                          device),
             "flagship_faults": lambda: run_async_flagship(n, t, True,
                                                           device),
             "fault_studies": lambda: run_fault_studies(device),
             "models": lambda: run_async_models(shape, replays, device)}
    try:
        for name, part in parts.items():
            t0 = time.perf_counter()
            rows = part()
            wall = time.perf_counter() - t0
            out[name] = ([{**r, "part_wall_s": wall} for r in rows]
                         if isinstance(rows, list)
                         else {**rows, "wall_s": wall})
    finally:
        replays.close()
    return out


# ---------------------------------------------------------------- phase 10

ADVERSARY_SHAPES = {"full": (16_384, 16_384), "quick": (256, 512)}
SYNC_POLICIES = ("split_vote", "withhold_near_quorum", "stake_eclipse")
ASYNC_POLICIES = ("timing", "withhold_near_quorum")
POLICY_SYNC_ROUNDS = 3
# flagship_async under a policy: the walk 3 rounds, the other two 10.
POLICY_ASYNC_ROUNDS = {"walk": 3, "walk_earlyout": 10, "coalesced": 10}
POLICY_BYZANTINE = 0.2
POLICY_TIMEOUT = 6           # the bench lane's 2 * latency 2 + 2


def policy_flagship_config(t: int, policy: str, ingest_engine: str = "u8",
                           **kwargs):
    """The flagship's config (`workload.flagship_config`; `kwargs` pass
    to it) on `ingest_engine` at byzantine fraction 0.2 under `policy`
    ("off" for the control), stake_eclipse over zipf stake."""
    from go_avalanche_tpu_torch import workload

    knobs = dict(byzantine_fraction=POLICY_BYZANTINE, adversary_policy=policy,
                 ingest_engine=ingest_engine)
    if policy == "stake_eclipse":
        knobs["stake_mode"] = "zipf"
    return dataclasses.replace(workload.flagship_config(t, **kwargs), **knobs)


class Launches:
    """The kernels' launches, and the ingest kernels' by path, since it
    was made (counts are never reset inside phase 10)."""

    def __init__(self):
        self.before, self.paths = read_launches(), read_path_launches()

    def delta(self) -> tuple:
        now, paths = read_launches(), read_path_launches()
        return ({k: now[k] - self.before[k] for k in now},
                {k: {p: n - self.paths[k][p] for p, n in by.items()}
                 for k, by in paths.items()})


def run_policy_sync(n: int, t: int, device="cuda") -> dict:
    """Part (a): the flagship at byzantine 0.2 under each sync policy
    and the policy-off control, 3 rounds on phased-u8 and phased-swar32,
    each timed (ms per round over rounds 1-2, and over all three):
    leaf-equal states and telemetry, each ingest kernel
    launched once a round on its fast path; the megakernel refuses every
    policy with the reference's message."""
    import torch

    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.models import avalanche as av

    rows = {}
    for policy in ("off",) + SYNC_POLICIES:
        cfgs = {"vote_u8": policy_flagship_config(t, policy),
                "vote_swar": policy_flagship_config(t, policy,
                                                    ingest_engine="swar32")}
        if policy != "off":
            try:
                dataclasses.replace(cfgs["vote_u8"],
                                    round_engine="megakernel")
            except ValueError as err:
                if "run policy studies on round_engine 'phased'" not in str(
                        err):
                    raise
            else:
                raise AssertionError(f"the megakernel accepted {policy}")
        start = av.init(prng.key(0, device), n, t, cfgs["vote_u8"],
                        device=device)
        counts = Launches()
        runs = {name: run_rounds(start, cfg, POLICY_SYNC_ROUNDS,
                                 steady_from=1)
                for name, cfg in cfgs.items()}
        del start
        launches, paths = counts.delta()
        (u8, u8_tel, u8_row), (swar, swar_tel, swar_row) = (
            runs["vote_u8"], runs["vote_swar"])
        assert_trees_equal(u8, swar, f"{policy}: phased-u8 vs phased-swar32")
        assert_trees_equal(u8_tel, swar_tel, f"{policy}: telemetry")
        fast = {"fast": POLICY_SYNC_ROUNDS, "any": 0}
        if (launches != {"megakernel": 0, "vote_u8": POLICY_SYNC_ROUNDS,
                         "vote_swar": POLICY_SYNC_ROUNDS}
                or paths != {"vote_u8": fast, "vote_swar": fast}):
            raise AssertionError(f"{policy}: launches {launches} by path "
                                 f"{paths}")
        if int(u8.records.votes.sum()) == 0:
            raise AssertionError(f"{policy}: no vote reached the windows")
        rows[policy] = {
            "ms_per_round": {"phased_u8": u8_row["ms_per_round"],
                             "phased_swar32": swar_row["ms_per_round"]},
            "ms_per_round_all": {"phased_u8": u8_row["ms_per_round_all"],
                                 "phased_swar32":
                                     swar_row["ms_per_round_all"]},
            "peak_gib": max(u8_row["peak_gib"], swar_row["peak_gib"]),
            "votes_applied": u8_tel.votes_applied.tolist(),
            "flips": u8_tel.flips.tolist(),
            "launches": launches, "launches_by_ingest_path": paths}
        del runs, u8, swar, u8_tel, swar_tel
        torch.cuda.empty_cache()
    return {"nodes": n, "txs": t, "byzantine_fraction": POLICY_BYZANTINE,
            "rounds": POLICY_SYNC_ROUNDS, "policies": rows}


def run_policy_async(n: int, t: int, device="cuda") -> dict:
    """Part (b): `flagship_async` (latency 2, timeout 6) at byzantine 0.2
    under timing and under withhold_near_quorum on the three delivery
    engines: leaf-equal after 3 rounds, walk_earlyout and coalesced also
    after 10; ring counters gated (timing: no expiry under fixed latency;
    withholding: only the withheld draws expire, at the timeout six
    rounds after they were sent, so none before round 6 and some by round
    9: a querier is near its quorum once a delivery filled its window).
    No kernel launches."""
    import torch

    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.models import avalanche as av

    counts = Launches()
    rows = {}
    for policy in ASYNC_POLICIES:
        times, at3, at10 = {}, {}, {}
        for engine in ASYNC_ENGINES:
            cfg = policy_flagship_config(t, policy, latency=2,
                                         inflight_engine=engine)
            if cfg.timeout_rounds() != POLICY_TIMEOUT:
                raise AssertionError("policy async: timeout is not 6 rounds")
            state = av.init(prng.key(0, device), n, t, cfg, device=device)
            run, tels = AsyncRun(), []
            for r in range(POLICY_ASYNC_ROUNDS[engine]):
                state, tel = run.step(av.round_step, state, cfg)
                tels.append(tel)
                if r == 2:
                    at3[engine] = (state, av.SimTelemetry(
                        *(torch.stack(col) for col in zip(*tels))))
            times[engine] = run.close(steady_from=2)
            if len(tels) > 3:
                at10[engine] = (state, av.SimTelemetry(
                    *(torch.stack(col) for col in zip(*tels))))
            del state, tels
            if engine != "walk":
                assert_async_trees_equal(at3["walk"], at3.pop(engine),
                                         f"{policy}: {engine} vs walk "
                                         f"after 3 rounds")
        assert_async_trees_equal(at10["walk_earlyout"], at10["coalesced"],
                                 f"{policy}: coalesced vs walk_earlyout "
                                 f"after 10 rounds")
        tel = at10["coalesced"][1]
        expiries = tel.expiries.tolist()
        if policy == "timing" and any(expiries):
            raise AssertionError(f"timing: expiries {expiries}")
        if policy == "withhold_near_quorum" and (
                any(expiries[:POLICY_TIMEOUT]) or not sum(expiries)):
            raise AssertionError(f"withholding: expiries {expiries}")
        if int(at10["coalesced"][0].records.votes.sum()) == 0:
            raise AssertionError(f"{policy}: no vote reached the windows")
        rows[policy] = {"engines": times,
                        **{f: getattr(tel, f).tolist()
                           for f in ("deliveries", "expiries",
                                     "ring_occupancy", "votes_applied")}}
        del at3, at10, tel
        torch.cuda.empty_cache()
    launches, _ = counts.delta()
    if any(launches.values()):
        raise AssertionError(f"policy async launched kernels {launches}; "
                             f"the async path has none by design")
    return {"nodes": n, "txs": t, "byzantine_fraction": POLICY_BYZANTINE,
            "latency": 2, "timeout_rounds": POLICY_TIMEOUT,
            "rounds": POLICY_ASYNC_ROUNDS, "policies": rows,
            "launches": launches}


def run_policy_records(device="cuda") -> list:
    """Part (c): every `workload.POLICY_RECORDS` case on every engine it
    applies to (the phased engines for a sync case, the three delivery
    engines for an async one), each equal to the JAX package's record."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.ops import voterecord as vr

    rows = []
    for name, want in workload.POLICY_RECORDS.items():
        counts = Launches()
        times = {}
        for engine in workload.policy_engines(name):
            model, start, cfg = workload.policy_state(name, engine, device)
            run_scan = dag.run_scan if model == "dag" else av.run_scan
            (final, tel), ms = timed_run(run_scan, start, cfg,
                                         n_rounds=workload.POLICY_ROUNDS,
                                         device=device)
            records = final.base.records if model == "dag" else final.records
            got = {"finalizations": tel.finalizations.tolist(),
                   "votes_applied": tel.votes_applied.tolist()}
            if "expiries" in want:
                got["expiries"] = tel.expiries.tolist()
            got["finalized_fraction"] = float(vr.has_finalized(
                records.confidence, cfg).double().mean())
            if got != want:
                bad = [f for f in want if got[f] != want[f]]
                raise AssertionError(f"policy record {name} on {engine}: "
                                     f"{bad} differ from the JAX record")
            times[engine] = ms / workload.POLICY_ROUNDS
        launches, paths = counts.delta()
        rows.append({"case": name, "model": workload.POLICY_CASES[name][0],
                     "nodes": workload.POLICY_SHAPE[0],
                     "txs": workload.POLICY_SHAPE[1],
                     "rounds": workload.POLICY_ROUNDS,
                     "finalized_fraction": want["finalized_fraction"],
                     "ms_per_round": times, "launches": launches,
                     "launches_by_ingest_path": paths})
    return rows


def run_fleet_records(names, device="cuda") -> list:
    """Part (d): the fleet points `names` of `workload.FLEET_CASES`
    through `fleet.run_fleet` / `run_phase_grid`, each row equal to the
    JAX package's (`workload.FLEET_RECORDS`), tag included."""
    import torch

    from go_avalanche_tpu_torch import fleet, workload
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.obs.tags import config_tag

    rows = []
    for name in names:
        case = workload.FLEET_CASES[name]
        cfg = AvalancheConfig(**case["knobs"])
        counts = Launches()
        t0 = time.perf_counter()
        if case["grid"] is None:
            res = fleet.run_fleet(case["model"], cfg, device=device,
                                  **case["kw"])
            got = [{**res.summary(), "tag": config_tag(cfg)}]
        else:
            got = fleet.run_phase_grid(case["model"], cfg, case["grid"],
                                       device=device, **case["kw"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = json.loads(json.dumps(got))
        if got != workload.FLEET_RECORDS[name]:
            raise AssertionError(f"fleet {name}: {got} != the JAX rows "
                                 f"{workload.FLEET_RECORDS[name]}")
        launches, paths = counts.delta()
        rounds = case["kw"]["fleet"] * case["kw"]["n_rounds"] * len(got)
        rows.append({"case": name, "model": case["model"], **case["kw"],
                     "rows": got, "trial_rounds": rounds,
                     "ms_per_trial_round": wall * 1e3 / rounds,
                     "launches": launches,
                     "launches_by_ingest_path": paths, "wall_s": wall})
    return rows


def run_adversary(quick: bool = False, device="cuda") -> dict:
    """Phase 10: the adaptive adversary and the Monte-Carlo fleet (module
    docstring).  Returns each part's rows with its wall seconds, and the
    phase's launches per kernel and per ingest path."""
    from go_avalanche_tpu_torch import workload

    n, t = ADVERSARY_SHAPES["quick" if quick else "full"]
    fleets = (("atlas_hostile",) if quick else tuple(workload.FLEET_CASES))
    parts = {"sync": lambda: run_policy_sync(n, t, device),
             "async": lambda: run_policy_async(n, t, device),
             "records": lambda: run_policy_records(device),
             "fleet": lambda: run_fleet_records(fleets, device)}
    reset_launches()
    out = {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        rows = part()
        out[name] = {"rows": rows, "wall_s": time.perf_counter() - t0}
    out["launches"] = read_launches()
    out["launches_by_ingest_path"] = read_path_launches()
    for kernel in ("vote_u8", "vote_swar"):
        if not out["launches_by_ingest_path"][kernel]["fast"]:
            raise AssertionError(f"phase 10 never launched {kernel} on its "
                                 f"fast path")
    return out


# ---------------------------------------------------------------- phase 11

OBS_SHAPES = {
    "full": dict(flagship=(16_384, 16_384), dag=(10_000, 10_000),
                 grid=True, backlog_rounds=200, backlog_every=10,
                 node_txs=4096, registry=1_000_000, active=16_384),
    "quick": dict(flagship=(256, 512), dag=(64, 64), grid=False,
                  backlog_rounds=40, backlog_every=10, node_txs=256,
                  registry=4096, active=64),
}
OBS_ROUNDS = 5               # the traced flagship, each engine, each side
OBS_STRIDE = 3               # the strided trace: 10 rounds, 4 slots
OBS_STRIDE_ROUNDS = 10


def assert_trace_is_telemetry(buf, tel, where: str) -> None:
    """The trace rows of `buf` equal the stacked telemetry `tel` of the
    same run at every stride-th round."""
    import torch

    from go_avalanche_tpu_torch.obs import trace as obs_trace
    from go_avalanche_tpu_torch.obs.sink import _flatten_telemetry

    rows = obs_trace.stacked_telemetry(buf)
    flat = _flatten_telemetry(tel, {})
    if rows._fields != tuple(flat):
        raise AssertionError(f"{where}: trace columns {rows._fields} != "
                             f"telemetry {tuple(flat)}")
    for name, col in flat.items():
        want = col[::buf.stride].cpu()
        got = torch.from_numpy(getattr(rows, name))
        if want.is_floating_point():
            want, got = want.view(torch.int32), got.view(torch.int32)
        if not torch.equal(want.to(torch.int32), got.to(torch.int32)):
            raise AssertionError(f"{where}: trace column {name} differs "
                                 f"from the stacked telemetry")


def run_traced_flagship(n: int, t: int, tmp, device="cuda") -> dict:
    """Part (a): the flagship with both taps on (``metrics_every=1``,
    ``trace_every=1``, inside a `metrics_sink`) between two taps-off
    runs, 5 rounds each on the megakernel, phased-u8 and phased-swar32;
    then
    the strided trace and the clamp on one engine."""
    import torch

    from go_avalanche_tpu_torch import obs, sync, workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models.backlog import stack_tree
    from go_avalanche_tpu_torch.obs import trace as obs_trace

    start, mega_cfg = workload.flagship_state(n, t, round_engine="megakernel",
                                              device=device)
    cfgs = {"megakernel": mega_cfg,
            "vote_u8": workload.flagship_config(t),
            "vote_swar": dataclasses.replace(workload.flagship_config(t),
                                             ingest_engine="swar32")}

    def loop(state, cfg):
        """`OBS_ROUNDS` rounds timed by CUDA events; (state, telemetry
        rows, ms a round, host reads in the loop, launches)."""
        counts = Launches()
        reads = sync.reads
        tels = []
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(OBS_ROUNDS):
            state, tel = av.round_step(state, cfg)
            tels.append(tel)
        end.record()
        torch.cuda.synchronize()
        return (state, tels, begin.elapsed_time(end) / OBS_ROUNDS,
                sync.reads - reads, counts.delta()[0])

    rows, planes, total = {}, {}, {"megakernel": 0, "vote_u8": 0,
                                   "vote_swar": 0}
    for name, off_cfg in cfgs.items():
        on_cfg = dataclasses.replace(off_cfg, metrics_every=1, trace_every=1)
        av.round_step(start, off_cfg)       # warm-up, outside the counts
        off, _, off_ms, off_reads, off_launches = loop(start, off_cfg)
        tap = tmp / f"tap_{name}.jsonl"
        with obs.metrics_sink(tap):
            reads = sync.reads
            on, tels, on_ms, on_reads, on_launches = loop(
                av.with_trace(start, on_cfg, OBS_ROUNDS), on_cfg)
        drain_reads = sync.reads - reads - on_reads
        _, _, after_ms, after_reads, after_launches = loop(start, off_cfg)
        want = {k: OBS_ROUNDS if k == name else 0 for k in total}
        if want != on_launches or want != off_launches or (
                want != after_launches):
            raise AssertionError(f"traced flagship {name}: launches on "
                                 f"{on_launches}, off {off_launches} and "
                                 f"{after_launches}, want {want}")
        if on_reads != off_reads or after_reads != off_reads or (
                drain_reads != 1):
            raise AssertionError(f"traced flagship {name}: host reads in "
                                 f"the loop {on_reads} (taps off "
                                 f"{off_reads}), drain {drain_reads}")
        assert_states_equal(on._replace(trace=None), off,
                            f"traced flagship {name}, taps on vs off")
        assert_trace_is_telemetry(on.trace, stack_tree(tels),
                                  f"traced {name}")
        trace_file = tmp / f"trace_{name}.jsonl"
        with obs.metrics_sink(trace_file) as sink:
            obs_trace.write_trace(sink, on.trace)
        if tap.read_bytes() != trace_file.read_bytes():
            raise AssertionError(f"traced flagship {name}: the tap's JSONL "
                                 f"and write_trace's differ")
        planes[name] = obs_trace.to_host(on.trace)
        for k, v in on_launches.items():
            total[k] += v
        rows[name] = {"ms_per_round_taps_on": on_ms,
                      "ms_per_round_taps_off": (off_ms + after_ms) / 2,
                      "ms_per_round_taps_off_before_after": [off_ms,
                                                             after_ms],
                      "host_reads_in_loop": on_reads,
                      "host_reads_taps_off": off_reads,
                      "drain_reads": drain_reads, "launches": on_launches,
                      "tap_records": len(tap.read_text().splitlines())}
    first = planes["megakernel"]
    for name in ("vote_u8", "vote_swar"):
        if not (first.data == planes[name].data).all() or int(
                first.cursor) != int(planes[name].cursor):
            raise AssertionError(f"trace planes differ: megakernel vs {name}")

    # The strided trace, then the clamp: the same buffer run on past its
    # horizon, the writes beyond its last slot landing on that slot.
    cfg = dataclasses.replace(cfgs["vote_u8"], trace_every=OBS_STRIDE)
    state = av.with_trace(start, cfg, OBS_STRIDE_ROUNDS)
    counts = Launches()
    tels = []
    for _ in range(OBS_STRIDE_ROUNDS):
        state, tel = av.round_step(state, cfg)
        tels.append(tel)
    slots = obs_trace.slots_for(OBS_STRIDE_ROUNDS, OBS_STRIDE)
    host = obs_trace.to_host(state.trace)
    if host.data.shape[0] != slots or int(host.cursor) != slots:
        raise AssertionError(f"strided trace: {host.data.shape[0]} slots, "
                             f"cursor {int(host.cursor)}, want {slots}")
    obs.check_trace(state.trace, cfg, OBS_STRIDE_ROUNDS)
    assert_trace_is_telemetry(state.trace, stack_tree(tels),
                              "strided trace")
    past = 2 * OBS_STRIDE           # two more emitted rounds
    for _ in range(past):
        state, tel = av.round_step(state, cfg)
        tels.append(tel)
    torch.cuda.synchronize()
    host = obs_trace.to_host(state.trace)
    emitted = [r for r in range(OBS_STRIDE_ROUNDS + past)
               if r % OBS_STRIDE == 0]
    if int(host.cursor) != len(emitted):
        raise AssertionError(f"clamp: cursor {int(host.cursor)} != "
                             f"{len(emitted)} writes")
    last = {f: int(getattr(tels[emitted[-1]], f)) for f in tels[0]._fields}
    got = dict(zip((c for c, _ in host.columns), host.data[-1].tolist()))
    if got != last:
        raise AssertionError(f"clamp: last slot {got} != round "
                             f"{emitted[-1]}'s telemetry {last}")
    launches = counts.delta()[0]
    if launches["vote_u8"] != OBS_STRIDE_ROUNDS + past:
        raise AssertionError(f"strided trace launches {launches}")
    total["vote_u8"] += launches["vote_u8"]
    return {"engines": rows, "strided": {
        "stride": OBS_STRIDE, "rounds": OBS_STRIDE_ROUNDS, "slots": slots,
        "clamp_rounds": OBS_STRIDE_ROUNDS + past,
        "clamp_cursor": int(host.cursor)}, "launches": total}


def run_traced_dag(n: int, t: int, device="cuda") -> dict:
    """Part (b): the DAG baseline on phased-u8 to settlement with
    ``trace_every=1`` and `Watchdog.check` after every round."""
    import torch

    from go_avalanche_tpu_torch import obs, sync, workload
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.obs import trace as obs_trace

    start, cfg = workload.dag_baseline_state(n, t, device=device)
    cfg = dataclasses.replace(cfg, trace_every=1)
    state = dag.with_trace(start, cfg, DAG_MAX_ROUNDS)
    watchdog = obs.Watchdog(cfg)
    counts = Launches()
    reads = sync.reads
    t0 = time.perf_counter()
    rounds = 0
    while rounds < DAG_MAX_ROUNDS and not sync.read(dag.settled(state, cfg)):
        state = dag.round_step(state, cfg)[0]
        watchdog.check(state)
        rounds += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host_reads = sync.reads - reads
    launches = counts.delta()[0]
    if rounds != DAG_REFERENCE["rounds"]:
        raise AssertionError(f"traced dag: {rounds} rounds != the "
                             f"reference's {DAG_REFERENCE['rounds']}")
    if launches != {"megakernel": 0, "vote_u8": rounds, "vote_swar": 0}:
        raise AssertionError(f"traced dag launches {launches}")
    records = obs_trace.trace_records(state.base.trace)
    if [r["round"] for r in records] != list(range(rounds)):
        raise AssertionError("traced dag: trace rounds")
    fin = sum(r["finalizations"] for r in records)
    return {"rounds": rounds, "watchdog_checks": watchdog.checks,
            "host_reads": host_reads, "finalizations": fin,
            "launches": launches, "wall_s": wall}


def run_traced_fault_studies(device="cuda") -> list:
    """Part (c): the four fault studies at 512 x 64 on the coalesced
    engine with ``trace_every=1`` and the watchdog (its `check_ring_cut`
    included) after every round; each `check_recovery` report equal to
    `workload.RECOVERY_RECORDS`."""
    from go_avalanche_tpu_torch import obs, sync, workload
    from go_avalanche_tpu_torch.models import avalanche as av

    rows = []
    counts = Launches()
    for name, want in workload.RECOVERY_RECORDS.items():
        start, cfg, n_rounds = workload.fault_study_state(name, "coalesced",
                                                          device=device)
        cfg = dataclasses.replace(cfg, trace_every=1)
        state = av.with_trace(start, cfg, n_rounds)
        watchdog = obs.Watchdog(cfg)
        reads = sync.reads
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            state = av.round_step(state, cfg)[0]
            watchdog.check(state)
        wall = time.perf_counter() - t0
        report = obs.check_recovery(cfg, state.trace)
        got = json.loads(json.dumps({"ok": report.ok,
                                     "windows": report.windows,
                                     "totals": report.totals}))
        if got != want:
            raise AssertionError(f"fault study {name}: recovery report "
                                 f"{got} != the JAX record {want}")
        series = obs.trace_records(state.trace)
        for field in ("finalizations", "expiries", "partition_blocked"):
            if [r[field] for r in series] != \
                    workload.FAULT_STUDY_RECORDS[name][field]:
                raise AssertionError(f"fault study {name}: traced {field} "
                                     f"differ from the record")
        rows.append({"study": name, "rounds": n_rounds,
                     "recovered": report.ok, "windows": report.windows,
                     "watchdog_checks": watchdog.checks,
                     "host_reads": sync.reads - reads,
                     "ms_per_round_checked": wall * 1e3 / n_rounds})
    launches = counts.delta()[0]
    if any(launches.values()):
        raise AssertionError(f"traced fault studies launched {launches}: "
                             f"the async path has no kernel by design")
    return rows


def run_traced_fleets(grid: bool, device="cuda") -> list:
    """Part (d): the atlas's most hostile point (8 traced Snowball
    trials) and, at full size, the policy grid's split_vote point (4
    trials of 4096 x 1024): each fleet-stacked trace JSONL's sha256
    equal to `workload.FLEET_TRACE_RECORDS`; the atlas's spot-check of
    every trial's stall verdict against its trace finality curve."""
    import torch

    from go_avalanche_tpu_torch import fleet, workload
    from go_avalanche_tpu_torch.config import AvalancheConfig

    rows = []
    names = ("atlas_hostile", "policy_grid") if grid else ("atlas_hostile",)
    for name in names:
        case = workload.FLEET_CASES[name]
        rec = workload.FLEET_TRACE_RECORDS[name]
        cfg = AvalancheConfig(**case["knobs"], trace_every=1)
        if rec["point"] is not None:
            cfg = fleet.point_config(cfg, rec["point"])
        kw = dict(case["kw"], fleet=rec["fleet"])
        counts = Launches()
        t0 = time.perf_counter()
        res = fleet.run_fleet(case["model"], cfg, device=device, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records = res.trace_records()
        digest = workload.trace_jsonl_digest(records)
        if digest != rec["sha256"] or len(records) != rec["rows"]:
            raise AssertionError(f"fleet trace {name}: sha256 {digest} over "
                                 f"{len(records)} rows != the JAX record")
        launches = counts.delta()[0]
        trial_rounds = kw["fleet"] * kw["n_rounds"]
        row = {"case": name, "fleet": kw["fleet"], "rows": len(records),
               "sha256": digest, "launches": launches,
               "ms_per_trial_round": wall * 1e3 / trial_rounds,
               "wall_s": wall}
        if name == "atlas_hostile":
            n_byz = int(round(cfg.byzantine_fraction * kw["n_nodes"]))
            for i in range(kw["fleet"]):
                total = sum(r["finalizations"][i] for r in records)
                stalled = bool(res.stalled[i])
                if ((stalled and total > n_byz) or (
                        not stalled and res.finalized_fraction[i] > 0
                        and total == 0)):
                    raise AssertionError(
                        f"atlas trial {i}: stall verdict {stalled} "
                        f"disagrees with its trace finality curve "
                        f"({total} finalizations, {n_byz} byzantine)")
            row["stalls"] = int(res.stalled.sum())
        elif launches["vote_u8"] != trial_rounds:
            raise AssertionError(f"fleet trace {name}: launches {launches} "
                                 f"!= one vote_u8 a trial round")
        rows.append(row)
    return rows


def run_traced_schedulers(shape: dict, device="cuda") -> list:
    """Part (e): `backlog.run_scan` at config 5's width with
    ``trace_every=10`` and the node stream (its registry, 3 rounds) with
    ``trace_every=1``: each trace's rows equal to the stacked telemetry
    of the same call."""
    import torch

    from go_avalanche_tpu_torch import prng, workload
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models import backlog, node_stream

    rows = []
    quick = shape["backlog_rounds"] < 200
    start, cfg = workload.config5_state(quick, device=device)
    cfg = dataclasses.replace(cfg, trace_every=shape["backlog_every"])
    n_rounds = shape["backlog_rounds"]
    state = backlog.with_trace(start, cfg, n_rounds)
    counts = Launches()
    (final, tel), ms = timed_run(backlog.run_scan, state, cfg, n_rounds,
                                 device=device)
    assert_trace_is_telemetry(final.sim.trace, tel, "traced backlog")
    rows.append({"part": "backlog", "window": workload.config5_shape(
        quick)[2], "rounds": n_rounds, "stride": cfg.trace_every,
        "slots": int(final.sim.trace.cursor), "ms_per_round": ms / n_rounds,
        "launches": counts.delta()[0]})
    del start, state, final
    torch.cuda.empty_cache()

    ncfg = AvalancheConfig(stake_mode="zipf", stake_zipf_s=1.0,
                           registry_nodes=shape["registry"],
                           active_nodes=shape["active"],
                           node_churn_rate=1e-3,
                           max_element_poll=max(4096, shape["node_txs"]),
                           trace_every=1)
    start = node_stream.with_trace(node_stream.init(
        prng.key(0, device), shape["node_txs"], ncfg, device=device), ncfg, 3)
    counts = Launches()
    (final, tel), ms = timed_run(node_stream.run_scan, start, ncfg, 3,
                                 device=device)
    assert_trace_is_telemetry(final.sim.trace, tel, "traced node stream")
    rows.append({"part": "node_stream", "registry_nodes": shape["registry"],
                 "active_nodes": shape["active"], "txs": shape["node_txs"],
                 "rounds": 3, "ms_per_round": ms / 3,
                 "resident_stake": float(tel.resident_stake[-1]),
                 "launches": counts.delta()[0]})
    return rows


def run_obs(quick: bool = False, device="cuda") -> dict:
    """Phase 11: the flight recorder (module docstring).  Returns each
    part's rows with its wall seconds and the phase's launches per
    kernel."""
    import tempfile
    from pathlib import Path

    shape = OBS_SHAPES["quick" if quick else "full"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        parts = {
            "flagship": lambda: run_traced_flagship(*shape["flagship"],
                                                    Path(tmp), device),
            "dag": lambda: run_traced_dag(*shape["dag"], device),
            "recovery": lambda: run_traced_fault_studies(device),
            "fleet": lambda: run_traced_fleets(shape["grid"], device),
            "schedulers": lambda: run_traced_schedulers(shape, device),
        }
        reset_launches()
        for name, part in parts.items():
            t0 = time.perf_counter()
            rows = part()
            out[name] = {"rows": rows, "wall_s": time.perf_counter() - t0}
    out["launches"] = read_launches()
    return out


HOST_SHAPES = {          # phase 12: the CLI, the resume, the Connector
    "full": dict(cli=(16_384, 16_384), resume_sets=4096, chunk=8,
                 connector=(16_384, 4096),
                 backlog=dict(nodes=1024, txs=65_536, slots=4096,
                              submit=8192, rounds=40)),
    "quick": dict(cli=(64, 64), resume_sets=256, chunk=4,
                  connector=(64, 64),
                  backlog=dict(nodes=32, txs=512, slots=64, submit=64,
                               rounds=20)),
}
HOST_CLI_ROUNDS = 5
HOST_CLI_ENGINES = {"megakernel": ["--round-engine", "megakernel"],
                    "vote_u8": [],
                    "vote_swar": ["--ingest-engine", "swar32"]}
HOST_TRANSFER_BYTES = 64 << 20   # run_chunked's default fetch cap


def _synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _without_wall(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "elapsed_s"}


def run_host_cli(n: int, t: int, device="cuda") -> tuple:
    """Phase 12 (a): `run_sim.main` in process on the three engines at
    the flagship's width, each result against the other engines' and a
    direct `avalanche.run` at the config `parse_args` gives; each
    engine's kernel launched once a round."""
    import contextlib
    import io

    from go_avalanche_tpu_torch import prng, run_sim, workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.ops import voterecord as vr
    from go_avalanche_tpu_torch.utils import metrics

    base = ["--model", "avalanche", "--nodes", str(n), "--txs", str(t),
            "--k", "8", "--no-gossip", "--max-element-poll",
            str(max(4096, t)), "--finalization-score", "32766",
            "--max-rounds", str(HOST_CLI_ROUNDS), "--json",
            "--device", str(device)]
    rows, results = [], {}
    launches = dict.fromkeys(KERNEL_ROWS, 0)
    for kernel, extra in HOST_CLI_ENGINES.items():
        argv = base + extra
        _synchronize(device)
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = run_sim.main(argv)
        _synchronize(device)
        wall = time.perf_counter() - t0
        used = read_launches()
        want = {**dict.fromkeys(KERNEL_ROWS, 0), kernel: HOST_CLI_ROUNDS}
        if used != want:
            raise AssertionError(f"run_sim {kernel}: launches {used} != "
                                 f"{want}")
        for name, count in used.items():
            launches[name] += count
        if json.loads(out.getvalue().strip().splitlines()[-1]) != result:
            raise AssertionError(f"run_sim {kernel}: the JSON line is not "
                                 f"the result dict")
        # the same run through the entry points, at the parsed config
        args, cfg = run_sim.parse_args(argv)
        flagship = dataclasses.replace(
            workload.flagship_config(t), round_engine=cfg.round_engine,
            ingest_engine=cfg.ingest_engine)
        unexpressed = [f.name for f in dataclasses.fields(cfg)
                       if getattr(cfg, f.name) != getattr(flagship, f.name)]
        reset_launches()
        state = av.run(av.init(prng.key(args.seed, device), n, t, cfg,
                               device=device), cfg, HOST_CLI_ROUNDS,
                       device=device)
        fin = vr.has_finalized(state.records.confidence, cfg).cpu().numpy()
        direct = {"model": "avalanche", "nodes": n, "txs": t,
                  "backend": torch_device_type(device),
                  "rounds": int(state.round),
                  "finalized_fraction": float(fin.mean()),
                  "nodes_fully_finalized": int(fin.all(axis=1).sum()),
                  **{f"finality_{k}": v for k, v in
                     metrics.rounds_to_finality(state.finalized_at).items()}}
        launches[kernel] += read_launches()[kernel]
        if _without_wall(result) != direct:
            raise AssertionError(f"run_sim {kernel}: {result} != the "
                                 f"direct avalanche.run {direct}")
        results[kernel] = _without_wall(result)
        rows.append({"engine": kernel, "wall_s": wall,
                     "rounds": result["rounds"],
                     "flagship_fields_unexpressed": unexpressed,
                     "launches": used})
        del state
    if not (results["megakernel"] == results["vote_u8"]
            == results["vote_swar"]):
        raise AssertionError(f"run_sim results differ across engines: "
                             f"{results}")
    return rows, launches


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


class _Killed(Exception):
    """Raised by phase 12's progress hook to stop a run mid-way."""


def run_host_resume(sets: int, chunk: int, quick: bool,
                    device="cuda") -> tuple:
    """Phase 12 (b): config 6 at full width cut to 3 chunks: an
    uninterrupted `run_chunked`; one saving a checkpoint every chunk and
    killed at the second boundary once the first save landed; its
    checkpoint restored and run to the same depth, leaf-equal to the
    uninterrupted run."""
    import os
    import tempfile
    from pathlib import Path

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import streaming_dag as sdg
    from go_avalanche_tpu_torch.utils import checkpoint as ck

    star = dict(workload.QUICK if quick else workload.NORTH_STAR,
                backlog_sets=sets)
    start, cfg = workload.northstar_state(**star, device=device)
    depth = 3 * chunk
    _synchronize(device)
    reset_launches()
    t0 = time.perf_counter()
    full = sdg.run_chunked(start, cfg, max_rounds=depth, chunk=chunk,
                           device=device)
    _synchronize(device)
    run_s = time.perf_counter() - t0
    leaves = []
    ck._map_tensors(start, lambda x: leaves.append(x) or x)
    nbytes = [x.numel() * x.element_size() for x in leaves]
    blocks = sum(max(1, len(list(ck._row_blocks(tuple(x.shape), b,
                                                HOST_TRANSFER_BYTES))))
                 for x, b in zip(leaves, nbytes))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "config6.npz"
        marks = {}

        def kill_after_first_save(rounds, state):
            marks[rounds] = time.time()
            if len(marks) == 2:
                deadline = time.time() + 600
                while not path.exists():
                    if time.time() > deadline:
                        raise AssertionError("no checkpoint landed")
                    time.sleep(0.01)
                raise _Killed(rounds)

        try:
            sdg.run_chunked(start, cfg, max_rounds=depth, chunk=chunk,
                            checkpoint_path=str(path),
                            checkpoint_every_chunks=1,
                            progress=kill_after_first_save, device=device)
        except _Killed:
            pass
        else:
            raise AssertionError("the checkpointed run was not killed")
        save_s = os.path.getmtime(path) - marks[chunk]
        file_bytes = path.stat().st_size
        t0 = time.perf_counter()
        resumed = ck.restore_checkpoint(str(path), start,
                                        max_transfer_bytes=HOST_TRANSFER_BYTES,
                                        device=device)
        _synchronize(device)
        restore_s = time.perf_counter() - t0
    if int(resumed.dag.base.round) != chunk:
        raise AssertionError(f"the checkpoint holds round "
                             f"{int(resumed.dag.base.round)}, not {chunk}")
    final = sdg.run_chunked(resumed, cfg, max_rounds=depth, chunk=chunk,
                            device=device)
    assert_trees_equal(final, full, "resumed vs uninterrupted")
    launches = read_launches()
    want = {**dict.fromkeys(KERNEL_ROWS, 0), "vote_u8": 7 * chunk}
    if launches != want:
        raise AssertionError(f"resume: launches {launches} != {want}")
    row = {"nodes": star["nodes"], "window_sets": star["window_sets"],
           "set_cap": star["set_cap"], "backlog_sets": sets,
           "chunk": chunk, "depth": depth,
           "depth_cut": f"3 chunks of {chunk} rounds (config 6 runs 8313 "
                        f"rounds whole); width unchanged",
           "state_bytes": sum(nbytes), "file_bytes": file_bytes,
           "transfer_blocks_64MiB": blocks, "save_s": save_s,
           "restore_s": restore_s, "uninterrupted_run_s": run_s,
           "launches": launches}
    del start, full, resumed, final
    return [row], launches


def run_host_connector(n: int, t: int, bl: dict, device="cuda") -> tuple:
    """Phase 12 (c): the Connector server on the card over loopback,
    driven by the port's client: SIM_RUN 5 + 5 against a direct 10-round
    `run_scan`; an external-arrival backlog fed by SIM_SUBMIT against the
    same pushes and runs made directly; and the C++ harness when
    `make -C native` builds here."""
    import os
    import subprocess

    import torch

    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch import traffic as tf
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.connector import (ConnectorClient,
                                                  ConnectorServer)
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import backlog as blm
    from go_avalanche_tpu_torch.ops import voterecord as vr

    rows = []
    _synchronize(device)
    reset_launches()
    with ConnectorServer(device=device) as srv, ConnectorClient(
            *srv.address, timeout_s=900) as c:
        engine = srv.backend
        t0 = time.perf_counter()
        c.sim_init(n, t, seed=0)
        first, second = c.sim_run(5), c.sim_run(5)
        wire_s = time.perf_counter() - t0
        arrivals = []
        c.sim_init(bl["nodes"], bl["txs"], seed=0, model="backlog",
                   window_sets=bl["slots"], arrival_mode="external")
        for _ in range(3):
            arrivals.append(tuple(c.sim_submit(bl["submit"])))
            arrivals.append(tuple(c.sim_run(bl["rounds"])))
        arrivals.append(tuple(c.sim_submit(0)))
    server_launches = read_launches()

    cfg = AvalancheConfig()      # the wire's defaults: k 8, score 128
    state, tel = av.run_scan(av.init(prng.key(0, device), n, t, cfg,
                                     device=device), cfg, 10, device=device)
    fin = vr.has_finalized(state.records.confidence, cfg)
    want = (int(state.round), int(fin.sum()) / fin.numel(),
            *(int(x.sum(dtype=torch.int64)) for x in (
                tel.polls, tel.votes_applied, tel.flips, tel.finalizations)))
    if tuple(second) != want or first.round != 5:
        raise AssertionError(f"SIM_STATS {tuple(second)} != a direct "
                             f"10-round run_scan {want}")
    del state, tel, fin

    bcfg = AvalancheConfig(arrival_mode="external")
    s = blm.init(prng.key(0, device), bl["nodes"], bl["slots"],
                 blm.make_backlog(torch.arange(bl["txs"], dtype=torch.int32)),
                 bcfg, device=device)
    replay = []

    def stats(s):
        lat = tf.traffic_telemetry(s.traffic, torch.zeros(
            (), dtype=torch.int32, device=s.sim.round.device))
        return (int(lat.arrived_total), int(s.next_idx),
                int(s.outputs.settled.sum()), int(lat.lat_count),
                int(lat.lat_p50), int(lat.lat_p99), int(lat.lat_p999))

    for _ in range(3):
        s = s._replace(traffic=tf.push_arrivals(s.traffic, bl["submit"],
                                                s.sim.round))
        replay.append(stats(s))
        s, btel = blm.run_scan(s, bcfg, bl["rounds"], device=device)
        replay.append(None)
    replay.append(stats(s))
    for i, (got, ref) in enumerate(zip(arrivals, replay)):
        if ref is not None and got != ref:
            raise AssertionError(f"SIM_SUBMIT {i}: {got} != direct {ref}")
    final = arrivals[-1]
    if not (final[0] == 3 * bl["submit"] and 0 < final[2] <= final[1]
            <= final[0] and final[4] > 0):
        raise AssertionError(f"external backlog stats {final} out of range")
    rows.append({"part": "wire", "engine": engine, "nodes": n, "txs": t,
                 "sim_stats": list(second), "wire_s": wire_s})
    rows.append({"part": "external_backlog", **bl,
                 "traffic_stats": list(final)})
    launches = read_launches()
    if server_launches["vote_u8"] < 10 or launches["vote_u8"] < 20:
        raise AssertionError(f"connector: launches {launches}")

    native_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "native")
    try:
        subprocess.run(["make", "-C", native_dir, "all", "clients"],
                       check=True, capture_output=True, text=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        rows.append({"part": "native_harness", "ran": False,
                     "reason": f"make -C native failed: {e}"[:300]})
    else:
        with ConnectorServer(device=device) as srv:
            host, port = srv.address
            t0 = time.perf_counter()
            out = subprocess.run(
                [os.path.join(native_dir, "build", "avalanche_harness"),
                 host, str(port), "6", "3", "--sim"],
                capture_output=True, text=True, timeout=300)
            harness_s = time.perf_counter() - t0
            engine = srv.backend
        if (out.returncode != 0
                or "nodes_fully_finalized=6/6" not in out.stdout
                or "finalized_fraction=1.000" not in out.stdout):
            raise AssertionError(f"C++ harness failed: {out.stdout} "
                                 f"{out.stderr}")
        rows.append({"part": "native_harness", "ran": True,
                     "engine": engine, "seconds": harness_s,
                     "stdout": out.stdout.strip().splitlines()})
    return rows, launches


def run_host(quick: bool = False, device="cuda") -> dict:
    """Phase 12: the host surfaces (module docstring).  Returns each
    part's rows with its wall seconds and the phase's launches."""
    shape = HOST_SHAPES["quick" if quick else "full"]
    parts = {
        "cli": lambda: run_host_cli(*shape["cli"], device),
        "resume": lambda: run_host_resume(shape["resume_sets"],
                                          shape["chunk"], quick, device),
        "connector": lambda: run_host_connector(*shape["connector"],
                                                shape["backlog"], device),
    }
    out = {"launches": dict.fromkeys(KERNEL_ROWS, 0)}
    for name, part in parts.items():
        t0 = time.perf_counter()
        rows, launches = part()
        out[name] = {"rows": rows, "wall_s": time.perf_counter() - t0}
        for kernel, count in launches.items():
            out["launches"][kernel] += count
        _empty_cache(device)
    return out


MESH_SHAPES = {          # phase 13: (a)'s flagship, rounds a run
    "full": dict(nodes=16_384, txs=16_384, rounds=5),
    "quick": dict(nodes=256, txs=512, rounds=3),
}
# (b)'s flagship: the tx-only contract holds at any width, so (b) runs
# at a quarter of (a)'s cells.
MESH_CONTRACT_SHAPES = {
    "full": dict(nodes=8192, txs=8192, rounds=5),
    "quick": dict(nodes=256, txs=512, rounds=3),
}
# (b): each mesh with only tx shards against its node-only twin.
MESH_CONTRACT = (((1, 2), (1, 1)), ((1, 4), (1, 1)), ((2, 2), (2, 1)))
# The tiles a mesh run's digests cover: the node axis in 2, the tx axis in
# 4, so that every mesh of (b) holds whole tiles and two runs compare
# tile by tile whatever their blocks.
MESH_TILES = {"nodes": 2, "txs": 4}
MESH_RANKS = 4
MESH_TIMEOUT = 300       # seconds a rank may take for one case


def _spec_walk(tree, specs, path: str = ""):
    """``(path, leaf, spec)`` over a sharded state tree and its specs."""
    if isinstance(specs, tuple) and not hasattr(specs, "_fields"):
        if tree is not None:
            yield path, tree, specs
        return
    if not isinstance(tree, tuple):
        return
    for name in tree._fields:
        yield from _spec_walk(getattr(tree, name), getattr(specs, name),
                              f"{path}.{name}" if path else name)


def tile_digests(state, mesh, specs) -> dict:
    """sha256 of every `MESH_TILES` tile of every leaf this rank's block
    holds, keyed by leaf path and global tile index; replicated leaves
    whole."""
    import hashlib
    import itertools

    out = {}
    for path, leaf, spec in _spec_walk(state, specs):
        dims = []
        for dim, axis in enumerate(spec):
            if axis is None:
                dims.append([(0, slice(None))])
                continue
            here = MESH_TILES[axis] // mesh.shape[axis]
            w = leaf.shape[dim] // here
            first = mesh.coords[axis] * here
            dims.append([(first + i, slice(i * w, (i + 1) * w))
                         for i in range(here)])
        for combo in itertools.product(*dims):
            part = leaf[tuple(c[1] for c in combo)].contiguous()
            key = f"{path}{[c[0] for c in combo]}"
            out[key] = hashlib.sha256(part.cpu().numpy().tobytes()
                                      ).hexdigest()
    return out


def _mesh_scan(mesh, block, cfg, rounds: int, device,
               digests: bool = True) -> dict:
    """`run_scan_sharded` on this rank's block, timed, with its launches
    and host-staged collectives counted from 0; the final block, its
    tile digests (with `digests`) and the telemetry."""
    from go_avalanche_tpu_torch.parallel import collectives, sharded

    collectives.host_staged = 0
    reset_launches()
    _synchronize(device)
    t0 = time.perf_counter()
    block, tel = sharded.run_scan_sharded(mesh, block, cfg, rounds)
    _synchronize(device)
    wall = time.perf_counter() - t0
    return {"final": block,
            "tiles": (tile_digests(block, mesh, sharded.specs_of(block))
                      if digests else None),
            "telemetry": {f: getattr(tel, f).tolist() for f in tel._fields},
            "ms_per_round": wall * 1e3 / rounds,
            "host_staged": collectives.host_staged,
            "launches": read_launches(),
            "launches_by_ingest_path": read_path_launches(),
            "block": list(block.records.votes.shape)}


def mesh_flagship_rank(nodes: int, txs: int, rounds: int, shape,
                       engine: str, device="cuda") -> dict:
    """Part (b), in a rank: the mesh flagship built on this rank's
    device, its block cut, `rounds` sharded rounds (`_mesh_scan`)."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.parallel import sharded
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    dev = _rank_setup(device)
    mesh = make_mesh(*shape)
    start, cfg = workload.mesh_flagship_state(nodes, txs, device=dev,
                                              ingest_engine=engine)
    block = sharded.shard_state(start, mesh)
    del start
    _empty_cache(dev)
    row = _mesh_scan(mesh, block, cfg, rounds, dev)
    del row["final"]
    return row


def sharded_record_rank(name: str, device="cuda") -> dict:
    """Part (c), in a rank: a `workload.SHARDED_CASES` case through the
    sharded driver; rank 0 digests the gathered state."""
    from go_avalanche_tpu_torch import convert, workload
    from go_avalanche_tpu_torch.models import dag
    from go_avalanche_tpu_torch.ops import voterecord as vr
    from go_avalanche_tpu_torch.parallel import sharded, sharded_dag
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    case = workload.SHARDED_CASES[name]
    dev = _rank_setup(device)
    mesh = make_mesh(*case["mesh"])
    out = {}
    reset_launches()
    t0 = time.perf_counter()
    if case["model"] == "avalanche":
        start, cfg = workload.mesh_flagship_state(case["nodes"], case["txs"],
                                                  device=dev)
        block, tel = sharded.run_scan_sharded(
            mesh, sharded.shard_state(start, mesh), cfg, case["rounds"])
        _synchronize(dev)
        whole = convert.state_to_numpy(sharded.gather_state(block, mesh))
        out["telemetry"] = workload.leaf_digests(
            {f: getattr(tel, f).cpu().numpy() for f in tel._fields})
        rounds = int(whole.round)
    else:
        start, cfg = workload.dag_baseline_state(case["nodes"], case["txs"],
                                                 device=dev)
        block = sharded_dag.run_sharded_dag(
            mesh, sharded_dag.shard_dag_state(start, mesh), cfg,
            max_rounds=case["max_rounds"])
        _synchronize(dev)
        gathered = sharded_dag.gather_dag_state(block, mesh)
        conf = gathered.base.records.confidence
        fin_acc = vr.has_finalized(conf, cfg) & vr.is_accepted(conf)
        out["sets_resolved_fraction"] = float(
            (dag.winners_per_set(fin_acc, 2) == 1).float().mean())
        whole = convert.dag_state_to_numpy(gathered)
        rounds = int(whole.base.round)
    wall = time.perf_counter() - t0
    if mesh.rank == 0:
        out["leaves"] = workload.leaf_digests(whole)
    return {**out, "rounds": rounds, "wall_s": wall,
            "launches": read_launches(),
            "launches_by_ingest_path": read_path_launches()}


def mesh_fleet_rank(shape, device="cuda") -> dict:
    """Part (d), in a rank: the policy grid's "off" point over a fleet
    mesh of the ranks; the row with its point and tag."""
    from go_avalanche_tpu_torch import fleet, workload
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.obs.tags import config_tag
    from go_avalanche_tpu_torch.parallel.sharded_fleet import make_fleet_mesh

    case = workload.FLEET_CASES["policy_grid"]
    dev = _rank_setup(device)
    cfg = AvalancheConfig(**case["knobs"])
    reset_launches()
    t0 = time.perf_counter()
    res = fleet.run_fleet(case["model"], cfg, mesh=make_fleet_mesh(*shape),
                          device=dev, **case["kw"])
    return {"row": {"point": {"adversary_policy": "off"}, **res.summary(),
                    "tag": config_tag(cfg)},
            "wall_s": time.perf_counter() - t0, "launches": read_launches(),
            "launches_by_ingest_path": read_path_launches()}


def _add_launches(total: dict, paths: dict, row: dict) -> None:
    for name, n in row["launches"].items():
        total[name] += n
    for name, by in row["launches_by_ingest_path"].items():
        for path, n in by.items():
            paths[name][path] += n


# Phase 13, part streaming: (f) config 6's width through the sharded
# streaming DAG, its backlog cut to 2 waves; (g) config 5's width through
# the sharded backlog, its backlog cut to 16,384 txs; (h) the 1M-node
# registry through the sharded node stream, 3 rounds.
STREAMING_MESH = {
    "full": dict(nodes=100_000, window_sets=1024, set_cap=2, sets=2048,
                 save_round=17, backlog_txs=16_384, registry=1_000_000,
                 active=16_384, node_txs=4096, node_rounds=3),
    "quick": dict(nodes=64, window_sets=32, set_cap=2, sets=64,
                  save_round=17, backlog_txs=1024, registry=4096, active=64,
                  node_txs=256, node_rounds=3),
}
# The per-tx-shard poll-order rank leaves: the one by-design difference
# between a tx-sharded streaming run and its node-only twin.
RANK_LEAVES = ("score_rank", "poll_order", "poll_order_inv")


def _without_ranks(tiles: dict) -> dict:
    return {k: v for k, v in tiles.items()
            if k.split("[")[0].rsplit(".", 1)[-1] not in RANK_LEAVES}


def _rank_setup(device):
    """This rank's device, made current."""
    import torch

    from go_avalanche_tpu_torch.parallel.runtime import rank_device

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def _peak_gib(device) -> float:
    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _counted_run(fn, device) -> dict:
    """`fn()` timed, with launches and host-staged tensors counted from
    0; ``{"out", "wall_s", "launches", "launches_by_ingest_path",
    "host_staged"}``."""
    from go_avalanche_tpu_torch.parallel import collectives

    collectives.host_staged = 0
    reset_launches()
    _synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    _synchronize(device)
    return {"out": out, "wall_s": time.perf_counter() - t0,
            "launches": read_launches(),
            "launches_by_ingest_path": read_path_launches(),
            "host_staged": collectives.host_staged}


def _check_one_launch_a_round(where: str, row: dict, kernel: str,
                              rounds: int) -> None:
    want = {"vote_u8": 0, "vote_swar": 0, "megakernel": 0, kernel: rounds}
    if row["launches"] != want:
        raise AssertionError(f"{where}: launches {row['launches']} != one "
                             f"{kernel} a round over {rounds}")
    if row["launches_by_ingest_path"][kernel] != {"fast": rounds, "any": 0}:
        raise AssertionError(f"{where}: launches by path "
                             f"{row['launches_by_ingest_path']} are not "
                             f"all on the fast path")


def _northstar(shape: dict, device):
    from go_avalanche_tpu_torch import workload

    return workload.northstar_state(shape["nodes"], shape["sets"],
                                    shape["set_cap"], shape["window_sets"],
                                    device=device)


def _config6_gate(final, shape: dict, quick: bool) -> dict:
    """Phase 8's gate: waves x 17 rounds and the outcome fractions."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import streaming_dag as sdg

    reference = workload.REFERENCE_QUICK if quick else workload.REFERENCE
    waves = -(-shape["sets"] // shape["window_sets"])
    want = {**reference["config6"], "rounds": waves * WAVE_ROUNDS}
    got = {"rounds": int(final.dag.base.round),
           **sdg.resolution_summary(final)}
    check_result("(f) config 6", got, want)
    return got


def _working_set(state, tel) -> dict:
    """sha256 of the node stream's working-set leaves and departures."""
    import hashlib

    leaves = {name: getattr(state, name) for name in
              ("slot_node", "resident", "stake", "churned_in",
               "churned_out")}
    leaves["latency_weight"] = state.sim.latency_weight
    leaves["departed"] = tel.departed
    return {name: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
            for name, x in leaves.items()}


def _node_stream_config(shape: dict):
    from go_avalanche_tpu_torch.config import AvalancheConfig

    return AvalancheConfig(stake_mode="zipf", stake_zipf_s=1.0,
                           registry_nodes=shape["registry"],
                           active_nodes=shape["active"],
                           node_churn_rate=1e-3,
                           max_element_poll=max(4096, shape["node_txs"]))


def streaming_1x1(quick: bool, device, total: dict, paths: dict) -> dict:
    """Part streaming on the 1x1 NCCL mesh of part (a), in this process:
    (f) the streaming DAG on u8 and swar32, leaf-equal, gated, beside
    the dense round; (g) the backlog; (h) the node stream against the
    dense `run_scan`."""
    import torch

    from go_avalanche_tpu_torch import prng, workload
    from go_avalanche_tpu_torch.models import node_stream
    from go_avalanche_tpu_torch.models import streaming_dag as sdg
    from go_avalanche_tpu_torch.parallel import sharded_backlog as sbl
    from go_avalanche_tpu_torch.parallel import sharded_node_stream as sns
    from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    shape = STREAMING_MESH["quick" if quick else "full"]
    mesh = make_mesh(1, 1)
    out = {}
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # (f)
    start, cfg = _northstar(shape, device)
    finals, rows = {}, {}
    for kernel, c in (("vote_u8", cfg), ("vote_swar", dataclasses.replace(
            cfg, ingest_engine="swar32"))):
        row = _counted_run(lambda: ssd.run_sharded_streaming_dag(
            mesh, ssd.shard_streaming_dag_state(start, mesh), c,
            max_rounds=STREAM_MAX_ROUNDS), device)
        finals[kernel] = row.pop("out")
        rounds = int(finals[kernel].dag.base.round)
        _check_one_launch_a_round(f"(f) 1x1 {kernel}", row, kernel, rounds)
        _add_launches(total, paths, row)
        rows[kernel] = {**row, "rounds": rounds,
                        "ms_per_round": row["wall_s"] * 1e3 / rounds}
    assert_trees_equal(finals["vote_u8"], finals["vote_swar"],
                       "(f) 1x1 u8 vs swar32")
    gate = _config6_gate(finals["vote_u8"], shape, quick)
    tiles = tile_digests(finals["vote_u8"], mesh,
                         ssd.specs_of(finals["vote_u8"]))
    del finals
    reset_launches()
    _synchronize(device)
    t0 = time.perf_counter()
    dense = sdg.run(start, cfg, max_rounds=STREAM_MAX_ROUNDS, device=device)
    _synchronize(device)
    dense_ms = (time.perf_counter() - t0) * 1e3 / int(dense.dag.base.round)
    out["streaming_dag"] = {
        "mesh": [1, 1], "nodes": shape["nodes"],
        "window_sets": shape["window_sets"], "backlog_sets": shape["sets"],
        "depth_cut": f"backlog cut to {shape['sets']} sets to fit the "
                     f"part's time; width unchanged",
        **gate, "engines": rows,
        "dense_streaming_dag_ms_per_round": dense_ms,
        "peak_gib": _peak_gib(device)}
    del start, dense
    _empty_cache(device)

    # (g)
    start, cfg = workload.config5_state(quick, device=device,
                                        n_txs=shape["backlog_txs"])
    row = _counted_run(lambda: sbl.run_sharded_backlog(
        mesh, sbl.shard_backlog_state(start, mesh), cfg,
        max_rounds=STREAM_MAX_ROUNDS), device)
    final = row.pop("out")
    rounds = int(final.sim.round)
    _check_one_launch_a_round("(g) 1x1", row, "vote_u8", rounds)
    _add_launches(total, paths, row)
    if not (bool(final.outputs.settled.all())
            and bool(final.outputs.accepted.all())):
        raise AssertionError("(g) 1x1: not every tx settled accepted")
    out["backlog"] = {"mesh": [1, 1], "backlog_txs": shape["backlog_txs"],
                      "window": int(start.slot_tx.shape[0]), **row,
                      "rounds": rounds,
                      "ms_per_round": row["wall_s"] * 1e3 / rounds,
                      "outputs": workload.leaf_digests(
                          {f: getattr(final.outputs, f).cpu().numpy()
                           for f in final.outputs._fields})}
    del start, final
    _empty_cache(device)

    # (h)
    ncfg = _node_stream_config(shape)
    start = node_stream.init(prng.key(0, device), shape["node_txs"], ncfg,
                             device=device)
    n_rounds = shape["node_rounds"]
    row = _counted_run(lambda: sns.run_scan_sharded_node_stream(
        mesh, sns.shard_node_stream_state(start, mesh), ncfg, n_rounds),
        device)
    final, tel = row.pop("out")
    _check_one_launch_a_round("(h) 1x1", row, "vote_u8", n_rounds)
    _add_launches(total, paths, row)
    dense, dtel = node_stream.run_scan(start, ncfg, n_rounds, device=device)
    got, want = _working_set(final, tel), _working_set(dense, dtel)
    if got != want:
        raise AssertionError(f"(h) 1x1: working set differs from the dense "
                             f"run_scan's: {sorted(k for k in got if got[k] != want[k])}")
    out["node_stream"] = {"mesh": [1, 1], "registry": shape["registry"],
                          "active": shape["active"],
                          "txs": shape["node_txs"], **row,
                          "rounds": n_rounds, "departed": int(
                              tel.departed.sum()),
                          "ms_per_round": row["wall_s"] * 1e3 / n_rounds}
    del start, final, dense
    _empty_cache(device)
    return {"rows": out, "tiles": tiles, "working_set": want,
            "backlog_outputs": out["backlog"]["outputs"],
            "backlog_rounds": rounds}


def stream_dag_rank(quick: bool, mesh_shape, path: str,
                    device="cuda") -> dict:
    """Part (f), in a rank: the streaming DAG at config 6's width on
    `mesh_shape` to settlement, saved with the DCP pair at
    `save_round`, then restored and run on to the end again; the tile
    digests of both ends, the save and restore seconds and the
    checkpoint's bytes."""
    import os

    from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh
    from go_avalanche_tpu_torch.utils import checkpoint

    dev = _rank_setup(device)
    shape = STREAMING_MESH["quick" if quick else "full"]
    mesh = make_mesh(*mesh_shape)
    start, cfg = _northstar(shape, dev)
    template = ssd.shard_streaming_dag_state(start, mesh)
    del start
    step = ssd.make_sharded_streaming_dag_step(mesh, cfg)

    def through():
        block = template
        for _ in range(shape["save_round"]):
            block = step(block)[0]
        t0 = time.perf_counter()
        checkpoint.save_checkpoint_dcp(path, block, mesh)
        saved_s = time.perf_counter() - t0
        block = ssd.run_sharded_streaming_dag(mesh, block, cfg,
                                              max_rounds=STREAM_MAX_ROUNDS)
        return block, saved_s

    row = _counted_run(through, device)
    final, save_s = row.pop("out")
    rounds = int(final.dag.base.round)
    tiles = tile_digests(final, mesh, ssd.specs_of(final))
    # The outputs, backlog and round are replicated: the block has them.
    gate = _config6_gate(final, shape, quick)
    del final
    t0 = time.perf_counter()
    block = checkpoint.restore_checkpoint_dcp(path, template, mesh)
    _synchronize(dev)
    restore_s = time.perf_counter() - t0
    resumed = _counted_run(lambda: ssd.run_sharded_streaming_dag(
        mesh, block, cfg, max_rounds=STREAM_MAX_ROUNDS), device)
    final = resumed.pop("out")
    if tile_digests(final, mesh, ssd.specs_of(final)) != tiles:
        raise AssertionError(f"(f) {mesh_shape}: the run resumed from the "
                             f"DCP checkpoint differs from the "
                             f"uninterrupted one")
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)
    return {"tiles": tiles, **gate, "rounds": rounds,
            "ms_per_round": (row["wall_s"] - save_s) * 1e3 / rounds,
            "run": row, "resumed": resumed,
            "resumed_rounds": int(final.dag.base.round) - shape["save_round"],
            "block": list(template.dag.base.records.votes.shape),
            "dcp_save_s": save_s, "dcp_restore_s": restore_s,
            "dcp_bytes": size, "peak_gib": _peak_gib(dev)}


def stream_backlog_rank(quick: bool, mesh_shape, device="cuda") -> dict:
    """Part (g), in a rank: the backlog at config 5's width on
    `mesh_shape` to settlement; the gathered outputs' digests."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.parallel import sharded_backlog as sbl
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    dev = _rank_setup(device)
    shape = STREAMING_MESH["quick" if quick else "full"]
    mesh = make_mesh(*mesh_shape)
    start, cfg = workload.config5_state(quick, device=dev,
                                        n_txs=shape["backlog_txs"])
    block = sbl.shard_backlog_state(start, mesh)
    del start
    row = _counted_run(lambda: sbl.run_sharded_backlog(
        mesh, block, cfg, max_rounds=STREAM_MAX_ROUNDS), device)
    final = sbl.gather_backlog_state(row.pop("out"), mesh)
    rounds = int(final.sim.round)
    return {**row, "rounds": rounds,
            "ms_per_round": row["wall_s"] * 1e3 / rounds,
            "block": list(block.sim.records.votes.shape),
            "outputs": workload.leaf_digests(
                {f: getattr(final.outputs, f).cpu().numpy()
                 for f in final.outputs._fields}),
            "peak_gib": _peak_gib(dev)}


def stream_node_rank(quick: bool, mesh_shape, device="cuda") -> dict:
    """Part (h), in a rank: the node stream on `mesh_shape`; the working
    set's digests."""
    from go_avalanche_tpu_torch import prng
    from go_avalanche_tpu_torch.models import node_stream
    from go_avalanche_tpu_torch.parallel import sharded_node_stream as sns
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    dev = _rank_setup(device)
    shape = STREAMING_MESH["quick" if quick else "full"]
    mesh = make_mesh(*mesh_shape)
    ncfg = _node_stream_config(shape)
    start = node_stream.init(prng.key(0, dev), shape["node_txs"], ncfg,
                             device=dev)
    block = sns.shard_node_stream_state(start, mesh)
    del start
    n_rounds = shape["node_rounds"]
    row = _counted_run(lambda: sns.run_scan_sharded_node_stream(
        mesh, block, ncfg, n_rounds), device)
    final, tel = row.pop("out")
    return {**row, "rounds": n_rounds,
            "ms_per_round": row["wall_s"] * 1e3 / n_rounds,
            "block": list(block.sim.records.votes.shape),
            "working_set": _working_set(final, tel),
            "peak_gib": _peak_gib(dev)}


def stream_record_rank(name: str, device="cuda") -> dict:
    """Part (i), in a rank: a `workload.STREAMING_SHARDED_CASES` case
    through its scan driver; rank 0 digests the gathered state and the
    telemetry."""
    from go_avalanche_tpu_torch import convert, workload
    from go_avalanche_tpu_torch.parallel import sharded_backlog as sbl
    from go_avalanche_tpu_torch.parallel import sharded_node_stream as sns
    from go_avalanche_tpu_torch.parallel import sharded_streaming_dag as ssd
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh

    dev = _rank_setup(device)
    case = workload.STREAMING_SHARDED_CASES[name]
    model = case["model"]
    drivers = {
        "backlog": (sbl.shard_backlog_state, sbl.run_scan_sharded_backlog,
                    sbl.gather_backlog_state,
                    convert.backlog_state_to_numpy),
        "streaming_dag": (ssd.shard_streaming_dag_state,
                          ssd.run_scan_sharded_streaming_dag,
                          ssd.gather_streaming_dag_state,
                          convert.streaming_dag_state_to_numpy),
        "node_stream": (sns.shard_node_stream_state,
                        sns.run_scan_sharded_node_stream,
                        sns.gather_node_stream_state,
                        convert.node_stream_state_to_numpy)}
    shard, scan, gather, to_numpy = drivers[model]
    mesh = make_mesh(*case["mesh"])
    start, cfg = workload.streaming_sharded_state(model, device=dev)
    row = _counted_run(lambda: scan(mesh, shard(start, mesh), cfg,
                                    case["rounds"]), device)
    block, tel = row.pop("out")
    whole = to_numpy(gather(block, mesh))
    out = {**row, "rounds": case["rounds"]}
    if mesh.rank == 0:
        out["leaves"] = workload.short_digests(whole)
        out["telemetry"] = workload.short_digests(workload.numpy_tree(tel))
    return out


def streaming_ranks(pool, quick: bool, device, work: str, one: dict,
                    total: dict, paths: dict) -> dict:
    """Part streaming in the gloo ranks sharing the card: (f) 1x2 against
    (f)'s 1x1 by tile digests (every leaf but the per-shard rank leaves:
    the tx-only contract as the JAX drivers show it) with the DCP pair;
    (g) and (h) on 2x1 against their 1x1 runs; (i) every
    `STREAMING_SHARDED_RECORDS` digest."""
    import os

    from go_avalanche_tpu_torch import workload

    out = {}
    rows = pool.run(2, "chip_smoke:stream_dag_rank", quick, (1, 2),
                    os.path.join(work, "dcp"), device, timeout=MESH_TIMEOUT)
    tiles = {}
    for row in rows:
        tiles.update(row.pop("tiles"))
        _check_one_launch_a_round("(f) 1x2", row["run"], "vote_u8",
                                  row["rounds"])
        _check_one_launch_a_round("(f) 1x2 resumed", row["resumed"],
                                  "vote_u8", row["resumed_rounds"])
        _add_launches(total, paths, row["run"])
        _add_launches(total, paths, row["resumed"])
    if _without_ranks(tiles) != _without_ranks(one["tiles"]):
        raise AssertionError("(f) 1x2 is not leaf-equal to 1x1 (rank "
                             "leaves aside)")
    out["streaming_dag"] = {
        "mesh": [1, 2], "block": rows[0]["block"],
        "rounds": rows[0]["rounds"],
        "ms_per_round": max(r["ms_per_round"] for r in rows),
        "host_staged": sum(r["run"]["host_staged"] for r in rows),
        "dcp_save_s": max(r["dcp_save_s"] for r in rows),
        "dcp_restore_s": max(r["dcp_restore_s"] for r in rows),
        "dcp_bytes": rows[0]["dcp_bytes"],
        "rank_peak_gib": [r["peak_gib"] for r in rows]}

    rows = pool.run(2, "chip_smoke:stream_backlog_rank", quick, (2, 1),
                    device, timeout=MESH_TIMEOUT)
    for row in rows:
        _add_launches(total, paths, row)
        _check_one_launch_a_round("(g) 2x1", row, "vote_u8", row["rounds"])
        if (row["outputs"] != one["backlog_outputs"]
                or row["rounds"] != one["backlog_rounds"]):
            raise AssertionError("(g) 2x1: outputs or rounds differ from "
                                 "the 1x1 run's")
    out["backlog"] = {"mesh": [2, 1], "block": rows[0]["block"],
                      "rounds": rows[0]["rounds"],
                      "ms_per_round": max(r["ms_per_round"] for r in rows),
                      "host_staged": sum(r["host_staged"] for r in rows),
                      "rank_peak_gib": [r["peak_gib"] for r in rows]}

    rows = pool.run(2, "chip_smoke:stream_node_rank", quick, (2, 1), device,
                    timeout=MESH_TIMEOUT)
    for row in rows:
        _add_launches(total, paths, row)
        _check_one_launch_a_round("(h) 2x1", row, "vote_u8", row["rounds"])
        if row["working_set"] != one["working_set"]:
            raise AssertionError("(h) 2x1: the working set differs from "
                                 "the dense run_scan's")
    out["node_stream"] = {"mesh": [2, 1], "block": rows[0]["block"],
                          "rounds": rows[0]["rounds"],
                          "ms_per_round": max(r["ms_per_round"]
                                              for r in rows),
                          "host_staged": sum(r["host_staged"] for r in rows),
                          "rank_peak_gib": [r["peak_gib"] for r in rows]}

    records = []
    for name, case in workload.STREAMING_SHARDED_CASES.items():
        rows = pool.run(case["mesh"][0] * case["mesh"][1],
                        "chip_smoke:stream_record_rank", name, device,
                        timeout=MESH_TIMEOUT)
        want = workload.STREAMING_SHARDED_RECORDS[name]
        for key in ("leaves", "telemetry"):
            if rows[0][key] != want[key]:
                bad = sorted(k for k in want[key]
                             if rows[0][key].get(k) != want[key][k])
                raise AssertionError(f"(i) {name}: {key} {bad} differ "
                                     f"from the JAX package's record")
        for row in rows:
            _add_launches(total, paths, row)
        records.append({"case": name, "mesh": list(case["mesh"]),
                        "rounds": case["rounds"],
                        "wall_s": max(r["wall_s"] for r in rows),
                        "leaves_checked": len(want["leaves"]),
                        "telemetry_checked": len(want["telemetry"])})
    out["records"] = records
    return out


def run_mesh(quick: bool = False, device="cuda") -> dict:
    """Phase 13: the sharded drivers (`parallel/`), module docstring."""
    import os
    import subprocess
    import tempfile

    import torch
    import torch.distributed as dist

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.parallel import runtime, sharded
    from go_avalanche_tpu_torch.parallel.mesh import make_mesh
    from go_avalanche_tpu_torch.parallel.ranks import RankPool

    shape = MESH_SHAPES["quick" if quick else "full"]
    n, t, rounds = shape["nodes"], shape["txs"], shape["rounds"]
    total = dict.fromkeys(read_launches(), 0)
    paths = {k: {"fast": 0, "any": 0} for k in read_path_launches()}
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t_phase = time.perf_counter()

    # (e), started first so that it overlaps the rest: two processes of
    # the distributed smoke, gloo ranks sharing the card.
    smoke = [subprocess.Popen(
        [sys.executable, "-m", "go_avalanche_tpu_torch.parallel."
         "distributed_smoke", "--init-method",
         f"file://{os.path.join(work, 'smoke')}", "--world-size", "2",
         "--rank", str(r), "--device", torch.device(device).type,
         "--backend", "gloo"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]

    # (a) a 1x1 mesh in this process, world 1 (NCCL on the card).
    runtime.initialize_runtime(f"file://{os.path.join(work, 'world1')}",
                               world_size=1, rank=0, device=device)
    mesh = make_mesh(1, 1)
    start, cfg = workload.mesh_flagship_state(n, t, device=device)
    cfgs = {"vote_u8": cfg,
            "vote_swar": dataclasses.replace(cfg, ingest_engine="swar32")}
    part_a, finals = {}, {}
    for name, c in cfgs.items():
        sharded.run_scan_sharded(mesh, start, c, 1)    # warm-up, untimed
        row = _mesh_scan(mesh, sharded.shard_state(start, mesh), c, rounds,
                         device, digests=False)
        if row["launches"][name] != rounds or sum(
                row["launches"].values()) != rounds:
            raise AssertionError(f"(a) {name}: launches {row['launches']} "
                                 f"!= one a round over {rounds}")
        _add_launches(total, paths, row)
        finals[name] = row
        part_a[name] = {k: v for k, v in row.items()
                        if k not in ("tiles", "final")}
    assert_states_equal(finals["vote_u8"].pop("final"),
                        finals["vote_swar"].pop("final"),
                        "(a) the u8 and swar32 meshes")
    if finals["vote_u8"]["telemetry"] != finals["vote_swar"]["telemetry"]:
        raise AssertionError("(a): the u8 and swar32 telemetry differ")
    state = av.round_step(start, cfg)[0]     # warm-up, untimed
    reset_launches()
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        state = av.round_step(state, cfg)[0]
    _synchronize(device)
    part_a["dense_phased_u8_ms_per_round"] = (
        (time.perf_counter() - t0) * 1e3 / rounds)
    del start, state, finals
    _empty_cache(device)
    # Part streaming's 1x1 runs on the same NCCL world.
    t_stream = time.perf_counter()
    one = streaming_1x1(quick, device, total, paths)
    stream_wall = time.perf_counter() - t_stream
    dist.destroy_process_group()
    _empty_cache(device)

    pool = RankPool(MESH_RANKS, work, threads=2)
    try:
        # (b) gloo ranks sharing the card: the tx-only contract.
        contract = MESH_CONTRACT_SHAPES["quick" if quick else "full"]
        runs = {}
        part_b = []
        for mesh_shape in ((1, 1), (2, 1), (1, 2), (1, 4), (2, 2)):
            t0 = time.perf_counter()
            rows = pool.run(mesh_shape[0] * mesh_shape[1],
                            "chip_smoke:mesh_flagship_rank",
                            contract["nodes"], contract["txs"], rounds,
                            mesh_shape, "u8", device, timeout=MESH_TIMEOUT)
            tiles = {}
            for row in rows:
                tiles.update(row["tiles"])
                _add_launches(total, paths, row)
                if row["launches"]["vote_u8"] != rounds:
                    raise AssertionError(f"(b) {mesh_shape}: launches "
                                         f"{row['launches']}")
            runs[mesh_shape] = {"tiles": tiles,
                                "telemetry": rows[0]["telemetry"]}
            part_b.append({
                "mesh": list(mesh_shape), "block": rows[0]["block"],
                "ms_per_round": max(r["ms_per_round"] for r in rows),
                "host_staged": sum(r["host_staged"] for r in rows),
                "launches_by_ingest_path": rows[0]["launches_by_ingest_path"],
                "wall_s": time.perf_counter() - t0})
        for tx_only, twin in MESH_CONTRACT:
            if runs[tx_only] != runs[twin]:
                raise AssertionError(f"(b) mesh {tx_only} is not leaf-equal "
                                     f"to its twin {twin}")
        if runs[(2, 1)]["tiles"] == runs[(1, 1)]["tiles"]:
            raise AssertionError("(b) the node-sharded trajectory equals "
                                 "the 1x1 one: the shard fold is missing")

        # (c) the JAX package's records.
        part_c = []
        for name, case in workload.SHARDED_CASES.items():
            rows = pool.run(case["mesh"][0] * case["mesh"][1],
                            "chip_smoke:sharded_record_rank", name, device,
                            timeout=MESH_TIMEOUT)
            want = workload.SHARDED_RECORDS[name]
            got = rows[0]
            for key in ("rounds", "leaves", "telemetry"):
                if key in want and got[key] != want[key]:
                    raise AssertionError(f"(c) {name}: {key} differs from "
                                         f"the JAX package's record")
            if case["model"] == "dag" and got["sets_resolved_fraction"] != 1.0:
                raise AssertionError(f"(c) {name}: not every set settled")
            for row in rows:
                _add_launches(total, paths, row)
            part_c.append({"case": name, "mesh": list(case["mesh"]),
                           "rounds": got["rounds"],
                           "wall_s": max(r["wall_s"] for r in rows),
                           "leaves_checked": len(want["leaves"])})

        # (d) the fleet over a 2-rank fleet mesh.
        rows = pool.run(2, "chip_smoke:mesh_fleet_rank", (2, 1), device,
                        timeout=MESH_TIMEOUT)
        want = workload.FLEET_RECORDS["policy_grid"][0]
        for row in rows:
            if json.loads(json.dumps(row["row"])) != want:
                raise AssertionError(f"(d) fleet row {row['row']} != the "
                                     f"JAX row {want}")
            _add_launches(total, paths, row)
        part_d = {"mesh": [2, 1], "row": rows[0]["row"],
                  "wall_s": max(r["wall_s"] for r in rows)}

        # part streaming in the ranks
        t_stream = time.perf_counter()
        ranked = streaming_ranks(pool, quick, device, work, one, total,
                                 paths)
        stream_wall += time.perf_counter() - t_stream
    finally:
        pool.close()
    streaming = []
    for name in ("streaming_dag", "backlog", "node_stream"):
        streaming += [{"model": name, **one["rows"][name]},
                      {"model": name, **ranked[name]}]
    streaming.append({"records": ranked["records"],
                      "part_wall_s": stream_wall})

    # (e) the distributed smoke's two lines.
    part_e = []
    for p in smoke:
        try:
            out, err = p.communicate(timeout=MESH_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in smoke:
                q.kill()
            raise
        if p.returncode != 0:
            raise AssertionError(f"(e) distributed smoke rank failed "
                                 f"({p.returncode}):\n{err}")
        part_e.append(json.loads(out.strip().splitlines()[-1]))
    if {d["polls"] for d in part_e} != {part_e[0]["polls"]}:
        raise AssertionError(f"(e) ranks disagree: {part_e}")
    return {"flagship": part_a, "contract": part_b, "records": part_c,
            "fleet": part_d, "smoke": part_e, "streaming": streaming,
            "launches": total,
            "launches_by_ingest_path": paths,
            "wall_s": time.perf_counter() - t_phase}


# Phase 14: the resource and tracing plane on the flagship.
RESOURCE_SHAPES = {"full": (16_384, 16_384), "quick": (64, 64)}
# The flagship state's analytic footprint at 16384^2, k=8: the reference's
# `obs/resources.footprint` of `jax.eval_shape(flagship_state(16384,
# 16384, 8))` in its dtypes, and the card's (the key is int64[2] here,
# 8 bytes more).
FLAGSHIP_REFERENCE_BYTES = 2_416_230_412
FLAGSHIP_DEVICE_BYTES = FLAGSHIP_REFERENCE_BYTES + 8
RESOURCE_ENGINES = {"megakernel": dict(round_engine="megakernel"),
                    "vote_u8": dict(ingest_engine="u8"),
                    "vote_swar": dict(ingest_engine="swar32")}
RESOURCE_PHASE_ROUNDS = 3
RESOURCE_CLI_ROUNDS = 3


def resource_engine(n: int, t: int, name: str, device) -> dict:
    """Phase 14 (a)-(b) on one engine: the state's analytic footprint
    against its allocation and one round's ledger (`memory_record`,
    `check_memory`), then two replays of one round from the same state
    compared byte for byte (`determinism_audit`)."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.obs import resources
    from go_avalanche_tpu_torch.utils import tracing

    knobs = dict(RESOURCE_ENGINES[name])
    state, cfg = workload.flagship_state(
        n, t, round_engine=knobs.pop("round_engine", "phased"),
        device=device)
    cfg = dataclasses.replace(cfg, **knobs)
    fp = resources.footprint(state)
    ref = resources.footprint(state, dtypes="reference")
    if (n, t) == RESOURCE_SHAPES["full"] and (
            ref["total_bytes"], fp["total_bytes"]) != (
            FLAGSHIP_REFERENCE_BYTES, FLAGSHIP_DEVICE_BYTES):
        raise AssertionError(
            f"{name}: flagship footprint {ref['total_bytes']} / "
            f"{fp['total_bytes']} != the predicted "
            f"{FLAGSHIP_REFERENCE_BYTES} / {FLAGSHIP_DEVICE_BYTES}")

    def step(s):
        return av.round_step(s, cfg)[0]

    rec = resources.memory_record(step, state)
    failures = resources.check_memory(rec, fp["total_bytes"], what=name)
    if failures:
        raise AssertionError("; ".join(failures))
    t0 = time.perf_counter()
    audit = tracing.determinism_audit(step, state)
    audit_s = time.perf_counter() - t0
    if not audit["deterministic"]:
        raise AssertionError(f"{name}: two replays of one round differ "
                             f"at {audit['mismatches']}")
    top = sorted(fp["planes"].items(), key=lambda kv: -kv[1])[:5]
    return {"engine": name, "device_bytes": fp["total_bytes"],
            "reference_bytes": ref["total_bytes"], **rec,
            "temp_gib": rec["temp_bytes"] / 2**30,
            "top_planes": dict(top), "check_memory": "clean",
            "deterministic": True, "audit_s": audit_s}


def resource_phase_times(n: int, t: int, device) -> dict:
    """Phase 14 (c): `collect_phase_times` over phased-u8 rounds: wall
    ms per span, each span's boundary waiting for the card.  The flat
    round's children lie within its `round` span, and that within the
    rounds' wall."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.utils import tracing

    state, cfg = workload.flagship_state(n, t, device=device)
    state = av.round_step(state, cfg)[0]            # warm
    _synchronize(device)
    t0 = time.perf_counter()
    with tracing.collect_phase_times() as spans:
        for _ in range(RESOURCE_PHASE_ROUNDS):
            state = av.round_step(state, cfg)[0]
    wall_ms = (time.perf_counter() - t0) * 1e3 / RESOURCE_PHASE_ROUNDS
    span_ms = {k: v * 1e3 / RESOURCE_PHASE_ROUNDS for k, v in spans.items()}
    children = {"key_split", "finality", "poll_mask", "sample_peers",
                "responses", "gather_prefs", "ingest_votes", "telemetry"}
    if set(span_ms) != {"round"} | children:
        raise AssertionError(f"phase spans {sorted(span_ms)} != "
                             f"{sorted({'round'} | children)}")
    children_ms = sum(span_ms[name] for name in children)
    if not children_ms <= span_ms["round"] <= wall_ms:
        raise AssertionError(f"the round's children {children_ms} ms, its "
                             f"span {span_ms['round']} ms and the rounds' "
                             f"wall {wall_ms} ms do not nest")
    return {"rounds": RESOURCE_PHASE_ROUNDS, "span_ms": span_ms,
            "spans_sum_ms": children_ms,
            "round_wall_ms": wall_ms}


def resource_report_memory(n: int, t: int, device) -> dict:
    """Phase 14 (e): `run_sim --report-memory` at the flagship's width:
    the report on stderr, the stdout result equal to the same run's
    without the flag."""
    import contextlib
    import io

    from go_avalanche_tpu_torch import run_sim

    argv = ["--model", "avalanche", "--nodes", str(n), "--txs", str(t),
            "--k", "8", "--no-gossip", "--max-element-poll",
            str(max(4096, t)), "--finalization-score", "32766",
            "--max-rounds", str(RESOURCE_CLI_ROUNDS), "--json",
            "--device", str(device)]
    outputs = {}
    for flag in ((), ("--report-memory",)):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = run_sim.main(argv + list(flag))
        if json.loads(out.getvalue().strip().splitlines()[-1]) != result:
            raise AssertionError("run_sim: the JSON line is not the "
                                 "result dict")
        outputs[flag] = (_without_wall(result), err.getvalue())
    (plain, plain_err), (reported, report) = outputs.values()
    if reported != plain or plain_err:
        raise AssertionError(f"--report-memory changed the run: {reported} "
                             f"!= {plain} (stderr {plain_err!r})")
    lines = report.splitlines()
    ledger = torch_device_type(device) == "cuda"   # none on the CPU
    if (not lines or not lines[0].startswith("memory report [avalanche")
            or ledger != ("  check_memory: clean" in lines)):
        raise AssertionError(f"--report-memory wrote {report!r}")
    return {"result": reported, "report": lines}


def run_resources(quick: bool = False, device="cuda") -> dict:
    """Phase 14: the resource and tracing plane on the flagship.  Launch
    counts are reset just before and read just after."""
    n, t = RESOURCE_SHAPES["quick" if quick else "full"]
    _synchronize(device)
    t0 = time.perf_counter()
    reset_launches()
    engines = []
    for name in RESOURCE_ENGINES:
        engines.append(resource_engine(n, t, name, device))
        _empty_cache(device)
    spans = resource_phase_times(n, t, device)
    _empty_cache(device)
    cli = resource_report_memory(n, t, device)
    _synchronize(device)
    launches = read_launches()
    # (a) one round and (b) two replays a engine; (c) a warm round and
    # the timed rounds; (e) both runs, and the report's ledger round
    # (on the card only).
    want = {"megakernel": 3, "vote_swar": 3,
            "vote_u8": 3 + 1 + RESOURCE_PHASE_ROUNDS
            + 2 * RESOURCE_CLI_ROUNDS
            + (torch_device_type(device) == "cuda")}
    if launches != want:
        raise AssertionError(f"phase 14 launches {launches} != {want}")
    _empty_cache(device)
    return {"engines": engines, "spans": spans, "cli": cli,
            "launches": launches, "wall_s": time.perf_counter() - t0}


# Phase 15: the fleet scan on the card sized by the knee table, the
# contract audit of the programs, the sharded drivers' ledgers, the
# analysis CLI.
AUDIT_SHAPES = {"full": (16_384, 16_384), "quick": (64, 64)}
AUDIT_QUICK_FLEET = 2        # the CPU rehearsal validates F, never picks
AUDIT_FLEET_ROUNDS = 2
AUDIT_REFUSED_FLEET = 64     # refused at 16384² with its row cited
AUDIT_ENGINES = ("flagship_megakernel", "flagship", "flagship_swar32")
AUDIT_CLI_TIMEOUT = 300


def _allocated(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.memory_allocated(device)


def _peak(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def _reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def audit_fleet(n: int, t: int, work: str, quick: bool,
                device="cuda") -> dict:
    """Phase 15 (a): `--fleet-shape auto`'s pick at n x t on the card's
    knee table (`obs/knee.py`), the stacked trials built in place
    (`workload.fleet_flagship_state`) and scanned by
    `sharded_fleet.fleet_scan_program` on a 1x1 NCCL mesh; launches,
    the measured peak against the row's modelled peak, `check_memory`
    on the stack, and the first and last trial against the dense
    flagship round from their own keys."""
    import os

    import torch
    import torch.distributed as dist

    from go_avalanche_tpu_torch import prng, workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.obs import knee, resources
    from go_avalanche_tpu_torch.parallel import runtime, sharded_fleet

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    profile = knee.PLATFORM_PROFILES[dev.type]
    tables = {profile: knee.knee_table(profile)}
    total = tables[profile]["hbm_bytes"]
    sel = knee.select_fleet_shape(dev.type, 1, n, t, tables=tables,
                                  fleet=AUDIT_QUICK_FLEET if quick
                                  else None)
    f, row = sel["fleet"], sel["row"]
    refused = None
    try:
        knee.select_fleet_shape(dev.type, 1, n, t,
                                fleet=AUDIT_REFUSED_FLEET, tables=tables)
    except ValueError as e:
        refused = str(e)
    cited = f"caps the {AUDIT_REFUSED_FLEET} trials/chip row"
    if not quick and (refused is None or cited not in refused):
        raise AssertionError(f"(a) --fleet {AUDIT_REFUSED_FLEET} at "
                             f"{n}x{t} was not refused citing its row: "
                             f"{refused!r}")
    # A world of one of its own: `runtime.initialize_runtime` brings a
    # group up once a process, and phase 13's is gone.
    dist.init_process_group(runtime.select_backend(device, 1),
                            init_method=f"file://{os.path.join(work, 'f1')}",
                            world_size=1, rank=0)
    try:
        mesh = sharded_fleet.make_fleet_mesh(1, 1)
        _synchronize(device)
        base = _allocated(device)
        _reset_peak(device)
        t0 = time.perf_counter()
        stack, cfg = workload.fleet_flagship_state(f, n, t, device=dev)
        _synchronize(device)
        build_s = time.perf_counter() - t0
        build_peak = _peak(device) - base
        block = sharded_fleet.shard_fleet_state(stack, mesh)
        del stack
        state_bytes = resources.footprint(block)["total_bytes"]
        _reset_peak(device)
        reset_launches()
        _synchronize(device)
        t0 = time.perf_counter()
        sharded_fleet.fleet_scan_program(mesh, cfg, AUDIT_FLEET_ROUNDS)(block)
        _synchronize(device)
        scan_s = time.perf_counter() - t0
        measured = _peak(device) - base
        launches, paths = read_launches(), read_path_launches()
        want = {"megakernel": 0, "vote_swar": 0,
                "vote_u8": AUDIT_FLEET_ROUNDS * f if cuda else 0}
        if launches != want:
            raise AssertionError(f"(a) fleet scan launches {launches} != "
                                 f"{want}")
        if paths["vote_u8"] != {"fast": want["vote_u8"], "any": 0}:
            raise AssertionError(f"(a) fleet scan launches by path "
                                 f"{paths['vote_u8']} are not all on "
                                 f"the fast path")
        modeled = row["modeled_live_peak_bytes"]
        slack = resources.allocator_slack(block)
        if cuda and not (measured <= modeled + slack
                         and modeled <= knee.HEADROOM * total):
            raise AssertionError(
                f"(a) fleet {f} at {n}x{t}: measured peak {measured} B, "
                f"modelled {modeled} B (+ {slack} B of allocator "
                f"rounding), budget {knee.HEADROOM * total:.0f} B — not "
                f"measured <= modelled <= budget")
        rounds = AUDIT_FLEET_ROUNDS
        record = None
        if cuda:
            record = resources.memory_record(
                sharded_fleet.fleet_scan_program(mesh, cfg, 1), block)
            fails = resources.check_memory(record, state_bytes,
                                           what="(a) fleet scan")
            if fails:
                raise AssertionError("; ".join(fails))
            rounds += 1
        scan_launches = read_launches()
        keys = prng.split(prng.key(0, dev), f)
        for i in sorted({0, f - 1}):
            dense = av.init(keys[i], n, t, cfg, device=dev)
            for _ in range(rounds):
                dense = av.round_step(dense, cfg)[0]
            assert_states_equal(sharded_fleet.trial(block, i), dense,
                                f"(a) trial {i} against its dense run")
            del dense
    finally:
        dist.destroy_process_group()
    del block
    _empty_cache(device)
    return {"fleet": f, "profile": profile, "row": row,
            "total_memory_bytes": total, "state_bytes": state_bytes,
            "modeled_peak_bytes": modeled, "measured_peak_bytes": measured,
            "allocator_slack_bytes": slack,
            "build_peak_bytes": build_peak, "build_s": build_s,
            "scan_ms_per_trial_round": scan_s * 1e3
            / (AUDIT_FLEET_ROUNDS * f),
            "refused": refused, "record": record,
            "launches": scan_launches}


def audit_programs(n: int, t: int, device="cuda") -> dict:
    """Phase 15 (b): `analysis.audit.audit_all_pinned` at the audit
    shapes, then the three flagship engines at n x t, each clean, each
    engine's kernel launched exactly once in its round, no host sync
    outside `sync.py`; each engine's op histogram."""
    import torch

    from go_avalanche_tpu_torch.analysis import audit, drift

    dev = torch.device(device)
    reset_launches()
    t0 = time.perf_counter()
    failures = audit.audit_all_pinned(dev)
    if failures:
        raise AssertionError("(b) audit_all_pinned:\n  "
                             + "\n  ".join(failures))
    small_s = time.perf_counter() - t0
    rows = []
    for name in AUDIT_ENGINES:
        program = audit.pinned_program(
            name, dict(audit.PROGRAMS[name], nodes=n, txs=t), dev)
        failures, rec = audit.audit(program)
        if failures:
            raise AssertionError(f"(b) {name} at {n}x{t}:\n  "
                                 + "\n  ".join(failures))
        if dev.type == "cuda" and rec.kernels != program.kernels:
            raise AssertionError(f"(b) {name}: launches {rec.kernels} "
                                 f"!= {program.kernels} in one round")
        rows.append({"program": name, "nodes": n, "txs": t,
                     "kernels": rec.kernels, "host_reads": rec.reads,
                     "syncs_outside_sync_py": len(rec.debug_syncs) + len(
                         [o for o, sc in rec.syncs if "sync" not in sc]),
                     "histogram": drift.histogram(rec.ops, rec.kernels)})
        del program, rec
        _empty_cache(device)
    return {"pinned_programs": len(audit.PROGRAMS), "small_s": small_s,
            "engines": rows, "launches": read_launches(),
            "wall_s": time.perf_counter() - t0}


def audit_records_rank(device="cuda") -> dict:
    """Phase 15 (c), in a rank of 4 sharing the card: one round of each
    sharded driver's audit case on the 2x2 mesh, its ledger beside the
    analytic per-rank footprint (`obs/resources.sharded_driver_records`)."""
    from go_avalanche_tpu_torch.obs import resources

    dev = _rank_setup(device)
    reset_launches()
    out = {}
    for name, r in resources.sharded_driver_records(device=dev).items():
        fp = r["footprint"]["total_bytes"]
        rec = r["record"]
        tol = max(int(0.02 * fp), 4096)
        # the live check's tolerance: every leaf's 512-byte rounding
        slack = max(4096, 512 * len(r["footprint"]["planes"]))
        out[name] = {"argument_bytes": rec["argument_bytes"],
                     "footprint_bytes": fp, "tolerance": tol,
                     "temp_bytes": rec["temp_bytes"],
                     "live_bytes": rec["live_bytes"],
                     "check_memory": resources.check_memory(
                         rec, fp, abs_tol=slack),
                     "ops": sum(r["histogram"].values())}
    return {"drivers": out, "launches": read_launches(),
            "launches_by_ingest_path": read_path_launches()}


def run_audit(quick: bool = False, device="cuda") -> dict:
    """Phase 15: (a) the fleet, (b) the audited programs, (c) the
    sharded ledgers, (d) `python -m go_avalanche_tpu_torch.analysis all`
    on the device, started first so that it overlaps the rest."""
    import os
    import subprocess
    import tempfile

    import torch

    from go_avalanche_tpu_torch.parallel.ranks import RankPool

    n, t = AUDIT_SHAPES["quick" if quick else "full"]
    work = tempfile.mkdtemp(prefix="chip_smoke_audit_")
    t_phase = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "go_avalanche_tpu_torch.analysis", "all",
         "--device", torch.device(device).type], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        fleet = audit_fleet(n, t, work, quick, device)
        fleet["wall_s"] = time.perf_counter() - t0
        programs = audit_programs(n, t, device)
        total = {k: fleet["launches"][k] + programs["launches"][k]
                 for k in fleet["launches"]}
        records = []
        if torch.device(device).type == "cuda":
            t0 = time.perf_counter()
            pool = RankPool(MESH_RANKS, work, threads=2)
            try:
                ranks = pool.run(MESH_RANKS, audit_records_rank, device,
                                 timeout=MESH_TIMEOUT)
            finally:
                pool.close()
            for r, got in enumerate(ranks):
                for name, row in got["drivers"].items():
                    if abs(row["argument_bytes"] - row["footprint_bytes"]) \
                            > row["tolerance"]:
                        raise AssertionError(
                            f"(c) rank {r} {name}: argument bytes "
                            f"{row['argument_bytes']} != per-rank "
                            f"footprint {row['footprint_bytes']} (tol "
                            f"{row['tolerance']})")
                    records.append({"rank": r, "driver": name, **row})
                for k, v in got["launches"].items():
                    total[k] += v
            records_s = time.perf_counter() - t0
        else:
            records_s = 0.0   # the ledger is the card's
        out, err = cli.communicate(timeout=AUDIT_CLI_TIMEOUT)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    if cli.returncode != 0 or "ok: contract audit + lint clean" not in out:
        raise AssertionError(f"(d) analysis all exited {cli.returncode}:"
                             f"\n{out}\n{err[-4000:]}")
    return {"fleet": fleet, "programs": programs, "records": records,
            "records_s": records_s, "cli": out.strip(),
            "launches": total, "wall_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------- phase 16

# (a): the recorded cells (`examples/recorded.CELLS`), the quorum-dial
# safety cell on its first seed; the quick rehearsal runs one.
# The recorded cell that launches no kernel: `skip_absent_votes` ingests
# through the plain engines on every device, by the reference's design.
EXAMPLE_NO_KERNEL_CELLS = ("churn_skip",)
EXAMPLE_QUICK_CELLS = ("oppose",)
# (b): each twin's `main` at a small shape, the same argv on both devices;
# "{out}" is a scratch directory of the run's device.  The studies whose
# grids are module constants (as in their JAX scripts) run with the
# constants of EXAMPLE_GRIDS set for the call.
EXAMPLE_CLIS = {
    "equivocation_threshold": [
        "--nodes", "16", "--txs", "8", "--rounds", "20",
        "--json-out", "{out}/eq.json"],
    "quorum_dial": [
        "--nodes", "16", "--txs", "8", "--rounds", "20", "--n-seeds", "1",
        "--json-out", "{out}/qd.json"],
    "oppose_scaling": [
        "--rounds", "30", "--seeds", "1", "--json-out", "{out}/op.json"],
    "churn_tolerance": [
        "--nodes", "32", "--txs", "8", "--rounds", "20", "--n-seeds", "1",
        "--json-out", "{out}/churn.json"],
    "retire_cap_tradeoff": ["--json-out", "{out}/rc.json"],
    "adversary_atlas": [
        "--quick", "--nodes", "16", "--fleet", "2", "--rounds", "20",
        "--finalization-score", "8", "--json-out", "{out}/atlas.json"],
    "finality_curves": [
        "--sizes", "16,24,32", "--txs", "8", "--byzantine", "0.0",
        "--max-rounds", "60", "--json", "--json-out", "{out}/fit.json"],
    "basic_preconsensus": ["--nodes", "16", "--txs", "8", "--logging"],
    "family_curves": [
        "--nodes", "16", "--byzantine", "0.1", "--seeds", "1",
        "--max-rounds", "60", "--beta", "10", "--json"],
    "window_scaling": [
        "--nodes", "16", "--windows", "8", "--fill", "2",
        "--json-out", "{out}/ws.json"],
    "capacity_planning": [
        "--rates", "4", "--nodes", "16", "--slots", "8", "--txs", "32",
        "--out", "{out}/cp.json"],
    "fault_scenarios": [
        "eclipse", "--nodes", "16", "--txs", "8", "--json"],
    "committee_scaling": [
        "--sizes", "16", "--fleet", "2", "--rounds", "30", "--txs", "4",
        "--clusters", "2", "--json"],
}
EXAMPLE_GRIDS = {
    "equivocation_threshold": dict(EPS_GRID=(0.1,), P_GRID=(0.5, 1.0)),
    "quorum_dial": dict(QUORUM_GRID=(7,), EPS_GRID=(0.1,),
                        WINDOW_PAIRS=((4, 3),)),
    "oppose_scaling": dict(N_GRID=(32,)),
    "churn_tolerance": dict(CHURN_GRID=(0.1,), DROP_GRID=(0.1,)),
    "retire_cap_tradeoff": dict(NODES=8, BACKLOG_SETS=24, WINDOW_SETS=6,
                                CAPS=(None, 2)),
}
# The one study whose rounds launch no kernel: its scenarios run the
# async ring, plain PyTorch by the reference's design.
EXAMPLE_NO_KERNEL = ("fault_scenarios",)
EXAMPLE_TIMEOUT = 300      # seconds a spawned part of phase 16 may take
EXAMPLE_UNCOMPARED = ("backend", "card", "elapsed_s", "seconds", "wall_s",
                      "txs_per_sec", "votes_per_sec")


def _uncompared_out(obj):
    """A twin's result without its times, rates, device and card."""
    if isinstance(obj, dict):
        return {k: _uncompared_out(v) for k, v in obj.items()
                if k not in EXAMPLE_UNCOMPARED}
    if isinstance(obj, list):
        return [_uncompared_out(v) for v in obj]
    return obj


def run_example_main(study: str, device, work: str) -> dict:
    """One twin's `main` on `device` with phase 16 (b)'s argv and grids,
    its printing kept off the script's output: the result, the launches
    per kernel and `vote_u8`'s by path, and the seconds."""
    import contextlib
    import importlib
    import io
    import os

    import torch

    module = importlib.import_module(f"go_avalanche_tpu_torch.examples."
                                     f"{study}")
    out = os.path.join(work, torch.device(device).type)
    os.makedirs(out, exist_ok=True)
    argv = [a.replace("{out}", out) for a in EXAMPLE_CLIS[study]]
    grids = EXAMPLE_GRIDS.get(study, {})
    saved = {name: getattr(module, name) for name in grids}
    for name, value in grids.items():
        setattr(module, name, value)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = module.main(argv
                                 + ["--device", torch.device(device).type])
        _synchronize(device)
    finally:
        for name, value in saved.items():
            setattr(module, name, value)
    return {"study": study, "result": result,
            "seconds": time.perf_counter() - t0,
            "launches": read_launches(),
            "vote_u8_by_path": read_path_launches()["vote_u8"]}


def example_cell(name: str, device) -> dict:
    """Phase 16 (a), in a process of its own: one recorded cell with the
    launches it made."""
    from go_avalanche_tpu_torch.examples import recorded

    reset_launches()
    row = recorded.replay(name, device, n_seeds=1)
    return {**row, "launches": read_launches(),
            "vote_u8_by_path": read_path_launches()["vote_u8"]}


def example_mains(device, work: str) -> list:
    """Phase 16 (b) on one device: every twin's `main`, one after
    another."""
    return [run_example_main(study, device, work) for study in EXAMPLE_CLIS]


def run_examples(quick: bool = False, device="cuda") -> dict:
    """Phase 16: (a) the recorded cells on `device` at their recorded
    shapes against `examples/out/`, (b) every twin's `main` on `device`
    against the same argv on the CPU.  On the card, each recorded cell
    runs in a spawned process of its own and the CPU side of (b) in one
    more, all started first, while this process runs (b) on the card:
    the cells are host-bound (a DAG round under EQUIVOCATE launches
    thousands of small operators), so one after another they would
    take ~2 minutes.
    Returns each part's rows, the phase's launches on `device` per
    kernel and `vote_u8`'s by path."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    import torch

    from go_avalanche_tpu_torch.examples import recorded

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    names = EXAMPLE_QUICK_CELLS if quick else recorded.CELLS
    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    if on_card:
        pool = concurrent.futures.ProcessPoolExecutor(
            len(names) + 1, mp_context=multiprocessing.get_context("spawn"))
        try:
            cell_futures = [pool.submit(example_cell, n, device)
                            for n in names]
            cpu_future = pool.submit(example_mains, "cpu", work)
            card_runs = example_mains(device, work)
            cells = [f.result(timeout=EXAMPLE_TIMEOUT)
                     for f in cell_futures]
            cpu_runs = cpu_future.result(timeout=EXAMPLE_TIMEOUT)
        finally:
            pool.shutdown(cancel_futures=True)
    else:
        cells = [example_cell(n, device) for n in names]
        card_runs = example_mains(device, work)
        cpu_runs = example_mains("cpu", work)

    total = dict.fromkeys(KERNEL_ROWS, 0)
    paths = {"fast": 0, "any": 0}

    def add(row: dict) -> None:
        for k, v in row["launches"].items():
            total[k] += v
        for k, v in row["vote_u8_by_path"].items():
            paths[k] += v

    for row in cells:
        if row["got"] != row["want"]:
            raise AssertionError(f"(a) {row['cell']}: {row['got']} != the "
                                 f"recorded {row['want']}")
        if on_card:
            if row["cell"] in EXAMPLE_NO_KERNEL_CELLS:
                if any(row["launches"].values()):
                    raise AssertionError(f"(a) {row['cell']} launched "
                                         f"{row['launches']}; its ingest "
                                         f"has no kernel")
            elif row["launches"]["vote_u8"] == 0:
                raise AssertionError(f"(a) {row['cell']} never launched "
                                     f"vote_u8")
        add(row)
    clis = []
    for got, want in zip(card_runs, cpu_runs):
        study = got["study"]
        if _uncompared_out(got["result"]) != _uncompared_out(want["result"]):
            raise AssertionError(f"(b) {study}: {device} result != the "
                                 f"CPU's:\n{got['result']}\n"
                                 f"{want['result']}")
        if any(want["launches"].values()):
            raise AssertionError(f"(b) {study} launched {want['launches']} "
                                 f"on the CPU")
        if on_card:
            if study in EXAMPLE_NO_KERNEL:
                if any(got["launches"].values()):
                    raise AssertionError(f"(b) {study} launched "
                                         f"{got['launches']}; its async "
                                         f"rounds have no kernel")
            elif got["launches"]["vote_u8"] == 0:
                raise AssertionError(f"(b) {study} never launched vote_u8")
        add(got)
        clis.append({"study": study, "seconds": got["seconds"],
                     "cpu_seconds": want["seconds"],
                     "launches": got["launches"],
                     "vote_u8_by_path": got["vote_u8_by_path"]})
    return {"cells": cells, "clis": clis, "launches": total,
            "launches_by_ingest_path": paths,
            "wall_s": time.perf_counter() - t_phase}


def _empty_cache(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------ phases 7-14: lanes

# Phases 7-14 are bound by the host: their rounds launch hundreds of
# small operators each, and the card waits between them (PERF.md §5).
# One after another they took 773 s of the script's 910.0 (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md §6), and a slower host pushed the whole
# script past its 1200 s limit.  So they run in three lanes at once,
# each lane its phases one after another: the first lane in this
# process, the others each in a spawned process.  Every phase keeps its
# shapes and gates; each lane counts its own launches and memory.
# Phase 8 is split in two (config 5's 2 x 4165 rounds, then the rest).
# The lanes are chosen so that their memory peaks fit the card together
# (~28 GiB phases 9 and 10, one after the other in one lane; ~12-14 GiB
# config 6 and the mesh; under 1 GiB config 5) and that the two phases
# with processes of their own (9's CPU replays, 13's ranks) are in
# different lanes.  Phases 15 (~26 GiB) and 16 follow, alone.
LANE_PHASES = {           # name -> (function, keyword arguments)
    "baselines": (run_baselines, {}),
    "streaming_config5": (run_streaming, {"parts": ("config5",)}),
    "streaming": (run_streaming, {"parts": STREAM_PARTS[1:]}),
    "async": (run_async, {}),
    "adversary": (run_adversary, {}),
    "obs": (run_obs, {}),
    "host": (run_host, {}),
    "mesh": (run_mesh, {}),
    "resources": (run_resources, {}),
}
LANES = (("streaming_config5", "obs", "host"),          # this process
         ("async", "adversary"),
         ("baselines", "streaming", "resources", "mesh"))
LANE_TIMEOUT = 900        # seconds a lane may take
LANE_THREADS = 2          # torch threads in a spawned lane


def run_lane(names, quick: bool = False, device="cuda") -> dict:
    """The phases `names` of `LANE_PHASES`, one after another: each
    phase's result and seconds."""
    out = {}
    for name in names:
        fn, kwargs = LANE_PHASES[name]
        t0 = time.perf_counter()
        result = fn(quick=quick, device=device, **kwargs)
        _empty_cache(device)
        out[name] = (result, time.perf_counter() - t0)
    return out


def _lane_main(names, quick: bool, device, conn) -> None:
    """A spawned lane: loads the kernels phase 2 built (so that no phase
    counts a first load), runs its phases and sends ``(True, results)``
    or ``(False, traceback)``.  SIGTERM exits through the phases'
    `finally` blocks, which stop their own processes."""
    import signal
    import traceback

    import torch

    from go_avalanche_tpu_torch import _build

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        torch.set_num_threads(LANE_THREADS)
        if torch.device(device).type == "cuda":
            for name in SOURCES:
                _build.load(name)
        sent = (True, run_lane(names, quick, device))
    except BaseException:
        sent = (False, traceback.format_exc())
    conn.send(sent)
    conn.close()


class Lane:
    """`names` run by `_lane_main` in a spawned process; `result()`
    waits for them, `stop()` ends the process if it still runs."""

    def __init__(self, names, quick: bool = False, device="cuda"):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.names = names
        self.deadline = time.monotonic() + LANE_TIMEOUT
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_lane_main,
                                args=(names, quick, device, child))
        self.proc.start()
        child.close()

    def result(self) -> dict:
        wait = max(0.0, self.deadline - time.monotonic())
        if not self.conn.poll(wait):
            raise TimeoutError(f"lane {self.names} did not end within "
                               f"{LANE_TIMEOUT} s")
        try:
            ok, out = self.conn.recv()
        except EOFError:
            self.proc.join(30)
            raise RuntimeError(f"lane {self.names} exited with code "
                               f"{self.proc.exitcode} and no result"
                               ) from None
        self.proc.join(30)
        if not ok:
            raise RuntimeError(f"lane {self.names} failed:\n{out}")
        return out

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()


def run_lanes(lanes=LANES, quick: bool = False, device="cuda") -> dict:
    """Every lane at once, the first in this process: each phase's
    result and seconds, and the lanes' wall seconds under "lanes"."""
    t0 = time.perf_counter()
    spawned = [Lane(names, quick, device) for names in lanes[1:]]
    try:
        out = run_lane(lanes[0], quick, device)
        for lane in spawned:
            out.update(lane.result())
    finally:
        for lane in spawned:
            lane.stop()
    out["lanes"] = (None, time.perf_counter() - t0)
    return out


KERNEL_ROWS = {          # name -> (source, the TPU kernel it replaces)
    "megakernel": ("go_avalanche_tpu_torch/csrc/megakernel.cu",
                   "go_avalanche_tpu/ops/megakernel.py:95"),
    "vote_u8": ("go_avalanche_tpu_torch/csrc/vote_u8.cu",
                "go_avalanche_tpu/ops/pallas_vote.py:67"),
    "vote_swar": ("go_avalanche_tpu_torch/csrc/vote_swar.cu",
                  "go_avalanche_tpu/ops/pallas_vote.py:259"),
}


# The exchange kernels, port-only (the JAX package's exchange is plain
# XLA): name -> source.
EXCHANGE_ROWS = {"prefs_pack": "go_avalanche_tpu_torch/csrc/exchange.cu",
                 "vote_packs": "go_avalanche_tpu_torch/csrc/exchange.cu"}
# The scheduler kernels, port-only (the JAX package's scheduler is plain
# XLA): name -> source.
SCHEDULER_ROWS = {"settle_scan": "go_avalanche_tpu_torch/csrc/scheduler.cu",
                  "refill": "go_avalanche_tpu_torch/csrc/scheduler.cu"}


def main() -> int:
    import torch

    from go_avalanche_tpu_torch import _build
    from go_avalanche_tpu_torch.round_profile import card_label
    from go_avalanche_tpu_torch.workload import (DAG_NODES, DAG_TXS,
                                                 FLAGSHIP_NODES, FLAGSHIP_TXS)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — the port's "
              "smoke run needs an NVIDIA GPU and does not fall back to the "
              "CPU", file=sys.stderr)
        return 2

    # 1. device
    t_script = time.perf_counter()
    seconds = {}
    clock = [t_script]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    card = card_label()
    print(card, flush=True)
    label = {"card": card, "torch": torch.__version__,
             "cuda": torch.version.cuda}
    emit({"phase": "device", **label,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(_build.build, name) for name in SOURCES}
        built = {name: f.result() for name, f in futures.items()}
    for name, b in built.items():
        emit({"phase": "build", "kernel": name, "seconds": b.seconds,
              "ptxas": [ln.strip() for ln in b.log.splitlines()
                        if "registers" in ln or "spill" in ln]})
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})
    lap("device_build")

    if "--config6-full-depth" in sys.argv[1:]:
        emit({"phase": "config6_full_depth", **run_config6_full_depth(),
              **label})
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # 3. kernels against their plain versions, the ingest kernels also at
    # the DAG path's shape (the flagship's is checked in phase 6)
    worst = {"megakernel": check_kernel_cases(),
             **check_ingest_cases(INGEST_SHAPES + ((DAG_NODES, DAG_TXS),)),
             **check_exchange_cases(EXCHANGE_CHECK_SHAPES)}
    lap("kernels")

    # 4. main path at full width
    main_path = run_main_path(FLAGSHIP_NODES, FLAGSHIP_TXS, TIMED_ROUNDS)
    emit({"phase": "main", "nodes": FLAGSHIP_NODES, "txs": FLAGSHIP_TXS,
          "k": 8, **main_path, **label})
    torch.cuda.empty_cache()
    lap("main")

    # 5. the DAG baseline to settlement
    dag_run = run_dag(DAG_NODES, DAG_TXS)
    emit({"phase": "dag", "nodes": DAG_NODES, "txs": DAG_TXS, **dag_run,
          **label})
    torch.cuda.empty_cache()
    lap("dag")

    # 6. each kernel alone at the main path's shape
    timing = {"megakernel": time_megakernel(FLAGSHIP_NODES, FLAGSHIP_TXS)}
    for name in ("vote_u8", "vote_swar"):
        timing[name] = time_ingest(name, FLAGSHIP_NODES, FLAGSHIP_TXS)
    for name, row in timing.items():
        emit({"phase": "timing", "kernel": name, "nodes": FLAGSHIP_NODES,
              "txs": FLAGSHIP_TXS, **row, **label})
    # the exchange kernels at the two benchmark cells' shapes; the kernels
    # line takes config 6's FLIP row
    for n, t in EXCHANGE_SHAPES:
        for row in time_exchange(n, t):
            emit({"phase": "timing", "nodes": n, "txs": t, **row, **label})
            worst[row["kernel"]] = max(worst[row["kernel"]],
                                       row["max_abs_err"])
            if (n, t) == EXCHANGE_SHAPES[-1] and row["case"] == "flip":
                timing[row["kernel"]] = {**row, "shape": [n, t]}
    # the scheduler kernels at config 6's window; the kernels line takes
    # the rows with finality tracked, as config 6 runs
    n, w = SCHEDULER_SHAPE
    for row in time_scheduler(n, w):
        emit({"phase": "timing", "nodes": n, "window": w, **row, **label})
        worst[row["kernel"]] = max(worst.get(row["kernel"], 0),
                                   row["max_abs_err"])
        if row["tracked"]:
            timing[row["kernel"]] = {**row, "shape": [n, w]}
    lap("timing")

    # the ingest kernels' general path alone at Snowball's [1000, 1]
    # (phase 7's timing), before the lanes load the card
    for name in ("vote_u8", "vote_swar"):
        row = time_ingest(name, 1000, 1)
        worst[name] = max(worst[name], row["max_abs_err"])
        emit({"phase": "timing", "kernel": name, "nodes": 1000, "txs": 1,
              **row, **label})
    torch.cuda.empty_cache()
    lap("timing_1000x1")

    # 7-14 in three lanes at once (LANES); each phase's seconds are its
    # own lane's
    laned = run_lanes()
    for name, (_, sec) in laned.items():
        seconds[name] = sec
    clock[0] = time.perf_counter()

    # 7. BASELINE configs 0, 1, 3 and 4
    baselines = laned["baselines"][0]
    for name, row in baselines["configs"].items():
        emit({"phase": "baselines", "config": name, **row, **label})
    emit({"phase": "baselines", "launches": baselines["launches"],
          "launches_by_ingest_path": baselines["launches_by_ingest_path"],
          **label})

    # 8. the streaming schedulers, traffic and the node registry
    streaming = [laned[k][0] for k in ("streaming_config5", "streaming")]
    for part in streaming:
        for row in part["parts"]:
            emit({"phase": "streaming", **row, **label})
    emit({"phase": "streaming",
          "launches": {k: sum(p["launches"][k] for p in streaming)
                       for k in KERNEL_ROWS},
          "scheduler_launches": {
              k: sum(p["scheduler_launches"][k] for p in streaming)
              for k in SCHEDULER_ROWS},
          "launches_by_ingest_path": {
              k: {path: sum(p["launches_by_ingest_path"][k][path]
                            for p in streaming)
                  for path in ("fast", "any")}
              for k in ("vote_u8", "vote_swar")}, **label})

    # 9. the async query ring
    for part, row in laned["async"][0].items():
        for r in (row if isinstance(row, list) else [row]):
            emit({"phase": "async", "part": part, **r, **label})

    # 10. the adaptive adversary and the Monte-Carlo fleet
    adversary = laned["adversary"][0]
    for part in ("sync", "async", "records", "fleet"):
        rows = adversary[part]["rows"]
        for r in (rows if isinstance(rows, list) else [rows]):
            emit({"phase": "adversary", "part": part, **r,
                  "part_wall_s": adversary[part]["wall_s"], **label})
    emit({"phase": "adversary", "launches": adversary["launches"],
          "launches_by_ingest_path": adversary["launches_by_ingest_path"],
          "wall_s": laned["adversary"][1], **label})

    # 11. the flight recorder; its launches stay out of the kernels line
    observed = laned["obs"][0]
    for part in ("flagship", "dag", "recovery", "fleet", "schedulers"):
        rows = observed[part]["rows"]
        for r in (rows if isinstance(rows, list) else [rows]):
            emit({"phase": "obs", "part": part, **r,
                  "part_wall_s": observed[part]["wall_s"], **label})
    emit({"phase": "obs", "launches": observed["launches"],
          "wall_s": laned["obs"][1], **label})

    # 12. the host surfaces: the CLI, a killed and resumed chunked run,
    # the Connector
    host = laned["host"][0]
    for part in ("cli", "resume", "connector"):
        for r in host[part]["rows"]:
            emit({"phase": "host", "part": part, **r,
                  "part_wall_s": host[part]["wall_s"], **label})
    emit({"phase": "host", "launches": host["launches"],
          "wall_s": laned["host"][1], **label})

    # 13. the sharded drivers on one card: NCCL world 1, gloo ranks
    # sharing it, the JAX package's records, the fleet, the smoke
    mesh = laned["mesh"][0]
    for part in ("flagship", "contract", "records", "fleet", "smoke",
                 "streaming"):
        rows = mesh[part]
        for r in (rows if isinstance(rows, list) else [rows]):
            emit({"phase": "mesh", "part": part, **r, **label})
    emit({"phase": "mesh", "launches": mesh["launches"],
          "launches_by_ingest_path": mesh["launches_by_ingest_path"],
          "wall_s": mesh["wall_s"], **label})

    # 14. the resource and tracing plane: footprints against the
    # allocator, determinism replays, phase timers, --report-memory
    resources = laned["resources"][0]
    for row in resources["engines"]:
        emit({"phase": "resources", "part": "engine", **row, **label})
    emit({"phase": "resources", "part": "spans", **resources["spans"],
          **label})
    emit({"phase": "resources", "part": "cli", **resources["cli"],
          **label})
    emit({"phase": "resources", "launches": resources["launches"],
          "timed_compiles": {"main": main_path["timed_compiles"],
                             "timing": {k: v["timed_compiles"]
                                        for k, v in timing.items()}},
          "wall_s": resources["wall_s"], **label})

    # 15. the fleet scan sized by the knee table, the contract audit,
    # the sharded ledgers, the analysis CLI
    audited = run_audit()
    fleet = {k: v for k, v in audited["fleet"].items() if k != "launches"}
    emit({"phase": "audit", "part": "fleet", **fleet, **label})
    for row in audited["programs"]["engines"]:
        emit({"phase": "audit", "part": "programs", **row, **label})
    emit({"phase": "audit", "part": "programs",
          "pinned_programs": audited["programs"]["pinned_programs"],
          "small_s": audited["programs"]["small_s"], **label})
    for row in audited["records"]:
        emit({"phase": "audit", "part": "records", **row, **label})
    emit({"phase": "audit", "part": "cli", "stdout": audited["cli"],
          **label})
    emit({"phase": "audit", "launches": audited["launches"],
          "records_s": audited["records_s"],
          "wall_s": audited["wall_s"], **label})
    torch.cuda.empty_cache()
    lap("audit")

    # 16. the protocol studies on their twins: the recorded cells, each
    # twin's main on the card against the CPU
    examples = run_examples()
    for row in examples["cells"]:
        emit({"phase": "examples", "part": "recorded", **row, **label})
    for row in examples["clis"]:
        emit({"phase": "examples", "part": "cli", **row, **label})
    emit({"phase": "examples", "launches": examples["launches"],
          "launches_by_ingest_path": examples["launches_by_ingest_path"],
          "wall_s": examples["wall_s"], **label})
    lap("examples")
    emit({"phase": "seconds", "phases": seconds,
          "total_s": time.perf_counter() - t_script, **label})

    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": (main_path["launches"][name]
                     + adversary["launches"][name]
                     + host["launches"][name]
                     + mesh["launches"][name]
                     + resources["launches"][name]
                     + audited["launches"][name]
                     + examples["launches"][name]),
        "max_abs_err": max(worst[name], timing[name]["max_abs_err"]),
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,
    } for name, (source, replaces) in KERNEL_ROWS.items()] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": None,
        "launches": (main_path["exchange_launches"][name]
                     + dag_run["exchange_launches"][name]),
        "max_abs_err": worst[name],
        "shape": timing[name]["shape"],
        "ms": timing[name]["ms"],
        "device_ms": timing[name]["device_ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,
    } for name, source in EXCHANGE_ROWS.items()] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": None,
        "launches": sum(p["scheduler_launches"][name] for p in streaming),
        "max_abs_err": worst[name],
        "shape": timing[name]["shape"],
        "ms": timing[name]["ms"],
        "device_ms": timing[name]["device_ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,
    } for name, source in SCHEDULER_ROWS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
