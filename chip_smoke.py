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
               path's 10000 x 10000, each on both its paths);
  4. main    — the flagship round (16384 nodes x 16384 txs, k=8,
               `workload.flagship_state`, the reference bench's) through
               `models.avalanche.init` / `round_step`: the megakernel,
               phased-u8 (ingest kernel 1) and phased-swar32 (kernel 2)
               trajectories leaf-equal, timed rounds, and the launch
               counts of the kernels during that run;
  5. dag     — the DAG baseline (10000 nodes x 10000 txs in 2-tx
               conflict sets, `workload.dag_baseline_state`) through
               `models.dag.run` to settlement and `run_scan`, on both
               ingest engines: leaf-equal, timed, compared with the
               reference's recorded result, launch counts;
  6. timing  — each kernel alone at the main path's shape, against its
               plain version and its bound;
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
               x a 1024-set window of 2-tx sets, 25,600 sets), both on
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
               the kernels).  Latency 0 at 16384 x 16384 on the walk,
               walk_earlyout and coalesced engines, 3 rounds leaf-equal
               to the synchronous round on phased-u8 and phased-swar32
               (which launch the two ingest kernels); the reference
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
               each against a CPU replay of the port (the DAG's replay
               cut to its first 2 rounds, the first with a delivery).  Each engine prints ms per
               round (CUDA events), peak memory and host reads;
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
               kernels line.

With ``--config6-full-depth`` it builds the kernels and runs only BASELINE
config 6 at full width and full depth (500,000 sets, ~8313 rounds,
`streaming_dag.run_chunked` on phased-u8) against the reference's
recorded result, printing progress to stderr.

The second-to-last line is the kernels summary, the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
# H100 SXM int32 rate outside the tensor cores: 132 SMs x 64 int32
# lanes x ~1.98 GHz (67e12/s is its fp32 FMA rate, not an integer one)
INT_OPS_PER_S = 1.67e13
TIMED_ROUNDS = 20
PHASED_TIMED_ROUNDS = 3
SOURCES = ("megakernel", "vote_u8", "vote_swar")
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
    from go_avalanche_tpu_torch.ops import megakernel
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    megakernel.launches = 0
    for name in pv.launches:
        pv.launches[name] = 0
        pv.path_launches[name] = {"fast": 0, "any": 0}


def read_launches() -> dict:
    from go_avalanche_tpu_torch.ops import megakernel
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    return {"megakernel": megakernel.launches, **pv.launches}


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

    def timed(name: str, warm: int, reps: int) -> float:
        def one_round():
            states[name] = av.round_step(states[name], cfgs[name])[0]
            rounds[name] += 1

        for _ in range(warm):
            one_round()
        torch.cuda.synchronize()
        return time_ms(one_round, reps)

    round_ms = timed("megakernel", 2, timed_rounds)
    phased_ms = {name: timed(name, 1, PHASED_TIMED_ROUNDS)
                 for name in ("vote_u8", "vote_swar")}
    launches = read_launches()
    if launches != rounds:
        raise AssertionError(f"launches {launches} != rounds per engine "
                             f"{rounds}")
    state = states["megakernel"]
    if int(state.round) != 3 + 2 + timed_rounds:
        raise AssertionError("round counter did not advance per round")
    if int(state.records.votes.sum()) == 0:
        raise AssertionError("no vote reached the windows")
    return {"launches": launches, "rounds": rounds,
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
    kernel_ms = time_ms(lambda: megakernel.fused_round(*args, cfg), 20)
    plain_ms = time_ms(lambda: megakernel.fused_round_reference(*args, cfg),
                       3)
    bound_ms, bound_by = megakernel_bound(n, t, cfg.k)
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    kernel_ms = time_ms(lambda: kernel(*args[:3], cfg.k, cfg, args[3]), 20)
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
            "bound_ms": bound_ms, "bound_by": bound_by}


# Phase 8's shapes.  Config 6 runs at full width (100000 nodes, a 1024-set
# window of 2-tx sets) with its backlog cut from 500,000 sets to 25,600
# (25 waves of the window; the whole backlog would take ~8313 rounds, about
# ten minutes per engine; phase 9 took the time the other 25 waves had);
# every wave settles in ceil(134 / k) = 17 rounds, so the cut run's gate is
# 25 * 17 = 425 rounds.  The retire-cap check runs 3 waves.
STREAM_SHAPES = {
    "full": dict(config6_sets=25_600, cap_sets=3072, traffic_txs=65_536,
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

    def close(self, expect: dict, totals: dict) -> dict:
        """Check the launches against the rounds each kernel's engine
        ran (`expect`: kernel -> rounds) and add them to `totals`."""
        import torch

        from go_avalanche_tpu_torch import sync

        torch.cuda.synchronize()
        launches, paths = read_launches(), read_path_launches()
        want = {"vote_u8": 0, "vote_swar": 0, "megakernel": 0, **expect}
        if launches != want:
            raise AssertionError(f"{self.name}: launches {launches} != "
                                 f"rounds per kernel {want}")
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
        return {"part": self.name, "rounds_per_engine": self.rounds,
                "ms_per_round": self.ms_per_round, "launches": launches,
                "launches_by_ingest_path": paths, "ingest_path": path,
                "host_reads": sync.reads,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_streaming(quick: bool = False, device="cuda") -> dict:
    """Phase 8: the streaming schedulers, the traffic plane and the node
    registry through their entry points on the card (module docstring);
    each part raises on any gate it misses."""
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
                          for k in ("vote_u8", "vote_swar")}}
    engines = {"u8": "vote_u8", "swar32": "vote_swar"}
    parts = []

    def phased(cfg):
        return {engine: dataclasses.replace(cfg, ingest_engine=engine)
                for engine in engines}

    # 1. config 5, whole
    start, cfg = workload.config5_state(quick, device=device)
    n5, b5, w5 = workload.config5_shape(quick)
    part = StreamPart("config5", w5)
    finals = {}
    for engine, ecfg in phased(cfg).items():
        finals[engine] = part.run(
            engine, lambda s, c: (lambda f: (f, sync.read(f.sim.round)))(
                backlog.run(s, c, max_rounds=STREAM_MAX_ROUNDS,
                            device=device)), start, ecfg)
    assert_trees_equal(finals["u8"], finals["swar32"], "config5 u8 vs swar32")
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
    sets = shape["config6_sets"]
    star = dict(workload.QUICK if quick else workload.NORTH_STAR)
    star["backlog_sets"] = sets
    start, cfg = workload.northstar_state(**star, device=device)
    w6 = star["window_sets"] * star["set_cap"]
    part = StreamPart("config6", w6)
    finals = {}
    for engine, ecfg in phased(cfg).items():
        finals[engine] = part.run(
            engine, lambda s, c: (lambda f: (f, sync.read(
                f.dag.base.round)))(sdg.run_chunked(
                    s, c, max_rounds=STREAM_MAX_ROUNDS, chunk=256,
                    device=device)), start, ecfg)
    assert_trees_equal(finals["u8"], finals["swar32"], "config6 u8 vs swar32")
    summary = sdg.resolution_summary(finals["u8"])
    waves = -(-sets // star["window_sets"])
    want = {**reference["config6"], "rounds": waves * WAVE_ROUNDS}
    result = {"nodes": star["nodes"], "window_sets": star["window_sets"],
              "set_cap": star["set_cap"], "backlog_sets": sets,
              "full_backlog_sets": (workload.QUICK if quick
                                    else workload.NORTH_STAR)["backlog_sets"],
              "depth_cut": f"backlog cut to {sets} sets ({waves} waves) to "
                           f"fit the script's time limit; width unchanged",
              "rounds": int(finals["u8"].dag.base.round), **summary}
    check_result("config6", result, want)
    parts.append({**result, "reference": want,
                  **part.close({engines[e]: r
                                for e, r in part.rounds.items()}, totals)})
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
    for name, rcfg in runs.items():
        finals[name] = part.run(
            name, lambda s, c: (lambda f: (f, sync.read(
                f.dag.base.round)))(sdg.run(
                    s, c, max_rounds=STREAM_MAX_ROUNDS, device=device)),
            start, rcfg)
    assert_trees_equal(finals["dense"], finals["retire_cap"],
                       "retire cap vs dense")
    cap_rounds = -(-shape["cap_sets"] // star["window_sets"]) * WAVE_ROUNDS
    if part.rounds["dense"] != cap_rounds:
        raise AssertionError(f"retire-cap check: {part.rounds} rounds, "
                             f"expected {cap_rounds}")
    parts.append({"backlog_sets": shape["cap_sets"],
                  "stream_retire_cap": star["window_sets"],
                  **part.close({"vote_u8": sum(part.rounds.values())},
                               totals)})
    del start, finals
    torch.cuda.empty_cache()

    # 3. live traffic at config 5's width
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
    replay = tf.init_traffic(tcfg, prng.key(0, "cpu"), shape["traffic_txs"])
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
                                 f"{int(tel.departed[r])} rows on the card,"
                                 f" {int(n_swapped)} in the CPU replay")
        replay = replay._replace(slot_node=new_slot, resident=resident,
                                 churn_key=key)
    for field in ("slot_node", "resident", "churn_key"):
        if not torch.equal(getattr(replay, field),
                           getattr(final, field).cpu()):
            raise AssertionError(f"node stream: {field} differs from the "
                                 f"CPU replay")
    parts.append({"registry_nodes": shape["registry"],
                  "active_nodes": shape["active"], "txs": shape["node_txs"],
                  "rounds": n_rounds, "departed": departed,
                  **node_stream.window_summary(final, ncfg),
                  **part.close({"vote_u8": n_rounds, "vote_swar": n_rounds,
                                "megakernel": n_rounds}, totals)})
    return {"parts": parts, "launches": totals["launches"],
            "launches_by_ingest_path": totals["by_path"]}


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
        raise AssertionError(f"{where}: the async path launched kernels "
                             f"{launches}; it has none by design")
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


def run_async_models(shape: dict, device="cuda") -> list:
    """The DAG, Snowball, backlog and node-stream models under latency,
    each held against a CPU replay of the port on the same seed."""
    import torch

    from go_avalanche_tpu_torch import prng, sync, workload
    from go_avalanche_tpu_torch.config import AvalancheConfig
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.models import backlog, dag, node_stream
    from go_avalanche_tpu_torch.models import snowball
    from go_avalanche_tpu_torch.ops import voterecord as vr

    rows = []
    cpu = torch.device("cpu")

    # 1. the DAG baseline under fixed latency 1, to settlement
    t0 = time.perf_counter()
    n, t = shape["dag"]
    finals, times = {}, {}
    reset_launches()
    for engine in ASYNC_ENGINES:
        start, cfg = workload.dag_baseline_state(
            n, t, device=device, inflight_engine=engine, **LATENCY1)
        run = AsyncRun()
        state = start
        while (int(state.base.round) < DAG_MAX_ROUNDS
               and not bool(dag.settled(state, cfg))):
            state = run.step(lambda s: dag.round_step(s, cfg)[0], state)
        times[engine] = run.close()
        finals[engine] = state
        if engine == "coalesced":
            cpu_start = av.move_leaves(start, cpu)
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
    replay, again = cpu_start, dag.to_device(cpu_start, device)
    for _ in range(k_replay):
        replay = dag.round_step(replay, cfg)[0]
        again = dag.round_step(again, cfg)[0]
    assert_trees_equal(av.move_leaves(again, cpu), replay,
                       f"dag async vs its CPU replay at round {k_replay}")
    rows.append({"model": "dag", "nodes": n, "txs": t, "latency": 1,
                 "timeout_rounds": cfg.timeout_rounds(),
                 "rounds": int(final.base.round),
                 "sets_resolved_fraction": resolved,
                 "finality_median": finality_median(final.base.finalized_at),
                 "cpu_replay_rounds": k_replay, "engines": times,
                 "launches": check_no_launches("dag async"),
                 "wall_s": time.perf_counter() - t0})
    del finals, final, again, replay, cpu_start
    torch.cuda.empty_cache()

    # 2. Snowball at config 1's width under geometric latency
    t0 = time.perf_counter()
    knobs = dict(LATENCY1, latency_mode="geometric")
    finals, times = {}, {}
    for engine in ASYNC_ENGINES:
        start, cfg = workload.config1_state(shape["snowball_quick"],
                                            device=device,
                                            inflight_engine=engine, **knobs)
        (final, ms) = timed_run(snowball.run, start, cfg, device=device)
        finals[engine] = final
        times[engine] = ms / max(int(final.round), 1)
    for engine in ASYNC_ENGINES[1:]:
        assert_trees_equal(finals["walk"], finals[engine],
                           f"snowball async {engine} vs walk")
    replay = snowball.run(snowball.to_device(start, cpu), cfg, device="cpu")
    assert_trees_equal(av.move_leaves(finals["coalesced"], cpu), replay,
                       "snowball async vs its CPU replay")
    final = finals["coalesced"]
    fin = vr.has_finalized(final.records.confidence, cfg)
    pref = vr.is_accepted(final.records.confidence)
    rows.append({"model": "snowball", "nodes": int(fin.numel()),
                 "latency_mode": "geometric", "latency_rounds": 1,
                 "rounds": int(final.round),
                 "finalized_fraction": float(fin.float().mean()),
                 "agreed_one_value": bool((pref == pref[0]).all()),
                 "cpu_replay_rounds": int(replay.round),
                 "ms_per_round": times,
                 "launches": check_no_launches("snowball async"),
                 "wall_s": time.perf_counter() - t0})

    # 3. backlog.run at config 5's width, coalesced, backlog cut
    t0 = time.perf_counter()
    n5, _, w5 = workload.config5_shape(shape["snowball_quick"])
    start, cfg = workload.config5_state(
        shape["snowball_quick"], device=device, n_txs=shape["backlog_txs"],
        inflight_engine="coalesced", **LATENCY1)
    sync.reads = 0
    final, ms = timed_run(backlog.run, start, cfg, max_rounds=STREAM_MAX_ROUNDS,
                          device=device)
    reads = sync.reads
    replay = backlog.run(av.move_leaves(start, cpu), cfg, device="cpu")
    assert_trees_equal(av.move_leaves(final, cpu), replay,
                       "backlog async vs its CPU replay")
    if not bool(final.outputs.settled.all()):
        raise AssertionError("backlog async: not every tx settled")
    rounds = int(final.sim.round)
    rows.append({"model": "backlog", "nodes": n5, "window": w5,
                 "backlog_txs": shape["backlog_txs"], "latency": 1,
                 "engine": "coalesced", "rounds": rounds,
                 "ms_per_round": ms / rounds, "host_reads": reads,
                 "cpu_replay_rounds": int(replay.sim.round),
                 "launches": check_no_launches("backlog async"),
                 "wall_s": time.perf_counter() - t0})
    del start, final, replay
    torch.cuda.empty_cache()

    # 4. the node stream under latency 1 (rows cleared from the ring)
    t0 = time.perf_counter()
    ncfg = AvalancheConfig(stake_mode="zipf", registry_nodes=shape["registry"],
                           active_nodes=shape["active"],
                           node_churn_rate=shape["node_churn"],
                           inflight_engine="coalesced",
                           max_element_poll=max(4096, shape["node_txs"]),
                           **LATENCY1)
    start = node_stream.init(prng.key(0, device), shape["node_txs"], ncfg,
                             device=device)
    n_rounds = shape["node_rounds"]
    (final, tel), ms = timed_run(node_stream.run_scan, start, ncfg,
                                 n_rounds=n_rounds, device=device)
    replay, rtel = node_stream.run_scan(av.move_leaves(start, cpu),
                                        ncfg, n_rounds=n_rounds, device="cpu")
    assert_trees_equal(av.move_leaves((final, tel), cpu), (replay, rtel),
                       "node stream async vs its CPU replay")
    if int(tel.departed.sum()) == 0 or int(tel.round.deliveries.sum()) == 0:
        raise AssertionError("node stream async: no churn or no delivery")
    rows.append({"model": "node_stream", "registry_nodes": shape["registry"],
                 "active_nodes": shape["active"], "txs": shape["node_txs"],
                 "latency": 1, "engine": "coalesced", "rounds": n_rounds,
                 "departed": int(tel.departed.sum()),
                 "ms_per_round": ms / n_rounds, "cpu_replay_rounds": n_rounds,
                 "launches": check_no_launches("node stream async"),
                 "wall_s": time.perf_counter() - t0})
    del start, final, replay
    torch.cuda.empty_cache()
    return rows


def run_async(quick: bool = False, device="cuda") -> dict:
    """Phase 9: the async query ring (module docstring); each part's
    rows carry its wall seconds (host clock, CPU replays included)."""
    shape = ASYNC_SHAPES["quick" if quick else "full"]
    n, t = shape["flagship"]
    parts = {"latency0": lambda: run_async_latency0(n, t, device),
             "flagship_async": lambda: run_async_flagship(n, t, False,
                                                          device),
             "flagship_faults": lambda: run_async_flagship(n, t, True,
                                                           device),
             "fault_studies": lambda: run_fault_studies(device),
             "models": lambda: run_async_models(shape, device)}
    out = {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        rows = part()
        wall = time.perf_counter() - t0
        out[name] = ([{**r, "part_wall_s": wall} for r in rows]
                     if isinstance(rows, list) else {**rows, "wall_s": wall})
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


KERNEL_ROWS = {          # name -> (source, the TPU kernel it replaces)
    "megakernel": ("go_avalanche_tpu_torch/csrc/megakernel.cu",
                   "go_avalanche_tpu/ops/megakernel.py:95"),
    "vote_u8": ("go_avalanche_tpu_torch/csrc/vote_u8.cu",
                "go_avalanche_tpu/ops/pallas_vote.py:67"),
    "vote_swar": ("go_avalanche_tpu_torch/csrc/vote_swar.cu",
                  "go_avalanche_tpu/ops/pallas_vote.py:259"),
}


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
             **check_ingest_cases(INGEST_SHAPES + ((DAG_NODES, DAG_TXS),))}

    # 4. main path at full width
    main_path = run_main_path(FLAGSHIP_NODES, FLAGSHIP_TXS, TIMED_ROUNDS)
    emit({"phase": "main", "nodes": FLAGSHIP_NODES, "txs": FLAGSHIP_TXS,
          "k": 8, **main_path, **label})
    torch.cuda.empty_cache()

    # 5. the DAG baseline to settlement
    dag_run = run_dag(DAG_NODES, DAG_TXS)
    emit({"phase": "dag", "nodes": DAG_NODES, "txs": DAG_TXS, **dag_run,
          **label})
    torch.cuda.empty_cache()

    # 6. each kernel alone at the main path's shape
    timing = {"megakernel": time_megakernel(FLAGSHIP_NODES, FLAGSHIP_TXS)}
    for name in ("vote_u8", "vote_swar"):
        timing[name] = time_ingest(name, FLAGSHIP_NODES, FLAGSHIP_TXS)
    for name, row in timing.items():
        emit({"phase": "timing", "kernel": name, "nodes": FLAGSHIP_NODES,
              "txs": FLAGSHIP_TXS, **row, **label})

    # 7. BASELINE configs 0, 1, 3 and 4
    baselines = run_baselines()
    for name, row in baselines["configs"].items():
        emit({"phase": "baselines", "config": name, **row, **label})
    emit({"phase": "baselines", "launches": baselines["launches"],
          "launches_by_ingest_path": baselines["launches_by_ingest_path"],
          **label})
    torch.cuda.empty_cache()
    # the ingest kernels' general path alone at Snowball's [1000, 1]
    for name in ("vote_u8", "vote_swar"):
        row = time_ingest(name, 1000, 1)
        worst[name] = max(worst[name], row["max_abs_err"])
        emit({"phase": "timing", "kernel": name, "nodes": 1000, "txs": 1,
              **row, **label})
    torch.cuda.empty_cache()

    # 8. the streaming schedulers, traffic and the node registry
    streaming = run_streaming()
    for row in streaming["parts"]:
        emit({"phase": "streaming", **row, **label})
    emit({"phase": "streaming", "launches": streaming["launches"],
          "launches_by_ingest_path": streaming["launches_by_ingest_path"],
          **label})
    torch.cuda.empty_cache()

    # 9. the async query ring
    for part, row in run_async().items():
        for r in (row if isinstance(row, list) else [row]):
            emit({"phase": "async", "part": part, **r, **label})

    # 10. the adaptive adversary and the Monte-Carlo fleet
    t0 = time.perf_counter()
    adversary = run_adversary()
    for part in ("sync", "async", "records", "fleet"):
        rows = adversary[part]["rows"]
        for r in (rows if isinstance(rows, list) else [rows]):
            emit({"phase": "adversary", "part": part, **r,
                  "part_wall_s": adversary[part]["wall_s"], **label})
    emit({"phase": "adversary", "launches": adversary["launches"],
          "launches_by_ingest_path": adversary["launches_by_ingest_path"],
          "wall_s": time.perf_counter() - t0, **label})
    torch.cuda.empty_cache()

    # 11. the flight recorder; its launches stay out of the kernels line
    t0 = time.perf_counter()
    observed = run_obs()
    for part in ("flagship", "dag", "recovery", "fleet", "schedulers"):
        rows = observed[part]["rows"]
        for r in (rows if isinstance(rows, list) else [rows]):
            emit({"phase": "obs", "part": part, **r,
                  "part_wall_s": observed[part]["wall_s"], **label})
    emit({"phase": "obs", "launches": observed["launches"],
          "wall_s": time.perf_counter() - t0, **label})
    torch.cuda.empty_cache()

    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": (main_path["launches"][name]
                     + adversary["launches"][name]),
        "max_abs_err": max(worst[name], timing[name]["max_abs_err"]),
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,
    } for name, (source, replaces) in KERNEL_ROWS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
