#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (go_avalanche_tpu_torch).

    python3 chip_smoke.py

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
               plain version and its bound.

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


def read_launches() -> dict:
    from go_avalanche_tpu_torch.ops import megakernel
    from go_avalanche_tpu_torch.ops import pallas_vote as pv

    return {"megakernel": megakernel.launches, **pv.launches}


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


def time_ingest(name: str, n: int, t: int, device="cuda") -> dict:
    """Phase 6, ingest kernels: kernel `name` alone at the main path's
    shape and inputs (the stride-0 consider pack, a polled mask),
    checked against and timed beside its plain version."""
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
    plain_ms = time_ms(lambda: plain(*args[:3], cfg.k, cfg, args[3]), 3)
    bound_ms, bound_by = ingest_bound(n, t, cfg.k)
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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

    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": main_path["launches"][name],
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
