#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (go_avalanche_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) with nvcc; exits non-zero, before
printing any result, where `torch.cuda.is_available()` is false or the
package is missing.  Phases, each printing JSON lines:

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel of the main path from csrc/;
  3. kernels — each kernel's wrapper on CUDA tensors against its plain
               PyTorch version on the same inputs, bit for bit, over the
               shapes and configs below;
  4. main    — the flagship round (16384 nodes x 16384 txs, k=8,
               `workload.flagship_state`, the reference bench's) through
               `models.avalanche.init` / `round_step`: megakernel and
               phased trajectories leaf-equal, timed rounds, and the
               launch counts of the kernels during that run;
  5. timing  — each kernel alone at the main path's shape, against its
               plain version and its bound.

The second-to-last line is the kernels summary, the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
INT_OPS_PER_S = 67e12           # H100 non-tensor-core 32-bit rate
TIMED_ROUNDS = 20
KERNEL_SHAPES = ((2048, 2048), (1000, 1184))
KERNEL_CASES = {
    "base": dict(),
    "flip_byz0.2": dict(byzantine_fraction=0.2),
    "oppose_byz0.2": dict(byzantine_fraction=0.2,
                          adversary_strategy="oppose_majority"),
    "k3_q2_w3": dict(k=3, quorum=2, window=3),
}


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


def random_round_inputs(n: int, t: int, cfg, device, seed: int):
    """One round's megakernel inputs: random records (counters spread
    over the whole range, around the finalization score and at the
    0x7FFF ceiling), preferences, peers, flags and the polled mask.  A
    draw lies with the config's byzantine fraction, so the base config
    has no lies, as in the round."""
    import torch

    from go_avalanche_tpu_torch.ops import voterecord as vr
    from go_avalanche_tpu_torch.ops.bitops import pack_bool_plane

    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=dtype)

    def coins(p, shape):
        return torch.rand(shape, generator=g, device=device) < p

    wm = (1 << cfg.window) - 1
    kind = ints(0, 3, (n, t))
    counter = torch.where(
        kind == 0, ints(0, 0x8000, (n, t)),
        torch.where(kind == 1,
                    (cfg.finalization_score - ints(-2, 9, (n, t))).clamp(
                        0, 0x7FFF),
                    0x7FFF - ints(0, 3, (n, t))))
    confidence = (counter << 1) | ints(0, 2, (n, t))
    records = vr.VoteRecordState(
        ints(0, 256, (n, t), torch.uint8) & wm,
        ints(0, 256, (n, t), torch.uint8) & wm,
        vr.narrow_confidence(confidence))
    return (records, pack_bool_plane(coins(0.5, (n, t))),
            ints(0, n, (n, cfg.k), torch.int32), coins(0.85, (n, cfg.k)),
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


def check_kernel_cases(device="cuda") -> int:
    """Phase 3: the megakernel against its plain version, every shape and
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


def run_main_path(n: int, t: int, timed_rounds: int, device="cuda") -> dict:
    """Phase 4: the flagship round through the entry points.  Launch
    counts are reset just before and read just after."""
    import torch

    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.models import avalanche as av
    from go_avalanche_tpu_torch.ops import megakernel

    start, mega_cfg = workload.flagship_state(n, t, round_engine="megakernel",
                                              device=device)
    phased_cfg = workload.flagship_config(t)
    torch.cuda.synchronize()

    megakernel.launches = 0
    mega_rounds = 0
    mega, phased = start, start
    for r in range(3):
        mega, mtel = av.round_step(mega, mega_cfg)
        mega_rounds += 1
        phased, ptel = av.round_step(phased, phased_cfg)
        for field, x, y in zip(mtel._fields, mtel, ptel):
            if int(x) != int(y):
                raise AssertionError(f"round {r}: telemetry.{field} "
                                     f"{int(x)} != {int(y)}")
    assert_states_equal(mega, phased, "megakernel vs phased after 3 rounds")
    del phased

    state = mega

    def mega_round():
        nonlocal state, mega_rounds
        state = av.round_step(state, mega_cfg)[0]
        mega_rounds += 1

    for _ in range(2):                      # warm-up
        mega_round()
    torch.cuda.synchronize()
    round_ms = time_ms(mega_round, timed_rounds)
    launches = megakernel.launches
    if launches != mega_rounds:
        raise AssertionError(f"megakernel launched {launches} times in "
                             f"{mega_rounds} megakernel rounds")

    phased_state = state

    def phased_round():
        nonlocal phased_state
        phased_state = av.round_step(phased_state, phased_cfg)[0]

    phased_round()                          # warm-up
    torch.cuda.synchronize()
    phased_ms = time_ms(phased_round, 3)
    if int(state.round) != 3 + 2 + timed_rounds:
        raise AssertionError("round counter did not advance per round")
    if int(state.records.votes.sum()) == 0:
        raise AssertionError("no vote reached the windows")
    return {"launches": {"megakernel": launches}, "mega_rounds": mega_rounds,
            "round_ms": round_ms, "phased_round_ms": phased_ms,
            "votes_per_s": n * t * mega_cfg.k / (round_ms / 1e3),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def time_megakernel(n: int, t: int, device="cuda") -> dict:
    """Phase 5: the kernel alone at the main path's shape, checked
    against and timed beside its plain version."""
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
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main() -> int:
    import torch

    from go_avalanche_tpu_torch import _build
    from go_avalanche_tpu_torch.round_profile import card_label
    from go_avalanche_tpu_torch.workload import FLAGSHIP_NODES, FLAGSHIP_TXS

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

    # 2. build
    t0 = time.perf_counter()
    built = _build.build("megakernel")
    emit({"phase": "build", "kernel": "megakernel",
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in built.log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernels against their plain versions
    worst = check_kernel_cases()

    # 4. main path at full width
    main_path = run_main_path(FLAGSHIP_NODES, FLAGSHIP_TXS, TIMED_ROUNDS)
    emit({"phase": "main", "nodes": FLAGSHIP_NODES, "txs": FLAGSHIP_TXS,
          "k": 8, **main_path, **label})

    # 5. the kernel alone at the main path's shape
    timing = time_megakernel(FLAGSHIP_NODES, FLAGSHIP_TXS)
    emit({"phase": "timing", "kernel": "megakernel", **timing, **label})

    emit({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "go_avalanche_tpu_torch/csrc/megakernel.cu",
        "replaces": "go_avalanche_tpu/ops/megakernel.py:95",
        "launches": main_path["launches"]["megakernel"],
        "max_abs_err": max(worst, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
