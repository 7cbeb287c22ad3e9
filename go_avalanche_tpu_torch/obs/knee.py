"""The largest fleet shapes a card holds — the port's copy of
`benchmarks/vmem_knee.py:59-278`, on an H100 profile.

The fleet lane stacks F flagship trials of ``[N, T]`` planes on a
leading trial axis (`workload.fleet_flagship_state`) and scans them in
place (`parallel/sharded_fleet.fleet_scan_program`).  `knee_table`
sweeps the analytic footprint over the ``[F, N = T]`` grid and gives,
per fleet size, the largest square whose modelled live peak fits the
device's memory budget; `select_fleet_shape` (`run_sim --fleet-shape
auto`) picks or validates a fleet against that table, with the
reference's logic and wording (only the cited source differs).

The model, per grid point:

  * the per-trial state bytes: `per_trial_footprint`, the analytic
    footprint (`obs/resources.footprint`) of one flagship trial, built
    on the ``meta`` device, so 65536² allocates nothing;
  * trials per device: ``ceil(F / devices)``;
  * the live peak (``peak_model="loop"``, the port's): the port runs
    the trials of a device one after another, each round's new state
    written back into the stack, so the peak is the stack plus ONE
    round's scratch, ``trials x state + temp_ratio x state``.  The
    reference vmaps the trials and holds every trial's scratch at once,
    ``trials x state x (1 + temp_ratio)`` (``peak_model="stacked"``,
    kept to compare the two tables).  Both pick F = 8 at 16384² on an
    H100.

Profiles (`DEVICE_PROFILES`): ``h100`` for CUDA, its memory the card's
own ``torch.cuda.get_device_properties(dev).total_memory`` and its temp
ratio the phased flagship round's measured peak over its state
(6,477,893,632 / 2,416,230,420 B, `chip_smoke.py` phase resources on an
NVIDIA H100 80GB HBM3 at 700 W); ``cpu-ci`` for the CPU, with the
reference's numbers (an 8 GiB budget and its archived `fleet_small`
CPU record's ratio), so the CPU tests compare like with like.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

GIB = 1024 ** 3

HEADROOM = 0.90          # the share of memory the live peak may claim
HOT_BYTES_PER_ELEM = 5   # votes u8 + consider u8 + confidence u16 + added
FLEETS = (1, 8, 64, 256, 1024, 4096)
SQUARES = tuple(2 ** p for p in range(6, 17))  # 64 .. 65536
SOURCE = "go_avalanche_tpu_torch/obs/knee.py"

# The phased flagship round's peak above its state, and the state, at
# 16384², k=8: `chip_smoke.py` phase resources on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §5).
H100_PHASED_PEAK_BYTES = 6_477_893_632
H100_FLAGSHIP_STATE_BYTES = 2_416_230_420

DEVICE_PROFILES: Dict[str, Dict] = {
    "h100": {"platform": "cuda", "devices": 1, "hbm_bytes": None,
             "vmem_bytes": None,
             "temp_ratio": {
                 "ratio": H100_PHASED_PEAK_BYTES / H100_FLAGSHIP_STATE_BYTES,
                 "source": "chip_smoke.py phase resources: the phased "
                           "flagship round's peak above its state at "
                           "16384², NVIDIA H100 80GB HBM3, 700 W"},
             "peak_model": "loop"},
    "cpu-ci": {"platform": "cpu", "devices": 1, "hbm_bytes": 8 * GIB,
               "vmem_bytes": None,
               "temp_ratio": {"ratio": 4.311748780897932,
                              "source": "mem_pin.json fleet_small [cpu]"},
               "peak_model": "loop"},
}

# torch device type -> the profile that models it.
PLATFORM_PROFILES = {"cuda": "h100", "cpu": "cpu-ci"}


def per_trial_footprint(nt: int, k: int = 8) -> int:
    """The analytic state bytes of ONE flagship trial at N = T = nt, on
    the device (built on ``meta``: nothing is allocated)."""
    from go_avalanche_tpu_torch import workload
    from go_avalanche_tpu_torch.obs import resources

    state, _ = workload.flagship_state(nt, nt, k, device="meta")
    return resources.footprint(state)["total_bytes"]


def live_peak(trials: int, state_bytes: int, ratio: float,
              peak_model: str) -> float:
    """The modelled live peak of `trials` stacked trials on one device."""
    if peak_model == "loop":
        return trials * state_bytes + ratio * state_bytes
    if peak_model == "stacked":
        return trials * state_bytes * (1.0 + ratio)
    raise ValueError(f"peak_model must be 'loop' or 'stacked', got "
                     f"{peak_model!r}")


def _card_memory() -> int:
    import torch

    return int(torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory)


def knee_table(profile_name: str, fleets=FLEETS, squares=SQUARES,
               k: int = 8, hbm_bytes: Optional[int] = None,
               temp_ratio: Optional[Dict] = None,
               peak_model: Optional[str] = None) -> Dict:
    """The largest-safe-shape table of one profile.  `hbm_bytes`,
    `temp_ratio` (``{"ratio", "source"}``) and `peak_model` override the
    profile's; the ``h100`` profile reads the card's memory when none
    is given."""
    profile = dict(DEVICE_PROFILES[profile_name])
    if hbm_bytes is not None:
        profile["hbm_bytes"] = int(hbm_bytes)
    elif profile["hbm_bytes"] is None:
        profile["hbm_bytes"] = _card_memory()
    tr = dict(temp_ratio or profile["temp_ratio"])
    model = peak_model or profile["peak_model"]
    profile.update(temp_ratio=tr, peak_model=model)
    budget = profile["hbm_bytes"] * HEADROOM
    per_trial = {nt: per_trial_footprint(nt, k) for nt in squares}

    rows = []
    for f in fleets:
        trials_per_device = math.ceil(f / profile["devices"])
        best = None
        for nt in squares:
            peak = live_peak(trials_per_device, per_trial[nt], tr["ratio"],
                             model)
            if peak <= budget:
                best = (nt, peak)
        if best is None:
            rows.append({"fleet": f,
                         "trials_per_device": trials_per_device,
                         "largest_nt": None,
                         "note": "no swept square fits"})
            continue
        nt, peak = best
        row = {
            "fleet": f,
            "trials_per_device": trials_per_device,
            "largest_nt": nt,
            "per_trial_state_bytes": per_trial[nt],
            "per_device_state_bytes": trials_per_device * per_trial[nt],
            "modeled_live_peak_bytes": int(peak),
            "trial_hot_plane_bytes": HOT_BYTES_PER_ELEM * nt * nt,
        }
        if profile["vmem_bytes"]:
            row["vmem_resident"] = (row["trial_hot_plane_bytes"]
                                    <= profile["vmem_bytes"] // 2)
        rows.append(row)
    return {"profile": profile_name, **profile, "headroom": HEADROOM,
            "k": k, "rows": rows}


def _cite(profile: str) -> str:
    return f"{SOURCE} [{profile}]"


def select_fleet_shape(platform: str, devices: int, nodes: int,
                       txs: int, fleet: Optional[int] = None,
                       tables: Optional[Dict] = None) -> Dict:
    """Knee-table fleet sizing (`run_sim --fleet-shape auto`).

    Resolves the profile from the torch device type `platform`, then at
    the requested ``N = nodes, T = txs`` square against its table
    (`knee_table`, or `tables[profile]` when given):

      * ``fleet=None`` — PICK: the deepest trials-per-device row whose
        ``largest_nt`` still fits the shape, times `devices`.  Returns
        ``{"fleet", "trials_per_device", "profile", "row"}``.
      * ``fleet`` given — VALIDATE: the binding row is the shallowest
        ``trials_per_device >= ceil(fleet / devices)``; a shape above
        its knee raises `ValueError` citing the row.

    Raises `ValueError` (funnelled into `parser.error`) when the
    platform has no profile, there is no table, or nothing fits.
    """
    profile = PLATFORM_PROFILES.get(platform)
    if profile is None:
        raise ValueError(
            f"--fleet-shape auto: no knee-table device profile models "
            f"platform {platform!r} (profiles: "
            f"{', '.join(sorted(PLATFORM_PROFILES.values()))})")
    table = (tables.get(profile) if tables is not None
             else knee_table(profile))
    if table is None:
        raise ValueError(
            f"--fleet-shape auto: no knee table for profile {profile!r} "
            f"in {SOURCE} — build it with `knee_table({profile!r})`")
    if devices < 1:
        raise ValueError(f"--fleet-shape auto needs >= 1 device, got "
                         f"{devices}")
    nt = max(int(nodes), int(txs))
    rows = [r for r in table.get("rows", [])
            if r.get("largest_nt") is not None]
    if fleet is None:
        fitting = [r for r in rows if r["largest_nt"] >= nt]
        if not fitting:
            best = max((r["largest_nt"] for r in rows), default=0)
            raise ValueError(
                f"--fleet-shape auto: {nodes}x{txs} exceeds every "
                f"knee in {_cite(profile)} (largest safe square even "
                f"at 1 trial/device: {best}²) — shrink the shape or "
                f"re-derive the table")
        row = max(fitting, key=lambda r: r["trials_per_device"])
        return {"fleet": row["trials_per_device"] * devices,
                "trials_per_device": row["trials_per_device"],
                "profile": profile, "row": row}
    per_chip = math.ceil(fleet / devices)
    binding = [r for r in rows if r["trials_per_device"] >= per_chip]
    if not binding:
        deepest = max((r["trials_per_device"] for r in rows), default=0)
        raise ValueError(
            f"--fleet-shape auto: fleet {fleet} over {devices} "
            f"device(s) is {per_chip} trials/chip — beyond every row "
            f"of {_cite(profile)} (deepest swept: {deepest} "
            f"trials/chip)")
    row = min(binding, key=lambda r: r["trials_per_device"])
    if nt > row["largest_nt"]:
        raise ValueError(
            f"--fleet-shape auto: {nodes}x{txs} at {per_chip} "
            f"trials/chip is ABOVE the VMEM/HBM knee — {_cite(profile)}"
            f" caps the {row['trials_per_device']} trials/chip row at "
            f"{row['largest_nt']}² (modeled live peak "
            f"{row['modeled_live_peak_bytes'] / GIB:.1f} GiB, temp "
            f"ratio source: {table['temp_ratio']['source']}) — shrink "
            f"the shape, the fleet, or grow the mesh")
    return {"fleet": fleet, "trials_per_device": per_chip,
            "profile": profile, "row": row}
