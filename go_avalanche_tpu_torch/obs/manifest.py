"""Run-manifest writer — `go_avalanche_tpu/obs/manifest.py`: the
provenance record next to a metrics file.

The manifest captures, at run time:

  * the full `AvalancheConfig` as a dict (enums by value) and which
    telemetry taps it selected (`_tap_dict`);
  * the torch and CUDA versions and the device topology the run saw:
    the CUDA device when there is one (platform ``"gpu"``), else the CPU;
  * `hlo_pins`: None — the port compiles no XLA program, so there is no
    program hash to join a trace against (its programs are described
    by `analysis/drift.op_histogram` instead);
  * the git commit (best-effort: absent outside a checkout);
  * any caller extras (workload shape, argv, metric tag).

`write_manifest` writes it next to a metrics file (`manifest_path_for`:
``<metrics>.manifest.json``).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import subprocess
from pathlib import Path
from typing import Optional

import torch

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def _config_dict(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


def _git_sha() -> Optional[str]:
    try:
        proc = subprocess.run(
            ["git", "-C", str(_REPO_ROOT), "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = proc.stdout.strip()
    return sha if proc.returncode == 0 and sha else None


def _topology() -> dict:
    """The devices a run of the port sees: the CUDA devices when there
    are any, else the host CPU."""
    if torch.cuda.is_available():
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": "cpu", "device_count": 1}


def manifest_dict(cfg=None, extra: Optional[dict] = None) -> dict:
    """Assemble the manifest (see module docstring); pure, no writes.
    Every field is best-effort."""
    topology = _topology()
    manifest = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        # `backend` duplicates devices.platform on purpose: it is the
        # key a consumer compares runs on.
        "backend": topology["platform"],
        "devices": topology,
        "git_sha": _git_sha(),
        "hlo_pins": None,
    }
    if cfg is not None:
        manifest["config"] = _config_dict(cfg)
        manifest["tap"] = _tap_dict(cfg)
    if extra:
        manifest.update(extra)
    return manifest


def _tap_dict(cfg) -> dict:
    """Which telemetry tap(s) the run's config selected, with strides: a
    trace file's consumer must know whether its rows came from the
    metrics tap or the trace plane (obs/trace.py) and at what stride."""
    metrics = getattr(cfg, "metrics_every", 0)
    trace = getattr(cfg, "trace_every", 0)
    if metrics > 0 and trace > 0:
        kind = "callback+trace"
    elif trace > 0:
        kind = "trace"
    elif metrics > 0:
        kind = "callback"
    else:
        kind = "none"
    return {"kind": kind, "metrics_every": metrics, "trace_every": trace}


def manifest_path_for(metrics_path) -> Path:
    """``<metrics file>.manifest.json`` — always next to the metrics
    file, whatever its own suffix."""
    p = Path(metrics_path)
    return p.with_name(p.name + ".manifest.json")


def write_manifest(metrics_path, cfg=None,
                   extra: Optional[dict] = None) -> Path:
    """Write the manifest next to `metrics_path`; returns its path."""
    path = manifest_path_for(metrics_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(manifest_dict(cfg, extra), indent=2,
                               sort_keys=True) + "\n")
    return path
