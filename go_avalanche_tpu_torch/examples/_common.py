"""What the study twins share: the device flag, the artifact directory
and the card's label beside every time."""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Optional

import torch

OUT_DIR = Path(__file__).resolve().parent / "out"


def out_path(name: str) -> str:
    """The twin's default artifact path, under this package's ``out/``."""
    return str(OUT_DIR / name)


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default; raises without one) "
                         "or on the CPU")


def card(device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, on
    CUDA; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    from go_avalanche_tpu_torch.round_profile import card_label

    return card_label()


def card_note(label: Optional[str]) -> str:
    """A `card` label as a suffix for a printed time or rate ("" on the
    CPU)."""
    return f" [{label}]" if label else ""


def synchronize(device) -> None:
    """Wait for the card before a clock is read (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def write_json(path: str, result) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
