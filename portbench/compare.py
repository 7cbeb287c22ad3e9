"""The comparison that decides `correct`: the program's planes and
counters against the plain reference's, element for element.

Every number compared is an exact count with the limit 0 (or a count of
checked answers with a least value), so a `Check` holds its value, its
limit and which side of the limit passes.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence

import torch


@dataclass
class Check:
    value: int
    limit: int
    at_least: bool = False   # pass when value >= limit, else value <= limit

    def ok(self) -> bool:
        return (self.value >= self.limit if self.at_least
                else self.value <= self.limit)


def mismatched(program: Mapping[str, torch.Tensor],
               reference: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """Elements that differ, per plane the reference has; a plane the
    program lacks or holds in another shape counts whole."""
    out = {}
    for name, ref in reference.items():
        got = program.get(name)
        if got is None or tuple(got.shape) != tuple(ref.shape):
            out[name] = ref.numel()
            continue
        got = got.to(ref.device)
        if ref.is_floating_point() or got.is_floating_point():
            diff = got.to(torch.float64) != ref.to(torch.float64)
        else:
            diff = got.to(torch.int64) != ref.to(torch.int64)
        out[name] = int(diff.sum())
    return out


def telemetry_mismatches(program: Sequence[Mapping[str, int]],
                         reference: Sequence[Mapping[str, int]]) -> int:
    """Counters that differ, round by round, plus every round one side
    has and the other lacks (each of its counters counts)."""
    bad = 0
    for got, want in zip(program, reference):
        bad += sum(int(got.get(k, -1) != v) for k, v in want.items())
    longer = program if len(program) > len(reference) else reference
    for row in longer[min(len(program), len(reference)):]:
        bad += len(row)
    return bad


def rows_to_host(rows: List[Mapping[str, torch.Tensor]]) -> List[dict]:
    """Per-round counter dicts of device scalars to Python ints in one
    copy."""
    if not rows:
        return []
    names = list(rows[0])
    flat = torch.stack([torch.stack([r[n].to(torch.int64) for n in names])
                        for r in rows]).tolist()
    return [dict(zip(names, vals)) for vals in flat]


def report(checks: Mapping[str, Check]) -> None:
    """Print each number compared beside its limit on standard error,
    one line each."""
    for name, c in checks.items():
        side = ">=" if c.at_least else "<="
        print(f"check {name} {c.value} limit {side} {c.limit} "
              f"{'ok' if c.ok() else 'FAILED'}", file=sys.stderr)


def as_json(checks: Mapping[str, Check]) -> dict:
    return {name: {"value": c.value, "limit": c.limit,
                   "rule": ">=" if c.at_least else "<="}
            for name, c in checks.items()}
