"""Retrace guard: a compile counter for one-compile claims — the port's
`go_avalanche_tpu/analysis/retrace.py`.

Two of the port's performance claims are compile-count claims:

  * a timed loop assumes its warm-up built and loaded everything — a
    kernel build inside the measured repeats would time `nvcc`, not the
    kernel;
  * `fleet.run_phase_grid` loads at most one kernel library per config
    point (the first point that launches it).

The port's compiles are its kernel libraries: `CompileCounter` counts
`_build.compiles` — each `_build.build` that ran nvcc and each first
`_build.load` of a library that was already current.  A library already
loaded costs nothing and counts 0.  The port captures no CUDA graph, so
there is no graph capture to count.

    with retrace.CompileCounter() as c:
        timed_loop()
    c.expect_at_most(0, "the timed loop")   # raises RetraceError
"""

from __future__ import annotations

from go_avalanche_tpu_torch import _build


class RetraceError(RuntimeError):
    """A compile cache was violated: something (re)compiled where the
    surrounding claim says nothing may."""


def compile_count() -> int:
    """Kernel libraries compiled or loaded anew in this process."""
    return _build.compiles


class CompileCounter:
    """Context manager counting kernel-library compiles inside its scope.

    The count FREEZES at scope exit — work after the with-block never
    contaminates the guarded measurement."""

    def __enter__(self) -> "CompileCounter":
        self._start = compile_count()
        self._end = None
        return self

    def __exit__(self, *exc) -> None:
        self._end = compile_count()

    @property
    def count(self) -> int:
        end = self._end if self._end is not None else compile_count()
        return end - self._start

    def expect_at_most(self, n: int, what: str) -> None:
        """Raise `RetraceError` if more than `n` compiles happened in
        scope — with the count, so the failure names its magnitude."""
        if self.count > n:
            raise RetraceError(
                f"{what} compiled {self.count} program(s) where at most "
                f"{n} is allowed — a kernel library was built or loaded "
                f"inside the guarded scope (the one-compile contract, "
                f"go_avalanche_tpu_torch/analysis/retrace.py)")


def guard_fleet_point(misses_before: int, misses_after: int,
                      point) -> None:
    """The phase-grid guard: one config point may compile at most once
    (a repeated point legitimately costs zero).  More than one compile
    for a single point means the sweep rebuilds per call, the
    regression the one-compile-per-config-point claim forbids."""
    misses = misses_after - misses_before
    if misses > 1:
        raise RetraceError(
            f"phase point {point!r} compiled {misses} kernel libraries "
            f"(expected at most 1): the point rebuilds or reloads what "
            f"it already has — one compile per config point is the "
            f"fleet's dispatch-amortization contract "
            f"(go_avalanche_tpu_torch/fleet.py)")
