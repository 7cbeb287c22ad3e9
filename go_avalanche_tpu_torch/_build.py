"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles with `nvcc`
alone (no PyTorch headers) into `build/lib<name>-<digest>.so`, where the
digest covers the source, every `csrc/*.cuh` header a source may include
and the flags, so an edited source or header rebuilds and an unchanged
one is reused.  Nothing here runs at import.

`compiles` counts the kernel libraries this process compiled or loaded
anew: one for each `build` that ran nvcc, and one for each first `load`
of a library that was already current (`analysis/retrace.py` reads it).
`Launch` runs a loaded entry's call as a torch op, so that the profiler
places its kernels under the span open around the call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
compiles = 0


def _count_compile() -> None:
    global compiles
    compiles += 1


class Built(NamedTuple):
    path: Path       # the shared library
    seconds: float   # wall time of this build (0.0 when reused)
    log: str         # nvcc's output (ptxas register / spill report)


def nvcc_path() -> str:
    """`nvcc` from CUDA_HOME, then PATH, then the toolkit's usual home."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels build only where a CUDA toolkit "
                       "is installed)")


def library_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a digest of the source,
    of every `csrc/*.cuh` (in name order) and of the flags."""
    h = hashlib.sha256()
    for src in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Compile `csrc/<name>.cu` unless its library is current; raises
    with nvcc's output if the build fails."""
    lib = library_path(name)
    if lib.exists():
        return Built(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)
    _count_compile()
    return Built(lib, time.perf_counter() - start, proc.stdout)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    built = build(name)
    if not built.seconds:
        _count_compile()    # a current library: this first load counts
    return ctypes.CDLL(str(built.path))


def check_arg(t, name: str, dtype, shape: tuple, device, align: int = 8
              ) -> None:
    """Raise unless tensor `t` is what a kernel reads through a bare
    pointer: on `device`, of `dtype` and `shape`, contiguous, and
    starting on an `align`-byte boundary (the kernels read whole
    words)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, records on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on an {align}-byte boundary "
                         f"(the kernel reads whole words)")


class Launch(torch.autograd.Function):
    """A kernel's ctypes call as a torch op (one that differentiates
    nothing): ``Launch.apply(entry, *args)`` returns ``entry(*args)``,
    the C entry's status.  The profiler links a device kernel to the
    innermost torch op open when it was launched, and a bare ctypes call
    opens none: its kernels would lie under no span."""

    @staticmethod
    def forward(ctx, entry, *args) -> int:
        return entry(*args)
