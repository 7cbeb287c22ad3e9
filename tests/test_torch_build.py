"""The kernel build's cache key and argument checks (`_build.py`), on the
CPU: nothing here compiles."""

import re

import pytest
import torch

from go_avalanche_tpu_torch import _build


def test_library_path_changes_with_an_included_header(tmp_path,
                                                      monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    assert first.parent == tmp_path / "build"
    (csrc / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


def test_every_local_include_is_a_hashed_header():
    """A source may include only `csrc/*.cuh` files (or system headers):
    those are what the digest covers."""
    headers = {p.name for p in _build.CSRC_DIR.glob("*.cuh")}
    sources = sorted(_build.CSRC_DIR.glob("*.cu"))
    assert {p.stem for p in sources} >= {"megakernel", "vote_u8",
                                         "vote_swar"}
    for src in [*sources, *(_build.CSRC_DIR / h for h in headers)]:
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert name in headers, (src.name, name)


def test_check_arg_refuses_what_a_kernel_cannot_read():
    cpu = torch.device("cpu")
    x = torch.zeros((4, 8), dtype=torch.uint8)
    _build.check_arg(x, "x", torch.uint8, (4, 8), cpu, 4)
    with pytest.raises(TypeError, match="torch.int16"):
        _build.check_arg(x, "x", torch.int16, (4, 8), cpu)
    with pytest.raises(ValueError, match="shape"):
        _build.check_arg(x, "x", torch.uint8, (8, 4), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check_arg(x.t(), "x", torch.uint8, (8, 4), cpu)
    with pytest.raises(ValueError, match="4-byte boundary"):
        _build.check_arg(x.reshape(-1)[1:29].reshape(4, 7), "x",
                         torch.uint8, (4, 7), cpu, 4)
    with pytest.raises(ValueError, match="records on meta"):
        _build.check_arg(x, "x", torch.uint8, (4, 8), torch.device("meta"))


def _kernel_symbols():
    """Every `__global__` kernel of csrc/, as its symbol reads in a
    profile: `name<` for a template, `name(` otherwise."""
    kernel = re.compile(r"(template\s*<[^>]*>\s*)?__global__\s+void\s+"
                        r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    for src in sorted([*_build.CSRC_DIR.glob("*.cu"),
                       *_build.CSRC_DIR.glob("*.cuh")]):
        for template, name in kernel.findall(src.read_text()):
            yield name + ("<" if template else "(")


def test_profile_attributes_each_kernel_to_exactly_one_key():
    """`round_profile.PORT_KERNELS` adds a kernel's time to its span once
    per key its symbol matches: each kernel must match exactly one key,
    and each key some kernel."""
    from go_avalanche_tpu_torch.round_profile import PORT_KERNELS

    symbols = list(_kernel_symbols())
    assert {"mega_round_kernel<", "vote_u8_kernel<", "vote_u8_kernel_any(",
            "vote_swar_kernel<", "vote_swar_kernel_any("} <= set(symbols)
    for symbol in symbols:
        assert len([k for k in PORT_KERNELS if k in symbol]) == 1, symbol
    for key in PORT_KERNELS:
        assert any(key in symbol for symbol in symbols), key
