"""``kernels/build``: a library's key follows its source and every header
of ``csrc/`` that the source reaches, so an edit to a shared header
rebuilds every library that includes it and no other. Needs no ``nvcc``.
"""
import re

import pytest

from repro_torch.kernels import build

SOURCES = {
    "a.cu": '#include "tile.cuh"\n#include <cuda_runtime.h>\nint a;\n',
    "b.cu": '  #  include "tile.cuh"\nint b;\n',
    "c.cu": '#include "other.cuh"\nint c;\n',
    "d.cu": "int d;\n",
    "tile.cuh": '#pragma once\n#include "inner.cuh"\nint tile;\n',
    "inner.cuh": "#pragma once\nint inner;\n",
    "other.cuh": "#pragma once\nint other;\n",
}
# header -> the sources whose library must change with it
INCLUDED_BY = {
    "tile.cuh": {"a", "b"},
    "inner.cuh": {"a", "b"},  # through tile.cuh
    "other.cuh": {"c"},
}


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    for name, text in SOURCES.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def paths():
    return {name: build.library_path(name) for name in "abcd"}


@pytest.mark.parametrize("header", sorted(INCLUDED_BY))
def test_editing_a_header_changes_exactly_its_includers(csrc, header):
    before = paths()
    with (csrc / header).open("a") as f:
        f.write("int edited;\n")
    after = paths()
    changed = {name for name in before if before[name] != after[name]}
    assert changed == INCLUDED_BY[header]


@pytest.mark.parametrize("name", "abcd")
def test_editing_a_source_changes_only_its_library(csrc, name):
    before = paths()
    with (csrc / f"{name}.cu").open("a") as f:
        f.write("int edited;\n")
    after = paths()
    assert {n for n in before if before[n] != after[n]} == {name}


def test_sources_follow_quoted_includes_only(csrc):
    found = {p.name for p in build.sources("a")}
    assert found == {"a.cu", "tile.cuh", "inner.cuh"}  # not <cuda_runtime.h>
    assert {p.name for p in build.sources("d")} == {"d.cu"}


def test_key_is_stable_and_names_the_library(csrc):
    first = paths()
    assert paths() == first
    for name, path in first.items():
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", path.name)
        assert build.ptxas_log(name) == path.with_suffix(".log")


@pytest.mark.parametrize("kernel", ["sspnna_fused", "sspnna_tiles"])
def test_sspnna_kernels_take_their_tile_body_from_the_shared_header(kernel):
    """Both SSpNNA libraries reach csrc/sspnna_tile.cuh, so an edit to it
    rebuilds both."""
    assert "sspnna_tile.cuh" in {p.name for p in build.sources(kernel)}
    for other in ("flash_fwd", "moe_gemm"):
        assert "sspnna_tile.cuh" not in {p.name for p in build.sources(other)}


def test_defines_build_a_variant_under_a_key_of_its_own(csrc):
    plain = build.library_path("a")
    one, two = (build.library_path("a", (f"X={v}",)) for v in (1, 2))
    assert len({plain, one, two}) == 3
    assert build.library_path("a", ()) == plain
    assert build.ptxas_log("a", ("X=1",)) == one.with_suffix(".log")
    with (csrc / "tile.cuh").open("a") as f:  # variants follow the header too
        f.write("int edited;\n")
    assert build.library_path("a", ("X=1",)) != one


@pytest.mark.parametrize("kernel", ["flash_fwd", "moe_gemm"])
def test_tensor_core_kernels_take_their_primitives_from_hopper_header(kernel):
    """flash_fwd.cu and moe_gemm.cu reach csrc/hopper.cuh (the wgmma and
    cp.async primitives they share); the SSpNNA sources do not."""
    assert "hopper.cuh" in {p.name for p in build.sources(kernel)}
    for other in ("sspnna_fused", "sspnna_tiles"):
        assert "hopper.cuh" not in {p.name for p in build.sources(other)}


def test_editing_hopper_header_rebuilds_flash_and_moe_gemm_only(
        tmp_path, monkeypatch):
    """On a copy of the real csrc/: an edit to hopper.cuh changes the keys
    of the flash and expert-GEMM libraries and of no other."""
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = sorted(p.stem for p in tmp_path.glob("*.cu"))
    assert {"flash_fwd", "moe_gemm", "sspnna_fused", "sspnna_tiles"} <= set(names)
    before = {n: build.library_path(n) for n in names}
    with (tmp_path / "hopper.cuh").open("a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert {n for n in names if before[n] != after[n]} == {"flash_fwd",
                                                           "moe_gemm"}
