"""The port's build of its CUDA sources, on the CPU: which files name a
library (``operator_forge_torch/kernels/build.py``), computed without
``nvcc``.  A library's path hashes its source and every header the source
includes with quotes, so a changed header builds anew instead of loading a
stale library."""

import pytest

from operator_forge_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree of one ``.cu`` that includes a header, which includes
    another; no ``nvcc`` on the path."""
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "unused.cuh").write_text("int unused;\n")
    return tmp_path


def test_inputs_follow_quoted_includes_through_headers(csrc):
    assert [p.name for p in build.inputs(csrc / "k.cu")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("changed", ["k.cu", "a.cuh", "b.cuh"])
def test_a_changed_input_gives_a_new_library_path(csrc, changed):
    before = build.library_path("k", csrc)
    path = csrc / changed
    text = path.read_text()
    path.write_text(text + "// changed\n")
    after = build.library_path("k", csrc)
    assert after != before and after.name.startswith("libk-")
    path.write_text(text)
    assert build.library_path("k", csrc) == before


def test_a_header_the_source_does_not_include_changes_nothing(csrc):
    before = build.library_path("k", csrc)
    (csrc / "unused.cuh").write_text("int unused_changed;\n")
    assert build.library_path("k", csrc) == before


@pytest.mark.parametrize("name", build.sources())
def test_every_source_of_the_port_names_its_headers(name):
    """Each CUDA source's quoted includes exist, and the library path of
    each covers ``common.cuh`` where the source includes it."""
    found = [p.name for p in build.inputs(build.CSRC / f"{name}.cu")]
    assert found[0] == f"{name}.cu"
    if '#include "common.cuh"' in (build.CSRC / f"{name}.cu").read_text():
        assert "common.cuh" in found
    assert build.library_path(name).parent == build.BUILD_DIR


def test_resources_reads_each_kernels_registers_and_spills(csrc, monkeypatch):
    """``ptxas``'s report kept beside a library: each entry function's
    registers and spill bytes, by its symbol where no ``c++filt`` is found;
    a device function's own properties (one a kernel calls) are not its
    kernel's."""
    monkeypatch.setattr(build, "BUILD_DIR", csrc / "_build")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    report = build.report(build.library_path("k", csrc))
    report.parent.mkdir()
    report.write_text(
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size\n"
        "ptxas info    : Function properties for _Z6calledPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 219 registers, used 1 barriers\n"
    )
    assert build.resources("k", csrc) == {
        "_Z1aPf": {"registers": 80, "spill_stores": 8, "spill_loads": 12},
        "_Z1bPf": {"registers": 219, "spill_stores": 0, "spill_loads": 0},
    }
