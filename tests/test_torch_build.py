"""Where the port's CUDA libraries build to (no nvcc needed).

``build.library_path`` keys each ``csrc/<name>.cu`` library by its source,
every shared header ``csrc/*.cuh`` and the compiler flags, so an edit to a
header that two kernels include rebuilds both instead of loading a stale
library from ``build/kernels/``.  These tests point ``build.CSRC`` at a
temporary directory.
"""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
    (tmp_path / "two.cu").write_text('#include "shared.cuh"\nint two;\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\nint shared;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_path_is_stable_when_nothing_changes(csrc):
    first = {n: build.library_path(n) for n in ("one", "two")}
    assert first == {n: build.library_path(n) for n in ("one", "two")}
    assert first["one"] != first["two"]
    assert first["one"].parent == build.BUILD_DIR
    assert first["one"].name.startswith("libone-")
    assert first["one"].suffix == ".so"


def test_header_edit_moves_every_user(csrc):
    before = {n: build.library_path(n) for n in ("one", "two")}
    (csrc / "shared.cuh").write_text("#pragma once\nint shared2;\n")
    after = {n: build.library_path(n) for n in ("one", "two")}
    assert all(before[n] != after[n] for n in before)
    # and back: the digest is a function of the contents
    (csrc / "shared.cuh").write_text("#pragma once\nint shared;\n")
    assert {n: build.library_path(n) for n in before} == before


@pytest.mark.parametrize("edit", ["source", "new header", "flags"])
def test_source_new_header_and_flags_move_the_path(csrc, monkeypatch, edit):
    before = build.library_path("one")
    if edit == "source":
        (csrc / "one.cu").write_text('#include "shared.cuh"\nint uno;\n')
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("int extra;\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("one") != before
    if edit == "source":                 # the other library is untouched
        (csrc / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
        assert build.library_path("one") == before


def test_repository_sources_and_header_exist():
    """Every listed source is in ``csrc``, and the TMA/wgmma kernels share
    ``hopper.cuh``, so a library's path covers it."""
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    header = build.CSRC / "hopper.cuh"
    assert header.is_file()
    for name in ("flash_attention", "logprob_gather"):
        assert '#include "hopper.cuh"' in (build.CSRC /
                                           f"{name}.cu").read_text()
