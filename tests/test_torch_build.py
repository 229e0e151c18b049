"""The kernel build's cache key (``multiverso_tpu_torch/ops/_build.py``).

A built library is found again by its file name, which hashes what went
into it. The CUDA sources include a shared header (``csrc/hopper.cuh``),
so an edit to any header under ``csrc/`` must give a new name: else a
stale library, built from the old header, would be loaded. These tests
need no ``nvcc``: they work on a copy of ``csrc/`` and only compute names.
"""

import shutil

import pytest

from multiverso_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_sources_include_a_shared_header():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "hopper.cuh" in headers
    for name in ("flash_fwd", "flash_bwd"):
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in source


@pytest.mark.parametrize("name", _build.KERNELS)
@pytest.mark.parametrize("edit", ["header", "own source", "new header",
                                  "flags"])
def test_library_path_follows_every_input(csrc_copy, monkeypatch, name, edit):
    before = _build.library_path(name)
    assert before.parent == csrc_copy.parent / "build"
    assert before.name.startswith(f"lib{name}-") and before.suffix == ".so"
    if edit == "header":
        with open(csrc_copy / "hopper.cuh", "a") as f:
            f.write("\n// edited\n")
    elif edit == "own source":
        with open(csrc_copy / f"{name}.cu", "a") as f:
            f.write("\n// edited\n")
    elif edit == "new header":
        (csrc_copy / "extra.h").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", _build.KERNELS)
def test_library_path_ignores_other_sources_and_files(csrc_copy, name):
    """Another kernel's ``.cu`` or a non-header file does not rebuild this
    one, and the name is stable from call to call."""
    before = _build.library_path(name)
    assert _build.library_path(name) == before
    other = next(n for n in _build.KERNELS if n != name)
    with open(csrc_copy / f"{other}.cu", "a") as f:
        f.write("\n// edited\n")
    (csrc_copy / "notes.txt").write_text("not compiled\n")
    assert _build.library_path(name) == before
