"""Launch counting in impg_tpu_torch/kernels.py: a count goes up only when a
C entry point launched its kernel.  A stand-in library plays the entry
points, so these run without a card."""

import os
import re

import pytest

from impg_tpu_torch import kernels


class _FakeLibrary:
    """Every entry point returns `code`."""

    def __init__(self, code: int):
        self.code = code
        self.calls = 0

    def impg_cuda_error_string(self, err):
        return b"stand-in error"

    def __getattr__(self, name):
        def entry(*args):
            self.calls += 1
            return self.code

        return entry


@pytest.fixture
def fake_library(monkeypatch):
    def install(code):
        lib = _FakeLibrary(code)
        monkeypatch.setattr(kernels, "_lib", lib)
        kernels.reset_launch_counts()
        return lib

    yield install
    kernels.reset_launch_counts()


def test_launch_counts_a_launch(fake_library):
    lib = fake_library(0)
    assert kernels.launch("windows", "impg_windows", 1, 2)
    assert kernels.launch("windows", "impg_windows", 1, 2)
    assert kernels.launch("compact", "impg_compact")
    assert lib.calls == 3
    assert kernels.launch_counts() == dict(
        stab_count=0, windows=2, project_lanes=0, compact=1, project_approx=0
    )


def test_empty_call_leaves_count_unchanged(fake_library):
    lib = fake_library(kernels.NO_LAUNCH)
    for name, entry in (("stab_count", "impg_stab_count"),
                        ("project_lanes", "impg_project_lanes"),
                        ("compact", "impg_compact"),
                        ("project_approx", "impg_project_approx")):
        assert kernels.launch(name, entry) is False
    assert lib.calls == 4
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_cuda_error_raises_uncounted(fake_library):
    fake_library(700)
    with pytest.raises(RuntimeError, match="CUDA error 700: stand-in error"):
        kernels.launch("stab_count", "impg_stab_count")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_project_approx_counts_on_its_own(fake_library):
    """K-E has its own counter: a launch of it moves no other count."""
    lib = fake_library(0)
    assert kernels.launch("project_approx", "impg_project_approx", 1)
    assert kernels.launch("project_approx", "impg_project_approx", 1)
    assert lib.calls == 2
    counts = kernels.launch_counts()
    assert counts.pop("project_approx") == 2
    assert counts == dict.fromkeys(counts, 0)


def test_sources_and_signatures_cover_every_kernel():
    """Every counter has a source, every entry point a ctypes signature, and
    every header the sources include is hashed into the build key."""
    assert "project_approx.cu" in kernels.SOURCES
    assert "project_approx" in kernels.KERNELS
    assert "impg_project_approx" in kernels._SIGNATURES
    included = set()
    for source in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC_DIR, source)) as fh:
            included |= set(re.findall(r'#include "([^"]+)"', fh.read()))
    assert included == set(kernels.HEADERS)


@pytest.mark.parametrize("source", kernels.SOURCES)
def test_entry_points_report_empty_input_as_no_launch(source):
    """An entry point that returns before its launch says so: never the
    success code of cudaGetLastError() from an early return."""
    with open(os.path.join(kernels.CSRC_DIR, source)) as fh:
        src = fh.read()
    m = re.search(r"constexpr int kNoLaunch = (-?\d+);", src)
    assert m and int(m.group(1)) == kernels.NO_LAUNCH
    assert "return kNoLaunch;" in src
    early = re.findall(r"if \([^;]*\) return static_cast<int>\("
                       r"cudaGetLastError\(\)\);", src)
    assert not early, early
