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
        stab_count=0, windows=2, project_lanes=0, compact=1, project_approx=0,
        syncmer_scan=0, map_pack=0, diploid=0, path_sgd=0,
    )


def test_each_entry_point_counts(fake_library):
    """K-F's scan and write entry points each add one to `syncmer_scan`."""
    lib = fake_library(0)
    assert kernels.launch("syncmer_scan", "impg_syncmer_scan", 1)
    assert kernels.launch("syncmer_scan", "impg_syncmer_write", 1)
    assert lib.calls == 2
    counts = kernels.launch_counts()
    assert counts.pop("syncmer_scan") == 2
    assert counts == dict.fromkeys(counts, 0)


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


@pytest.mark.parametrize("name,entry", [
    ("syncmer_scan", "impg_syncmer_scan"), ("map_pack", "impg_map_pack"),
    ("diploid", "impg_diploid_topk"), ("diploid", "impg_diploid_scores"),
    ("path_sgd", "impg_path_sgd_epoch"), ("path_sgd", "impg_path_sgd_apply"),
])
def test_syng_kernels_count_on_their_own(fake_library, name, entry):
    """K-F, K-G, K-H and K-I each have a counter that only their launches
    move, and an empty call moves none."""
    fake_library(0)
    assert kernels.launch(name, entry, 1)
    counts = kernels.launch_counts()
    assert counts.pop(name) == 1
    assert counts == dict.fromkeys(counts, 0)
    fake_library(kernels.NO_LAUNCH)
    assert kernels.launch(name, entry, 1) is False
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc compile per source, all started before any is waited on,
    then one link into the hashed library; the ptxas logs are kept."""
    started, waited = [], []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.src = cmd[-1]

        def communicate(self):
            waited.append(len(started))
            return (f"ptxas info    : Compiling entry function 'k_{len(waited)}'"
                    "\n", None)

    def run(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return type("R", (), dict(returncode=0, stdout="", stderr=""))()

    def fake_objects(cmd):
        open(cmd[cmd.index("-o") + 1], "wb").close()

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen",
                        lambda cmd, **kw: (fake_objects(cmd), Proc(cmd))[1])
    monkeypatch.setattr(kernels.subprocess, "run", run)
    path = kernels.build()
    assert [c[-1].rsplit("/", 1)[1] for c in started] == list(kernels.SOURCES)
    assert waited[0] == len(kernels.SOURCES)  # all started before a wait
    assert all("-c" in c and "arch=compute_90a,code=sm_90a" in c
               for c in started)
    assert os.path.basename(path) == \
        f"libimpg_torch_kernels_{kernels._source_key()}.so"
    assert os.path.exists(path)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".o")]
    assert set(kernels.ptxas_report()) == {
        f"k_{i + 1}" for i in range(len(kernels.SOURCES))}


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


# Random123's published known-answer vectors of Philox4x32-10 (kat_vectors):
# counter words, key words, output words.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_twin_known_answers(ctr, key, want):
    """K-I's plain twin of Philox4x32-10 (int64 arithmetic, 16-bit split
    multiplies) gives Random123's published outputs, alone and inside a
    batch of other counters."""
    import torch

    from impg_tpu_torch.ops import path_sgd

    cols = [torch.tensor([c, 1, c ^ 0xFFFF], dtype=torch.int64) for c in ctr]
    got = path_sgd.philox4x32(*cols, *key)
    assert [int(w[0]) for w in got] == list(want)
    assert all(0 <= int(w.min()) and int(w.max()) < 2**32 for w in got)


def test_draw_mapping():
    """Philox words -> (i, j): i = (u0 n) >> 32; the offset ceil(exp(t log
    n)) with t from u1 and u3 in float64; the sign from u2's top bit; j
    clipped to i's path."""
    import math

    import torch

    from impg_tpu_torch.ops import path_sgd

    n = 100
    pstart = torch.tensor([0] * 40 + [40] * 60, dtype=torch.int64)
    pend = torch.tensor([40] * 40 + [100] * 60, dtype=torch.int64)

    def words(*w):
        return [torch.tensor([x], dtype=torch.int64) for x in w]

    def pair(u0, u1, u2, u3):
        i, j = path_sgd.pairs_from_words(*words(u0, u1, u2, u3), pstart,
                                         pend, math.log(n))
        return int(i[0]), int(j[0])

    assert pair(0, 0, 0, 0) == (0, 0)                 # t = 0: off 1, clipped
    assert pair(0, 0, 2**31, 0) == (0, 1)             # + side
    assert pair(2**31, 0, 0, 0) == (50, 49)           # i = n / 2, - side
    assert pair(2**32 - 1, 0, 2**31, 0) == (99, 99)   # clipped to path end
    # t = 1/4: off = ceil(exp(log(100) / 4)) = ceil(3.16...) = 4
    assert pair(2**31, 2**30, 2**31, 0) == (50, 54)
    # t = 3/4: off = ceil(31.6...) = 32, clipped to the path's start
    assert pair(2**31, 3 * 2**30, 0, 0) == (50, 40)
    # The largest t: off = n, clipped either way.
    assert pair(2**31, 2**32 - 1, 2**31, 2**32 - 1) == (50, 99)
    i, j = path_sgd.draw_pairs(pstart, pend, epoch=3, first=0, count=4096,
                               log_n=math.log(n))
    assert ((pstart[i] <= j) & (j < pend[i])).all()
    assert (j != i).float().mean() > 0.9
    assert abs(float((j > i).float().mean()) - 0.5) < 0.05
