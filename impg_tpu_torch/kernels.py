"""Build, bind and count the port's hand-written CUDA kernels.

The sources under `csrc/` have a plain C interface (no PyTorch headers), so
one `nvcc` call builds them into a shared library in seconds; it is loaded
with ctypes.  The build runs on first CUDA use, never at import: the machine
that imports this module may have no CUDA toolkit at all (the CPU tests run
every kernel's plain twin instead).  The library lands in `build/`, named by
a hash of the sources and flags, so an edited source rebuilds.

Every C entry point takes device pointers, sizes and the CUDA stream, launches
asynchronously and returns `cudaGetLastError()`, or NO_LAUNCH when its input
was empty and it launched nothing.  `launch` raises on a CUDA error and adds
one to the kernel's launch count only when the entry point launched, so the
counts show that a run went through the kernels (`reset_launch_counts`,
`launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("stab_count.cu", "windows.cu", "project_lanes.cu", "compact.cu",
           "project_approx.cu")
# Headers the sources include; hashed with them, never compiled alone.
HEADERS = ("lanes.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launch counters, one per kernel (one count per wrapper call that launched).
KERNELS = ("stab_count", "windows", "project_lanes", "compact",
           "project_approx")
# An entry point's return when it launched nothing (kNoLaunch in csrc/).
NO_LAUNCH = -1

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {
    "impg_stab_count": (_P, _P, _P, _I64, _P, _P, _P, _I32, _P, _P),
    "impg_windows": (_P, _I32, _P, _P, _P, _P, _P, _I32, _P, _P, _P),
    "impg_project_lanes": (
        _P, _I32, _I64, _I64, _P, _P, _P, _I32,
        _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
        _I32, _I32, ctypes.c_uint32, _P, _P, _P,
    ),
    "impg_project_approx": (
        _P, _I32, _I64, _I64, _P, _P, _P, _I32,
        _P, _P, _P,
        _P, _P, _P, _P, _P, _P, _P, _I32,
        _I32, ctypes.c_uint32, _P, _P, _P,
    ),
    "impg_compact_count": (_P, _I64, _P, _P),
    "impg_compact_scatter": (_P, _I64, _P, _P, _P, _I32, _I64, _P, _P),
}

_launches = dict.fromkeys(KERNELS, 0)
_lib = None


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source set has no library yet; returns the
    library path.  The ptxas report (registers, spills) is kept beside it."""
    key = _source_key()
    so_path = os.path.join(BUILD_DIR, f"libimpg_torch_kernels_{key}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    with open(os.path.join(BUILD_DIR, f"ptxas_{key}.txt"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, so_path)
    return so_path


def ptxas_report() -> dict:
    """`parse_ptxas` of the current build's log (requires `build()` first)."""
    with open(os.path.join(BUILD_DIR, f"ptxas_{_source_key()}.txt")) as fh:
        return parse_ptxas(fh.read())


def parse_ptxas(text: str) -> dict:
    """Per-kernel {registers, smem, spill_stores, spill_loads} from the
    output of `nvcc -Xptxas -v`."""
    out: dict = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[current]["smem"] = int(sm.group(1)) if sm else 0
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.impg_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.impg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(kernel: str | None, entry: str, *args) -> bool:
    """Call C entry point `entry`; raise on a CUDA error.  Returns whether
    it launched a kernel, and if it did, adds one to `kernel`'s count; a
    wrapper that makes several entry calls for one kernel (compact's two
    passes) passes kernel=None for all but the first."""
    lib = library()
    err = getattr(lib, entry)(*args)
    if err == NO_LAUNCH:
        return False
    if err != 0:
        msg = lib.impg_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")
    if kernel is not None:
        _launches[kernel] += 1
    return True


def stream_of(t) -> int:
    """Raw cudaStream_t of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
