"""Build, bind and count the port's hand-written CUDA kernels.

The sources under `csrc/` have a plain C interface (no PyTorch headers), so
`nvcc` builds them into a shared library in seconds (one compile of each
source, all started together, then one link); it is loaded with ctypes.  The build runs on first CUDA use, never at import: the machine
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
           "project_approx.cu", "syncmer.cu", "diploid.cu", "path_sgd.cu")
# Headers the sources include; hashed with them, never compiled alone.
HEADERS = ("lanes.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launch counters, one per kernel (one count per wrapper call that launched).
KERNELS = ("stab_count", "windows", "project_lanes", "compact",
           "project_approx", "syncmer_scan", "map_pack", "diploid",
           "path_sgd")
# An entry point's return when it launched nothing (kNoLaunch in csrc/).
NO_LAUNCH = -1

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {
    "impg_stab_count": (_P, _P, _I32, _P, _P, _P, _P, _I32, _P, _P, _P, _I32,
                        _P, _P),
    "impg_windows": (_P, _I32, _P, _P, _P, _P, _P, _I32, _P, _P, _P),
    "impg_project_lanes": (
        _P, _I32, _I64, _I64, _P, _P, _P, _I32,
        _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _I64,
        _I32, _I32, ctypes.c_uint32, _P, _P, _P,
    ),
    "impg_project_approx": (
        _P, _I32, _I64, _I64, _P, _P, _P, _I32,
        _P, _P, _P,
        _P, _P, _I32,
        _I32, ctypes.c_uint32, _P, _P, _P,
    ),
    "impg_compact": (_P, _I64, _P, _I32, _P, _P, _P),
    "impg_syncmer_scan": (
        _P, _I64, _I32, _I32, ctypes.c_uint32, _P, _P, _P, _P,
    ),
    "impg_syncmer_write": (
        _P, _I64, _I32, _I32, ctypes.c_uint32, _P, _P, _P, _I64, _P, _P, _P,
        _P, _P,
    ),
    "impg_map_pack": (
        _P, _I64, _I32, _I32, ctypes.c_uint32, _P, _I64, _P, _P, _P, _P,
    ),
    "impg_diploid_scores": (_P, _P, _P, _I64, _P, _P, _P, _P, _P),
    "impg_diploid_topk": (_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _I64,
                          _P),
    "impg_path_sgd_epoch": (
        _P, _I64, _P, _P, _P, _I64, ctypes.c_float, ctypes.c_double,
        ctypes.c_uint32, ctypes.c_uint32, _I32, _I64, _P, _P,
    ),
    "impg_path_sgd_apply": (_P, _P, _P, _I64, _I32, _P),
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
    library path.  Each source compiles in its own nvcc process, all at
    once; the ptxas report (registers, spills) is kept beside the library."""
    key = _source_key()
    so_path = os.path.join(BUILD_DIR, f"libimpg_torch_kernels_{key}.so")
    if os.path.exists(so_path):
        return so_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}_{tag}.o")
            for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, log)
              for s, p, log in zip(SOURCES, procs, logs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{s} ({rc}):\n{log}" for s, rc, log in failed))
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         tmp, *objs], capture_output=True, text=True,
    )
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
            f"{proc.stderr}"
        )
    with open(os.path.join(BUILD_DIR, f"ptxas_{key}.txt"), "w") as fh:
        fh.write("".join(logs))
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


def launch(kernel: str, entry: str, *args) -> bool:
    """Call C entry point `entry`; raise on a CUDA error.  Returns whether
    it launched a kernel, and if it did, adds one to `kernel`'s count."""
    lib = library()
    err = getattr(lib, entry)(*args)
    if err == NO_LAUNCH:
        return False
    if err != 0:
        msg = lib.impg_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")
    _launches[kernel] += 1
    return True


def stream_of(t) -> int:
    """Raw cudaStream_t of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
