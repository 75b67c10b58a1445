"""ctypes binding to the port's native C++ host library (built on demand).

The port's copy of impg_tpu/io/native.py, trimmed to what the query path
needs: the library is built from the three sources in `impg_tpu_torch/native/`
(the PAF parser, the visited bookkeeping of the BFS, the C++ reference
engine), copies of impg_tpu/native/'s files of the same names, with g++ at
first use into `impg_tpu_torch/build/`.  `load()` binds the `impg_paf_*`
symbols; query/engine.py binds `vb_*` and query/host_native.py `he_*`.

Falls back gracefully: `load()` returns None when the shared library is
missing and cannot be built, and io/paf.py then uses the pure-Python parser
and query/engine.py the Python visited bookkeeping.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

import numpy as np

_SRC_NAMES = ("paf_parser.cpp", "visited.cpp", "host_engine.cpp")
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libimpg_torch_native.so")

_lib = None
_load_attempted = False
_malloc_tuned = False

# glibc mallopt parameter numbers (malloc.h).
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_malloc_for_reuse(threshold_bytes: int = 256 << 20) -> bool:
    """Keep big freed buffers on the heap for reuse (glibc mallopt).

    Hosts that fault fresh pages slowly pay the first-touch cost on every
    large per-chunk result buffer when glibc serves it with a private mmap
    that is munmap'd on free (any allocation above M_MMAP_THRESHOLD,
    dynamic, <=32 MiB).  Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps
    those buffers on the main heap, where free()+malloc() hands back the
    same hot pages.

    Called once from load(), so every native-engine process (CLI, tests)
    gets it.  Kill switch: IMPG_MALLOC_TUNE=0.  Returns False (no-op) on
    non-glibc platforms.
    """
    global _malloc_tuned
    if _malloc_tuned:
        return True
    if os.environ.get("IMPG_MALLOC_TUNE", "1") == "0":
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.restype = ctypes.c_int
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    ok = mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
    ok = mallopt(_M_TRIM_THRESHOLD, threshold_bytes) and ok
    _malloc_tuned = bool(ok)
    return _malloc_tuned


def _host_supports_avx2() -> bool:
    """True only when the running CPU reports AVX2.

    Gating on compile success is not enough: g++ compiles AVX2 code on any
    x86 host, and the resulting .so would SIGILL at runtime on a pre-AVX2
    CPU.  /proc/cpuinfo's flags line reflects the actual hardware (Linux);
    on other platforms the flag is skipped (the code is autovectorized, not
    intrinsics, so baseline codegen stays correct).
    """
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    return "avx2" in line.split(":", 1)[1].split()
    except OSError:
        pass
    return False


def _stale() -> bool:
    if not os.path.exists(_SO_PATH):
        return True
    built = os.path.getmtime(_SO_PATH)
    return built < max(os.path.getmtime(os.path.join(_NATIVE_DIR, f))
                       for f in _SRC_NAMES)


def _build() -> bool:
    """g++ the sources into _SO_PATH with impg_tpu/native/Makefile's flags
    (-mavx2 only where the CPU has it, a baseline build as the fallback).
    A lock file serialises concurrent builders (test workers); each writes a
    temporary file and renames it into place."""
    srcs = [os.path.join(_NATIVE_DIR, f) for f in _SRC_NAMES]
    if not all(os.path.exists(s) for s in srcs):
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(_SO_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while we waited
            return True
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        isa_choices = [["-mavx2"], []] if _host_supports_avx2() else [[]]
        for isa in isa_choices:
            try:
                subprocess.run(
                    ["g++", "-O3", *isa, "-std=c++17", "-fPIC", "-Wall",
                     "-Wextra", "-pthread", "-shared", "-o", tmp, *srcs],
                    check=True,
                    capture_output=True,
                    timeout=240,
                )
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, _SO_PATH)
            return True
    return False


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return _lib
    _load_attempted = True
    tune_malloc_for_reuse()
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    lib.impg_paf_parse.restype = ctypes.c_void_p
    lib.impg_paf_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.impg_paf_parse_mt.restype = ctypes.c_void_p
    lib.impg_paf_parse_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.c_int32,
    ]
    lib.impg_paf_error.restype = ctypes.c_char_p
    lib.impg_paf_error.argtypes = [ctypes.c_void_p]
    for name in (
        "impg_paf_n_records",
        "impg_paf_n_runs",
        "impg_paf_n_names",
        "impg_paf_names_size",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    ptr_getters = {
        "impg_paf_query_name_idx": ctypes.POINTER(ctypes.c_int32),
        "impg_paf_target_name_idx": ctypes.POINTER(ctypes.c_int32),
        "impg_paf_q_start": ctypes.POINTER(ctypes.c_int32),
        "impg_paf_q_end": ctypes.POINTER(ctypes.c_int32),
        "impg_paf_t_start": ctypes.POINTER(ctypes.c_int32),
        "impg_paf_t_end": ctypes.POINTER(ctypes.c_int32),
        "impg_paf_strand": ctypes.POINTER(ctypes.c_int8),
        "impg_paf_runs": ctypes.POINTER(ctypes.c_uint32),
        "impg_paf_run_offsets": ctypes.POINTER(ctypes.c_int64),
        "impg_paf_name_offsets": ctypes.POINTER(ctypes.c_int64),
        "impg_paf_name_lengths": ctypes.POINTER(ctypes.c_int64),
    }
    for name, restype in ptr_getters.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    lib.impg_paf_names_buf.restype = ctypes.POINTER(ctypes.c_char)
    lib.impg_paf_names_buf.argtypes = [ctypes.c_void_p]
    lib.impg_paf_free.restype = None
    lib.impg_paf_free.argtypes = [ctypes.c_void_p]

    _lib = lib
    return _lib


def _as_array(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_paf_bytes_native(
    data: bytes, require_cigar: bool = True, threads: int = 0
) -> Optional[dict]:
    """Parse a PAF buffer natively; returns column dict or None if the
    native library is unavailable.  Raises ValueError on malformed input.

    threads=0 lets the parser pick (all cores, >=4 MB per chunk); any
    thread count yields identical columns and error messages (ordered
    chunk merge with exact first-seen name order and rebased line
    numbers)."""
    lib = load()
    if lib is None:
        return None
    handle = lib.impg_paf_parse_mt(
        data, len(data), 1 if require_cigar else 0, threads
    )
    try:
        err = lib.impg_paf_error(handle)
        if err:
            raise ValueError(err.decode())
        n = int(lib.impg_paf_n_records(handle))
        n_runs = int(lib.impg_paf_n_runs(handle))
        n_names = int(lib.impg_paf_n_names(handle))
        names_size = int(lib.impg_paf_names_size(handle))
        out = dict(
            query_name_idx=_as_array(lib.impg_paf_query_name_idx(handle), n, np.int32),
            target_name_idx=_as_array(lib.impg_paf_target_name_idx(handle), n, np.int32),
            q_start=_as_array(lib.impg_paf_q_start(handle), n, np.int32),
            q_end=_as_array(lib.impg_paf_q_end(handle), n, np.int32),
            t_start=_as_array(lib.impg_paf_t_start(handle), n, np.int32),
            t_end=_as_array(lib.impg_paf_t_end(handle), n, np.int32),
            strand=_as_array(lib.impg_paf_strand(handle), n, np.int8),
            runs=_as_array(lib.impg_paf_runs(handle), n_runs, np.uint32),
            run_offsets=_as_array(lib.impg_paf_run_offsets(handle), n + 1, np.int64),
            name_offsets=_as_array(lib.impg_paf_name_offsets(handle), n_names + 1, np.int64),
            name_lengths=_as_array(lib.impg_paf_name_lengths(handle), n_names, np.int64),
        )
        raw = ctypes.string_at(lib.impg_paf_names_buf(handle), names_size)
        offs = out["name_offsets"]
        out["names"] = [
            raw[offs[i] : offs[i + 1]].decode() for i in range(n_names)
        ]
        return out
    finally:
        lib.impg_paf_free(handle)
