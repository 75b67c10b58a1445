"""ctypes binding to the port's native C++ host library (built on demand).

The port's copy of impg_tpu/io/native.py: the library is built from the
eleven sources in `impg_tpu_torch/native/` (the PAF parser, the visited
bookkeeping of the BFS, the C++ reference engine, the closed-syncmer
extractor, the GFA tokenizer, the path-spelling, token-stream and
priority-topological-sort functions of the GFA layer, the partial-order
aligner of the region outputs, the pairwise aligner, seqwish's union-find
and emitter, and the syncmer-walk GBWT of syng/gbwt.py), copies of
impg_tpu/native/'s files of the same names, with g++ at first use into
`impg_tpu_torch/build/`.  `load()` binds the `impg_paf_*`, `sx_*`,
`impg_gfa_*`, `impg_spell_steps`, `impg_concat_tokens*`,
`impg_topo_priority`, aligner, seqwish and `impg_gbwt_*` symbols;
query/engine.py binds `vb_*`, query/host_native.py `he_*` and graph/poa.py
`impg_poa_*`.

Falls back gracefully: `load()` returns None when the shared library is
missing and cannot be built, and io/paf.py then uses the pure-Python parser
and query/engine.py the Python visited bookkeeping.  The GFA layer and the
POA have no such fallback: they raise RuntimeError without the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_SRC_NAMES = ("paf_parser.cpp", "visited.cpp", "host_engine.cpp",
              "syncmer.cpp", "gfa_parser.cpp", "spellc.cpp", "poa.cpp",
              "gbwt.cpp", "align.cpp", "seqwish_uf.cpp", "seqwish_emit.cpp")
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


def _compile(flags: list, srcs: list, out: str) -> bool:
    """One g++ a source, all started together, then one link into `out`:
    whether every step succeeded."""
    objdir = out + ".objs"
    os.makedirs(objdir, exist_ok=True)
    objs = [os.path.join(objdir, os.path.basename(s) + ".o") for s in srcs]
    procs = []
    try:
        procs = [subprocess.Popen(["g++", *flags, "-c", s, "-o", o],
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
                 for s, o in zip(srcs, objs)]
        if any(p.wait(timeout=240) != 0 for p in list(procs)):
            return False
        subprocess.run(["g++", *flags, "-shared", "-o", out, *objs],
                       check=True, capture_output=True, timeout=240)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(objdir, ignore_errors=True)


def _build() -> bool:
    """g++ the sources into _SO_PATH with impg_tpu/native/Makefile's flags
    (-mavx2 only where the CPU has it, a baseline build as the fallback),
    one compiler process a source at once.  A lock file serialises
    concurrent builders (test workers); each writes a temporary file and
    renames it into place."""
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
            if _compile(["-O3", *isa, "-std=c++17", "-fPIC", "-Wall",
                         "-Wextra", "-pthread"], srcs, tmp):
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

    lib.sx_extract.restype = ctypes.c_void_p
    lib.sx_extract.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_int32,
    ]
    lib.sx_extract_batch.restype = ctypes.c_void_p
    lib.sx_extract_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32, ctypes.c_int32,
    ]
    for nm, rt in (
        ("sx_count", ctypes.c_int64),
        ("sx_pos", ctypes.POINTER(ctypes.c_int64)),
        ("sx_ids", ctypes.POINTER(ctypes.c_uint64)),
        ("sx_fwd", ctypes.POINTER(ctypes.c_uint8)),
        ("sx_free", None),
        ("sxb_count", ctypes.c_int64),
        ("sxb_pos", ctypes.POINTER(ctypes.c_int64)),
        ("sxb_ids", ctypes.POINTER(ctypes.c_uint64)),
        ("sxb_fwd", ctypes.POINTER(ctypes.c_uint8)),
        ("sxb_seq_counts", ctypes.POINTER(ctypes.c_int64)),
        ("sxb_free", None),
    ):
        fn = getattr(lib, nm)
        fn.restype = rt
        fn.argtypes = [ctypes.c_void_p]
    lib.sx_radix_argsort_u64.restype = None
    lib.sx_radix_argsort_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]

    _bind_gfa(lib)
    _bind_align_seqwish(lib)
    _bind_gbwt(lib)
    _lib = lib
    return _lib


def _bind_gbwt(lib) -> None:
    """ctypes signatures of the syncmer-walk GBWT (gbwt.cpp)."""
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.impg_gbwt_build.restype = ctypes.c_void_p
    lib.impg_gbwt_build.argtypes = [ctypes.c_int64, i64p, i32p, u64p,
                                    ctypes.c_int32]
    lib.impg_gbwt_destroy.restype = None
    lib.impg_gbwt_destroy.argtypes = [ctypes.c_void_p]
    lib.impg_gbwt_num_steps.restype = ctypes.c_int64
    lib.impg_gbwt_num_steps.argtypes = [ctypes.c_void_p]
    lib.impg_gbwt_node_count.restype = ctypes.c_int64
    lib.impg_gbwt_node_count.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.impg_gbwt_match_walk.restype = ctypes.c_int64
    lib.impg_gbwt_match_walk.argtypes = [
        ctypes.c_void_p, i32p, u64p, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.impg_gbwt_locate_segment.restype = ctypes.c_int64
    lib.impg_gbwt_locate_segment.argtypes = [
        ctypes.c_void_p, i32p, u64p, ctypes.c_int64, ctypes.c_int64,
        i32p, i64p, i8p, ctypes.c_int64,
    ]


def _bind_gfa(lib) -> None:
    """ctypes signatures of the GFA layer's symbols (gfa_parser.cpp,
    spellc.cpp)."""
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.impg_gfa_parse_mt.restype = ctypes.c_void_p
    lib.impg_gfa_parse_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int32,
    ]
    for name in ("impg_gfa_error", "impg_gfa_header"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_void_p]
    for name in (
        "impg_gfa_n_names", "impg_gfa_names_size", "impg_gfa_n_segs",
        "impg_gfa_seq_size", "impg_gfa_n_links", "impg_gfa_n_paths",
        "impg_gfa_path_names_size", "impg_gfa_n_steps",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name, restype in {
        "impg_gfa_name_offsets": i64p,
        "impg_gfa_seg_name_idx": i32p,
        "impg_gfa_seq_offsets": i64p,
        "impg_gfa_link_a": i32p,
        "impg_gfa_link_b": i32p,
        "impg_gfa_link_a_rev": i8p,
        "impg_gfa_link_b_rev": i8p,
        "impg_gfa_path_name_offsets": i64p,
        "impg_gfa_path_is_walk": i8p,
        "impg_gfa_path_off": i64p,
        "impg_gfa_step_name_idx": i32p,
        "impg_gfa_step_rev": i8p,
        "impg_gfa_names_buf": ctypes.POINTER(ctypes.c_char),
        "impg_gfa_seq_buf": ctypes.POINTER(ctypes.c_char),
        "impg_gfa_path_names_buf": ctypes.POINTER(ctypes.c_char),
    }.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    lib.impg_gfa_free.restype = None
    lib.impg_gfa_free.argtypes = [ctypes.c_void_p]

    lib.impg_concat_tokens_offsets.restype = ctypes.c_int64
    lib.impg_concat_tokens_offsets.argtypes = [
        i64p,            # tok_len
        i64p,            # rows
        ctypes.c_int64,  # n_rows
        i64p,            # out_off
    ]
    lib.impg_concat_tokens_mt.restype = None
    lib.impg_concat_tokens_mt.argtypes = [
        ctypes.c_char_p, i64p, i64p, i64p, ctypes.c_int64, i64p, u8p,
        ctypes.c_int32,
    ]
    lib.impg_topo_priority.restype = None
    lib.impg_topo_priority.argtypes = [
        ctypes.c_int32,
        i32p,            # edge_a
        i32p,            # edge_b
        ctypes.c_int64,  # n_edges
        i32p,            # prio
        i32p,            # order out
    ]
    lib.impg_spell_steps.restype = None
    lib.impg_spell_steps.argtypes = [
        ctypes.c_char_p,  # seq blob
        i64p,             # seg offsets [n_segs+1]
        i32p,             # step rows
        u8p,              # step rev
        ctypes.c_int64,   # n_steps
        i64p,             # out offsets [n_steps+1]
        u8p,              # out
        ctypes.c_int32,   # n_threads
    ]


def _bind_align_seqwish(lib) -> None:
    """ctypes signatures of the pairwise aligner (align.cpp) and of seqwish's
    union-find and GFA emitter (seqwish_uf.cpp, seqwish_emit.cpp)."""
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.uf_create.restype = ctypes.c_void_p
    lib.uf_create.argtypes = [ctypes.c_int64]
    lib.uf_destroy.restype = None
    lib.uf_destroy.argtypes = [ctypes.c_void_p]
    lib.uf_union_runs.restype = None
    lib.uf_union_runs.argtypes = [
        ctypes.c_void_p, i64p, i8p, i64p, i64p, u8p, ctypes.c_int64,
    ]
    lib.uf_find_all.restype = None
    lib.uf_find_all.argtypes = [ctypes.c_void_p, i64p, u8p, ctypes.c_int64]
    lib.uf_union_pairs.restype = None
    lib.uf_union_pairs.argtypes = [ctypes.c_void_p, i64p, i64p,
                                   ctypes.c_int64]
    lib.impg_seqwish_emit.restype = ctypes.c_void_p
    lib.impg_seqwish_emit.argtypes = [
        ctypes.c_int64, i64p, i64p, u8p, ctypes.c_int64, u8p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.impg_seqwish_emit_free.restype = None
    lib.impg_seqwish_emit_free.argtypes = [ctypes.c_void_p]
    for name in ("impg_align_pair", "impg_align_wfa", "impg_align_prefix"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,  # query, its length
            ctypes.c_char_p, ctypes.c_int64,  # target, its length
            ctypes.c_int, ctypes.c_int,       # match, mismatch
            ctypes.c_int, ctypes.c_int,       # gap open, gap extend
            ctypes.POINTER(ctypes.c_uint32),  # CIGAR runs out
            ctypes.c_int64,                   # their capacity
        ]


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


def extract_syncmers_native(
    seq: bytes, k: int, w: int, seed: int, threads: int = 1
) -> Optional[tuple]:
    """Native closed-syncmer extraction (bit-exact vs ops/syncmer.py), or
    None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    if not isinstance(seq, bytes):
        seq = bytes(seq)  # bytearray/memoryview callers (c_char_p arg)
    h = lib.sx_extract(seq, len(seq), k, w, seed & 0xFFFFFFFF, threads)
    try:
        n = int(lib.sx_count(h))
        return (
            _as_array(lib.sx_pos(h), n, np.int64),
            _as_array(lib.sx_ids(h), n, np.uint64),
            _as_array(lib.sx_fwd(h), n, np.uint8).astype(bool),
        )
    finally:
        lib.sx_free(h)


def extract_syncmers_batch_native(
    seqs: list, k: int, w: int, seed: int, threads: int = 0
) -> Optional[tuple]:
    """Batch closed-syncmer extraction over a sequence SET, parallel
    across sequences (the index-build shape; see sx_extract_batch in
    native/syncmer.cpp).  Returns (pos, ids, fwd, per_seq_counts)
    concatenated in input order — bit-exact vs per-sequence extraction —
    or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    blob = b"".join(bytes(s) if not isinstance(s, bytes) else s
                    for s in seqs)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    h = lib.sx_extract_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seqs),
        k,
        w,
        seed & 0xFFFFFFFF,
        threads,
    )
    try:
        n = int(lib.sxb_count(h))
        return (
            _as_array(lib.sxb_pos(h), n, np.int64),
            _as_array(lib.sxb_ids(h), n, np.uint64),
            _as_array(lib.sxb_fwd(h), n, np.uint8).astype(bool),
            _as_array(lib.sxb_seq_counts(h), len(seqs), np.int64),
        )
    finally:
        lib.sxb_free(h)


def radix_argsort_u64(keys: np.ndarray) -> Optional[np.ndarray]:
    """Stable argsort of a contiguous uint64 array via native LSD radix
    (~10x numpy's stable argsort), or None when unavailable."""
    lib = load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    order = np.empty(keys.size, np.int64)
    lib.sx_radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        keys.size,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order


class _NativeHandle:
    """Owns a native result handle; freed when the last zero-copy view
    (whose base chain references this object) is garbage-collected."""

    __slots__ = ("_free", "_h")

    def __init__(self, free_fn, h):
        self._free, self._h = free_fn, h

    def __del__(self):
        if self._h:
            self._free(self._h)
            self._h = None


def _view_array(ptr, n, dtype, owner):
    """Zero-copy numpy view over a native buffer.  The view's base chain
    (ndarray -> ctypes buffer -> ._owner) keeps `owner` — and therefore
    the native allocation — alive for the array's whole lifetime."""
    if n == 0:
        return np.zeros(0, dtype)
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    nbytes = int(n) * np.dtype(dtype).itemsize
    buf = (ctypes.c_byte * nbytes).from_address(addr)
    buf._owner = owner
    return np.frombuffer(buf, dtype=dtype)


def _require(what: str):
    """The loaded library, or RuntimeError naming `what` needs it."""
    lib = load()
    if lib is None:
        raise RuntimeError(
            f"{what} needs the port's native host library, which did not "
            f"build (g++ of impg_tpu_torch/native/ into {_SO_PATH})")
    return lib


def parse_gfa_native(data: bytes) -> dict:
    """Tokenize a GFA buffer natively into columnar arrays.  Raises
    ValueError on a bad W walk.

    The parser picks its threads (all cores, >=4 MB of input per chunk);
    any thread count yields bit-identical output (ordered merge preserving
    global first-seen name order).  The arrays are zero-copy views over the
    native buffers (the big step columns are ~100 MB of avoidable
    page-faulting copies on a 100 MiB graph); each view's base chain owns
    the native handle, so lifetime is safe even if the dict is dropped."""
    lib = _require("GFA parsing")
    h = lib.impg_gfa_parse_mt(data, len(data), 0)
    owner = _NativeHandle(lib.impg_gfa_free, h)
    err = lib.impg_gfa_error(h)
    if err:
        raise ValueError(err.decode())
    n_names = int(lib.impg_gfa_n_names(h))
    n_segs = int(lib.impg_gfa_n_segs(h))
    n_links = int(lib.impg_gfa_n_links(h))
    n_paths = int(lib.impg_gfa_n_paths(h))
    n_steps = int(lib.impg_gfa_n_steps(h))
    header = lib.impg_gfa_header(h)

    def arr(ptr, n, dtype):
        return _view_array(ptr, n, dtype, owner)

    return dict(
        header=header.decode() if header else "",
        names_blob=ctypes.string_at(
            lib.impg_gfa_names_buf(h), int(lib.impg_gfa_names_size(h))
        ),
        name_offsets=arr(
            lib.impg_gfa_name_offsets(h), n_names + 1, np.int64
        ),
        seg_name_idx=arr(
            lib.impg_gfa_seg_name_idx(h), n_segs, np.int32
        ),
        seq_blob=ctypes.string_at(
            lib.impg_gfa_seq_buf(h), int(lib.impg_gfa_seq_size(h))
        ),
        seq_offsets=arr(
            lib.impg_gfa_seq_offsets(h), n_segs + 1, np.int64
        ),
        link_a=arr(lib.impg_gfa_link_a(h), n_links, np.int32),
        link_b=arr(lib.impg_gfa_link_b(h), n_links, np.int32),
        link_a_rev=arr(lib.impg_gfa_link_a_rev(h), n_links, np.int8),
        link_b_rev=arr(lib.impg_gfa_link_b_rev(h), n_links, np.int8),
        path_names_blob=ctypes.string_at(
            lib.impg_gfa_path_names_buf(h),
            int(lib.impg_gfa_path_names_size(h)),
        ),
        path_name_offsets=arr(
            lib.impg_gfa_path_name_offsets(h), n_paths + 1, np.int64
        ),
        path_is_walk=arr(
            lib.impg_gfa_path_is_walk(h), n_paths, np.int8
        ),
        path_off=arr(lib.impg_gfa_path_off(h), n_paths + 1, np.int64),
        step_name_idx=arr(
            lib.impg_gfa_step_name_idx(h), n_steps, np.int32
        ),
        step_rev=arr(lib.impg_gfa_step_rev(h), n_steps, np.int8),
    )


def concat_tokens(blob: bytes, tok_start, tok_len, rows):
    """Native token-stream concatenation: (out, out_off)."""
    lib = _require("the GFA token stream")
    tok_start = np.ascontiguousarray(tok_start, np.int64)
    tok_len = np.ascontiguousarray(tok_len, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    out_off = np.empty(rows.size + 1, np.int64)
    lib.impg_concat_tokens_offsets(
        tok_len.ctypes.data_as(i64p),
        rows.ctypes.data_as(i64p),
        rows.size,
        out_off.ctypes.data_as(i64p),
    )
    out = np.empty(int(out_off[-1]), np.uint8)
    if rows.size:
        lib.impg_concat_tokens_mt(
            blob,
            tok_start.ctypes.data_as(i64p),
            tok_len.ctypes.data_as(i64p),
            rows.ctypes.data_as(i64p),
            ctypes.c_int64(rows.size),
            out_off.ctypes.data_as(i64p),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            0,
        )
    return out, out_off


def topo_priority(n: int, edge_a, edge_b, prio):
    """Native priority topological sort."""
    lib = _require("the priority topological sort")
    edge_a = np.ascontiguousarray(edge_a, np.int32)
    edge_b = np.ascontiguousarray(edge_b, np.int32)
    prio = np.ascontiguousarray(prio, np.int32)
    order = np.empty(n, np.int32)
    if n:
        lib.impg_topo_priority(
            ctypes.c_int32(n),
            edge_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            edge_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(edge_a.size),
            prio.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    return order


# Grow-only scratch of `spell_steps(reuse=True)`: a fresh large output per
# call pays its first-touch page faults every time.
_spell_scratch = np.zeros(0, np.uint8)


def spell_steps(blob: bytes, seg_off, step_row, step_rev, out_off,
                reuse: bool = True):
    """Native single-pass path spelling.

    With `reuse` (default) the returned array is a view into a grow-only
    module scratch buffer: it is INVALIDATED by the next call — copy
    (`.tobytes()`) anything you keep."""
    global _spell_scratch
    lib = _require("path spelling")
    seg_off = np.ascontiguousarray(seg_off, np.int64)
    step_row = np.ascontiguousarray(step_row, np.int32)
    step_rev = np.ascontiguousarray(step_rev, np.uint8)
    out_off = np.ascontiguousarray(out_off, np.int64)
    total = int(out_off[-1]) if out_off.size else 0
    if not reuse:
        out = np.empty(total, np.uint8)
    else:
        if _spell_scratch.size < total:
            _spell_scratch = np.empty(
                max(total, _spell_scratch.size * 2), np.uint8
            )
        out = _spell_scratch[:total]
    if step_row.size:
        lib.impg_spell_steps(
            blob,
            seg_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            step_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            step_rev.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(step_row.size),
            out_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(os.cpu_count() or 1),
        )
    return out
