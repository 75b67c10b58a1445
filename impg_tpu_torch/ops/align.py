"""Native pairwise alignment binding (see native/align.cpp).

The port's copy of impg_tpu/ops/align.py (tests/test_torch_seqwish.py holds
the two equal): base-level CIGAR reconstruction for bounded segments, the
reference's WFA2 FFI role (impg.rs:43-71).  The aligner is the port's own
build of the same C++ source, whose signatures io/native.py declares; without
that library every entry point raises RuntimeError.
"""

from __future__ import annotations

import ctypes

import numpy as np

from impg_tpu_torch.io import native

DEFAULT_SCORING = (1, 4, 6, 2)  # match, mismatch, gap_open, gap_ext


def _lib():
    lib = native.load()
    if lib is None:
        raise RuntimeError("native alignment library unavailable")
    return lib


def _runs(fn, query: bytes, target: bytes, scoring):
    """(return code, CIGAR run buffer) of one aligner entry point."""
    m, x, go, ge = scoring
    cap = len(query) + len(target) + 4
    out = (ctypes.c_uint32 * cap)()
    n = fn(query, len(query), target, len(target), m, x, go, ge, out, cap)
    return n, out


def align_pair(
    query: bytes, target: bytes, scoring=DEFAULT_SCORING
) -> np.ndarray:
    """Globally align query vs target; returns packed CIGAR runs
    ('I' consumes query, 'D' consumes target — PAF convention)."""
    n, out = _runs(_lib().impg_align_pair, query, target, scoring)
    if n < 0:
        raise ValueError(
            f"alignment failed (segment too large: {len(query)}x{len(target)})"
        )
    return np.frombuffer(out, np.uint32, int(n)).copy()


def align_pair_wfa(
    query: bytes, target: bytes, scoring=DEFAULT_SCORING
) -> np.ndarray | None:
    """Direct wavefront (WFA) global alignment — same optimum as
    `align_pair`'s Gotoh oracle by the score-domain transform (see
    native/align.cpp align_wfa). Returns None when WFA declines
    (unsupported scoring / divergence exceeds the cell budget)."""
    n, out = _runs(_lib().impg_align_wfa, query, target, scoring)
    if n == -3:
        return None
    if n < 0:
        raise ValueError("WFA alignment failed (capacity)")
    return np.frombuffer(out, np.uint32, int(n)).copy()


def align_extend(
    query: bytes, target: bytes, scoring=DEFAULT_SCORING
) -> tuple[int, int]:
    """Ends-free extension: align ALL of `query` against the best-scoring
    PREFIX of `target` (the reference's BiWFA boundary-refinement mode,
    syng_transitive.rs:436).  Returns (target bp consumed, matched bp)."""
    n, out = _runs(_lib().impg_align_prefix, query, target, scoring)
    if n < 0:
        raise ValueError(
            f"extension failed (segment too large: {len(query)}x{len(target)})"
        )
    runs = np.frombuffer(out, np.uint32, int(n))
    ops = runs >> np.uint32(29)
    lens = (runs & np.uint32((1 << 29) - 1)).astype(np.int64)
    consumed = int(lens[(ops == 0) | (ops == 1) | (ops == 3)].sum())
    matches = int(lens[ops == 0].sum())
    return consumed, matches
