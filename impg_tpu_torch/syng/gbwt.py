"""Syng GBWT-lite: signed syncmer walk index with MEM matching + locate.

The reference builds a C GBWT over every indexed sequence's syncmer walk
(both orientations, syng.rs:2598-2650) and uses it for maximal-exact-match
queries of read walks (syng.rs:4022 gbwt_mems_for_walk) and for locating
walk occurrences.  Here the walk index is the native flat-array structure
in native/gbwt.cpp (see its header comment for the design trade), built
directly from a `SyngIndex`'s occurrence table — the table already holds
every path's (position, syncmer, orientation) steps, so the GBWT needs no
extra artifact: it is derived on demand and cached on the index object.

Node ids are DENSE 1-based ranks over the index's sorted distinct syncmer
ids (the pack feature universe); the sign carries the canonical
orientation, mirroring the reference's signed kmerhash indexes.

The port's copy of impg_tpu/syng/gbwt.py over the port's build of
native/gbwt.cpp (tests/test_torch_syng_tools.py holds the two equal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.io import native as native_mod
from impg_tpu_torch.io.fasta import reverse_complement
from impg_tpu_torch.ops import syncmer as syncmer_mod
from impg_tpu_torch.syng.index import SyngIndex, match_universe


@dataclass
class GbwtMem:
    """A maximal exact match of a query walk (syng.rs:1948 SyngGbwtMem)."""

    step_start: int
    step_end: int
    query_start: int
    query_end: int
    anchors: int
    occurrences: int


@dataclass
class WalkHit:
    """One located occurrence of a walk segment."""

    path: str
    path_id: int
    step: int  # step index within the path's syncmer walk (of the segment END)
    bp: int  # bp position of that step on the path
    forward: bool


class SyngGbwt:
    """Native walk index over a syng index's sequences."""

    def __init__(self, index: SyngIndex):
        lib = native_mod.load()
        if lib is None:
            raise RuntimeError(
                "native library unavailable: the syng GBWT requires the C++ "
                "extension (impg_tpu_torch/native)"
            )
        self._lib = lib
        self.index = index
        cached = getattr(index, "_universe_cache", None)
        if cached is None:
            cached = np.unique(index.occ_ids)
            index._universe_cache = cached
        self.universe = cached
        self.syncmer_len = index.syncmer_len
        index._ensure_pos_view()
        order = index._pos_order
        self.path_offsets = np.ascontiguousarray(index._seq_offsets, np.int64)
        dense = np.searchsorted(self.universe, index.occ_ids[order]).astype(np.int32) + 1
        signed = np.where(index.occ_fwd[order], dense, -dense)
        # impg_gbwt_build copies the step arrays into C++ vectors; only
        # bpos is read back later (locate), so nodes stays a local.
        nodes = np.ascontiguousarray(signed, np.int32)
        self.bpos = np.ascontiguousarray(index.occ_pos[order], np.uint64)
        self.n_paths = len(self.path_offsets) - 1
        self._handle = lib.impg_gbwt_build(
            self.n_paths,
            self.path_offsets,
            nodes,
            self.bpos,
            np.int32(len(self.universe)),
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.impg_gbwt_destroy(handle)
            self._handle = None

    # ---- walk construction -------------------------------------------------

    def walk_from_sequence(self, seq: bytes) -> tuple[np.ndarray, np.ndarray]:
        """(signed_nodes int32, bp_pos uint64) for a query sequence.

        Unmatched syncmers get node 0 (the reference's invalid walk step,
        syng.rs:3851 valid_walk_node).
        """
        pos, ids, fwd = syncmer_mod.extract_syncmers(
            seq, self.index.k, self.index.w, self.index.seed
        )
        return self._steps_from_syncmers(pos, ids, fwd)

    def _steps_from_syncmers(
        self, pos: np.ndarray, ids: np.ndarray, fwd: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        if ids.size == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.uint64)
        hit, idx_c = match_universe(self.universe, ids)
        dense = (idx_c + 1).astype(np.int32)
        signed = np.where(fwd, dense, -dense)
        signed = np.where(hit, signed, np.int32(0))
        return (
            np.ascontiguousarray(signed, np.int32),
            np.ascontiguousarray(pos, np.uint64),
        )

    def best_orientation_walk(
        self, seq: bytes
    ) -> tuple[np.ndarray, np.ndarray, bool]:
        """Matched walk in the read orientation with more index hits.

        Mirrors matched_syncmers_best_query_orientation (syng.rs:2070):
        closed-syncmer extraction of a fragment is not perfectly symmetric
        at the boundaries, so try both orientations; reverse-orientation
        steps are flipped back into the forward read frame.  Returns
        (signed_nodes, bp_pos, used_reverse) restricted to MATCHED steps.
        """
        nodes_f, bpos_f = self.walk_from_sequence(seq)
        keep_f = nodes_f != 0
        rc = reverse_complement(seq)
        nodes_r, bpos_r = self.walk_from_sequence(rc)
        keep_r = nodes_r != 0
        if int(keep_r.sum()) > int(keep_f.sum()):
            # Flip back: position p on the rc read is position
            # len - p - syncmer_len on the forward read; orientation negates.
            nodes = -nodes_r[keep_r][::-1]
            bpos = (
                np.uint64(len(seq) - self.syncmer_len) - bpos_r[keep_r][::-1]
            ).astype(np.uint64)
            return np.ascontiguousarray(nodes), np.ascontiguousarray(bpos), True
        return (
            np.ascontiguousarray(nodes_f[keep_f]),
            np.ascontiguousarray(bpos_f[keep_f]),
            False,
        )

    # ---- queries -----------------------------------------------------------

    def node_count(self, signed_node: int) -> int:
        return int(self._lib.impg_gbwt_node_count(self._handle, np.int32(signed_node)))

    def mems_for_walk(
        self, nodes: np.ndarray, bpos: np.ndarray
    ) -> list[GbwtMem]:
        """Maximal exact matches of a signed walk, contained MEMs pruned."""
        n = len(nodes)
        if n == 0:
            return []
        nodes = np.ascontiguousarray(nodes, np.int32)
        bpos = np.ascontiguousarray(bpos, np.uint64)
        cap = n + 2
        starts = np.zeros(cap, np.int64)
        ends = np.zeros(cap, np.int64)
        occs = np.zeros(cap, np.int64)
        m = int(
            self._lib.impg_gbwt_match_walk(
                self._handle, nodes, bpos, n, starts, ends, occs
            )
        )
        cands = []
        for i in range(m):
            s, e, o = int(starts[i]), int(ends[i]), int(occs[i])
            cands.append(
                GbwtMem(
                    step_start=s,
                    step_end=e,
                    query_start=int(bpos[s]),
                    query_end=int(bpos[e - 1]) + self.syncmer_len,
                    anchors=e - s,
                    occurrences=o,
                )
            )
        return _prune_contained(cands)

    def locate_segment(
        self, nodes: np.ndarray, bpos: np.ndarray, start: int, end: int,
        max_out: int = 4096,
    ) -> list[WalkHit]:
        """All indexed occurrences of walk[start:end] (direct-position locate
        replacing the reference's sampled .spos/.pstep sidecar walk).

        `max_out` is only the initial buffer: the native call reports the
        TRUE occurrence count, and a larger buffer retries once so results
        are never silently truncated."""
        nodes = np.ascontiguousarray(nodes, np.int32)
        bpos = np.ascontiguousarray(bpos, np.uint64)
        if not (0 <= start < end <= nodes.size) or bpos.size != nodes.size:
            raise ValueError(
                f"walk segment [{start}, {end}) out of bounds for walk of "
                f"{nodes.size} steps"
            )
        paths = np.zeros(max_out, np.int32)
        steps = np.zeros(max_out, np.int64)
        dirs = np.zeros(max_out, np.int8)
        n = int(
            self._lib.impg_gbwt_locate_segment(
                self._handle, nodes, bpos, start, end, paths, steps, dirs, max_out
            )
        )
        if n > max_out:
            paths = np.zeros(n, np.int32)
            steps = np.zeros(n, np.int64)
            dirs = np.zeros(n, np.int8)
            n = int(
                self._lib.impg_gbwt_locate_segment(
                    self._handle, nodes, bpos, start, end, paths, steps,
                    dirs, n,
                )
            )
        if n < 0:
            return []
        hits = []
        names = self.index.seq_index
        for i in range(min(n, max_out)):
            p = int(paths[i])
            s = int(steps[i])
            hits.append(
                WalkHit(
                    path=names.get_name(p),
                    path_id=p,
                    step=s - int(self.path_offsets[p]),
                    bp=int(self.bpos[s]),
                    forward=dirs[i] > 0,
                )
            )
        return hits


def _prune_contained(cands: list[GbwtMem]) -> list[GbwtMem]:
    """Drop MEMs contained in an equal-or-richer MEM (syng.rs:3934)."""
    cands = sorted(
        cands,
        key=lambda m: (m.step_start, -m.step_end, m.occurrences),
    )
    kept: list[GbwtMem] = []
    for cand in cands:
        if any(
            k.step_start <= cand.step_start
            and k.step_end >= cand.step_end
            and k.anchors >= cand.anchors
            for k in kept
        ):
            continue
        kept = [
            k
            for k in kept
            if not (
                cand.step_start <= k.step_start
                and cand.step_end >= k.step_end
                and cand.anchors >= k.anchors
            )
        ]
        kept.append(cand)
    kept.sort(key=lambda m: (m.step_start, m.step_end))
    return kept


def gbwt_for_index(index: SyngIndex) -> SyngGbwt:
    """The index's cached walk-GBWT (built on first use)."""
    cached = getattr(index, "_gbwt_cache", None)
    if cached is None:
        cached = SyngGbwt(index)
        index._gbwt_cache = cached
    return cached
