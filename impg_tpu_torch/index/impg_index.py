"""The IMPG index: per-target sorted directed-interval arrays + run arena.

The port's copy of impg_tpu/index/impg_index.py (tests/test_torch_host.py
and tests/test_torch_onealn.py hold the two equal), for PAF, PAF.gz, .1aln
and .tpa input.  As in impg_tpu, the `.impgt` cache is keyed by the paths and
their mtimes alone: a tracepoint file first ingested without sequences
keeps its approximate runs when it is later loaded with `seq_fetch`.

Functional equivalent of the reference index (impg.rs:394 `Impg` over
per-target coitrees).  Instead of cache-oblivious interval trees we keep the
directed records sorted by (target_id, t_start) in flat SoA arrays: stabbing
is a binary search on starts plus a vectorized end filter — a layout that
batches across queries and maps directly onto device memory.

Serialized artifact: a single `.impgt` file (numpy .npz container) holding
the sequence index, directed record columns, and arena prefix arrays.  Like
the reference's IMPGIDX2 (impg.rs:1655) it is a pure cache: rebuilt from the
PAF when absent or stale.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.core import arena as arena_mod
from impg_tpu_torch.core.arena import CigarArena, DirectedRecords
from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.io import paf as paf_mod

INDEX_VERSION = 3
INDEX_SUFFIX = ".impgt"


def _seg_offsets_tail(part: "ImpgIndex") -> np.ndarray:
    """A part's ordered segment boundaries without the leading 0 (for
    concatenation after a shared [0] head)."""
    full = ImpgIndex.derive_seg_offsets(part.records, part.arena.n_ops)
    return full[1:]


@dataclass
class ImpgIndex:
    seq_index: SequenceIndex
    records: DirectedRecords  # sorted by (target_id, t_start)
    arena: CigarArena
    tgt_offsets: np.ndarray  # int64 [n_seqs + 1] — record slice per target id
    alignment_files: list[str]
    tp: object | None = None  # TracepointArena for --approximate (optional)

    def ensure_tracepoints(self, spacing: int = 100):
        """Derive (and cache) the tracepoint arena for approximate mode."""
        from impg_tpu_torch.index.tracepoints import TracepointArena

        if self.tp is None or self.tp.spacing != spacing:
            self.tp = TracepointArena.build(self.records, self.arena, spacing)
        return self.tp

    # ── construction ─────────────────────────────────────────────────
    @classmethod
    def from_paf_files(
        cls, paths: list[str], bidirectional: bool = True, seq_fetch=None
    ) -> "ImpgIndex":
        seq_index = SequenceIndex()
        parts = []
        for p in paths:
            if p.endswith(".1aln"):
                from impg_tpu_torch.io import onealn as onealn_mod

                recs, _spacing = onealn_mod.parse_1aln(
                    p, seq_index, seq_fetch
                )
                parts.append(recs)
            elif p.endswith(".tpa"):
                from impg_tpu_torch.io import tpa as tpa_mod

                recs, _spacing = tpa_mod.parse_tpa(p, seq_index, seq_fetch)
                parts.append(recs)
            else:
                parts.append(paf_mod.parse_paf_file(p, seq_index))
        if parts:
            run_off_parts = []
            base = 0
            for pr in parts:
                run_off_parts.append(pr.run_offsets[:-1] + base)
                base += pr.run_offsets[-1]
            run_offsets = np.concatenate(
                run_off_parts + [np.array([base], np.int64)]
            )
            cat = lambda name: np.concatenate([getattr(p, name) for p in parts])
            records, arena = arena_mod.build_directed(
                query_id=cat("query_id"),
                q_start=cat("q_start"),
                q_end=cat("q_end"),
                target_id=cat("target_id"),
                t_start=cat("t_start"),
                t_end=cat("t_end"),
                strand=cat("strand"),
                runs=cat("runs"),
                run_offsets=run_offsets,
                bidirectional=bidirectional,
            )
        else:
            records, arena = arena_mod.build_directed(
                query_id=np.zeros(0, np.int32),
                q_start=np.zeros(0, np.int32),
                q_end=np.zeros(0, np.int32),
                target_id=np.zeros(0, np.int32),
                t_start=np.zeros(0, np.int32),
                t_end=np.zeros(0, np.int32),
                strand=np.zeros(0, np.int8),
                runs=np.zeros(0, np.uint32),
                run_offsets=np.zeros(1, np.int64),
                bidirectional=bidirectional,
            )
        return cls._finalize(seq_index, records, arena, list(paths))

    @classmethod
    def _finalize(
        cls,
        seq_index: SequenceIndex,
        records: DirectedRecords,
        arena: CigarArena,
        files: list[str],
    ) -> "ImpgIndex":
        order = np.lexsort((records.t_start, records.target_id))
        records = records.take(order)
        n_seqs = len(seq_index)
        tgt_offsets = np.searchsorted(
            records.target_id, np.arange(n_seqs + 1), side="left"
        ).astype(np.int64)
        return cls(
            seq_index=seq_index,
            records=records,
            arena=arena,
            tgt_offsets=tgt_offsets,
            alignment_files=files,
        )

    @classmethod
    def merge(cls, parts: list["ImpgIndex"], files: list[str]) -> "ImpgIndex":
        """Combine per-file indexes into one unified index (reference:
        multi_impg.rs — lazily-combined per-file caches).  Sequence ids are
        remapped into a union SequenceIndex; arenas concatenate with op
        offsets shifted; records re-sort in _finalize."""
        seq_index = SequenceIndex()
        maps = []
        for p in parts:
            m = np.zeros(max(len(p.seq_index), 1), np.int32)
            for i in range(len(p.seq_index)):
                m[i] = seq_index.get_or_insert_id(
                    p.seq_index.get_name(i), p.seq_index.get_len_from_id(i)
                )
            maps.append(m)
        rec_parts: list[DirectedRecords] = []
        # Stats columns concatenate only when every part has them
        # materialized; otherwise the merged arena re-derives lazily.
        all_stats = all(p.arena.stats_materialized for p in parts)
        fields = CigarArena.EAGER_FIELDS + (
            CigarArena.STATS_FIELDS if all_stats else ()
        )
        arena_cols: dict[str, list[np.ndarray]] = {f: [] for f in fields}
        seg_parts: list[np.ndarray] = [np.zeros(1, np.int64)]
        arena_base = 0
        rec_base = 0
        for p, m in zip(parts, maps):
            r = p.records
            rec_parts.append(
                DirectedRecords(
                    target_id=m[r.target_id],
                    query_id=m[r.query_id],
                    t_start=r.t_start,
                    t_end=r.t_end,
                    q_start=r.q_start,
                    q_end=r.q_end,
                    strand=r.strand,
                    op_off=r.op_off + arena_base,
                    op_cnt=r.op_cnt,
                    rec_id=r.rec_id + rec_base,
                    is_reversed=r.is_reversed,
                )
            )
            for f in arena_cols:
                arena_cols[f].append(getattr(p.arena, f))
            seg_parts.append(_seg_offsets_tail(p) + arena_base)
            arena_base += p.arena.n_ops
            if len(r):
                rec_base += int(r.rec_id.max()) + 1
        records = DirectedRecords.concatenate(rec_parts)
        arena = CigarArena(
            **{f: np.concatenate(cols) for f, cols in arena_cols.items()},
            seg_offsets=np.concatenate(seg_parts),
        )
        return cls._finalize(seq_index, records, arena, files)

    @staticmethod
    def derive_seg_offsets(records: DirectedRecords, n_ops: int) -> np.ndarray:
        """Ordered run-segment boundaries from (possibly sorted) records.

        Record segments are contiguous and disjoint in the arena, so the
        sorted op_off values plus the arena length are exactly the
        segment boundaries the lazy stats builder needs."""
        return np.concatenate(
            [np.sort(records.op_off.astype(np.int64)),
             np.array([n_ops], np.int64)]
        )

    # ── stabbing ─────────────────────────────────────────────────────
    def stab(self, target_id: int, start: int, end: int) -> np.ndarray:
        """Directed record indices overlapping [start, end] (closed-interval
        semantics, matching coitrees: touching records are returned and later
        rejected by projection)."""
        lo = int(self.tgt_offsets[target_id])
        hi = int(self.tgt_offsets[target_id + 1])
        if lo == hi:
            return np.zeros(0, np.int64)
        cut = lo + int(
            np.searchsorted(self.records.t_start[lo:hi], end, side="right")
        )
        sel = np.nonzero(self.records.t_end[lo:cut] >= start)[0]
        return (lo + sel).astype(np.int64)

    def tree_size(self, target_id: int) -> int:
        return int(self.tgt_offsets[target_id + 1] - self.tgt_offsets[target_id])

    # ── serialization ────────────────────────────────────────────────
    def save(self, path: str) -> None:
        """Write the v3 artifact: only the eager arena arrays.

        The identity-statistics block (24 B/run) is never persisted —
        it derives lazily from the runs after load, which keeps the
        artifact and the resident footprint at 20 B/run for the dominant
        interval-only query paths."""
        names, lengths = self.seq_index.to_arrays()
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            version=np.int64(INDEX_VERSION),
            names=names.astype(str),
            lengths=lengths,
            files=np.array(self.alignment_files, dtype=str),
            tgt_offsets=self.tgt_offsets,
            **{f"rec_{k}": getattr(self.records, k) for k in self.records.__dataclass_fields__},
            **{f"arena_{k}": getattr(self.arena, k) for k in CigarArena.EAGER_FIELDS},
        )
        # numpy appends .npz; normalize to the requested path.
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            os.replace(path + ".npz", path)

    @classmethod
    def load(cls, path: str) -> "ImpgIndex":
        with np.load(path, allow_pickle=False) as z:
            version = int(z["version"])
            if version not in (2, INDEX_VERSION):
                raise ValueError(
                    f"Index {path} has version {version}, expected {INDEX_VERSION}"
                )
            seq_index = SequenceIndex.from_lists(z["names"], z["lengths"])
            records = DirectedRecords(
                **{k: z[f"rec_{k}"] for k in DirectedRecords.__dataclass_fields__}
            )
            fields = CigarArena.EAGER_FIELDS + (
                CigarArena.STATS_FIELDS if version == 2 else ()
            )
            arena = CigarArena(**{k: z[f"arena_{k}"] for k in fields})
            if not arena.stats_materialized:
                arena.attach_seg_offsets(
                    cls.derive_seg_offsets(records, arena.n_ops)
                )
            return cls(
                seq_index=seq_index,
                records=records,
                arena=arena,
                tgt_offsets=z["tgt_offsets"],
                alignment_files=[str(f) for f in z["files"]],
            )


def index_path_for(paf_paths: list[str]) -> str:
    """Default index artifact path for a set of alignment files.

    Single file: `<file>.impgt` next to it.  Multiple files: the name embeds
    a digest of the full sorted path list so different sets never share an
    artifact.
    """
    if len(paf_paths) == 1:
        return paf_paths[0] + INDEX_SUFFIX
    import hashlib

    digest = hashlib.sha256(
        "\0".join(sorted(paf_paths)).encode()
    ).hexdigest()[:12]
    return f"{paf_paths[0]}.multi-{digest}{INDEX_SUFFIX}"


def load_or_build(
    paf_paths: list[str], index_path: str | None = None, force: bool = False,
    seq_fetch=None, threads: int = 1,
) -> ImpgIndex:
    """Load a cached index if fresh, else build from the PAFs and save.

    Staleness: the index is rebuilt if any alignment file is newer than the
    artifact (the reference warns instead, main.rs:11355; rebuilding is
    strictly safer since our artifact embeds the CIGAR tensors).

    `threads > 1` builds per-file artifacts concurrently (the reference's
    rayon par_iter over files, main.rs:11189; the native parser and numpy
    release the GIL). Only the multi-file fan-out is threaded, and only
    without a shared `seq_fetch` handle.
    """
    if index_path is None and len(paf_paths) > 1:
        # Per-file artifact caching (reference: multi_impg.rs): each file
        # keeps its own `<file>.impgt`, so growing a file set only builds
        # the new files; the union merges in memory.
        if threads > 1 and seq_fetch is None:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                min(threads, len(paf_paths))
            ) as ex:
                parts = list(
                    ex.map(
                        lambda p: load_or_build([p], force=force),
                        paf_paths,
                    )
                )
        else:
            parts = [
                load_or_build([p], force=force, seq_fetch=seq_fetch)
                for p in paf_paths
            ]
        return ImpgIndex.merge(parts, list(paf_paths))
    import logging
    import time

    log = logging.getLogger("impg_tpu_torch.index")
    path = index_path or index_path_for(paf_paths)
    if not force and os.path.exists(path):
        idx_mtime = os.path.getmtime(path)
        if all(
            os.path.getmtime(p) <= idx_mtime for p in paf_paths if os.path.exists(p)
        ):
            try:
                t0 = time.perf_counter()
                idx = ImpgIndex.load(path)
                log.info(
                    "loaded index %s (%d records) in %.3fs",
                    path, len(idx.records), time.perf_counter() - t0,
                )
                return idx
            except Exception:
                pass  # fall through to rebuild
    t0 = time.perf_counter()
    idx = ImpgIndex.from_paf_files(paf_paths, seq_fetch=seq_fetch)
    log.info(
        "built index from %d file(s): %d records, %d runs in %.3fs",
        len(paf_paths), len(idx.records), int(idx.arena.n_ops),
        time.perf_counter() - t0,
    )
    try:
        idx.save(path)
    except OSError:
        pass  # read-only location: serve the in-memory index
    return idx
