"""Syncmer-anchor alignment-free index (the syng backend's first layer).

The port's copy of impg_tpu/syng/index.py (tests/test_torch_syncmer.py holds
the two equal); `extractor="device"` runs the K-F kernel on a torch device
(ops/syncmer_device.py).

The reference's syng backend (syng.rs:2249 SyngIndex) answers homology
queries from a syncmer GBWT with sampled-position sidecars.  This round-1
layer implements the anchor machinery, without the GBWT yet:

  - every sequence's closed syncmers (ops/syncmer.py) go into one global
    occurrence table sorted by syncmer id — flat SoA arrays, binary-search
    lookup (the tensor layout the device engine consumes);
  - `query_region` extracts the region's syncmers, gathers all occurrences,
    applies a seed-frequency filter (drop the most frequent query seeds,
    reference SyngSeedFilter syng.rs:1866), groups hits per (sequence,
    relative strand), and merges anchor positions within a gap budget into
    homologous intervals — the reference's raw query mode (--syng-raw,
    README.md:418).

Artifact: `<prefix>.syngt` (npz) with the occurrence table + name index.
GBWT construction, transitive hops with chaining, and boundary realignment
arrive with the native GBWT in a later round.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.ops import syncmer as syncmer_mod

SYNG_SUFFIX = ".syngt"
INDEX_VERSION = 1


def match_universe(
    universe: np.ndarray, ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(hit mask, clipped universe index) of `ids` in the sorted distinct
    syncmer-id `universe` — the shared matching primitive for GAF walks,
    GBWT MEM queries, and pack features (one id space).  An empty
    universe yields all-miss instead of an out-of-bounds index."""
    if universe.size == 0 or ids.size == 0:
        z = np.zeros(ids.size, np.int64)
        return np.zeros(ids.size, bool), z
    idx = np.searchsorted(universe, ids)
    idx_c = np.clip(idx, 0, universe.size - 1)
    hit = (idx < universe.size) & (universe[idx_c] == ids)
    return hit, idx_c


@dataclass
class HomologousInterval:
    genome: str
    start: int
    end: int
    strand: str
    n_anchors: int


@dataclass
class SyngIndex:
    seq_index: SequenceIndex
    # Occurrence table sorted by (id, seq, pos):
    occ_ids: np.ndarray  # uint64 [n]
    occ_seq: np.ndarray  # int32 [n]
    occ_pos: np.ndarray  # int64 [n]
    occ_fwd: np.ndarray  # bool [n]
    k: int
    w: int
    seed: int
    # Secondary (seq, pos)-sorted view for region slicing (built lazily).
    _pos_order: np.ndarray | None = None
    _seq_offsets: np.ndarray | None = None

    @property
    def syncmer_len(self) -> int:
        return self.w + self.k

    def _ensure_pos_view(self) -> None:
        if self._pos_order is None:
            self._pos_order = np.lexsort((self.occ_pos, self.occ_seq))
            seq_sorted = self.occ_seq[self._pos_order]
            n_seqs = len(self.seq_index)
            self._seq_offsets = np.searchsorted(
                seq_sorted, np.arange(n_seqs + 1), side="left"
            ).astype(np.int64)

    def region_syncmers(self, name: str, start: int, end: int):
        """(abs positions, ids, fwd) of indexed syncmers fully inside the
        region — the query seed set (reference walks the path range,
        syng.rs:4301)."""
        sid = self.seq_index.get_id(name)
        if sid is None:
            raise KeyError(f"Sequence '{name}' not found in syng index")
        self._ensure_pos_view()
        lo, hi = int(self._seq_offsets[sid]), int(self._seq_offsets[sid + 1])
        view = self._pos_order[lo:hi]
        pos = self.occ_pos[view]
        cut_lo = np.searchsorted(pos, start, side="left")
        cut_hi = np.searchsorted(pos, end - self.syncmer_len, side="right")
        sel = view[cut_lo:cut_hi]
        return self.occ_pos[sel], self.occ_ids[sel], self.occ_fwd[sel]

    # ── build ────────────────────────────────────────────────────────
    @classmethod
    def build(
        cls,
        sequences: list[tuple[str, bytes]],
        k: int = syncmer_mod.DEFAULT_K,
        w: int = syncmer_mod.DEFAULT_W,
        seed: int = syncmer_mod.DEFAULT_SEED,
        threads: int = 1,
        extractor: str = "native",
        device="cuda:0",
    ) -> "SyngIndex":
        """Index `sequences`.  extractor: "native" (one threaded C++ batch
        call), "numpy" (per sequence, native when loaded) or "device" (K-F
        on the torch `device`, default cuda:0, over all sequences at once);
        all three give the same arrays."""
        seq_index = SequenceIndex()
        # Fastest host path: one native batch call, parallel ACROSS
        # sequences (sx_extract_batch; two thread spawns per ~100 kb
        # sequence cost more than the scan itself) — the reference's
        # 4-thread build headline conditions (README.md:315).
        # extractor="device" returns the same batch from the bit-exact K-F
        # kernel (ops/syncmer_device.extract_syncmers_batch_device: one
        # launch and one copy back per 256 MiB of codes); all three
        # extractors produce interchangeable indexes.
        batch = None
        if extractor == "native":
            from impg_tpu_torch.io import native as native_mod

            batch = native_mod.extract_syncmers_batch_native(
                [seq for _, seq in sequences], k, w, seed, threads=threads
            )
        elif extractor == "device":
            from impg_tpu_torch.ops.syncmer_device import (
                extract_syncmers_batch_device,
            )

            batch = extract_syncmers_batch_device(
                [seq for _, seq in sequences], k, w, seed, device=device
            )
        if batch is not None:
            occ_pos, occ_ids, occ_fwd, counts = batch
            sids = np.array(
                [
                    seq_index.get_or_insert_id(name, len(seq))
                    for name, seq in sequences
                ],
                np.int32,
            )
            occ_seq = np.repeat(sids, counts)
        else:
            ids_parts, seq_parts, pos_parts, fwd_parts = [], [], [], []
            for name, seq in sequences:
                sid = seq_index.get_or_insert_id(name, len(seq))
                positions, ids, fwd = syncmer_mod.extract_syncmers(
                    seq, k, w, seed, threads=threads
                )
                ids_parts.append(ids)
                seq_parts.append(np.full(ids.size, sid, np.int32))
                pos_parts.append(positions)
                fwd_parts.append(fwd)
            occ_ids = (
                np.concatenate(ids_parts) if ids_parts
                else np.zeros(0, np.uint64)
            )
            occ_seq = (
                np.concatenate(seq_parts) if seq_parts
                else np.zeros(0, np.int32)
            )
            occ_pos = (
                np.concatenate(pos_parts) if pos_parts
                else np.zeros(0, np.int64)
            )
            occ_fwd = (
                np.concatenate(fwd_parts) if fwd_parts
                else np.zeros(0, bool)
            )
        # Occurrences arrive (seq, pos)-ordered from extraction, so a
        # STABLE sort by ids alone equals the full (ids, seq, pos)
        # lexsort; the native radix argsort does it ~10x faster than
        # np.lexsort.  The precondition is checked on BOTH keys: sids
        # monotone AND positions ascending within each equal-sid run —
        # two input sequences sharing a name dedup to one sid
        # (SequenceIndex.get_or_insert_id), which keeps occ_seq monotone
        # while positions restart, so a seq-only check would silently
        # diverge from the documented lexsort order.
        order = None
        if occ_seq.size == 0 or np.all(
            (occ_seq[1:] > occ_seq[:-1])
            | ((occ_seq[1:] == occ_seq[:-1]) & (occ_pos[1:] >= occ_pos[:-1]))
        ):
            from impg_tpu_torch.io import native as _native

            order = _native.radix_argsort_u64(occ_ids)
        if order is None:
            order = np.lexsort((occ_pos, occ_seq, occ_ids))
        return cls(
            seq_index=seq_index,
            occ_ids=occ_ids[order],
            occ_seq=occ_seq[order],
            occ_pos=occ_pos[order],
            occ_fwd=occ_fwd[order],
            k=k,
            w=w,
            seed=seed,
        )

    @classmethod
    def build_from_fasta(cls, fasta_files: list[str], **kwargs) -> "SyngIndex":
        from impg_tpu_torch.io.fasta import FastaIndex

        fa = FastaIndex.build_from_files(fasta_files)
        sequences = [
            (name, fa.fetch_sequence(name, 0, fa.get_sequence_length(name)))
            for name in fa.sequence_names()
        ]
        return cls.build(sequences, **kwargs)

    # ── serialization ────────────────────────────────────────────────
    def save(self, prefix: str) -> str:
        path = prefix if prefix.endswith(SYNG_SUFFIX) else prefix + SYNG_SUFFIX
        names, lengths = self.seq_index.to_arrays()
        # np.savez appends .npz; write then rename to the bare .syngt path.
        np.savez(
            path + ".npz",
            version=np.int64(INDEX_VERSION),
            names=names.astype(str),
            lengths=lengths,
            occ_ids=self.occ_ids,
            occ_seq=self.occ_seq,
            occ_pos=self.occ_pos,
            occ_fwd=self.occ_fwd,
            params=np.array([self.k, self.w, self.seed], np.int64),
        )
        os.replace(path + ".npz", path)
        return path

    @classmethod
    def load(cls, path: str) -> "SyngIndex":
        if not path.endswith(SYNG_SUFFIX):
            path = path + SYNG_SUFFIX
        with np.load(path, allow_pickle=False) as z:
            if int(z["version"]) != INDEX_VERSION:
                raise ValueError(f"unsupported syng index version in {path}")
            k, w, seed = (int(x) for x in z["params"])
            return cls(
                seq_index=SequenceIndex.from_lists(z["names"], z["lengths"]),
                occ_ids=z["occ_ids"],
                occ_seq=z["occ_seq"],
                occ_pos=z["occ_pos"],
                occ_fwd=z["occ_fwd"],
                k=k,
                w=w,
                seed=seed,
            )

    # ── query ────────────────────────────────────────────────────────
    def query_region(
        self,
        name: str,
        start: int,
        end: int,
        merge_gap: int = 10_000,
        min_anchors: int = 2,
        drop_top_fraction: float = 0.0005,
        max_occurrences: int | None = None,
        include_self: bool = False,
    ) -> list[HomologousInterval]:
        """Homologous intervals for the indexed region (raw anchor mode)."""
        q_abs, o_seq, o_pos, rel_fwd = self.region_occurrences(
            name, start, end,
            drop_top_fraction=drop_top_fraction,
            max_occurrences=max_occurrences,
            include_self=include_self,
        )
        if o_seq.size == 0:
            return []

        # Group by (sequence, relative strand); merge anchors within the gap.
        out: list[HomologousInterval] = []
        strand_code = np.where(rel_fwd, 0, 1)
        order = np.lexsort((o_pos, strand_code, o_seq))
        o_seq, o_pos, strand_code = (
            o_seq[order], o_pos[order], strand_code[order]
        )
        boundaries = np.nonzero(
            (o_seq[1:] != o_seq[:-1])
            | (strand_code[1:] != strand_code[:-1])
            | (o_pos[1:] - o_pos[:-1] > merge_gap)
        )[0]
        starts = np.concatenate([[0], boundaries + 1])
        ends = np.concatenate([boundaries + 1, [o_seq.size]])
        for s, e in zip(starts, ends):
            n_anchors = int(e - s)
            if n_anchors < min_anchors:
                continue
            genome = self.seq_index.get_name(int(o_seq[s]))
            out.append(
                HomologousInterval(
                    genome=genome,
                    start=int(o_pos[s]),
                    end=int(o_pos[e - 1]) + self.syncmer_len,
                    strand="-" if strand_code[s] else "+",
                    n_anchors=n_anchors,
                )
            )
        return out

    def region_occurrences(
        self,
        name: str,
        start: int,
        end: int,
        drop_top_fraction: float = 0.0005,
        max_occurrences: int | None = None,
        include_self: bool = False,
    ):
        """Seed-filtered anchor occurrences for an indexed region:
        (query abs position, target seq id, target pos, same-strand flag)
        per occurrence — the shared front half of raw-mode and chained
        transitive queries (syng.rs:4301/4494 anchor collection)."""
        positions, ids, fwd = self.region_syncmers(name, start, end)
        return self.occurrences_for_syncmers(
            positions, ids, fwd,
            drop_top_fraction=drop_top_fraction,
            max_occurrences=max_occurrences,
            exclude_self=None if include_self else name,
        )

    def occurrences_for_syncmers(
        self,
        positions: np.ndarray,
        ids: np.ndarray,
        fwd: np.ndarray,
        drop_top_fraction: float = 0.0005,
        max_occurrences: int | None = None,
        exclude_self: str | None = None,
    ):
        """Seed-filtered occurrences for an arbitrary query syncmer set —
        the read-mapping primitive (syng.rs:4369
        matched_syncmers_in_sequence feeding query_region_from_node
        _positions): the query need not be an indexed path."""
        if ids.size == 0:
            z = np.zeros(0, np.int64)
            return z, z.astype(np.int32), z, np.zeros(0, bool)

        # Occurrence lookup: contiguous [lo, hi) slice per query syncmer.
        lo = np.searchsorted(self.occ_ids, ids, side="left")
        hi = np.searchsorted(self.occ_ids, ids, side="right")
        counts = hi - lo

        # Seed-frequency filter (reference SyngSeedFilter): drop the most
        # frequent `drop_top_fraction` of the query's seeds, and optionally
        # seeds above an absolute occurrence cap.
        keep = counts > 0
        if ids.size and drop_top_fraction > 0:
            n_drop = int(np.ceil(ids.size * drop_top_fraction))
            if n_drop > 0:
                order = np.argsort(counts)
                cutoff_idx = order[-n_drop:]
                mask = np.ones(ids.size, bool)
                # Only drop seeds that are genuinely repetitive (count > 1).
                mask[cutoff_idx[counts[cutoff_idx] > 1]] = False
                keep &= mask
        if max_occurrences is not None:
            keep &= counts <= max_occurrences

        qsel = np.nonzero(keep)[0]
        if qsel.size == 0:
            z = np.zeros(0, np.int64)
            return z, z.astype(np.int32), z, np.zeros(0, bool)

        # Gather all occurrences of kept seeds (vectorized multi-slice
        # expansion: repeat each seed's slice start, add a within-slice
        # ramp — this sits on the hot path of every hop and mapped read).
        kept_counts = counts[qsel].astype(np.int64)
        total = int(kept_counts.sum())
        q_of_occ = np.repeat(qsel.astype(np.int64), kept_counts)
        out_off = np.zeros(qsel.size, np.int64)
        np.cumsum(kept_counts[:-1], out=out_off[1:])
        occ_idx = (
            np.arange(total, dtype=np.int64)
            - np.repeat(out_off, kept_counts)
            + np.repeat(lo[qsel].astype(np.int64), kept_counts)
        )

        o_seq = self.occ_seq[occ_idx]
        o_pos = self.occ_pos[occ_idx]
        o_fwd = self.occ_fwd[occ_idx]
        rel_fwd = o_fwd == fwd[q_of_occ]
        q_abs = positions[q_of_occ]

        qname_id = (
            self.seq_index.get_id(exclude_self) if exclude_self else None
        )
        if qname_id is not None:
            self_hit = (o_seq == qname_id) & (o_pos == q_abs)
            keep_occ = ~self_hit
            q_abs, o_seq, o_pos, rel_fwd = (
                q_abs[keep_occ],
                o_seq[keep_occ],
                o_pos[keep_occ],
                rel_fwd[keep_occ],
            )
        return q_abs, o_seq, o_pos, rel_fwd
