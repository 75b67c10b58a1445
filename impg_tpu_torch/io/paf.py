"""PAF ingestion into struct-of-array tensors.

The port's copy of impg_tpu/io/paf.py
(tests/test_torch_host.py holds the two equal).

Capability parity with the reference PAF parser (paf.rs:118-416): 12 mandatory
fields, strand, and the cg:Z: CIGAR tag.  Unlike the reference — which records
only the byte offset of the CIGAR and lazily re-reads it per projection — we
decode every CIGAR once into the packed run arena (see core/arena.py).

Compressed input: .gz/.bgz files are decompressed on ingest (BGZF is valid
multi-member gzip, so Python's gzip module reads both).  Since runs become
resident tensors there is no need for virtual-offset random access.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.seqidx import SequenceIndex


@dataclass
class PafRecords:
    """Parsed undirected alignment records (SoA) + packed CIGAR runs."""

    query_id: np.ndarray  # int32
    q_start: np.ndarray  # int32
    q_end: np.ndarray  # int32
    target_id: np.ndarray  # int32
    t_start: np.ndarray  # int32
    t_end: np.ndarray  # int32
    strand: np.ndarray  # int8 (0 '+', 1 '-')
    runs: np.ndarray  # uint32 packed CIGAR runs, concatenated
    run_offsets: np.ndarray  # int64 [n+1]

    def __len__(self) -> int:
        return self.query_id.size


def _read_bytes(path: str) -> bytes:
    if path.endswith((".gz", ".bgz")):
        with gzip.open(path, "rb") as fh:
            return fh.read()
    with open(path, "rb") as fh:
        return fh.read()


def parse_paf_file(
    path: str, seq_index: SequenceIndex, require_cigar: bool = True
) -> PafRecords:
    """Parse one PAF file, interning names into `seq_index`."""
    data = _read_bytes(path)
    return parse_paf_bytes(data, seq_index, require_cigar=require_cigar, path=path)


def parse_paf_bytes(
    data: bytes,
    seq_index: SequenceIndex,
    require_cigar: bool = True,
    path: str = "<memory>",
    use_native: bool = True,
) -> PafRecords:
    if use_native:
        try:
            from impg_tpu_torch.io import native

            cols = native.parse_paf_bytes_native(data, require_cigar)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
        if cols is not None:
            # Map file-local interned name ids to the global SequenceIndex.
            local_to_global = np.array(
                [
                    seq_index.get_or_insert_id(name, int(length))
                    for name, length in zip(cols["names"], cols["name_lengths"])
                ],
                dtype=np.int32,
            )
            n = cols["q_start"].size
            return PafRecords(
                query_id=local_to_global[cols["query_name_idx"]]
                if n
                else np.zeros(0, np.int32),
                q_start=cols["q_start"],
                q_end=cols["q_end"],
                target_id=local_to_global[cols["target_name_idx"]]
                if n
                else np.zeros(0, np.int32),
                t_start=cols["t_start"],
                t_end=cols["t_end"],
                strand=cols["strand"],
                runs=cols["runs"],
                run_offsets=cols["run_offsets"],
            )
    return _parse_paf_bytes_py(data, seq_index, require_cigar, path)


def _parse_paf_bytes_py(
    data: bytes,
    seq_index: SequenceIndex,
    require_cigar: bool = True,
    path: str = "<memory>",
) -> PafRecords:
    q_ids: list[int] = []
    q_starts: list[int] = []
    q_ends: list[int] = []
    t_ids: list[int] = []
    t_starts: list[int] = []
    t_ends: list[int] = []
    strands: list[int] = []
    cigar_parts: list[bytes] = []
    cigar_lens: list[int] = []

    for lineno, line in enumerate(data.split(b"\n"), 1):
        if not line or line.startswith(b"#"):
            continue
        fields = line.rstrip(b"\r").split(b"\t")
        if len(fields) < 12:
            raise ValueError(f"{path}:{lineno}: PAF record has <12 fields")
        try:
            q_len = int(fields[1])
            q_start = int(fields[2])
            q_end = int(fields[3])
            t_len = int(fields[6])
            t_start = int(fields[7])
            t_end = int(fields[8])
        except ValueError as e:
            raise ValueError(f"{path}:{lineno}: invalid integer field: {e}") from e
        strand_f = fields[4]
        if strand_f == b"+":
            strand = 0
        elif strand_f == b"-":
            strand = 1
        else:
            raise ValueError(f"{path}:{lineno}: invalid strand {strand_f!r}")

        q_id = seq_index.get_or_insert_id(fields[0].decode(), q_len)
        t_id = seq_index.get_or_insert_id(fields[5].decode(), t_len)

        cg = b""
        for tag in fields[12:]:
            if tag.startswith(b"cg:Z:"):
                cg = tag[5:]
                break
        if require_cigar and not cg:
            raise ValueError(
                f"{path}:{lineno}: alignment record lacks a 'cg:Z:' CIGAR tag"
            )

        q_ids.append(q_id)
        q_starts.append(q_start)
        q_ends.append(q_end)
        t_ids.append(t_id)
        t_starts.append(t_start)
        t_ends.append(t_end)
        strands.append(strand)
        cigar_parts.append(cg)
        cigar_lens.append(len(cg))

    buf = np.frombuffer(b"".join(cigar_parts), dtype=np.uint8)
    str_offsets = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(np.asarray(cigar_lens, np.int64))]
    )
    runs, run_offsets = cigar.parse_concat(buf, str_offsets)

    return PafRecords(
        query_id=np.asarray(q_ids, np.int32),
        q_start=np.asarray(q_starts, np.int32),
        q_end=np.asarray(q_ends, np.int32),
        target_id=np.asarray(t_ids, np.int32),
        t_start=np.asarray(t_starts, np.int32),
        t_end=np.asarray(t_ends, np.int32),
        strand=np.asarray(strands, np.int8),
        runs=runs,
        run_offsets=run_offsets,
    )
