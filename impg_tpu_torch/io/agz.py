"""AGC-role compressed sequence archive (.agz): create, list, range-fetch.

The port's copy of impg_tpu/io/agz.py: `AgzArchive`, the reader
(tests/test_torch_sequence.py holds it equal to impg_tpu's), and
`create_agz`, the writer of `agz create` (tests/test_torch_gfa_tools.py
holds its archives equal to impg_tpu's byte for byte: zlib blocks and a
JSON directory, no time field).

Role model: the reference's AGC backend (agc_index.rs:9 AgcIndex over the
ragc crate): multi-sample archives addressed as ``contig@sample`` (or bare
contig when unique), listing samples/contigs, O(1) length lookup, and
random-access range fetch without decompressing whole contigs.

Layout: one ``.agz`` file = 8-byte magic/version, each contig's sequence as
independently zlib-compressed fixed-size blocks, then a zlib-compressed
JSON directory (samples -> contigs -> block table) whose offset and size
the last 16 bytes give; a range fetch decompresses only the covering
blocks.

Addressing mirrors agc_index.rs:142 parse_query: ``contig@sample`` exact,
bare contig when unambiguous, and whitespace-truncated short contig names.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

MAGIC = b"IAGZ\x01\x00\x00\x00"
BLOCK_RAW = 1 << 18  # 256 KiB of raw sequence per compressed block


class AgzArchive:
    """Open archive with AGC-style addressing + block-random-access fetch."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        head = self._fh.read(8)
        if head != MAGIC:
            raise ValueError(f"{path}: not an .agz archive")
        self._fh.seek(-16, io.SEEK_END)
        footer_off, footer_len = struct.unpack("<QQ", self._fh.read(16))
        self._fh.seek(footer_off)
        directory = json.loads(zlib.decompress(self._fh.read(footer_len)))
        self.block_raw = int(directory.get("block_raw", BLOCK_RAW))
        self._samples: dict[str, dict] = directory["samples"]
        # contig@sample exact; bare contig + short contig when unique
        # (agc_index.rs:94-120 interning).
        self._exact: dict[str, tuple[str, str] | None] = {}
        # Bare contig resolution is only valid when unique across samples
        # (agc_index.rs parse_query); ambiguous names — bare OR
        # short@sample when two contigs in one sample share a
        # whitespace-truncated short name — map to None and raise at
        # lookup instead of silently picking the first.
        self._bare: dict[str, tuple[str, str] | None] = {}

        def note(table: dict, key: str, val: tuple[str, str]) -> None:
            cur = table.get(key, val)
            table[key] = val if cur == val else None

        for sample, contigs in self._samples.items():
            for contig in contigs:
                note(self._bare, contig, (sample, contig))
                short = contig.split()[0] if contig.split() else contig
                if short != contig:
                    note(self._exact, f"{short}@{sample}",
                         (sample, contig))
                    note(self._bare, short, (sample, contig))
        for sample, contigs in self._samples.items():
            for contig in contigs:  # full names win over short aliases
                self._exact[f"{contig}@{sample}"] = (sample, contig)

    def close(self) -> None:
        self._fh.close()

    # ---- listing ---------------------------------------------------------

    def list_samples(self) -> list[str]:
        return list(self._samples)

    def list_contigs(self, sample: str) -> list[str]:
        return list(self._samples.get(sample, {}))

    def sequence_names(self):
        for sample, contigs in self._samples.items():
            for contig in contigs:
                yield f"{contig}@{sample}"

    # ---- access ----------------------------------------------------------

    def _resolve(self, name: str) -> tuple[str, str]:
        for table, how in ((self._exact, "as a short name within the "
                            "sample — use the full contig name"),
                           (self._bare, "present in multiple samples — "
                            "use contig@sample")):
            if name in table:
                hit = table[name]
                if hit is None:
                    raise KeyError(f"sequence '{name}' is ambiguous in "
                                   f"{self.path} ({how})")
                return hit
        raise KeyError(f"sequence '{name}' not found in {self.path}")

    def get_sequence_length(self, name: str) -> int:
        sample, contig = self._resolve(name)
        return int(self._samples[sample][contig]["length"])

    def fetch_sequence(self, name: str, start: int, end: int) -> bytes:
        sample, contig = self._resolve(name)
        meta = self._samples[sample][contig]
        length = int(meta["length"])
        start = max(0, min(start, length))
        end = max(start, min(end, length))
        if start == end:
            return b""
        first = start // self.block_raw
        last = (end - 1) // self.block_raw
        parts = []
        for b in range(first, last + 1):
            off, clen = meta["blocks"][b]
            self._fh.seek(off)
            parts.append(zlib.decompress(self._fh.read(clen)))
        raw = b"".join(parts)
        lo = start - first * self.block_raw
        return raw[lo : lo + (end - start)]


def create_agz(
    out_path: str,
    fasta_files: list[str],
    sample_names: list[str] | None = None,
    block_raw: int = BLOCK_RAW,
) -> dict:
    """Create an archive from FASTA files (one sample per file, like
    `agc create`; sample name defaults to the file stem)."""
    from impg_tpu_torch.syng.pack import read_sequences

    if sample_names is None:
        sample_names = []
        for f in fasta_files:
            base = os.path.basename(f)
            for suf in (".gz", ".fa", ".fasta", ".fna"):
                if base.endswith(suf):
                    base = base[: -len(suf)]
            sample_names.append(base)
    # Two FASTAs may share a basename stem (same name, different dirs):
    # writing both under one sample key would orphan the first file's
    # blocks silently. Refuse up front.
    dupes = {s for s in sample_names if sample_names.count(s) > 1}
    if dupes:
        raise ValueError(
            "duplicate sample name(s) in agz create: "
            + ", ".join(sorted(dupes))
            + " — pass explicit sample_names to disambiguate"
        )
    if len(sample_names) != len(fasta_files):
        raise ValueError(
            f"sample_names has {len(sample_names)} entries for "
            f"{len(fasta_files)} FASTA files"
        )
    directory: dict = {"samples": {}}
    n_contigs = 0
    with open(out_path, "wb") as fh:
        fh.write(MAGIC)
        for f, sample in zip(fasta_files, sample_names):
            contigs = {}
            for name, seq in read_sequences(f):
                if name in contigs:
                    # Overwriting would orphan the first contig's blocks
                    # silently (names are whitespace-truncated, so
                    # '>chr1 foo' and '>chr1 bar' collide).
                    raise ValueError(
                        f"{f}: duplicate contig name '{name}' within "
                        f"sample '{sample}'"
                    )
                blocks = []
                for off in range(0, max(len(seq), 1), block_raw):
                    raw = seq[off : off + block_raw]
                    comp = zlib.compress(raw, 6)
                    blocks.append([fh.tell(), len(comp)])
                    fh.write(comp)
                contigs[name] = {"length": len(seq), "blocks": blocks}
                n_contigs += 1
            directory["samples"][sample] = contigs
        directory["block_raw"] = block_raw
        footer = zlib.compress(
            json.dumps(directory, separators=(",", ":")).encode(), 6
        )
        footer_off = fh.tell()
        fh.write(footer)
        fh.write(struct.pack("<QQ", footer_off, len(footer)))
    return {"samples": len(sample_names), "contigs": n_contigs}

