"""Read-syncmer inverted index (reference: main.rs:1482-1882 `impg
read-index`): per-read syncmers -> sorted (syncmer id -> read ordinals)
occurrence table, enabling read-link lookups (which reads share a syncmer)
for inference read-link rewards.

Artifact: `.readidx` npz — sorted unique syncmer ids, per-id offsets into a
flat read-ordinal array, and the read-name table.

The port's copy of impg_tpu/syng/read_index.py (tests/test_torch_syng_tools.py
holds the two equal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.ops import syncmer as syncmer_mod
from impg_tpu_torch.syng.pack import read_sequences

READ_INDEX_SUFFIX = ".readidx"


@dataclass
class ReadSyncmerIndex:
    ids: np.ndarray  # uint64, sorted unique syncmer ids
    offsets: np.ndarray  # int64 [n_ids + 1]
    read_ordinals: np.ndarray  # int32, flat
    read_names: list[str]
    k: int
    w: int
    seed: int

    @classmethod
    def build(
        cls,
        read_files: list[str],
        k: int = syncmer_mod.DEFAULT_K,
        w: int = syncmer_mod.DEFAULT_W,
        seed: int = syncmer_mod.DEFAULT_SEED,
    ) -> "ReadSyncmerIndex":
        names: list[str] = []
        id_parts: list[np.ndarray] = []
        ord_parts: list[np.ndarray] = []
        for path in read_files:
            for name, seq in read_sequences(path):
                ordinal = len(names)
                names.append(name)
                _pos, ids, _fwd = syncmer_mod.extract_syncmers(seq, k, w, seed)
                if ids.size:
                    # One entry per distinct syncmer per read.
                    uniq = np.unique(ids)
                    id_parts.append(uniq)
                    ord_parts.append(np.full(uniq.size, ordinal, np.int32))
        if id_parts:
            all_ids = np.concatenate(id_parts)
            all_ords = np.concatenate(ord_parts)
            order = np.lexsort((all_ords, all_ids))
            all_ids, all_ords = all_ids[order], all_ords[order]
            uniq_ids, starts = np.unique(all_ids, return_index=True)
            offsets = np.concatenate([starts, [all_ids.size]]).astype(np.int64)
        else:
            uniq_ids = np.zeros(0, np.uint64)
            offsets = np.zeros(1, np.int64)
            all_ords = np.zeros(0, np.int32)
        return cls(
            ids=uniq_ids,
            offsets=offsets,
            read_ordinals=all_ords,
            read_names=names,
            k=k,
            w=w,
            seed=seed,
        )

    def reads_with(self, syncmer_id: int) -> np.ndarray:
        i = int(np.searchsorted(self.ids, np.uint64(syncmer_id)))
        if i >= self.ids.size or self.ids[i] != np.uint64(syncmer_id):
            return np.zeros(0, np.int32)
        return self.read_ordinals[self.offsets[i] : self.offsets[i + 1]]

    def linking_reads(self, id_a: int, id_b: int) -> np.ndarray:
        """Read ordinals containing BOTH syncmers (read-link evidence)."""
        return np.intersect1d(self.reads_with(id_a), self.reads_with(id_b))

    def save(self, prefix: str) -> str:
        import os

        path = (
            prefix
            if prefix.endswith(READ_INDEX_SUFFIX)
            else prefix + READ_INDEX_SUFFIX
        )
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            ids=self.ids,
            offsets=self.offsets,
            read_ordinals=self.read_ordinals,
            read_names=np.array(self.read_names, dtype=str),
            params=np.array([self.k, self.w, self.seed], np.int64),
        )
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            os.replace(path + ".npz", path)
        return path

    @classmethod
    def load(cls, path: str) -> "ReadSyncmerIndex":
        if not path.endswith(READ_INDEX_SUFFIX):
            path = path + READ_INDEX_SUFFIX
        with np.load(path, allow_pickle=False) as z:
            k, w, seed = (int(x) for x in z["params"])
            return cls(
                ids=z["ids"],
                offsets=z["offsets"],
                read_ordinals=z["read_ordinals"],
                read_names=[str(n) for n in z["read_names"]],
                k=k,
                w=w,
                seed=seed,
            )
