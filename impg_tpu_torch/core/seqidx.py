"""Bidirectional sequence-name <-> id index with lengths.

The port's copy of impg_tpu/core/seqidx.py
(tests/test_torch_host.py holds the two equal).

Capability parity with the reference's SequenceIndex (seqidx.rs:5-56): interned
u32 ids in insertion order, name lookup both ways, and per-sequence lengths.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


class SequenceIndex:
    def __init__(self) -> None:
        self._name_to_id: dict[str, int] = {}
        self._names: list[str] = []
        self._lengths: list[int] = []

    def get_or_insert_id(self, name: str, length: Optional[int] = None) -> int:
        sid = self._name_to_id.get(name)
        if sid is None:
            sid = len(self._names)
            self._name_to_id[name] = sid
            self._names.append(name)
            self._lengths.append(length if length is not None else 0)
        elif length is not None and self._lengths[sid] == 0:
            self._lengths[sid] = length
        return sid

    def get_id(self, name: str) -> Optional[int]:
        return self._name_to_id.get(name)

    def get_name(self, sid: int) -> Optional[str]:
        if 0 <= sid < len(self._names):
            return self._names[sid]
        return None

    def get_len_from_id(self, sid: int) -> Optional[int]:
        if 0 <= sid < len(self._lengths):
            return self._lengths[sid]
        return None

    def __len__(self) -> int:
        return len(self._names)

    def names(self) -> Iterable[str]:
        return iter(self._names)

    def lengths_array(self) -> np.ndarray:
        return np.asarray(self._lengths, dtype=np.int64)

    # ── serialization ────────────────────────────────────────────────
    def to_arrays(self):
        names = np.array(self._names, dtype=object)
        lengths = np.asarray(self._lengths, dtype=np.int64)
        return names, lengths

    @classmethod
    def from_lists(cls, names, lengths) -> "SequenceIndex":
        idx = cls()
        for name, length in zip(names, lengths):
            idx.get_or_insert_id(str(name), int(length))
        return idx
