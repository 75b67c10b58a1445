"""Columnar GFA: struct-of-arrays graph tensors behind a native tokenizer.

The port's copy of impg_tpu/graph/gfa_columns.py's `GfaColumns`,
`parse_gfa_columns` and `_names_from_blob`: one interned name
table, segment sequences as a single blob + offsets, links as
index/orientation arrays, paths as CSR step arrays, tokenized by the port's
copy of native/gfa_parser.cpp (tests/test_torch_sortgfa.py holds the columns
equal to impg_tpu's).  `report_columns` and its helpers belong to
`graph-report`'s slice, and `to_gfa` (the dict model) to the slices that
work on it; neither is ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np

@dataclass
class GfaColumns:
    header: str
    names: list[str]  # interned name table (segments/links/steps)
    seg_name_idx: np.ndarray  # int32 [n_segs]
    seq_blob: bytes
    seq_offsets: np.ndarray  # int64 [n_segs + 1]
    link_a: np.ndarray  # int32 into names
    link_a_rev: np.ndarray  # bool
    link_b: np.ndarray
    link_b_rev: np.ndarray
    path_names: list[str]
    path_is_walk: np.ndarray  # bool
    path_off: np.ndarray  # int64 [n_paths + 1]
    step_name_idx: np.ndarray  # int32
    step_rev: np.ndarray  # bool
    _seg_row_of_name: np.ndarray | None = field(default=None, repr=False)

    @classmethod
    def from_arrays(cls, cols: dict) -> "GfaColumns":
        """Columns from a dict of the public fields' values (for example
        `vars()` of another implementation's columns of the same graph):
        arrays are copied, so the result shares no buffer with `cols`."""
        kw = {}
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            v = cols[f.name]
            kw[f.name] = (np.array(v, copy=True) if isinstance(v, np.ndarray)
                          else list(v) if isinstance(v, list) else v)
        return cls(**kw)

    @property
    def n_segs(self) -> int:
        return int(self.seg_name_idx.size)

    @property
    def n_paths(self) -> int:
        return int(self.path_off.size - 1)

    def seg_lens(self) -> np.ndarray:
        return np.diff(self.seq_offsets)

    def seg_row_of_name(self) -> np.ndarray:
        """name idx -> segment row (-1 when the name has no S line; the
        LAST S line wins on duplicates, like the dict model)."""
        if self._seg_row_of_name is None:
            rows = np.full(len(self.names), -1, np.int64)
            rows[self.seg_name_idx] = np.arange(self.n_segs)
            self._seg_row_of_name = rows
        return self._seg_row_of_name


def _names_from_blob(blob: bytes, offsets: np.ndarray) -> list[str]:
    offs = offsets.tolist()
    if blob.isascii():
        # Byte offsets == char offsets: decode once, slice the str.
        text = blob.decode()
        return [text[offs[i]: offs[i + 1]] for i in range(len(offs) - 1)]
    # Non-ASCII names: offsets are BYTE positions — slice bytes, decode each.
    return [
        blob[offs[i]: offs[i + 1]].decode() for i in range(len(offs) - 1)
    ]


def parse_gfa_columns(text) -> GfaColumns:
    """Tokenize GFA text/bytes into GfaColumns via the native parser
    (RuntimeError when the native library did not build)."""
    from impg_tpu_torch.io import native as native_mod

    data = text.encode() if isinstance(text, str) else text
    # Zero-copy views over the native buffers (each array's base chain
    # owns the handle); the 0/1 int8 flag columns reinterpret as bool
    # without a copy.
    cols = native_mod.parse_gfa_native(data)
    return GfaColumns(
        header=cols["header"],
        names=_names_from_blob(cols["names_blob"], cols["name_offsets"]),
        seg_name_idx=cols["seg_name_idx"],
        seq_blob=cols["seq_blob"],
        seq_offsets=cols["seq_offsets"],
        link_a=cols["link_a"],
        link_a_rev=cols["link_a_rev"].view(np.bool_),
        link_b=cols["link_b"],
        link_b_rev=cols["link_b_rev"].view(np.bool_),
        path_names=_names_from_blob(
            cols["path_names_blob"], cols["path_name_offsets"]
        ),
        path_is_walk=cols["path_is_walk"].view(np.bool_),
        path_off=cols["path_off"],
        step_name_idx=cols["step_name_idx"],
        step_rev=cols["step_rev"].view(np.bool_),
    )
