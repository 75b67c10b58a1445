"""The port's at-scale index generator equals tests/datagen.py's."""

import numpy as np
import pytest

from impg_tpu_torch.synth import realistic_directed_index as port_gen
from tests.datagen import realistic_directed_index as ref_gen


def _arrays(obj) -> dict:
    return {k: v for k, v in vars(obj).items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize(
    "kw",
    [
        dict(seed=5, n_seqs=30, seq_len=20_000, n_aln=300, chunks=3),
        dict(seed=3, n_seqs=7, seq_len=9_000, n_aln=41, chunks=4,
             tail_frac=0.5),
    ],
    ids=["small", "ragged-chunks"],
)
def test_synth_index_equals_datagen(kw):
    got, ref = port_gen(**kw), ref_gen(**kw)
    for part in ("records", "arena"):
        a, b = _arrays(getattr(got, part)), _arrays(getattr(ref, part))
        assert a.keys() == b.keys() and a, part
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{part}.{k}")
    np.testing.assert_array_equal(got.tgt_offsets, ref.tgt_offsets)
    assert [got.seq_index.get_name(i) for i in range(kw["n_seqs"])] == [
        ref.seq_index.get_name(i) for i in range(kw["n_seqs"])
    ]
