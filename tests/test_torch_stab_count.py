"""Port's stab-count wrapper (plain twin on CPU tensors) vs the JAX Pallas
kernel in interpret mode and the numpy oracle.  Integer outputs: exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from impg_tpu.ops import pallas_stab as ps
from impg_tpu_torch.ops import stab_count as sc


def _case(seed, n, b, tid_neg=False):
    rng = np.random.default_rng(seed)
    rec_tid = rng.integers(0, 8, n).astype(np.int32)
    rec_ts = rng.integers(0, 50_000, n).astype(np.int32)
    rec_te = (rec_ts + rng.integers(1, 3000, n)).astype(np.int32)
    q_tid = rng.integers(-1 if tid_neg else 0, 8, b).astype(np.int32)
    q_s = rng.integers(0, 50_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(1, 10_000, b)).astype(np.int32)
    return rec_tid, rec_ts, rec_te, q_tid, q_s, q_e


@pytest.mark.parametrize(
    "seed,n,b,tid_neg",
    [
        (3, 4000, 300, False),  # ragged N (not a tile multiple), B = 300
        (4, 1030, 1, False),  # one query, N just past one tile
        (5, 2500, 64, True),  # tid = -1 queries
        (6, 0, 16, False),  # empty record set
        (7, 1024, 300, True),  # exactly one tile
    ],
)
def test_stab_counts_match_pallas_and_oracle(seed, n, b, tid_neg):
    arrays = _case(seed, n, b, tid_neg)
    rec_tid, rec_ts, rec_te, q_tid, q_s, q_e = arrays
    got = sc.stab_counts(*(torch.from_numpy(a) for a in arrays)).numpy()
    padded = ps.pad_records(rec_tid, rec_ts, rec_te)
    pallas = np.asarray(
        ps.stab_counts(
            *(jnp.asarray(a) for a in padded),
            jnp.asarray(q_tid), jnp.asarray(q_s), jnp.asarray(q_e),
            interpret=True,
        )
    )
    oracle = ps.stab_counts_host(*arrays)
    assert got.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, oracle)
    if n:
        assert oracle.sum() > 0
    if tid_neg:
        assert np.all(got[q_tid < 0] == 0)


def test_pad_records_matches_jax_layout():
    rec_tid, rec_ts, rec_te, *_ = _case(8, 1500, 1)
    got = sc.pad_records(*(torch.from_numpy(a) for a in (rec_tid, rec_ts, rec_te)))
    exp = ps.pad_records(rec_tid, rec_ts, rec_te)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), e)


def test_stab_counts_rejects_bad_inputs():
    arrays = [torch.from_numpy(a) for a in _case(9, 100, 4)]
    with pytest.raises(ValueError):
        sc.stab_counts(arrays[0].long(), *arrays[1:])
    with pytest.raises(ValueError):
        sc.stab_counts(*arrays[:5], arrays[5][:2])
