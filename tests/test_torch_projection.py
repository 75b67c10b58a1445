"""Port's plain-torch project_batch vs the JAX package's project_batch under
jax.numpy and numpy, on the same lanes.  Integer outputs: exact equality."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from impg_tpu.ops import projection
from impg_tpu_torch.ops import projection as tproj
from tests import datagen, pyref
from tests.test_projection import build_from_paf_text
from tests.test_reference_golden import PROJECTION_VECTORS, _directed_from_record


def _lanes_random(seed):
    """Every directed record of a random PAF x 12 ranges around its span."""
    rng = random.Random(seed)
    text, _, _ = datagen.random_paf(rng, n_seqs=5, n_alns=40, n_ops=15)
    _, _, records, arena = build_from_paf_text(text)
    ks, s, e = [], [], []
    for k in range(len(records)):
        t0, te = int(records.t_start[k]), int(records.t_end[k])
        for _ in range(12):
            a = rng.randint(max(0, t0 - 30), te + 30)
            b = rng.randint(max(0, t0 - 30), te + 30)
            ks.append(k)
            s.append(min(a, b))
            e.append(max(a, b) + (a == b))
    return records, arena, np.array(ks), np.array(s), np.array(e)


def _lanes_exhaustive(ops, strand):
    """Every range over one record whose CIGAR has I/D runs on both ends."""
    parsed = pyref.parse_cigar(ops)
    t_len = sum(l for l, o in parsed if o in "=XMD")
    q_len = sum(l for l, o in parsed if o in "=XMI")
    line = datagen.make_paf_line(
        "q", 100, 5, 5 + q_len, strand, "t", 100, 7, 7 + t_len, parsed
    )
    _, _, records, arena = build_from_paf_text(line + "\n")
    ks, s, e = [], [], []
    for k in range(len(records)):
        t0, te = int(records.t_start[k]), int(records.t_end[k])
        for a in range(max(0, t0 - 2), te + 2):
            for b in range(a + 1, te + 3):
                ks.append(k)
                s.append(a)
                e.append(b)
    return records, arena, np.array(ks), np.array(s), np.array(e)


def _lanes_golden():
    """The reference's literal projection vectors, one record each."""
    out = []
    for _name, rng, record, ops, _exp in PROJECTION_VECTORS:
        records, arena = _directed_from_record(record, ops)
        out.append((records, arena, np.array([0]), np.array([rng[0]]),
                    np.array([rng[1]])))
    return out


def _compare(records, arena, ks, s, e, with_stats):
    kw = arena.projection_kwargs(with_stats=with_stats)
    lane = dict(
        op_off=records.op_off[ks], op_cnt=records.op_cnt[ks],
        t_start=records.t_start[ks], t_end=records.t_end[ks],
        strand=records.strand[ks],
        range_start=s.astype(np.int32), range_end=e.astype(np.int32),
    )
    iters = max(1, int(np.ceil(np.log2(int(records.op_cnt.max()) + 1))))
    ref_np = projection.project_batch(
        np, **kw, **lane, search_iters=iters, with_stats=with_stats
    )
    ref_jax = projection.project_batch(
        jnp, **{k: jnp.asarray(v) for k, v in kw.items()},
        **{k: jnp.asarray(np.asarray(v, np.int32)) for k, v in lane.items()},
        search_iters=iters, with_stats=with_stats,
    )
    got = tproj.project_batch(
        **{k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)
                               if v.dtype == np.uint32
                               else np.ascontiguousarray(v, np.int32))
           for k, v in kw.items()},
        **{k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
           for k, v in lane.items()},
        search_iters=iters, with_stats=with_stats,
    )
    assert got._fields == ref_np._fields
    for field in got._fields:
        g = getattr(got, field).numpy()
        assert g.dtype == (bool if field == "valid" else np.int32), field
        assert np.array_equal(g, np.asarray(getattr(ref_jax, field))), field
        assert np.array_equal(g, np.asarray(getattr(ref_np, field))), field
    return int(got.valid.sum())


@pytest.mark.parametrize("with_stats", [True, False])
def test_projection_random_lanes(with_stats):
    assert _compare(*_lanes_random(7), with_stats) > 100


@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize(
    "ops,strand", [("5=3I10D2X4I10=3D", "+"), ("4=2I3D5X1I6M", "-")]
)
def test_projection_edge_runs_both_strands(ops, strand, with_stats):
    assert _compare(*_lanes_exhaustive(ops, strand), with_stats) > 50


@pytest.mark.parametrize("with_stats", [True, False])
def test_projection_golden_vectors(with_stats):
    for case in _lanes_golden():
        assert _compare(*case, with_stats) == 1


def test_bisect_lower_bound():
    n = torch.tensor([0, 1, 5, 8], dtype=torch.int32)
    thresh = torch.tensor([3, 0, 3, 9], dtype=torch.int32)
    got = tproj._bisect(n, lambda m: m >= thresh, 4)
    assert got.tolist() == [0, 0, 3, 8]
