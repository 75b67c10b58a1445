"""Approximate (tracepoint) projection in the port against the JAX package
on the CPU: the plain twin of K-E (ops/approx.py) against
`_project_approx_device`, the engine's approximate stream against the JAX
DeviceEngine built with tracepoints (windowed and slotted), the approximate
transitive BFS against the JAX device engine and the host engine, and the
CLI's `query -x --approximate` output.  Every value is an integer:
tolerance 0 everywhere."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.query import engine
from impg_tpu.query.device import DeviceEngine, DeviceIndex
from impg_tpu.query.device import _project_approx_device
from impg_tpu_torch import kernels
from impg_tpu_torch.ops import approx
from impg_tpu_torch.query import device as tdev
from tests import datagen
from tests.test_query import index_from_text

APPROX_KEYS = ("valid", "pq_start", "pq_end", "pt_start", "pt_end", "matches",
               "mismatches")
BLOCK_COLUMNS = ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")


def _chain_index():
    """The chain pangenome with every other alignment on the reverse strand
    (projection reads CIGARs and coordinates only, so the flipped lines are
    alignments of the same shape)."""
    text, _, _ = datagen.mutate_chain_paf(random.Random(77), n_seqs=4,
                                          seq_len=6000)
    lines = text.splitlines()
    for i in range(1, len(lines), 2):
        cols = lines[i].split("\t")
        cols[4] = "-"
        lines[i] = "\t".join(cols)
    return index_from_text("\n".join(lines) + "\n")


def _pan_index():
    text, _, _ = datagen.pangenome_paf(random.Random(13), n_seqs=10,
                                       seq_len=20_000, cross_links=4)
    return index_from_text(text)


@pytest.fixture(scope="module", params=["chain", "pangenome"])
def index(request):
    idx = _chain_index() if request.param == "chain" else _pan_index()
    idx.ensure_tracepoints(100)
    return idx


@pytest.fixture(scope="module")
def jax_tp(index):
    d = DeviceIndex.build(index, with_tracepoints=True, stats=False)
    return d.tp, d.tp_spacing


@pytest.fixture(scope="module")
def port(index):
    return tdev.TorchDeviceEngine(index, device="cpu", with_tracepoints=True)


def _half_even_lanes(index, n_rec: int, rng):
    """(rec, rng_s) lanes whose start offset lands exactly half way between
    two query positions (2 * r2 == t), with the parity of the floored
    offset of each, found by trying every offset of random segments."""
    tp = index.tp
    r = index.records
    recs, starts, parity = [], [], []
    for rec in rng.choice(len(r), min(n_rec, len(r)), replace=False):
        ts, te = int(r.t_start[rec]), int(r.t_end[rec])
        off, nseg = int(tp.seg_off[rec]), int(tp.n_seg[rec])
        for i in range(nseg):
            seg_s = min(ts + i * tp.spacing, te)
            t = min(ts + (i + 1) * tp.spacing, te) - seg_s
            mag = abs(int(tp.q_bound[off + i + 1]) - int(tp.q_bound[off + i]))
            for od in range(1, t):
                if 2 * ((mag % t) * od % t) == t:
                    recs.append(rec)
                    starts.append(seg_s + od)
                    parity.append((mag // t * od + (mag % t) * od // t) & 1)
    return np.asarray(recs), np.asarray(starts), np.asarray(parity)


def _compare(tp_j, spacing, tp_t, rec, r_ts, r_te, rng_s, rng_e):
    ref = _project_approx_device(
        tp_j, spacing, jnp.asarray(rec.astype(np.int32)),
        *(jnp.asarray(a.astype(np.int32)) for a in (r_ts, r_te, rng_s, rng_e))
    )
    got = approx.project_approx(
        tp_t, spacing, torch.from_numpy(rec.astype(np.int64)),
        *(torch.from_numpy(a.astype(np.int32)) for a in
          (r_ts, r_te, rng_s, rng_e))
    )
    for key in APPROX_KEYS:
        g = got[key].numpy()
        assert g.dtype == (bool if key == "valid" else np.int32), key
        assert np.array_equal(g, np.asarray(ref[key])), key
    return got


@pytest.mark.parametrize("clip_overlap", [False, True])
def test_twin_matches_jax_on_index_lanes(index, jax_tp, port, clip_overlap):
    tp_j, spacing = jax_tp
    r = index.records
    rng = np.random.default_rng(5)
    # Random lanes over random records: ranges inside, across and outside.
    n = 4000
    rec = rng.integers(0, len(r), n)
    r_ts = r.t_start[rec].astype(np.int64)
    r_te = r.t_end[rec].astype(np.int64)
    span = r_te - r_ts
    rng_s = r_ts + rng.integers(-200, 1, n) + (rng.random(n) * span).astype(
        np.int64)
    rng_e = rng_s + rng.integers(-5, 3000, n)
    # Lanes whose start offset rounds half to even, both parities.
    h_rec, h_s, parity = _half_even_lanes(index, 40, rng)
    assert (parity == 0).any() and (parity == 1).any()
    rec = np.concatenate([rec, h_rec])
    rng_s = np.concatenate([rng_s, h_s])
    rng_e = np.concatenate([rng_e, r.t_end[h_rec]])
    r_ts = r.t_start[rec].astype(np.int64)
    r_te = r.t_end[rec].astype(np.int64)
    assert set(np.unique(r.strand[rec])) == {0, 1}
    if clip_overlap:
        rng_s, rng_e = np.maximum(rng_s, r_ts), np.minimum(rng_e, r_te)
    got = _compare(tp_j, spacing, port.dindex.tp, rec, r_ts, r_te, rng_s,
                   rng_e)
    assert int(got["valid"].sum()) > n // 2


def test_twin_matches_jax_on_synthetic_tracepoints():
    """Hand-made tracepoint columns: zero-span records (t_delta == 0 final
    segments), partial last segments, both walk directions and large
    per-segment query steps."""
    rng = np.random.default_rng(8)
    spacing = 64
    n_rec = 300
    length = np.where(rng.random(n_rec) < 0.15, 0,
                      rng.integers(1, 2000, n_rec))
    ts = rng.integers(0, 50_000, n_rec)
    te = ts + length
    n_seg = np.maximum(np.ceil(length / spacing).astype(np.int64), 1)
    seg_off = np.concatenate([[0], np.cumsum(n_seg + 1)])[:-1]
    total = int((n_seg + 1).sum())
    forward = rng.random(n_rec) < 0.5
    steps = rng.integers(0, 4 * spacing, total)
    q_bound = np.zeros(total, np.int64)
    pre_diffs = np.zeros(total, np.int64)
    pre_aligned = np.zeros(total, np.int64)
    q_start = np.zeros(n_rec, np.int64)
    q_end = np.zeros(n_rec, np.int64)
    for i in range(n_rec):
        sl = slice(seg_off[i], seg_off[i] + n_seg[i] + 1)
        walk = np.concatenate([[0], np.cumsum(steps[sl][1:])])
        base = int(rng.integers(0, 100_000))
        q_bound[sl] = base + walk if forward[i] else base + walk[-1] - walk
        q_start[i], q_end[i] = base, base + walk[-1]
        pre_diffs[sl] = np.cumsum(rng.integers(0, 5, walk.size))
        pre_aligned[sl] = np.cumsum(rng.integers(0, spacing, walk.size))
    tp = dict(seg_off=seg_off, n_seg=n_seg, q_bound=q_bound,
              pre_diffs=pre_diffs, pre_aligned=pre_aligned, q_start=q_start,
              q_end=q_end)
    tp32 = {k: v.astype(np.int32) for k, v in tp.items()}
    n = 5000
    rec = rng.integers(0, n_rec, n)
    rng_s = ts[rec] + rng.integers(-100, 2100, n)
    rng_e = rng_s + rng.integers(-3, 2100, n)
    got = _compare({k: jnp.asarray(v) for k, v in tp32.items()}, spacing,
                   {k: torch.from_numpy(v) for k, v in tp32.items()}, rec,
                   ts[rec], te[rec], rng_s, rng_e)
    assert got["valid"].any()


def test_tracepoints_upload_matches_jax(index, jax_tp, port):
    tp_j, spacing = jax_tp
    d = port.dindex
    assert d.tp_spacing == spacing == index.tp.spacing
    assert set(d.tp) == set(tdev.TorchDeviceIndex.TP_KEYS) == set(tp_j)
    r = index.records
    arrays = {k: getattr(r, k) for k in tdev.TorchDeviceIndex.RECORD_KEYS}
    arrays.update(tgt_offsets=index.tgt_offsets)
    carried = tdev.TorchDeviceIndex.from_arrays(
        arrays, "cpu", tp={k: np.asarray(v) for k, v in tp_j.items()},
        tp_spacing=spacing,
    )
    for up in (d, carried):
        for k, v in tp_j.items():
            assert up.tp[k].dtype == torch.int32, k
            assert np.array_equal(up.tp[k].numpy(), np.asarray(v)), k
    # Built with tracepoints, the index holds no CIGAR arena: the records'
    # 48 B and the boundaries' 12 B that the CLI's routing counts.
    built = tdev.TorchDeviceIndex.build(index, "cpu", with_tracepoints=True)
    assert not built.arena and not carried.arena
    n_bound = np.asarray(tp_j["q_bound"]).size
    assert built.nbytes() == carried.nbytes() == (
        n_bound * 12 + len(r) * 48 + index.tgt_offsets.size * 4
    )


def test_tracepoints_keep_the_index_spacing():
    """An index whose tracepoints were built at another spacing keeps them:
    no rebuild at the default."""
    index = _chain_index()
    tp = index.ensure_tracepoints(64)
    d = tdev.TorchDeviceIndex.build(index, "cpu", with_tracepoints=True)
    assert index.tp is tp and d.tp_spacing == 64
    assert np.array_equal(d.tp["q_bound"].numpy(), tp.q_bound)


def test_tracepoint_table_past_int32_is_refused(index):
    r = index.records
    arrays = {k: getattr(r, k) for k in tdev.TorchDeviceIndex.RECORD_KEYS}
    arrays.update(tgt_offsets=index.tgt_offsets,
                  **index.arena.projection_kwargs(with_stats=False))
    huge = np.broadcast_to(np.int32(0), (2**31,))  # zero-stride, no memory
    tp = dict.fromkeys(tdev.TorchDeviceIndex.TP_KEYS, np.zeros(1, np.int32))
    tp["q_bound"] = huge
    with pytest.raises(ValueError, match="tracepoint table too large"):
        tdev.TorchDeviceIndex.from_arrays(arrays, "cpu", tp=tp, tp_spacing=100)


def test_arena_past_int32_is_refused_at_upload(index):
    """A tracepoint index defers the arena; its upload keeps the int32
    ceiling."""
    d = tdev.TorchDeviceIndex.build(index, "cpu", with_tracepoints=True)
    huge = np.broadcast_to(np.int32(0), (2**31,))  # zero-stride, no memory
    with pytest.raises(ValueError, match="arena too large"):
        d.upload_arena({"runs": huge})
    assert not d.arena


@pytest.fixture(scope="module")
def queries(index):
    rng = np.random.default_rng(0)
    b = 150
    lens = np.asarray([index.seq_index.get_len_from_id(i)
                       for i in range(len(index.seq_index))])
    q_tid = rng.integers(0, len(index.seq_index), b).astype(np.int32)
    q_s = (rng.random(b) * (lens[q_tid] - 50)).astype(np.int32)
    q_e = (q_s + rng.integers(1, 4_000, b)).astype(np.int32)
    return q_tid, q_s, q_e


@pytest.mark.parametrize("slotted", [False, True], ids=["windowed", "slotted"])
@pytest.mark.parametrize("clip_overlap", [False, True])
@pytest.mark.parametrize(
    "fields", [None, engine.LEAN_FIELDS, engine.LEAN_STATS_FIELDS],
    ids=["all", "lean", "lean_stats"],
)
def test_approximate_stream_matches_jax(index, port, queries, slotted,
                                        clip_overlap, fields):
    jax_eng = DeviceEngine(index, with_tracepoints=True, slotted=slotted)
    ref = list(jax_eng.query_batch_stream(
        *queries, clip_overlap=clip_overlap, approximate=True, fields=fields
    ))
    got = list(port.query_batch_stream(
        *queries, clip_overlap=clip_overlap, approximate=True, fields=fields
    ))
    assert got and set(got[0]) == set(ref[0])
    for key in ref[0]:
        if key in ("k_needed", "n_hits"):
            continue
        g = np.concatenate([p[key] for p in got])
        assert np.array_equal(g, np.concatenate([p[key] for p in ref])), key
    total = sum(int(p["n_hits"]) for p in got)
    assert total == g.size > 50
    # Approximate mode never uploads the identity-stats arena.
    assert "cum_match" not in port.dindex.arena


def test_engine_contract_and_cpu_path(index, port, queries):
    assert port.supports_approximate is True
    lean = tdev.TorchDeviceEngine(index, device="cpu")
    assert lean.supports_approximate is False and lean.dindex.tp is None
    with pytest.raises(ValueError, match="with_tracepoints"):
        next(lean.query_batch_stream(*queries, approximate=True))
    tp_eng = tdev.TorchDeviceEngine(index, device="cpu", with_tracepoints=True)
    kernels.reset_launch_counts()
    assert list(tp_eng.query_batch_stream(*queries, approximate=True))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    # Approximate walks leave the CIGAR arena on the host; the first exact
    # stream (every field) uploads all of it, and equals the lean engine's.
    assert not tp_eng.dindex.arena
    for g, r in zip(tp_eng.query_batch_stream(*queries, clip_overlap=True),
                    lean.query_batch_stream(*queries, clip_overlap=True)):
        for key in tdev.RESULT_FIELDS:
            assert np.array_equal(g[key], r[key]), key
    assert set(tp_eng.dindex.arena) == set(tdev.TorchDeviceIndex.PROJECTION_CORE
                                           + tdev.TorchDeviceIndex.STATS_KEYS)


def _walk_targets(index, n: int, seed: int):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        tid = rng.randrange(len(index.seq_index))
        length = index.seq_index.get_len_from_id(tid)
        a = rng.randint(0, length // 2)
        out.append((tid, a, min(length, a + rng.randint(1500, 6000))))
    return out


@pytest.mark.parametrize("min_identity", [None, 0.97])
def test_approximate_bfs_matches_jax_and_host(index, port, min_identity):
    targets = _walk_targets(index, 6, 3)
    kw = dict(max_depth=3, approximate=True, min_identity=min_identity,
              columnar=True)
    jax_dev = engine.query_transitive_bfs_many(
        index, targets, device_engine=DeviceEngine(index,
                                                   with_tracepoints=True),
        **kw,
    )
    host = engine.query_transitive_bfs_many(index, targets, **kw)
    got = engine.query_transitive_bfs_many(index, targets,
                                           device_engine=port, **kw)
    total = 0
    for g, j, h in zip(got, jax_dev, host):
        total += len(g)
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(j, col)), col
            assert np.array_equal(getattr(g, col), getattr(h, col)), col
    assert total > 3 * len(targets)


@pytest.fixture(scope="module")
def cli_paf(tmp_path_factory):
    text, _, _ = datagen.mutate_chain_paf(random.Random(77), n_seqs=4,
                                          seq_len=6000)
    paf = tmp_path_factory.mktemp("torch_approx_cli") / "c.paf"
    paf.write_text(text)
    return str(paf)


@pytest.mark.parametrize("fmt", ["bed", "bedpe"])
def test_cli_approximate_matches_jax_device(cli_paf, capsys, monkeypatch,
                                            fmt):
    argv = ["query", "-a", cli_paf, "-r", "ref:500-4000", "-d", "100", "-x",
            "--approximate", "-o", fmt, "--compute-engine", "device"]
    capsys.readouterr()
    assert jax_cli.main(argv) == 0
    ref = capsys.readouterr().out
    seen = []
    original = tdev.TorchDeviceEngine.query_batch_stream

    def spy(self, *a, **kw):
        seen.append(kw.get("approximate"))
        return original(self, *a, **kw)

    monkeypatch.setattr(tdev.TorchDeviceEngine, "query_batch_stream", spy)
    assert torch_cli.main(argv, device="cpu") == 0
    got = capsys.readouterr().out
    assert got == ref and len(got.splitlines()) >= 2
    assert seen and all(seen), "approximate walk did not run on the engine"
