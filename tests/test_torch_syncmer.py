"""The port's syncmer path against impg_tpu's, on the CPU.

On the same numpy-seeded inputs: the port's ops/syncmer.py and native
bindings give impg_tpu's positions, ids and orientations; the dense scan
`syncmer_scan_plain` gives JAX's `syncmer_scan` exactly (N bases, padded
rows, k in {5, 8}), and at k = 12, which JAX's reverse-complement table
cannot reach, the numpy oracle's; the plain twins of K-F
(`extract_syncmers_batch_plain`, over one flat row of 255-separated
sequences) and K-G (`map_pack_plain`, over a flat row of reads, through the
universe's bucket directory) give JAX's `extract_syncmers_jax` per sequence
and `map_pack_step` on JAX's padded rows; the directory's lower bound gives
`np.searchsorted`; the SyngIndex arrays of all three extractors (the device
one over one or several pieces), the packs of `map_reads` and
`map_reads_batched` (at several batch sizes and byte caps), and the
`syng`/`map` CLI bytes equal impg_tpu's."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.io import fasta as jax_fasta
from impg_tpu.io import native as jax_native
from impg_tpu.ops import syncmer as jax_sync
from impg_tpu.ops import syncmer_jax as sj
from impg_tpu.syng import pack as jax_pack
from impg_tpu.syng.index import SyngIndex as JaxSyng
from impg_tpu_torch.io import fasta as port_fasta
from impg_tpu_torch.io import native as port_native
from impg_tpu_torch.ops import syncmer as port_sync
from impg_tpu_torch.ops import syncmer_device as sd
from impg_tpu_torch.syng import pack as port_pack
from impg_tpu_torch.syng.index import SyngIndex as PortSyng

OCC = ("occ_ids", "occ_seq", "occ_pos", "occ_fwd")


def _seq(rng, n, n_frac=0.0, lower=False):
    """Seeded random bases; `n_frac` of them N, lowercase when asked."""
    letters = np.frombuffer(b"acgt" if lower else b"ACGT", np.uint8)
    s = letters[rng.integers(0, 4, n)]
    s[rng.random(n) < n_frac] = ord("N")
    return s.tobytes()


def _codes(rng, rows, length, n_frac=0.01, pad_rows=()):
    codes = rng.integers(0, 4, (rows, length)).astype(np.uint8)
    codes[rng.random((rows, length)) < n_frac] = 255
    for r in pad_rows:  # a short read padded with 255
        codes[r, length // 3:] = 255
    return codes


def _scan_np(codes_t, k, w, seed=7):
    sel, hi, lo, fwd = sd.syncmer_scan_plain(codes_t, k, w, seed)
    return [sel.numpy(), hi.numpy().view(np.uint32),
            lo.numpy().view(np.uint32), fwd.numpy()]


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("k", [5, 8, 12])
@pytest.mark.parametrize("n_frac,lower", [(0.0, False), (0.02, True)])
def test_ops_syncmer_equals_reference(k, n_frac, lower):
    rng = np.random.default_rng(k)
    for n in (60, 700, 5000):
        seq = _seq(rng, n, n_frac, lower)
        assert _same(port_sync.extract_syncmers(seq, k=k),
                     jax_sync.extract_syncmers(seq, k=k))
        assert _same(port_sync.extract_syncmers_numpy(seq, k=k),
                     jax_sync.extract_syncmers_numpy(seq, k=k))
    codes = rng.integers(0, 1 << (2 * min(k, 8)), 100).astype(np.uint64)
    assert np.array_equal(port_sync.revcomp_code(codes, k),
                          jax_sync.revcomp_code(codes, k))


def test_native_bindings_equal_reference():
    rng = np.random.default_rng(2)
    seqs = [_seq(rng, n, 0.01) for n in (40, 3000, 9000, 64)]
    for threads in (1, 3):
        assert _same(port_native.extract_syncmers_native(seqs[2], 8, 55, 7,
                                                         threads),
                     jax_native.extract_syncmers_native(seqs[2], 8, 55, 7,
                                                        threads))
    assert _same(port_native.extract_syncmers_batch_native(seqs, 8, 55, 7),
                 jax_native.extract_syncmers_batch_native(seqs, 8, 55, 7))
    keys = rng.integers(0, 2**63, 5000).astype(np.uint64) * np.uint64(3)
    keys[::7] = keys[0]  # ties keep input order
    assert np.array_equal(port_native.radix_argsort_u64(keys),
                          jax_native.radix_argsort_u64(keys))


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("rows,length,pad_rows", [
    (1, 64, ()), (3, 300, (1,)), (4, 1000, (0, 3)),
])
def test_scan_twin_matches_jax(k, rows, length, pad_rows):
    """The dense scan under K-F's twin equals JAX's syncmer_scan bit for
    bit."""
    rng = np.random.default_rng(100 * k + length)
    codes = _codes(rng, rows, length, pad_rows=pad_rows)
    ref = [np.asarray(a) for a in sj.syncmer_scan(jnp.asarray(codes), k, 55,
                                                   7)]
    assert _same(_scan_np(torch.from_numpy(codes), k, 55), ref)


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("universe_kind", ["hits", "misses", "empty"])
def test_map_pack_twin_matches_jax(k, universe_kind):
    """K-G's twin over the padded rows laid end to end, each followed by
    one 255, adds JAX's map_pack_step counts and n_matched on the rows,
    starting from the counts already there."""
    rng = np.random.default_rng(k)
    codes = _codes(rng, 6, 400, pad_rows=(2,))
    flat = np.concatenate([np.append(row, np.uint8(255)) for row in codes])
    sel, hi, lo, _ = _scan_np(torch.from_numpy(codes), k, 55)
    ids = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if universe_kind == "empty":
        uni = np.zeros(0, np.uint64)
    else:
        picked = np.unique(ids[sel])[:: 2 if universe_kind == "hits" else 1]
        noise = rng.integers(0, 2**63, 40).astype(np.uint64) * np.uint64(2)
        uni = np.unique(np.concatenate(
            [picked if universe_kind == "hits" else np.zeros(0, np.uint64),
             noise]))
    start = rng.integers(0, 5, uni.size).astype(np.int64)
    counts = torch.from_numpy(start.copy())
    matched = torch.tensor([3], dtype=torch.int64)
    sd.map_pack(torch.from_numpy(flat), torch.from_numpy(uni.view(np.int64)),
                torch.from_numpy(sd.bucket_directory(uni)), counts, matched,
                k, 55, 7)
    if uni.size:
        uh, ul = sj.split_universe(uni)
        c_ref, m_ref = sj.map_pack_step(jnp.asarray(codes), jnp.asarray(uh),
                                        jnp.asarray(ul), k, 55, 7)
        c_ref, m_ref = np.asarray(c_ref), int(m_ref)
    else:  # the JAX step is never called on an empty universe
        c_ref, m_ref = np.zeros(0, np.int64), 0
    assert np.array_equal(counts.numpy(), start + c_ref)
    assert int(matched) == 3 + m_ref
    if universe_kind == "hits":
        assert m_ref > 0
    elif universe_kind == "misses":
        assert m_ref == 0


@pytest.mark.parametrize("k", [12, 16])
def test_scan_long_k_matches_numpy_oracle(k):
    """At k > 8 (JAX's table gather cannot reach it) the twin's arithmetic
    reverse complement gives the numpy oracle's syncmers, padded or not."""
    rng = np.random.default_rng(k)
    seq = _seq(rng, 4000, 0.005)
    ref = jax_sync.extract_syncmers_numpy(seq, k=k)
    assert ref[0].size > 10
    assert _same(sd.extract_syncmers_device(seq, k=k, device="cpu"), ref)
    codes = np.full((2, 4200), 255, np.uint8)
    codes[1, :4000] = jax_sync.encode_bases(seq)
    sel, hi, lo, fwd = _scan_np(torch.from_numpy(codes), k, 55)
    assert not sel[0].any()
    pos = np.nonzero(sel[1])[0]
    ids = (hi[1, pos].astype(np.uint64) << np.uint64(32)) | lo[1, pos]
    assert _same((pos, ids, fwd[1, pos]), ref)


def test_scan_short_rows_and_bad_inputs():
    codes = torch.full((2, 30), 1, dtype=torch.uint8)
    sel, hi, lo, fwd = sd.syncmer_scan_plain(codes, 8, 55, 7)
    assert sel.shape == hi.shape == lo.shape == fwd.shape == (2, 0)
    flat = codes.reshape(-1)
    starts = torch.tensor([0, 60], dtype=torch.int64)
    found = sd.extract_syncmers_batch(flat, starts, 8, 55, 7)
    assert found.n == 0 and found.counts.tolist() == [0]
    with pytest.raises(ValueError, match="k <= 16"):
        sd.extract_syncmers_batch(flat, starts, 17, 55, 7)
    with pytest.raises(ValueError, match="uint8"):
        sd.extract_syncmers_batch(flat.to(torch.int32), starts, 8, 55, 7)
    with pytest.raises(ValueError, match="1-D"):
        sd.extract_syncmers_batch(codes, starts, 8, 55, 7)
    directory = torch.zeros(sd.N_BUCKETS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        sd.map_pack(flat, torch.zeros(3, dtype=torch.int32), directory,
                    torch.zeros(3, dtype=torch.int64),
                    torch.zeros(1, dtype=torch.int64), 8, 55, 7)
    with pytest.raises(ValueError, match="directory"):
        sd.map_pack(flat, torch.zeros(3, dtype=torch.int64), directory[1:],
                    torch.zeros(3, dtype=torch.int64),
                    torch.zeros(1, dtype=torch.int64), 8, 55, 7)
    # codes 2,112 (2,110 and padding to 16-byte loads), 2,103 k-mers' hash
    # and prefix and suffix minima, 66 + 1 invalid-code words and their
    # prefix counts.
    assert sd.scan_smem_bytes(8, 55) == 2112 + 4 * (3 * 2103 + 2 * 67)


def test_encode_batch_pads_ragged_reads():
    """Reads of any length lie end to end in one row, each followed by one
    255 (the padding of the flat layout)."""
    reads = [b"ACGTN", b"AC", b"", b"ggGTT"]
    buf = sd.encode_batch(reads)
    assert buf.dtype == np.uint8
    assert buf.tolist() == [0, 1, 2, 3, 255, 255, 0, 1, 255, 255,
                            2, 2, 2, 3, 3, 255]
    assert sd.encode_batch([]).tolist() == [255]


def _flat(seqs):
    """encode_batch's row of `seqs` and its int64 starts, as tensors."""
    starts = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(q) + 1 for q in seqs], out=starts[1:])
    return torch.from_numpy(sd.encode_batch(seqs)), torch.from_numpy(starts)


def _mix(rng, k, w):
    """Empty, shorter than k + w, exactly k + w, lengths around the tile
    (256 window starts) and its halo, N runs, lowercase, a homopolymer
    (every window selects) and a tandem repeat."""
    seqs = [b"", _seq(rng, k + w - 1), _seq(rng, k + w)]
    seqs += [_seq(rng, n) for n in (255, 256, 257, 311, 312)]
    runs = bytearray(_seq(rng, 900))
    runs[100:130] = b"N" * 30
    runs[500:502] = b"NN"
    seqs += [bytes(runs), _seq(rng, 700, 0.01, lower=True), b"C" * 400,
             b"ACGTTGCAT" * 60, b"GA" * 200]
    return seqs


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_twin_matches_jax_per_sequence(k, seed):
    """K-F's twin over one flat row gives, for each sequence,
    extract_syncmers_jax's positions, ids and orientations, in order; a
    homopolymer selects every window."""
    rng = np.random.default_rng(seed)
    seqs = _mix(rng, k, 55)
    codes, starts = _flat(seqs)
    found = sd.extract_syncmers_batch_plain(codes, starts, k, 55, 7)
    counts = found.counts.numpy()
    pos, fwd = found.pos.numpy(), found.fwd.numpy()
    ids = found.ids.numpy().view(np.uint64)
    at = 0
    for seq, n in zip(seqs, counts):
        ref = sj.extract_syncmers_jax(seq, k, 55, 7)
        assert _same((pos[at:at + n], ids[at:at + n], fwd[at:at + n]), ref)
        at += n
    assert at == found.n
    homopolymer = seqs.index(b"C" * 400)
    assert counts[homopolymer] == 400 - k - 55 + 1
    assert counts[0] == counts[1] == 0 and counts[2] <= 1  # one window
    wrapped = sd.extract_syncmers_batch(codes, starts, k, 55, 7)
    assert torch.equal(wrapped.buffer, found.buffer)


def test_batch_device_extractor_matches_native_batch():
    """extract_syncmers_batch_device (on the CPU: the twin) returns
    extract_syncmers_batch_native's (pos, ids, fwd, per-sequence counts),
    over no sequences, one, and the mix."""
    rng = np.random.default_rng(4)
    seqs = _mix(rng, 8, 55)
    for batch in ([], [seqs[3]], seqs):
        got = sd.extract_syncmers_batch_device(batch, device="cpu")
        ref = jax_native.extract_syncmers_batch_native(batch, 8, 55, 7)
        assert [a.dtype for a in got] == [a.dtype for a in ref]
        assert _same(got, ref) and len(got[3]) == len(batch)
    assert _same(sd.extract_syncmers_device(seqs[4], device="cpu"),
                 jax_sync.extract_syncmers_numpy(seqs[4]))


@pytest.mark.parametrize("k", [5, 8])
def test_flat_map_pack_twin_matches_jax_padded_rows(k):
    """K-G's twin over a flat row of reads (ragged, shorter than k + w,
    with N, one empty) adds what map_pack_step adds over the same reads
    padded as JAX pads them."""
    rng = np.random.default_rng(30 + k)
    reads = [_seq(rng, int(n), 0.01) for n in rng.integers(150, 300, 12)]
    reads += [_seq(rng, 40), b"", _seq(rng, k + 55), _seq(rng, 200, 0.1)]
    padded = np.full((len(reads), 512), 255, np.uint8)
    for i, r in enumerate(reads):
        padded[i, :len(r)] = jax_sync.encode_bases(r)
    sel, hi, lo, _ = _scan_np(torch.from_numpy(padded), k, 55)
    ids = np.unique((hi.astype(np.uint64) << np.uint64(32))[sel] | lo[sel])
    noise = rng.integers(0, 2**64 - 1, 30, dtype=np.uint64)
    uni = np.unique(np.concatenate([ids[::2], noise]))
    counts = torch.zeros(uni.size, dtype=torch.int64)
    matched = torch.zeros(1, dtype=torch.int64)
    sd.map_pack_plain(torch.from_numpy(sd.encode_batch(reads)),
                      torch.from_numpy(uni.view(np.int64)),
                      torch.from_numpy(sd.bucket_directory(uni)), counts,
                      matched, k, 55, 7)
    uh, ul = sj.split_universe(uni)
    c_ref, m_ref = sj.map_pack_step(jnp.asarray(padded), jnp.asarray(uh),
                                    jnp.asarray(ul), k, 55, 7)
    assert int(m_ref) > 0
    assert np.array_equal(counts.numpy(), np.asarray(c_ref))
    assert int(matched) == int(m_ref)


def _universe(kind, rng):
    top = np.uint64(0xFFFF) << np.uint64(48)
    if kind == "empty":
        return np.zeros(0, np.uint64)
    if kind == "one":
        return np.array([0x8000_1234_5678_9ABC], np.uint64)
    if kind == "one_bucket":
        low = rng.integers(0, 2**48, 300, dtype=np.uint64)
        return np.unique((np.uint64(0xABCD) << np.uint64(48)) | low)
    if kind == "bucket_edges":
        return np.unique(np.array(
            [0, 1, 0x0000_FFFF_FFFF_FFFF, 0x0001_0000_0000_0000,
             0x7FFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0000, int(top),
             2**64 - 2, 2**64 - 1], np.uint64))
    if kind == "at_or_above_2_63":
        return np.unique(rng.integers(2**63, 2**64 - 1, 2000,
                                      dtype=np.uint64))
    return np.unique(rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64))


@pytest.mark.parametrize("kind", ["empty", "one", "one_bucket",
                                  "bucket_edges", "at_or_above_2_63",
                                  "random"])
def test_directory_lower_bound_matches_searchsorted(kind):
    """lower_bound_plain through bucket_directory equals np.searchsorted on
    the uint64 universe: for every id, its neighbours, both ends of the
    range and random ids."""
    rng = np.random.default_rng(len(kind))
    uni = _universe(kind, rng)
    one = np.uint64(1)
    q = np.concatenate([
        uni, uni + one, uni - one,
        np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], np.uint64),
        rng.integers(0, 2**64 - 1, 500, dtype=np.uint64),
        (np.uint64(0xABCD) << np.uint64(48))
        | rng.integers(0, 2**48, 100, dtype=np.uint64),
    ])
    directory = sd.bucket_directory(uni)
    assert directory.dtype == np.int32 and directory.size == 2**16 + 1
    assert directory[0] == 0 and directory[-1] == uni.size
    got = sd.lower_bound_plain(torch.from_numpy(uni.view(np.int64)),
                               torch.from_numpy(directory),
                               torch.from_numpy(q.view(np.int64)))
    assert np.array_equal(got.numpy(), np.searchsorted(uni, q))


def test_pieces_follow_the_budget():
    """Runs of sequences whose codes and separators fit the budget; a
    longer sequence is a run of its own."""
    assert sd._pieces([], 10) == []
    assert sd._pieces([3, 4, 2], 10) == [(0, 2), (2, 3)]
    assert sd._pieces([3, 5], 10) == [(0, 2)]
    assert sd._pieces([30, 2, 40, 1], 10) == [(0, 1), (1, 2), (2, 3),
                                              (3, 4)]
    assert sd._pieces([0, 0, 0], 2) == [(0, 2), (2, 3)]


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Five seeded 4 kb sequences (one lowercase, one with N bases, one a
    homolog of the first), their FASTA, and 150 reads of 150-500 bp from
    the first."""
    rng = np.random.default_rng(21)
    seqs = [(f"g{i}", _seq(rng, 4000, 0.002 * (i == 3), lower=(i == 2)))
            for i in range(4)]
    # g4: g0 with a substitution every 400 bases (a homolog of g0).
    g4 = np.frombuffer(seqs[0][1], np.uint8).copy()
    g4[::400] = np.where(g4[::400] == ord("A"), ord("C"), ord("A"))
    seqs.append(("g4", g4.tobytes()))
    tmp = tmp_path_factory.mktemp("tsync")
    fa = str(tmp / "panel.fa")
    with open(fa, "w") as fh:
        for name, s in seqs:
            fh.write(f">{name} desc\n")
            text = s.decode()
            for i in range(0, len(text), 70):
                fh.write(text[i:i + 70] + "\n")
    reads = str(tmp / "reads.fq")
    base = seqs[0][1].decode().upper()
    with open(reads, "w") as fh:
        for r in range(150):
            s = int(rng.integers(0, 3500))
            ln = int(rng.choice((150, 300, 500)))
            frag = base[s:s + ln]
            fh.write(f"@r{r}\n{frag}\n+\n{'I' * len(frag)}\n")
    return seqs, fa, reads, tmp


def test_fasta_index_equals_reference(panel):
    _seqs, fa, _reads, _tmp = panel
    a = port_fasta.FastaIndex.build_from_files([fa])
    b = jax_fasta.FastaIndex.build_from_files([fa])
    assert list(a.sequence_names()) == list(b.sequence_names())
    for name in b.sequence_names():
        n = b.get_sequence_length(name)
        assert a.get_sequence_length(name) == n
        for s, e in ((0, n), (65, 71), (139, 1400), (n - 3, n)):
            assert a.fetch_sequence(name, s, e) == b.fetch_sequence(name, s, e)
    assert port_fasta.reverse_complement(b"ACGTNacgtRY") == \
        jax_fasta.reverse_complement(b"ACGTNacgtRY")


@pytest.mark.parametrize("extractor", ["native", "numpy", "device"])
def test_syng_index_equals_reference(panel, extractor):
    """All three of the port's extractors (device: K-F's twin on the CPU)
    give impg_tpu's index arrays, queries and saved bytes."""
    _seqs, fa, _reads, tmp = panel
    ref = JaxSyng.build_from_fasta([fa])
    got = PortSyng.build_from_fasta([fa], extractor=extractor, device="cpu")
    for col in OCC:
        assert np.array_equal(getattr(got, col), getattr(ref, col)), col
    assert list(got.seq_index.names()) == list(ref.seq_index.names())
    hits = [vars(iv) for iv in got.query_region("g0", 100, 3500)]
    assert hits and hits == [vars(iv)
                             for iv in ref.query_region("g0", 100, 3500)]
    a = got.save(str(tmp / f"port_{extractor}"))
    b = ref.save(str(tmp / f"ref_{extractor}"))
    with open(a, "rb") as fa_, open(b, "rb") as fb_:
        assert fa_.read() == fb_.read()
    loaded = PortSyng.load(a)
    for col in OCC:
        assert np.array_equal(getattr(loaded, col), getattr(ref, col)), col


def test_map_reads_equal_reference(panel):
    """Host map_reads and map_reads_batched (K-G's twin on the CPU, ragged
    batches) give impg_tpu's host and JAX packs."""
    _seqs, fa, reads, tmp = panel
    ref_idx = JaxSyng.build_from_fasta([fa])
    idx = PortSyng.build_from_fasta([fa])
    ref_pack, ref_nr, ref_nm = jax_pack.map_reads(ref_idx, [reads])
    jx_pack, jx_nr, jx_nm = sj.map_reads_batched(ref_idx, [reads], batch=32)
    host = port_pack.map_reads(idx, [reads])
    dev = sd.map_reads_batched(idx, [reads], batch=37, device="cpu")
    assert ref_nm > 0 and (jx_nr, jx_nm) == (ref_nr, ref_nm)
    for pk, nr, nm in (host, dev):
        assert (nr, nm) == (ref_nr, ref_nm)
        assert np.array_equal(pk.feature_ids, ref_pack.feature_ids)
        assert np.array_equal(pk.counts, ref_pack.counts)
        assert np.array_equal(pk.counts, jx_pack.counts)
    # Pack I/O: the same .packt bytes and TSV text.
    a, b = str(tmp / "port.packt"), str(tmp / "ref.packt")
    host[0].save(a)
    ref_pack.save(b)
    with open(a, "rb") as fa_, open(b, "rb") as fb_:
        assert fa_.read() == fb_.read()
    ta, tb = io.StringIO(), io.StringIO()
    port_pack.Pack.load(a).write_tsv(ta)
    ref_pack.write_tsv(tb)
    assert ta.getvalue() == tb.getvalue()
    probe = np.concatenate([ref_pack.feature_ids[:5], [np.uint64(12345)]])
    assert np.array_equal(host[0].counts_for(probe),
                          ref_pack.counts_for(probe))


def _counting(monkeypatch, name):
    """Counts the calls of syncmer_device's `name`, which still runs."""
    calls = []
    fn = getattr(sd, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(sd, name, counted)
    return calls


@pytest.mark.parametrize("batch", [1, 7, 75, None])
def test_map_reads_batched_batch_sizes(panel, monkeypatch, batch):
    """At one read a batch, 7 (a ragged last batch), 75 (150 reads: a
    multiple) and the default (one batch), map_reads_batched gives host
    map_reads's pack in ceil(150 / batch) K-G calls."""
    _seqs, fa, reads, _tmp = panel
    idx = PortSyng.build_from_fasta([fa])
    host = port_pack.map_reads(idx, [reads])
    calls = _counting(monkeypatch, "map_pack")
    kw = {} if batch is None else {"batch": batch}
    pk, nr, nm = sd.map_reads_batched(idx, [reads], device="cpu", **kw)
    assert (nr, nm) == host[1:] and nm > 0
    assert np.array_equal(pk.counts, host[0].counts)
    assert len(calls) == -(-150 // (batch or 65536))


def test_map_reads_batched_byte_cap(panel, monkeypatch):
    """A batch also ends at BATCH_CODE_BYTES of codes; a read longer than
    that is a batch of its own; the pack is the host's."""
    _seqs, fa, reads, _tmp = panel
    idx = PortSyng.build_from_fasta([fa])
    host = port_pack.map_reads(idx, [reads])
    monkeypatch.setattr(sd, "BATCH_CODE_BYTES", 400)
    calls = _counting(monkeypatch, "map_pack")
    pk, nr, nm = sd.map_reads_batched(idx, [reads], device="cpu")
    assert (nr, nm) == host[1:]
    assert np.array_equal(pk.counts, host[0].counts)
    lens = [len(s) for _n, s in port_pack.read_sequences(reads)]
    assert len(calls) == len(sd._pieces(lens, 400)) > 100


def test_device_universe_is_cached_on_the_index(panel):
    _seqs, fa, _reads, _tmp = panel
    idx = PortSyng.build_from_fasta([fa])
    uni, directory = sd.device_universe(idx, "cpu")
    assert sd.device_universe(idx, torch.device("cpu"))[0] is uni
    want = port_pack.universe_from_index(idx)
    assert np.array_equal(uni.numpy().view(np.uint64), want)
    assert np.array_equal(directory.numpy(), sd.bucket_directory(want))


@pytest.mark.parametrize("budget,launches", [
    (None, 1), (9000, 3), (5000, 5), (3000, 5),
])
def test_syng_device_build_pieces(panel, monkeypatch, budget, launches):
    """SyngIndex.build(extractor="device") on the CPU equals the native
    build whether the panel (five 4 kb sequences) goes in one piece, two a
    piece, one a piece, or each past the budget on its own."""
    _seqs, fa, _reads, _tmp = panel
    ref = PortSyng.build_from_fasta([fa])
    if budget is not None:
        monkeypatch.setattr(sd, "PIECE_BYTES", budget)
    calls = _counting(monkeypatch, "extract_syncmers_batch")
    got = PortSyng.build_from_fasta([fa], extractor="device", device="cpu")
    assert len(calls) == launches
    for col in OCC:
        assert np.array_equal(getattr(got, col), getattr(ref, col)), col
    assert list(got.seq_index.names()) == list(ref.seq_index.names())


def test_map_reads_batched_empty_universe(tmp_path, panel):
    _seqs, _fa, reads, _tmp = panel
    empty = PortSyng.build([("tiny", b"ACGT")])
    pk, nr, nm = sd.map_reads_batched(empty, [reads], device="cpu")
    ref = jax_pack.map_reads(JaxSyng.build([("tiny", b"ACGT")]), [reads])
    assert (nr, nm) == ref[1:] and pk.counts.size == 0


def _run(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_syng_and_map_bytes_equal_reference(panel, tmp_path, engine):
    """`syng` and `map -o pack|pack-tsv`: the port's files (host engine, or
    the device engine on the CPU twins) equal impg_tpu.cli's."""
    _seqs, fa, reads, _tmp = panel
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    eng = ["--compute-engine", engine]
    assert _run(torch_cli.main, ["syng", "-f", fa, "-o", port] + eng,
                device="cpu")[0] == 0
    assert jax_cli.main(["syng", "-f", fa, "-o", ref,
                         "--compute-engine", "host"]) == 0
    with open(port + ".syngt", "rb") as a, open(ref + ".syngt", "rb") as b:
        assert a.read() == b.read()
    for fmt, ext in (("pack-tsv", ".tsv"), ("pack", ".packt")):
        assert _run(torch_cli.main, [
            "map", "-a", port + ".syngt", "-q", reads, "-o", fmt,
            "-O", port + ext] + eng, device="cpu")[0] == 0
        assert jax_cli.main(["map", "-a", ref + ".syngt", "-q", reads,
                             "-o", fmt, "-O", ref + ext,
                             "--compute-engine", "host"]) == 0
        with open(port + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read()
    with open(port + ".tsv") as fh:
        assert len(fh.read().splitlines()) > 10


@pytest.mark.parametrize("argv", [
    ["-o", "proj"], ["-o", "gaf"], ["-o", "paf"], ["-o", "graph-pack"],
    ["-o", "graph-pack-tsv"], ["--graph", "missing.gfa"],
])
def test_cli_map_unported_outputs_exit_2(argv, capsys):
    """Refused before any input is read (the index and reads do not
    exist)."""
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["map", "-a", "missing.syngt", "-q", "missing.fq",
                        "-O", "out"] + argv, device="cpu")
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("command", [
    ["syng", "-f", "missing.fa", "-o", "x"],
    ["map", "-a", "missing.syngt", "-q", "missing.fq", "-O", "x"],
])
def test_cli_syng_map_mesh_and_absent_cuda_exit_2(command, capsys):
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(command + ["--compute-engine", "mesh"], device="cpu")
    assert exc.value.code == 2
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as exc:  # cuda:0, the default device
        torch_cli.main(command + ["--compute-engine", "device"])
    assert exc.value.code == 2
    assert "needs a CUDA device" in capsys.readouterr().err


def test_wrappers_refuse_a_cuda_device_without_cuda():
    """The device path never carries on on the CPU: a wrapper handed a
    non-CPU tensor launches or raises (here: a `meta` tensor)."""
    codes = torch.zeros(100, dtype=torch.uint8, device="meta")
    starts = torch.tensor([0, 100], dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sd.extract_syncmers_batch(codes, starts, 8, 55, 7)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            sd.extract_syncmers_device(b"ACGT" * 40, device="cuda:0")
