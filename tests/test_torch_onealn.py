""".1aln tracepoint files in the port against impg_tpu, exactly.

Every case of tests/test_onealn.py, held between the two packages on the
same inputs (tests/datagen.mutate_chain_paf, seed 61, with alignments on both
strands): the ASCII and binary
exports by bytes, the ONEcode container (header, footer index, O(1) goto,
the spill to a temporary file past 32 MiB, its guards and the description of
a foreign header), ingest with and without sequences on both strands, the
error messages of an upstream binary file and of a file without a name
table, and the `.impgt` cache that keeps a first approximate ingest (a
reference fault both packages keep).  The port's batched ingest without
sequences (reconstruct_runs_batch) is held against the per-segment path at
its edges.  Through the CLI: `export-1aln` (ASCII and `--binary`), and
`index`, `query`, `stats`, `partition`, `refine` and `similarity` on the
exported files, on the port's host, native and device (CPU twin) engines,
with and without `--sequence-files`, by bytes against impg_tpu.cli."""

import contextlib
import io
import os
import random
import shutil

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.core import cigar as jax_cigar
from impg_tpu.core.seqidx import SequenceIndex as JaxSeqIndex
from impg_tpu.index import impg_index as jax_index
from impg_tpu.io import onealn as jax_onealn
from impg_tpu.io import onecode as jax_onecode
from impg_tpu.io.fasta import UnifiedSequenceIndex as JaxUSI
from impg_tpu.query import engine as jax_engine
from impg_tpu_torch.core.seqidx import SequenceIndex as PortSeqIndex
from impg_tpu_torch.index import impg_index as port_index
from impg_tpu_torch.io import onealn as port_onealn
from impg_tpu_torch.io import onecode as port_onecode
from impg_tpu_torch.io.fasta import UnifiedSequenceIndex as PortUSI
from impg_tpu_torch.query import engine as port_engine
from tests import datagen
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

COLS = ("query_id", "q_start", "q_end", "target_id", "t_start", "t_end",
        "strand", "runs", "run_offsets")


def _same_records(a, b):
    for col in COLS:
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype, col
        np.testing.assert_array_equal(x, y, err_msg=col)


@pytest.fixture(scope="module")
def roundtrip(tmp_path_factory):
    """The chain pangenome in two directories, its index built by each
    package, and each package's ASCII and binary exports."""
    tmp = tmp_path_factory.mktemp("torch_onealn")
    text, seqs, alns, seq_data = datagen.mutate_chain_paf(
        random.Random(61), n_seqs=4, seq_len=3000, return_sequences=True)
    out = {"seqs": seqs, "seq_data": seq_data, "n_alns": len(alns)}
    for side, idx_mod, onealn in (("jax", jax_index, jax_onealn),
                                  ("port", port_index, port_onealn)):
        d = tmp / side
        d.mkdir()
        (d / "p.paf").write_text(text)
        datagen.write_fasta(str(d / "p.fa"), seq_data)
        index = idx_mod.load_or_build([str(d / "p.paf")])
        tp = index.ensure_tracepoints(100)
        for name, binary in (("p.1aln", False), ("b.1aln", True)):
            n = onealn.write_1aln(str(d / name), index.seq_index,
                                  index.records, index.arena, tp,
                                  binary=binary)
            assert n == len(alns)
        out[side] = (str(d), index)
    return out


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", ["p.1aln", "b.1aln"],
                         ids=["ascii", "binary"])
def test_export_bytes_equal(roundtrip, name):
    jd, pd = roundtrip["jax"][0], roundtrip["port"][0]
    assert _bytes(f"{pd}/{name}") == _bytes(f"{jd}/{name}")


def test_export_format(roundtrip):
    """The ASCII grammar of tests/test_onealn.py: T lists are count-prefixed
    target deltas over the FASTGA query grid."""
    pd, index = roundtrip["port"]
    lines = open(f"{pd}/p.1aln").read().splitlines()
    assert lines[0].startswith("1 3 aln")
    assert any(ln.startswith("t 100") for ln in lines)
    assert len([ln for ln in lines if ln.startswith("N ")]) == len(
        index.seq_index)
    a_lines = [ln for ln in lines if ln.startswith("A ")]
    t_lines = [ln for ln in lines if ln.startswith("T ")]
    assert len(a_lines) == len(t_lines) > 0
    for al, tl in zip(a_lines, t_lines):
        af, tf = al.split(), tl.split()
        assert int(tf[1]) == len(tf) - 2
        qs, qe = int(af[2]), int(af[3])
        assert sum(int(x) for x in tf[2:]) == abs(int(af[6]) - int(af[5]))
        assert len(tf) - 2 == len(port_onealn.query_grid_bounds(
            qs, qe, 100)) - 1
        np.testing.assert_array_equal(
            port_onealn.query_grid_bounds(qs, qe, 100),
            jax_onealn.query_grid_bounds(qs, qe, 100))


@pytest.mark.parametrize("name", ["p.1aln", "b.1aln"],
                         ids=["ascii", "binary"])
@pytest.mark.parametrize("with_seq", [False, True],
                         ids=["approx", "exact"])
def test_parse_equal(roundtrip, name, with_seq):
    """Parsed columns and runs equal impg_tpu's, both strands, without
    sequences (the port's batched path) and with them (per segment through
    the native aligner)."""
    jd, pd = roundtrip["jax"][0], roundtrip["port"][0]
    jf = JaxUSI.from_files([f"{jd}/p.fa"]).fetch_sequence if with_seq else None
    pf = PortUSI.from_files([f"{pd}/p.fa"]).fetch_sequence if with_seq else None
    ref, sp_r = jax_onealn.parse_1aln(f"{jd}/{name}", JaxSeqIndex(), jf)
    got, sp_g = port_onealn.parse_1aln(f"{pd}/{name}", PortSeqIndex(), pf)
    assert sp_g == sp_r == 100
    _same_records(ref, got)
    assert set(ref.strand.tolist()) == {0, 1}


def _rows_by_coords(index, rows):
    return sorted(
        (index.seq_index.get_name(r.q_id), r.q_first, r.q_last,
         index.seq_index.get_name(r.t_id), r.t_first, r.t_last)
        for r in rows)


@pytest.mark.parametrize("with_seq", [False, True], ids=["approx", "exact"])
def test_ingested_index_queries_equal(roundtrip, with_seq):
    """The index built from the .1aln answers every query as impg_tpu's;
    without sequences its endpoints equal the PAF index's (the approximate
    contract of tests/test_onealn.py)."""
    jd, pd = roundtrip["jax"][0], roundtrip["port"][0]
    jf = JaxUSI.from_files([f"{jd}/p.fa"]).fetch_sequence if with_seq else None
    pf = PortUSI.from_files([f"{pd}/p.fa"]).fetch_sequence if with_seq else None
    ref = jax_index.ImpgIndex.from_paf_files([f"{jd}/p.1aln"], seq_fetch=jf)
    got = port_index.ImpgIndex.from_paf_files([f"{pd}/p.1aln"], seq_fetch=pf)
    paf_index = roundtrip["port"][1]
    assert len(got.records) == len(ref.records) == len(paf_index.records)
    for name, L in roundtrip["seqs"].items():
        for s, e in ((0, L), (L // 4, 3 * L // 4), (137, 2000)):
            want = _rows_by_coords(ref, jax_engine.query(
                ref, ref.seq_index.get_id(name), s, e))
            rows = _rows_by_coords(got, port_engine.query(
                got, got.seq_index.get_id(name), s, e))
            assert rows == want, (name, s, e)
            if not with_seq and (s, e) == (0, L):
                assert rows == _rows_by_coords(paf_index, port_engine.query(
                    paf_index, paf_index.seq_index.get_id(name), 0, L))


def test_binary_container_structure(roundtrip):
    pd, index = roundtrip["port"]
    jd = roundtrip["jax"][0]
    bout, out = f"{pd}/b.1aln", f"{pd}/p.1aln"
    assert port_onecode.is_onecode_binary(bout)
    assert not port_onecode.is_onecode_binary(out)
    r = port_onecode.OneBinaryReader(bout)
    j = jax_onecode.OneBinaryReader(f"{jd}/b.1aln")
    n = roundtrip["n_alns"]
    assert r.file_type == "aln" and r.counts["A"] == n
    assert r.counts["N"] == len(index.seq_index)
    assert set(port_onealn.ALN_SCHEMA) <= set(r.schema)
    assert r.list_total["T"] == r.list_total["X"] > 0
    for attr in ("file_type", "schema", "counts", "list_max", "list_total",
                 "provenance", "index"):
        assert getattr(r, attr) == getattr(j, attr), attr
    assert list(r) == list(j)
    assert list(port_onealn.iter_1aln_lines(out)) == list(
        jax_onealn.iter_1aln_lines(f"{jd}/p.1aln"))


def test_onealn_reader_goto(roundtrip):
    """O(1) fetch returns impg_tpu's record, in any access order."""
    pd, jd = roundtrip["port"][0], roundtrip["jax"][0]
    rd = port_onealn.OneAlnReader(f"{pd}/b.1aln")
    ref = jax_onealn.OneAlnReader(f"{jd}/b.1aln")
    n = roundtrip["n_alns"]
    assert rd.n_alignments == ref.n_alignments == n
    assert rd.trace_spacing == ref.trace_spacing == 100
    for i in [n - 1, 0, n // 2, n - 1, 1 % n]:
        assert rd.fetch_alignment(i) == ref.fetch_alignment(i), i
    with pytest.raises(IndexError):
        rd.fetch_alignment(n)
    with pytest.raises(ValueError):
        port_onealn.OneAlnReader(f"{pd}/p.1aln")


def _error(fn, *args):
    with pytest.raises(ValueError) as exc:
        fn(*args)
    return str(exc.value)


def test_upstream_binary_1aln_rejected(tmp_path):
    p = tmp_path / "up.1aln"
    p.write_bytes(b"1 3 aln 3 1\n" + bytes(range(256)) * 4)
    msgs = [_error(lambda: list(mod.iter_1aln_lines(str(p))))
            for mod in (jax_onealn, port_onealn)]
    assert msgs[0] == msgs[1] and "ONEview" in msgs[0]


def test_ascii_1aln_without_name_table_rejected(tmp_path):
    p = tmp_path / "ext.1aln"
    p.write_text(
        "1 3 aln 1 1\nt 100\nA 0 0 500 1 0 500\nT 1 500\nX 1 3\nD 3\n")
    msgs = [_error(jax_onealn.parse_1aln, str(p), JaxSeqIndex()),
            _error(port_onealn.parse_1aln, str(p), PortSeqIndex())]
    assert msgs[0] == msgs[1] and "1gdb" in msgs[0]


def test_upstream_onelib_binary_recognized_and_described(tmp_path):
    p = str(tmp_path / "upstream.1aln")
    header = (b"1 3 aln 2 2\n2 3 sxs\n"
              b"! 6 FastGA 5 1.0.2 9 <command> 8 20250101\n"
              b"# A 42\n# T 42\n@ T 99\n$ 0\n")
    with open(p, "wb") as fh:
        fh.write(header + bytes(range(256)) * 8)
    info = port_onecode.describe_onecode_header(p)
    assert info == jax_onecode.describe_onecode_header(p)
    assert info["filetype"] == "aln" and info["version"] == "2.2"
    assert port_onecode.describe_onecode_summary(p) == (
        jax_onecode.describe_onecode_summary(p))
    msgs = [_error(jax_onealn.parse_1aln, p, JaxSeqIndex()),
            _error(port_onealn.parse_1aln, p, PortSeqIndex())]
    assert msgs[0] == msgs[1]
    assert "recognized" in msgs[0] and "42 'A'" in msgs[0]


def test_describe_onecode_header_on_own_export(roundtrip):
    pd, jd = roundtrip["port"][0], roundtrip["jax"][0]
    info = port_onecode.describe_onecode_header(f"{pd}/b.1aln")
    assert info == jax_onecode.describe_onecode_header(f"{jd}/b.1aln")
    assert info["binary"] is True and info["counts"]["A"] == roundtrip[
        "n_alns"]
    assert port_onecode.describe_onecode_summary(f"{pd}/b.1aln") == (
        jax_onecode.describe_onecode_summary(f"{jd}/b.1aln"))


def test_fastga_lists_terminal_deletions():
    trail = jax_cigar.pack(np.asarray([10, 5], np.int64),
                           np.asarray([0, 3], np.uint32))
    lead = jax_cigar.pack(np.asarray([5, 10], np.int64),
                          np.asarray([3, 0], np.uint32))
    for runs in (trail, lead):
        for spacing in (4, 100):
            for rev in (False, True):
                got = port_onealn._fastga_lists(runs, 0, 10, spacing, rev)
                assert got == jax_onealn._fastga_lists(runs, 0, 10, spacing,
                                                       rev)
                assert sum(got[0]) == 15 and got[2] == 5
    assert port_onealn._fastga_lists(lead, 0, 10, 4, False)[:2] == (
        [9, 4, 2], [5, 0, 0])


def test_onecode_writer_guards(tmp_path):
    """INT fields outside int64 raise OverflowError and writes after
    close() raise ValueError, with impg_tpu's messages."""
    seen = []
    for mod in (jax_onecode, port_onecode):
        w = mod.OneBinaryWriter(str(tmp_path / "g.1x"), "tst",
                                schema={"A": (mod.T_INT,),
                                        "L": (mod.T_INT_LIST,)},
                                indexed=("A",))
        w.write("A", -(2**63))
        msgs = []
        for lt, v in (("A", -(2**63) - 1), ("A", 2**63),
                      ("L", [2**63 - 1, -5])):
            with pytest.raises(OverflowError) as exc:
                w.write(lt, v)
            msgs.append(str(exc.value))
        w.close()
        with pytest.raises(ValueError) as exc:
            w.write("A", 1)
        msgs.append(str(exc.value))
        seen.append(msgs)
    assert seen[0] == seen[1]


def _fill(mod, path, lines, limit=None):
    w = mod.OneBinaryWriter(path, "tst",
                            schema={"A": (mod.T_INT, mod.T_STRING),
                                    "L": (mod.T_INT_LIST,)},
                            indexed=("A", "L"))
    if limit:
        w._spill_limit = limit
    for lt, fields in lines:
        w.write(lt, *fields)
    w.close()


@pytest.mark.parametrize("spill", ["small_limit", "past_32MiB"])
def test_onecode_writer_spills_large_bodies(tmp_path, spill):
    """Bodies over the spill limit stream through a temporary file: the
    bytes equal the all-in-memory write and impg_tpu's, at a small limit
    and at the default 32 MiB (a 40 MiB body), and read back."""
    rng = random.Random(4)
    if spill == "small_limit":
        lines = [("A", (i * 7 - 3, "x" * (i % 40))) for i in range(2000)]
        lines += [("L", ([rng.randrange(-2**40, 2**40)
                          for _ in range(i % 50)],)) for i in range(500)]
        limit = 512
    else:
        lines = [("A", (i, "ACGT" * (1 << 18))) for i in range(40)]
        lines += [("L", (list(range(-5000, 5000, 3)),))] * 4
        limit = None
    paths = {}
    for tag, mod, lim in (("ram", port_onecode, 1 << 40),
                          ("port", port_onecode, limit),
                          ("jax", jax_onecode, limit)):
        paths[tag] = str(tmp_path / f"{tag}.bin")
        _fill(mod, paths[tag], lines, lim)
    data = _bytes(paths["port"])
    assert data == _bytes(paths["ram"]) == _bytes(paths["jax"])
    if spill == "past_32MiB":
        assert len(data) > 40 << 20
    got = [(lt, tuple(f)) for lt, f in port_onecode.OneBinaryReader(
        paths["port"])]
    assert got == [(lt, tuple(f)) for lt, f in lines]


def test_int_list_reader_equals_reference(tmp_path):
    """The port's numpy INT_LIST decoder reads impg_tpu's writer's lists:
    empty, single, negative, and values up to the int64 ends."""
    rng = random.Random(3)
    lists = [[], [0], [1], [-1], [2**62 - 1, -(2**62) + 1], [2**62],
             [-(2**63)], [2**63 - 1], [2**63 - 1, 2**63 - 2]]
    for _ in range(300):
        e = rng.choice([3, 7, 14, 21, 40, 61])
        lists.append([rng.randrange(-2**e, 2**e)
                      for _ in range(rng.randrange(0, 50))])
    p = str(tmp_path / "l.bin")
    _fill(jax_onecode, p, [("L", (lst,)) for lst in lists])
    got = [f[0] for _, f in port_onecode.OneBinaryReader(p)]
    assert got == [f[0] for _, f in jax_onecode.OneBinaryReader(p)] == lists


# Trace-segment edge cases: (dq, dt, x) rows, with an optional literal
# (length, op) run per segment.
_EDGE_RECORDS = [
    [(0, 0, 0), (100, 100, 3), (0, 0, 5)],        # empty segments
    [(0, 40, 2), (40, 0, 2), (10, 10, 0)],        # dq or dt zero
    [(50, 60, 100), (60, 50, -4), (5, -3, 1)],    # x past aligned, x < 0
    [(-2, -1, 0), (-1, 4, 0), (4, -1, 0)],        # negative advances
    [],                                           # a record of no segment
    [(30, 30, 0), (30, 30, 0)],                   # runs merge across
    [(10, 12, 1), (8, 8, 8), (12, 10, 0)],
]
_LITERALS = {1: [None, [(7, 2)], None],
             5: [[(0, 0)], [(30, 0)]],
             6: [None, [(5, 3)], [(0, 3)]]}


def test_batch_runs_equal_per_segment_runs():
    """reconstruct_runs_batch gives reconstruct_runs' runs (the port's and
    impg_tpu's) at the edges: empty and zero-advance segments, literal CIGAR
    items (one of length 0), edits past the aligned length, and reverse
    records."""
    seg_counts, dq, dt, x, lit_len, lit_op, want = [], [], [], [], [], [], []
    for r, segs in enumerate(_EDGE_RECORDS):
        lits = _LITERALS.get(r)
        adv = [s[0] for s in segs]
        diffs = [s[2] for s in segs]
        bounds = [1000]
        for s in segs:
            bounds.append(bounds[-1] + s[1])
        for rev in (False, True):
            args = (None, 0, 0, 5000, 1, rev, adv, diffs, bounds, None)
            runs = port_onealn.reconstruct_runs(*args, literal_runs=lits)
            np.testing.assert_array_equal(
                runs, jax_onealn.reconstruct_runs(*args, literal_runs=lits))
        want.append(runs)
        seg_counts.append(len(segs))
        for i, (a, b, c) in enumerate(segs):
            lit = lits[i] if lits else None
            dq.append(a)
            dt.append(b)
            x.append(c)
            lit_len.append(lit[0][0] if lit else 0)
            lit_op.append(lit[0][1] if lit else -1)
    runs, offsets = port_onealn.reconstruct_runs_batch(
        np.asarray(seg_counts), np.asarray(dq), np.asarray(dt),
        np.asarray(x), np.asarray(lit_len), np.asarray(lit_op))
    assert runs.dtype == np.uint32
    for r, w in enumerate(want):
        np.testing.assert_array_equal(runs[offsets[r]:offsets[r + 1]], w)
    assert offsets[-1] == runs.size == sum(w.size for w in want)


_FOREIGN = """1 3 aln 1 1
t {spacing}
N 0 2000 a
N 1 2100 b
A 0 37 950 1 12 940
T 3 300 300 328
X 3 1 0 9
A 0 120 760 1 200 850
R
T 7 10 100 100 100 100 100 140
X 2 4 5
A 1 0 300 0 0 290
T 0
A 1 500 1500 0 400 1400
R
T 4 250 250 250 250
X 6 1 2 3 4 5 6
A 0 1999 2000 1 0 1
T 1 1
A 1 100 400 0 100 420
T 3 100 100 100
A 0 600 900 1 700 1000
R
T 3 100 100 90
"""


@pytest.mark.parametrize("with_seq", [False, True], ids=["approx", "exact"])
@pytest.mark.parametrize("spacing", [100, 250, 1000])
def test_foreign_spacing_and_lists_parse_equal(tmp_path, spacing, with_seq):
    """Files another tool wrote: T lists shorter and longer than the query
    grid (advances padded or truncated), X lists missing, short and long,
    an empty T list, reverse records (target flipped, lists reversed), a
    one-base record and T lists that fall short of the target span (the
    last bound forced to te): the port's parse, batched without sequences and
    realigned with them (random bases of the declared lengths), equals
    impg_tpu's per-segment parse."""
    p = tmp_path / "f.1aln"
    p.write_text(_FOREIGN.format(spacing=spacing))
    fasta = str(tmp_path / "f.fa")
    if with_seq:
        rng = random.Random(5)
        datagen.write_fasta(fasta, {
            n: "".join(rng.choice("ACGT") for _ in range(L))
            for n, L in (("a", 2000), ("b", 2100))})
    fetch = lambda usi: (  # noqa: E731
        usi.from_files([fasta]).fetch_sequence if with_seq else None)
    ref, _ = jax_onealn.parse_1aln(str(p), JaxSeqIndex(), fetch(JaxUSI))
    got, _ = port_onealn.parse_1aln(str(p), PortSeqIndex(), fetch(PortUSI))
    _same_records(ref, got)
    assert got.strand.tolist() == [0, 1, 0, 1, 0, 0, 1]


def test_impgt_cache_keeps_first_ingest(roundtrip, tmp_path):
    """The `.impgt` cache is keyed by path and mtime alone (a reference
    fault both packages keep): a .1aln first loaded without sequences
    keeps its approximate runs when loaded again with them."""
    results = []
    for side, idx_mod, usi in (("jax", jax_index, JaxUSI),
                               ("port", port_index, PortUSI)):
        d = tmp_path / side
        d.mkdir()
        src = roundtrip[side][0]
        shutil.copy(f"{src}/p.1aln", d / "c.1aln")
        fetch = usi.from_files([f"{src}/p.fa"]).fetch_sequence
        approx = idx_mod.load_or_build([str(d / "c.1aln")])
        cached = idx_mod.load_or_build([str(d / "c.1aln")], seq_fetch=fetch)
        exact = idx_mod.ImpgIndex.from_paf_files([str(d / "c.1aln")],
                                                 seq_fetch=fetch)
        np.testing.assert_array_equal(cached.arena.runs, approx.arena.runs)
        assert not np.array_equal(exact.arena.runs, approx.arena.runs)
        results.append((approx.arena.runs, exact.arena.runs))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def _cli(main, argv, d, capsys, **kw):
    capsys.readouterr()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main([a.format(d=d) for a in argv], **kw)
        except SystemExit as e:
            rc = ("exit", e.code)
    err = capsys.readouterr().err
    return rc, out.getvalue().replace(d, "<d>"), err.replace(d, "<d>")


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_cli_export_1aln_bytes(roundtrip, capsys, binary):
    extra = ["--binary"] if binary else []
    res = []
    for main, side, kw in ((jax_cli.main, "jax", {}),
                           (torch_cli.main, "port", {"device": "cpu"})):
        d = roundtrip[side][0]
        res.append(_cli(main, ["export-1aln", "-a", "{d}/p.paf", *extra,
                               "-o", "{d}/cli.1aln"], d, capsys, **kw)
                   + (_bytes(f"{d}/cli.1aln"),))
    assert res[0] == res[1] and res[0][0] == 0
    assert ("binary" if binary else "ASCII") in res[0][2]


@pytest.fixture(scope="module")
def cli_files(roundtrip, tmp_path_factory):
    """Each package's directory with both exports, a BED of windows and a
    sequence list (the commands below read the exports and write their
    own caches)."""
    tmp = tmp_path_factory.mktemp("torch_onealn_cli")
    out = {}
    for side in ("jax", "port"):
        d = tmp / side
        shutil.copytree(roundtrip[side][0], d)
        for f in os.listdir(d):
            if f.endswith(".impgt"):
                os.remove(d / f)
        (d / "w.bed").write_text("ref\t100\t1500\nref\t1600\t2900\n")
        out[side] = str(d)
    return out


_CASES = {
    "index": ["index", "-a", "{d}/{f}", "--index", "{d}/{f}.idx.impgt"],
    "query": ["query", "-a", "{d}/{f}", "-r", "ref:100-2900", "-d", "100"],
    "query_x": ["query", "-a", "{d}/{f}", "-b", "{d}/w.bed", "-d", "100",
                "-x"],
    "query_x_paf": ["query", "-a", "{d}/{f}", "-r", "ref:300-2800", "-d",
                    "100", "-x", "-o", "paf"],
    "query_approx": ["query", "-a", "{d}/{f}", "-b", "{d}/w.bed", "-d",
                     "100", "-x", "--approximate"],
    "stats": ["stats", "-a", "{d}/{f}"],
    "stats_r": ["stats", "-a", "{d}/{f}", "-b", "{d}/w.bed"],
    "partition": ["partition", "-a", "{d}/{f}", "-w", "700", "-d", "100",
                  "--min-missing-size", "200",
                  "--min-boundary-distance", "200", "--output-folder",
                  "{d}/part"],
    "refine": ["refine", "-a", "{d}/{f}", "-r", "ref:500-2500", "-d", "100",
               "-x", "--span-bp", "300", "--extension-step", "200"],
    "similarity": ["similarity", "-a", "{d}/{f}", "-r", "ref:300-1800",
                   "-d", "100", "-x"],
}
# Commands that take --sequence-files (the others ingest approximately);
# similarity always reads sequences; index takes no engine.
_SEQ = ("query", "query_x", "query_x_paf", "query_approx", "partition",
        "similarity")
_RUNS = [
    (case, seq, engine)
    for case in _CASES
    for seq in ((True,) if case == "similarity" else
                (False, True) if case in _SEQ else (False,))
    for engine in (("host",) if case == "index" else
                   ("host", "native", "device"))
]


@pytest.mark.parametrize(
    "case,seq,engine", _RUNS,
    ids=[f"{c}-{'exact' if s else 'approx'}-{e}" for c, s, e in _RUNS])
@pytest.mark.parametrize("f", ["p.1aln", "b.1aln"], ids=["ascii", "binary"])
def test_cli_on_1aln_input(cli_files, capsys, f, case, seq, engine):
    """A command on a .1aln gives impg_tpu.cli's status, stdout and stderr
    on every engine (impg_tpu's host engine for the port's device), with
    and without --sequence-files (`-I`: each run ingests the file anew).
    Where both refuse the C++ engine, both exit 2 with the same reason."""
    argv = [a.format(d="{d}", f=f) for a in _CASES[case]]
    if case != "index":
        argv.append("-I")
    if seq:
        argv += ["--sequence-files", "{d}/p.fa"]
    opt = lambda e: [] if case == "index" else ["--compute-engine", e]  # noqa
    got = _cli(torch_cli.main, argv + opt(engine), cli_files["port"],
               capsys, device="cpu")
    ref = _cli(jax_cli.main,
               argv + opt("native" if engine == "native" else "host"),
               cli_files["jax"], capsys)
    if ref[0] == ("exit", 2):
        assert got[0] == ref[0] and engine == "native"
        assert got[2][:60] == ref[2][:60]
        return
    assert got == ref
    assert ref[0] == 0
    if case == "partition":
        folders = [os.path.join(cli_files[side], "part")
                   for side in ("port", "jax")]
        files = [{n: _bytes(os.path.join(p, n)) for n in sorted(os.listdir(p))}
                 for p in folders]
        assert files[0] == files[1] and files[0]
    else:
        assert ref[1] or case == "index", ref
