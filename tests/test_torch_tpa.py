""".tpa tracepoint containers in the port against impg_tpu, exactly.

Every case of tests/test_tpa.py, held between the two packages on the same
inputs (tests/datagen.mutate_chain_paf, seed 62, alignments on both
strands).  A container is a compressed numpy zip whose bytes carry write
times, so exports are held by their loaded arrays and header fields, not by
bytes.  Ingest is held exactly, with and without sequences, for the
`fastga` and `standard` exports and for crafted containers of the other
encodings (`fastga-nodiff`, `variable`, `mixed` with literal CIGAR items,
records without items); the port's batched ingest without sequences gives
the per-item path's runs.  Through the CLI: `export-tpa` in both modes, and
`index`, `query`, `stats`, `partition`, `refine` and `similarity` on the
exports, on the port's host, native and device (CPU twin) engines, by bytes
against impg_tpu.cli."""

import os
import random
import shutil

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.core.seqidx import SequenceIndex as JaxSeqIndex
from impg_tpu.index import impg_index as jax_index
from impg_tpu.io import tpa as jax_tpa
from impg_tpu.io.fasta import UnifiedSequenceIndex as JaxUSI
from impg_tpu.query import engine as jax_engine
from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.seqidx import SequenceIndex as PortSeqIndex
from impg_tpu_torch.index import impg_index as port_index
from impg_tpu_torch.io import tpa as port_tpa
from impg_tpu_torch.io.fasta import UnifiedSequenceIndex as PortUSI
from impg_tpu_torch.query import engine as port_engine
from tests import datagen
from tests.test_torch_onealn import (_CASES, _RUNS, _bytes, _cli,
                                     _rows_by_coords, _same_records)
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

MODES = ("fastga", "standard")


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def roundtrip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tpa")
    text, seqs, alns, seq_data = datagen.mutate_chain_paf(
        random.Random(62), n_seqs=4, seq_len=3000, return_sequences=True)
    out = {"seqs": seqs, "n_alns": len(alns)}
    for side, idx_mod, tpa in (("jax", jax_index, jax_tpa),
                               ("port", port_index, port_tpa)):
        d = tmp / side
        d.mkdir()
        (d / "p.paf").write_text(text)
        datagen.write_fasta(str(d / "p.fa"), seq_data)
        index = idx_mod.load_or_build([str(d / "p.paf")])
        tp = index.ensure_tracepoints(100)
        for mode in MODES:
            n = tpa.write_tpa(str(d / f"{mode}.tpa"), index.seq_index,
                              index.records, index.arena, tp, tp_type=mode)
            assert n == len(alns)
        out[side] = (str(d), index)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_export_arrays_equal(roundtrip, mode):
    """Same arrays, dtypes and header fields as impg_tpu's export; the
    layout of tests/test_tpa.py (offsets cover the items; fastga target
    deltas sum to the target span, standard query deltas to the query
    span)."""
    jd, pd = roundtrip["jax"][0], roundtrip["port"][0]
    z = _arrays(f"{pd}/{mode}.tpa")
    _same_arrays(_arrays(f"{jd}/{mode}.tpa"), z)
    assert port_tpa.read_trace_spacing(f"{pd}/{mode}.tpa") == 100
    assert str(z["tp_type"]) == mode
    n = len(z["query_id"])
    assert n > 0 and len(z["tp_off"]) == n + 1
    assert z["tp_off"][-1] == len(z["tp_a"]) == len(z["tp_b"])
    assert set(z["strand"].tolist()) == {0, 1}
    for r in range(n):
        lo, hi = int(z["tp_off"][r]), int(z["tp_off"][r + 1])
        if mode == "fastga":
            assert int(z["tp_b"][lo:hi].sum()) == int(z["t_end"][r]) - int(
                z["t_start"][r])
        else:
            assert int(z["tp_a"][lo:hi].sum()) == abs(
                int(z["q_end"][r]) - int(z["q_start"][r]))


@pytest.mark.parametrize("with_seq", [False, True], ids=["approx", "exact"])
@pytest.mark.parametrize("mode", MODES)
def test_parse_equal(roundtrip, mode, with_seq):
    jd, pd = roundtrip["jax"][0], roundtrip["port"][0]
    jf = JaxUSI.from_files([f"{jd}/p.fa"]).fetch_sequence if with_seq else None
    pf = PortUSI.from_files([f"{pd}/p.fa"]).fetch_sequence if with_seq else None
    ref, sp_r = jax_tpa.parse_tpa(f"{jd}/{mode}.tpa", JaxSeqIndex(), jf)
    got, sp_g = port_tpa.parse_tpa(f"{pd}/{mode}.tpa", PortSeqIndex(), pf)
    assert sp_g == sp_r == 100
    _same_records(ref, got)


@pytest.mark.parametrize("with_seq", [False, True], ids=["approx", "exact"])
@pytest.mark.parametrize("mode", MODES)
def test_ingested_index_queries_equal(roundtrip, mode, with_seq):
    """Queries of the .tpa-built index equal impg_tpu's; without sequences
    the whole-sequence answers equal the PAF index's."""
    jd, pd = roundtrip["jax"][0], roundtrip["port"][0]
    jf = JaxUSI.from_files([f"{jd}/p.fa"]).fetch_sequence if with_seq else None
    pf = PortUSI.from_files([f"{pd}/p.fa"]).fetch_sequence if with_seq else None
    ref = jax_index.ImpgIndex.from_paf_files([f"{jd}/{mode}.tpa"],
                                             seq_fetch=jf)
    got = port_index.ImpgIndex.from_paf_files([f"{pd}/{mode}.tpa"],
                                              seq_fetch=pf)
    paf_index = roundtrip["port"][1]
    for name, L in roundtrip["seqs"].items():
        for s, e in ((0, L), (L // 4, 3 * L // 4), (137, 2000)):
            rows = _rows_by_coords(got, port_engine.query(
                got, got.seq_index.get_id(name), s, e))
            assert rows == _rows_by_coords(ref, jax_engine.query(
                ref, ref.seq_index.get_id(name), s, e)), (name, s, e)
            if not with_seq and (s, e) == (0, L):
                assert rows == _rows_by_coords(paf_index, port_engine.query(
                    paf_index, paf_index.seq_index.get_id(name), 0, L))


# Crafted records: (query_id, target_id, strand, qs, qe, ts, te, items),
# items as (kind, a, b).
_I, _C = port_tpa.KIND_PAIR, port_tpa.KIND_CIGAR
_RECORDS = {
    "fastga-nodiff": [
        (0, 1, 0, 37, 950, 12, 940, [(_I, 3, 63), (_I, 1, 100), (_I, 0, 765)]),
        (1, 0, 1, 120, 760, 200, 850, [(_I, 9, 90)] * 7 + [(_I, 0, 20)]),
        (0, 1, 0, 10, 300, 0, 290, []),
        (1, 0, 0, 100, 400, 100, 420, [(_I, 0, 100)] * 3),
    ],
    "variable": [
        (0, 1, 0, 0, 500, 0, 480, [(_I, 100, -1), (_I, 90, 120),
                                   (_I, 290, -1)]),
        (1, 0, 1, 5, 905, 100, 1000, [(_I, 450, 400), (_I, 450, -1)]),
        (0, 1, 1, 50, 350, 60, 380, [(_I, 100, -1), (_I, 100, 100),
                                     (_I, 90, -1)]),
    ],
    "mixed": [
        (0, 1, 0, 0, 210, 10, 210, [(_C, cigar.OP_EQ, 100),
                                    (_C, cigar.OP_I, 10),
                                    (_C, cigar.OP_EQ, 100)]),
        (1, 0, 1, 0, 400, 0, 390, [(_I, 150, 140), (_C, cigar.OP_D, 5),
                                   (_C, cigar.OP_X, 0), (_I, 250, 245)]),
        (0, 1, 0, 300, 700, 300, 700, [(_I, 200, 200), (_I, 200, 200)]),
        (1, 0, 0, 0, 100, 0, 100, []),
        (0, 1, 0, 500, 800, 500, 790, [(_I, 150, 150),
                                       (_C, cigar.OP_EQ, 100)]),
    ],
}


def _write_crafted(path, tp_type, records):
    si = JaxSeqIndex()
    si.get_or_insert_id("a", 1200)
    si.get_or_insert_id("b", 1300)
    names, lengths = si.to_arrays()
    items = [it for rec in records for it in rec[7]]
    np.savez_compressed(
        path + ".npz",
        version=np.int64(1), tp_type=np.str_(tp_type),
        complexity_metric=np.str_("edit"), max_complexity=np.int64(100),
        distance=np.str_("edit"), names=names.astype(str),
        lengths=np.asarray(lengths, np.int64),
        query_id=np.asarray([r[0] for r in records], np.int32),
        target_id=np.asarray([r[1] for r in records], np.int32),
        strand=np.asarray([r[2] for r in records], np.int8),
        q_start=np.asarray([r[3] for r in records], np.int64),
        q_end=np.asarray([r[4] for r in records], np.int64),
        t_start=np.asarray([r[5] for r in records], np.int64),
        t_end=np.asarray([r[6] for r in records], np.int64),
        tp_kind=np.asarray([i[0] for i in items], np.uint8),
        tp_a=np.asarray([i[1] for i in items], np.int64),
        tp_b=np.asarray([i[2] for i in items], np.int64),
        tp_off=np.cumsum([0] + [len(r[7]) for r in records]),
    )
    os.replace(path + ".npz", path)


@pytest.mark.parametrize("with_seq", [False, True], ids=["approx", "exact"])
@pytest.mark.parametrize("tp_type", list(_RECORDS))
def test_other_encodings_parse_equal(tmp_path, tp_type, with_seq):
    """fastga-nodiff, variable (absent query deltas take the spacing) and
    mixed (literal CIGAR items, one of length 0, beside pairs), on both
    strands, with records of no item and records whose target deltas fall
    short of the span (the last bound forced to te): the port's parse equals
    impg_tpu's.  With sequences, random bases of the declared lengths."""
    path = str(tmp_path / "c.tpa")
    _write_crafted(path, tp_type, _RECORDS[tp_type])
    fasta = str(tmp_path / "c.fa")
    if with_seq:
        rng = random.Random(9)
        datagen.write_fasta(fasta, {
            n: "".join(rng.choice("ACGT") for _ in range(L))
            for n, L in (("a", 1200), ("b", 1300))})
    fetch = lambda usi: (  # noqa: E731
        usi.from_files([fasta]).fetch_sequence if with_seq else None)
    ref, _ = jax_tpa.parse_tpa(path, JaxSeqIndex(), fetch(JaxUSI))
    got, _ = port_tpa.parse_tpa(path, PortSeqIndex(), fetch(PortUSI))
    _same_records(ref, got)
    if tp_type == "mixed" and not with_seq:
        runs = got.runs[got.run_offsets[0]:got.run_offsets[1]]
        assert cigar.run_len(runs).tolist() == [100, 10, 100]
        assert cigar.run_op(runs).tolist() == [cigar.OP_EQ, cigar.OP_I,
                                               cigar.OP_EQ]


def test_bad_containers_rejected_equal(tmp_path):
    """An unknown version or tp_type gives impg_tpu's error."""
    for field, value in (("version", np.int64(2)),
                         ("tp_type", np.str_("bogus"))):
        path = str(tmp_path / f"{field}.tpa")
        _write_crafted(path, "mixed", _RECORDS["mixed"])
        z = _arrays(path)
        z[field] = value
        np.savez_compressed(path + ".npz", **z)
        os.replace(path + ".npz", path)
        msgs = []
        for tpa, si in ((jax_tpa, JaxSeqIndex), (port_tpa, PortSeqIndex)):
            with pytest.raises(ValueError) as exc:
                tpa.parse_tpa(path, si())
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mode", MODES)
def test_cli_export_tpa(roundtrip, capsys, mode):
    res, arrays = [], []
    for main, side, kw in ((jax_cli.main, "jax", {}),
                           (torch_cli.main, "port", {"device": "cpu"})):
        d = roundtrip[side][0]
        res.append(_cli(main, ["export-tpa", "-a", "{d}/p.paf", "--tp-mode",
                               mode, "-o", "{d}/cli.tpa"], d, capsys, **kw))
        arrays.append(_arrays(f"{d}/cli.tpa"))
    assert res[0] == res[1] and res[0][0] == 0 and "Wrote" in res[0][2]
    _same_arrays(*arrays)


@pytest.fixture(scope="module")
def cli_files(roundtrip, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tpa_cli")
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


@pytest.mark.parametrize(
    "case,seq,engine", _RUNS,
    ids=[f"{c}-{'exact' if s else 'approx'}-{e}" for c, s, e in _RUNS])
@pytest.mark.parametrize("f", [f"{m}.tpa" for m in MODES], ids=MODES)
def test_cli_on_tpa_input(cli_files, capsys, f, case, seq, engine):
    """tests/test_torch_onealn.py's commands on a .tpa: impg_tpu.cli's
    status, stdout, stderr and partition files on every engine."""
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
        files = [{n: _bytes(os.path.join(p, n)) for n in sorted(os.listdir(p))}
                 for p in (os.path.join(cli_files[s], "part")
                           for s in ("port", "jax"))]
        assert files[0] == files[1] and files[0]
    else:
        assert ref[1] or case == "index", ref
