"""The port's copy of the host half against impg_tpu's modules, on the CPU.

impg_tpu_torch keeps its own copies of the modules its query path needs
(core/, io/, index/, ops/projection_np.py, query/engine.py, host_native.py,
merge.py, subset.py, outputs.py, native/*.cpp).  On the same seeded PAFs each
copy must give what its original gives: every index array, the tracepoint
arrays, the projection, the visited bookkeeping, the transitive BFS rows of
every engine, the native engine's rows, the writers' text, and the CLI's
bytes.  The CLI also refuses what it has not ported, with exit status 2,
before it reads any input."""

import contextlib
import gzip
import io
import os
import random
import shutil

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.core import intervals as jax_intervals
from impg_tpu.core.seqidx import SequenceIndex as JaxSeqIndex
from impg_tpu.index import impg_index as jax_index_mod
from impg_tpu.index import tracepoints as jax_tp
from impg_tpu.io import paf as jax_paf
from impg_tpu.ops import projection as jax_projection
from impg_tpu.query import engine as jax_engine
from impg_tpu.query import outputs as jax_outputs
from impg_tpu.query.device import DeviceEngine
from impg_tpu.query.host_native import NativeHostEngine as JaxNative
from impg_tpu_torch.core import intervals as port_intervals
from impg_tpu_torch.core.seqidx import SequenceIndex as PortSeqIndex
from impg_tpu_torch.index import impg_index as port_index_mod
from impg_tpu_torch.index import tracepoints as port_tp
from impg_tpu_torch.io import native as port_native
from impg_tpu_torch.io import paf as port_paf
from impg_tpu_torch.ops import projection_np as port_projection
from impg_tpu_torch.query import engine as port_engine
from impg_tpu_torch.query import outputs as port_outputs
from impg_tpu_torch.query.device import TorchDeviceEngine
from impg_tpu_torch.query.host_native import NativeHostEngine as PortNative
from tests import datagen
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

BLOCK_COLUMNS = ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")


def _write(path, text, gz=False):
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def texts():
    pan, seqs, _ = datagen.pangenome_paf(random.Random(31), n_seqs=10,
                                         seq_len=20_000, cross_links=3)
    rand, _, _ = datagen.random_paf(random.Random(8), n_seqs=5, n_alns=40,
                                    n_ops=24)
    return pan, rand, seqs


def _twin_dirs(tmp_path):
    """One directory per package, so that neither reads the other's
    cached .impgt artifact."""
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    return a, b


def assert_index_equal(got, ref):
    assert list(got.seq_index.names()) == list(ref.seq_index.names())
    assert np.array_equal(got.seq_index.lengths_array(),
                          ref.seq_index.lengths_array())
    for f in ref.records.__dataclass_fields__:
        g, r = getattr(got.records, f), getattr(ref.records, f)
        assert g.dtype == r.dtype and np.array_equal(g, r), f
    for f in ref.arena.EAGER_FIELDS + ref.arena.STATS_FIELDS:
        g, r = getattr(got.arena, f), getattr(ref.arena, f)
        assert g.dtype == r.dtype and np.array_equal(g, r), f
    assert np.array_equal(got.tgt_offsets, ref.tgt_offsets)
    assert got.alignment_files == ref.alignment_files


@pytest.mark.parametrize(
    "variant", ["paf", "paf_gz", "two_files", "no_bidirectional", "reload"]
)
def test_index_arrays_equal(tmp_path, texts, variant):
    pan, rand, _ = texts
    built = []
    for d in _twin_dirs(tmp_path):
        gz = variant == "paf_gz"
        files = [_write(d / ("a.paf.gz" if gz else "a.paf"), rand, gz)]
        if variant == "two_files":
            files.append(_write(d / "b.paf", pan))
        built.append(files)
    (jf, pf) = built
    if variant == "no_bidirectional":
        ref = jax_index_mod.ImpgIndex.from_paf_files(jf, bidirectional=False)
        got = port_index_mod.ImpgIndex.from_paf_files(pf, bidirectional=False)
    else:
        ref = jax_index_mod.load_or_build(jf)
        got = port_index_mod.load_or_build(pf)
        if variant == "reload":  # both read their saved artifacts back
            ref = jax_index_mod.load_or_build(jf)
            got = port_index_mod.load_or_build(pf)
            assert os.path.exists(pf[0] + port_index_mod.INDEX_SUFFIX)
    ref.alignment_files = got.alignment_files  # the paths differ by dir
    assert_index_equal(got, ref)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("require_cigar", [True, False])
def test_parse_paf_equal(texts, use_native, require_cigar):
    pan, rand, _ = texts
    data = (rand + pan).encode()
    js, ps = JaxSeqIndex(), PortSeqIndex()
    ref = jax_paf.parse_paf_bytes(data, js, require_cigar=require_cigar,
                                  use_native=use_native)
    got = port_paf.parse_paf_bytes(data, ps, require_cigar=require_cigar,
                                   use_native=use_native)
    for f in ref.__dataclass_fields__:
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert list(ps.names()) == list(js.names())


def test_parse_paf_errors_equal():
    bad = b"q\t10\t0\t5\t+\tt\t10\t0\t5\t5\t5\t60\tcg:Z:5Q\n"
    msgs = []
    for mod, seq in ((jax_paf, JaxSeqIndex()), (port_paf, PortSeqIndex())):
        with pytest.raises(ValueError) as exc:
            mod.parse_paf_bytes(bad, seq)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_native_library_is_the_ports_own():
    lib = port_native.load()
    assert lib is not None
    assert lib._name == port_native._SO_PATH
    assert port_native._SO_PATH.endswith(
        os.path.join("impg_tpu_torch", "build", "libimpg_torch_native.so"))
    for sym in ("impg_paf_parse_mt", "vb_create", "vb_process32",
                "he_create", "he_run", "sx_extract", "sx_extract_batch",
                "sx_radix_argsort_u64", "impg_gfa_parse_mt",
                "impg_spell_steps", "impg_concat_tokens_mt",
                "impg_topo_priority", "impg_poa_create", "impg_align_pair",
                "impg_align_prefix", "uf_create", "uf_union_runs",
                "impg_seqwish_emit"):
        assert hasattr(lib, sym), sym
    # The syng tools' GBWT is built in too (the eleventh source).
    for sym in ("impg_gbwt_build", "impg_gbwt_match_walk",
                "impg_gbwt_locate_segment"):
        assert hasattr(lib, sym), sym


@pytest.fixture(scope="module")
def twin_indexes(tmp_path_factory, texts):
    pan, _, seqs = texts
    tmp = tmp_path_factory.mktemp("host_twins")
    jd, pd = tmp / "jax", tmp / "port"
    jd.mkdir()
    pd.mkdir()
    ref = jax_index_mod.load_or_build([_write(jd / "pan.paf", pan)])
    got = port_index_mod.load_or_build([_write(pd / "pan.paf", pan)])
    r = random.Random(12)
    names = list(seqs)
    targets = []
    for _ in range(6):
        n = r.choice(names)
        a = r.randint(0, seqs[n] // 2)
        b = r.randint(a + 1500, min(seqs[n], a + 8000))
        targets.append((ref.seq_index.get_id(n), a, b))
    return ref, got, targets


@pytest.mark.parametrize("spacing", [1, 100, 997])
def test_tracepoint_build_equal_at_scale_shape(spacing):
    """The port's build searches each record's runs once (impg_tpu: every
    boundary at once in log2(n_runs) passes): the same arrays on the
    smoke's yeast-fitted index shape, records of hundreds of runs on both
    strands, a record with no runs among them."""
    from impg_tpu_torch import synth

    index = synth.realistic_directed_index(seed=4, n_seqs=40,
                                           seq_len=20_000, n_aln=120)
    index.records.op_cnt[3] = 0
    # The port first: impg_tpu's build materializes the lazy statistics,
    # which the port's sums from the runs.
    gt = port_tp.TracepointArena.build(index.records, index.arena, spacing)
    assert not index.arena.stats_materialized
    rt = jax_tp.TracepointArena.build(index.records, index.arena, spacing)
    assert set(index.records.strand.tolist()) == {0, 1}
    for f in rt.FIELDS:
        g, r = getattr(gt, f), getattr(rt, f)
        assert g.dtype == r.dtype and np.array_equal(g, r), f


@pytest.mark.parametrize("spacing", [1, 100])
@pytest.mark.parametrize("stats", ["lazy", "materialized"])
@pytest.mark.parametrize("case", ["blocks", "no_runs"])
def test_tracepoint_build_blocks_and_segments(monkeypatch, spacing, case,
                                              stats):
    """The port's build in blocks of 3 records equals impg_tpu's build over
    the materialized statistics, whether the port sums them from the runs
    of each record's segment (`lazy`: they stay unbuilt) or reads them;
    `no_runs` gives records with no runs at the first and last place of
    blocks, one of them at the arena's end (its offset clipped to the last
    run, in the middle of another record's segment)."""
    from impg_tpu_torch import synth

    monkeypatch.setattr(port_tp, "BUILD_BLOCK", 3)
    index = synth.realistic_directed_index(seed=5, n_seqs=30,
                                           seq_len=20_000, n_aln=40)
    r, arena = index.records, index.arena
    if case == "no_runs":
        for i in (0, 2, 3, 5, 9, len(r) - 1):
            r.op_cnt[i] = 0
        r.op_off[len(r) - 1] = arena.n_ops
    assert len(r) > 3 * 4 and not arena.stats_materialized
    if stats == "materialized":
        arena.cum_mm  # noqa: B018 -- builds the lazy statistics
    gt = port_tp.TracepointArena.build(r, arena, spacing)
    assert arena.stats_materialized == (stats == "materialized")
    rt = jax_tp.TracepointArena.build(r, arena, spacing)
    for f in rt.FIELDS:
        g, want = getattr(gt, f), getattr(rt, f)
        assert g.dtype == want.dtype and np.array_equal(g, want), f


@pytest.mark.parametrize("spacing", [100, 37])
def test_tracepoint_arrays_equal(twin_indexes, spacing):
    ref, got, targets = twin_indexes
    rt = jax_tp.TracepointArena.build(ref.records, ref.arena, spacing)
    gt = port_tp.TracepointArena.build(got.records, got.arena, spacing)
    assert gt.spacing == rt.spacing
    for f in rt.FIELDS:
        g, r = getattr(gt, f), getattr(rt, f)
        assert g.dtype == r.dtype and np.array_equal(g, r), f
    tid, s, e = targets[0]
    cand = ref.stab(tid, s, e)
    assert cand.size > 2
    rs = np.full(cand.size, s, np.int64)
    re_ = np.full(cand.size, e, np.int64)
    ra = jax_tp.project_batch_approx(rt, ref.records, cand, rs, re_)
    ga = port_tp.project_batch_approx(gt, got.records, cand, rs, re_)
    for f in ra._fields:
        assert np.array_equal(getattr(ga, f), getattr(ra, f)), f
    assert np.array_equal(port_tp.gap_compressed_identity_approx(ga),
                          jax_tp.gap_compressed_identity_approx(ra))


@pytest.mark.parametrize("with_stats", [True, False])
def test_projection_np_equal(twin_indexes, with_stats):
    ref, got, _ = twin_indexes
    rng = np.random.default_rng(3)
    n = 4000
    rec = rng.integers(0, len(ref.records), n)
    ts = ref.records.t_start[rec].astype(np.int64)
    te = ref.records.t_end[rec].astype(np.int64)
    a = rng.integers(ts - 50, te + 50)
    b = a + rng.integers(-5, 3000, n)
    kw = lambda ix: dict(  # noqa: E731
        **ix.arena.projection_kwargs(with_stats=with_stats),
        op_off=ix.records.op_off[rec], op_cnt=ix.records.op_cnt[rec],
        t_start=ix.records.t_start[rec], t_end=ix.records.t_end[rec],
        strand=ix.records.strand[rec], range_start=a.astype(np.int32),
        range_end=b.astype(np.int32), with_stats=with_stats,
    )
    r = jax_projection.project_batch(np, **kw(ref))
    g = port_projection.project_batch(**kw(got))
    for f in r._fields:
        assert np.array_equal(getattr(g, f), getattr(r, f)), f
    assert int(np.asarray(r.valid).sum()) > n // 10
    if with_stats:
        assert np.array_equal(port_projection.gap_compressed_identity(g),
                              jax_projection.gap_compressed_identity(r))
    for i in np.nonzero(r.valid)[0][:50]:
        row = {k: getattr(r, k)[i] for k in
               ("first_run", "last_run", "first_clip", "last_rem")}
        off = int(ref.records.op_off[rec[i]])
        assert np.array_equal(
            port_projection.clipped_runs(got.arena.runs, off, row),
            jax_projection.clipped_runs(ref.arena.runs, off, row),
        )


@pytest.mark.parametrize("min_distance", [0, 10, 200])
def test_sorted_ranges_equal(min_distance):
    rng = random.Random(min_distance)
    r = jax_intervals.SortedRanges(10_000, min_distance)
    g = port_intervals.SortedRanges(10_000, min_distance)
    for _ in range(400):
        a = rng.randint(0, 10_000)
        rg = (a, min(10_000, a + rng.randint(-300, 600)))
        assert g.insert(rg) == r.insert(rg)
        assert g.ranges == r.ranges


def _engines(kind, ref, got, approximate):
    if kind == "host":
        return None, None
    if kind == "native":
        return JaxNative(ref), PortNative(got)
    return (DeviceEngine(ref, with_tracepoints=approximate),
            TorchDeviceEngine(got, "cpu", with_tracepoints=approximate))


@pytest.mark.parametrize("approximate", [False, True],
                         ids=["exact", "approximate"])
@pytest.mark.parametrize("kind", ["host", "native", "device"])
def test_bfs_rows_equal(twin_indexes, kind, approximate):
    ref, got, targets = twin_indexes
    j_eng, p_eng = _engines(kind, ref, got, approximate)
    kw = dict(max_depth=2, columnar=True, approximate=approximate)
    rb = jax_engine.query_transitive_bfs_many(ref, targets, device_engine=j_eng,
                                              **kw)
    gb = port_engine.query_transitive_bfs_many(got, targets,
                                               device_engine=p_eng, **kw)
    assert len(gb) == len(rb) == len(targets)
    total = 0
    for g, r in zip(gb, rb):
        total += len(r)
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(r, col)), col
    assert total > 2 * len(targets)


@pytest.mark.parametrize("mode", ["closed", "walk", "paf"])
def test_native_host_engine_rows_equal(twin_indexes, mode):
    ref, got, targets = twin_indexes
    rb = JaxNative(ref, mode=mode, threads=2).run(targets, max_depth=2)
    gb = PortNative(got, mode=mode, threads=2).run(targets, max_depth=2)
    assert sum(len(b) for b in rb) > len(targets)
    for g, r in zip(gb, rb):
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(r, col)), col


def test_native_host_engine_reads_batch_switch_per_run(twin_indexes,
                                                       monkeypatch):
    """IMPG_HE_BATCH (closed mode's lockstep-batched searches, off at 0) is
    read by each run, not latched for the process: walks run with it off,
    then on, then off again in one process give impg_tpu's rows."""
    ref, got, targets = twin_indexes
    rb = JaxNative(ref, mode="closed", threads=2).run(targets, max_depth=2)
    eng = PortNative(got, mode="closed", threads=2)
    for flag in ("0", "1", "0"):
        monkeypatch.setenv("IMPG_HE_BATCH", flag)
        gb = eng.run(targets, max_depth=2)
        assert len(gb) == len(rb)
        for g, r in zip(gb, rb):
            for col in BLOCK_COLUMNS:
                assert np.array_equal(getattr(g, col), getattr(r, col)), col


@pytest.mark.parametrize("fmt", ["bed", "bed_strands", "bedpe", "paf"])
def test_outputs_text_equal(twin_indexes, fmt):
    """The writers (and the merges inside them) over each package's own
    CIGAR-bearing rows of the same walks."""
    ref, got, targets = twin_indexes
    kw = dict(max_depth=2, store_cigar=fmt in ("bedpe", "paf"))
    texts = []
    for mod, eng, index in ((jax_outputs, jax_engine, ref),
                            (port_outputs, port_engine, got)):
        buf = io.StringIO()
        for rows in eng.query_transitive_bfs_many(index, targets, **kw):
            if fmt.startswith("bed") and fmt != "bedpe":
                mod.write_bed(index.seq_index, rows, buf, "n", 100,
                              fmt == "bed")
            elif fmt == "bedpe":
                mod.write_bedpe(index.seq_index, rows[1:], buf, "n", 100)
            else:
                mod.write_paf(index.seq_index, rows[1:], buf, "n", 100)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert len(texts[0].splitlines()) > len(targets)


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory, texts):
    pan, _, _ = texts
    tmp = tmp_path_factory.mktemp("host_cli")
    dirs = []
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        (d / "pan.paf").write_text(pan)
        (d / "regions.bed").write_text(
            "ref\t1000\t9000\tlocus1\ns2\t500\t7000\tlocus2\n"
            "s5\t3000\t12000\tlocus3\n"
        )
        (d / "subset.txt").write_text("s1\ns3\ns4\ns6\n")
        dirs.append(str(d))
    return dirs


_Q = ["query", "-a", "{d}/pan.paf", "-d", "100"]
CLI_CASES = {
    "query_x_bed": (_Q + ["-r", "ref:1000-9000", "-x", "-o", "bed"], None),
    "query_x_bedpe": (_Q + ["-r", "ref:1000-9000", "-x", "-o", "bedpe"], None),
    "query_x_paf": (_Q + ["-r", "ref:1000-9000", "-x", "-o", "paf"], None),
    "query_x_bed_regions": (_Q + ["-b", "{d}/regions.bed", "-x"], None),
    "query_x_approx_bed": (
        _Q + ["-r", "ref:1000-9000", "-x", "--approximate", "-o", "bed"], None),
    "query_x_approx_bedpe": (
        _Q + ["-b", "{d}/regions.bed", "-x", "--approximate", "-o", "bedpe"],
        None),
    "query_x_bed_paged": (_Q + ["-b", "{d}/regions.bed", "-x"], "65536"),
    "query_plain_paf": (_Q + ["-r", "s3:2000-6000", "-o", "paf"], None),
    "query_dfs_bed": (
        _Q + ["-r", "ref:1000-9000", "-x", "--transitive-dfs"], None),
    "query_filters_bed": (
        _Q + ["-b", "{d}/regions.bed", "-x", "-l", "500",
              "--min-result-identity", "0.9",
              "--subset-sequence-list", "{d}/subset.txt"], None),
    "query_no_merge_bed": (
        ["query", "-a", "{d}/pan.paf", "--no-merge", "-r", "ref:1000-9000",
         "-x", "-m", "3", "--consider-strandness"], None),
    "stats": (["stats", "-a", "{d}/pan.paf"], None),
    "stats_list": (["stats", "-a", "{d}/pan.paf", "--list-sequences"], None),
    "stats_r": (["stats", "-a", "{d}/pan.paf", "-r", "s2:0-9000"], None),
    "stats_b": (["stats", "-a", "{d}/pan.paf", "-b", "{d}/regions.bed"],
                None),
    "stats_b_paged": (
        ["stats", "-a", "{d}/pan.paf", "-b", "{d}/regions.bed"], "65536"),
}


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax(cli_dirs, capsys, monkeypatch, case, engine):
    """The port's CLI prints impg_tpu.cli's bytes (impg_tpu on its host
    engine, the port on its host engine or its device engines on the
    CPU, paged where a budget is set)."""
    argv, budget = CLI_CASES[case]
    outs = []
    for d, main, kw, spec in ((cli_dirs[0], jax_cli.main, {}, "host"),
                              (cli_dirs[1], torch_cli.main,
                               {"device": "cpu"}, engine)):
        if budget and main is torch_cli.main:
            monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", budget)
        args = [a.format(d=d) for a in argv] + ["--compute-engine", spec]
        capsys.readouterr()
        assert main(args, **kw) == 0
        outs.append(capsys.readouterr().out.replace(d, "<dir>"))
    assert outs[1] == outs[0]
    assert len(outs[0].splitlines()) >= 2


@pytest.mark.parametrize("fmt", ["paf", "bedpe"])
def test_cli_paged_stats_formats_match_jax(cli_dirs, capsys, monkeypatch,
                                           fmt):
    """Past the budget, both packages' paged engines refuse the identity
    statistics that paf/bedpe need, with the same status and message."""
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", "65536")
    seen = []
    for d, main, kw in ((cli_dirs[0], jax_cli.main, {}),
                        (cli_dirs[1], torch_cli.main, {"device": "cpu"})):
        capsys.readouterr()
        rc = main(["query", "-a", f"{d}/pan.paf", "-d", "100", "-r",
                   "ref:1000-9000", "-x", "-o", fmt, "--compute-engine",
                   "device"], **kw)
        cap = capsys.readouterr()
        seen.append((rc, cap.out, cap.err))
    assert seen[1] == seen[0]
    assert seen[0][0] == 1 and "without stats arrays" in seen[0][2]


def test_cli_index_then_query(cli_dirs, capsys):
    """`index` writes the artifact that `query` then reads, with
    impg_tpu.cli's messages."""
    errs = []
    for d, main, kw in ((cli_dirs[0], jax_cli.main, {}),
                        (cli_dirs[1], torch_cli.main, {"device": "cpu"})):
        shutil.copy(os.path.join(d, "pan.paf"), os.path.join(d, "idx.paf"))
        capsys.readouterr()
        assert main(["index", "-a", f"{d}/idx.paf"], **kw) == 0
        errs.append(capsys.readouterr().err.replace(d, "<dir>"))
        assert os.path.exists(f"{d}/idx.paf.impgt")
    assert errs[0] == errs[1] and "Indexed" in errs[0]
    capsys.readouterr()
    assert torch_cli.main(["stats", "-a", f"{cli_dirs[1]}/idx.paf"],
                          device="cpu") == 0
    assert "Directed intervals" in capsys.readouterr().out


@pytest.mark.parametrize(
    "argv",
    [
        ["partition", "-a", "missing.syngt", "-w", "1000", "-o", "fasta"],
        ["-v", "1", "similarity", "-a", "missing.1aln", "-r", "x:0-10",
         "--sequence-files", "x.fa"],
        ["refine", "-a", "missing.tpa", "-r", "x:0-10", "-x"],
        ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10", "-o",
         "fasta"],
        ["query", "-a", "missing.paf", "-r", "x:0-10", "-d", "10", "-o",
         "gfa:sort"],
        ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10", "-o",
         "bed", "--sequence-files", "x.fa"],
        ["query", "-a", "missing.1aln", "-r", "x:0-10", "-d", "10"],
        ["stats", "-a", "missing.tpa"],
        ["index", "-a", "missing.syngt"],
    ],
    ids=["partition", "similarity", "refine", "fasta", "gfa_pipeline",
         "sequence_files", "1aln", "tpa", "syngt"],
)
def test_cli_refuses_unported(capsys, argv):
    """These were refused until the port took them: `.syngt`, `.1aln` and
    `.tpa` alignments of partition, similarity, refine, stats, index and
    query, a `.syngt` query's FASTA and sequence files, and `gfa:`
    pipelines.  On the same missing input (the inputs here do not exist)
    each now gives impg_tpu.cli's status and message."""
    res = []
    for main, kw in ((torch_cli.main, {"device": "cpu"}),
                     (jax_cli.main, {})):
        capsys.readouterr()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv, **kw)
        res.append((rc, out.getvalue(), capsys.readouterr().err))
    assert res[0] == res[1] and res[0][0] in (1, 2)
    assert "not yet ported" not in res[0][2]


def test_without_native_library_python_bookkeeping_runs(twin_indexes,
                                                         monkeypatch):
    """When the port's native library cannot be had, `load()` returns None
    (as impg_tpu's does), the native engine refuses, and the BFS runs the
    Python visited bookkeeping with the same rows."""
    ref, got, targets = twin_indexes
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_load_attempted", True)
    assert port_native.load() is None
    with pytest.raises(RuntimeError):
        PortNative(got)
    rb = jax_engine.query_transitive_bfs_many(ref, targets, max_depth=2,
                                              columnar=True)
    gb = port_engine.query_transitive_bfs_many(got, targets, max_depth=2,
                                               columnar=True)
    for g, r in zip(gb, rb):
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(r, col)), col
