"""The port's pairwise aligner, all-vs-all alignment, seqwish induction and
the seqwish, syng-native and pggb region-graph engines against impg_tpu's,
on the CPU.

ops/align.py's `align_pair`, `align_pair_wfa` and `align_extend` (CIGAR
runs; consumed and matched bases) on random and crafted pairs, an empty side
and a pair past the Gotoh cell cap among them; commands/align.py's
`align_sequence_pair`, `select_pairs` and `run_align`;
graph/seqwish.py's `induce_graph`
with the native and the Python emit over rows on both strands;
graph/region.py's `generate_gfa_seqwish` for `seqwish`, `syng-native` and
`pggb` (with and without `skip_normalize`); and the CLI's `query -o gfa
--gfa-engine seqwish|pggb|syng-native` and `-o vcf --gfa-engine seqwish`
byte for byte against impg_tpu.cli on the port's host, native and device
(the kernels' plain twins) engines.  The panel is
`synth.panel_alignments(seed=7)` cut to 10 haplotypes of 12 kb (every third
stored reverse complemented), walked over 1-1.5 kb windows of `base`.  The
port's native code is its own build of the same C++ sources
(io/native.py); impg_tpu's runs from the tests' private build
(tests/torch_reference_native.py).  Exact throughout: bytes and arrays."""

import contextlib
import io

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.commands import align as jax_align_cmd
from impg_tpu.commands import similarity as jax_sim
from impg_tpu.graph import region as jax_region
from impg_tpu.graph import seqwish as jax_seqwish
from impg_tpu.index import impg_index as jax_index
from impg_tpu.io import fasta as jax_fasta
from impg_tpu.ops import align as jax_align
from impg_tpu.query import engine as jax_engine
from impg_tpu.syng.index import SyngIndex as JaxSyng
from impg_tpu_torch import synth
from impg_tpu_torch.commands import align as port_align_cmd
from impg_tpu_torch.commands import similarity as port_sim
from impg_tpu_torch.graph import region as port_region
from impg_tpu_torch.graph import seqwish as port_seqwish
from impg_tpu_torch.index import impg_index as port_index
from impg_tpu_torch.io import fasta as port_fasta
from impg_tpu_torch.io import native as port_native
from impg_tpu_torch.ops import align as port_align
from impg_tpu_torch.query import engine as port_engine
from impg_tpu_torch.syng.index import SyngIndex as PortSyng
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutant(rng, seq: bytes, rate: float) -> bytes:
    """`seq` with substitutions and 1-3 bp indels at `rate` a base."""
    out = bytearray()
    for b in seq:
        r = rng.random()
        if r < rate * 0.6:
            out.append(int(BASES[rng.integers(4)]))
        elif r < rate * 0.8:
            continue
        elif r < rate:
            out.append(b)
            out.extend(BASES[rng.integers(0, 4, rng.integers(1, 4))].tobytes())
        else:
            out.append(b)
    return bytes(out)


def _pairs():
    rng = np.random.default_rng(11)
    a = BASES[rng.integers(0, 4, 300)].tobytes()
    long_a = BASES[rng.integers(0, 4, 2500)].tobytes()
    return {
        "empty_query": (b"", b"ACGTACGT"),
        "empty_target": (b"ACGTAC", b""),
        "both_empty": (b"", b""),
        "identical": (a, a),
        "snps_indels": (a, _mutant(rng, a, 0.05)),
        "divergent": (a, BASES[rng.integers(0, 4, 280)].tobytes()),
        "lowercase_n": (a[:100].lower() + b"NNNN" + a[100:], a),
        "homopolymer": (b"A" * 60 + b"C" * 40, b"A" * 45 + b"C" * 52),
        # Past 2^22 cells: the WFA route of impg_align_pair.
        "wfa_route": (long_a, _mutant(rng, long_a, 0.01)),
    }


PAIRS = _pairs()


@pytest.mark.parametrize("scoring", [(1, 4, 6, 2), (2, 3, 5, 1)])
@pytest.mark.parametrize("case", list(PAIRS))
def test_align_entry_points_equal_jax(case, scoring):
    q, t = PAIRS[case]
    for fn in ("align_pair", "align_pair_wfa"):
        got = getattr(port_align, fn)(q, t, scoring)
        ref = getattr(jax_align, fn)(q, t, scoring)
        assert (got is None) == (ref is None), fn
        if got is not None:
            assert got.dtype == ref.dtype and got.tolist() == ref.tolist(), fn
    assert port_align.align_extend(q, t, scoring) == \
        jax_align.align_extend(q, t, scoring)
    assert port_align.align_extend(t, q, scoring) == \
        jax_align.align_extend(t, q, scoring)


@pytest.mark.parametrize("fn", ["align_pair", "align_extend"])
def test_align_too_large_raises_as_jax(fn):
    """A divergent pair past the Gotoh cell cap (2^28 cells), where WFA
    declines too: the same ValueError."""
    rng = np.random.default_rng(3)
    q = BASES[rng.integers(0, 4, 17_000)].tobytes()
    t = BASES[rng.integers(0, 4, 16_000)].tobytes()
    msgs = []
    for mod in (port_align, jax_align):
        with pytest.raises(ValueError) as e:
            getattr(mod, fn)(q, t)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_native_library_has_the_new_sources():
    lib = port_native.load()
    assert lib is not None
    for sym in ("impg_align_pair", "impg_align_wfa", "impg_align_prefix",
                "uf_create", "uf_union_runs", "uf_find_all",
                "impg_seqwish_emit", "impg_seqwish_emit_free"):
        assert hasattr(lib, sym), sym
    assert port_native._SRC_NAMES[-3:] == ("align.cpp", "seqwish_uf.cpp",
                                           "seqwish_emit.cpp")


def test_align_without_native_library_raises(monkeypatch):
    monkeypatch.setattr(port_native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native alignment library"):
        port_align.align_pair(b"ACGT", b"ACGA")


# ---- region sequences of the panel ----------------------------------------


WINDOWS = [(3000, 4500), (7000, 8000)]


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """Each package's index, sequence index, walks of WINDOWS and region
    sequences (forward, as the region engines see them); the panel's files
    for the CLI; and `raw`, each window's span on base, the founders and
    the haplotypes as stored, reverse-complemented haplotypes included."""
    seqs, paf = synth.panel_alignments(seed=7, n_haps=10, length=12_000)
    tmp = tmp_path_factory.mktemp("seqwish_panel")
    (tmp / "panel.paf").write_text(paf)
    synth.write_fasta(str(tmp / "panel.fa"), seqs)
    sides = {}
    for side, idx_mod, fa_mod, eng, sim in (
            ("jax", jax_index, jax_fasta, jax_engine, jax_sim),
            ("port", port_index, port_fasta, port_engine, port_sim)):
        index = idx_mod.ImpgIndex.from_paf_files([str(tmp / "panel.paf")])
        seq_idx = fa_mod.UnifiedSequenceIndex.from_files(
            [str(tmp / "panel.fa")])
        rid = index.seq_index.get_id("base")
        walks = eng.query_transitive_bfs_many(
            index, [(rid, s, e) for s, e in WINDOWS], max_depth=2)
        regions = []
        for w in walks:
            pairs = sim.prepare_sequences(index, list(w), seq_idx)
            regions.append({m.path_name(): s for s, m in pairs})
        sides[side] = (index, seq_idx, walks, regions)
    raw = []
    for s, e in WINDOWS:
        raw.append({})
        for name, seq in seqs[:12]:
            rev = name.startswith("hap") and int(name[3:]) % 3 == 2
            lo, hi = (len(seq) - e, len(seq) - s) if rev else (s, e)
            raw[-1][name] = seq[lo:hi]
    sides["raw"] = raw
    return tmp, sides


def test_region_sequences_have_both_strands(panel):
    _, sides = panel
    assert sides["port"][3] == sides["jax"][3]
    index, seq_idx, walks, _ = sides["port"]
    meta = [m for _, m in port_sim.prepare_sequences(
        index, list(walks[0]), seq_idx)]
    assert {m.strand for m in meta} == {"+", "-"}
    assert len(meta) >= 10


def _rows_fields(rows):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in r.items()} for r in rows]


@pytest.mark.parametrize("w", range(len(WINDOWS)))
def test_align_sequence_pair_equals_jax(panel, w):
    _, sides = panel
    seqs = sides["raw"][w]
    port_syng = PortSyng.build(list(seqs.items()))
    jax_syng = JaxSyng.build(list(seqs.items()))
    names = list(seqs)
    n_rows = 0
    strands = set()
    for q in names[::2]:
        for t in names:
            if q == t:
                continue
            got = port_align_cmd.align_sequence_pair(port_syng, seqs, q, t)
            ref = jax_align_cmd.align_sequence_pair(jax_syng, seqs, q, t)
            assert _rows_fields(got) == _rows_fields(ref), (q, t)
            n_rows += len(got)
            strands |= {r["strand"] for r in got}
    assert n_rows >= 20 and strands == {"+", "-"}
    cfg = dict(min_anchors=5, max_gap=200, min_chain_span=300)
    got = port_align_cmd.align_sequence_pair(
        port_syng, seqs, names[0], names[1], port_align_cmd.AlignConfig(**cfg))
    assert _rows_fields(got) == _rows_fields(jax_align_cmd.align_sequence_pair(
        jax_syng, seqs, names[0], names[1], jax_align_cmd.AlignConfig(**cfg)))


@pytest.mark.parametrize("strategy", ["none", "random:0.3", "knn:2", "knn:1",
                                      "bogus:1"])
def test_select_pairs_equals_jax(panel, strategy):
    _, sides = panel
    seqs = sides["port"][3][0]
    # PanSN names (sample#hap#contig), two contigs a group, and bare names.
    pansn = {f"s{i // 4}#{i // 2 % 2}#c{i % 2}": s
             for i, s in enumerate(seqs.values())}
    for named in (seqs, pansn):
        names = list(named)
        res = []
        for mod in (port_align_cmd, jax_align_cmd):
            try:
                res.append(mod.select_pairs(names, named, strategy,
                                            mash_k=11, sketch_size=200))
            except ValueError as e:
                res.append(str(e))
        assert res[0] == res[1]
    a, b = list(seqs.values())[:2]
    sa = port_align_cmd.mash_sketch(a, 11, 200)
    sb = port_align_cmd.mash_sketch(b, 11, 200)
    assert sa.tolist() == jax_align_cmd.mash_sketch(a, 11, 200).tolist()
    assert port_align_cmd.mash_distance(sa, sb, 11) == \
        jax_align_cmd.mash_distance(sa, sb, 11)


@pytest.mark.parametrize("sparsify", ["none", "knn:2"])
def test_run_align_equals_jax(panel, tmp_path, sparsify):
    """`run_align` (the `align` command's body): PAF text over a FASTA of
    one window's sequences as stored, both strands."""
    _, sides = panel
    fa = tmp_path / "w.fa"
    synth.write_fasta(str(fa), list(sides["raw"][1].items()))
    outs = []
    for mod in (port_align_cmd, jax_align_cmd):
        buf = io.StringIO()
        n = mod.run_align([str(fa)], buf,
                          mod.AlignConfig(sparsify=sparsify, mash_k=11))
        outs.append((n, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] >= 20 and "\t-\t" in outs[0][1]


@pytest.mark.parametrize("emit", ["native", "python"])
@pytest.mark.parametrize("w", range(len(WINDOWS)))
def test_induce_graph_equals_jax(panel, w, emit):
    """Both strands' rows; the native emit equals the Python emit."""
    _, sides = panel
    seqs = sides["raw"][w]
    syng = JaxSyng.build(list(seqs.items()))
    names = list(seqs)
    rows = [r for q in names for t in names if q != t
            for r in jax_align_cmd.align_sequence_pair(syng, seqs, q, t)]
    assert {r["strand"] for r in rows} == {"+", "-"}
    python = emit == "python"
    got = port_seqwish.induce_graph(seqs, rows, force_python_emit=python)
    assert got == jax_seqwish.induce_graph(seqs, rows,
                                           force_python_emit=python)
    assert got == jax_seqwish.induce_graph(seqs, rows,
                                           force_python_emit=not python)
    assert got.count("\nP\t") == len(seqs)


def test_induce_graph_python_union_find_equals_native(panel, monkeypatch):
    """Without the native library the pure-Python union-find and emit give
    the same text."""
    _, sides = panel
    seqs = dict(list(sides["port"][3][1].items())[:5])
    syng = PortSyng.build(list(seqs.items()))
    names = list(seqs)
    rows = [r for q in names for t in names if q != t
            for r in port_align_cmd.align_sequence_pair(syng, seqs, q, t)]
    native = port_seqwish.induce_graph(seqs, rows)
    monkeypatch.setattr(port_native, "load", lambda: None)
    assert port_seqwish.induce_graph(seqs, rows) == native


@pytest.mark.parametrize("engine,skip", [("seqwish", False),
                                         ("syng-native", False),
                                         ("pggb", False), ("pggb", True)])
@pytest.mark.parametrize("w", range(len(WINDOWS)))
def test_generate_gfa_seqwish_equals_jax(panel, w, engine, skip):
    _, sides = panel
    texts = []
    for side, mod in (("jax", jax_region), ("port", port_region)):
        index, seq_idx, walks, _ = sides[side]
        texts.append(mod.generate_gfa_seqwish(
            index, list(walks[w]), seq_idx, engine=engine,
            skip_normalize=skip))
    assert texts[0] == texts[1]
    assert texts[0].count("\nP\t") >= 10


# ---- the CLI ---------------------------------------------------------------


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv, **kw)
        except SystemExit as e:
            rc = ("exit", e.code)
    return rc, out.getvalue(), err.getvalue()


CLI_CASES = {
    "seqwish": ["-o", "gfa", "--gfa-engine", "seqwish"],
    "syng_native": ["-o", "gfa", "--gfa-engine", "syng-native"],
    "pggb": ["-o", "gfa", "--gfa-engine", "pggb"],
    "vcf_seqwish": ["-o", "vcf", "--gfa-engine", "seqwish"],
}


@pytest.mark.parametrize("engine", ["host", "native", "device"])
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_query_seqwish_cli_matches_jax(panel, case, engine):
    tmp, _ = panel
    argv = ["query", "-a", f"{tmp}/panel.paf", "-r", "base:3000-4500", "-x",
            "-m", "2", "-d", "0", "--sequence-files", f"{tmp}/panel.fa",
            *CLI_CASES[case], "--compute-engine"]
    got = _run(torch_cli.main, argv + [engine], device="cpu")
    ref = _run(jax_cli.main, argv + ["native" if engine == "native"
                                     else "host"])
    assert got == ref
    assert ref[0] == 0 and len(ref[1].splitlines()) > 10
