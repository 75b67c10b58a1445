"""The syng tools and `-o gbwt` in the port against impg_tpu, exactly.

Every case of tests/test_gbwt.py (the syncmer-walk GBWT: walks, MEMs,
locate, node counts, its cache), tests/test_syng2gfa.py (blunt and raw
graphs, N-gap cutting, GFA 1.1 walks), the `syng-repair` case of
tests/test_syng.py and the `infer`/`read-index` cases of
tests/test_map_genotype.py, held between the two packages on the same
seeded inputs: results by value, CLI output by bytes, `.syngt` and
`.readidx` artifacts (numpy zips whose bytes carry write times) by their
members' bytes.  `query -o gbwt` runs on the alignment route (the walk on
the port's host, native and device (CPU twin) engines) and on the `.syngt`
route."""

import os
import random
import zipfile

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.commands import infer as jax_infer
from impg_tpu.io.fasta import UnifiedSequenceIndex as JaxUSI
from impg_tpu.io.fasta import reverse_complement
from impg_tpu.syng import gbwt as jax_gbwt
from impg_tpu.syng import map as jax_map
from impg_tpu.syng import pack as jax_pack
from impg_tpu.syng import read_index as jax_read_index
from impg_tpu.syng import syng2gfa as jax_s2g
from impg_tpu.syng.index import SyngIndex as JaxSyng
from impg_tpu_torch.commands import infer as port_infer
from impg_tpu_torch.io import native as port_native
from impg_tpu_torch.io.fasta import UnifiedSequenceIndex as PortUSI
from impg_tpu_torch.syng import gbwt as port_gbwt
from impg_tpu_torch.syng import map as port_map
from impg_tpu_torch.syng import pack as port_pack
from impg_tpu_torch.syng import read_index as port_read_index
from impg_tpu_torch.syng import syng2gfa as port_s2g
from impg_tpu_torch.syng.index import SyngIndex as PortSyng
from tests import datagen
from tests.test_torch_onealn import _cli
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def _rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n)).encode()


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_native_library_binds_gbwt():
    lib = port_native.load()
    for sym in ("impg_gbwt_build", "impg_gbwt_destroy",
                "impg_gbwt_num_steps", "impg_gbwt_node_count",
                "impg_gbwt_match_walk", "impg_gbwt_locate_segment"):
        assert hasattr(lib, sym), sym


# ── the GBWT (tests/test_gbwt.py) ────────────────────────────────────


@pytest.fixture(scope="module")
def gbwt_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gbwt")
    rng = random.Random(11)
    a = _rand_seq(rng, 6000)
    shared = a[2000:4000]
    b = _rand_seq(rng, 1500) + shared + _rand_seq(rng, 1500)
    c = _rand_seq(rng, 1000) + reverse_complement(shared) + _rand_seq(rng,
                                                                        1000)
    fa = str(tmp / "g.fa")
    datagen.write_fasta(fa, {"A": a.decode(), "B": b.decode(),
                             "C": c.decode()})
    ref = JaxSyng.build_from_fasta([fa])
    got = PortSyng.build_from_fasta([fa])
    return (jax_gbwt.SyngGbwt(ref), port_gbwt.SyngGbwt(got), a)


def _mems(mems):
    return [(m.step_start, m.step_end, m.query_start, m.query_end,
             m.anchors, m.occurrences) for m in mems]


def _hits(hits):
    return [(h.path, h.path_id, h.step, h.bp, h.forward) for h in hits]


_READS = {
    "whole": lambda a: a,
    "shared": lambda a: a[2300:3700],
    "rc": lambda a: reverse_complement(a[2300:3700]),
    "junction": lambda a: a[500:1500] + a[4500:5500],
    "inner": lambda a: a[1000:2000],
}


@pytest.mark.parametrize("read", list(_READS))
def test_walks_mems_and_locate_equal(gbwt_fixture, read):
    """Walks (both orientations), MEMs, located occurrences and node counts
    equal impg_tpu's, with tests/test_gbwt.py's facts: the shared segment
    occurs on all three paths (C reverse-complemented), a chimeric read
    gives two MEMs, an indexed sequence matches end to end, and counts are
    symmetric under negation."""
    ref, got, a = gbwt_fixture
    seq = _READS[read](a)
    for g in (ref, got):
        assert g.n_paths == 3
    wr, wg = ref.walk_from_sequence(seq), got.walk_from_sequence(seq)
    for x, y in zip(wr, wg):
        np.testing.assert_array_equal(x, y)
    br, bg = ref.best_orientation_walk(seq), got.best_orientation_walk(seq)
    np.testing.assert_array_equal(br[0], bg[0])
    np.testing.assert_array_equal(br[1], bg[1])
    assert br[2] == bg[2]
    nodes, bpos, _ = bg
    mems = got.mems_for_walk(nodes, bpos)
    assert _mems(mems) == _mems(ref.mems_for_walk(nodes, bpos))
    best = max(mems, key=lambda m: m.anchors)
    hits = got.locate_segment(nodes, bpos, best.step_start, best.step_end)
    assert _hits(hits) == _hits(ref.locate_segment(
        nodes, bpos, best.step_start, best.step_end))
    assert len(hits) == best.occurrences
    inner = nodes[nodes != 0][:10]
    counts = [got.node_count(int(n)) for n in inner]
    assert counts == [ref.node_count(int(n)) for n in inner]
    assert counts == [got.node_count(-int(n)) for n in inner]
    if read in ("shared", "rc"):
        assert best.occurrences == 3
        assert {h.path for h in hits} == {"A", "B", "C"}
        # C carries the segment reverse-complemented.
        c_forward = [h for h in hits if h.path == "C"][0].forward
        assert bool(c_forward) == (read == "rc")
    elif read == "junction":
        assert len(mems) >= 2
    else:
        assert max(m.anchors for m in mems) == nodes.size


def test_offsets_gate_matching(gbwt_fixture):
    """A bent bp offset splits the match, as in impg_tpu."""
    ref, got, a = gbwt_fixture
    nodes, bpos = got.walk_from_sequence(a[1000:2000])
    bent = bpos.copy()
    bent[nodes.size // 2:] += np.uint64(3)
    mems = got.mems_for_walk(nodes, bent)
    assert _mems(mems) == _mems(ref.mems_for_walk(nodes, bent))
    assert max(m.anchors for m in mems) < nodes.size and len(mems) >= 2


def test_locate_segment_bounds_and_cache(gbwt_fixture):
    ref, got, a = gbwt_fixture
    nodes, bpos = got.walk_from_sequence(a[:500])
    msgs = []
    for g in (ref, got):
        with pytest.raises(ValueError) as exc:
            g.locate_segment(nodes, bpos, 0, nodes.size + 1)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert got.mems_for_walk(nodes[:0], bpos[:0]) == []
    assert port_gbwt.gbwt_for_index(got.index) is port_gbwt.gbwt_for_index(
        got.index)


# ── `query -o gbwt` ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def gbwt_dirs(tmp_path_factory):
    text, _, _, seq_data = datagen.mutate_chain_paf(
        random.Random(77), n_seqs=3, seq_len=9000, return_sequences=True)
    tmp = tmp_path_factory.mktemp("torch_query_gbwt")
    out = {}
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        (d / "p.paf").write_text(text)
        datagen.write_fasta(str(d / "p.fa"), seq_data)
        (d / "w.bed").write_text("ref\t1000\t3000\nref\t2500\t6000\n"
                                 "s1\t100\t900\n")
        JaxSyng.build_from_fasta([str(d / "p.fa")]).save(str(d / "pan"))
        out[side] = str(d)
    return out


_GBWT_CASES = {
    "paf": ["-a", "{d}/p.paf", "-r", "ref:1000-5000"],
    "paf_x": ["-a", "{d}/p.paf", "-r", "ref:1000-5000", "-x"],
    "paf_bed_x": ["-a", "{d}/p.paf", "-b", "{d}/w.bed", "-x"],
    "syngt": ["-a", "{d}/pan.syngt", "-r", "ref:1000-5000"],
    "syngt_x": ["-a", "{d}/pan.syngt", "-r", "ref:1000-5000", "-x"],
    "syngt_bed": ["-a", "{d}/pan.syngt", "-b", "{d}/w.bed"],
}
# The C++ engine walks transitively only: it takes the `-x` alignment runs.
_GBWT_RUNS = [(c, e) for c in _GBWT_CASES
              for e in (("host", "native", "device") if c.startswith("paf_")
                        else ("host", "device") if c == "paf"
                        else ("host",))]


@pytest.mark.parametrize("case,engine", _GBWT_RUNS,
                         ids=[f"{c}-{e}" for c, e in _GBWT_RUNS])
def test_query_o_gbwt(gbwt_dirs, capsys, case, engine):
    """The regional `.syngt` holds the same arrays (member bytes) as
    impg_tpu's, with its stderr; the alignment route walks on every engine,
    the `.syngt` route keeps the parent's syncmer parameters."""
    argv = ["query", *_GBWT_CASES[case], "-d", "100", "-o", "gbwt",
            "--sequence-files", "{d}/p.fa", "-O", "{d}/region_%s" % case]
    extra = ["--compute-engine", engine] if case.startswith("paf") else []
    got = _cli(torch_cli.main, argv + extra, gbwt_dirs["port"], capsys,
               device="cpu")
    ref = _cli(jax_cli.main, argv + (
        ["--compute-engine", "native" if engine == "native" else "host"]
        if extra else []), gbwt_dirs["jax"], capsys)
    assert got == ref and ref[0] == 0 and ref[1] == ""
    assert "Wrote region syng index" in ref[2]
    paths = [os.path.join(gbwt_dirs[s], f"region_{case}.syngt")
             for s in ("port", "jax")]
    assert _members(paths[0]) == _members(paths[1])
    regional = PortSyng.load(paths[0])
    assert any(n.startswith("ref:") for n in regional.seq_index.names())
    assert len(regional.seq_index) >= 2


@pytest.mark.parametrize("argv", [
    ["-a", "{d}/p.paf", "-o", "gbwt", "-O", "{d}/x"],
    ["-a", "{d}/p.paf", "-o", "gbwt", "--sequence-files", "{d}/p.fa"],
    ["-a", "{d}/pan.syngt", "-o", "gbwt", "-O", "{d}/x"],
    ["-a", "{d}/p.paf", "-o", "gbwt", "-O", "{d}/x", "--sequence-files",
     "{d}/p.fa", "--approximate"],
    ["-a", "{d}/missing.paf", "-o", "gbwt", "-O", "{d}/x",
     "--sequence-files", "{d}/p.fa"],
], ids=["no_sequences", "no_prefix", "syngt_no_sequences", "approximate",
        "missing"])
def test_query_o_gbwt_errors_equal(gbwt_dirs, capsys, argv):
    full = ["query", *argv, "-r", "ref:0-100", "-d", "10"]
    got = _cli(torch_cli.main, full, gbwt_dirs["port"], capsys, device="cpu")
    ref = _cli(jax_cli.main, full, gbwt_dirs["jax"], capsys)
    assert got == ref and ref[0] in (1, 2)


# ── syng2gfa (tests/test_syng2gfa.py) ────────────────────────────────


def _panel_fasta(tmp_path, kind):
    rng = random.Random({"panel": 41, "cli": 42}.get(kind, 5))
    if kind in ("panel", "cli"):
        _, _, _, data = datagen.mutate_chain_paf(
            rng, n_seqs=3, seq_len=5000, return_sequences=True)
    elif kind == "rc":
        fwd = "".join(rng.choice("ACGT") for _ in range(4000))
        data = {"fwd": fwd,
                "rev": reverse_complement(fwd.encode()).decode()}
    elif kind == "raw":
        a = "".join(rng.choice("ACGT") for _ in range(3000))
        data = {"A": a, "B": a[:1200] + "".join(
            rng.choice("ACGT") for _ in range(40)) + a[1240:]}
    else:  # "ns"
        rng = random.Random(9)
        left = "".join(rng.choice("ACGT") for _ in range(2000))
        right = "".join(rng.choice("ACGT") for _ in range(2000))
        data = {"s1": left + "N" * 50 + right,
                "s2": left + "N" * 50 + right[:1500],
                "s3": left + "NNNNN" + right}
    fa = str(tmp_path / f"{kind}.fa")
    datagen.write_fasta(fa, data)
    return fa, data


_S2G = {
    "blunt": ("panel", {}),
    "rc_blunt": ("rc", {}),
    "raw": ("raw", {"mode": "raw"}),
    "rc_raw": ("rc", {"mode": "raw"}),
    "cut_ns": ("ns", {"cut_n_gaps": True, "cut_n_min_run": 10}),
    "ns_uncut": ("ns", {}),
    "privatized": ("panel", {"drop_top_fraction": 0.05}),
    "max_occurrences": ("panel", {"max_occurrences": 1}),
    "raw_privatized": ("panel", {"mode": "raw", "max_occurrences": 2}),
}


def _spell(text):
    segs, paths = {}, {}
    for line in text.splitlines():
        f = line.split("\t")
        if f[0] == "S":
            segs[f[1]] = f[2].encode()
        elif f[0] == "P":
            paths[f[1]] = b"".join(
                reverse_complement(segs[s[:-1]]) if s[-1] == "-"
                else segs[s[:-1]] for s in f[2].split(","))
    return paths


@pytest.mark.parametrize("case", list(_S2G))
def test_syng_to_gfa_equal(tmp_path, case):
    """The GFA text equals impg_tpu's; every blunt path spells its source
    exactly (with --cut-ns, its parts spell it without the long N run)."""
    kind, kw = _S2G[case]
    fa, data = _panel_fasta(tmp_path, kind)
    text = port_s2g.syng_to_gfa(PortSyng.build_from_fasta([fa]),
                                PortUSI.from_files([fa]), **kw)
    assert text == jax_s2g.syng_to_gfa(JaxSyng.build_from_fasta([fa]),
                                       JaxUSI.from_files([fa]), **kw)
    if kw.get("mode") == "raw":
        return
    spelled = _spell(text)
    for name, seq in data.items():
        parts = sorted(p for p in spelled if p.split("|")[0] == name)
        joined = b"".join(spelled[p] for p in parts).decode()
        if kw.get("cut_n_gaps") and "N" * 10 in seq:
            assert len(parts) == 2 and joined == seq.replace("N" * 50, "")
        else:
            assert parts == [name] and joined == seq
    lengths = {n: len(s) for n, s in data.items()}
    assert port_s2g.paths_to_walks(text, lengths) == jax_s2g.paths_to_walks(
        text, lengths)


@pytest.mark.parametrize("extra", [
    [], ["--mode", "raw"], ["--gfa-version", "1.1"],
    ["--cut-ns", "--cut-n-min-run", "10"], ["-o", "{d}/out.gfa"],
    ["--drop-top-fraction", "0", "--max-occurrences", "2"],
], ids=["blunt", "raw", "gfa_1_1", "cut_ns", "output_file", "max_occ"])
def test_cli_syng2gfa(tmp_path, capsys, extra):
    res = []
    for main, side, kw in ((jax_cli.main, "jax", {}),
                           (torch_cli.main, "port", {"device": "cpu"})):
        d = tmp_path / side
        d.mkdir()
        fa, _ = _panel_fasta(d, "ns" if "--cut-ns" in extra else "cli")
        JaxSyng.build_from_fasta([fa]).save(str(d / "pan"))
        r = _cli(main, ["syng2gfa", "-a", "{d}/pan.syngt",
                        "--sequence-files", fa, *extra], str(d), capsys, **kw)
        files = ({"out.gfa": (d / "out.gfa").read_bytes()}
                 if "-o" in extra else {})
        res.append((r, files))
    assert res[0] == res[1] and res[0][0][0] == 0
    assert res[0][0][1] or res[0][1]
    if "1.1" in extra:
        assert "\nW\t" in res[0][0][1] and "\nP\t" not in res[0][0][1]


def test_cli_syng2gfa_needs_sequences(tmp_path, capsys):
    argv = ["syng2gfa", "-a", "{d}/pan.syngt"]
    got = _cli(torch_cli.main, argv, str(tmp_path), capsys, device="cpu")
    assert got == _cli(jax_cli.main, argv, str(tmp_path), capsys)
    assert got[0] == 2


# ── syng-repair (tests/test_syng.py) ─────────────────────────────────


def _corrupt(path, how):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if how == "permuted":
        perm = np.random.default_rng(0).permutation(arrays["occ_ids"].size)
        for k in ("occ_ids", "occ_seq", "occ_pos", "occ_fwd"):
            arrays[k] = arrays[k][perm]
    elif how == "out_of_bounds":
        arrays["occ_pos"] = arrays["occ_pos"] + 10_000_000
    elif how == "bad_seq":
        arrays["occ_seq"] = arrays["occ_seq"] + 5
    elif how == "missing":
        del arrays["occ_fwd"]
    elif how == "truncated":
        arrays["occ_pos"] = arrays["occ_pos"][:-3]
    np.savez(path + ".npz", **arrays)
    os.replace(path + ".npz", path)


@pytest.mark.parametrize("how,argv", [
    ("intact", []), ("intact", ["--force"]), ("permuted", []),
    ("out_of_bounds", []), ("bad_seq", []), ("missing", []),
    ("truncated", []), ("unreadable", []),
], ids=["ok", "force", "permuted", "out_of_bounds", "bad_seq", "missing",
        "truncated", "unreadable"])

def test_cli_syng_repair(tmp_path, capsys, how, argv):
    """syng-repair's status, message and rewritten artifact equal
    impg_tpu's: an intact index is left alone (or rewritten with --force),
    a permuted one re-canonicalized (and queries as before), inconsistent
    or partial data refused."""
    res = []
    for main, side, kw in ((jax_cli.main, "jax", {}),
                           (torch_cli.main, "port", {"device": "cpu"})):
        d = tmp_path / side
        d.mkdir()
        fa = str(d / "r.fa")
        datagen.write_fasta(fa, {
            n: "".join(random.Random(s).choice("ACGT") for _ in range(3000))
            for n, s in (("ref", 3), ("alt", 4))})
        JaxSyng.build_from_fasta([fa]).save(str(d / "ridx"))
        path = str(d / "ridx.syngt")
        before = _members(path)
        if how == "unreadable":
            with open(path, "wb") as fh:
                fh.write(b"not a zip")
        elif how != "intact":
            _corrupt(path, how)
        if how == "bad_seq":
            # Sequence ids past the name table: impg_tpu's check indexes
            # the lengths with them before it reports, and raises
            # IndexError; the port keeps that.
            with pytest.raises(IndexError) as exc:
                main(["syng-repair", str(d / "ridx"), *argv], **kw)
            res.append(str(exc.value))
            continue
        r = _cli(main, ["syng-repair", "{d}/ridx", *argv], str(d), capsys,
                 **kw)
        after = _members(path) if how != "unreadable" else None
        res.append((r, after))
        if how in ("intact", "permuted"):
            assert after == before and r[0] == 0
    assert res[0] == res[1]
    if how not in ("intact", "permuted", "bad_seq"):
        assert res[0][0][0] == 1
    if how == "permuted":
        assert "re-canonicalized" in res[0][0][2]


# ── read-index and infer (tests/test_map_genotype.py) ────────────────


def _simulate_reads(rng, seq, n, length=150):
    out = []
    for i in range(n):
        s = rng.randint(0, len(seq) - length)
        out.append((f"r{i}", seq[s:s + length]))
    return out


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """tests/test_map_genotype.py's 4-haplotype panel and a diploid sample
    of ref + s1, indexed, mapped (pack and GAF) and read-indexed by each
    package."""
    tmp = tmp_path_factory.mktemp("torch_infer")
    rng = random.Random(123)
    _, _, _, seq_data = datagen.mutate_chain_paf(
        rng, n_seqs=4, seq_len=12_000, return_sequences=True)
    reads = _simulate_reads(rng, seq_data["ref"], 400) + _simulate_reads(
        rng, seq_data["s1"], 400)
    half = len(seq_data["s0"]) // 2
    recomb = seq_data["s0"][:half] + seq_data["s2"][
        len(seq_data["s2"]) // 2:]
    rrng = random.Random(99)
    recomb_reads = []
    for i in range(900):
        s = rrng.randint(0, len(recomb) - 150)
        recomb_reads.append((f"m{i}", recomb[s:s + 150]))
    out = {"seq_data": seq_data}
    for side, syng_cls, pack_mod, map_mod, ri_mod in (
            ("jax", JaxSyng, jax_pack, jax_map, jax_read_index),
            ("port", PortSyng, port_pack, port_map, port_read_index)):
        d = tmp / side
        d.mkdir()
        fa = str(d / "panel.fa")
        datagen.write_fasta(fa, seq_data)
        for name, rs in (("reads.fastq", reads),
                         ("recomb.fastq", recomb_reads)):
            with open(d / name, "w") as fh:
                for n, s in rs:
                    fh.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")
        idx = syng_cls.build_from_fasta([fa])
        idx.save(str(d / "pan"))
        pack, _, _ = pack_mod.map_reads(idx, [str(d / "reads.fastq")])
        pack.save(str(d / "s.packt"))
        recomb_pack, _, _ = pack_mod.map_reads(idx, [str(d / "recomb.fastq")])
        with open(d / "reads.gaf", "w") as fh:
            for row in map_mod.map_reads_gaf(idx, [str(d / "reads.fastq")]):
                fh.write(row + "\n")
        ridx = ri_mod.ReadSyncmerIndex.build([str(d / "reads.fastq")])
        ridx.save(str(d / "reads"))
        with open(d / "parts.bed", "w") as fh:
            fh.write("ref\t0\t6000\tp1\nref\t6000\t12000\tp2\n")
        out[side] = dict(d=str(d), idx=idx, pack=pack, ridx=ridx,
                         recomb=recomb_pack)
    return out


def test_read_index_equal(panel):
    ref, got = panel["jax"]["ridx"], panel["port"]["ridx"]
    assert len(got.read_names) == 800 and got.read_names == ref.read_names
    for k in ("ids", "offsets", "read_ordinals"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
        assert getattr(got, k).dtype == getattr(ref, k).dtype
    assert (got.k, got.w, got.seed) == (ref.k, ref.w, ref.seed)
    for i in range(0, got.ids.size, max(1, got.ids.size // 50)):
        sid = int(got.ids[i])
        np.testing.assert_array_equal(got.reads_with(sid),
                                      ref.reads_with(sid))
        nxt = int(got.ids[(i + 1) % got.ids.size])
        np.testing.assert_array_equal(got.linking_reads(sid, nxt),
                                      ref.linking_reads(sid, nxt))
    assert got.reads_with(1).size == 0
    _members_equal_after_load = port_read_index.ReadSyncmerIndex.load(
        os.path.join(panel["port"]["d"], "reads.readidx"))
    np.testing.assert_array_equal(_members_equal_after_load.ids, ref.ids)


@pytest.mark.parametrize("extra", [[], ["--syncmer-k", "6", "--syncmer-w",
                                        "30"]], ids=["default", "params"])
def test_cli_read_index(panel, capsys, extra):
    res = []
    for main, side, kw in ((jax_cli.main, "jax", {}),
                           (torch_cli.main, "port", {"device": "cpu"})):
        d = panel[side]["d"]
        r = _cli(main, ["read-index", "-q", "{d}/reads.fastq,{d}/recomb.fastq",
                        "-O", "{d}/cli_reads", *extra], d, capsys, **kw)
        res.append((r, _members(os.path.join(d, "cli_reads.readidx"))))
    assert res[0] == res[1] and res[0][0][0] == 0
    assert "1700 reads" in res[0][0][2]


def _calls(result):
    windows, path, segments = result
    return (
        [(w.chrom, w.start, w.end,
          [(c.genome, c.start, c.end) for c in w.candidates],
          [(tuple(s.combination), s.similarity, s.qv) for s in w.combos],
          w.rewards) for w in windows],
        path,
        [(s.hap_slot, s.chrom, s.start, s.end, s.source) for s in segments],
    )


_INFER = {
    "plain": {"window": 4000},
    "read_link": {"window": 4000, "read_link_weight": 0.5},
    "gaf": {"window": 4000, "read_link_weight": 1.0,
            "min_read_link_anchors": 1, "gaf": True},
    "gaf_3000": {"window": 3000, "read_link_weight": 1.0, "gaf": True},
    "gaf_evidence": {"window": 4000, "read_link_weight": 1.0,
                     "min_read_link_anchors": 1, "gaf": "evidence"},
    "spanning_ploidy3": {"window": 5000, "candidate_mode": "spanning",
                         "ploidy": 3, "top_n": 3},
    "recombinant": {"window": 3000, "recomb": True},
}


@pytest.mark.parametrize("case", list(_INFER))
def test_run_infer_equal(panel, case):
    """Windows, candidates, scores, rewards, the stitched path and the
    mosaic equal impg_tpu's (read-link rewards from the read index, GAF
    rewards through the GBWT, the GafEvidence cache, a recombinant
    sample)."""
    kw = dict(_INFER[case])
    gaf = kw.pop("gaf", None)
    recomb = kw.pop("recomb", False)
    outs = []
    for side, mod in (("jax", jax_infer), ("port", port_infer)):
        p = panel[side]
        extra = {}
        if case == "read_link":
            extra["read_index"] = p["ridx"]
        if gaf:
            path = os.path.join(p["d"], "reads.gaf")
            extra["gaf_path"] = (mod.GafEvidence(p["idx"], path)
                                 if gaf == "evidence" else path)
        outs.append(_calls(mod.run_infer(
            p["idx"], p["recomb"] if recomb else p["pack"], "ref", 0, 12_000,
            **kw, **extra)))
    assert outs[0] == outs[1]
    windows, path, segments = outs[1]
    assert windows and path
    if case == "read_link":
        assert all(w[5] for w in windows)
    if recomb:
        assert {"s0", "s2"} <= {g for combo in path for g in combo}


def test_gaf_evidence_equal(panel):
    evs = [mod.GafEvidence(panel[side]["idx"],
                           os.path.join(panel[side]["d"], "reads.gaf"))
           for side, mod in (("jax", jax_infer), ("port", port_infer))]
    assert len(evs[0].reads) == len(evs[1].reads) == 800
    for a, b in zip(evs[0].reads, evs[1].reads):
        assert a[0] == b[0]
        if a[0] == "walk":
            assert a[1] == b[1]
            continue
        for (n1, b1, m1), (n2, b2, m2) in zip(a[1], b[1]):
            np.testing.assert_array_equal(n1, n2)
            np.testing.assert_array_equal(b1, b2)
            assert _mems(m1) == _mems(m2)


def test_stitch_link_rewards_equal():
    """tests/test_map_genotype.py's stitch cases: link rewards steer the
    slot order as in impg_tpu."""
    class Cand:
        def __init__(self, genome):
            self.genome = genome

    class Score:
        def __init__(self, combination, similarity):
            self.combination = combination
            self.similarity = similarity
            self.qv = 10.0

    cands = [Cand("A"), Cand("B")]
    results = []
    for mod in (jax_infer, port_infer):
        w0 = mod.WindowCall("c", 0, 100, [Score((0, 1), 1.0)], cands)
        w1 = mod.WindowCall("c", 100, 200, [Score((0, 1), 1.0),
                                            Score((1, 0), 1.0)], cands)
        links = {((0, 0), (1, 0)): 5.0, ((0, 1), (1, 1)): 5.0}
        results.append((mod.stitch([w0, w1], switch_penalty=0.0),
                        mod.stitch([w0, w1], switch_penalty=0.0,
                                   link_rewards=links),
                        mod.stitch([], 0.1)))
    assert results[0] == results[1]
    assert results[1][1][0][1] == ("A", "B") and results[1][1][1] > 2.0


_INFER_CLI = {
    "plain": ["-r", "ref:0-12000", "-w", "4000"],
    "bed": ["-b", "{d}/parts.bed"],
    "read_index": ["-r", "ref:0-12000", "-w", "4000", "--read-index",
                   "{d}/reads.readidx", "--read-link-weight", "0.5"],
    "gaf": ["-r", "ref:0-12000", "--gaf", "{d}/reads.gaf",
            "--read-link-weight", "0.5", "--min-read-link-anchors", "1"],
    "bed_gaf": ["-b", "{d}/parts.bed", "-w", "2000", "--gaf",
                "{d}/reads.gaf", "--read-link-weight", "0.5"],
    "haplotypes": ["-r", "ref:0-12000", "-w", "4000", "--write-haplotypes",
                   "{d}/dip", "--sequence-files", "{d}/panel.fa",
                   "--sample-name", "smp"],
    "haplotypes_list": ["-r", "ref:0-12000", "-w", "4000",
                        "--write-haplotypes", "{d}/dipl", "--sequence-list",
                        "{d}/seqs.txt", "--compute-engine", "device"],
    "no_region": [],
    "haplotypes_no_sequences": ["-r", "ref:0-12000", "--write-haplotypes",
                                "{d}/x"],
    "haplotypes_bed": ["-b", "{d}/parts.bed", "--write-haplotypes", "{d}/x",
                       "--sequence-files", "{d}/panel.fa"],
    "unknown_sequence": ["-r", "zzz:0-100"],
    "bad_window": ["-r", "ref:0-12000", "-w", "0"],
}


@pytest.mark.parametrize("case", list(_INFER_CLI))
def test_cli_infer(panel, capsys, case):
    """`infer`'s status, report, messages and haplotype FASTAs equal
    impg_tpu.cli's (the port scores on the host whatever
    `--compute-engine` says, as impg_tpu does)."""
    res = []
    for main, side, kw in ((jax_cli.main, "jax", {}),
                           (torch_cli.main, "port", {"device": "cpu"})):
        d = panel[side]["d"]
        with open(os.path.join(d, "seqs.txt"), "w") as fh:
            fh.write(f"# panel\n{d}/panel.fa\n")
        argv = ["infer", "-a", "{d}/pan.syngt", "-p", "{d}/s.packt",
                *_INFER_CLI[case]]
        try:
            r = _cli(main, argv, d, capsys, **kw)
        except KeyError as e:
            # A sequence the index lacks: impg_tpu raises KeyError.
            r = ("KeyError", str(e))
        files = {}
        if "--write-haplotypes" in argv:
            prefix = argv[argv.index("--write-haplotypes") + 1].format(d=d)
            for slot in range(2):
                p = f"{prefix}_hap{slot}.fa"
                if os.path.exists(p):
                    with open(p, "rb") as fh:
                        files[os.path.basename(p)] = fh.read()
        res.append((r, files))
    assert res[0] == res[1]
    if case == "unknown_sequence":
        assert res[0][0][0] == "KeyError"
        return
    (rc, out, err), files = res[0]
    if case in ("plain", "bed", "read_index", "gaf", "bed_gaf"):
        assert rc == 0 and out.startswith("#type")
        assert out.count("#type") == 1 and "\nmosaic\t" in out
    elif case.startswith("haplotypes") and rc == 0:
        assert len(files) == 2 and "Wrote haplotype FASTAs" in err
    else:
        assert rc in (1, 2), (rc, err)
