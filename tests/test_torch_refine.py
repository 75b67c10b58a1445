"""`refine` in the port against impg_tpu, byte for byte.

The cases of tests/test_refine.py through both CLIs: impg_tpu.cli on its
host engine and its JAX DeviceEngine (CPU backend), impg_tpu_torch.cli on
its host, native C++ and device engine (TorchDeviceEngine on CPU tensors:
the kernels' plain twins).  Standard output and the `--support-output` file
must be the same bytes.  The `-x` cases walk every flank candidate
transitively through the engine; the others stab the index directly."""

import random

import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from tests import datagen
from tests.test_refine import make_support_paf


def _pansn_chain_paf() -> str:
    """A chain pangenome (datagen.mutate_chain_paf, seed 12) with PanSN
    names: two haplotypes of sample A, one of B, one of C."""
    text, _, _ = datagen.mutate_chain_paf(random.Random(12), n_seqs=5,
                                          seq_len=5000)
    names = {"s0": "A#1#c", "s1": "A#2#c", "s2": "B#1#c", "s3": "C#1#c"}
    lines = []
    for line in text.splitlines():
        f = line.split("\t")
        f[0], f[5] = names.get(f[0], f[0]), names.get(f[5], f[5])
        lines.append("\t".join(f))
    return "\n".join(lines) + "\n"


_S = ["refine", "-a", "{d}/support.paf", "-r", "ref:2000-8000"]
_C = ["refine", "-a", "{d}/chain.paf", "-b", "{d}/loci.bed", "-d", "100",
      "--span-bp", "200", "--extension-step", "250"]
CASES = {
    "support": _S + ["-d", "200", "--max-extension", "0"],
    "support_output": _S + ["-d", "200", "--max-extension", "0",
                            "--support-output", "{d}/support.bed"],
    "extend": ["refine", "-a", "{d}/support.paf", "-r", "ref:4000-5000",
               "-d", "0", "--span-bp", "100", "--max-extension", "2000",
               "--extension-step", "500"],
    "blacklist": _S + ["-d", "200", "--max-extension", "0",
                       "--blacklist-bed", "{d}/blacklist.bed"],
    "no_merge": _S + ["--no-merge", "--max-extension", "0"],
    "chain": _C,
    "chain_x": _C + ["-x"],
    "chain_x_sample": _C + ["-x", "--pansn-mode", "sample",
                            "--support-output", "{d}/support.bed"],
    "chain_x_haplotype": _C + ["-x", "--pansn-mode", "haplotype"],
    "chain_x_depth_1": _C + ["-x", "-m", "1", "--max-extension", "0.2"],
    "chain_x_subset": _C + ["-x", "--subset-sequence-list",
                            "{d}/subset.txt"],
    "chain_x_blacklist": _C + ["-x", "--blacklist-bed", "{d}/blacklist.bed"],
    "chain_x_identity": _C + ["-x", "--min-result-identity", "0.9"],
    "chain_dfs": _C + ["-x", "--transitive-dfs"],
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refine")
    out = {}
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        (d / "support.paf").write_text(make_support_paf())
        (d / "chain.paf").write_text(_pansn_chain_paf())
        (d / "loci.bed").write_text(
            "ref\t1000\t2500\tl1\nref\t3000\t3600\t.\nC#1#c\t500\t4000\tl3\n")
        (d / "blacklist.bed").write_text("A#1#x\t0\t100000\nB#1#c\t0\t2000\n")
        (d / "subset.txt").write_text("A#1#c\nC#1#c\n")
        out[side] = str(d)
    return out


def _run(main, d, case, spec, capsys, **kw):
    argv = [a.format(d=d) for a in CASES[case]]
    capsys.readouterr()
    assert main(argv + ["--compute-engine", spec], **kw) == 0
    stdout = capsys.readouterr().out
    support = None
    if "--support-output" in argv:
        with open(f"{d}/support.bed", "rb") as fh:
            support = fh.read()
    return stdout, support


_JAX = {}


def _jax_reference(dirs, case, capsys):
    """impg_tpu's output of `case`, held equal across its host and device
    engines (computed once a case)."""
    if case not in _JAX:
        host = _run(jax_cli.main, dirs["jax"], case, "host", capsys)
        dev = _run(jax_cli.main, dirs["jax"], case, "device", capsys)
        assert dev == host
        _JAX[case] = host
    return _JAX[case]


@pytest.mark.parametrize("engine", ["host", "native", "device"])
@pytest.mark.parametrize("case", list(CASES))
def test_refine_cli_matches_jax(dirs, capsys, case, engine):
    argv = CASES[case]
    if engine == "native" and ("-x" not in argv
                               or "--transitive-dfs" in argv):
        # The C++ engine serves the breadth-first walk only: both packages
        # refuse it with status 2 (the port's message names no mesh engine).
        for main, side, kw in ((jax_cli.main, "jax", {}),
                               (torch_cli.main, "port", {"device": "cpu"})):
            with pytest.raises(SystemExit) as exc:
                _run(main, dirs[side], case, engine, capsys, **kw)
            assert exc.value.code == 2
            assert "--compute-engine native does not produce" in (
                capsys.readouterr().err)
        return
    ref = _jax_reference(dirs, case, capsys)
    got = _run(torch_cli.main, dirs["port"], case, engine, capsys,
               device="cpu")
    assert got == ref
    lines = ref[0].splitlines()
    assert lines[0].startswith("#chrom") and len(lines) >= 2
    if "--support-output" in CASES[case]:
        assert ref[1]


def test_refine_x_support_changes_with_depth(dirs, capsys):
    """The transitive cases see more than the direct stab: support at depth
    2 exceeds the direct query's somewhere on the chain."""
    direct = _jax_reference(dirs, "chain", capsys)[0].splitlines()[1:]
    walked = _jax_reference(dirs, "chain_x", capsys)[0].splitlines()[1:]
    assert [ln.split("\t")[5] for ln in direct] != [
        ln.split("\t")[5] for ln in walked]
