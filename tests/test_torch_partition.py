"""`partition` in the port against impg_tpu, byte for byte.

On tests/test_partition.py's chain pangenome (datagen.mutate_chain_paf,
seed 12), impg_tpu.cli runs each case on its host engine and on its JAX
DeviceEngine (CPU backend), and impg_tpu_torch.cli runs it on its host, its
native C++ and its device engine (TorchDeviceEngine on CPU tensors: the
kernels' plain twins).  Standard output and every file written to
`--output-folder` must be the same bytes.  The windows are small, so each
run walks many windows and the masked regions that the engine preloads
into every walk change between them.  The formats the port has not ported
exit 2 before any input is read."""

import os
import random

import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from tests import datagen

_BASE = ["partition", "-a", "{d}/chain.paf", "-w", "700", "-d", "100",
         "--min-missing-size", "200", "--min-boundary-distance", "200",
         "--output-folder", "{d}/{out}"]
CASES = {
    "bed": [],
    "paf": ["-o", "paf"],
    "bed_separate": ["--separate-files"],
    "paf_separate": ["-o", "paf", "--separate-files"],
    "starting_sequences": ["--starting-sequences-file", "{d}/start.txt"],
    "select_total": ["--selection-mode", "total"],
    "select_sample": ["--selection-mode", "sample"],
    "select_haplotype": ["--selection-mode", "haplotype,#"],
    "no_merge": ["--no-merge"],
    "no_rehome": ["--no-rehome-singletons", "-w", "1500"],
    "depth_1": ["-m", "1"],
    "depth_2_wide": ["-m", "2", "-w", "2000"],
    "transitive_dfs": ["--transitive-dfs"],
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    text, _, _ = datagen.mutate_chain_paf(random.Random(12), n_seqs=5,
                                          seq_len=5000)
    tmp = tmp_path_factory.mktemp("partition")
    out = {}
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        (d / "chain.paf").write_text(text)
        (d / "start.txt").write_text("s2\n#comment\ns0\tx\n")
        out[side] = str(d)
    return out


def _run(main, d, case, spec, capsys, **kw):
    out = f"out_{case}_{spec}"
    argv = [a.format(d=d, out=out) for a in _BASE + CASES[case]]
    capsys.readouterr()
    assert main(argv + ["--compute-engine", spec], **kw) == 0
    stdout = capsys.readouterr().out
    folder = os.path.join(d, out)
    files = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as fh:
            files[name] = fh.read()
    return stdout, files


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
def test_partition_cli_matches_jax(dirs, capsys, case, engine):
    if case == "transitive_dfs" and engine == "native":
        # The C++ engine walks breadth first only: both packages refuse it
        # with status 2 (the port's message names no mesh engine).
        for main, side, kw in ((jax_cli.main, "jax", {}),
                               (torch_cli.main, "port", {"device": "cpu"})):
            with pytest.raises(SystemExit) as exc:
                _run(main, dirs[side], case, engine, capsys, **kw)
            assert exc.value.code == 2
            assert "--compute-engine native does not produce" in (
                capsys.readouterr().err)
        return
    ref_out, ref_files = _jax_reference(dirs, case, capsys)
    got_out, got_files = _run(torch_cli.main, dirs["port"], case, engine,
                              capsys, device="cpu")
    assert got_out == ref_out
    assert got_files == ref_files
    assert ref_files and all(ref_files.values())
    n_lines = sum(v.count(b"\n") for v in ref_files.values())
    assert n_lines > 10, n_lines


@pytest.mark.parametrize("extra", [
    ["-o", "fasta"], ["-o", "gfa"], ["-o", "maf"], ["-o", "vcf"],
    ["--sequence-files", "missing.fa"], ["--sequence-list", "missing.txt"],
], ids=["fasta", "gfa", "maf", "vcf", "sequence_files", "sequence_list"])
def test_partition_unported_outputs_exit_2(capsys, extra):
    """Before any input is read: the PAF, the FASTA and the list named here
    do not exist."""
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["partition", "-a", "missing.paf", "-w", "1000",
                        "-d", "100", *extra], device="cpu")
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
