"""The port's slice end to end on the CPU: the depth-2 transitive BFS and
the CLI (`query -x -o bed|paf`, `stats -b`) through TorchDeviceEngine,
against the same calls through the JAX DeviceEngine.  Exact equality."""

import random

import numpy as np
import pytest
import torch

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.query import engine
from impg_tpu.query.device import DeviceEngine
from impg_tpu_torch.query.device import TorchDeviceEngine
from tests import datagen
from tests.test_query import index_from_text

BLOCK_COLUMNS = ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")


@pytest.fixture(scope="module")
def walk_setup():
    rng = random.Random(21)
    text, seqs, _ = datagen.pangenome_paf(
        rng, n_seqs=14, seq_len=30_000, cross_links=4
    )
    index = index_from_text(text)
    r2 = random.Random(4)
    names = list(seqs)
    targets = []
    for _ in range(8):
        n = r2.choice(names)
        a = r2.randint(0, seqs[n] // 2)
        b = r2.randint(a + 2000, min(seqs[n], a + 12_000))
        targets.append((index.seq_index.get_id(n), a, b))
    return index, targets


@pytest.mark.parametrize("slotted", [False, True], ids=["windowed", "slotted"])
def test_transitive_bfs_depth2_matches_jax(walk_setup, slotted):
    index, targets = walk_setup
    ref = engine.query_transitive_bfs_many(
        index, targets, max_depth=2, columnar=True,
        device_engine=DeviceEngine(index, slotted=slotted),
    )
    got = engine.query_transitive_bfs_many(
        index, targets, max_depth=2, columnar=True,
        device_engine=TorchDeviceEngine(index, device="cpu"),
    )
    assert len(got) == len(ref) == len(targets)
    total = 0
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        total += len(g)
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(r, col)), col
    assert total > 200


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = random.Random(2026)
    text, _, _ = datagen.mutate_chain_paf(rng, n_seqs=5, seq_len=12_000)
    paf = tmp / "pan.paf"
    paf.write_text(text)
    bed = tmp / "regions.bed"
    bed.write_text("ref\t2000\t8000\tlocus1\ns1\t500\t9000\tlocus2\n")
    return str(paf), str(bed)


def _run(main, argv, capsys, **kw):
    capsys.readouterr()
    rc = main(argv, **kw)
    out = capsys.readouterr().out
    assert rc == 0
    return out


@pytest.mark.parametrize(
    "kind", ["query_bed", "query_paf", "stats_bed"]
)
def test_cli_output_matches_jax_device(cli_inputs, capsys, kind):
    paf, bed = cli_inputs
    argv = {
        "query_bed": ["query", "-a", paf, "-r", "ref:2000-8000", "-d", "100",
                      "-x", "-o", "bed"],
        "query_paf": ["query", "-a", paf, "-r", "ref:2000-8000", "-d", "100",
                      "-x", "-o", "paf"],
        "stats_bed": ["stats", "-a", paf, "-b", bed],
    }[kind] + ["--compute-engine", "device"]
    original = jax_cli._resolve_compute_engine
    ref = _run(jax_cli.main, argv, capsys)
    got = _run(torch_cli.main, argv, capsys, device="cpu")
    assert jax_cli._resolve_compute_engine is original
    assert got == ref
    assert len(got.splitlines()) >= 2


def test_cli_resolver_routes(cli_inputs, capsys, monkeypatch):
    paf, _ = cli_inputs
    base = ["query", "-a", paf, "-r", "ref:2000-8000", "-d", "100", "-x",
            "-o", "bed"]
    host = _run(jax_cli.main, base + ["--compute-engine", "host"], capsys)
    for spec in ("host", "native", "auto"):
        got = _run(torch_cli.main, base + ["--compute-engine", spec], capsys,
                   device="cpu")
        assert got == host, spec
    # An index past the device budget is paged, not refused.
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", "4096")
    got = _run(torch_cli.main, base + ["--compute-engine", "device"], capsys,
               device="cpu")
    assert got == host
    monkeypatch.delenv("IMPG_HBM_BUDGET_BYTES")
    original = jax_cli._resolve_compute_engine
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(base + ["--compute-engine", "mesh"], device="cpu")
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
    assert jax_cli._resolve_compute_engine is original
    if not torch.cuda.is_available():
        # The command line always means cuda:0: no CUDA is an error.
        with pytest.raises(SystemExit) as exc:
            torch_cli.main(base + ["--compute-engine", "device"])
        assert exc.value.code == 2
        assert "needs a CUDA device" in capsys.readouterr().err
        assert jax_cli._resolve_compute_engine is original


@pytest.mark.parametrize("spec", ["device", "mesh"])
@pytest.mark.parametrize(
    "argv",
    [
        ["syng", "-f", "x.fa", "-o", "x"],
        ["map", "-a", "x", "-q", "r.fq", "-O", "x.pack"],
        ["genotype", "cos", "-a", "x", "-p", "s.pack"],
        ["infer", "-a", "x", "-p", "s.pack"],
    ],
    ids=lambda a: a[0],
)
def test_cli_rejects_unported_device_commands(capsys, argv, spec):
    """The syng-side commands' device engines are JAX code: the port's CLI
    refuses them before any input is read."""
    original = jax_cli._resolve_compute_engine
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(argv + ["--compute-engine", spec], device="cpu")
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
    assert jax_cli._resolve_compute_engine is original
