"""The port's `sort` path against impg_tpu's, on the CPU.

The port's GFA columns equal impg_tpu's field by field; `sort` with the
numpy backend writes impg_tpu.cli's bytes for every pipeline, through the
CLI and the library; the twin of K-I's update, in float64 and fed the numpy
Generator's own draws, gives impg_tpu's numpy-backend order exactly; the
device backend (the twin with its own Philox draws) recovers a chain's order
and agrees with impg_tpu's jitted backend, and from a shuffled start it moves
the segments as that backend does; a step that names no S line wraps to node
n - 1 as numpy and JAX wrap it; under `auto` a failure of K-I raises instead
of falling back to numpy; and without the native library `sort` raises.
Graphs: the chain and bubble of tests/test_sortgfa.py, a W-line graph, a
graph with a dangling step, and synth.variation_graph with 6 haplotypes of
20 kb."""

import random

import numpy as np
import pytest
import torch

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.graph import gfa_columns as jax_cols
from impg_tpu.graph import sortgfa as jax_sort
from impg_tpu.graph.gfa import Gfa as JaxGfa
from impg_tpu_torch import synth
from impg_tpu_torch.graph import columnar_ops as co
from impg_tpu_torch.graph import gfa_columns as port_cols
from impg_tpu_torch.graph import sortgfa as port_sort
from impg_tpu_torch.graph.gfa import Gfa as PortGfa
from impg_tpu_torch.ops import path_sgd


def _chain_gfa(n=60, seed=4):
    """tests/test_sortgfa.py's chain: S lines shuffled, one path in order."""
    rng = random.Random(seed)
    ids = [f"x{i}" for i in range(n)]
    shuffled = ids[:]
    rng.shuffle(shuffled)
    lines = ["H\tVN:Z:1.0"]
    for sid in shuffled:
        lines.append(f"S\t{sid}\t{'ACGT' * 3}")
    for i in range(n - 1):
        lines.append(f"L\t{ids[i]}\t+\t{ids[i + 1]}\t+\t0M")
    lines.append("P\tp\t" + ",".join(s + "+" for s in ids) + "\t*")
    return "\n".join(lines) + "\n", ids


BUBBLE = (
    "H\tVN:Z:1.0\nS\tm\tAC\nS\tu\tG\nS\tv\tT\nS\tz\tCC\n"
    "L\tm\t+\tu\t+\t0M\nL\tm\t+\tv\t+\t0M\n"
    "L\tu\t+\tz\t+\t0M\nL\tv\t+\tz\t+\t0M\n"
    "P\tp1\tm+,u+,z+\t*\nP\tp2\tm+,v+,z+\t*\n"
)
# Reverse steps (groom flips b), a W line, and a path back through a.
WALKS = (
    "H\tVN:Z:1.0\nS\ta\tACGTT\nS\tb\tGGA\nS\tc\tTTTC\nS\td\tA\n"
    "L\ta\t+\tb\t-\t0M\nL\tb\t-\tc\t+\t0M\nL\tc\t+\td\t+\t0M\n"
    "P\tp\ta+,b-,c+,d+\t*\n"
    "W\ts1\t1\tchr1\t0\t13\t>a<b>c\n"
    "P\tq\tb-,c+\t*\n"
)
# Step `ghost` names no S line, so its node id is -1.
DANGLING = (
    "H\tVN:Z:1.0\nS\ta\tACGT\nS\tb\tGG\nS\tc\tTTA\nS\td\tCCCA\n"
    "L\ta\t+\tb\t+\t0M\nL\tb\t+\tc\t+\t0M\nL\tc\t+\td\t+\t0M\n"
    "P\tp\ta+,ghost+,b+,c+,d+\t*\nP\tq\ta+,b+,ghost+,c+\t*\n"
)


def _graphs():
    return {
        "chain": _chain_gfa()[0],
        "bubble": BUBBLE,
        "walks": WALKS,
        "dangling": DANGLING,
        "variation": synth.variation_graph(seed=3, n_haps=6,
                                           locus_len=20_000),
    }


GRAPHS = _graphs()
PIPELINES = ("Ygs", "gs", "s", "g")


def _rho(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def _spell_dict(g) -> dict:
    from impg_tpu_torch.io.fasta import reverse_complement

    out = {}
    for name, steps in g.paths:
        s = b""
        for sid, rev in steps:
            t = g.segments[sid].encode()
            s += reverse_complement(t) if rev else t
        out[name] = s
    return out


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_columns_equal_impg_tpu(graph):
    """parse_gfa_columns gives impg_tpu's arrays, field by field, and
    from_arrays rebuilds them."""
    ref = jax_cols.parse_gfa_columns(GRAPHS[graph])
    got = port_cols.parse_gfa_columns(GRAPHS[graph])
    rebuilt = port_cols.GfaColumns.from_arrays(vars(ref))
    for cols in (got, rebuilt):
        for name, want in vars(ref).items():
            if name.startswith("_"):
                continue
            have = getattr(cols, name)
            if isinstance(want, np.ndarray):
                assert have.dtype == want.dtype, name
                assert np.array_equal(have, want), name
            else:
                assert have == want, name
    assert vars(PortGfa.parse_python(GRAPHS[graph])) \
        == vars(JaxGfa.parse_python(GRAPHS[graph]))


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_cli_sort_numpy_bytes_equal_impg_tpu(graph, pipeline, tmp_path,
                                             capsys):
    """`sort --sgd-backend numpy` prints impg_tpu.cli's bytes, and the
    library's sort_pipeline returns them."""
    path = tmp_path / "g.gfa"
    path.write_text(GRAPHS[graph])
    argv = ["sort", str(path), "--pipeline", pipeline,
            "--sgd-backend", "numpy"]
    outs = []
    for main, kw in ((jax_cli.main, {}), (torch_cli.main, {"device": "cpu"})):
        capsys.readouterr()
        assert main(argv, **kw) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert port_sort.sort_pipeline(GRAPHS[graph], pipeline, "numpy") \
        == outs[0]


@pytest.mark.parametrize("main,kw", [(jax_cli.main, {}),
                                     (torch_cli.main, {"device": "cpu"})],
                         ids=["impg_tpu", "port"])
def test_cli_sort_unknown_step_exits_2(main, kw, tmp_path, capsys):
    path = tmp_path / "g.gfa"
    path.write_text(GRAPHS["chain"])
    capsys.readouterr()
    assert main(["sort", str(path), "--pipeline", "Q"], **kw) == 2
    assert capsys.readouterr().err == (
        "error: unsupported sort pipeline step 'Q' (expected Y, g, s)\n")


def _numpy_draws_order(n, step_node, step_pos, bounds, seed, epochs=30,
                       batch_per_step=8):
    """The port's twin update in float64, fed default_rng(seed)'s draws in
    the numpy loop's order (integers, uniform, random per epoch)."""
    node, x0, pstart, pend, eta_max, lam = port_sort.sgd_setup(
        n, step_node, step_pos, bounds, epochs)
    n_steps = node.size
    batch = n_steps * batch_per_step
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(x0.copy())
    acc, cnt = torch.zeros_like(x), torch.zeros_like(x)
    t_node = torch.from_numpy(node)
    t_pos = torch.from_numpy(np.asarray(step_pos, np.float64))
    for t in range(epochs):
        eta = eta_max * np.exp(-lam * t)
        i = rng.integers(0, n_steps, batch)
        off = np.ceil(
            np.exp(rng.uniform(0.0, np.log(n_steps), batch))
        ).astype(np.int64)
        sign = np.where(rng.random(batch) < 0.5, -1, 1)
        j = np.clip(i + sign * off, pstart[i], pend[i] - 1)
        path_sgd.pull_plain(x, t_node, t_pos, torch.from_numpy(i),
                            torch.from_numpy(j), float(eta), acc, cnt)
        path_sgd.apply_plain(x, acc, cnt)
    return port_sort.order_of(x.numpy())


@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("graph", ["chain", "bubble", "walks", "dangling",
                                   "variation"])
def test_twin_update_with_numpy_draws_is_impg_tpu_order(graph, seed):
    """The update math of K-I's twin, in float64 with numpy's draws, gives
    impg_tpu's numpy-backend order exactly."""
    gc = jax_cols.parse_gfa_columns(GRAPHS[graph])
    step_node, step_pos, bounds = port_sort.sgd_inputs(
        port_cols.GfaColumns.from_arrays(vars(gc)))
    want = jax_sort._sgd_order_core(
        gc.n_segs, step_node.copy(), step_pos, bounds, backend="numpy",
        rng=np.random.default_rng(seed))
    got = _numpy_draws_order(gc.n_segs, step_node, step_pos, bounds, seed)
    assert np.array_equal(got, want)


def _chain_rank(order, ids):
    true_rank = {s: i for i, s in enumerate(ids)}
    return [true_rank[s] for s in order]


def _chain_state():
    """The chain's layout inputs: (step_node, x0, pstart, pend, eta_max,
    lam, step_pos), and each segment row's true place along the path."""
    gc = port_cols.parse_gfa_columns(_chain_gfa()[0])
    step_node, step_pos, bounds = port_sort.sgd_inputs(gc)
    setup = port_sort.sgd_setup(gc.n_segs, step_node, step_pos, bounds)
    truth = np.empty(gc.n_segs)
    truth[setup[0]] = step_pos
    return (*setup, step_pos), truth


@pytest.fixture(scope="module")
def jax_chain_order():
    """impg_tpu's jitted backend on the chain (JAX on the CPU)."""
    text, _ = _chain_gfa()
    return jax_sort.path_sgd_order(JaxGfa.parse(text), backend="jax")


@pytest.mark.parametrize("backend", ["device", "jax", "auto"])
def test_device_twin_recovers_chain_order(backend, monkeypatch,
                                          jax_chain_order):
    """The device backend on the CPU (K-I's twin, its own Philox draws):
    rho > 0.99 against the chain's true order and against impg_tpu's jitted
    backend (as test_path_sgd_jax_backend_recovers_linear_order runs it).
    `auto` takes the same path once the volume passes its threshold."""
    monkeypatch.setattr(port_sort, "AUTO_DEVICE_SAMPLES", 0)
    text, ids = _chain_gfa()
    gc = port_cols.parse_gfa_columns(text)
    rows = port_sort.sgd_order_columns(gc, backend=backend, device="cpu")
    got = [gc.names[gc.seg_name_idx[r]] for r in rows]
    assert _rho(_chain_rank(got, ids), range(len(ids))) > 0.99
    assert _rho(_chain_rank(got, ids), _chain_rank(jax_chain_order, ids)) \
        > 0.99


def _stress(x, step_node, step_pos):
    """The layout's weighted stress over all step pairs of the chain's one
    path: sum of ((|x_a - x_b| - d) / d)^2 with d the pair's bp distance."""
    i, j = np.triu_indices(step_node.size, 1)
    d = np.abs(step_pos[i] - step_pos[j])
    gap = np.abs(x[step_node[i]] - x[step_node[j]])
    return float(np.sum(((gap - d) / d) ** 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_twin_moves_like_jax_from_shuffled_start(seed):
    """From the chain's start positions dealt to the segments in a random
    order (rank rho with the truth near 0), 30 epochs of the port's device
    twin (path_sgd.sgd_epochs on the CPU) and of impg_tpu's
    `_sgd_epochs_jax`, each with its own draws: both cut the layout's stress
    by more than half, end within 25% of each other, and their moves from
    the start correlate above 0.95.  Neither recovers the order from such a
    start in 30 epochs (the layout refines an order, it does not find one),
    so the moves, not the ranks, are held; a layout that does nothing, pulls
    the wrong way, leaves out mu or halves its moves fails here."""
    (node, x0, pstart, pend, eta_max, lam, pos), truth = _chain_state()
    xs = x0[np.random.default_rng(seed).permutation(x0.size)]
    assert abs(_rho(xs, truth)) < 0.3
    args = (node, pos, pstart, pend, 30, 8 * node.size, eta_max, lam)
    got = path_sgd.sgd_epochs(xs, *args, device="cpu")
    want = jax_sort._sgd_epochs_jax(xs, *args)
    start, s_got, s_want = (_stress(x, node, pos) for x in (xs, got, want))
    assert s_got < start / 2 and s_want < start / 2
    assert abs(s_got / s_want - 1) < 0.25
    assert _rho(got - xs, want - xs) > 0.95


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_dangling_step_wraps_to_last_node(backend):
    """A step that names no S line (node id -1) acts on node n - 1, as
    numpy's and JAX's indexing wrap it: impg_tpu's numpy order exactly,
    and the device twin's layout runs in bounds and keeps the spellings."""
    gc = port_cols.parse_gfa_columns(DANGLING)
    step_node, _, _ = port_sort.sgd_inputs(gc)
    assert (step_node < 0).sum() == 2
    got = port_sort.sgd_order_columns(gc, backend=backend, device="cpu")
    if backend == "numpy":
        want = jax_sort.sgd_order_columns(
            jax_cols.parse_gfa_columns(DANGLING), backend="numpy")
        assert np.array_equal(got, want)
    assert sorted(got.tolist()) == list(range(gc.n_segs))
    out = PortGfa.parse_python(port_sort.sort_pipeline(
        DANGLING, "Ygs", backend, device="cpu"))
    assert list(out.segments) == ["1", "2", "3", "4"]
    assert [len(steps) for _, steps in out.paths] == [4, 3]
    with pytest.raises(ValueError, match="must lie in"):
        path_sgd.sgd_steps(step_node, np.zeros(step_node.size), np.zeros(
            step_node.size, np.int64), np.full(step_node.size, 5), gc.n_segs,
            "cpu")


@pytest.mark.parametrize("via", ["library", "cli"])
def test_auto_device_failure_raises(via, monkeypatch, tmp_path):
    """Under `auto`, past the volume threshold, a failure of K-I raises:
    there is no silent numpy fallback (impg_tpu's sortgfa catches it)."""
    def broken(*a, **kw):
        raise RuntimeError("impg_path_sgd_epoch: CUDA error 700")

    monkeypatch.setattr(port_sort, "AUTO_DEVICE_SAMPLES", 0)
    monkeypatch.setattr(path_sgd, "sgd_epochs", broken)
    text = GRAPHS["chain"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        if via == "library":
            port_sort.sort_pipeline(text, "Ygs", "auto", device="cpu")
        else:
            path = tmp_path / "g.gfa"
            path.write_text(text)
            torch_cli.main(["sort", str(path)], device="cpu")


@pytest.mark.parametrize("backend,device,samples,want", [
    ("numpy", "cpu", 10**12, False),
    ("device", "cpu", 1, True),
    ("jax", "cpu", 1, True),
    ("auto", "cpu", 499_999_999, False),
    ("auto", "cpu", 500_000_000, True),
    ("auto", "cuda:0", 10**12, "cuda"),
    ("device", "cuda:0", 1, "cuda"),
    ("fast", "cpu", 1, ValueError),
])
def test_backend_rule(backend, device, samples, want):
    """`auto` keeps impg_tpu's volume rule (5e8 samples x epochs) and needs
    a usable device; `device` on an absent CUDA device is an error."""
    cuda = torch.cuda.is_available()
    if want == "cuda":
        want = cuda if backend == "auto" else (True if cuda else ValueError)
    if want is ValueError:
        with pytest.raises(ValueError):
            port_sort.use_device(backend, samples, torch.device(device))
    else:
        assert port_sort.use_device(backend, samples,
                                    torch.device(device)) is want


def test_cli_device_without_cuda_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "g.gfa"
    path.write_text(GRAPHS["chain"])
    for backend in ("device", "jax"):
        assert torch_cli.main(["sort", str(path), "--sgd-backend",
                               backend]) == 2
        assert "needs a CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("via", ["library", "cli"])
def test_sort_without_native_library_raises(via, monkeypatch, tmp_path):
    """The sort path has no Python fallback for its native tokenizer and
    spell/topo kernels: without the library it raises, naming it."""
    from impg_tpu_torch.io import native as native_mod

    monkeypatch.setattr(native_mod, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native host library"):
        if via == "library":
            port_sort.sort_pipeline(BUBBLE, "Ygs", "numpy")
        else:
            path = tmp_path / "g.gfa"
            path.write_text(BUBBLE)
            torch_cli.main(["sort", str(path), "--sgd-backend", "numpy"],
                           device="cpu")


@pytest.mark.parametrize("graph", ["chain", "bubble", "walks", "variation"])
def test_cli_sort_device_twin_keeps_spellings(graph, tmp_path, capsys):
    """`sort --sgd-backend device` on the CPU (the twin): every path spells
    what it spelled, and segments are renumbered 1..N in a topological
    order of the links."""
    path = tmp_path / "g.gfa"
    path.write_text(GRAPHS[graph])
    out = tmp_path / "out.gfa"
    assert torch_cli.main(["sort", str(path), "--sgd-backend", "device",
                           "--output", str(out)], device="cpu") == 0
    before = PortGfa.parse_python(GRAPHS[graph])
    after = PortGfa.parse_python(out.read_text())
    assert _spell_dict(after) == _spell_dict(before)
    assert list(after.segments) == [str(i + 1)
                                    for i in range(len(before.segments))]
    if graph != "walks":  # `walks` has a link back to a (a cycle)
        assert all(int(a) < int(b) for a, _, b, _ in after.links)


def test_sort_pipeline_device_renumbers_chain_in_path_order():
    """tests/test_sortgfa.py's renumbering check, on the device twin."""
    text, ids = _chain_gfa()
    g = PortGfa.parse_python(port_sort.sort_pipeline(
        text, device="cpu", sgd_backend="device"))
    assert list(g.segments) == [str(i + 1) for i in range(len(ids))]
    assert [s for s, _ in g.paths[0][1]] == list(g.segments)


def test_variation_graph_spells_its_haplotypes():
    """synth.variation_graph: deterministic, one P line a haplotype of about
    locus_len bases, haplotypes that differ, links exactly the paths'
    adjacencies, and S lines in an order unrelated to the layout."""
    text = GRAPHS["variation"]
    assert synth.variation_graph(seed=3, n_haps=6, locus_len=20_000) == text
    gc = port_cols.parse_gfa_columns(text)
    spell = co.path_spellings(gc)
    assert list(spell) == [f"hap{h}" for h in range(6)]
    assert all(abs(len(s) - 20_000) < 200 for s in spell.values())
    assert len(set(spell.values())) == 6
    g = PortGfa.parse_python(text)
    adj = set()
    for _, steps in g.paths:
        adj |= {(a, b) for (a, _), (b, _) in zip(steps, steps[1:])}
    assert {(a, b) for a, _, b, _ in g.links} == adj
    walk = [int(s) for s, _ in g.paths[0][1]]
    assert gc.n_segs > 100 and walk != sorted(walk)


def _epoch_state(n=5, n_steps=12):
    rng = np.random.default_rng(3)
    node = rng.integers(0, n, n_steps)
    pos = np.cumsum(rng.integers(1, 10, n_steps)).astype(np.float64)
    pstart = np.where(np.arange(n_steps) < 7, 0, 7)
    pend = np.where(np.arange(n_steps) < 7, 7, n_steps)
    steps = path_sgd.sgd_steps(node, pos, pstart, pend, n, "cpu")
    x = torch.from_numpy(rng.random(n).astype(np.float32) * 50)
    return x, steps


def test_sgd_epoch_on_cpu_is_the_twin():
    """The wrapper on CPU tensors runs the twin's epoch, and leaves acc and
    cnt zeroed for the next one."""
    x, steps = _epoch_state()
    want = x.clone()
    path_sgd.epoch_plain(want, steps, 2, 96, 40.0, float(np.log(12)))
    acc, cnt = torch.zeros_like(x), torch.zeros_like(x)
    path_sgd.sgd_epoch(x, steps, acc, cnt, 2, 96, 40.0, float(np.log(12)))
    assert torch.equal(x, want)
    assert not acc.any() and not cnt.any()
    assert not torch.equal(x, _epoch_state()[0])


@pytest.mark.parametrize("bad", ["x_dtype", "steps_layout", "acc_shape",
                                 "pairs_on_cpu"])
def test_sgd_epoch_refuses_bad_state(bad):
    x, steps = _epoch_state()
    acc, cnt = torch.zeros_like(x), torch.zeros_like(x)
    pairs = None
    if bad == "x_dtype":
        x = x.double()
    elif bad == "steps_layout":
        steps = steps.t().contiguous()
    elif bad == "acc_shape":
        acc = torch.zeros(x.shape[0] + 1)
    else:
        pairs = torch.zeros((96, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        path_sgd.sgd_epoch(x, steps, acc, cnt, 0, 96, 1.0, 1.0, pairs=pairs)
