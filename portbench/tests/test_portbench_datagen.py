"""The benchmark's copies of the program's generators draw what the
program's own draw (impg_tpu_torch/synth.py) at small sizes."""

import numpy as np
import pytest

from portbench.harness.registry import load_file

YEAST = dict(n_seqs=40, seq_len=20_000, n_aln=600, chunks=3, tail_frac=0.2,
             match_bp=[30, 180], edit_bp_max=6, edit_pairs_per_kb=9.2,
             body_median_at_580kb=4900.0, body_sigma=1.6, max_aln_share=0.98,
             reverse_share=0.3)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_yeast_index_equals_synth(seed, tmp_path):
    from impg_tpu_torch import synth

    got = load_file("datagen", "yeast_ava").make(YEAST, seed, str(tmp_path))
    want = synth.realistic_directed_index(
        seed=seed, n_seqs=YEAST["n_seqs"], seq_len=YEAST["seq_len"],
        n_aln=YEAST["n_aln"], chunks=YEAST["chunks"])
    gi = got["index"]
    for f in ("target_id", "query_id", "t_start", "t_end", "q_start",
              "q_end", "strand", "op_off", "op_cnt"):
        assert np.array_equal(getattr(gi.records, f),
                              getattr(want.records, f)), f
    assert np.array_equal(gi.arena.runs, want.arena.runs)
    assert list(gi.seq_index.names()) == list(want.seq_index.names())
    assert sum(c["query_id"].size for c in got["chunks"]) == YEAST["n_aln"]


@pytest.mark.parametrize("seed", [5, 3_000_000_013])
def test_panel_gfa_equals_synth(seed):
    from impg_tpu_torch import synth

    got = load_file("datagen", "panel_gfa").variation_graph(
        seed, 9, 60_000, 2, 0.000975, 0.000025, 0.041, 3)
    assert got == synth.variation_graph(
        seed=seed, n_haps=9, locus_len=60_000, founders=2,
        founder_div=0.000975, hap_div=0.000025, indel_share=0.041,
        max_indel=3)


def test_panel_gfa_make_draws_names_from_the_run_seed():
    """Every run sorts the configuration's one graph; its seed renames the
    segments, so the file's order changes and every path spells the
    same."""
    from portbench.reference.sort import Graph

    c = dict(graph_seed=4, n_haps=5, locus_len=30_000, n_founders=2,
             founder_div=0.000975, hap_div=0.000025, graph_indel_share=0.041,
             graph_max_indel=3)
    gen = load_file("datagen", "panel_gfa")
    a, b = (Graph(gen.make(c, s, "")["gfa"]) for s in (11, 2**31 + 13))
    assert a.n_segs == b.n_segs and a.step_row.size == b.step_row.size
    assert a.seqs != b.seqs
    assert [a.spell(p) for p in range(5)] == [b.spell(p) for p in range(5)]
