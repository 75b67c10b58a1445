"""Flat whole-FASTA graph build: the `impg graph` command.

Reference: Args::Graph (main.rs:5427-5447) dispatching at main.rs:8683 —
sequence files (+ optional pre-computed PAF skipping the alignment step)
→ engine-specific whole-input GFA:

  * poa       → run_graph_build_poa (one POA over the whole sequences)
  * seqwish   → align (or take the given PAF) → seqwish induction
                (commands/graph.rs:156 build_graph)
  * pggb      → seqwish + the reference's automatic chain: line-sort →
                Ygs → smooth → gfaffix normalize → sort (lib.rs:1015-1064
                via graph/pggb.py pggb_chain)
  * syng-native / syng-local → rejected with the reference's error
                contract (main.rs:8794: only meaningful under
                query/partition with selected intervals)

Partitioned mode (--partition-size) goes through the partition+lace
pipeline instead (run_graph_build_partitioned, commands/graph.rs:1308 →
lib.rs:1204 partitioned_gfa_pipeline), which the `partition -o gfa`
route already implements.

The port's copy of impg_tpu/commands/graph.py (tests/test_torch_graph_cmd.py
holds every engine's GFA equal); it launches no kernel: pggb's two Ygs sorts
reach the path-SGD kernel only past graph/sortgfa.py's volume threshold.
"""

from __future__ import annotations

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.seqidx import SequenceIndex


def load_sequences(fasta_files: list[str]) -> dict[str, bytes]:
    from impg_tpu_torch.io.fasta import FastaIndex

    fa = FastaIndex.build_from_files(fasta_files)
    return {
        n: fa.fetch_sequence(n, 0, fa.get_sequence_length(n))
        for n in fa.sequence_names()
    }


def paf_rows_from_file(paf_path: str) -> list[dict]:
    """Parse a PAF into the align command's row-dict shape (what
    seqwish.induce_graph consumes)."""
    from impg_tpu_torch.io.paf import parse_paf_file

    si = SequenceIndex()
    recs = parse_paf_file(paf_path, si)
    rows = []
    for i in range(len(recs)):
        o0, o1 = int(recs.run_offsets[i]), int(recs.run_offsets[i + 1])
        rows.append(
            {
                "qname": si.get_name(int(recs.query_id[i])),
                "qstart": int(recs.q_start[i]),
                "qend": int(recs.q_end[i]),
                "strand": "-" if int(recs.strand[i]) else "+",
                "tname": si.get_name(int(recs.target_id[i])),
                "tstart": int(recs.t_start[i]),
                "tend": int(recs.t_end[i]),
                "runs": recs.runs[o0:o1],
            }
        )
    return rows


def align_rows_native(
    seqs: dict[str, bytes],
    sparsify: str = "none",
    config=None,
) -> list[dict]:
    """All-vs-all (optionally sparsified) native alignment rows — the
    align-step the reference delegates to sweepga (main.rs:8734
    build_graph_config → align_sequences)."""
    from impg_tpu_torch.commands import align as align_mod
    from impg_tpu_torch.syng.index import SyngIndex

    if config is None:
        config = align_mod.AlignConfig()
    index = SyngIndex.build(list(seqs.items()))
    names = list(seqs)
    pairs = align_mod.select_pairs(
        names, seqs, sparsify,
        mash_k=getattr(config, "mash_k", 15),
        sketch_size=getattr(config, "sketch_size", 1000),
    )
    rows: list[dict] = []
    for q, t in pairs:
        rows.extend(align_mod.align_sequence_pair(index, seqs, q, t, config))
    return rows


def build_graph_flat(
    seqs: dict[str, bytes],
    engine: str = "seqwish",
    paf_rows: list[dict] | None = None,
    poa_scoring=None,
    sparsify: str = "none",
) -> str:
    """Whole-input GFA text for the flat (non-partitioned) build."""
    if engine in ("syng-native", "syng-local", "syng"):
        raise ValueError(
            "--gfa-engine syng/syng-local is only available under "
            "`query`/`partition` with selected intervals; use `seqwish` "
            "or `pggb` here"
        )
    if engine == "poa":
        from impg_tpu_torch.graph import poa as poa_mod

        names = list(seqs)
        scoring = poa_scoring or poa_mod.DEFAULT_SCORING
        result = poa_mod.poa_align([seqs[n] for n in names], scoring)
        return poa_mod.poa_to_gfa(result, names)
    if engine not in ("seqwish", "pggb"):
        raise ValueError(f"unknown graph engine '{engine}'")
    from impg_tpu_torch.graph import seqwish as seqwish_mod

    if paf_rows is None:
        paf_rows = align_rows_native(seqs, sparsify=sparsify)
    gfa = seqwish_mod.induce_graph(seqs, paf_rows)
    # induce_graph names paths `name:0-len`; flat input paths are the
    # source sequences themselves.
    fixed = []
    for line in gfa.splitlines():
        if line.startswith("P\t") or line.startswith("W\t"):
            parts = line.split("\t")
            col = 1 if line.startswith("P\t") else 3
            base, _, suffix = parts[col].rpartition(":")
            if suffix.startswith("0-") and base in seqs:
                parts[col] = base
            fixed.append("\t".join(parts))
        else:
            fixed.append(line)
    gfa = "\n".join(fixed) + ("\n" if fixed else "")
    if engine == "pggb":
        from impg_tpu_torch.graph.pggb import pggb_chain

        gfa = pggb_chain(gfa)
    return gfa
