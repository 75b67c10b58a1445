"""The pggb engine's automatic transform chain.

Reference: lib.rs:1015-1064 GfaEngine::Pggb — seqwish induction, then:
  1. lexicographic line-sort of the raw GFA (seqwish emits L lines in a
     thread-dependent order; ygs sort is parse-order-sensitive),
  2. Ygs sort (path-SGD 1D layout + groom + topo, required by the
     smoothxg-style block decomposition),
  3. smooth at the configured target POA lengths, with n_haps counted as
     distinct PanSN sample#haplotype prefixes of the input paths (NOT the
     interval count — lib.rs:1037-1048),
  4. gfaffix-style normalize + final Ygs sort (graph::normalize_and_sort),
     skipped in partitioned builds where it runs once after lacing
     (lib.rs:1060 skip_normalize).

This makes `--gfa-engine pggb` produce the reference's full pipeline
output instead of stopping at seqwish+sort; each stage remains available
as an explicit `-o gfa:` DSL stage too.

The port's copy of impg_tpu/graph/pggb.py (tests/test_torch_seqwish.py and
tests/test_torch_graph_pipeline.py hold the chain equal).  Its Ygs sorts run
`sortgfa.sort_pipeline` under `auto`, the numpy layout loop for every graph
below impg_tpu's 5e8-sample threshold, as in impg_tpu.
"""

from __future__ import annotations

from impg_tpu_torch.query.subset import extract_sample_and_hap


def count_pansn_haplotypes(path_names) -> int:
    """Distinct sample#haplotype keys (sweepga::pansn::count_pansn_keys at
    PanSnLevel::Haplotype role); non-PanSN names count individually."""
    keys = set()
    for name in path_names:
        parsed = extract_sample_and_hap(name)
        if parsed is None:
            keys.add(name)
        else:
            sample, hap = parsed
            keys.add((sample, hap))
    return max(len(keys), 1)


def pggb_chain(
    gfa_text: str,
    target_poa_lengths=(700, 1100),
    scoring=None,
    skip_normalize: bool = False,
) -> str:
    """Apply the post-seqwish pggb transform chain to a raw seqwish GFA."""
    from impg_tpu_torch.graph import normalize as normalize_mod
    from impg_tpu_torch.graph import smooth as smooth_mod
    from impg_tpu_torch.graph import sortgfa as sortgfa_mod
    from impg_tpu_torch.graph.poa import DEFAULT_SCORING

    # 1. deterministic line order before the parse-order-sensitive sort
    text = "\n".join(sorted(l for l in gfa_text.splitlines() if l)) + "\n"
    # 2. Ygs 1D layout
    text = sortgfa_mod.sort_pipeline(text, "Ygs")
    # 3. smooth; n_haps from the sorted graph's path names
    path_names = [
        line.split("\t")[1]
        for line in text.splitlines()
        if line.startswith("P\t")
    ]
    text = smooth_mod.smooth_gfa_passes(
        text,
        target_poa_lengths=target_poa_lengths,
        scoring=scoring or DEFAULT_SCORING,
        n_haps=count_pansn_haplotypes(path_names),
    )
    # smooth's relace suffixes full-cover paths as `name:0-len`; the
    # reference chain keeps the input path names — strip the redundant
    # whole-path suffix (same rule as generate_gfa_seqwish's fixup).
    originals = set(path_names)
    fixed = []
    for line in text.splitlines():
        if line.startswith("P\t"):
            parts = line.split("\t")
            base, _, suffix = parts[1].rpartition(":")
            if base in originals and suffix.startswith("0-"):
                parts[1] = base
            fixed.append("\t".join(parts))
        else:
            fixed.append(line)
    text = "\n".join(fixed) + "\n"
    # 4. gfaffix normalize + final sort
    if not skip_normalize:
        text = normalize_mod.normalize_gfa(text)
        text = sortgfa_mod.sort_pipeline(text, "Ygs")
    return text
