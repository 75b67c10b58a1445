"""A locus panel as a variation graph in GFA, drawn from the seed.

The draws are those of impg_tpu_torch/synth.py:variation_graph, copied here
so that the benchmark's data stays as it is whatever later changes make to
synth.py: a random backbone of the locus carries variant sites, each
founder's sites carried by every haplotype h with h % n_founders == f and
each haplotype's own; a site is a SNP bubble or, for an `indel_share` of
them, a deletion or an insertion of 1..max_indel bases.  P lines hap0..
spell the haplotypes, L lines are the paths' distinct adjacencies, and the
segment names are a random permutation, S lines in name order, so the
file's order says nothing of the layout.

`make` draws the graph itself from the configuration's `graph_seed`, so
that every run sorts the same locus, as a deployment does, and the same
work; the run's seed draws the segments' names, and so the order of the
file and of the program's rows.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def variation_graph(seed: int, n_haps: int, locus_len: int, founders: int,
                    founder_div: float, hap_div: float, indel_share: float,
                    max_indel: int, name_seed: int | None = None) -> str:
    rng = np.random.default_rng(seed)
    base = _BASES[rng.integers(0, 4, locus_len)]
    pos_parts, carrier_parts = [], []
    hap_ids = np.arange(n_haps)
    for f in range(founders):
        p = rng.integers(1, locus_len - max_indel - 1,
                         rng.binomial(locus_len, founder_div))
        pos_parts.append(p)
        carrier_parts.append(np.broadcast_to(hap_ids % founders == f,
                                             (p.size, n_haps)))
    for h in range(n_haps):
        p = rng.integers(1, locus_len - max_indel - 1,
                         rng.binomial(locus_len, hap_div))
        pos_parts.append(p)
        carrier_parts.append(np.broadcast_to(hap_ids == h, (p.size, n_haps)))
    pos = np.concatenate(pos_parts)
    carriers = np.concatenate(carrier_parts)
    pos, first = np.unique(pos, return_index=True)
    carriers = carriers[first]
    kind_draw = rng.random(pos.size)
    kind = np.where(kind_draw < indel_share / 2, 1,
                    np.where(kind_draw < indel_share, 2, 0))
    length = np.where(kind == 0, 1, rng.integers(1, max_indel + 1, pos.size))
    extent = np.where(kind == 2, 0, length)
    keep = np.ones(pos.size, bool)
    end = 0
    for k, (p, e) in enumerate(zip(pos.tolist(), extent.tolist())):
        if p <= end:
            keep[k] = False
        else:
            end = p + e
    pos, kind, length, extent, carriers = (
        pos[keep], kind[keep], length[keep], extent[keep], carriers[keep])
    n_sites = pos.size
    n_site_segs = np.where(kind == 0, 2, 1)
    seg_per_site = 1 + n_site_segs
    site_first = np.concatenate([[0], np.cumsum(seg_per_site)])[:-1]
    n_segs = int(seg_per_site.sum()) + 1
    chunk_start = np.concatenate([[0], pos[:-1] + extent[:-1]])
    seqs: list[bytes] = [b""] * n_segs
    base_b = base.tobytes()
    alt_base = _BASES[(np.searchsorted(_BASES, base[pos])
                       + rng.integers(1, 4, n_sites)) % 4].tobytes()
    ins_seq = _BASES[rng.integers(0, 4, int(length.sum()))].tobytes()
    ins_off = np.concatenate([[0], np.cumsum(length)])
    for k, (s0, p, kd, ln, sf) in enumerate(zip(
            chunk_start.tolist(), pos.tolist(), kind.tolist(),
            length.tolist(), site_first.tolist())):
        seqs[sf] = base_b[s0:p]
        if kd == 0:
            seqs[sf + 1] = base_b[p:p + 1]
            seqs[sf + 2] = alt_base[k:k + 1]
        elif kd == 1:
            seqs[sf + 1] = base_b[p:p + ln]
        else:
            seqs[sf + 1] = ins_seq[int(ins_off[k]):int(ins_off[k]) + ln]
    last_start = int(pos[-1] + extent[-1]) if n_sites else 0
    seqs[n_segs - 1] = base_b[last_start:]
    ref_seg = np.where(kind == 2, -1, site_first + 1)
    alt_seg = np.where(kind == 0, site_first + 2,
                       np.where(kind == 2, site_first + 1, -1))
    name_rng = rng if name_seed is None else np.random.default_rng(
        [name_seed, 7])
    names = name_rng.permutation(n_segs) + 1
    tok = [f"{names[i]}+," for i in range(n_segs)]
    lines = ["H\tVN:Z:1.0"]
    by_name = np.argsort(names)
    lines += [f"S\t{names[i]}\t{seqs[i].decode()}" for i in by_name.tolist()]
    pairs = []
    paths = []
    for h in range(n_haps):
        steps = np.empty((n_sites, 2), np.int64)
        steps[:, 0] = site_first
        steps[:, 1] = np.where(carriers[:, h], alt_seg, ref_seg)
        walk = steps.reshape(-1)
        walk = np.append(walk[walk >= 0], n_segs - 1)
        pairs.append(walk[:-1] * n_segs + walk[1:])
        body = "".join([tok[i] for i in walk.tolist()])
        paths.append(f"P\thap{h}\t{body[:-1]}\t*")
    links = np.unique(np.concatenate(pairs))
    la, lb = names[links // n_segs], names[links % n_segs]
    lines += [f"L\t{a}\t+\t{b}\t+\t0M"
              for a, b in zip(la.tolist(), lb.tolist())]
    lines += paths
    return "\n".join(lines) + "\n"


def make(config: dict, seed: int, workdir: str) -> dict:
    """The GFA text; the program parses it in every sort."""
    return dict(gfa=variation_graph(
        config["graph_seed"], config["n_haps"], config["locus_len"],
        config["n_founders"], config["founder_div"], config["hap_div"],
        config["graph_indel_share"], config["graph_max_indel"],
        name_seed=seed))
