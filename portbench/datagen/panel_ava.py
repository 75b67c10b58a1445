"""An all-vs-all alignment set of a locus panel: every pair of the panel's
haplotypes aligned over the whole locus, each CIGAR the real difference of
the two.

The panel is datagen/panel_gfa.py's, drawn from the same `graph_seed`: the
site draws below are a copy of `panel_gfa.variation_graph`'s up to the
sites (a backbone, each founder's sites carried by every haplotype h with
h % n_founders == f, each haplotype's own; a site a SNP or, for an
`indel_share` of them, a deletion or an insertion of 1..max_indel bases),
so that this panel spells, haplotype for haplotype, the P lines of the sort
cell's graph.

For every pair i < j, haplotype j (query) is aligned against haplotype i
(target), strand '+': `=` runs between the sites where the two differ, and
at such a site an `X` for a SNP, or an `I`/`D` of the indel's length.  The
pairs and their sites are worked out in numpy, a block of pairs at a time.
`make` hands each block's columns to the program's own ingest
(`core.arena.build_directed`, then `ImpgIndex._finalize`, as
datagen/yeast_ava.py does): that ingest is set-up.  The index enters each
alignment in both directions, so no mirrored alignment is drawn.

The data is the configuration's one panel in every run; the run's seed
draws only the seed ranges of the traffic.
"""

from __future__ import annotations

import numpy as np

from portbench.datagen.yeast_ava import OP_D, OP_EQ, OP_I, OP_X, pack

_BASES = np.frombuffer(b"ACGT", np.uint8)
# Pairs of haplotypes a block: about 5M runs a block at the MHC's sizes.
PAIRS_PER_BLOCK = 512


def panel_sites(seed: int, n_haps: int, locus_len: int, founders: int,
                founder_div: float, hap_div: float, indel_share: float,
                max_indel: int) -> dict:
    """The panel's backbone and sites, drawn as panel_gfa.variation_graph
    draws them: `pos`, `kind` (0 SNP, 1 deletion, 2 insertion), `length`,
    `carriers` [site, haplotype] and the bases that spell the alleles."""
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
    pos, kind, length, carriers = (pos[keep], kind[keep], length[keep],
                                   carriers[keep])
    alt_base = _BASES[(np.searchsorted(_BASES, base[pos])
                       + rng.integers(1, 4, pos.size)) % 4]
    ins_seq = _BASES[rng.integers(0, 4, int(length.sum()))]
    return dict(base=base, pos=pos.astype(np.int64), kind=kind,
                length=length.astype(np.int64),
                carriers=np.ascontiguousarray(carriers), alt_base=alt_base,
                ins_seq=ins_seq,
                ins_off=np.concatenate([[0], np.cumsum(length)]))


def site_params(config: dict) -> dict:
    return dict(seed=config["graph_seed"], n_haps=config["n_haps"],
                locus_len=config["locus_len"],
                founders=config["n_founders"],
                founder_div=config["founder_div"],
                hap_div=config["hap_div"],
                indel_share=config["graph_indel_share"],
                max_indel=config["graph_max_indel"])


def seq_names(n_haps: int) -> list[str]:
    """The haplotypes' names, as the sort cell's P lines name them."""
    return [f"hap{h}" for h in range(n_haps)]


def offsets(sites: dict) -> tuple[np.ndarray, np.ndarray]:
    """Each haplotype's shift at each site from the backbone (the bases its
    earlier indels took or added) [site, haplotype], and its length."""
    delta = np.where(sites["kind"] == 1, -sites["length"],
                     np.where(sites["kind"] == 2, sites["length"], 0))
    step = sites["carriers"] * delta[:, None]
    shift = np.cumsum(step, axis=0) - step
    length = len(sites["base"]) + step.sum(axis=0)
    return shift, length.astype(np.int64)


def pair_block(sites: dict, shift: np.ndarray, hap_len: np.ndarray,
               tgt: np.ndarray, qry: np.ndarray) -> dict:
    """The alignments of query haplotypes `qry` against target haplotypes
    `tgt`, one a pair, as a dict of columns (int32 ids and coordinates,
    int8 strand, packed uint32 runs and their int64 offsets)."""
    car = sites["carriers"]
    n = tgt.size
    pair, site = np.nonzero((car[:, tgt] != car[:, qry]).T)
    t_has = car[site, tgt[pair]]
    kind = sites["kind"][site]
    ln = sites["length"][site]
    op = np.where(kind == 0, OP_X,
                  np.where((kind == 1) == t_has, OP_I, OP_D))
    t_cons = np.where(op == OP_I, 0, ln)
    t_at = sites["pos"][site] + shift[site, tgt[pair]]
    n_ev = np.bincount(pair, minlength=n)
    ev_first = np.cumsum(n_ev) - n_ev
    # Target end of each event's predecessor in its pair (0 for the first).
    prev_end = np.zeros(site.size, np.int64)
    prev_end[1:] = (t_at + t_cons)[:-1]
    prev_end[ev_first[n_ev > 0]] = 0
    last_end = np.zeros(n, np.int64)
    has = n_ev > 0
    last_end[has] = (t_at + t_cons)[ev_first[has] + n_ev[has] - 1]
    n_runs = 2 * n_ev + 1
    run_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(n_runs, out=run_offsets[1:])
    lens = np.empty(int(run_offsets[-1]), np.int64)
    ops = np.full(lens.size, OP_EQ, np.int64)
    ev_run = (run_offsets[:-1][pair]
              + 2 * (np.arange(site.size) - ev_first[pair]) + 1)
    lens[ev_run - 1] = t_at - prev_end
    lens[ev_run] = ln
    ops[ev_run] = op
    lens[run_offsets[1:] - 1] = hap_len[tgt] - last_end
    return dict(
        query_id=qry.astype(np.int32),
        q_start=np.zeros(n, np.int32),
        q_end=hap_len[qry].astype(np.int32),
        target_id=tgt.astype(np.int32),
        t_start=np.zeros(n, np.int32),
        t_end=hap_len[tgt].astype(np.int32),
        strand=np.zeros(n, np.int8),
        runs=pack(lens, ops),
        run_offsets=run_offsets,
    )


def reference_data(config: dict) -> tuple[list, list, list]:
    """The drawn alignments' columns, names and lengths, without the
    program."""
    sites = panel_sites(**site_params(config))
    shift, hap_len = offsets(sites)
    tgt, qry = np.triu_indices(config["n_haps"], 1)
    chunks = [pair_block(sites, shift, hap_len, tgt[b:b + PAIRS_PER_BLOCK],
                         qry[b:b + PAIRS_PER_BLOCK])
              for b in range(0, tgt.size, PAIRS_PER_BLOCK)]
    return chunks, seq_names(config["n_haps"]), hap_len.tolist()


def make(config: dict, seed: int, workdir: str) -> dict:
    """The program's index over the panel's alignments, with their columns,
    the haplotypes' names and lengths for the reference."""
    from impg_tpu_torch.core import arena as arena_mod
    from impg_tpu_torch.core.arena import CigarArena, DirectedRecords
    from impg_tpu_torch.core.seqidx import SequenceIndex
    from impg_tpu_torch.index.impg_index import ImpgIndex

    chunks, names, lengths = reference_data(config)
    rec_parts = []
    arena_parts = {f: [] for f in CigarArena.EAGER_FIELDS}
    seg_parts = [np.zeros(1, np.int64)]
    arena_base = 0
    rec_base = 0
    for cols in chunks:
        records, arena = arena_mod.build_directed(**cols)
        records.op_off += arena_base
        records.rec_id += rec_base
        rec_parts.append(records)
        for f in arena_parts:
            arena_parts[f].append(getattr(arena, f))
        seg_parts.append(arena.seg_offsets[1:] + arena_base)
        arena_base += arena.n_ops
        rec_base += cols["query_id"].size
    records = DirectedRecords.concatenate(rec_parts)
    del rec_parts
    arena_cols = {f: np.concatenate(arena_parts.pop(f))
                  for f in list(arena_parts)}
    arena = CigarArena(**arena_cols, seg_offsets=np.concatenate(seg_parts))
    del arena_cols
    seq_index = SequenceIndex()
    for name, ln in zip(names, lengths):
        seq_index.get_or_insert_id(name, ln)
    index = ImpgIndex._finalize(seq_index, records, arena, [])
    return dict(index=index, chunks=chunks, names=names, lengths=lengths)
