"""GFA -> VCF: call variants from path walks against a reference path
(reference: lib.rs:930 gfa_to_vcf_string via POVU flubble decomposition).

The port's copy of impg_tpu/graph/vcf.py: `gfa_to_vcf` and its helpers,
the VCF of `query -o vcf`, `partition -o vcf` and `gfa2vcf`
(tests/test_torch_poa.py holds the text equal), and `gfa_to_vcf_flubbles`,
the multi-allelic caller of `gfa2vcf --sites flubbles` over
graph/bubbles.py's decomposition (tests/test_torch_gfa_tools.py).

Method (path-anchored bubble calling): for every non-reference path, match
its node walk against the reference walk via a longest increasing chain of
shared nodes; between consecutive shared anchors, the differing node
subsequences spell REF/ALT alleles at the reference coordinate (VCF
conventions: 1-based, indels left-anchored on the preceding base).
Identical (pos, ref, alt) records merge across paths; per-path genotypes
are emitted as haploid sample columns.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from impg_tpu_torch.graph.gfa import Gfa
from impg_tpu_torch.io.fasta import reverse_complement


def _step_seq(gfa: Gfa, step: tuple[str, bool]) -> bytes:
    seq = gfa.segments[step[0]].encode()
    return reverse_complement(seq) if step[1] else seq


def _walk_seq(gfa: Gfa, steps) -> bytes:
    return b"".join(_step_seq(gfa, s) for s in steps)


def _select_reference(paths, reference_path: str | None):
    """Pick the reference walk: exact name first, then a prefix followed by
    a PanSN/range separator (an earlier 'chr10:...' must not shadow an
    exact or 'chr1:...' match for reference_path='chr1'); unknown names
    raise instead of silently calling against the first path."""
    if reference_path is None:
        return paths[0]
    for name, steps in paths:
        if name == reference_path:
            return name, steps
    for name, steps in paths:
        if name.startswith(reference_path + ":") or name.startswith(
            reference_path + "#"
        ):
            return name, steps
    have = ", ".join(n for n, _ in paths[:5])
    raise ValueError(
        f"reference path '{reference_path}' not found in GFA (paths: "
        f"{have}{', ...' if len(paths) > 5 else ''})"
    )


def _ref_frame(ref_name: str) -> tuple[str, int]:
    """CHROM + base offset from a `name:start-end` path name."""
    if ":" in ref_name:
        base, _, rng = ref_name.rpartition(":")
        if "-" in rng:
            s, _, _e = rng.partition("-")
            try:
                return base, int(s)
            except ValueError:
                pass
    return ref_name, 0


def _ref_offsets(gfa: Gfa, ref_steps) -> list[int]:
    """Cumulative bp offset at each reference step boundary."""
    off = [0]
    for s in ref_steps:
        off.append(off[-1] + len(gfa.segments[s[0]]))
    return off


def _anchor_chain(ref_steps, alt_steps) -> list[tuple[int, int]]:
    """(ref_idx, alt_idx) pairs of shared oriented nodes, increasing in both
    walks (LIS over reference positions of alt's shared nodes).

    Anchors are restricted to steps occurring EXACTLY ONCE in each walk
    (crush's anchor rule): repeated nodes become bubble interiors instead
    of candidates, which keeps the candidate set linear — an all-pairs
    enumeration over repeat nodes is quadratic on real pangenomes
    (observed 144M candidates on a 32k-node yeast chrV graph)."""
    ref_count: dict[tuple[str, bool], int] = {}
    for s in ref_steps:
        ref_count[s] = ref_count.get(s, 0) + 1
    alt_count: dict[tuple[str, bool], int] = {}
    for s in alt_steps:
        alt_count[s] = alt_count.get(s, 0) + 1
    ref_pos = {
        s: i for i, s in enumerate(ref_steps)
        if ref_count[s] == 1 and alt_count.get(s) == 1
    }
    # Candidates in alt order; patience LIS over (alt_idx, ref_idx).
    cands: list[tuple[int, int]] = []
    for j, s in enumerate(alt_steps):
        i = ref_pos.get(s)
        if i is not None:
            cands.append((j, i))
    # LIS on ref_idx over alt-ordered candidates (strictly increasing both).
    tails: list[int] = []
    tails_idx: list[int] = []
    back = [-1] * len(cands)
    for ci, (j, i) in enumerate(cands):
        k = bisect.bisect_left(tails, i)
        if k > 0:
            back[ci] = tails_idx[k - 1]
        if k == len(tails):
            tails.append(i)
            tails_idx.append(ci)
        else:
            tails[k] = i
            tails_idx[k] = ci
    if not tails_idx:
        return []
    chain = []
    cur = tails_idx[-1]
    while cur != -1:
        chain.append(cands[cur])
        cur = back[cur]
    chain.reverse()
    # chain is (alt_idx, ref_idx); return (ref_idx, alt_idx), ensuring strict
    # increase on the alt side too (LIS guarantees ref side).
    out = []
    last_alt = -1
    for j, i in chain:
        if j > last_alt:
            out.append((i, j))
            last_alt = j
    return out


_INFO_HEADER_AC = (
    '##INFO=<ID=AC,Number=A,Type=Integer,'
    'Description="Allele count in genotypes">'
)
_INFO_HEADER_AN = (
    '##INFO=<ID=AN,Number=1,Type=Integer,'
    'Description="Total number of alleles in called genotypes">'
)


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based
    ref: str
    alt: str
    carriers: set = field(default_factory=set)


def gfa_to_vcf(gfa_text: str, reference_path: str | None = None) -> str:
    """Call variants of every path against the reference path.

    `reference_path` selects by exact name or prefix; defaults to the first
    path.  Path names of the form `name:start-end` shift coordinates by
    `start` and report CHROM as `name`.
    """
    gfa = Gfa.parse(gfa_text)
    if not gfa.paths:
        return "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    ref_name, ref_steps = _select_reference(gfa.paths, reference_path)

    # Reference coordinates: cumulative bp offset at each step boundary.
    ref_off = _ref_offsets(gfa, ref_steps)
    ref_seq = _walk_seq(gfa, ref_steps).decode()
    chrom, base_offset = _ref_frame(ref_name)

    records: dict[tuple[int, str, str], VcfRecord] = {}
    sample_names = [n for n, _ in gfa.paths if n != ref_name]
    # Paths that never anchor to the reference walk carry no evidence
    # either way: genotype them missing ('.'), not reference ('0') —
    # same contract as gfa_to_vcf_flubbles for non-traversing paths.
    no_chain: set[str] = set()
    # Reference bp span each path's anchor chain covers: outside it the
    # path has no evidence, so records there genotype '.', not '0'.
    span: dict[str, tuple[int, int]] = {}

    for alt_name, alt_steps in gfa.paths:
        if alt_name == ref_name:
            continue
        chain = _anchor_chain(ref_steps, alt_steps)
        if not chain:
            no_chain.add(alt_name)
            continue
        span[alt_name] = (
            ref_off[chain[0][0]], ref_off[chain[-1][0] + 1]
        )
        for (ri, ai), (rj, aj) in zip(chain, chain[1:]):
            if rj == ri + 1 and aj == ai + 1:
                continue  # contiguous: no bubble
            ref_sub = ref_seq[ref_off[ri + 1] : ref_off[rj]]
            alt_sub = _walk_seq(gfa, alt_steps[ai + 1 : aj]).decode()
            if ref_sub == alt_sub:
                continue
            pos0 = ref_off[ri + 1]  # 0-based ref coordinate of the bubble
            if ref_sub and alt_sub and len(ref_sub) == len(alt_sub):
                # (MNP kept as one record; trim shared affixes.)
                lead = 0
                while (
                    lead < len(ref_sub)
                    and ref_sub[lead] == alt_sub[lead]
                ):
                    lead += 1
                trail = 0
                while (
                    trail < len(ref_sub) - lead
                    and ref_sub[-1 - trail] == alt_sub[-1 - trail]
                ):
                    trail += 1
                r = ref_sub[lead : len(ref_sub) - trail]
                a = alt_sub[lead : len(alt_sub) - trail]
                pos = pos0 + lead
                if not r:
                    continue
            else:
                # Indel / complex: left-anchor with the preceding base.
                anchor_pos = pos0 - 1
                if anchor_pos < 0:
                    continue
                anchor = ref_seq[anchor_pos]
                r = anchor + ref_sub
                a = anchor + alt_sub
                pos = anchor_pos
            key = (pos, r, a)
            rec = records.get(key)
            if rec is None:
                rec = VcfRecord(
                    chrom=chrom, pos=base_offset + pos + 1, ref=r, alt=a
                )
                records[key] = rec
            rec.carriers.add(alt_name)

    out = [
        "##fileformat=VCFv4.2",
        f"##reference={ref_name}",
        _INFO_HEADER_AC,
        _INFO_HEADER_AN,
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_names),
    ]
    for key in sorted(records):
        rec = records[key]
        raw_pos = key[0]

        def gt_of(name: str) -> str:
            if name in rec.carriers:
                return "1"
            sp = span.get(name)
            if sp is None or not (sp[0] <= raw_pos < sp[1]):
                return "."  # no anchored evidence at this position
            return "0"

        gts = [gt_of(name) for name in sample_names]
        an = sum(1 for g in gts if g != ".")
        out.append(
            f"{rec.chrom}\t{rec.pos}\t.\t{rec.ref}\t{rec.alt}\t.\t.\t"
            f"AC={len(rec.carriers)};AN={an}\tGT\t" + "\t".join(gts)
        )
    return "\n".join(out) + "\n"


def gfa_to_vcf_flubbles(
    gfa_text: str, reference_path: str | None = None
) -> str:
    """Multi-allelic site calling from the flubble decomposition
    (reference: lib.rs:930 gfa_to_vcf_string via POVU flubbles): one record
    per top-level variation site, ALT = every non-reference interior
    spelling, per-path GT = allele index ('.' for paths not traversing
    the site)."""
    from impg_tpu_torch.graph import bubbles as bubbles_mod

    gfa = Gfa.parse(gfa_text)
    header_only = (
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    )
    if not gfa.paths:
        return header_only
    refs = [reference_path] if reference_path else None
    dec = bubbles_mod.decompose_flubbles(gfa_text, refs)
    ref_name = dec.reference_path
    ref_steps = dict(gfa.paths)[ref_name]
    ref_off = _ref_offsets(gfa, ref_steps)
    ref_pos_of_step = {s: i for i, s in enumerate(ref_steps)}
    ref_seq = _walk_seq(gfa, ref_steps).decode()
    chrom, base_offset = _ref_frame(ref_name)

    def parse_token(tok: str):
        return (tok[:-1], tok.endswith("-"))

    sample_names = [n for n, _ in gfa.paths if n != ref_name]
    lines: list[tuple[int, str]] = []
    for site in dec.sites:
        if site.level != 0:
            continue
        a = parse_token(site.start)
        b = parse_token(site.end)
        # Interior spelling per path between the unique a..b occurrences.
        interiors: dict[str, str | None] = {}
        for name, steps in gfa.paths:
            try:
                ia = steps.index(a)
                ib = steps.index(b)
            except ValueError:
                interiors[name] = None
                continue
            if ib < ia:
                interiors[name] = None
                continue
            interiors[name] = _walk_seq(gfa, steps[ia + 1 : ib]).decode()
        ref_allele = interiors.get(ref_name)
        if ref_allele is None or a not in ref_pos_of_step:
            continue
        alts: list[str] = []
        for name in sample_names:
            iv = interiors.get(name)
            if iv is not None and iv != ref_allele and iv not in alts:
                alts.append(iv)
        if not alts:
            continue
        pos0 = ref_off[ref_pos_of_step[a] + 1]
        alleles = [ref_allele] + alts
        if any(not al for al in alleles) or len(
            {len(al) for al in alleles}
        ) > 1:
            # Indel/complex site: left-anchor on the preceding ref base.
            anchor_pos = pos0 - 1
            if anchor_pos < 0:
                continue
            anchor = ref_seq[anchor_pos]
            alleles = [anchor + al for al in alleles]
            pos = anchor_pos
        else:
            lead = 0
            while lead < len(alleles[0]) and len(
                {al[lead] for al in alleles}
            ) == 1:
                lead += 1
            trail = 0
            while trail < len(alleles[0]) - lead and len(
                {al[len(al) - 1 - trail] for al in alleles}
            ) == 1:
                trail += 1
            alleles = [al[lead : len(al) - trail] for al in alleles]
            pos = pos0 + lead
            if not alleles[0]:
                continue
        gt_cols = []
        an = 0
        ac = [0] * len(alts)
        for name in sample_names:
            iv = interiors.get(name)
            if iv is None:
                gt_cols.append(".")
                continue
            an += 1
            if iv == ref_allele:
                gt_cols.append("0")
            else:
                k = alts.index(iv) + 1
                ac[k - 1] += 1
                gt_cols.append(str(k))
        lines.append(
            (
                pos,
                f"{chrom}\t{base_offset + pos + 1}\t{site.id}\t"
                f"{alleles[0]}\t{','.join(alleles[1:])}\t.\t.\t"
                f"AC={','.join(str(c) for c in ac)};AN={an}\tGT\t"
                + "\t".join(gt_cols),
            )
        )
    out = [
        "##fileformat=VCFv4.2",
        f"##reference={ref_name}",
        _INFO_HEADER_AC,
        _INFO_HEADER_AN,
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_names),
    ]
    for _, line in sorted(lines):
        out.append(line)
    return "\n".join(out) + "\n"

