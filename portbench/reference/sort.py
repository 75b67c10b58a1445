"""Plain reference of `sort --pipeline Ygs` (gfasort's Y, g and s): from the
GFA text alone, the order in which the sorted graph must list its segments,
and the checks of a sorted graph against it.

Y, the path-guided 1D layout, as the program specifies it
(ops/path_sgd.py's module docstring): segments start at the bp midpoint of
their first step along the paths (float32); each of `epochs` epochs draws
`samples_per_step` x steps pairs within paths from a counter-based
Philox4x32-10 keyed by (42, epoch) with the sample index as the counter
(i = (u0 n) >> 32; t = ((u1 << 21) | (u3 >> 11)) 2^-53; a partner at
ceil(exp(t ln n)) steps, before the step when u2 < 2^31, clipped to the
path); each pair pulls its two segments toward their bp distance at the
annealed rate min(eta / d^2, 1), eta = eta_max exp(-lambda t) from the
paths' span down to 0.01; an epoch's pulls are averaged per segment and
applied at once, summed exactly in int64 fixed point.  The order is by
(position, row).  g flips segments read backward by most steps (none, in a
graph whose paths run forward), and s is Kahn's topological sort over the
links taking the ready segment first in the layout's order, then renumbers
the segments 1..N in that order.

This is plain torch and NumPy, run on the card for the layout; it imports
nothing of the program.  `position_dtype=torch.bfloat16` keeps the
positions in bfloat16 between epochs: the control that a layout held in a
16-bit float must fail.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

SEED = 42
M32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
DRAW_CHUNK = 1 << 24
_COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


# ---- GFA -------------------------------------------------------------------


def _steps(body: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(segment names as ints, reverse flags) of a P line's step list."""
    a = np.frombuffer(body, np.uint8)
    sign = np.flatnonzero((a == 43) | (a == 45))
    rev = a[sign] == 45
    starts = np.concatenate([[0], sign[:-1] + 2])
    lens = sign - starts
    vals = np.zeros(sign.size, np.int64)
    for k in range(int(lens.max()) if lens.size else 0):
        m = lens > k
        vals[m] = vals[m] * 10 + (a[starts[m] + k].astype(np.int64) - 48)
    return vals, rev


class Graph:
    """A GFA with numeric segment names: S lines in file order (rows), L
    lines, P lines."""

    def __init__(self, text: str):
        names, seqs, la, lb, paths = [], [], [], [], []
        for line in text.encode().split(b"\n"):
            if line.startswith(b"S\t"):
                f = line.split(b"\t")
                names.append(int(f[1]))
                seqs.append(f[2])
            elif line.startswith(b"L\t"):
                f = line.split(b"\t")
                la.append(int(f[1]))
                lb.append(int(f[3]))
            elif line.startswith(b"P\t"):
                f = line.split(b"\t")
                paths.append((f[1].decode(), _steps(f[2])))
        self.names = np.asarray(names, np.int64)
        self.seqs = seqs
        self.row_of = np.full(int(self.names.max()) + 1, -1, np.int64)
        self.row_of[self.names] = np.arange(self.names.size)
        self.links = (self.row_of[np.asarray(la, np.int64)],
                      self.row_of[np.asarray(lb, np.int64)])
        self.path_names = [p[0] for p in paths]
        self.step_row = np.concatenate([self.row_of[p[1][0]]
                                        for p in paths])
        self.step_rev = np.concatenate([p[1][1] for p in paths])
        self.path_off = np.concatenate(
            [[0], np.cumsum([p[1][0].size for p in paths])]).astype(np.int64)
        self.lens = np.array([len(s) for s in seqs], np.int64)

    @property
    def n_segs(self) -> int:
        return int(self.names.size)

    def spell(self, p: int) -> bytes:
        """Path p's sequence, reverse steps complemented."""
        lo, hi = int(self.path_off[p]), int(self.path_off[p + 1])
        seqs = self.seqs
        return b"".join([
            seqs[r].translate(_COMP)[::-1] if back else seqs[r]
            for r, back in zip(self.step_row[lo:hi].tolist(),
                               self.step_rev[lo:hi].tolist())])


# ---- Y: the layout ----------------------------------------------------------


def _mulhilo(x, m: int):
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    hi = (b + (a >> 16)) >> 16
    lo = (a + ((b & 0xFFFF) << 16)) & M32
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    k0, k1 = k0 & M32, k1 & M32
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & M32
            k1 = (k1 + PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draws(pstart, pend, epoch: int, first: int, count: int, log_n: float,
          key: int = SEED):
    idx = torch.arange(first, first + count, dtype=torch.int64,
                       device=pstart.device)
    z = torch.zeros_like(idx)
    u0, u1, u2, u3 = philox(idx & M32, idx >> 32, z, z, key, epoch)
    n = pstart.shape[0]
    i = (u0 * n) >> 32
    t = ((u1 << 21) | (u3 >> 11)).to(torch.float64) * 2.0 ** -53
    off = torch.ceil(torch.exp(t * log_n)).to(torch.int64)
    j = i + torch.where(u2 >= 2**31, off, -off)
    j = torch.minimum(torch.maximum(j, pstart[i]), pend[i] - 1)
    return i, j


def layout_inputs(g: Graph):
    """(step rows, bp midpoints along the paths, path start and end of each
    step, first-seen start positions)."""
    step_len = g.lens[g.step_row].astype(np.float64)
    ends = np.cumsum(step_len)
    base = np.zeros_like(step_len)
    pstart = np.zeros(step_len.size, np.int64)
    pend = np.zeros(step_len.size, np.int64)
    for p in range(len(g.path_names)):
        lo, hi = int(g.path_off[p]), int(g.path_off[p + 1])
        base[lo:hi] = ends[lo - 1] if lo else 0.0
        pstart[lo:hi] = lo
        pend[lo:hi] = hi
    pos = ends - base - step_len / 2.0
    n = g.n_segs
    first = np.full(n, pos.size, np.int64)
    np.minimum.at(first, g.step_row, np.arange(pos.size))
    seen = first < pos.size
    x0 = np.full(n, pos.max() + 1.0)
    x0[seen] = pos[first[seen]]
    return g.step_row, pos, pstart, pend, x0


def fixed_point(batch: int, bound: float) -> tuple[int, int]:
    q_max = 2**62 // max(2 * batch, 1)
    frac = 0
    while frac < 30 and max(bound, 1.0) * 2.0 ** (frac + 1) <= q_max:
        frac += 1
    return frac, q_max


def layout_positions(g: Graph, epochs: int, samples_per_step: int,
                     device, position_dtype=torch.float32,
                     key: int = SEED) -> np.ndarray:
    """Each segment row's position after the layout's epochs (float64)."""
    rows, pos, pstart, pend, x0 = layout_inputs(g)
    n_steps = rows.size
    batch = n_steps * samples_per_step
    span = float(pos.max() - pos.min()) or 1.0
    eta_max = span
    lam = math.log(eta_max / 0.01) / max(epochs - 1, 1)
    log_n = math.log(n_steps)
    frac, q_max = fixed_point(batch, max(float(np.ptp(x0)),
                                         float(np.ptp(pos))))
    dev = torch.device(device)
    node = torch.from_numpy(rows).to(dev)
    posf = torch.from_numpy(pos.astype(np.float32)).to(dev)
    ps = torch.from_numpy(pstart).to(dev)
    pe = torch.from_numpy(pend).to(dev)
    x = torch.from_numpy(x0.astype(np.float32)).to(dev)
    acc = torch.zeros(x.shape, dtype=torch.int64, device=dev)
    cnt = torch.zeros(x.shape, dtype=torch.int32, device=dev)
    for t in range(epochs):
        eta = float(np.float32(np.float32(eta_max)
                               * np.exp(np.float32(-lam) * np.float32(t))))
        for first in range(0, batch, DRAW_CHUNK):
            i, j = draws(ps, pe, t, first, min(DRAW_CHUNK, batch - first),
                         log_n, key)
            keep = i != j
            i, j = i[keep], j[keep]
            a, b = node[i], node[j]
            d = torch.clamp_min((posf[i] - posf[j]).abs(), 1e-9)
            w = torch.ones_like(d) / (d * d)
            mu = torch.clamp_max(eta * w, 1.0)
            diff = x[a] - x[b]
            mag = diff.abs()
            big = mag > 1e-9
            cur = torch.where(big, mag, torch.full_like(mag, 1e-9))
            r = (cur - d) / (2.0 * cur) * big.to(x.dtype)
            dx = mu * r * diff
            q = torch.clamp(dx * 2.0 ** frac, -2.0 ** 62, 2.0 ** 62)
            q = torch.clamp(torch.round(q).to(torch.int64), -q_max, q_max)
            acc.index_add_(0, a, q)
            acc.index_add_(0, b, -q)
            ones = torch.ones_like(a, dtype=torch.int32)
            cnt.index_add_(0, a, ones)
            cnt.index_add_(0, b, ones)
        x -= (acc.to(x.dtype) * 2.0 ** -frac) / torch.clamp_min(
            cnt.to(x.dtype), 1.0)
        if position_dtype != torch.float32:
            x = x.to(position_dtype).to(torch.float32)
        acc.zero_()
        cnt.zero_()
    return x.cpu().numpy().astype(np.float64)


def layout_order(x: np.ndarray) -> np.ndarray:
    """Segment rows by (position, row)."""
    return np.lexsort((np.arange(x.size), x))


# ---- the layout's quality -------------------------------------------------

STRESS_PAIRS = 1 << 20


def stress_pairs(g: Graph, seed: int, count: int = STRESS_PAIRS):
    """Step pairs within paths drawn from the seed as the layout draws its
    own (a step, and a partner a log-uniform number of steps before or
    after it, clipped to the path): (segment a, segment b, bp distance
    along the path) of the pairs whose segments differ."""
    rows, pos, pstart, pend, _ = layout_inputs(g)
    rng = np.random.default_rng([seed, 3])
    n = rows.size
    i = rng.integers(0, n, count)
    off = np.ceil(np.exp(rng.uniform(0.0, math.log(n), count))).astype(
        np.int64)
    j = np.clip(i + np.where(rng.random(count) < 0.5, -off, off),
                pstart[i], pend[i] - 1)
    a, b, d = rows[i], rows[j], np.abs(pos[i] - pos[j])
    keep = (a != b) & (d > 0)
    return a[keep], b[keep], d[keep]


def stress(x: np.ndarray, pairs) -> float:
    """The layout's stress over `pairs`: the mean squared relative gap
    between two segments' distance in the layout and along the path."""
    a, b, d = pairs
    r = (np.abs(x[a] - x[b]) - d) / d
    return float(np.mean(r * r))


# ---- s: the topological sort ------------------------------------------------


def topo_order(n: int, edge_a: np.ndarray, edge_b: np.ndarray,
               prio: np.ndarray) -> np.ndarray:
    """Kahn's sort taking the ready node of least priority first; self
    links ignored, nodes left on cycles after, by priority."""
    ok = (edge_a != edge_b) & (edge_a >= 0) & (edge_b >= 0)
    ea, eb = edge_a[ok], edge_b[ok]
    order = np.argsort(ea, kind="stable")
    succ = eb[order]
    head = np.searchsorted(ea[order], np.arange(n + 1))
    indeg = np.bincount(eb, minlength=n)
    heap = [(int(prio[v]), v) for v in np.flatnonzero(indeg == 0).tolist()]
    heapq.heapify(heap)
    seen = np.zeros(n, bool)
    out = []
    while heap:
        _, v = heapq.heappop(heap)
        if seen[v]:
            continue
        seen[v] = True
        out.append(v)
        for w in succ[head[v]:head[v + 1]].tolist():
            indeg[w] -= 1
            if indeg[w] == 0 and not seen[w]:
                heapq.heappush(heap, (int(prio[w]), w))
    rest = np.flatnonzero(~seen)
    out.extend(rest[np.argsort(prio[rest], kind="stable")].tolist())
    return np.asarray(out, np.int64)


def sorted_rows(g: Graph, x: np.ndarray) -> np.ndarray:
    """Input rows in the order the sorted graph lists its segments, the
    layout having put segment row k at x[k]: g and s over Y's order."""
    y = layout_order(x)
    prio = np.empty(g.n_segs, np.int64)
    prio[y] = np.arange(g.n_segs)
    return topo_order(g.n_segs, g.links[0], g.links[1], prio)


# ---- the checks -------------------------------------------------------------


def compare(inp: Graph, out_text: str, want_rows: np.ndarray) -> dict:
    """segments_misplaced: segments the sorted graph lists elsewhere than
    the reference (and names it maps to two input segments);
    paths_misspelled: paths that do not spell the input's sequence, or are
    missing."""
    out = Graph(out_text)
    n = inp.n_segs
    misplaced = abs(out.n_segs - n)
    same_steps = out.step_row.size == inp.step_row.size
    if same_steps:
        in_of_out = np.full(out.n_segs, -1, np.int64)
        in_of_out[out.step_row] = inp.step_row
        clash = np.zeros(out.n_segs, bool)
        clash[out.step_row] = in_of_out[out.step_row] != inp.step_row
        misplaced += int(clash.sum())
        k = min(n, out.n_segs)
        misplaced += int((in_of_out[:k] != want_rows[:k]).sum())
    else:
        misplaced += n
    out_path = {name: p for p, name in enumerate(out.path_names)}
    misspelled = sum(name not in out_path
                     or out.spell(out_path[name]) != inp.spell(p)
                     for p, name in enumerate(inp.path_names))
    return dict(segments_misplaced=misplaced, paths_misspelled=misspelled)
