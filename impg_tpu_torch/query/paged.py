"""Out-of-core device execution: record pages with LRU eviction.

Counterpart of impg_tpu/query/paged.py, for indexes whose lean arena does
not fit the card or passes 2^31 runs (the resident TorchDeviceIndex refuses
those).  The JAX engine's page plan and LRU are kept; its execution is the
resident engine's kernels:

  * Records (sorted by target) are cut into contiguous PAGES by the JAX
    engine's greedy plan, so the page edges are the same for the same
    budget.  A page is its gathered arena slice (5 arrays, 11 with stats)
    plus page-relative int32 `op_off`; the host gather runs in int64, so the
    global arena may pass 2^31 runs.  Pages are uploaded on first use and
    evicted least recently used, holding `len(pages) * page_bytes_each <=
    budget`.  That is the JAX engine's accounting, kept so that pages and
    evictions match it: `page_bytes_each` is its padded page size, which
    charges 24 B of record columns per record that a page here never
    uploads, while the resident record columns below come on top of the
    budget.
  * The record columns and the prefix max of t_end stay resident (28 B per
    record), so one K-B launch per depth gives every query's window
    over the whole index, and K-A serves `stats -r/-b` over them (with the
    t_end values sorted within each target segment, 4 B per record more,
    uploaded on the first count).
    Windows are split at page edges; per page, K-C `project_lanes` and K-D
    `compact` run over exact lanes with windows relative to the page, and
    the hits' `pair_rec` gets the page's first record added back.  JAX's fixed padded page shape and slot grid exist to
    bound recompiles and have no counterpart here.
  * A depth's hits are emitted in global (query, then record) order: pages
    ascending, then a stable sort on `pair_q`.  A window straddling two
    pages therefore keeps its records ascending across them, and the
    transitive bookkeeping sees the resident engine's order.

Approximate (tracepoint) walks stay on the resident engine, as in JAX: built
with tracepoints, it uploads the record and tracepoint columns and no CIGAR
arena for them, an order of magnitude fewer bytes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from impg_tpu_torch.query.device import (
    LANE_BUDGET,
    DepthFront,
    RESULT_FIELDS,
    STATS_FIELDS,
    TorchDeviceIndex,
    _iters_for,
    compact,
    compute_cummax_te,
    field_mask,
    hits_to_numpy,
    lane_chunks,
    lane_offsets,
    mask_fields,
    project_lanes,
    stab_layout,
    arena_tensors,
)
from impg_tpu_torch.ops.stab_count import stab_counts_segmented
from impg_tpu_torch.ops.xfer import check_device, upload_i32

PAGE_ARRAYS_LEAN = 5  # runs, cum_t, cum_q, irun_before, irun_after
PAGE_ARRAYS_STATS = 11
REC_COLS = 6  # t_start, t_end, strand, query_id, op_off, op_cnt
DEFAULT_BUDGET = 12 << 30  # the JAX engine's default
# Per-record columns a page takes as views of the resident ones.
_PAGE_VIEWS = ("target_id", "t_start", "t_end", "cummax_te", "strand",
               "query_id", "op_cnt")


def plan_pages(op_cnt: np.ndarray, budget: int, with_stats: bool):
    """The JAX engine's page plan (impg_tpu/query/paged.py:152-188):
    (page_edges int64 [n_pages + 1], page_bytes_each).

    A page closes when its run count would pass the per-page capacity
    (a quarter of the budget, the record bytes amortised over the mean
    record); a record larger than that is a page of its own.  Computed by
    jumping from edge to edge with a binary search instead of the JAX
    loop over every record; the edges are the same."""
    bytes_per_run = 4 * (PAGE_ARRAYS_STATS if with_stats else PAGE_ARRAYS_LEAN)
    bytes_per_rec = 4 * REC_COLS
    page_bytes = max(budget // 4, 1 << 14)
    cnt = np.asarray(op_cnt, np.int64)
    n = cnt.size
    run_cum = np.zeros(n + 1, np.int64)
    np.cumsum(cnt, out=run_cum[1:])
    mean_runs = max(float(cnt.mean()) if n else 1.0, 1.0)
    cap_runs = max(
        int(page_bytes // (bytes_per_run + bytes_per_rec / mean_runs)), 256
    )
    edges = [0]
    target = cap_runs
    while True:
        # First record whose end passes the target; it opens the next page
        # unless it already opens this one.
        i = int(np.searchsorted(run_cum[1:], target, side="right"))
        if i == edges[-1]:
            i += 1
        if i >= n:
            break
        edges.append(i)
        target = int(run_cum[i]) + cap_runs
    edges.append(n)
    edges = np.asarray(edges, np.int64)
    p_runs = max(1, int(np.diff(run_cum[edges]).max()))
    p_rec = max(1, int(np.diff(edges).max()))
    return edges, p_runs * bytes_per_run + p_rec * bytes_per_rec


class TorchPagedEngine:
    """TorchDeviceEngine's stream contract for indexes beyond the card.

    `hbm_budget_bytes` caps the resident page bytes as the JAX engine
    counts them (default: its 12 GiB); the resident record columns come on
    top.
    `with_stats` pages the identity-stats arrays too, for
    identity-statistics fields (`--min-identity`)."""

    supports_approximate = False

    def __init__(self, index, device, hbm_budget_bytes: int = DEFAULT_BUDGET,
                 with_stats: bool = False):
        self.device = check_device(device)
        self.index = index
        self.budget = int(hbm_budget_bytes)
        self.with_stats = with_stats
        self.lane_budget = LANE_BUDGET
        r = index.records
        self.page_edges, self.page_bytes_each = plan_pages(
            r.op_cnt, self.budget, with_stats
        )
        self.n_pages = self.page_edges.size - 1
        tree = np.diff(index.tgt_offsets)
        up = lambda a: upload_i32(np.asarray(a), self.device)  # noqa: E731
        # Record columns over the whole index; `op_off` and the arena are
        # per page (`_build_page`).
        self.rindex = TorchDeviceIndex(
            **{k: up(getattr(r, k)) for k in
               ("target_id", "t_start", "t_end", "strand", "query_id",
                "op_cnt")},
            cummax_te=up(compute_cummax_te(r.t_end, index.tgt_offsets)),
            op_off=torch.zeros(0, dtype=torch.int32, device=self.device),
            tgt_offsets=up(index.tgt_offsets),
            arena={},
            n_records=len(r),
            search_iters=_iters_for(int(r.op_cnt.max()) if len(r) else 1),
            window_iters=_iters_for(int(tree.max()) if tree.size else 1),
            device=self.device,
        )
        self.front = DepthFront(self.rindex)
        self._pages: OrderedDict[int, TorchDeviceIndex] = OrderedDict()
        self.uploads = 0
        self.evictions = 0
        self.h2d_bytes = 0  # page bytes uploaded
        self.page_build_s = 0.0  # host gather + upload, summed
        self._stab_layout = None
        self.stab_layout_s = 0.0  # host seconds of the K-A layout build

    # ── paging ──
    def _build_page(self, p: int) -> TorchDeviceIndex:
        t0 = time.perf_counter()
        r = self.index.records
        a = self.index.arena
        lo, hi = int(self.page_edges[p]), int(self.page_edges[p + 1])
        cnt = r.op_cnt[lo:hi].astype(np.int64)
        page_off = np.zeros(cnt.size + 1, np.int64)
        np.cumsum(cnt, out=page_off[1:])
        # The page's arena slice, gathered in int64 (repeat/arange trick).
        gather = (
            np.arange(int(page_off[-1]), dtype=np.int64)
            - np.repeat(page_off[:-1], cnt)
            + np.repeat(r.op_off[lo:hi].astype(np.int64), cnt)
        )
        keys = TorchDeviceIndex.PROJECTION_CORE + (
            TorchDeviceIndex.STATS_KEYS if self.with_stats else ()
        )
        arena = arena_tensors({k: getattr(a, k)[gather] for k in keys}, keys,
                              self.device)
        op_off = upload_i32(page_off[:-1], self.device)
        self.h2d_bytes += sum(t.numel() * 4 for t in (op_off, *arena.values()))
        ri = self.rindex
        page = dataclasses.replace(
            ri, **{k: getattr(ri, k)[lo:hi] for k in _PAGE_VIEWS},
            op_off=op_off, arena=arena, n_records=hi - lo,
        )
        self.page_build_s += time.perf_counter() - t0
        return page

    def _get_page(self, p: int) -> TorchDeviceIndex:
        page = self._pages.get(p)
        if page is not None:
            self._pages.move_to_end(p)
            return page
        while (
            self._pages
            and (len(self._pages) + 1) * self.page_bytes_each > self.budget
        ):
            self._pages.popitem(last=False)
            self.evictions += 1
        page = self._build_page(p)
        self._pages[p] = page
        self.uploads += 1
        return page

    def page_windows(self, win_lo: np.ndarray, k: np.ndarray):
        """Split windows [win_lo, win_lo + k) at page edges.  Yields
        (page, sub_lo, sub_k, sub_q) per page in ascending order: the page's
        pieces in ascending query order, `sub_lo` global, `sub_q` the
        owning query."""
        edges = self.page_edges
        has = np.nonzero(k > 0)[0]
        lo = win_lo[has].astype(np.int64)
        hi = lo + k[has]
        p_lo = np.searchsorted(edges, lo, side="right") - 1
        p_hi = np.searchsorted(edges, hi - 1, side="right") - 1
        n = p_hi - p_lo + 1
        first = np.repeat(np.cumsum(n) - n, n)
        page = np.repeat(p_lo, n) + np.arange(first.size) - first
        sub_q = np.repeat(has, n)
        sub_lo = np.maximum(np.repeat(lo, n), edges[page])
        sub_hi = np.minimum(np.repeat(hi, n), edges[page + 1])
        order = np.argsort(page, kind="stable")
        page, sub_q = page[order], sub_q[order]
        sub_lo, sub_hi = sub_lo[order], sub_hi[order]
        cuts = np.flatnonzero(np.diff(page)) + 1
        for sel in np.split(np.arange(page.size), cuts):
            if sel.size:
                yield (int(page[sel[0]]), sub_lo[sel], sub_hi[sel] - sub_lo[sel],
                       sub_q[sel])

    def page_lanes(self, qs, qe, win_lo, k):
        """The lane work of one depth, page by page in ascending order.

        `qs`, `qe` are the batch's int32 ranges on the device and `win_lo`,
        `k` its windows on the host.  Yields (page, rec_base, sub_q, lane_off,
        lane_off_h, lo_rel, p_qs, p_qe): the page's TorchDeviceIndex, its
        first record, and per window piece its query, int64 lane offsets
        (device and host), page-relative window start and range, ready for
        `project_lanes`."""
        for p, sub_lo, sub_k, sub_q in self.page_windows(win_lo, k):
            page = self._get_page(p)
            rec_base = int(self.page_edges[p])
            sq = upload_i32(sub_q, self.device)
            offs, offs_h = lane_offsets(upload_i32(sub_k, self.device))
            idx = sq.long()
            yield (page, rec_base, sq, offs, offs_h,
                   upload_i32(sub_lo - rec_base, self.device), qs[idx],
                   qe[idx])

    # ── the stream ──
    def query_batch_stream(self, q_tid, q_s, q_e, clip_overlap: bool = False,
                           approximate: bool = False, fields=None):
        """One depth's hits as one dict, in global (query, then record)
        order, with TorchDeviceEngine's fields, `k_needed` and `n_hits`."""
        if approximate:
            raise NotImplementedError(
                "paged engine does not serve approximate mode"
            )
        if (fields is None or set(fields) & set(STATS_FIELDS)) and not (
            self.with_stats
        ):
            raise ValueError(
                "paged engine built without stats arrays; pass "
                "with_stats=True for identity-statistics fields"
            )
        fields = RESULT_FIELDS if fields is None else tuple(fields)
        # pair_q orders the depth's hits, so it is always fetched.
        mask = field_mask(fields + ("pair_q",))
        names = mask_fields(mask)
        q, _, _, _, depth_offs, lo_h = self.front.windows(
            q_tid, q_s, q_e, host_windows=True)
        k_h = np.diff(depth_offs)
        parts = []
        for page, rec_base, sq, offs, offs_h, lo_rel, p_qs, p_qe in (
            self.page_lanes(q[1], q[2], lo_h, k_h)
        ):
            for c0, c1 in lane_chunks(offs_h, self.lane_budget):
                valid, rows = project_lanes(
                    page, offs[c0:c1 + 1], lo_rel[c0:c1], p_qs[c0:c1],
                    p_qe[c0:c1], q_base=c0, lane_base=int(offs_h[c0]),
                    n_lanes=int(offs_h[c1] - offs_h[c0]),
                    clip_overlap=clip_overlap, mask=mask,
                )
                hits = compact(valid, rows)
                row_q = hits[names.index("pair_q")]
                row_q.copy_(sq[row_q.long()])
                if "pair_rec" in names:
                    hits[names.index("pair_rec")] += rec_base
                parts.append(hits)
        if not parts:
            return
        hits = torch.cat(parts, 1)
        order = torch.sort(hits[names.index("pair_q")], stable=True).indices
        out = hits_to_numpy(hits[:, order], mask, fields)
        out["k_needed"] = np.int32(k_h.max())
        yield out

    def stab_layout(self):
        """K-A's segmented layout over the resident record columns, built on
        first use (query/device.py:stab_layout) and kept."""
        if self._stab_layout is None:
            self._stab_layout, self.stab_layout_s = stab_layout(self.index,
                                                                self.rindex)
        return self._stab_layout

    def stab_counts(self, q_tid, q_s, q_e) -> np.ndarray:
        """Per-region overlapping directed-record counts through K-A over
        the resident record columns, as TorchDeviceEngine.stab_counts."""
        qt, qs, qe = (upload_i32(np.asarray(a), self.device)
                      for a in (q_tid, q_s, q_e))
        return stab_counts_segmented(self.stab_layout(), qt, qs,
                                     qe).cpu().numpy()
