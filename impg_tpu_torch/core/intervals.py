"""Sorted visited-range bookkeeping for transitive walks.

The port's copy of impg_tpu/core/intervals.py
(tests/test_torch_host.py holds the two equal).

Exact-semantics reimplementation of the reference's `SortedRanges`
(impg.rs:242-369): sorted non-overlapping [start, end) ranges with
min-distance snapping to neighbors / sequence bounds on insert, returning the
sub-ranges of the inserted range not already covered.
"""

from __future__ import annotations

from bisect import bisect_left


class SortedRanges:
    __slots__ = ("ranges", "sequence_length", "min_distance")

    def __init__(self, sequence_length: int = 0, min_distance: int = 0) -> None:
        self.ranges: list[tuple[int, int]] = []
        self.sequence_length = sequence_length
        self.min_distance = min_distance

    def __len__(self) -> int:
        return len(self.ranges)

    def clone(self) -> "SortedRanges":
        out = SortedRanges(self.sequence_length, self.min_distance)
        out.ranges = list(self.ranges)
        return out

    def _search_start(self, start: int) -> int:
        return bisect_left(self.ranges, start, key=lambda r: r[0])

    def insert(self, new_range: tuple[int, int]) -> list[tuple[int, int]]:
        start, end = new_range
        if start > end:
            start, end = end, start

        i = self._search_start(start)
        # Snap to previous range / sequence start when within min_distance.
        if i > 0 and abs(start - self.ranges[i - 1][1]) < self.min_distance:
            start = self.ranges[i - 1][1]
            i -= 1
        elif start < self.min_distance:
            start = 0
        # Snap to next range / sequence end.
        if i < len(self.ranges) and abs(self.ranges[i][0] - end) < self.min_distance:
            end = self.ranges[i][0]
        elif end > self.sequence_length - self.min_distance:
            end = self.sequence_length

        # Collect sub-ranges not covered by existing ranges.
        non_overlapping: list[tuple[int, int]] = []
        current = start
        i = self._search_start(start)
        if i > 0 and self.ranges[i - 1][1] > start:
            i -= 1
        while i < len(self.ranges) and current < end:
            r_start, r_end = self.ranges[i]
            if r_start > end:
                break
            if current < r_start:
                non_overlapping.append((current, r_start))
            current = max(current, r_end)
            i += 1
        if current < end:
            non_overlapping.append((current, end))

        # Insert / merge the (snapped) range.
        pos = self._search_start(start)
        if pos > 0 and self.ranges[pos - 1][1] >= start:
            prev = self.ranges[pos - 1]
            self.ranges[pos - 1] = (prev[0], max(prev[1], end))
            self._merge_forward_from(pos - 1)
        elif pos < len(self.ranges) and end >= self.ranges[pos][0]:
            nxt = self.ranges[pos]
            self.ranges[pos] = (min(start, nxt[0]), max(end, nxt[1]))
            self._merge_forward_from(pos)
        else:
            self.ranges.insert(pos, (start, end))

        return non_overlapping

    def _merge_forward_from(self, start_idx: int) -> None:
        write = start_idx
        read = start_idx + 1
        ranges = self.ranges
        while read < len(ranges):
            if ranges[write][1] >= ranges[read][0]:
                ranges[write] = (
                    ranges[write][0],
                    max(ranges[write][1], ranges[read][1]),
                )
            else:
                write += 1
                ranges[write], ranges[read] = ranges[read], ranges[write]
            read += 1
        del ranges[write + 1 :]
