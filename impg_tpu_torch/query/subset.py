"""Sequence subset filter (reference: subset_filter.rs).

The port's copy of impg_tpu/query/subset.py
(tests/test_torch_host.py holds the two equal).

Matches a sequence name against a whitelist by exact name, coordinate-stripped
name, PanSN sample, or sample#hap key.
"""

from __future__ import annotations

from typing import Optional


def extract_sample_and_hap(name: str) -> Optional[tuple[str, Optional[str]]]:
    idx = name.find("_hap")
    if idx != -1:
        sample = name[:idx]
        digits = ""
        for ch in name[idx + 4 :]:
            if ch.isdigit():
                digits += ch
            else:
                break
        return sample, (digits or None)
    if "#" in name:
        sample, rest = name.split("#", 1)
        hap_fragment = rest.split("#", 1)[0]
        digits = ""
        for ch in hap_fragment:
            if ch.isdigit():
                digits += ch
            else:
                break
        return sample, (digits or None)
    if ":" not in name and name.strip():
        return name, None
    return None


class SubsetFilter:
    def __init__(self) -> None:
        self.exact: set[str] = set()
        self.normalized: set[str] = set()
        self.sample_ids: set[str] = set()
        self.sample_haps: set[tuple[str, str]] = set()

    @property
    def entry_count(self) -> int:
        return len(self.exact)

    @classmethod
    def parse(cls, contents: str) -> "SubsetFilter":
        f = cls()
        for line in contents.splitlines():
            trimmed = line.strip()
            if not trimmed or trimmed.startswith("#"):
                continue
            f.exact.add(trimmed)
            no_coords = trimmed.split(":", 1)[0]
            f.normalized.add(no_coords)
            parsed = extract_sample_and_hap(no_coords)
            if parsed is not None:
                sample, hap = parsed
                if hap is not None:
                    f.sample_haps.add((sample, hap))
                else:
                    f.sample_ids.add(sample)
        return f

    @classmethod
    def load(cls, path: str) -> "SubsetFilter":
        with open(path) as fh:
            contents = fh.read()
        f = cls.parse(contents)
        if f.entry_count == 0:
            raise ValueError(
                f"Subset sequence list '{path}' did not contain any sequence names"
            )
        return f

    def _matches_sample_keys(self, seq_name: str) -> bool:
        parsed = extract_sample_and_hap(seq_name)
        if parsed is None:
            return False
        sample, hap = parsed
        if hap is not None and (sample, hap) in self.sample_haps:
            return True
        return sample in self.sample_ids

    def matches(self, seq_name: str) -> bool:
        if seq_name in self.exact:
            return True
        no_coords = seq_name.split(":", 1)[0]
        if seq_name != no_coords and no_coords in self.exact:
            return True
        if no_coords in self.normalized:
            return True
        if self._matches_sample_keys(no_coords):
            return True
        return self._matches_sample_keys(seq_name)
