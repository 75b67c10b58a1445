"""BED / target-range parsing (reference: partition.rs:1719-1790).

The port's copy of impg_tpu/io/bed.py
(tests/test_torch_host.py holds the two equal).
"""

from __future__ import annotations


def parse_range(start_s: str, end_s: str) -> tuple[int, int]:
    try:
        start, end = int(start_s), int(end_s)
    except ValueError as e:
        raise ValueError(f"Invalid range value: {e}") from e
    if start >= end:
        raise ValueError("Start value must be less than end value")
    return start, end


def parse_target_range(target_range: str) -> tuple[str, tuple[int, int], str]:
    """Parse `seq_name:start-end` (name may itself contain ':')."""
    name, sep, rng = target_range.rpartition(":")
    if not sep:
        raise ValueError("Target range format should be `seq_name:start-end`")
    parts = rng.split("-")
    if len(parts) != 2:
        raise ValueError("Range format should be `start-end`")
    start, end = parse_range(parts[0], parts[1])
    return name, (start, end), f"{name}:{start}-{end}"


def parse_bed_file(path: str) -> list[tuple[str, tuple[int, int], str]]:
    ranges = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError("Invalid BED file format")
            start, end = parse_range(parts[1], parts[2])
            name = None
            if len(parts) > 3:
                trimmed = parts[3].strip()
                if trimmed and trimmed != ".":
                    name = trimmed
            if name is None:
                name = f"{parts[0]}:{start}-{end}"
            ranges.append((parts[0], (start, end), name))
    return ranges


def parse_size(text: str) -> int:
    """Parse integer with optional k/m/g suffix (reference: main.rs:39-61)."""
    t = text.strip().lower()
    mult = 1
    if t.endswith("k"):
        mult, t = 1000, t[:-1]
    elif t.endswith("m"):
        mult, t = 1000000, t[:-1]
    elif t.endswith("g"):
        mult, t = 1000000000, t[:-1]
    return int(float(t) * mult) if "." in t else int(t) * mult
