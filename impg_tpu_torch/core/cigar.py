"""CIGAR run codec: packed (op, len) uint32 runs + vectorized text parsing.

The port's copy of impg_tpu/core/cigar.py
(tests/test_torch_host.py holds the two equal).

Encoding matches the capability of the reference codec (impg.rs:75-140): a
3-bit op code in the high bits and a 29-bit length.  Codes:

    0 '='  sequence match        (consumes target + query)
    1 'X'  mismatch              (consumes target + query)
    2 'I'  insertion in query    (consumes query only)
    3 'D'  deletion in query     (consumes target only)
    4 'M'  alignment match       (consumes target + query)

All functions are vectorized over flat numpy arrays so an entire PAF file's
CIGARs decode in one pass (the reference re-reads and re-parses CIGAR bytes
from disk per projection, impg.rs:495-530; here ops are decoded once and kept
resident as tensors).
"""

from __future__ import annotations

import numpy as np

OP_EQ = 0
OP_X = 1
OP_I = 2
OP_D = 3
OP_M = 4

OP_CHARS = np.array([ord("="), ord("X"), ord("I"), ord("D"), ord("M")], dtype=np.uint8)
_CHAR_TO_OP = np.full(256, 255, dtype=np.uint8)
for _code, _ch in enumerate(OP_CHARS):
    _CHAR_TO_OP[_ch] = _code

LEN_MASK = (1 << 29) - 1


def pack(lengths: np.ndarray, ops: np.ndarray) -> np.ndarray:
    """Pack (len, op-code) into uint32 runs."""
    return (ops.astype(np.uint32) << 29) | (lengths.astype(np.uint32) & LEN_MASK)


def run_len(runs: np.ndarray) -> np.ndarray:
    return (runs & LEN_MASK).astype(np.int32)


def run_op(runs: np.ndarray) -> np.ndarray:
    return (runs >> 29).astype(np.uint8)


def consumes_target(ops: np.ndarray) -> np.ndarray:
    """'='|'X'|'D'|'M' advance the target cursor."""
    return ops != OP_I


def consumes_query(ops: np.ndarray) -> np.ndarray:
    """'='|'X'|'I'|'M' advance the query cursor."""
    return ops != OP_D


def parse_concat(buf: np.ndarray, str_offsets: np.ndarray):
    """Parse many concatenated CIGAR strings in one vectorized pass.

    Args:
      buf: uint8 array holding all CIGAR strings back to back.
      str_offsets: int64 array of length n_strings+1 delimiting each string.

    Returns:
      (runs, run_offsets): packed uint32 runs for all strings concatenated,
      and int64 offsets of length n_strings+1 delimiting each string's runs.
    """
    if buf.size == 0:
        n = len(str_offsets) - 1
        return np.empty(0, np.uint32), np.zeros(n + 1, np.int64)

    is_digit = (buf >= ord("0")) & (buf <= ord("9"))
    op_pos = np.nonzero(~is_digit)[0]
    op_codes = _CHAR_TO_OP[buf[op_pos]]
    if np.any(op_codes == 255):
        bad = buf[op_pos[op_codes == 255]][0]
        raise ValueError(f"Invalid CIGAR operation: {chr(bad)!r}")

    # Length of each run: accumulate digits with positional weights.
    digit_pos = np.nonzero(is_digit)[0]
    # Which run does each digit belong to: the next op char at/after it.
    run_of_digit = np.searchsorted(op_pos, digit_pos, side="left")
    place = op_pos[run_of_digit] - 1 - digit_pos  # 0 for last digit
    weights = np.power(10, place.astype(np.int64))
    contrib = (buf[digit_pos].astype(np.int64) - ord("0")) * weights
    # Sum contributions per run (digits of one run are contiguous).
    lengths = np.zeros(op_pos.size, dtype=np.int64)
    np.add.at(lengths, run_of_digit, contrib)  # correct even with empty digit runs

    runs = pack(lengths, op_codes.astype(np.uint32))
    run_offsets = np.searchsorted(op_pos, str_offsets, side="left").astype(np.int64)
    return runs, run_offsets


def format_runs(runs: np.ndarray) -> str:
    """Format packed runs back to CIGAR text (e.g. for PAF cg:Z: output)."""
    if runs.size == 0:
        return ""
    lens = run_len(runs)
    ops = run_op(runs)
    chars = OP_CHARS[ops]
    return "".join(f"{l}{chr(c)}" for l, c in zip(lens.tolist(), chars.tolist()))


def parse_one(text: str) -> np.ndarray:
    """Parse a single CIGAR string to packed runs (convenience/tests)."""
    buf = np.frombuffer(text.encode(), dtype=np.uint8)
    runs, _ = parse_concat(buf, np.array([0, buf.size], dtype=np.int64))
    return runs


def invert_runs(runs: np.ndarray, strand_reverse: bool) -> np.ndarray:
    """Invert runs for the swapped (target<->query) interpretation.

    Swaps I<->D and, on the reverse strand, reverses run order (reference
    semantics: impg.rs:144-162 invert_cigar_ops).
    """
    ops = run_op(runs).copy()
    i_mask = ops == OP_I
    d_mask = ops == OP_D
    ops[i_mask] = OP_D
    ops[d_mask] = OP_I
    out = pack(run_len(runs), ops.astype(np.uint32))
    if strand_reverse:
        out = out[::-1].copy()
    return out
