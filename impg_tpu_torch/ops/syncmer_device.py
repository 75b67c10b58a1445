"""Device closed-syncmer extraction and read-to-pack step: K-F and K-G.

Counterpart of impg_tpu/ops/syncmer_jax.py.  Both kernels (csrc/syncmer.cu)
scan one flat uint8 row of 2-bit codes in which sequences or reads follow one
another, each followed by one 255 (the invalid code, `encode_batch`): a
window that crosses a separator holds an invalid k-mer and never selects,
exactly as a JAX window that reaches its batch's 255 padding.
`extract_syncmers_batch` (K-F) returns the selected windows of every sequence
of the row, compacted on the card in (sequence, position) order; `map_pack`
(K-G) adds each selected id's hit in the sorted syncmer universe into int64
counts that stay on the device across read batches, finding it through a
directory of bucket starts (`bucket_directory`).  Each has its plain-torch
twin beside it (`extract_syncmers_batch_plain`, `map_pack_plain`), built on
`syncmer_scan_plain` (the JAX scan's shift/compare/windowed-min formulation
in int64 arithmetic, uint32 values masked to 32 bits) and
`lower_bound_plain`.  A wrapper given CPU tensors runs the twin; given CUDA
tensors it launches the kernel or raises.

uint64 ids travel as int64 tensors of the same bits
(`.numpy().view(np.uint64)` gives them back); the universe is the sorted
uint64 id array so viewed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from impg_tpu_torch import kernels
from impg_tpu_torch.ops import syncmer as sync_np
from impg_tpu_torch.ops.xfer import upload

_M32 = 0xFFFFFFFF
_TILE = 2048  # kTile of csrc/syncmer.cu: window starts a block
_TILE_WORDS = _TILE // 32  # its selection bitmask words
_MAX_SMEM = 48 * 1024  # static launch limit (no opt-in attribute set)
# The universe directory: one bucket for each value of an id's top 16 bits.
BUCKET_SHIFT = 48
N_BUCKETS = 1 << 16
# K-F: the most codes (separators included) one piece holds; a longer
# sequence is a piece of its own.
PIECE_BYTES = 256 << 20
# K-G: a read batch ends at `batch` reads or this many codes, whichever
# comes first.
BATCH_CODE_BYTES = 16 << 20


def scan_smem_bytes(k: int, w: int) -> int:
    """Shared-memory bytes of one K-F/K-G block (csrc/syncmer.cu's
    scan_smem_bytes): the tile's codes plus halo (rounded up to 16-byte
    loads), then per k-mer its hash and its prefix and suffix minima, then
    the invalid-code bitmask words and their prefix counts."""
    n_kmers = _TILE + w
    n_codes = n_kmers + k - 1
    n_words = (n_codes + 31) // 32 + 1
    return ((n_codes + 15) & ~15) + 4 * (3 * n_kmers + 2 * n_words)


# ---- plain twins (int64 tensors carrying uint32 values) --------------------


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x, seed: int):
    x = x ^ ((seed * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _revcomp(code, k: int):
    out = torch.zeros_like(code)
    for _ in range(k):
        out = (out << 2) | ((code ^ 3) & 3)
        code = code >> 2
    return out


def _to_i32_bits(x):
    """int64 values in [0, 2^32) as int32 tensors of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u64_bits(hi, lo):
    """int64 bit views of the uint64 values (hi << 32) | lo, for int64 hi
    and lo in [0, 2^32) (no intermediate leaves int64)."""
    return torch.where(hi >= 2**31, hi - 2**32, hi) * (1 << 32) + lo


def _window_valid(valid, w1: int):
    """[B, m] bool -> [B, m - w1 + 1]: every value of the window is set."""
    cnt = torch.zeros(valid.shape[0], valid.shape[1] + 1, dtype=torch.int64,
                      device=valid.device)
    cnt[:, 1:] = torch.cumsum(valid.to(torch.int64), dim=1)
    return (cnt[:, w1:] - cnt[:, : cnt.shape[1] - w1]) == w1


def _sliding_min(values, w1: int):
    span = 1
    m = values
    while span * 2 <= w1:
        m = torch.minimum(m[:, :-span], m[:, span:])
        span *= 2
    if span == w1:
        return m
    rem = w1 - span
    return torch.minimum(m[:, : m.shape[1] - rem], m[:, rem:])


def _scan_int64(codes, k: int, w: int, seed: int):
    """The JAX scan (syncmer_jax.syncmer_scan) in int64: (sel, id_hi, id_lo,
    fwd), ids as int64 values in [0, 2^32)."""
    m = codes.shape[1] - k + 1
    invalid = codes == 255
    kvalid = _window_valid(~invalid, k)
    out = torch.where(invalid, 0, codes.to(torch.int64))
    span = 1
    while span * 2 <= k:
        out = (out[:, : out.shape[1] - span] << (2 * span)) | out[:, span:]
        span *= 2
    if span != k:
        rem = k - span
        out = (out[:, : out.shape[1] - rem] << (2 * rem)) | (
            out[:, rem:] & ((1 << (2 * rem)) - 1)
        )
    kcodes = out[:, :m]
    rc_k = _revcomp(kcodes, k)
    hashes = torch.where(kvalid, _mix32(torch.minimum(kcodes, rc_k), seed),
                         _M32)
    w1 = w + 1
    mins = _sliding_min(hashes, w1)
    m2 = mins.shape[1]
    sel = (hashes[:, :m2] == mins) | (hashes[:, w1 - 1:] == mins)
    sel &= _window_valid(kvalid, w1)
    fh_hi = _mix32(kcodes[:, :m2], seed)
    fh_lo = _mix32(kcodes[:, w: w + m2], seed + 1)
    rh_hi = _mix32(rc_k[:, w: w + m2], seed)  # RC(last k-mer)
    rh_lo = _mix32(rc_k[:, :m2], seed + 1)    # RC(first k-mer)
    fwd = (fh_hi < rh_hi) | ((fh_hi == rh_hi) & (fh_lo <= rh_lo))
    return (sel, torch.where(fwd, fh_hi, rh_hi),
            torch.where(fwd, fh_lo, rh_lo), fwd)


def syncmer_scan_plain(codes, k: int, w: int, seed: int):
    """The dense scan of 255-padded rows `codes` [B, L], as JAX's
    syncmer_scan: (sel, id_hi, id_lo, fwd), each [B, L - k - w + 1] (no
    columns when L < k + w), the id halves as int32 tensors of the uint32
    bits."""
    if codes.shape[1] < k + w:
        b = codes.shape[0]
        empty = torch.zeros((b, 0), dtype=torch.bool, device=codes.device)
        ids = torch.zeros((b, 0), dtype=torch.int32, device=codes.device)
        return empty, ids, ids.clone(), empty.clone()
    sel, hi, lo, fwd = _scan_int64(codes, k, w, seed)
    return sel, _to_i32_bits(hi), _to_i32_bits(lo), fwd


@dataclass
class Syncmers:
    """K-F's result in one byte buffer, so that one copy brings it to the
    host: pos int64 [n] (within its sequence), ids int64 [n] (uint64 bit
    views), first int64 [n_seqs + 1] (the index of each sequence's first
    syncmer, then n) and fwd bool [n], in (sequence, position) order."""

    buffer: torch.Tensor
    n: int
    n_seqs: int

    @staticmethod
    def empty(n: int, n_seqs: int, device) -> "Syncmers":
        nbytes = 17 * n + 8 * (n_seqs + 1)
        return Syncmers(torch.empty(nbytes, dtype=torch.uint8, device=device),
                        n, n_seqs)

    def _at(self, offset: int, count: int, dtype) -> torch.Tensor:
        size = torch.empty((), dtype=dtype).element_size()
        return self.buffer[offset: offset + count * size].view(dtype)

    @property
    def pos(self) -> torch.Tensor:
        return self._at(0, self.n, torch.int64)

    @property
    def ids(self) -> torch.Tensor:
        return self._at(8 * self.n, self.n, torch.int64)

    @property
    def first(self) -> torch.Tensor:
        return self._at(16 * self.n, self.n_seqs + 1, torch.int64)

    @property
    def fwd(self) -> torch.Tensor:
        return self._at(16 * self.n + 8 * (self.n_seqs + 1), self.n,
                        torch.bool)

    @property
    def counts(self) -> torch.Tensor:
        return self.first[1:] - self.first[:-1]

    def cpu(self) -> "Syncmers":
        return Syncmers(self.buffer.cpu(), self.n, self.n_seqs)


def extract_syncmers_batch_plain(codes, starts, k: int, w: int,
                                 seed: int) -> Syncmers:
    """Plain twin of K-F: `syncmer_scan_plain` over each sequence of the
    flat row (its codes [starts[s], starts[s + 1] - 1), without the
    separator), then `torch.nonzero`."""
    bounds = starts.tolist()
    parts = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        sel, hi, lo, fwd = syncmer_scan_plain(codes[None, a: b - 1], k, w,
                                              seed)
        at = torch.nonzero(sel[0]).reshape(-1)
        parts.append((at, _u64_bits(hi[0, at].to(torch.int64) & _M32,
                                    lo[0, at].to(torch.int64) & _M32),
                      fwd[0, at]))
    n_seqs = len(parts)
    sizes = torch.tensor([p[0].numel() for p in parts], dtype=torch.int64)
    out = Syncmers.empty(int(sizes.sum()), n_seqs, codes.device)
    out.first.copy_(torch.cat([torch.zeros(1, dtype=torch.int64),
                               torch.cumsum(sizes, 0)]))
    if out.n:
        out.pos.copy_(torch.cat([p[0] for p in parts]))
        out.ids.copy_(torch.cat([p[1] for p in parts]))
        out.fwd.copy_(torch.cat([p[2] for p in parts]))
    return out


def bucket_directory(universe: np.ndarray) -> np.ndarray:
    """int32 [N_BUCKETS + 1]: the index in the sorted uint64 `universe` of
    its first id whose top 16 bits (unsigned) are at least b, for each b;
    the last entry is the universe's size."""
    if universe.size >= 2**31:
        raise ValueError(f"{universe.size} ids: the directory holds int32 "
                         "indices (fewer than 2^31 ids)")
    top = (universe.astype(np.uint64) >> np.uint64(BUCKET_SHIFT)).astype(
        np.int64)
    return np.searchsorted(top, np.arange(N_BUCKETS + 1)).astype(np.int32)


def lower_bound_plain(universe, directory, ids):
    """np.searchsorted(universe, ids) of uint64 values carried as int64 bit
    views, through the directory: the bucket of each id's top 16 bits, then
    a bisection inside it.  Within a bucket every value has the id's top 16
    bits, so the same sign as an int64, and int64 order is uint64 order."""
    top = (ids >> BUCKET_SHIFT) & (N_BUCKETS - 1)
    d = directory.to(torch.int64)
    lo, hi = d[top], d[top + 1]
    while True:
        live = lo < hi
        if not bool(live.any()):
            return lo
        mid = (lo + hi) >> 1
        less = universe[torch.where(live, mid, 0)] < ids
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)


def map_pack_plain(codes, universe, directory, counts, n_matched, k: int,
                   w: int, seed: int) -> None:
    """Plain twin of K-G over the flat row `codes` [N] as it is: adds the
    hits into `counts` (int64 [U]) and their total into `n_matched` (int64
    [1]), in place."""
    u = universe.shape[0]
    if u == 0 or codes.shape[0] < k + w:
        return
    sel, hi, lo, _fwd = _scan_int64(codes[None], k, w, seed)
    ids = _u64_bits(hi[sel], lo[sel])
    pos = lower_bound_plain(universe, directory, ids)
    probe = torch.clamp(pos, max=u - 1)
    hit = (pos < u) & (universe[probe] == ids)
    counts += torch.bincount(probe[hit], minlength=u)
    n_matched += hit.sum()


# ---- kernel wrappers -------------------------------------------------------


def _check_row(codes, k: int, w: int) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError("codes: expected a contiguous 1-D uint8 tensor")
    if not 1 <= k <= 16:
        raise ValueError(f"k={k}: the scan packs k-mers into 32 bits (k <= 16)")
    if w < 0:
        raise ValueError(f"w={w}: expected w >= 0")


def _check_int_vector(name: str, t, dtype, n: int) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor")
    if t.shape[0] != n:
        raise ValueError(f"{name}: expected length {n}, got {t.shape[0]}")


def _check_devices(name: str, *tensors) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def _check_launch(codes, k: int, w: int) -> None:
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    if scan_smem_bytes(k, w) > _MAX_SMEM:
        raise ValueError(f"w={w}: the scan's tile needs more than 48 KB of "
                         "shared memory")


def extract_syncmers_batch(codes, starts, k: int, w: int,
                           seed: int) -> Syncmers:
    """Closed syncmers of the sequences in the flat row `codes` [N]
    (`encode_batch`'s layout: sequence s at [starts[s], starts[s + 1] - 1),
    then one 255), `starts` int64 [n_seqs + 1] with starts[0] = 0 and
    starts[-1] = N.  CPU tensors take the plain twin; CUDA tensors launch
    K-F (or raise): its scan pass, the host's read of the total, and its
    write pass into an output of exactly that size (two launches counted
    under `syncmer_scan`, one for each entry point)."""
    _check_row(codes, k, w)
    if starts.dtype != torch.int64 or starts.dim() != 1 or starts.numel() < 1:
        raise ValueError("starts: expected a 1-D int64 tensor")
    _check_devices("extract_syncmers_batch", codes, starts)
    if codes.device.type == "cpu":
        return extract_syncmers_batch_plain(codes, starts, k, w, seed)
    _check_launch(codes, k, w)
    starts = starts.contiguous()
    n_seqs = starts.numel() - 1
    if codes.numel() < k + w or n_seqs == 0:
        out = Syncmers.empty(0, n_seqs, codes.device)
        out.first.zero_()
        return out
    masks, offsets = syncmer_scan_launch(codes, k, w, seed)
    out = Syncmers.empty(int(offsets[-1]), n_seqs, codes.device)
    syncmer_write_launch(codes, starts, k, w, seed, masks, offsets, out)
    return out


def syncmer_scan_launch(codes, k: int, w: int, seed: int) -> tuple:
    """K-F's scan pass over a CUDA row of at least k + w codes (the scan and
    the tile-count scan, one entry point): (masks int32 [n_tiles * 64], the tiles'
    selection bits; offsets int64 [n_tiles + 1], the exclusive scan of
    their counts, offsets[-1] the total)."""
    n_tiles = -(-(codes.numel() - k - w + 1) // _TILE)
    masks = torch.empty(n_tiles * _TILE_WORDS, dtype=torch.int32,
                        device=codes.device)
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=codes.device)
    offsets = torch.empty(n_tiles + 1, dtype=torch.int64, device=codes.device)
    kernels.launch(
        "syncmer_scan", "impg_syncmer_scan",
        codes.data_ptr(), codes.numel(), k, w, seed & _M32, masks.data_ptr(),
        tile_counts.data_ptr(), offsets.data_ptr(), kernels.stream_of(codes),
    )
    return masks, offsets


def syncmer_write_launch(codes, starts, k: int, w: int, seed: int, masks,
                         offsets, out: Syncmers) -> None:
    """K-F's write pass after `syncmer_scan_launch` on the same row, into
    `out` (out.n = offsets[-1]), with no wait for the card."""
    kernels.launch(
        "syncmer_scan", "impg_syncmer_write",
        codes.data_ptr(), codes.numel(), k, w, seed & _M32, masks.data_ptr(),
        offsets.data_ptr(), starts.data_ptr(), out.n_seqs, out.pos.data_ptr(),
        out.ids.data_ptr(), out.fwd.data_ptr(), out.first.data_ptr(),
        kernels.stream_of(codes),
    )


def map_pack(codes, universe, directory, counts, n_matched, k: int, w: int,
             seed: int) -> None:
    """Adds the hits of the flat row's selected syncmers in `universe` (the
    sorted uint64 ids as an int64 view, [U]; `directory` its
    `bucket_directory`, int32) into `counts` (int64 [U]) and their total
    into `n_matched` (int64 [1]), in place.  CPU tensors take the plain
    twin; CUDA tensors launch K-G (or raise)."""
    _check_row(codes, k, w)
    u = universe.shape[0]
    _check_int_vector("universe", universe, torch.int64, u)
    _check_int_vector("directory", directory, torch.int32, N_BUCKETS + 1)
    _check_int_vector("counts", counts, torch.int64, u)
    _check_int_vector("n_matched", n_matched, torch.int64, 1)
    _check_devices("map_pack", codes, universe, directory, counts, n_matched)
    if codes.device.type == "cpu":
        map_pack_plain(codes, universe, directory, counts, n_matched, k, w,
                       seed)
        return
    _check_launch(codes, k, w)
    kernels.launch(
        "map_pack", "impg_map_pack",
        codes.data_ptr(), codes.numel(), k, w, seed & _M32,
        universe.data_ptr(), u, directory.data_ptr(), counts.data_ptr(),
        n_matched.data_ptr(), kernels.stream_of(codes),
    )


# ---- host wrappers ---------------------------------------------------------


def encode_batch(seqs: list) -> np.ndarray:
    """Sequences -> one flat uint8 row of 2-bit codes, each sequence followed
    by one 255 (non-ACGT bases are 255 too)."""
    return sync_np.encode_bases(b"N".join(seqs) + b"N")


def _pieces(lens: list, budget: int) -> list:
    """[a, b) runs of sequences whose codes and separators fit `budget`
    bytes; a sequence longer than that is a run of its own."""
    out, a, size = [], 0, 0
    for i, n in enumerate(lens):
        if i > a and size + n + 1 > budget:
            out.append((a, i))
            a, size = i, 0
        size += n + 1
    if a < len(lens):
        out.append((a, len(lens)))
    return out


def extract_syncmers_batch_device(
    seqs: list,
    k: int = sync_np.DEFAULT_K,
    w: int = sync_np.DEFAULT_W,
    seed: int = sync_np.DEFAULT_SEED,
    device="cuda:0",
):
    """io/native.extract_syncmers_batch_native's result, (pos int64, ids
    uint64, fwd bool, per-sequence counts int64) concatenated in input
    order, through K-F on `device`: one scan launch, one write launch and
    one copy back for each piece of at most PIECE_BYTES codes."""
    dev = torch.device(device)
    lens = [len(s) for s in seqs]
    parts = []
    for a, b in _pieces(lens, PIECE_BYTES):
        starts = np.zeros(b - a + 1, np.int64)
        np.cumsum(np.asarray(lens[a:b], np.int64) + 1, out=starts[1:])
        found = extract_syncmers_batch(
            upload(encode_batch(seqs[a:b]), dev), upload(starts, dev), k, w,
            seed).cpu()
        parts.append((found.pos.numpy(), found.ids.numpy().view(np.uint64),
                      found.fwd.numpy(), found.counts.numpy()))
    if not parts:
        return (np.zeros(0, np.int64), np.zeros(0, np.uint64),
                np.zeros(0, bool), np.zeros(0, np.int64))
    return tuple(np.concatenate(col) for col in zip(*parts))


def extract_syncmers_device(
    seq: bytes,
    k: int = sync_np.DEFAULT_K,
    w: int = sync_np.DEFAULT_W,
    seed: int = sync_np.DEFAULT_SEED,
    device="cuda:0",
):
    """One sequence's (positions int64, ids uint64, fwd bool) through K-F on
    `device`, with ops/syncmer.extract_syncmers_numpy's result."""
    pos, ids, fwd, _ = extract_syncmers_batch_device([seq], k, w, seed,
                                                     device)
    return pos, ids, fwd


def device_universe(index, device) -> tuple:
    """The index's universe (int64 bit views) and its bucket directory on
    `device`, built and uploaded once per index and device and cached on the
    index beside syng/pack.universe_from_index's `_universe_cache`."""
    from impg_tpu_torch.syng.pack import universe_from_index

    dev = torch.device(device)
    cache = getattr(index, "_device_universe_cache", None)
    if cache is None:
        cache = index._device_universe_cache = {}
    if dev not in cache:
        universe = universe_from_index(index)
        cache[dev] = (upload(universe.view(np.int64), dev),
                      upload(bucket_directory(universe), dev))
    return cache[dev]


def map_reads_batched(index, read_files: list[str], batch: int = 65536,
                      device="cuda:0"):
    """Device map_reads: syng/pack.map_reads's contract (pack over the index
    universe, n_reads, n_matched), computed by K-G on `device`, one launch a
    flat batch of at most `batch` reads and BATCH_CODE_BYTES codes (a longer
    read is a batch of its own).  The counts stay on the device across
    batches and come to the host once at the end; each batch goes up by
    `upload`, whose pinned buffers PyTorch's host allocator reuses once
    their copies are done.  Equal to the host path."""
    from impg_tpu_torch.syng.pack import Pack, read_sequences, universe_from_index

    dev = torch.device(device)
    universe = universe_from_index(index)
    n_reads = 0
    if universe.size == 0:
        for path in read_files:
            for _ in read_sequences(path):
                n_reads += 1
        return Pack(feature_ids=universe, counts=np.zeros(0, np.int64)), \
            n_reads, 0
    d_uni, d_dir = device_universe(index, dev)
    counts = torch.zeros(universe.size, dtype=torch.int64, device=dev)
    matched = torch.zeros(1, dtype=torch.int64, device=dev)

    def flush(reads: list) -> None:
        map_pack(upload(encode_batch(reads), dev), d_uni, d_dir, counts,
                 matched, index.k, index.w, index.seed)

    pending: list[bytes] = []
    n_bytes = 0
    for path in read_files:
        for _name, seq in read_sequences(path):
            n_reads += 1
            if pending and (len(pending) == batch
                            or n_bytes + len(seq) + 1 > BATCH_CODE_BYTES):
                flush(pending)
                pending, n_bytes = [], 0
            pending.append(seq)
            n_bytes += len(seq) + 1
    if pending:
        flush(pending)
    return (Pack(feature_ids=universe, counts=counts.cpu().numpy()), n_reads,
            int(matched.item()))
