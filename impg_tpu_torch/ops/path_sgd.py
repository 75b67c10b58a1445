"""Annealed path-SGD layout epochs: the K-I kernel's wrappers and plain twin.

Counterpart of impg_tpu/graph/sortgfa.py:_sgd_epochs_jax (K12), the 1D
path-guided layout of `sort`'s 'Y' step.  Per epoch, `batch` step pairs are
sampled within paths (a uniform step i; a partner at a log-uniform distance
in steps, either side, clipped to i's path); each pair pulls its two nodes
toward their bp distance along the path with the annealed rate
mu = min(eta / d^2, 1); the pulls are averaged per node (Jacobi: every pull
of an epoch reads the epoch's starting positions) and applied at once.

Random numbers: a counter-based Philox4x32-10, keyed by (SEED, epoch), with
the sample index as the counter.  Its four words map to a pair as

    i    = (u0 * n_steps) >> 32
    t    = ((u1 << 21) | (u3 >> 11)) * 2^-53        (float64, in [0, 1))
    off  = ceil(exp(t * log(n_steps)))             (float64)
    sign = +1 if u2 >= 2^31 else -1
    j    = clip(i + sign * off, pstart[i], pend[i] - 1)

and a pair with i == j does nothing (JAX's `valid` weight of 0).  The
offset is float64 so that the kernel's `exp` and the twin's cannot round an
offset across an integer in float32.  The stream is the port's own: JAX's
threefry bits are not reproduced (the layout is a stochastic heuristic; its
contract is layout quality and spellings, as for impg_tpu's two backends).

Layout on the card: the step columns interleaved as int32 [n_steps, 4]
(node, float32 position bits, path start, path end), one 16-byte row per
step; positions x float32 [n_segs]; the sums of the moves int64 [n_segs]
(fixed point) and their counts int32 [n_segs].

  * `sgd_epochs` runs the whole annealed loop: on a CUDA device one K-I
    launch per epoch (`impg_path_sgd_epoch`: draws, pulls, integer atomics
    into the sums and counts) and one small apply launch
    (`impg_path_sgd_apply`: x -= sum 2^-frac_bits / max(count, 1), sums
    and counts zeroed), both counted under `path_sgd`; on the CPU the plain
    twin.  Its stages are spans (tracing.py): layout.pack (the host
    columns and their checks), layout.upload, layout.epochs (the launches'
    enqueue) and layout.readback (the host's wait on K-I, then the copy
    back).
  * The twin is kept in parts: `draw_pairs` (the Philox draws and the pair
    mapping, in int64 arithmetic), `pulls` (the move of each pair), and its
    accumulation, `pull_fixed` + `apply_fixed` as the kernel sums, so a test
    can inject other draws; `pull_plain` + `apply_plain` sum the same moves
    in floating point, as impg_tpu's numpy and JAX loops do.

Arithmetic: each move is float32 as in JAX; the kernel computes it with
round-to-nearest intrinsics in the twin's order of operations (no
contraction).  Moves are then summed in fixed point (`fixed_point`): the
int64 round(dx 2^frac_bits), clipped to +-q_max, so the sums are exact and
their order does not matter; frac_bits (2^-14 bp for the smoke's 1 Mb
graph) keeps the quantum far below a float32 position's spacing.  Float
atomics into device memory bound the first design (csrc/path_sgd.cu).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from impg_tpu_torch import kernels, tracing
from impg_tpu_torch.ops.xfer import check_device, upload

SEED = 42  # impg_tpu's jrandom.PRNGKey(42) for the device loop
_M32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Random123).
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10
# Samples per chunk of the twin's draws (bounds its int64 temporaries).
_DRAW_CHUNK = 1 << 24


# ---- plain twin: draws -------------------------------------------------------


def _mulhilo(x, m: int):
    """(hi, lo) 32-bit halves of x * m for x an int64 tensor of values in
    [0, 2^32) and m < 2^32, with m split in 16-bit halves so that no
    product leaves int64."""
    a = x * (m & 0xFFFF)          # < 2^48
    b = x * (m >> 16)             # < 2^48
    hi = (b + (a >> 16)) >> 16
    lo = (a + ((b & 0xFFFF) << 16)) & _M32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int,
               rounds: int = PHILOX_ROUNDS):
    """Philox4x32 of counters (c0..c3, int64 tensors of uint32 values) under
    key (k0, k1): the four output words, int64 tensors of uint32 values."""
    k0, k1 = k0 & _M32, k1 & _M32
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def pairs_from_words(u0, u1, u2, u3, pstart, pend, log_n: float):
    """(i, j) int64 of the draw mapping (module docstring) from Philox words;
    `pstart`/`pend` are the steps' path bounds (int64 [n_steps])."""
    n_steps = pstart.shape[0]
    i = (u0 * n_steps) >> 32
    t = ((u1 << 21) | (u3 >> 11)).to(torch.float64) * 2.0 ** -53
    off = torch.ceil(torch.exp(t * log_n)).to(torch.int64)
    j = i + torch.where(u2 >= 2**31, off, -off)
    j = torch.minimum(torch.maximum(j, pstart[i]), pend[i] - 1)
    return i, j


def draw_pairs(pstart, pend, epoch: int, first: int, count: int,
               log_n: float):
    """Samples first .. first + count - 1 of `epoch`: (i, j) int64 on
    pstart's device."""
    idx = torch.arange(first, first + count, dtype=torch.int64,
                       device=pstart.device)
    zero = torch.zeros_like(idx)
    u = philox4x32(idx & _M32, idx >> 32, zero, zero, SEED, epoch)
    return pairs_from_words(*u, pstart, pend, log_n)


# ---- plain twin: update ------------------------------------------------------


def pulls(x, node, pos, i, j, eta: float):
    """The pulls of the pairs (i, j) with i != j: (a, b, dx), node a moving
    by +dx and node b by -dx, dx = mu * r * (x[a] - x[b]), in x's dtype."""
    keep = i != j
    i, j = i[keep], j[keep]
    a, b = node[i], node[j]
    d = torch.clamp_min((pos[i] - pos[j]).abs(), 1e-9)
    w = torch.ones_like(d) / (d * d)
    mu = torch.clamp_max(eta * w, 1.0)
    diff = x[a] - x[b]
    mag = diff.abs()
    big = mag > 1e-9
    cur = torch.where(big, mag, torch.full_like(mag, 1e-9))
    r = (cur - d) / (2.0 * cur) * big.to(x.dtype)
    return a, b, mu * r * diff


def pull_plain(x, node, pos, i, j, eta: float, acc, cnt) -> None:
    """Adds the pulls of the pairs (i, j) into acc and their counts into cnt
    in x's dtype (in place), as impg_tpu's numpy and JAX loops add them."""
    a, b, dx = pulls(x, node, pos, i, j, eta)
    acc.index_add_(0, a, dx)
    acc.index_add_(0, b, -dx)
    ones = torch.ones_like(dx)
    cnt.index_add_(0, a, ones)
    cnt.index_add_(0, b, ones)


def apply_plain(x, acc, cnt) -> None:
    """x -= acc / max(cnt, 1); acc = cnt = 0 (in place)."""
    x -= acc / torch.clamp_min(cnt, 1.0)
    acc.zero_()
    cnt.zero_()


def fixed_point(batch: int, bound: float) -> tuple:
    """K-I's fixed point for an epoch of `batch` samples whose moves stay
    within `bound` bp: (frac_bits, q_max).  A move dx is added as the int64
    round(dx * 2^frac_bits) clipped to +-q_max; no segment can take more
    than 2 * batch of them, so q_max = 2^62 // (2 * batch) keeps every sum
    inside int64, and frac_bits is the largest in 0..30 with
    bound * 2^frac_bits <= q_max."""
    q_max = 2**62 // max(2 * batch, 1)
    frac_bits = 0
    while frac_bits < 30 and max(bound, 1.0) * 2.0 ** (frac_bits + 1) <= q_max:
        frac_bits += 1
    return frac_bits, q_max


def quantize(dx, frac_bits: int, q_max: int):
    """dx (float32) as K-I adds it: round(dx * 2^frac_bits), ties to even,
    clipped to +-q_max, int64."""
    t = torch.clamp(dx * 2.0 ** frac_bits, -2.0 ** 62, 2.0 ** 62)
    return torch.clamp(torch.round(t).to(torch.int64), -q_max, q_max)


def pull_fixed(x, node, pos, i, j, eta: float, frac_bits: int, q_max: int,
               acc, cnt) -> None:
    """K-I's accumulation of the pulls of (i, j): each quantized move into
    acc (int64) and each count into cnt (int32), in place.  Integer sums do
    not depend on their order."""
    a, b, dx = pulls(x, node, pos, i, j, eta)
    q = quantize(dx, frac_bits, q_max)
    acc.index_add_(0, a, q)
    acc.index_add_(0, b, -q)
    ones = torch.ones_like(a, dtype=cnt.dtype)
    cnt.index_add_(0, a, ones)
    cnt.index_add_(0, b, ones)


def apply_fixed(x, acc, cnt, frac_bits: int) -> None:
    """x -= (acc * 2^-frac_bits) / max(cnt, 1) in float32; acc = cnt = 0 (in
    place)."""
    x -= (acc.to(x.dtype) * 2.0 ** -frac_bits) / torch.clamp_min(
        cnt.to(x.dtype), 1.0)
    acc.zero_()
    cnt.zero_()


def epoch_plain(x, steps, epoch: int, batch: int, eta: float, log_n: float,
                frac_bits: int, q_max: int, acc=None, cnt=None) -> None:
    """One epoch of the twin on `steps` (sgd_steps' [n_steps, 4] int32)
    in float32, updating x in place; acc (int64 [n]) and cnt (int32 [n]),
    zero, hold the fixed-point sums and the counts, and are left zero."""
    node = steps[:, 0].to(torch.int64)
    pos = steps[:, 1].view(torch.float32)
    pstart = steps[:, 2].to(torch.int64)
    pend = steps[:, 3].to(torch.int64)
    acc = x.new_zeros(x.shape, dtype=torch.int64) if acc is None else acc
    cnt = x.new_zeros(x.shape, dtype=torch.int32) if cnt is None else cnt
    for first in range(0, batch, _DRAW_CHUNK):
        i, j = draw_pairs(pstart, pend, epoch, first,
                          min(_DRAW_CHUNK, batch - first), log_n)
        pull_fixed(x, node, pos, i, j, eta, frac_bits, q_max, acc, cnt)
    apply_fixed(x, acc, cnt, frac_bits)


# ---- kernel wrappers ---------------------------------------------------------


def step_columns(step_node, step_pos, pstart, pend, n: int) -> np.ndarray:
    """The step columns interleaved as int32 [n_steps, 4] on the host: node,
    float32 position bits, path start, path end.  Raises unless every node
    lies in [0, n) and every step's path bounds hold it."""
    step_node = np.asarray(step_node)
    n_steps = step_node.size
    if n_steps >= 2**31:
        raise ValueError(f"{n_steps} steps: the layout indexes steps in int32")
    if n_steps and (int(step_node.min()) < 0 or int(step_node.max()) >= n):
        raise ValueError(f"step nodes must lie in [0, {n}) (normalise "
                         "negative ids before the call)")
    at = np.arange(n_steps)
    pstart = np.asarray(pstart)
    pend = np.asarray(pend)
    if n_steps and not ((pstart <= at) & (at < pend)).all():
        raise ValueError("every step must lie inside its path bounds")
    cols = np.empty((n_steps, 4), np.int32)
    cols[:, 0] = step_node
    cols[:, 1] = np.asarray(step_pos, np.float32).view(np.int32)
    cols[:, 2] = pstart
    cols[:, 3] = pend
    return cols


def sgd_steps(step_node, step_pos, pstart, pend, n: int, device) -> torch.Tensor:
    """`step_columns` uploaded to `device`."""
    return upload(step_columns(step_node, step_pos, pstart, pend, n), device)


def _check_state(x, steps) -> None:
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x: expected a contiguous 1-D float32 tensor")
    if steps.dtype != torch.int32 or steps.dim() != 2 \
            or steps.shape[1] != 4 or not steps.is_contiguous():
        raise ValueError("steps: expected a contiguous int32 [n_steps, 4]")
    if x.device != steps.device:
        raise ValueError(f"x on {x.device}, steps on {steps.device}")


def move_bound(x0, step_pos) -> float:
    """The bound on a move that `fixed_point` is sized for: the wider of the
    start positions' and the step positions' ranges (a move is at most half
    of the larger of a pair's gap and its bp distance)."""
    widths = [float(np.ptp(v)) for v in (x0, step_pos) if np.size(v)]
    return max(widths, default=1.0)


def sgd_epoch(x, steps, acc, cnt, epoch: int, batch: int, eta: float,
              log_n: float, frac_bits: int, q_max: int, pairs=None) -> None:
    """One epoch in place on x (float32 [n]) through K-I: the pull launch,
    then the apply launch, with `fixed_point`'s (frac_bits, q_max); acc
    (int64 [n]) and cnt (int32 [n]) must be zero and are left zero.  With
    `pairs` (int32 [batch, 2] on the card) the pull also writes each
    sample's (i, j) there.  CPU tensors take the plain twin (no `pairs`);
    CUDA tensors launch the kernels or raise."""
    _check_state(x, steps)
    for name, t, dtype in (("acc", acc, torch.int64),
                           ("cnt", cnt, torch.int32)):
        if t.dtype != dtype or t.shape != x.shape or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             "shaped like x")
    if not 0 <= frac_bits <= 30 or not 0 < q_max <= 2**62:
        raise ValueError(f"fixed point ({frac_bits}, {q_max}) out of range")
    if x.device.type == "cpu":
        if pairs is not None:
            raise ValueError("pairs: only the kernel writes its draws")
        epoch_plain(x, steps, epoch, batch, eta, log_n, frac_bits, q_max,
                    acc, cnt)
        return
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if pairs is not None and (pairs.dtype != torch.int32
                              or pairs.shape != (batch, 2)
                              or not pairs.is_contiguous()
                              or pairs.device != x.device):
        raise ValueError("pairs: expected a contiguous int32 [batch, 2] "
                         "beside x")
    stream = kernels.stream_of(x)
    kernels.launch(
        "path_sgd", "impg_path_sgd_epoch",
        steps.data_ptr(), steps.shape[0], x.data_ptr(), acc.data_ptr(),
        cnt.data_ptr(), batch, float(eta), float(log_n), SEED,
        epoch & _M32, frac_bits, q_max,
        0 if pairs is None else pairs.data_ptr(), stream,
    )
    kernels.launch(
        "path_sgd", "impg_path_sgd_apply",
        x.data_ptr(), acc.data_ptr(), cnt.data_ptr(), x.shape[0], frac_bits,
        stream,
    )


def epoch_eta(eta_max: float, lam: float, t: int) -> float:
    """eta of epoch t as impg_tpu's device loop computes it, in float32:
    eta_max * exp(-lam * t)."""
    e = np.float32(eta_max) * np.exp(np.float32(-lam) * np.float32(t))
    return float(np.float32(e))


def sgd_epochs(x0, step_node, step_pos, pstart, pend, epochs: int,
               batch: int, eta_max: float, lam: float,
               device="cuda:0") -> np.ndarray:
    """The annealed loop of `_sgd_epochs_jax`, with its arguments: initial
    positions x0 [n], the steps' node (in [0, n)), bp position, path start
    and end [n_steps], the epoch count, samples per epoch, eta_max and the
    annealing rate lam.  Returns float64 positions [n].  On a CUDA device
    every epoch runs through K-I (a failure raises: there is no fallback);
    on the CPU through the plain twin."""
    dev = check_device(device)
    x0 = np.asarray(x0)
    n_steps = int(np.asarray(step_node).size)
    with tracing.span("layout.pack"):
        cols = step_columns(step_node, step_pos, pstart, pend, x0.size)
        x32 = x0.astype(np.float32)
        fixed = fixed_point(batch, move_bound(x0, step_pos))
    with tracing.span("layout.upload", launches=True):
        steps = upload(cols, dev)
        x = upload(x32, dev)
        acc = x.new_zeros(x.shape, dtype=torch.int64)
        cnt = x.new_zeros(x.shape, dtype=torch.int32)
    log_n = math.log(n_steps) if n_steps else 0.0
    with tracing.span("layout.epochs", launches=True):
        for t in range(epochs):
            sgd_epoch(x, steps, acc, cnt, t, batch,
                      epoch_eta(eta_max, lam, t), log_n, *fixed)
    # The host waits here for the epochs' kernels, then copies x back.
    with tracing.span("layout.readback", launches=True):
        out = x.cpu()
        tracing.count("layout.d2h_bytes", out.numel() * out.element_size())
        return out.numpy().astype(np.float64)
