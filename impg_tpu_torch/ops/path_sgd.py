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
step; positions x and the accumulators acc, cnt float32 [n_segs].

  * `sgd_epochs` runs the whole annealed loop: on a CUDA device one K-I
    launch per epoch (`impg_path_sgd_epoch`: draws, pulls, atomicAdd into
    acc/cnt) and one small apply launch (`impg_path_sgd_apply`:
    x -= acc / max(cnt, 1), acc = cnt = 0), both counted under `path_sgd`;
    on the CPU the plain twin.
  * The twin is kept in two parts: `draw_pairs` (the Philox draws and the
    pair mapping, in int64 arithmetic) and `pull_plain` + `apply_plain` (the
    update for given pairs), so a test can inject other draws.

float32 arithmetic as JAX's: the kernel does it with round-to-nearest
intrinsics in the twin's order of operations (no contraction); only the
order of the atomic sums differs from the twin's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from impg_tpu_torch import kernels
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


def pull_plain(x, node, pos, i, j, eta: float, acc, cnt) -> None:
    """Adds the pulls of the pairs (i, j) with i != j into acc and their
    counts into cnt (in place, in x's dtype): node a = node[i] moves by +dx,
    node b = node[j] by -dx, dx = mu * r * (x[a] - x[b])."""
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
    dx = mu * r * diff
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


def epoch_plain(x, steps, epoch: int, batch: int, eta: float, log_n: float,
                acc=None, cnt=None) -> None:
    """One epoch of the twin on `steps` (sgd_steps' [n_steps, 4] int32)
    in float32, updating x in place."""
    node = steps[:, 0].to(torch.int64)
    pos = steps[:, 1].view(torch.float32)
    pstart = steps[:, 2].to(torch.int64)
    pend = steps[:, 3].to(torch.int64)
    acc = torch.zeros_like(x) if acc is None else acc
    cnt = torch.zeros_like(x) if cnt is None else cnt
    for first in range(0, batch, _DRAW_CHUNK):
        i, j = draw_pairs(pstart, pend, epoch, first,
                          min(_DRAW_CHUNK, batch - first), log_n)
        pull_plain(x, node, pos, i, j, eta, acc, cnt)
    apply_plain(x, acc, cnt)


# ---- kernel wrappers ---------------------------------------------------------


def sgd_steps(step_node, step_pos, pstart, pend, n: int, device) -> torch.Tensor:
    """The step columns interleaved as int32 [n_steps, 4] on `device`: node,
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
    return upload(cols, device)


def _check_state(x, steps) -> None:
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x: expected a contiguous 1-D float32 tensor")
    if steps.dtype != torch.int32 or steps.dim() != 2 \
            or steps.shape[1] != 4 or not steps.is_contiguous():
        raise ValueError("steps: expected a contiguous int32 [n_steps, 4]")
    if x.device != steps.device:
        raise ValueError(f"x on {x.device}, steps on {steps.device}")


def sgd_epoch(x, steps, acc, cnt, epoch: int, batch: int, eta: float,
              log_n: float, pairs=None) -> None:
    """One epoch in place on x (float32 [n]) through K-I: the pull launch,
    then the apply launch; acc and cnt (float32 [n]) must be zero and are
    left zero.  With `pairs` (int32 [batch, 2] on the card) the pull also
    writes each sample's (i, j) there.  CPU tensors take the plain twin (no
    `pairs`); CUDA tensors launch the kernels or raise."""
    _check_state(x, steps)
    for name, t in (("acc", acc), ("cnt", cnt)):
        if t.dtype != torch.float32 or t.shape != x.shape \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: expected float32 like x")
    if x.device.type == "cpu":
        if pairs is not None:
            raise ValueError("pairs: only the kernel writes its draws")
        epoch_plain(x, steps, epoch, batch, eta, log_n, acc, cnt)
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
        epoch & _M32, 0 if pairs is None else pairs.data_ptr(), stream,
    )
    kernels.launch(
        "path_sgd", "impg_path_sgd_apply",
        x.data_ptr(), acc.data_ptr(), cnt.data_ptr(), x.shape[0], stream,
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
    steps = sgd_steps(step_node, step_pos, pstart, pend, x0.size, dev)
    x = upload(x0.astype(np.float32), dev)
    acc = torch.zeros_like(x)
    cnt = torch.zeros_like(x)
    log_n = math.log(n_steps) if n_steps else 0.0
    for t in range(epochs):
        sgd_epoch(x, steps, acc, cnt, t, batch,
                  epoch_eta(eta_max, lam, t), log_n)
    return x.cpu().numpy().astype(np.float64)
