"""Host -> device uploads and the device check.

Counterpart of impg_tpu/ops/xfer.py.  A CUDA host copies straight from
pinned memory over PCIe, so the JAX module's relay chunking and compile cache
have no counterpart here.  The uploads add the bytes they hand to the
device to tracing.py's counter "xfer.h2d_bytes" (a clone on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from impg_tpu_torch import tracing

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def check_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no CUDA
    device is usable.  Never picks a device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def as_i32(a: np.ndarray) -> np.ndarray:
    """Contiguous int32 copy or view of `a`: uint32 (packed CIGAR runs) is
    reinterpreted bit for bit, wider integers must fit int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.int32:
        return a
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.size and (int(a.min()) < _I32_MIN or int(a.max()) > _I32_MAX):
        raise ValueError(f"values of dtype {a.dtype} do not fit int32")
    return a.astype(np.int32)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Tensor on `device` holding a copy of `a` (its dtype kept).  CUDA
    uploads go through pinned memory and do not block the host."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    t = torch.from_numpy(a)
    dev = torch.device(device)
    tracing.count("xfer.h2d_bytes", a.nbytes)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


def upload_i32(a: np.ndarray, device) -> torch.Tensor:
    """int32 tensor on `device` holding `a` (see `as_i32`), by `upload`."""
    return upload(as_i32(a), device)


# Values a pinned staging buffer of `upload_i32_rows` holds (64 MiB of int32).
STAGE_ELEMS = 1 << 24


def _n_rows(rows) -> int:
    return rows.stop - rows.start if isinstance(rows, slice) else len(rows)


def _take(col: np.ndarray, rows, out: np.ndarray, wrap: bool) -> None:
    """out[:] = col[rows] as int32: `as_i32`'s values, or wrapped when
    `wrap`.  int32 and uint32 columns go straight into `out`, with no copy
    between (`rows` index arrays are in range by construction)."""
    if col.dtype == np.uint32:
        col = col.view(np.int32)
    if col.dtype == np.int32:
        if isinstance(rows, slice):
            out[...] = col[rows]
        else:
            np.take(col, rows, out=out, mode="clip")
        return
    v = col[rows]
    out[...] = v.astype(np.int32) if wrap else as_i32(v)


def upload_i32_rows(groups: list, n: int, blocks, device,
                    wrap: bool = False) -> list:
    """int32 [n, len(g)] tensors on `device`, one for each group `g` of host
    columns, column i of a group's tensor taking g[i]'s rows as `blocks`
    sends them: (r0, rows) pairs, `rows` a slice or an int64 index array of
    the columns' rows that go to rows [r0, r0 + len(rows)) of every tensor.
    Values are taken as `as_i32` takes them, or wrapped to int32 when
    `wrap` (int64 prefixes that are sums within one record, which the JAX
    upload casts so).

    On CUDA the host takes a chunk of rows of every column, one column
    after the other, straight into one of two pinned staging buffers of
    STAGE_ELEMS values; the chunk goes up in one copy while the host fills
    the other buffer, and the device transposes it into the tensors' rows.
    So the host makes one pass over the values and never holds a copy of
    the whole: the arena columns of an index past 2^31 runs are tens of
    GB, and so are a page's and the tracepoints'."""
    dev = torch.device(device)
    outs = [torch.empty((n, len(g)), dtype=torch.int32, device=dev)
            for g in groups]
    cols = [np.asarray(c) for g in groups for c in g]
    if dev.type != "cuda":
        dst = [(o.numpy(), i) for o, g in zip(outs, groups)
               for i in range(len(g))]
        for r0, rows in blocks:
            r1 = r0 + _n_rows(rows)
            tracing.count("xfer.h2d_bytes", 4 * len(cols) * (r1 - r0))
            for col, (o, i) in zip(cols, dst):
                _take(col, rows, o[r0:r1, i], wrap)
        return outs
    k = len(cols)
    step = max(STAGE_ELEMS // k, 1)
    stage = [None, None]
    done = [None, None]
    turn = 0
    for r0, rows in blocks:
        m = _n_rows(rows)
        tracing.count("xfer.h2d_bytes", 4 * k * m)
        for c0 in range(0, m, step):
            c1 = min(c0 + step, m)
            sub = (slice(rows.start + c0, rows.start + c1)
                   if isinstance(rows, slice) else rows[c0:c1])
            b = turn % 2
            turn += 1
            if stage[b] is None:
                stage[b] = torch.empty(STAGE_ELEMS, dtype=torch.int32,
                                       pin_memory=True)
            if done[b] is not None:
                done[b].synchronize()
            buf = stage[b][:k * (c1 - c0)].view(k, c1 - c0)
            host = buf.numpy()
            for i, col in enumerate(cols):
                _take(col, sub, host[i], wrap)
            up = buf.to(dev, non_blocking=True)
            done[b] = torch.cuda.Event()
            done[b].record(torch.cuda.current_stream(dev))
            i0 = 0
            for o, g in zip(outs, groups):
                o[r0 + c0:r0 + c1].copy_(up[i0:i0 + len(g)].t())
                i0 += len(g)
    return outs


def upload_i32_columns(cols: list, device, wrap: bool = False) -> torch.Tensor:
    """int32 [n, len(cols)] tensor on `device` whose column i holds cols[i],
    by `upload_i32_rows`: the host does no interleaving, and it and the
    device hold no more than a staging buffer's worth on top of the
    result."""
    n = len(cols[0])
    return upload_i32_rows([cols], n, [(0, slice(0, n))], device, wrap)[0]
