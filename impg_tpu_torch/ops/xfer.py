"""Host -> device uploads (int32) and the device check.

Counterpart of impg_tpu/ops/xfer.py.  A CUDA host copies straight from
pinned memory over PCIe, so the JAX module's relay chunking and compile cache
have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

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


def upload_i32(a: np.ndarray, device) -> torch.Tensor:
    """int32 tensor on `device` holding `a` (see `as_i32`).  CUDA uploads go
    through pinned memory and do not block the host."""
    a = as_i32(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    t = torch.from_numpy(a)
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


def upload_i32_columns(cols: list, device) -> torch.Tensor:
    """int32 [n, len(cols)] tensor on `device` whose column i holds cols[i]
    (each as `as_i32`).  Each column goes up as its own contiguous array
    (`upload_i32`) and is written into its strided column on the device, so
    the host does no interleaving and the device holds one column's copy
    at a time on top of the result."""
    dev = torch.device(device)
    out = torch.empty((len(cols[0]), len(cols)), dtype=torch.int32,
                      device=dev)
    for i, c in enumerate(cols):
        out[:, i].copy_(upload_i32(np.asarray(c), dev))
    return out
