"""Command line of the PyTorch/CUDA port.

`main` runs impg_tpu's own CLI (`impg_tpu.cli.main`) with its compute-engine
resolution swapped, for the duration of the call, for `resolve_compute_engine`
below, which builds the port's `TorchDeviceEngine` and imports no JAX.  Every
command, flag and output format is therefore the JAX package's; only the
device engine behind `--compute-engine device|auto` of the interval commands
(query, stats, partition, refine, similarity) differs.  The syng-side
commands (syng, map, genotype, infer) have no ported device path yet: they
run on the host, and their `--compute-engine device|mesh` exits 2.

    python -m impg_tpu_torch.cli query -a aln.paf -r 'chr1:0-50000' -x \\
        -d 100 -o bed --compute-engine device

From the command line the device is always `cuda:0`.
"""

from __future__ import annotations

import functools
import os
import sys

import torch


# Commands whose device work (syncmer scan, read packing, diploid scoring)
# is not ported: their device|mesh engines are JAX code.
UNPORTED_DEVICE_COMMANDS = ("syng", "map", "genotype", "infer")


def _fail(msg: str):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def resolve_compute_engine(args, index, approximate: bool = False,
                           n_targets: int = 0, native_ok: bool = False, *,
                           device: torch.device):
    """--compute-engine host|native|device|auto|mesh onto an engine, with
    impg_tpu.cli._resolve_compute_engine's contract.

    host -> None (numpy engine).  native -> the C++ BFS engine (default
    filter set only).  device -> TorchDeviceEngine on `device`; exits 2 when
    CUDA is absent or the lean index would not fit the card's free memory
    (the paged engine is not ported yet).  auto -> native for default-filter
    walks, else device when `device` is a usable CUDA device and the index
    passes the IMPG_AUTO_MIN_RECORDS gate, else host.  mesh -> exits 2.
    """
    spec = getattr(args, "compute_engine", "host") or "host"
    if spec == "host":
        return None
    if spec in ("native", "auto") and native_ok:
        from impg_tpu.query.host_native import NativeHostEngine

        try:
            return NativeHostEngine(index)
        except RuntimeError:
            if spec == "native":
                _fail("--compute-engine native requires the native library "
                      "(impg_tpu/native/Makefile)")
    elif spec == "native":
        _fail("--compute-engine native does not produce CIGAR-bearing output "
              "(paf/bedpe/fasta+paf); use host/device")
    if spec == "mesh":
        _fail("--compute-engine mesh is not yet ported to impg_tpu_torch")
    cuda = device.type == "cuda" and torch.cuda.is_available()
    if spec == "auto":
        if not cuda:
            return None
        n_records = len(getattr(index, "records", ())) or n_targets
        min_records = int(os.environ.get("IMPG_AUTO_MIN_RECORDS", "4096"))
        if n_records < min_records and n_targets < 64:
            return None
    if device.type == "cuda":
        if not cuda:
            _fail("--compute-engine device needs a CUDA device")
        lean_bytes = index.arena.n_ops * 20 + len(index.records) * 36
        free, _total = torch.cuda.mem_get_info(device)
        if lean_bytes > free:
            _fail(f"index needs {lean_bytes} bytes on the device, {free} free "
                  "(the paged engine is not yet ported)")
    from impg_tpu_torch.query.device import TorchDeviceEngine

    return TorchDeviceEngine(index, device=device)


def main(argv=None, device=None) -> int:
    """Run impg_tpu's CLI on `argv` with the port's engine resolver.
    `device` defaults to cuda:0; the tests pass "cpu"."""
    import impg_tpu.cli as jax_cli

    args = jax_cli.build_parser().parse_args(argv)
    spec = getattr(args, "compute_engine", None)
    if args.command in UNPORTED_DEVICE_COMMANDS and spec in ("device", "mesh"):
        _fail(f"--compute-engine {spec} for `{args.command}` is not yet "
              "ported to impg_tpu_torch; use host or auto")
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    original = jax_cli._resolve_compute_engine
    jax_cli._resolve_compute_engine = functools.partial(
        resolve_compute_engine, device=dev
    )
    try:
        return jax_cli.main(argv)
    finally:
        jax_cli._resolve_compute_engine = original


if __name__ == "__main__":
    sys.exit(main())
