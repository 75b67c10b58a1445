"""Command line of the PyTorch/CUDA port.

`main` runs impg_tpu's own CLI (`impg_tpu.cli.main`) with its compute-engine
resolution swapped, for the duration of the call, for `resolve_compute_engine`
below, which builds the port's engines and imports no JAX (and with its
mesh output-process check, which asks jax, answered as one process).  Every command,
flag and output format is therefore the JAX package's; only the device
engines behind `--compute-engine device|auto` of the interval commands
(query, stats, partition, refine, similarity) differ:

  * `TorchDeviceEngine`, resident on the card; built with tracepoints (and
    no CIGAR arena) for `--approximate` walks, which then run on the card
    too unless even those columns pass the device budget;
  * `TorchPagedEngine` (query/paged.py) for exact walks and `stats -r/-b`
    over an index whose lean bytes pass the device budget or whose arena
    passes 2^31 runs.

The syng-side commands (syng, map, genotype, infer) have no ported device
path yet: they run on the host, and their `--compute-engine device|mesh`
exits 2.

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


# Share of the card's free memory that the device budget takes: the JAX
# default's share of its chip (12 GiB of a 16 GiB v5e).
CUDA_BUDGET_SHARE = 0.75


def device_budget(device: torch.device) -> int:
    """Bytes the device engines may hold: IMPG_HBM_BUDGET_BYTES when set;
    else, on CUDA, CUDA_BUDGET_SHARE (3/4) of the free memory that
    `torch.cuda.mem_get_info` reports; else the JAX default of 12 GiB."""
    env = os.environ.get("IMPG_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * CUDA_BUDGET_SHARE)
    from impg_tpu_torch.query.paged import DEFAULT_BUDGET

    return DEFAULT_BUDGET


def resolve_compute_engine(args, index, approximate: bool = False,
                           n_targets: int = 0, native_ok: bool = False, *,
                           device: torch.device):
    """--compute-engine host|native|device|auto|mesh onto an engine, with
    impg_tpu.cli._resolve_compute_engine's contract.

    host -> None (numpy engine).  native -> the C++ BFS engine (default
    filter set only).  device -> on `device` (exits 2 when it names CUDA and
    CUDA is absent): an approximate walk gets TorchDeviceEngine with
    tracepoints, which uploads no CIGAR arena, unless its bytes
    (n_boundaries * 12 + n_records * 48) pass `device_budget` or its
    tracepoint table has 2^31 boundaries, and then the host (no device
    engine pages tracepoints).  Any other command whose lean index bytes
    (n_ops * 20 + n_records * 36) pass `device_budget`, or whose arena has
    2^31 runs or more, gets the paged TorchPagedEngine under that budget;
    else TorchDeviceEngine.  auto ->
    native for default-filter walks, else device when `device` is a usable
    CUDA device and the index passes the IMPG_AUTO_MIN_RECORDS gate, else
    host.  mesh -> exits 2.
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
    if device.type == "cuda" and not cuda:
        _fail("--compute-engine device needs a CUDA device")
    budget = device_budget(device)
    from impg_tpu_torch.query.device import TorchDeviceEngine

    if approximate:
        tp = index.tp if index.tp is not None else index.ensure_tracepoints()
        n_bound = tp.q_bound.size
        if n_bound * 12 + len(index.records) * 48 > budget or n_bound >= 2**31:
            return None
        return TorchDeviceEngine(index, device, with_tracepoints=True)
    n_ops = index.arena.n_ops
    if n_ops * 20 + len(index.records) * 36 > budget or n_ops >= 2**31:
        from impg_tpu_torch.query.paged import TorchPagedEngine

        return TorchPagedEngine(index, device, hbm_budget_bytes=budget)
    return TorchDeviceEngine(index, device)


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
    original = (jax_cli._resolve_compute_engine, jax_cli._is_output_process)
    jax_cli._resolve_compute_engine = functools.partial(
        resolve_compute_engine, device=dev
    )
    # The JAX CLI asks jax which process of a mesh run writes the output,
    # which would import jax and start its CUDA backend beside torch; the
    # port runs one process.
    jax_cli._is_output_process = lambda: True
    try:
        return jax_cli.main(argv)
    finally:
        jax_cli._resolve_compute_engine, jax_cli._is_output_process = original


if __name__ == "__main__":
    sys.exit(main())
