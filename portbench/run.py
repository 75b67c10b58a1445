"""Runs one cell of BENCHMARK.json once, on the cards of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run makes its data from the seed, builds
and warms up the program on the cell's own shapes (all of that is
`setup_s`), then drives the cell's entry back to back for `--seconds`: the
window ends at the first step boundary after it.  With `--trace 0` the
result reports the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics from one torch.profiler pass over the window and the
benchmark's own spans.  After the window the program's answers are held to
the plain references under reference/ (`correct`).  The last line of
standard output is the result as one JSON object; the last lines of
standard error name each number compared beside its limit.

Exits with another code than 0, printing no result, when CUDA is absent or
the cell needs more cards than the machine has, when JAX or the JAX package
was loaded by the end of the window, or when any step fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Kernel caches at fixed paths inside the checkout, so that only a cell's
# first run in a checkout builds; the port's own nvcc and g++ libraries
# already live in impg_tpu_torch/build/.
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(CACHE_DIR, _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import guard as guard_mod  # noqa: E402

_GUARD = guard_mod.ImportGuard().install()

import torch  # noqa: E402

from portbench.harness import registry, trace as trace_mod  # noqa: E402


class Refused(RuntimeError):
    """The run cannot give a result (no card, a blocked import)."""


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({type(exc).__name__})"


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float = T_START) -> dict:
    """One run of `cell`; returns the result object (the last line)."""
    cuda = device.type == "cuda"
    drv = cell.driver()
    with tempfile.TemporaryDirectory(prefix="portbench_") as work:
        state = drv.setup(cell, seed, device, work, traced)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        prof = trace_mod.profiler() if traced else contextlib.nullcontext()
        units = 0
        with prof as p:
            t0 = time.perf_counter()
            while True:
                units += drv.step(state)
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        blocked = guard_mod.loaded_blocked()
        if blocked:
            raise Refused(f"modules loaded by the end of the window: "
                          f"{blocked}")
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        metrics = {}
        result_extra = {}
        dev = {"platform": "gpu" if cuda else device.type,
               "kind": (torch.cuda.get_device_name(device) if cuda
                        else "cpu"),
               "count": cell.chips, "memory_peak_bytes": peak}
        if traced:
            tr = trace_mod.DeviceTrace.from_profile(p, window_s)
            ctx = drv.layer_context(state)
            ctx["trace"] = tr
            for m in cell.per_layer:
                v = registry.load_file("layers", m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            result_extra["breakdown"] = tr.breakdown()
        else:
            values = drv.end_to_end(state, units, window_s)
            values["setup_s"] = setup_s
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
        drv.release(state)
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks, failed = drv.check(state)
    print(f"portbench: setup_s={setup_s:.3f} window_s={window_s:.3f} "
          f"units={units} check_s={time.perf_counter() - t_check:.3f}",
          file=sys.stderr, flush=True)
    correct = all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": bool(correct), "attempted": int(units),
              "failed": int(failed), "metrics": metrics, "device": dev}
    result.update(result_extra)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = registry.Cell(registry.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed={args.seed} "
          f"card={power_limit()}", file=sys.stderr, flush=True)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    except Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
