#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch + CUDA port once.

    python3 bench_gpu/run.py --workload fpfh-train-b64n512 --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout: builds the cell's inputs and weights from the
seed, loads, warms up and captures (``setup_s``), measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or traces the
cell's ``trace_iters`` iterations under ``torch.profiler`` (``--trace 1``:
its per-layer metrics, the device's busy and window seconds and the
breakdown), then holds what the timed path produced to the plain reference
and prints one JSON line last on standard output. The numbers compared and
their limits are the last lines of standard error and the line's last key.

Before anything is imported it fixes the process's malloc thresholds
(``harness/common.py::fix_malloc``), so that a fresh process's host path
runs as a long-lived one's does.

It needs the card: with no CUDA device, or fewer than the cell asks for, it
prints no result and exits 2. It exits 3 with no result when JAX or the JAX
package is loaded in the process once the window has closed and the
metric files have read.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the import path
sys.path[0] = str(ROOT)
os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            workload=None, overrides=None, t_start: float = T_START,
            folder=None):
    """Everything after the look for the card: (exit code, result line or
    None). ``workload`` replaces the cell's file and ``overrides`` adds
    Config fields (the CPU tests run a cell small, on the kernel twins).
    ``folder`` holds the configurations, workloads, metrics and
    architectures in place of this package, and ``BENCHMARK.json`` is in
    its parent (a test's temporary checkout)."""
    import torch
    from bench_gpu.harness import common
    from bench_gpu.harness.cells import Run, run_cell

    folder = folder or common.PKG
    bench = common.benchmark(folder.parent)
    wl = workload or common.workload(cell, folder)
    run = Run(cell=cell, workload=wl,
              config=common.config(wl["config"], folder), seed=seed,
              seconds=seconds, trace=bool(trace),
              device=torch.device(device), t_start=t_start,
              overrides=dict(overrides or {}), folder=folder)
    out = run_cell(run)
    dev = run.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1,
                   "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"]}
    metrics = {}
    if trace:
        t = out["trace"]
        on_card = t is not None and bool(t.ops)
        if not on_card and dev.type == "cuda":
            print("the profiler recorded no device operation in the window",
                  file=sys.stderr)
            return 4, None
        if on_card:
            device_info.update(busy_s=t.busy_s, window_s=t.window_s)
            result["breakdown"] = {"device_ops": t.top_ops(10),
                                   "idle_gaps": t.idle_gaps(10)}
        for m in common.per_layer_for(cell, bench):
            value = common.metric_reader(m["name"], folder)(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in common.end_to_end_for(cell, bench):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    if dev.type == "cuda":
        print("card: " + common.card_line(), file=sys.stderr)
    # last, once every metric file has been loaded and has read
    found = common.forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found), file=sys.stderr)
        return 3, None
    return 0, (result, out["checks"])


def main(argv=None) -> int:
    from bench_gpu.harness import common
    malloc_fixed = common.fix_malloc()
    args = parse(argv)
    import torch
    chips = next(w["chips"] for w in common.benchmark()["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible: no result", file=sys.stderr)
        return 2
    if not malloc_fixed:
        print("malloc's thresholds could not be fixed", file=sys.stderr)
    code, out = execute(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda:0")
    if out is not None:
        common.emit(*out)
    return code


if __name__ == "__main__":
    sys.exit(main())
