#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 bench_gpu/calibrate.py --workload fpfh-train-b64n512 \\
        --seeds 11,12,13 --control 3 --seconds 2

For each seed, in one process: the cell's own run (a short window for the
serving cells; a training cell's readings come from its first three steps)
and the numbers ``checks.py`` compares, with no limit applied. For the
first ``--control`` seeds also the control, the plain reference computed at
TF32 in the program's place, and for a training cell the fault of half the
batch left out of the loss (the reference, so broken, in the program's
place). One JSON line a seed on standard output. The benchmark's runs do
not run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])


def control_readings(run, out, dev):
    """(control readings, fault readings or None) of one finished run."""
    import torch
    from bench_gpu.harness import cells, checks, reference
    mat = out["materials"]
    if run.workload["kind"] == "train":
        ref, start = mat["ref"], mat["start"]
        ctrl, _ = cells.train_reference(run, mat["hosts"], reference.CONTROL,
                                        dev)
        ctrl_r = checks.train_readings(ctrl, ref, start)
        half, _ = cells.train_reference(run, mat["hosts"],
                                        reference.REFERENCE, dev,
                                        loss_rows=run.traffic["batch"] // 2)
        return ctrl_r, checks.train_readings(half, ref, start)
    values, matched = [], []
    for b in mat["sample"]:
        host = mat["hosts"][b]
        transport, (r0, _, _, _), masks, gt = cells.match_reference(
            run, host, dev, reference.REFERENCE, mat["floor"], mat["weights"])
        _, answers, _, cgt = cells.match_reference(
            run, host, dev, reference.CONTROL, mat["floor"], mat["weights"])
        r = run.arch.match_readings(run.sizes, answers, masks, transport)
        if gt is not None:
            keep = gt["clear_pair"]
            r["gt_mismatch"] = float(((cgt["gt0"] != gt["gt0"])
                                      & gt["clear0"]).sum())
            r["loss_gap"] = checks.loss_gap(cgt["loss"][keep],
                                            gt["loss"][keep])
        values.append(r)
        matched.append(float(((r0 >= 0) & masks[0]).sum())
                       / float(masks[0].sum()))
        del transport
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    out["matched_share"] = matched
    return checks.merge_max(values), None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    from bench_gpu.harness import common
    common.fix_malloc()
    import torch
    from bench_gpu.harness.cells import Run, free, run_cell
    dev = torch.device(args.device)
    wl = common.workload(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run = Run(cell=args.workload, workload=wl,
                  config=common.config(wl["config"]), seed=seed,
                  seconds=args.seconds, trace=False, device=dev,
                  t_start=time.perf_counter())
        out = run_cell(run)
        line = {"seed": seed, "program": out["values"],
                "e2e": out["e2e"], "attempted": out["attempted"]}
        if i < args.control:
            ctrl, fault = control_readings(run, out, dev)
            line["control"] = ctrl
            if fault is not None:
                line["half_batch"] = fault
            if "matched_share" in out:
                line["matched_share"] = out["matched_share"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out, run
        free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
