#!/usr/bin/env python3
"""Registration-recall evaluation of the PyTorch + CUDA port (counterpart of
``test_registration_metric.py``).

FCGF/D3Feat-style protocol: AverageMeters over repeatability / inlier /
precision (inlier ratio) / recall / fp,tp rates; SVD pose fit; RTE
accumulated when < 2 m, RRE when < 5 deg; registration recall = fraction
of pairs passing both; final F1 computed from the run-averaged precision
and recall. Prints the per-pair lines, the two-line summary, ``baned_data``
and the ``[timing]`` lines in the formats of
``test_registration_metric.py``.

    python3 test_registration_metric_torch.py --synthetic true \\
        --train_path /tmp/kd/ --device cpu --resume_model model.pth \\
        --batch_size 8 --max_pairs 16

``--device`` defaults to ``cuda`` (absent: an error); batches run through
``eval/runner.py::EvalPipeline`` as in ``test_torch.py``, the forward a
CUDA graph replayed per batch shape on the card. As W processes
each rank evaluates a contiguous block of the pairs; the meters' update
histories are merged on rank 0 in rank order (bit-equal to one sequential
pass), and rank 0 alone prints the summary. With ``--seq_parallel S`` the
S members of a data row split the keypoints of the row's pairs, and member
0 alone records them.
"""

import time

import numpy as np

METER_KEYS = ("rep", "rre", "rte", "inlier", "inlier_ratio", "recall",
              "tp_rate", "fp_rate", "RR")


def main(argv=None):
    """Run the evaluation; returns ``summary`` (``registration_summary`` of
    the meters), ``pairs`` (one record a pair: ``idx``, the printed ``line``
    or None for a banned pair, ``mm``, ``rte``, ``rre`` and the pair's valid
    ``matches0``), ``baned_data``, ``n_pairs``, ``n_batches``, ``seconds``
    and ``first_batch_s``."""
    from mdgat_tpu_torch.cli import build_parser, debugging
    args = build_parser("test").parse_args(argv)
    with debugging(args):
        return _run(args)


def _run(args):
    from mdgat_tpu_torch.cli import (config_from_args,
                                     maybe_generate_synthetic, nan_guard,
                                     setup_distributed)
    cfg = config_from_args(args, "test")

    from mdgat_tpu_torch.eval import (AverageMeter, merge_meter_records,
                                      pack_meter_records,
                                      registration_batch_metrics,
                                      registration_summary)
    from mdgat_tpu_torch.eval.runner import (eval_model, eval_pipeline,
                                             timing_lines)
    from mdgat_tpu_torch.parallel import allgather_host_vector, is_primary

    device, group = setup_distributed(cfg, args)
    cfg = maybe_generate_synthetic(cfg, args)
    model, source = eval_model(cfg, device)
    if args.debug_nans:
        nan_guard(model)
    if source == "missing":
        print(f"[warn] checkpoint not found ({cfg.resume_model}); using "
              "random init — metrics will be near-chance")
    elif source == "none":
        print("[warn] no checkpoint; random init")

    multi = group is not None
    meters = {k: AverageMeter(record=multi) for k in METER_KEYS}
    baned_data = 0
    n_pairs = 0
    records = []
    pipeline = eval_pipeline(cfg, model, device, ("matches0",), group=group,
                             max_pairs=args.max_pairs)
    # the members of a seq row compute the same matches: member 0 records
    recording = group is None or group.seq_index == 0
    t0 = time.time()
    t_first = None  # first completed batch (start-up), reported apart
    n_batches = 0
    for batch, out in pipeline:
        if t_first is None:
            t_first = time.time()
        n_batches += 1
        if not recording:
            continue
        # batched host post-processing (integer count reductions and one
        # [B, 3, 3] SVD solve), then the reference's sequential meter and
        # print protocol. Empty match sets give nan rte / rre.
        results = registration_batch_metrics(
            out["matches0"], out["gt_matches0"],
            batch["keypoints0"], batch["keypoints1"],
            batch["mask0"], batch["mask1"], batch["T_gt"],
            calculate_pose=args.calculate_pose)

        for b, (mm, rte, rre) in enumerate(results):
            n_pairs += 1
            idx = batch["idx0"][b]
            rec = dict(idx=int(idx), line=None, mm=mm, rte=rte, rre=rre,
                       matches0=out["matches0"][b][
                           np.asarray(batch["mask0"][b])])
            records.append(rec)
            if mm["banned"]:
                baned_data += 1
                continue
            meters["rep"].update(mm["repeatability"])
            meters["fp_rate"].update(mm["fp_rate"])
            meters["tp_rate"].update(mm["tp_rate"])
            meters["recall"].update(mm["recall"])
            meters["inlier_ratio"].update(mm["precision"])
            meters["inlier"].update(mm["tm"])

            if args.calculate_pose:
                if rte < 2:
                    meters["rte"].update(rte)
                if not np.isnan(rre) and rre < np.pi / 180 * 5:
                    meters["rre"].update(rre)
                if rte < 2 and not np.isnan(rre) and rre < np.pi / 180 * 5:
                    meters["RR"].update(1)
                    rec["line"] = (
                        "idx{}, rep {:.3f}, inlier {}, precision(inlier "
                        "ratio) {:.3f}, recall {:.3f}, fp_rate {:.3f}, "
                        "tp_rate {:.3f}, RTE {:.3f}, RRE {:.3f}".format(
                            idx, mm["repeatability"], mm["tm"],
                            mm["precision"], mm["recall"], mm["fp_rate"],
                            mm["tp_rate"], rte, rre))
                else:
                    meters["RR"].update(0)
                    rec["line"] = (f"idx{idx}, rep {mm['repeatability']:.3f}, "
                                   "registration fail")
            else:
                rec["line"] = (
                    "idx{}, rep {:.3f}, inlier {}, precision(inlier "
                    "ratio) {:.3f}, recall {:.3f}, fp_rate {:.3f}, "
                    "tp_rate {:.3f}".format(
                        idx, mm["repeatability"], mm["tm"],
                        mm["precision"], mm["recall"], mm["fp_rate"],
                        mm["tp_rate"]))
            print(rec["line"])

        if not multi and args.max_pairs and n_pairs >= args.max_pairs:
            break

    dt = time.time() - t0
    result = dict(pairs=records, n_batches=n_batches, seconds=dt)
    if multi:
        states = allgather_host_vector(pack_meter_records(
            [baned_data, n_pairs], meters, METER_KEYS))
        if not is_primary():
            return dict(result, summary=None, baned_data=baned_data,
                        n_pairs=n_pairs, first_batch_s=None)
        head, meters = merge_meter_records(states, METER_KEYS)
        baned_data, n_pairs = int(head[0]), int(head[1])
    s = registration_summary(meters)
    print("repeatibility, inlier, RR || precision(inlier ratio), recall, "
          "F1 || fp_rate, tp_rate || RTE, RRE")
    print("{:.3f} {:.1f} {:.3f} || {:.3f} {:.3f}  {:.3f} || {:.3f}  "
          "{:.3f} || {:.3f} {:.3f}".format(
              s["repeatability"], s["inlier"], s["RR"], s["precision"],
              s["recall"], s["F1"], s["fp_rate"], s["tp_rate"],
              s["RTE"], s["RRE"]))
    print("baned_data {}".format(baned_data / max(n_pairs, 1)))
    first = None if t_first is None else t_first - t0
    for line in timing_lines(len(records), dt, first, n_batches):
        print(line)
    return dict(result, summary=s, baned_data=baned_data, n_pairs=n_pairs,
                first_batch_s=first)


if __name__ == "__main__":
    main()
