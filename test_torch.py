#!/usr/bin/env python3
"""Matching + pose evaluation entry point of the PyTorch + CUDA port
(counterpart of ``test.py``, with the reference-compatible CLI).

Per pair: forward pass, match metrics (precision/accuracy/recall/
repeatability/fp/tp rates), SVD pose fit with inlier count and
translation/rotation errors, fail (<4 matches or pose error over 2m/5deg)
and ban (<10% GT coverage) bookkeeping; prints the per-pair lines, the
aggregate line, ``baned_data`` and the ``[timing]`` lines in the formats of
``test.py``.

    python3 test_torch.py --synthetic true --train_path /tmp/kd/ \\
        --device cpu --resume_model model.pth --batch_size 8 --max_pairs 24

The model runs on ``--device`` (``cuda`` by default; a CUDA device that is
absent is an error). Pairs are evaluated in batches of ``--batch_size``
through ``eval/runner.py::EvalPipeline`` (host batches on a thread, one
readback a batch, one batch behind); the metrics are host numpy at float64
(``eval/metrics.py``), computed from the host keypoints of each batch.

As W processes (``torchrun`` or ``--coordinator_address / --num_processes
/ --process_id``), each rank evaluates a contiguous block of the pairs on
its own device, and the per-pair records are merged on rank 0, which alone
prints the aggregate lines: the same lines as one process over the same
pairs. With ``--seq_parallel S`` the ranks form W / S data rows; the S
members of a row split the keypoints of the row's block of pairs, every
member gets the whole clouds' matches, and member 0 alone records and
prints the row's pairs.
"""

import time

import numpy as np


def _pair_line(idx, status, mm, pm):
    """The line ``test.py`` prints for one pair, or None (banned pairs)."""
    if status == "banned":
        return None
    if status in ("too_few", "pose_fail"):
        return "registration fail"
    if status == "ok":
        return (
            "idx{}, inlier {}, rep {:.3f}, inlier_ratio {:.3f}, "
            "precision {:.3f}, accuracy {:.3f}, recall {:.3f}, "
            "fp_rate {:.3f}, tp_rate {:.3f}, trans_error {:.3f}, "
            "rot_error {:.3f}".format(
                idx, pm["inlier"], mm["repeatability"],
                pm["inlier_ratio"], mm["precision"], mm["accuracy"],
                mm["recall"], mm["fp_rate"], mm["tp_rate"],
                pm["trans_error"], pm["rot_error"]))
    # ok_nopose: the reference prints but never appends
    return ("idx{}, precision {:.3f}, accuracy {:.3f}, recall "
            "{:.3f}, true match {}, false match {}, fp_rate "
            "{:.3f}, tp_rate {:.3f}".format(
                idx, mm["precision"], mm["accuracy"], mm["recall"],
                mm["tm"], mm["fm"], mm["fp_rate"], mm["tp_rate"]))


def _plot(batch, out, b, line_width):
    from mdgat_tpu_torch.eval.visualize import plot_match
    mask = np.asarray(batch["mask0"][b])
    mask1 = np.asarray(batch["mask1"][b])
    kpts0 = np.asarray(batch["keypoints0"][b])[mask]
    kpts1 = np.asarray(batch["keypoints1"][b])[mask1]
    matches = np.asarray(out["matches0"][b])[mask]
    conf = np.asarray(out["matching_scores0"][b])[mask]
    gt0 = np.asarray(out["gt_matches0"][b])[mask]
    valid = matches > -1
    tp_mask = (matches > -1) & (matches == gt0)
    fp_mask = (matches > -1) & (gt0 == -1)   # test.py:280
    gt_valid = gt0 > -1
    # the pointnet modes' batches carry the raw scans: the panels are drawn
    # over them, as the reference does (test.py:322)
    pc0, pc1 = (np.asarray(batch[k][b]) if k in batch else []
                for k in ("cloud0", "cloud1"))
    plot_match(pc0, pc1, kpts0, kpts1, kpts0[valid], kpts1[matches[valid]],
               kpts0[gt_valid], kpts1[gt0[gt_valid]], matches, conf[valid],
               tp_mask, fp_mask, line_radius=line_width)


def main(argv=None):
    """Run the evaluation; returns what it computed: ``summary`` (the
    aggregate means, ``fail_rate`` and ``baned_rate``), ``pairs`` (one
    record a pair: ``idx``, ``status``, the printed ``line`` or None,
    ``mm``, ``pm`` and the pair's valid ``matches0``), ``n_pairs``,
    ``n_batches``, ``seconds`` and ``first_batch_s``."""
    from mdgat_tpu_torch.cli import build_parser, debugging
    args = build_parser("test").parse_args(argv)
    with debugging(args):
        return _run(args)


def _run(args):
    from mdgat_tpu_torch.cli import (config_from_args,
                                     maybe_generate_synthetic, nan_guard,
                                     setup_distributed)
    cfg = config_from_args(args, "test")

    from mdgat_tpu_torch.eval import TestEvalAccumulator
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
        print("[warn] no checkpoint given (--resume_model); using random "
              "init — metrics will be near-chance")
    else:
        print(f"Resume from {cfg.resume_model}")

    fetch = (("matches0", "matching_scores0") if args.visualize
             else ("matches0",))
    # several ranks: this rank's contiguous block of the pairs, the cap
    # applied to the global prefix first
    pipeline = eval_pipeline(cfg, model, device, fetch, group=group,
                             max_pairs=args.max_pairs)
    acc = TestEvalAccumulator()
    records = []
    # the members of a seq row compute the same matches: member 0 records
    recording = group is None or group.seq_index == 0
    t0 = time.time()
    t_first = None  # wall time of the first completed batch (start-up),
    n_batches = 0   # reported apart
    for batch, out in pipeline:
        if t_first is None:
            t_first = time.time()
        n_batches += 1
        if not recording:
            continue
        # batched host post-processing: integer [B]-reductions and one
        # [B, 3, 3] SVD pose solve, then the per-pair print protocol
        results = acc.update_batch(
            out["matches0"], out["gt_matches0"],
            batch["keypoints0"], batch["keypoints1"],
            batch["mask0"], batch["mask1"], batch["T_gt"],
            calculate_pose=args.calculate_pose)
        for b, (status, mm, pm) in enumerate(results):
            idx = batch["idx0"][b]
            line = _pair_line(idx, status, mm, pm)
            records.append(dict(
                idx=int(idx), status=status, line=line, mm=mm, pm=pm,
                matches0=out["matches0"][b][np.asarray(batch["mask0"][b])]))
            if line is None:
                continue
            print(line)
            if args.visualize and status in ("ok", "ok_nopose"):
                _plot(batch, out, b, args.vis_line_width)
        if group is None and args.max_pairs and acc.n_pairs >= args.max_pairs:
            break

    dt = time.time() - t0
    result = dict(pairs=records, n_pairs=acc.n_pairs, n_batches=n_batches,
                  seconds=dt)
    if group is not None:
        states = allgather_host_vector(acc.state_vector())
        if not is_primary():
            return dict(result, summary=None, first_batch_s=None)
        acc = TestEvalAccumulator.from_state_vectors(states)
    mean = acc.summary()
    print(
        "average repeatibility: {:.3f}, inlier_mean {:.3f}, "
        "inlier_ratio_mean {:.3f}, fail {:.6f}, precision_mean {:.3f}, "
        "accuracy_mean {:.3f}, recall_mean {:.3f}, true match {:.3f}, "
        "false match {:.3f}, fp_rate_mean {:.3f}, tp_rate_mean {:.3f}, "
        "tp_rate_mean2 {:.3f}, trans_error_mean {:.3f}, rot_error_mean "
        "{:.3f}".format(
            mean["repeatability"], mean["inlier"], mean["inlier_ratio"],
            mean["fail_rate"], mean["precision"], mean["accuracy"],
            mean["recall"], mean["tm"], mean["fm"], mean["fp_rate"],
            mean["tp_rate"], mean["tp_rate2"], mean["trans_error"],
            mean["rot_error"]))
    print("baned_data {}".format(mean["baned_rate"]))
    first = None if t_first is None else t_first - t0
    for line in timing_lines(result["n_pairs"], dt, first, n_batches):
        print(line)
    return dict(result, summary=mean, first_batch_s=first)


if __name__ == "__main__":
    main()
