"""Shared CLI of the port: the reference's public flags + device extras.

Port of ``mdgat_tpu/cli.py``. Every reference flag keeps its name, type and
per-entry-point default (``train.py:16-123``, ``test.py:18-126``), including
the defaults that differ between train and test (batch size, max_keypoints,
ensure_kpts_num, loss_method, memory_is_enough); ``--k`` accepts the
reference's Python-list syntax (``[128, None, 128, None, 64, None, 64,
None]``).

The JAX package's accelerator flags collapse as its config did: ``--device``
says where the model runs (``cuda`` unless asked otherwise), ``--use_kernels``
/ ``--train_layer`` / ``--loss_kernel`` choose the hand-written kernel routes
(``core/config.py``). The flags that steer JAX, the TPU or several hosts
are not ported; ``--help`` lists them in its epilog.
"""

from __future__ import annotations

import argparse
import ast
import os

from mdgat_tpu_torch.core.config import (POINTNET_DESCRIPTORS, Config,
                                         test_defaults, train_defaults)

_EPILOG = ("Flags of the JAX package that are not ported (they steer JAX, "
           "the TPU or several hosts): --platform, --data_parallel, "
           "--seq_parallel, --shard_map, --use_pallas, --pallas_*, "
           "--scan_gnn_pairs, --coordinator_address, --num_processes, "
           "--process_id, --debug_nans, --trace_dir, --ship_bf16.")


def _parse_k(s: str):
    if s in ("None", "none", ""):
        return None
    val = ast.literal_eval(s)
    if val is None:
        return None
    return tuple(val)


def _parse_bool(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes", "y")


def build_parser(preset: str) -> argparse.ArgumentParser:
    d = train_defaults() if preset == "train" else test_defaults()
    p = argparse.ArgumentParser(
        description="Point cloud matching ({} preset)".format(preset),
        epilog=_EPILOG,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    p.add_argument("--sinkhorn_iterations", type=int,
                   default=d.sinkhorn_iterations)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--epoch", type=int, default=d.epoch)
    p.add_argument("--memory_is_enough", type=_parse_bool,
                   default=d.memory_is_enough)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--local_rank", type=int, nargs="*", default=[0],
                   help="accepted for CLI compatibility and ignored; "
                        "--device places the model")
    p.add_argument("--resume", type=_parse_bool, default=False)
    p.add_argument("--net", type=str, default=d.net,
                   choices=["mdgat", "superglue", "raw"])
    p.add_argument("--loss_method", type=str, default=d.loss_method,
                   choices=["superglue", "triplet_loss", "gap_loss"])
    p.add_argument("--mutual_check", type=_parse_bool, default=d.mutual_check)
    p.add_argument("--k", type=_parse_k, default=d.k)
    p.add_argument("--l", type=int, default=d.L)
    p.add_argument("--descriptor", type=str, default=d.descriptor,
                   choices=["FPFH", "FPFH_gloabal", "FPFH_only",
                            "pointnet", "pointnetmsg"])
    p.add_argument("--keypoints", type=str, default=d.keypoints)
    p.add_argument("--ensure_kpts_num", type=_parse_bool,
                   default=d.ensure_kpts_num)
    p.add_argument("--max_keypoints", type=int, default=d.max_keypoints)
    p.add_argument("--dataset", type=str, default=d.dataset)
    p.add_argument("--resume_model", type=str, default=d.resume_model)
    p.add_argument("--train_path", type=str, default=d.train_path)
    p.add_argument("--keypoints_path", type=str, default=d.keypoints_path)
    p.add_argument("--txt_path", type=str, default=d.txt_path)
    p.add_argument("--model_out_path", type=str, default=d.model_out_path)
    p.add_argument("--match_threshold", type=float, default=d.match_threshold)
    p.add_argument("--threshold", type=float, default=d.threshold)
    p.add_argument("--triplet_loss_gamma", type=float,
                   default=d.triplet_loss_gamma)
    p.add_argument("--train_step", type=int, default=d.train_step)

    # eval-only flags of the reference test scripts
    if preset == "test":
        p.add_argument("--visualize", type=_parse_bool, default=False)
        p.add_argument("--vis_line_width", type=float, default=0.2)
        p.add_argument("--calculate_pose", type=_parse_bool, default=True)

    # --- extras (no reference equivalent) ---
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["float32", "bfloat16", "float64"])
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: cuda, cuda:N, or cpu; a CUDA "
                        "device that is absent is an error")
    p.add_argument("--use_kernels", type=_parse_bool, default=d.use_kernels,
                   help="on a CUDA device, run the GNN layers and the "
                        "Sinkhorn through the hand-written kernels")
    p.add_argument("--train_layer", type=_parse_bool, default=d.train_layer,
                   help="train: each GNN layer (MHA + MLP + batch-stat BN + "
                        "residual) through the whole-layer train kernels; "
                        "false = fused-MHA kernels + plain MLP / BN")
    p.add_argument("--loss_kernel", type=_parse_bool, default=d.loss_kernel,
                   help="gap loss through the margin kernels (forward and "
                        "backward); off by default")
    p.add_argument("--synthetic", type=_parse_bool, default=False,
                   help="generate a synthetic KITTI-format dataset under "
                        "--train_path if keypoints are absent (demo mode)")
    p.add_argument("--prefetch", type=int, default=d.prefetch,
                   help="train-loop batch prefetch depth: a producer "
                        "thread runs disk IO + batch assembly this many "
                        "batches ahead (DataLoader(num_workers) "
                        "equivalent, reference train.py:166-171); "
                        "0 = serial")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="0 = full epoch; >0 truncates (smoke runs)")
    p.add_argument("--max_pairs", type=int, default=0,
                   help="eval: 0 = all pairs, >0 truncates")
    return p


def config_from_args(args, preset: str) -> Config:
    base = train_defaults() if preset == "train" else test_defaults()
    cfg = base.replace(
        sinkhorn_iterations=args.sinkhorn_iterations,
        learning_rate=args.learning_rate,
        epoch=args.epoch,
        memory_is_enough=args.memory_is_enough,
        batch_size=args.batch_size,
        resume=args.resume,
        net=args.net,
        loss_method=args.loss_method,
        mutual_check=args.mutual_check,
        k=args.k,
        L=args.l,
        descriptor=args.descriptor,
        keypoints=args.keypoints,
        ensure_kpts_num=args.ensure_kpts_num,
        max_keypoints=args.max_keypoints,
        dataset=args.dataset,
        resume_model=args.resume_model,
        train_path=args.train_path,
        keypoints_path=args.keypoints_path,
        txt_path=args.txt_path,
        model_out_path=args.model_out_path,
        match_threshold=args.match_threshold,
        threshold=args.threshold,
        triplet_loss_gamma=args.triplet_loss_gamma,
        train_step=args.train_step,
        compute_dtype=args.compute_dtype,
        param_dtype=("float64" if args.compute_dtype == "float64"
                     else "float32"),
        use_kernels=args.use_kernels,
        train_layer=args.train_layer,
        loss_kernel=args.loss_kernel,
        prefetch=args.prefetch,
        seed=args.seed,
    )
    if cfg.net == "raw":
        cfg = cfg.replace(k=None, L=9)  # train.py:130-132
    return cfg


def maybe_generate_synthetic(cfg: Config, args) -> Config:
    """Demo mode: materialize a synthetic KITTI-layout dataset when the
    real keypoint features are absent."""
    if os.path.isdir(cfg.keypoints_path):
        return cfg
    if not args.synthetic:
        raise SystemExit(
            f"keypoints_path not found: {cfg.keypoints_path}\n"
            "Download the USIP/FPFH keypoint features (see reference "
            "README) or pass --synthetic true for a generated dataset.")
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    root = cfg.train_path
    n_points = max(300, cfg.max_keypoints)
    print(f"[synthetic] generating KITTI-format dataset under {root}")
    kp_dir = write_synthetic_kitti(
        root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10), frames_per_seq=12,
        pairs_per_seq=24, n_points=n_points, seed=cfg.seed,
        # the learned-descriptor modes read raw clouds
        cloud_points=(4 * n_points if cfg.descriptor in POINTNET_DESCRIPTORS
                      else 0))
    return cfg.replace(keypoints_path=kp_dir,
                       txt_path=os.path.join(root, "preprocess-random-full"))
