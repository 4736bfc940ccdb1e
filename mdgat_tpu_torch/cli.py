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
(``core/config.py``); ``--pallas_exact_topk`` keeps its JAX name, type and
default and picks the attention kernel's selection arm. ``--trace_dir``
and ``--debug_nans`` keep their JAX names, types and defaults: a
``torch.profiler`` trace of the run, and autograd's anomaly mode with a
finiteness check of every step and forward (:func:`debugging`). Its
multi-process flags (``--coordinator_address``,
``--num_processes``, ``--process_id``) run the entry points as one rank a
process (:func:`setup_distributed`), with ``--dist_backend`` naming the
``torch.distributed`` backend, and ``--seq_parallel S`` (the JAX name and
default) lays the ranks out as ``W / S`` data rows of S seq members whose
ranks split each pair's keypoints (context parallelism). The flags that
steer JAX, the TPU or one process over several devices are not ported;
``--help`` lists them in its epilog. One process over several devices is
``Matcher(data_parallel=N, seq_parallel=M)``'s (``api.py``); the CLIs keep
one device a rank, and torchrun starts the ranks.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os

from mdgat_tpu_torch.core.config import (POINTNET_DESCRIPTORS, Config,
                                         test_defaults, train_defaults)

_EPILOG = ("Flags of the JAX package that are not ported (they steer JAX, "
           "the TPU or one process over several devices; in the port one "
           "rank is one device): --platform, --data_parallel, "
           "--shard_map, --use_pallas, --pallas_attention, "
           "--pallas_train_layer, --pallas_loss, --pallas_interpret, "
           "--scan_gnn_pairs, --ship_bf16.")


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
                   choices=["mdgat", "superglue", "raw", "lightglue"])
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
    p.add_argument("--pallas_exact_topk", type=_parse_bool,
                   default=d.exact_topk,
                   help="kernel routes: bit-exact top-k selection in the "
                        "attention kernel; false = its value bisection, "
                        "which keeps the top k and possibly near ties (the "
                        "plain route is exact either way)")
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
    p.add_argument("--coordinator_address", type=str,
                   default=d.coordinator_address,
                   help="multi-process: rank 0's 'host:port'; with "
                        "--num_processes / --process_id this process joins "
                        "as one rank with one device. Empty = one process, "
                        "unless a torchrun environment is set")
    p.add_argument("--num_processes", type=int, default=d.num_processes)
    p.add_argument("--process_id", type=int, default=d.process_id)
    p.add_argument("--seq_parallel", type=int, default=d.seq_parallel,
                   help="multi-process: ranks per data row; the S members "
                        "of a row split each pair's keypoints (context "
                        "parallelism). S must divide the ranks and the "
                        "keypoint count (--max_keypoints, or 128 for "
                        "variable-size clouds)")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of a multi-process run; "
                        "default nccl on a CUDA device, gloo on the CPU")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--debug_nans", type=_parse_bool, default=False,
                   help="autograd anomaly detection (NaN provenance) and a "
                        "finiteness check of every train step's loss and "
                        "grad_norm and every forward's scores: a non-finite "
                        "value raises FloatingPointError (slow: each check "
                        "reads a value back)")
    p.add_argument("--trace_dir", type=str, default="",
                   help="write a torch.profiler trace of the run here "
                        "(Chrome format, one file a rank)")
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
        exact_topk=args.pallas_exact_topk,
        prefetch=args.prefetch,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
        seq_parallel=args.seq_parallel,
        seed=args.seed,
        # --debug_nans reads values back in every forward and step: eager
        cuda_graphs=not args.debug_nans,
    )
    if cfg.net == "lightglue":
        raise ValueError("--net lightglue: no LightGlue loss or eval pipeline "
                         "is ported; serve it with Matcher(net='lightglue')")
    if cfg.net == "raw":
        cfg = cfg.replace(k=None, L=9)  # train.py:130-132
    return cfg


def check_seq_layout(cfg: Config):
    """Refuse, before the first step, a ``seq_parallel`` the keypoint axis
    cannot take: S must divide ``max_keypoints`` (fixed-size clouds) or the
    128 of the variable-size buckets, and ``FPFH_gloabal`` (whose encoder
    pools over the whole cloud) takes no seq axis. The JAX package warns
    and runs without shard_map there; the port raises ``ValueError``."""
    s = cfg.seq_parallel
    if s == 1:
        return
    grain = cfg.max_keypoints if cfg.ensure_kpts_num else 128
    if s < 1 or grain % s:
        what = ("--max_keypoints" if cfg.ensure_kpts_num
                else "the 128 of the variable-size buckets")
        raise ValueError(f"--seq_parallel {s} does not divide {what} "
                         f"({grain}): set --max_keypoints / --seq_parallel so "
                         "that every seq member holds an equal block")
    if cfg.descriptor == "FPFH_gloabal":
        raise ValueError("--descriptor FPFH_gloabal pools over the whole "
                         "cloud: it cannot run with --seq_parallel > 1")


def setup_distributed(cfg: Config, args):
    """Join the multi-process run the flags (or a torchrun environment)
    describe, before the first device use. Returns ``(device, group)``:
    this rank's device (``parallel/multihost.py::rank_device``) and its
    ``parallel.DataParallelGroup`` over ``W / S`` data rows of
    ``cfg.seq_parallel`` members, or ``--device`` and None for one
    process. A seq layout the ranks or the keypoints cannot take raises
    ``ValueError`` (:func:`check_seq_layout`)."""
    import torch
    from mdgat_tpu_torch.parallel import (data_parallel_group,
                                          initialize_distributed, rank_device)
    check_seq_layout(cfg)
    backend = args.dist_backend or (
        "gloo" if torch.device(args.device).type == "cpu" else "nccl")
    if not initialize_distributed(cfg.coordinator_address, cfg.num_processes,
                                  cfg.process_id, backend):
        data_parallel_group(args.device, cfg.seq_parallel)  # S > 1 raises
        return torch.device(args.device), None
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # NCCL's communicator binds to it
    group = data_parallel_group(device, cfg.seq_parallel)
    print(f"multi-process: rank {group.rank}/{group.world}, device {device}, "
          f"backend {backend}")
    print(f"rank {group.rank}/{group.world} (data {group.data_index}/"
          f"{group.data}, seq {group.seq_index}/{group.seq})")
    return device, group


@contextlib.contextmanager
def debugging(args):
    """``--debug_nans`` and ``--trace_dir`` around an entry point's run,
    where the JAX package's ``setup_jax`` turns on ``jax_debug_nans`` and
    starts a ``jax.profiler`` trace. ``--trace_dir DIR``: a
    ``torch.profiler`` window (the CPU, and CUDA where the machine has it)
    from before the first step to the run's end, written to
    ``DIR/trace_rank{r}.json`` (Chrome trace format, ``r`` this process's
    rank) when the run returns or raises; the JAX package stops its trace
    at exit, the port at the end of ``main``, so that an in-process caller
    finds its file. Beside the operators, kernels and copies the file holds
    the program's spans (``utils/profiling.py::span``, ``user_annotation``
    events on the main thread; shapes are recorded so that an entry span
    carries its call's identifier in ``Concrete Inputs``, and the spans of
    one call lie inside its entry span): ``mdgat.entry.train_step`` (a
    train step, by the state's step), ``mdgat.entry.eval_batch`` (an eval
    pipeline iteration, by batch index) and ``mdgat.entry.eval_step`` (its
    forward); ``mdgat.data.wait`` (waiting on the loader thread),
    ``mdgat.data.prepare`` (a batch's device preprocessing) with
    ``mdgat.data.pin`` (pinned staging and the enqueued copies) and
    ``mdgat.data.ground_truth``, ``mdgat.data.readback`` (answers read
    back to the host); ``mdgat.graphs.warm_up`` / ``capture`` / ``replay``
    (a step's eager first call, its CUDA-graph capture, each replay with
    its input copies and output clones). ``--debug_nans``: autograd's
    anomaly mode for the run (the backward's NaNs name the function that
    made them); the entry points add :func:`nan_guard` and
    :func:`require_finite`. Both are put back as they were when the run
    ends."""
    import torch
    anomaly = torch.is_anomaly_enabled()
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    profiler = None
    if args.trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities,
                                          record_shapes=True)
        profiler.start()
    try:
        yield
    finally:
        if profiler is not None:
            from mdgat_tpu_torch.parallel.multihost import process_index
            profiler.stop()
            os.makedirs(args.trace_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(
                args.trace_dir, f"trace_rank{process_index()}.json"))
        torch.autograd.set_detect_anomaly(anomaly)


# the forward outputs --debug_nans holds finite
CHECKED_OUTPUTS = ("scores", "matching_scores0", "matching_scores1", "loss")


def require_finite(values, what: str):
    """Raise ``FloatingPointError`` (what ``jax_debug_nans`` raises) when a
    floating-point tensor among ``values`` (a dict) holds a NaN or an
    infinity. Reads the values back: ``--debug_nans`` only."""
    import torch
    for name, v in values.items():
        if (isinstance(v, torch.Tensor) and v.is_floating_point()
                and not bool(torch.isfinite(v).all())):
            raise FloatingPointError(f"--debug_nans: {what}: {name} is not "
                                     "finite")


def nan_guard(model):
    """Hold every forward of ``model`` to :func:`require_finite` over its
    scores, matching scores and loss (a forward hook)."""
    def hook(module, inputs, out):
        require_finite({k: out[k] for k in CHECKED_OUTPUTS if k in out},
                       "forward")
    model.register_forward_hook(hook)


def maybe_generate_synthetic(cfg: Config, args) -> Config:
    """Demo mode: materialize a synthetic KITTI-layout dataset when the
    real keypoint features are absent. In a multi-process run the ranks
    share one file system: rank 0 writes, the others wait for it."""
    from mdgat_tpu_torch.parallel.multihost import host_barrier, is_primary
    present = os.path.isdir(cfg.keypoints_path)
    host_barrier()          # every rank has looked before rank 0 writes
    if present:
        return cfg
    if not args.synthetic:
        raise SystemExit(
            f"keypoints_path not found: {cfg.keypoints_path}\n"
            "Download the USIP/FPFH keypoint features (see reference "
            "README) or pass --synthetic true for a generated dataset.")
    from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
    root = cfg.train_path
    n_points = max(300, cfg.max_keypoints)
    kp_dir = os.path.join(root, "keypoints", "synthetic")
    if is_primary():
        print(f"[synthetic] generating KITTI-format dataset under {root}")
        write_synthetic_kitti(
            root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10), frames_per_seq=12,
            pairs_per_seq=24, n_points=n_points, seed=cfg.seed,
            # the learned-descriptor modes read raw clouds
            cloud_points=(4 * n_points
                          if cfg.descriptor in POINTNET_DESCRIPTORS else 0))
    host_barrier()
    return cfg.replace(keypoints_path=kp_dir,
                       txt_path=os.path.join(root, "preprocess-random-full"))
