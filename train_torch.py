#!/usr/bin/env python3
"""Training entry point of the PyTorch + CUDA port (counterpart of
``train.py``, with the reference-compatible CLI).

Trains MDGAT on KITTI keypoint pairs (or, with ``--synthetic true``, on a
generated dataset in the same layout) with the gap loss, validating on seq 9
each epoch, checkpointing per epoch with the reference's run-name scheme and
best-model naming, and logging the same scalars (``Train/val_loss``,
``Train/epoch_loss``).

    python3 train_torch.py --synthetic true --train_path /tmp/kd/ \\
        --device cpu --epoch 2 --batch_size 8 --max_keypoints 64

The model runs on ``--device`` (``cuda`` by default; a CUDA device that is
absent is an error, nothing carries on on the CPU). Host batches are
assembled a few ahead on a thread (``--prefetch``); descriptor normalisation
and the ground-truth correspondences run on the device; losses stay on the
device until the epoch ends.

Data-parallel training: W processes, one rank and one device each, started
by ``torchrun --nproc_per_node W train_torch.py ...`` or with
``--coordinator_address host:port --num_processes W --process_id r`` on each.
Every rank loads its ``batch_size / W`` rows of each global batch and runs
``parallel/smap.py``'s step (global BatchNorm statistics, averaged
gradients); the validation loss is averaged over the ranks, so every rank
takes the same best-model decision, and rank 0 alone writes the logs and
the checkpoints.

    python3 train_torch.py --synthetic true --train_path /tmp/kd/ \
        --device cpu --batch_size 8 --coordinator_address 127.0.0.1:29500 \
        --num_processes 2 --process_id 0      # and --process_id 1

Context parallelism: with ``--seq_parallel S`` the W ranks form ``W / S``
data rows of S members. The members of a row load the row's pairs whole
(the ground truth is formed on the whole clouds), keep their block of
``max_keypoints / S`` keypoints, and run the seq arm of the same step;
validation runs on the same layout. A keypoint count S does not divide is
refused before the first step (the JAX package warns and trains without
shard_map instead).
"""

import os
import time

import numpy as np


def resolve_resume(cfg, device):
    """Start a train state from ``cfg.resume_model`` with the reference's
    semantics (``train.py:159-164,202-204``): a fresh Adam at the
    *checkpointed* ``lr_schedule`` (not the CLI lr), ``best_loss`` reset to
    1; Adam moments are NOT restored. Takes a training ``.pth`` (the port's,
    the reference's, or the JAX package's ``save_pth_checkpoint``) or the
    JAX package's ``.npz``.

    Returns ``(state, meta, best_loss)``.
    """
    from mdgat_tpu_torch.core.checkpoint import (load_npz,
                                                 load_train_checkpoint,
                                                 state_dict_from_numpy)
    from mdgat_tpu_torch.train import create_train_state
    if cfg.resume_model.endswith(".pth"):
        state = create_train_state(cfg, device=device, seed=cfg.seed)
        meta = load_train_checkpoint(cfg.resume_model, state,
                                     fresh_optimizer=True)
    else:
        params, bn_state, meta = load_npz(cfg.resume_model)
        state = create_train_state(
            cfg, device=device, learning_rate=float(meta["lr_schedule"]),
            state_dict=state_dict_from_numpy(params, bn_state, cfg))
    return state, meta, 1.0


def _mean_loss(losses, empty: float) -> float:
    """Mean of 0-dim device tensors, read back in one copy."""
    import torch
    if not losses:
        return empty
    return float(np.mean(torch.stack(losses).cpu().numpy()))


def main(argv=None):
    """Run the training loop; returns a summary of what it did: per-epoch
    losses, checkpoint paths, steps and the wall time of each epoch's train
    loop (synchronised at the epoch end), the phase timer's summary and the
    final ``TrainState``."""
    from mdgat_tpu_torch.cli import build_parser, debugging
    args = build_parser("train").parse_args(argv)
    with debugging(args):
        return _run(args)


def _run(args):
    from mdgat_tpu_torch.cli import (config_from_args,
                                     maybe_generate_synthetic, nan_guard,
                                     require_finite, setup_distributed)
    cfg = config_from_args(args, "train")

    import torch
    from mdgat_tpu_torch.core.checkpoint import save_train_checkpoint
    from mdgat_tpu_torch.data.pipeline import (SparseDataset, model_inputs,
                                               prepare_batch)
    from mdgat_tpu_torch.data.prefetch import prefetch_batches
    from mdgat_tpu_torch.models.mdgat import torch_dtype
    from mdgat_tpu_torch.parallel import (all_reduce, process_batch_rows,
                                          replicate, shard_batch)
    from mdgat_tpu_torch.train import (create_train_state, make_eval_step,
                                       make_train_step)
    from mdgat_tpu_torch.utils import PhaseTimer, ScalarLogger

    device, group = setup_distributed(cfg, args)
    # host-side side effects (logs, checkpoints) belong to rank 0; every
    # rank holds the same state and metrics
    primary = group is None or group.rank == 0
    # each data row's contiguous rows of every global batch (D must divide
    # it) and, under a seq axis, this member's block of the keypoints
    batch_rows, seq_block, seq_group = None, None, None
    if group is not None:
        batch_rows = process_batch_rows(cfg.batch_size, seq=group.seq)
        if group.seq > 1:
            seq_block, seq_group = (group.seq_index, group.seq), group.seq_group
    cfg = maybe_generate_synthetic(cfg, args)

    log_path = cfg.run_dir("./logs")
    model_out_path = cfg.run_dir(cfg.model_out_path)
    if primary:
        os.makedirs(log_path, exist_ok=True)
        os.makedirs(model_out_path, exist_ok=True)
    print(f"Train {cfg.net} | k={cfg.k} | descriptor={cfg.descriptor} | "
          f"loss={cfg.loss_method} | dataset={cfg.dataset}\n"
          f"model_out_path: {model_out_path}\nlog_path: {log_path}")

    start_epoch, best_loss = 1, 1e6
    if cfg.resume:
        state, meta, best_loss = resolve_resume(cfg, device)
        lr = state.optimizer.param_groups[0]["lr"]
        print(f"Resume from {cfg.resume_model} at epoch {meta['epoch']}, "
              f"loss {meta['loss']:.4f}, lr {lr}")
    else:
        state = create_train_state(cfg, device=device, seed=cfg.seed)
    if group is not None:
        replicate(state.model, group)
    if args.debug_nans:
        nan_guard(state.model)      # every forward: train and validation

    train_set = SparseDataset(cfg, "train")
    val_set = SparseDataset(cfg, "val")
    compute_dtype = torch_dtype(cfg.compute_dtype)
    gt_dtype = (torch.float64 if cfg.compute_dtype == "float64"
                else torch.float32)

    def prepare(batch):
        # the ground truth of the whole clouds, then this member's block
        return shard_batch(model_inputs(prepare_batch(
            batch, cfg.threshold, cfg.mutual_check, device, compute_dtype,
            gt_dtype)), seq_block=seq_block)

    train_step = make_train_step(group)
    eval_step = make_eval_step(state.model, seq_group)
    timer = PhaseTimer()
    logger = ScalarLogger(log_path) if primary else None
    summary = {"epoch_loss": [], "val_loss": [], "checkpoints": [],
               "steps": [], "train_loop_s": []}
    print(f"device: {device} | use_kernels: {cfg.use_kernels} | train_layer: "
          f"{cfg.train_layer} | loss_kernel: {cfg.loss_kernel} | "
          f"train pairs: {len(train_set)} | val pairs: {len(val_set)}")

    try:
        for epoch in range(start_epoch, cfg.epoch + 1):
            t_epoch = time.time()
            step_losses = []
            t_loop = time.perf_counter()
            # producer-thread batch prefetch (host IO / assembly overlaps
            # the asynchronous device steps: the reference's
            # DataLoader(num_workers=1), train.py:166-171); its exceptions
            # surface in this loop
            for batch in prefetch_batches(
                    lambda: train_set.batches(cfg.batch_size, shuffle=True,
                                              seed=cfg.seed + epoch,
                                              rows=batch_rows),
                    cfg.prefetch):
                with timer("prepare"):
                    prepared = prepare(batch)
                with timer("train_step"):
                    # losses stay on the device until the epoch ends: no
                    # per-step readback
                    state, metrics = train_step(state, prepared)
                    if args.debug_nans:
                        require_finite(metrics, "train step")
                step_losses.append(metrics["loss"])
                if (args.steps_per_epoch
                        and len(step_losses) >= args.steps_per_epoch):
                    break
            epoch_loss = _mean_loss(step_losses, 0.0)   # waits for the steps
            summary["train_loop_s"].append(time.perf_counter() - t_loop)
            summary["steps"].append(len(step_losses))

            # validation (reference: every epoch on seq 9, train.py:263-285)
            val_losses = []
            for batch in prefetch_batches(
                    lambda: val_set.batches(cfg.batch_size, shuffle=False,
                                            rows=batch_rows),
                    cfg.prefetch):
                with timer("validation"):
                    val_losses.append(eval_step(prepare(batch))["loss"].mean())
                if args.steps_per_epoch and len(val_losses) >= max(
                        1, args.steps_per_epoch // 4):
                    break
            if group is not None and val_losses:
                # each rank's batches hold its data row's rows (its seq
                # members hold the same losses): the mean over the ranks is
                # the global batches' mean, and every rank takes the same
                # best-model decision on it
                mine = torch.stack(val_losses).mean()
                val_losses = [all_reduce(mine, group.group, "val_loss")
                              / group.world]
            mean_val_loss = _mean_loss(val_losses, float("inf"))
            dt = time.time() - t_epoch
            print(f"Epoch [{epoch}/{cfg.epoch}] {dt:.1f}s | epoch_loss "
                  f"{epoch_loss:.4f} | val_loss {mean_val_loss:.4f} | "
                  f"best {best_loss:.4f}")

            if mean_val_loss <= best_loss + 1e-5:
                best_loss = mean_val_loss
                out_file = (f"{model_out_path}/best_model_epoch_{epoch}"
                            f"(val_loss{best_loss}).pth")
            else:
                out_file = f"{model_out_path}/model_epoch_{epoch}.pth"
            if primary:
                # all five reference checkpoint fields, the optimizer state
                # and the current lr included (train.py:288-294)
                save_train_checkpoint(out_file, state, epoch=epoch,
                                      loss=mean_val_loss)
                print(f"Checkpoint saved to {out_file}")
                logger.add_scalar("Train/val_loss", mean_val_loss, epoch)
                logger.add_scalar("Train/epoch_loss", epoch_loss, epoch)
                summary["checkpoints"].append(out_file)
            summary["epoch_loss"].append(epoch_loss)
            summary["val_loss"].append(mean_val_loss)
    finally:
        if logger is not None:
            logger.close()

    print(timer.report())
    summary["timer"] = timer.summary()
    summary["state"] = state
    return summary


if __name__ == "__main__":
    main()
