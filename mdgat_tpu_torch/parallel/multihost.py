"""Several processes, one rank each: joining the run, and what each rank
feeds and evaluates.

Port of ``mdgat_tpu/parallel/multihost.py``. JAX runs one process per host
and every process sees the global device list; here a process is one rank
of a ``torch.distributed`` group and owns one device
(:func:`rank_device`). What stays per process is the same as there: a
training rank loads only its contiguous block of every global batch
(:func:`process_batch_rows`), an eval rank evaluates a contiguous block of
the pair list (:func:`eval_pair_range`), and host-side per-pair records
are gathered in rank order (:func:`allgather_host_vector`) so rank 0 can
print the aggregates of the whole run.

The ranks form the JAX package's ``(data, seq)`` mesh, rows major
(``mdgat_tpu/parallel/mesh.py``'s device grid, one device a rank): with a
``seq`` axis of S ranks, rank ``r`` is data row ``d = r // S`` and seq
member ``s = r % S`` of ``D = W / S`` rows (:func:`mesh_coords`). The rows
split the batch rows and the eval pairs; the members of a row split the
keypoint axis of the row's pairs into S contiguous blocks
(:func:`seq_columns`).

The process group is ``torch.distributed``'s, a process-wide state: one
run, one group, as ``jax.distributed`` is process-wide. Host vectors travel
over a ``gloo`` group made for them when the run joins, so they do not
depend on the backend that carries the device tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

# the gloo group of host vectors, made by initialize_distributed (a new
# group is a collective call: every rank makes it at the same point)
_host_group = None


def initialize_distributed(coordinator_address: str = "",
                           num_processes: int = 0, process_id: int = -1,
                           backend: str = "gloo") -> bool:
    """Join (or skip) a multi-process run. Call before the first device use.

    With ``coordinator_address`` (``host:port``) this process becomes rank
    ``process_id`` of ``num_processes`` through
    ``init_process_group(backend, init_method="tcp://host:port")``. With
    none, a torchrun environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    set) is joined through ``env://``, as the JAX package auto-detects when
    ``JAX_COORDINATOR_ADDRESS`` is set; otherwise the run stays one process.
    Returns True when more than one process takes part."""
    global _host_group
    if coordinator_address:
        if num_processes < 1 or process_id < 0:
            raise SystemExit(
                "--coordinator_address requires --num_processes >= 1 and "
                f"--process_id >= 0 (got num_processes={num_processes}, "
                f"process_id={process_id})")
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    else:
        return False
    _host_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo"))
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that owns host-side side effects (checkpoints, logs,
    the eval aggregates)."""
    return process_index() == 0


def rank_device(requested: str = "cuda") -> torch.device:
    """The device of this rank. ``requested`` is the CLI's ``--device``: a
    CPU device, or a CUDA device with an explicit index, is taken as it is;
    a bare ``cuda`` is ``cuda:{LOCAL_RANK}`` under torchrun and ``cuda:{rank
    % device_count}`` otherwise (ranks launched by hand on one host)."""
    dev = torch.device(requested)
    if dev.type != "cuda" or dev.index is not None or process_count() == 1:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local))
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"--device {requested}: no CUDA device")
    return torch.device("cuda", process_index() % count)


def mesh_coords(seq: int = 1):
    """``(D, S, d, s)``: the data rows and seq members of the run's rank
    layout, and this rank's row and member (``rank = d * S + s``). A seq
    size that does not divide the ranks raises ``ValueError``."""
    world, rank = process_count(), process_index()
    if seq < 1 or world % seq:
        raise ValueError(
            f"--seq_parallel {seq} does not divide the {world} ranks: the "
            "ranks form (W / S) data rows of S seq members")
    return world // seq, seq, rank // seq, rank % seq


def process_batch_rows(global_batch: int, seq: int = 1) -> slice:
    """This rank's contiguous ``[lo, hi)`` block of every global batch: its
    data row's equal share of ``global_batch / D`` rows (the seq members of
    a row hold the same rows). A batch that D does not divide raises
    ``ValueError`` (the JAX package falls back to its one-program step
    there; the port has no such fallback)."""
    rows, _, d, _ = mesh_coords(seq)
    if global_batch % rows:
        what = (f"{rows} ranks" if seq == 1
                else f"{rows} data rows of the {rows * seq} ranks")
        raise ValueError(
            f"batch_size {global_batch} is not a multiple of the {what}: "
            "every rank needs an equal share of each global batch")
    share = global_batch // rows
    return slice(d * share, (d + 1) * share)


def seq_columns(n: int, seq: int = 1, index: Optional[int] = None) -> slice:
    """Seq member ``index``'s (default: this rank's) contiguous block of a
    keypoint axis of ``n`` columns: ``n / S`` of them. A count that S does
    not divide raises ``ValueError`` (the JAX package warns and runs
    without shard_map there; the port has no such fallback)."""
    if seq < 1 or n % seq:
        raise ValueError(
            f"a keypoint axis of {n} is not a multiple of --seq_parallel "
            f"{seq}: set --max_keypoints (or, for variable-size clouds, "
            "--seq_parallel) so that S divides the keypoint count")
    if index is None:
        index = mesh_coords(seq)[3]
    block = n // seq
    return slice(index * block, (index + 1) * block)


def eval_pair_range(n_total: int, max_pairs: int = 0, batch_size: int = 1,
                    seq: int = 1):
    """This rank's contiguous ``[lo, hi)`` block of the eval pair list:
    its data row's block, which every seq member of the row takes.

    ``max_pairs`` (the CLI cap) applies to the global prefix first, rounded
    up to whole batches of ``batch_size``: the one-process loops check the
    cap only after finishing a batch, so they evaluate ``ceil(max_pairs /
    batch_size) * batch_size`` pairs, and the merged aggregates must cover
    the same pairs."""
    if max_pairs:
        total = min(n_total, -(-max_pairs // batch_size) * batch_size)
    else:
        total = n_total
    n, _, p, _ = mesh_coords(seq)
    return p * total // n, (p + 1) * total // n


def allgather_host_vector(vec) -> List[np.ndarray]:
    """Every rank's 1-D float64 host vector, in rank order. Lengths may
    differ: they are gathered first, then the payloads padded to the
    longest."""
    vec = np.asarray(vec, np.float64).reshape(-1)
    n = process_count()
    if n == 1:
        return [vec]
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([vec.size], dtype=torch.int64),
                    group=_host_group)
    sizes = [int(s) for s in sizes]
    pad = torch.zeros(max(sizes), dtype=torch.float64)
    pad[:vec.size] = torch.from_numpy(vec)
    out = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(out, pad, group=_host_group)
    return [o[:s].numpy() for o, s in zip(out, sizes)]


def host_barrier():
    """Wait for every rank (on the host group); nothing in one process."""
    if process_count() > 1:
        dist.barrier(group=_host_group)


def host_group() -> Optional[object]:
    """The gloo group of host vectors (None before a multi-process run
    was joined)."""
    return _host_group
