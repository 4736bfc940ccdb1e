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


def process_batch_rows(global_batch: int) -> slice:
    """This rank's contiguous ``[lo, hi)`` block of every global batch: an
    equal share of ``global_batch / W`` rows. A batch that W does not divide
    raises ``ValueError`` (the JAX package falls back to its one-program
    step there; the port has no such fallback)."""
    world, rank = process_count(), process_index()
    if global_batch % world:
        raise ValueError(
            f"batch_size {global_batch} is not a multiple of the {world} "
            "ranks: every rank needs an equal share of each global batch")
    share = global_batch // world
    return slice(rank * share, (rank + 1) * share)


def eval_pair_range(n_total: int, max_pairs: int = 0, batch_size: int = 1):
    """This rank's contiguous ``[lo, hi)`` block of the eval pair list.

    ``max_pairs`` (the CLI cap) applies to the global prefix first, rounded
    up to whole batches of ``batch_size``: the one-process loops check the
    cap only after finishing a batch, so they evaluate ``ceil(max_pairs /
    batch_size) * batch_size`` pairs, and the merged aggregates must cover
    the same pairs."""
    if max_pairs:
        total = min(n_total, -(-max_pairs // batch_size) * batch_size)
    else:
        total = n_total
    p, n = process_index(), process_count()
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
