"""Data- and context-parallel execution of the port: one process a rank,
one device a rank, in a ``(data, seq)`` grid (``multihost``), the group and
its counted collectives and gathers (``mesh``), the training step that
reduces across the ranks (``smap``), and one process over a grid of
devices, one thread a replica (``smap.make_eval_runtime`` on ``local``)."""

from mdgat_tpu_torch.parallel.local import LocalGroup
from mdgat_tpu_torch.parallel.mesh import (DataParallelGroup, all_gather,
                                           all_reduce, collective_counts,
                                           data_parallel_group, group_size,
                                           replicate, shard_batch)
from mdgat_tpu_torch.parallel.multihost import (allgather_host_vector,
                                                eval_pair_range,
                                                initialize_distributed,
                                                is_primary, mesh_coords,
                                                process_batch_rows,
                                                rank_device, seq_columns)
from mdgat_tpu_torch.parallel.smap import (average_gradients,
                                           make_data_parallel_train_step,
                                           make_eval_runtime)

__all__ = ["DataParallelGroup", "LocalGroup", "all_gather", "all_reduce",
           "allgather_host_vector", "average_gradients", "collective_counts",
           "data_parallel_group", "eval_pair_range", "group_size",
           "initialize_distributed", "is_primary",
           "make_data_parallel_train_step", "make_eval_runtime",
           "mesh_coords", "process_batch_rows", "rank_device", "replicate",
           "seq_columns", "shard_batch"]
