"""One rank of the port's data-parallel training step, on the CPU over gloo
(spawned by ``test_torch_parallel.py``; imports no JAX).

    python torch_parallel_worker.py <rank> <world> <port> <spec.pt> <out.pt>

``spec.pt`` (``torch.save``) is a dict of runs, each ``{"config": train
config overrides, "state_dict": the starting weights, "lr": Adam's rate,
"batches": [global batches of model inputs]}``. For every run the rank
builds the train state from the weights, broadcasts it from rank 0
(``parallel.replicate``), and takes one data-parallel step on its rows of
each global batch (``parallel.process_batch_rows`` / ``shard_batch``). It
writes, per run, the metrics of each step, the collectives of each step by
kind, and the final state dict to ``out.pt.<rank>``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec_path, out_path = sys.argv[4:6]
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.parallel import (collective_counts,
                                          data_parallel_group,
                                          initialize_distributed,
                                          process_batch_rows, replicate,
                                          shard_batch)
    from mdgat_tpu_torch.train import create_train_state, make_train_step

    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, "gloo")
    group = data_parallel_group("cpu")
    spec = torch.load(spec_path, weights_only=False)
    results = {}
    for name, run in spec.items():
        cfg = train_defaults(**run["config"])
        state = create_train_state(cfg, device="cpu", learning_rate=run["lr"],
                                   state_dict=run["state_dict"])
        replicate(state.model, group)
        step = make_train_step(group)
        metrics, counts = [], []
        for batch in run["batches"]:
            rows = process_batch_rows(len(batch["keypoints0"]))
            collective_counts.clear()
            state, m = step(state, shard_batch(batch, rows))
            metrics.append({k: float(v) for k, v in m.items()})
            counts.append(dict(collective_counts))
        results[name] = dict(metrics=metrics, counts=counts,
                             state=state.model.state_dict())
    torch.save(results, f"{out_path}.{rank}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
