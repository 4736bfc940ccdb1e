"""One rank of the port's data- and context-parallel steps, on the CPU over
gloo (spawned by ``test_torch_parallel.py`` and
``test_torch_seq_parallel.py``; imports no JAX).

    python torch_parallel_worker.py <rank> <world> <port> <spec.pt> <out.pt> [S]

``S`` (default 1) is the seq axis: the ranks form ``world / S`` data rows of
S members (``parallel.data_parallel_group(device, S)``). ``spec.pt``
(``torch.save``) is a dict of runs, each ``{"config": train config
overrides, "state_dict": the starting weights, "lr": Adam's rate,
"batches": [global batches of model inputs]}``, the ground truth formed on
the whole clouds. A training run builds the train state from the weights,
broadcasts it from rank 0 (``parallel.replicate``), and takes one step on
its rows (``parallel.process_batch_rows``) and, under a seq axis, its
keypoint block (``parallel.shard_batch(..., seq_block=...)``) of each
global batch. A run with ``"eval": True`` instead runs the eval step
(``train.make_eval_step(model, seq_group)``) on the same share of each
batch. It writes, per run, the metrics of each step (the eval outputs), the
collectives of each step by kind, and the final state dict to
``out.pt.<rank>``. A run ``{"gather": {"shapes": [...], "seed": n}}`` instead
gathers this rank's seeded float64 blocks of those shapes (and a boolean
block) over its seq group (``parallel.all_gather``) and takes the gradient
of a seeded linear function of the result (:func:`gather_case`).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def gather_blocks(shapes, seed, rank):
    """Rank ``rank``'s float64 blocks of ``shapes``, and the generator that
    then draws the weights of its linear loss and its boolean block."""
    g = torch.Generator().manual_seed(seed + rank)
    xs = [torch.randn(s, generator=g, dtype=torch.float64) for s in shapes]
    return xs, g


def gather_case(case, group):
    """The gathered tensors, the gradients of ``sum(w_i * y_i)`` in this
    rank's blocks, and the collectives, for the closed form in the test."""
    from mdgat_tpu_torch.parallel import all_gather, collective_counts
    collective_counts.clear()
    xs, g = gather_blocks(case["shapes"], case["seed"], group.rank)
    xs = [x.requires_grad_() for x in xs]
    ys = all_gather(xs, group.seq_group, "case")
    ws = [torch.randn(y.shape, generator=g, dtype=torch.float64) for y in ys]
    sum((w * y).sum() for w, y in zip(ws, ys)).backward()
    mask = torch.rand(case["shapes"][0][:2], generator=g,
                      dtype=torch.float64) < 0.5
    return dict(ys=[y.detach() for y in ys], grads=[x.grad for x in xs],
                mask=all_gather(mask, group.seq_group, "case_mask"),
                counts=dict(collective_counts))


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec_path, out_path = sys.argv[4:6]
    seq = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.parallel import (collective_counts,
                                          data_parallel_group,
                                          initialize_distributed,
                                          process_batch_rows, replicate,
                                          shard_batch)
    from mdgat_tpu_torch.train import (create_train_state, make_eval_step,
                                       make_train_step)

    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, "gloo")
    group = data_parallel_group("cpu", seq)
    block = (group.seq_index, seq) if seq > 1 else None
    spec = torch.load(spec_path, weights_only=False)
    results = {}
    for name, run in spec.items():
        if "gather" in run:
            results[name] = gather_case(run["gather"], group)
            continue
        cfg = train_defaults(**run["config"])
        state = create_train_state(cfg, device="cpu", learning_rate=run["lr"],
                                   state_dict=run["state_dict"])
        replicate(state.model, group)
        step = (make_eval_step(state.model, group.seq_group)
                if run.get("eval") else make_train_step(group))
        metrics, counts = [], []
        for batch in run["batches"]:
            rows = process_batch_rows(len(batch["keypoints0"]), seq)
            collective_counts.clear()
            mine = shard_batch(batch, rows, seq_block=block)
            if run.get("eval"):
                metrics.append({k: v.clone() for k, v in step(mine).items()})
            else:
                state, m = step(state, mine)
                metrics.append({k: float(v) for k, v in m.items()})
            counts.append(dict(collective_counts))
        results[name] = dict(metrics=metrics, counts=counts,
                             state=state.model.state_dict())
    torch.save(results, f"{out_path}.{rank}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
