"""The loops a cell runs, by the ``kind`` of its workload file.

* ``train``: ``train_torch.py``'s loop. Host batches come from a seeded
  pool (``collate_pairs`` at set-up) through ``data/prefetch.py`` at the
  configuration's depth; each step is ``prepare_batch`` -> ``model_inputs``
  -> ``make_train_step``'s step, with no readback. Set-up builds the one
  train state and drives it through the window's own feed and call for
  three steps on three distinct batches (the eager first call, the capture,
  a replay); the window goes on with the same objects.
* ``match``: one caller that waits for every reply calls
  ``Matcher.match_batch`` with a batch of ragged pairs from a seeded pool.
* ``eval``: the eval CLIs' pipeline (``eval/runner.py::EvalPipeline``) over
  a seeded pool: ``prepare_batch`` on the device, ``make_eval_step``'s
  forward, answers read back one batch behind.

Every cell warms up and captures its own shape bucket in set-up, measures
for ``--seconds`` (end-to-end metrics) or traces ``trace_iters``
iterations (``--trace 1``, per-layer metrics), then, with the program's
state freed, holds what the timed path produced to the plain reference
(``checks.py``). What belongs to the model's design (its sizes, weights,
reference, readings and work counts) comes from the configuration's
architecture module (``architectures/__init__.py``); the loops read none
of its keys.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_gpu.harness import checks, common, reference, traffic, work
from bench_gpu.harness.common import Readings, Spans
from bench_gpu.harness.devtrace import Profiled
from bench_gpu.harness.weights import make_weights

import mdgat_tpu_torch.api as api
import mdgat_tpu_torch.data.pipeline as pipeline
import mdgat_tpu_torch.data.prefetch as prefetch
import mdgat_tpu_torch.eval.runner as runner
import mdgat_tpu_torch.train.loop as loop
from mdgat_tpu_torch.core.config import test_defaults, train_defaults
from mdgat_tpu_torch.models.factory import build_model
from mdgat_tpu_torch.models.mdgat import torch_dtype

ANSWERS = ("matches0", "matches1", "matching_scores0", "matching_scores1")
FETCH = ANSWERS + ("loss",)
GIB = float(2 ** 30)
# set-up's calls of a serving cell: the eager first call, the capture, a
# replay (a training cell's three steps do the same)
WARM_CALLS = 3


@dataclasses.dataclass
class Run:
    cell: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    # Config fields on top of the configuration's (the CPU tests send the
    # model down the kernel routes' twins with kernel_twins)
    overrides: Dict = dataclasses.field(default_factory=dict)
    # where the configuration's architecture file is found
    folder: Path = common.PKG

    @property
    def traffic(self) -> Dict:
        return self.workload["traffic"]

    @functools.cached_property
    def arch(self):
        return common.architecture(self.config, self.folder)

    @property
    def sizes(self) -> Dict:
        return self.arch.sizes(self.config)

    def weights(self, dev) -> Dict[str, torch.Tensor]:
        return make_weights(self.config, self.seed, dev, self.arch)


def config_fields(run: Run) -> Dict:
    """The program's ``Config`` fields the architecture reads from the
    configuration file, with the run's overrides."""
    return {**run.arch.program_fields(run.config), **run.overrides}


def program_config(run: Run, kind: str):
    base = train_defaults() if kind == "train" else test_defaults()
    return base.replace(**config_fields(run))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    """The device's own count of its memory in use (``cudaMemGetInfo``, as
    nvidia-smi reads it): the CUDA context, the caching allocator's
    reserve, the graphs' pools and anything allocated past the allocator.
    Nothing in the program hands memory back before the window closes
    (no ``empty_cache``), so at the close it is the run's peak."""
    if dev.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(dev)
    return int(total - free)


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Sampler:
    """The latest answer of every pool batch the window finished; at the
    end a seeded choice of ``k`` of them, and the pool's largest batch."""

    def __init__(self, rng: np.random.Generator, k: int, longest: int):
        self.rng, self.k, self.longest = rng, k, longest
        self.latest: Dict[int, object] = {}

    def offer(self, index: int, answer):
        self.latest[index] = answer

    def sample(self):
        done = sorted(self.latest)
        pick = [int(i) for i in self.rng.choice(
            done, size=min(self.k, len(done)), replace=False)]
        if self.longest in self.latest and self.longest not in pick:
            pick.append(self.longest)
        return [(i, self.latest[i]) for i in pick]


def _stop(run: Run, n: int, t0: float) -> bool:
    if run.trace:
        return n >= run.workload["trace_iters"]
    return time.perf_counter() - t0 >= run.seconds


def _readings(run: Run, order: List[int], hosts: List[Dict], train: bool,
              spans: Spans, trace, extra=None) -> Readings:
    """The per-layer readers' view of a window that ran the pool batches
    ``order`` names."""
    summaries = [run.arch.work(run.sizes, h, train) for h in hosts]
    return Readings(trace=trace, spans=dict(spans.seconds),
                    work=work.per_iteration(summaries, order), extra=extra)


def ref_inputs(run: Run, host: Dict, dev, dtype, floor: float = 1e-30):
    x = reference.inputs(host, dev, dtype, floor)
    if "kpts0_world" in x:
        x["gt0"], x["gt1"], x["clear0"], x["clear1"] = \
            reference.ground_truth(x["kpts0_world"], x["kpts1_world"],
                                   run.sizes["threshold"], x["mask0"],
                                   x["mask1"])
    return x


# ------------------------------------------------------------------ train
def train_hosts(run: Run) -> List[Dict]:
    tr = run.traffic
    hosts = [pipeline.collate_pairs(pairs, max_keypoints=tr["max_keypoints"])
             for pairs in traffic.pool_pairs(tr, run.seed)]
    if tr.get("cloud_points"):
        rng = traffic.rng_for(run.seed, 4)
        hosts = [traffic.add_clouds(h, rng, tr["cloud_points"]) for h in hosts]
    return hosts


def train_reference(run: Run, hosts: List[Dict], prec, dev,
                    loss_rows: Optional[int] = None):
    """The reference's three steps on the first three pool batches, from
    the seed's weights: (its results in ``checks.train_readings``' form,
    the starting weights)."""
    start = run.weights(dev)
    xs = [ref_inputs(run, h, dev, prec.dtype) for h in hosts[:3]]
    losses, grads, after = run.arch.reference_train(
        start, run.sizes, xs, prec, run.sizes["learning_rate"], loss_rows)
    return ({"losses": losses, "grads": grads, "after": after,
             "gt": [(x["gt0"], x["gt1"]) for x in xs],
             "clear": [(x["clear0"], x["clear1"]) for x in xs]}, start)


def run_train(run: Run) -> Dict:
    dev = run.device
    cfg = program_config(run, "train")
    hosts = train_hosts(run)
    weights = run.weights(dev)
    state = loop.create_train_state(cfg, device=dev, state_dict=weights)
    del weights
    step = loop.make_train_step()
    spans = Spans(run.trace)
    order: List[int] = []
    cdt = torch_dtype(cfg.compute_dtype)
    gdt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    feed = iter(prefetch.prefetch_batches(
        lambda: ((i, hosts[i]) for i in traffic.cycle(range(len(hosts)))),
        cfg.prefetch))

    def one():
        i, host = next(feed)
        with spans("prepare"):
            x = pipeline.model_inputs(pipeline.prepare_batch(
                host, cfg.threshold, cfg.mutual_check, dev, cdt, gdt))
        with spans("step"):
            _, metrics = step(state, x)
        order.append(i)
        return x, metrics

    params = dict(state.model.named_parameters())
    firsts = [one()]
    opt = state.optimizer.state
    # the first gradient as Adam got it: its first moment over 1 - b1 (no
    # moment where the step gave the optimizer nothing)
    grads = {k: (opt[p]["exp_avg"].detach().double() / 0.1
                 if "exp_avg" in opt.get(p, {})
                 else torch.zeros_like(p, dtype=torch.float64))
             for k, p in params.items()}
    firsts += [one(), one()]
    after = {k: p.detach().clone() for k, p in params.items()}
    prog = {"losses": [m["loss"] for _, m in firsts], "grads": grads,
            "after": after,
            "gt": [(x["gt_matches0"], x["gt_matches1"]) for x, _ in firsts]}
    del firsts
    sync(dev)
    setup_s = time.perf_counter() - run.t_start

    spans.reset()
    order.clear()
    with Profiled(run.trace, dev) as prof:
        sync(dev)
        with prof.window():
            t0 = time.perf_counter()
            n = 0
            while True:
                one()
                n += 1
                if _stop(run, n, t0):
                    break
            sync(dev)
            t1 = time.perf_counter()
    peak = peak_bytes(dev)
    prog["losses"] = [float(v) for v in prog["losses"]]
    feed.close()
    del state, step, params, opt
    free(dev)

    batch = run.traffic["batch"]
    readings = _readings(run, list(order), hosts, True, spans, prof.trace)
    ref, start = train_reference(run, hosts, reference.REFERENCE, dev)
    values = checks.train_readings(prog, ref, start)
    return {"attempted": n, "failed": 0, "peak_bytes": peak,
            "e2e": {"setup_s": setup_s,
                    "train_pairs_per_s": n * batch / (t1 - t0),
                    "peak_gib": peak / GIB},
            "readings": readings, "trace": prof.trace, "values": values,
            "materials": {"hosts": hosts, "prog": prog, "ref": ref,
                          "start": start}}


# ------------------------------------------------------------------ match
def pad_pairs(pairs: List[Dict], bucket: int = 128) -> Dict[str, np.ndarray]:
    """The pairs as ``Matcher`` stacks them, float32: each side zero-padded
    to the batch's largest ``bucket`` multiple, with masks; descriptors as
    given (the reference normalises them)."""
    out = {}
    for side in "01":
        sizes = [len(p["kp" + side]) for p in pairs]
        tgt = max(max(-(-n // bucket) * bucket, bucket) for n in sizes)
        b = len(pairs)
        kp = np.zeros((b, tgt, 3), np.float32)
        de = np.zeros((b, tgt, pairs[0]["desc" + side].shape[1]), np.float32)
        sc = np.zeros((b, tgt), np.float32)
        mk = np.zeros((b, tgt), bool)
        for i, (p, n) in enumerate(zip(pairs, sizes)):
            kp[i, :n], de[i, :n] = p["kp" + side], p["desc" + side]
            sc[i, :n], mk[i, :n] = p["score" + side], True
        out.update({"keypoints" + side: kp, "descriptors" + side: de,
                    "scores" + side: sc, "mask" + side: mk})
    return out


def _answers_from_pairs(outs: List[Dict], n: int, m: int, dev):
    """Per-pair answers of ``match_batch`` stacked to [B, n] / [B, m]."""
    b = len(outs)
    m0 = torch.full((b, n), -1, dtype=torch.long)
    m1 = torch.full((b, m), -1, dtype=torch.long)
    s0 = torch.zeros((b, n), dtype=torch.float64)
    s1 = torch.zeros((b, m), dtype=torch.float64)
    for i, o in enumerate(outs):
        k0, k1 = len(o["matches0"]), len(o["matches1"])
        m0[i, :k0] = torch.as_tensor(o["matches0"].astype(np.int64))
        m1[i, :k1] = torch.as_tensor(o["matches1"].astype(np.int64))
        s0[i, :k0] = torch.as_tensor(o["matching_scores0"].astype(np.float64))
        s1[i, :k1] = torch.as_tensor(o["matching_scores1"].astype(np.float64))
    return m0.to(dev), m1.to(dev), s0.to(dev), s1.to(dev)


def match_reference(run: Run, host: Dict, dev, prec, floor: float,
                    weights=None):
    """The reference's transport, decision, masks, and where the batch has
    world keypoints its ground truth (``gt0`` / ``gt1``, ``clear0`` /
    ``clear1``, ``clear_pair``: the pairs with no point float32 may decide
    either way) and per-pair gap ``loss``, over a stacked host batch in
    blocks of ``reference_block`` pairs."""
    weights = weights if weights is not None else run.weights(dev)
    block = run.workload["reference_block"]
    b = host["mask0"].shape[0]
    parts = []
    for lo in range(0, b, block):
        sub = {k: v[lo:lo + block] for k, v in host.items()
               if isinstance(v, np.ndarray) and v.ndim >= 1
               and v.shape[0] == b}
        x = ref_inputs(run, sub, dev, prec.dtype, floor)
        (dense, br, bc), dec = run.arch.reference_match(weights, run.sizes,
                                                        x, prec)
        parts.append(((dense, br, bc), dec, x))
    cat = lambda i, j: torch.cat([p[i][j] for p in parts])   # noqa: E731
    transport = tuple(cat(0, j) for j in range(3))
    decision = tuple(cat(1, j) for j in range(4))
    masks = (torch.cat([p[2]["mask0"] for p in parts]),
             torch.cat([p[2]["mask1"] for p in parts]))
    gt = None
    if "gt0" in parts[0][2]:
        loss = torch.cat([run.arch.reference_loss(run.sizes, p[0], p[2])
                          for p in parts])
        gt = {k: torch.cat([p[2][k] for p in parts])
              for k in ("gt0", "gt1", "clear0", "clear1")}
        gt["loss"] = loss
        gt["clear_pair"] = gt["clear0"].all(1) & gt["clear1"].all(1)
    return transport, decision, masks, gt


def run_match(run: Run) -> Dict:
    dev = run.device
    tr = run.traffic
    pools = traffic.pool_pairs(tr, run.seed)
    matcher = api.Matcher(device=dev, seed=0, **config_fields(run))
    matcher.model.load_state_dict(run.weights(dev), strict=True)
    spans = Spans(run.trace)
    if run.trace:
        matcher._host_batch = spans.wrap("host_batch", matcher._host_batch)
    totals = [sum(len(p["kp0"]) + len(p["kp1"]) for p in b) for b in pools]
    for i in range(WARM_CALLS):
        matcher.match_batch(pools[i % len(pools)])
    sync(dev)
    setup_s = time.perf_counter() - run.t_start

    spans.reset()
    sampler = Sampler(traffic.rng_for(run.seed, 3), tr["sample_calls"],
                      int(np.argmax(totals)))
    lat, order = [], []
    with Profiled(run.trace, dev) as prof:
        with prof.window():
            t0 = time.perf_counter()
            n = 0
            while True:
                b = n % len(pools)
                t = time.perf_counter()
                with spans("match_batch"):
                    out = matcher.match_batch(pools[b])
                lat.append(time.perf_counter() - t)
                order.append(b)
                sampler.offer(b, out)
                n += 1
                if _stop(run, n, t0):
                    break
            t1 = time.perf_counter()
    peak = peak_bytes(dev)
    del matcher
    free(dev)

    hosts = [pad_pairs(p) for p in pools]
    readings = _readings(run, order, hosts, False, spans, prof.trace)
    weights = run.weights(dev)
    values, sample = [], []
    for b, outs in sampler.sample():
        host = hosts[b]
        transport, _, masks, _ = match_reference(
            run, host, dev, reference.REFERENCE, 1e-12, weights)
        answers = _answers_from_pairs(outs, masks[0].shape[1],
                                      masks[1].shape[1], dev)
        values.append(run.arch.match_readings(run.sizes, answers, masks,
                                              transport))
        sample.append(b)
    batch = tr["batch"]
    return {"attempted": n, "failed": 0, "peak_bytes": peak,
            "e2e": {"setup_s": setup_s,
                    "match_pairs_per_s": n * batch / (t1 - t0),
                    "match_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                    "peak_gib": peak / GIB},
            "readings": readings, "trace": prof.trace,
            "values": checks.merge_max(values),
            "materials": {"hosts": hosts, "sample": sample,
                          "weights": weights, "floor": 1e-12}}


# ------------------------------------------------------------------- eval
def eval_hosts(run: Run) -> List[Dict]:
    tr = run.traffic
    rng = traffic.rng_for(run.seed, 4)
    hosts = []
    for pairs in traffic.pool_pairs(tr, run.seed):
        host = pipeline.collate_pairs(pairs)
        if tr.get("cloud_points"):
            host = traffic.add_clouds(host, rng, tr["cloud_points"])
        hosts.append(traffic.stack_index(host, len(pairs)))
    return hosts


class PoolSource:
    """The pool as ``EvalPipeline`` reads a dataset: batches, over and
    over."""

    def __init__(self, hosts: List[Dict]):
        self.hosts = hosts

    def batches(self, batch_size, shuffle=False, drop_last=False, **kw):
        return traffic.cycle(self.hosts)


def run_eval(run: Run) -> Dict:
    dev = run.device
    tr = run.traffic
    cfg = program_config(run, "eval")
    hosts = eval_hosts(run)
    model = build_model(cfg)
    model.load_state_dict(run.weights(dev), strict=True)
    model.to(dev)
    eval_step = loop.make_eval_step(model)
    spans = Spans(run.trace)
    ids = {id(h): i for i, h in enumerate(hosts)}
    cdt = torch_dtype(cfg.compute_dtype)
    gdt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    order: List[int] = []

    def prepare(batch):
        order.append(ids[id(batch)])
        with spans("prepare"):
            return pipeline.prepare_batch(batch, cfg.threshold,
                                          cfg.mutual_check, dev, cdt, gdt)

    pipe = runner.EvalPipeline(PoolSource(hosts), prepare,
                               spans.wrap("eval_step", eval_step),
                               tr["batch"], fetch=FETCH)
    it = iter(pipe)
    for _ in range(WARM_CALLS):
        next(it)
    sync(dev)
    setup_s = time.perf_counter() - run.t_start

    spans.reset()
    order.clear()
    totals = [int(h["mask0"].sum() + h["mask1"].sum()) for h in hosts]
    sampler = Sampler(traffic.rng_for(run.seed, 3), tr["sample_calls"],
                      int(np.argmax(totals)))
    with Profiled(run.trace, dev) as prof:
        with prof.window():
            t0 = time.perf_counter()
            n = 0
            while True:
                batch, got = next(it)
                sampler.offer(ids[id(batch)], got)
                n += 1
                if _stop(run, n, t0):
                    break
            if run.trace:
                sync(dev)
            t1 = time.perf_counter()
    peak = peak_bytes(dev)
    extra = {}
    if run.trace:
        extra = run.arch.eval_readings(
            model, pipeline.model_inputs(pipeline.prepare_batch(
                hosts[0], cfg.threshold, cfg.mutual_check, dev, cdt, gdt)),
            cdt, dev)
    it.close()
    del model, eval_step, pipe
    free(dev)

    readings = _readings(run, list(order), hosts, False, spans, prof.trace,
                         extra)
    weights = run.weights(dev)
    values, sample = [], []
    for b, got in sampler.sample():
        transport, _, masks, gt = match_reference(
            run, hosts[b], dev, reference.REFERENCE, 1e-30, weights)
        t = {k: torch.as_tensor(v).to(dev) for k, v in got.items()}
        r = run.arch.match_readings(
            run.sizes, tuple(t[k] for k in ANSWERS), masks, transport)
        r["gt_mismatch"] = float(((t["gt_matches0"].long() != gt["gt0"])
                                  & gt["clear0"]).sum())
        r["loss_gap"] = checks.loss_gap(t["loss"][gt["clear_pair"]],
                                        gt["loss"][gt["clear_pair"]])
        values.append(r)
        sample.append(b)
    return {"attempted": n, "failed": 0, "peak_bytes": peak,
            "e2e": {"setup_s": setup_s,
                    "match_pairs_per_s": n * tr["batch"] / (t1 - t0),
                    "peak_gib": peak / GIB},
            "readings": readings, "trace": prof.trace,
            "values": checks.merge_max(values),
            "materials": {"hosts": hosts, "sample": sample,
                          "weights": weights, "floor": 1e-30}}


KINDS = {"train": run_train, "match": run_match, "eval": run_eval}


def run_cell(run: Run) -> Dict:
    out = KINDS[run.workload["kind"]](run)
    correct, checked = checks.judge(out["values"], run.workload["limits"])
    out["correct"], out["checks"] = correct, checked
    if not math.isfinite(sum(v for v in out["e2e"].values())):
        out["correct"] = False
    return out
