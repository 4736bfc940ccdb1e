"""The architecture seam: the weights and work counts of MDGAT's cells as the
harness made them before the seam, a stand-in architecture that joins as
files alone and runs a small serving cell with its own weights, work key
and metric, the finders' errors, and the loops that read none of MDGAT's
keys."""

import ast
import copy
import hashlib
import json
import shutil
import sys
import time

import pytest
import torch

from bench_gpu.harness import cells, common, traffic, weights

# sha256 of every tensor of the state dict (name, dtype, shape, bytes, by
# name), as the harness's weights.py computed them before the architecture
# seam, on the CPU
WEIGHT_DIGESTS = {
    ("mdgat-fpfh", 7):
        "84f5f32db229359abdd659c451f9dfd364194dd6239cafc4dfbfe405c611c442",
    ("mdgat-fpfh", 2 ** 31 + 5):
        "38d953b8fe50772a110c80ef4572b07820cb0bccdf133ab70df3fe7391df9a71",
    ("mdgat-fpfh", 2 ** 62 + 11):
        "9ea88cc0b5c9eed10b3cdbc640ca164a61668c9814d3825520ccdf5e862c2ac0",
    ("mdgat-pointnetmsg", 7):
        "70c9b1e232eaca18e34299ce99481b4e36c3a6cd0991c07bd0d77c574199ddff",
    ("mdgat-pointnetmsg", 2 ** 31 + 5):
        "2e9f4b3ecb84e98ef95a61857d6265e751d3d563f32a9be14a1bcf4ec51ae3ee",
    ("mdgat-pointnetmsg", 2 ** 62 + 11):
        "50e6662642f50bb4985a34593cc054ae5f8b181c23ccc4d0a840d185151de99b",
}

# (pairs, flops, attention_bound_s, gemm_bound_s) of each pool batch at
# seed 5, as work.summary counted them before the seam
WORK_SEED = 5
WORK = {
    "fpfh-train-b64n512": [
        (64.0, 2142433705984.0, 0.014070825693611948, 0.0)] * 4,
    "fpfh-match-b64n256": [
        (64.0, 233629556992.0, 0.0008526829965373133, 0.0025610686280597016),
        (64.0, 232425887488.0, 0.0008456441733731341, 0.002550504616119403),
        (64.0, 234705919104.0, 0.000858831910208955, 0.002570664272238806),
        (64.0, 233438345216.0, 0.0008519910170746265, 0.0025589558256716416),
        (64.0, 232837707136.0, 0.0008482230562388057, 0.00255393792),
        (64.0, 235023321600.0, 0.0008609168277014926, 0.0025732172417910447),
        (64.0, 234732168064.0, 0.0008592099801791043, 0.002570664272238806),
        (64.0, 233030722432.0, 0.0008492871756417908, 0.0025556985886567166),
    ],
    "msg-eval-b64n256": [
        (64.0, 415785695232.0, 0.0008403958065671642, 0.0025427576740298507),
        (64.0, 419584212224.0, 0.0008540682469253735, 0.0025630933970149255),
        (64.0, 418790080000.0, 0.0008517039455522388, 0.0025586036919402985),
        (64.0, 422017803008.0, 0.0008626443615522386, 0.0025762103785074626),
    ],
    "msg-train-b32n512": [
        (32.0, 1686345089024.0, 0.007035412846805974, 0.0)] * 4,
}
WORK_KEYS = ("pairs", "flops", "attention_bound_s", "gemm_bound_s")

# MDGAT's own keys: only reference.py and work.py (and the architecture
# module) read them
MDGAT_KEYS = ("descriptor", "k", "L", "keypoint_encoder",
              "descriptor_encoder", "final_proj", "bin_score",
              "topk_bisection_iters")
HARNESS = sorted(p for p in (common.PKG / "harness").glob("*.py")
                 if p.name not in ("reference.py", "work.py"))
LOOPS = HARNESS + [common.PKG / "run.py", common.PKG / "calibrate.py"]


def digest(state):
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed", sorted(WEIGHT_DIGESTS))
def test_bg_weights_are_bit_equal_to_before(config, seed):
    cfg = common.config(config)
    w = weights.make_weights(cfg, seed, "cpu", common.architecture(cfg))
    assert digest(w) == WEIGHT_DIGESTS[(config, seed)]


def pool_hosts(run):
    kind = run.workload["kind"]
    if kind == "train":
        return cells.train_hosts(run)
    if kind == "eval":
        return cells.eval_hosts(run)
    return [cells.pad_pairs(p)
            for p in traffic.pool_pairs(run.traffic, run.seed)]


@pytest.mark.parametrize("cell", sorted(WORK))
def test_bg_work_counts_are_the_same_as_before(cell):
    wl = common.workload(cell)
    run = cells.Run(cell, wl, common.config(wl["config"]), WORK_SEED, 1.0,
                    False, torch.device("cpu"), time.perf_counter())
    train = wl["kind"] == "train"
    got = [run.arch.work(run.sizes, h, train) for h in pool_hosts(run)]
    assert [tuple(g[k] for k in WORK_KEYS) for g in got] == WORK[cell]
    assert all(set(g) == set(WORK_KEYS) for g in got)


# ------------------------------------------------------------ a stand-in
STANDIN = '''"""MDGAT with one tensor drawn from the normal init and one
more work count: a stand-in for another architecture."""

from bench_gpu.architectures.mdgat import *  # noqa: F401,F403
from bench_gpu.architectures import mdgat

NORMAL = "gnn.layers.0.attn.merge.weight"
NORMAL_SCALE = 0.05


def param_specs(sizes):
    return [(n, s, "normal", NORMAL_SCALE) if n == NORMAL else (n, s, i, a)
            for n, s, i, a in mdgat.param_specs(sizes)]


def work(sizes, host, train):
    out = mdgat.work(sizes, host, train)
    out["valid_rows"] = float(host["mask0"].sum() + host["mask1"].sum())
    return out
'''

STANDIN_METRIC = '''"""Valid keypoints a host ms of the program's host
batch."""

from bench_gpu.harness.readers import program_span_ms


def read(r):
    ms = program_span_ms(r, "mdgat.data.host_batch")
    if ms is None or not r.work:
        return None
    return r.work["valid_rows"] / ms
'''

CELL = "standin-match"


def standin_checkout(tmp_path):
    """A checkout of the stand-in: BENCHMARK.json and, under ``bench/``,
    one configuration, architecture, workload and metric, all new files."""
    folder = tmp_path / "bench"
    for sub in ("configs", "architectures", "workloads", "metrics"):
        (folder / sub).mkdir(parents=True)
    cfg = common.config("mdgat-fpfh")
    cfg.update(name="standin", architecture="standin")
    (folder / "configs" / "standin.json").write_text(json.dumps(cfg))
    (folder / "architectures" / "standin.py").write_text(STANDIN)
    (folder / "metrics" / "valid_rows_per_ms.py").write_text(STANDIN_METRIC)
    wl = copy.deepcopy(common.workload("fpfh-match-b64n256"))
    wl["config"] = "standin"
    wl["traffic"].update(batch=8, pool=3, sample_calls=2)
    wl.update(trace_iters=3, reference_block=2)
    (folder / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    bench = {"workloads": [{"name": CELL, "config": "standin",
                            "traffic": CELL, "chips": 1, "why": "a test"}],
             "end_to_end": [
                 {"name": "match_pairs_per_s", "unit": "pairs/s",
                  "better": "higher", "bound": 0.25, "source": "host_clock"},
                 {"name": "setup_s", "unit": "s", "better": "lower",
                  "bound": 0.25, "source": "host_clock"}],
             "per_layer": [
                 {"name": "valid_rows_per_ms", "unit": "1/ms",
                  "better": "higher", "source": "program_span",
                  "layer": "data path", "moves": "match_pairs_per_s",
                  "workloads": [CELL]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return folder


def test_bg_a_standin_architecture_joins_as_files_alone(tmp_path):
    from bench_gpu.run import execute
    folder = standin_checkout(tmp_path)
    cfg = common.config("standin", folder)
    arch = common.architecture(cfg, folder)
    mine = weights.make_weights(cfg, 2 ** 31 + 7, "cpu", arch)
    mdgat = common.config("mdgat-fpfh")
    theirs = weights.make_weights(mdgat, 2 ** 31 + 7, "cpu",
                                  common.architecture(mdgat))
    assert mine.keys() == theirs.keys()
    normal = mine[arch.NORMAL]
    assert not torch.equal(normal, theirs[arch.NORMAL])
    gen = torch.Generator().manual_seed((2 ** 31 + 7) ^ weights.NORMAL_STREAM)
    assert torch.equal(normal, torch.randn(normal.numel(), generator=gen)
                       .view(normal.shape) * arch.NORMAL_SCALE)
    # the uniform draw is the same stream: the tensors before the normal
    # one in the specs' order are MDGAT's
    names = [n for n, _, _, _ in arch.param_specs(arch.sizes(cfg))]
    before = names[:names.index(arch.NORMAL)]
    assert before and all(torch.equal(mine[k], theirs[k]) for k in before)

    code, out = execute(CELL, 2 ** 31 + 7, 0.3, True, "cpu",
                        overrides={"kernel_twins": True}, folder=folder)
    assert code == 0
    result, checks = out
    assert result["correct"], checks
    assert set(result["metrics"]) == {"valid_rows_per_ms"}
    assert result["metrics"]["valid_rows_per_ms"]["value"] > 0
    # a trace of the host alone gives the card's numbers nowhere
    assert "busy_s" not in result["device"] and "breakdown" not in result


def test_bg_a_metric_file_that_loads_a_forbidden_module_gives_no_result(
        tmp_path, monkeypatch):
    """The guard against JAX looks once the metric files have read: a
    module one of them loads, here a stand-in for a forbidden one, leaves
    the run with no result."""
    from bench_gpu.run import execute
    folder = standin_checkout(tmp_path)
    (tmp_path / "forbidden_standin.py").write_text("")
    metric = folder / "metrics" / "valid_rows_per_ms.py"
    metric.write_text("import forbidden_standin  # noqa: F401\n"
                      + metric.read_text())
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(common, "FORBIDDEN",
                        common.FORBIDDEN + ("forbidden_standin",))
    try:
        assert common.forbidden_modules() == []
        got = execute(CELL, 2 ** 31 + 9, 0.3, True, "cpu",
                      overrides={"kernel_twins": True}, folder=folder)
        assert "forbidden_standin" in sys.modules
    finally:
        sys.modules.pop("forbidden_standin", None)
    assert got == (3, None)


def test_bg_the_standin_metric_reads_its_work_key_and_span(tmp_path):
    from bench_gpu.harness import devtrace
    from bench_gpu.harness.common import Readings
    folder = standin_checkout(tmp_path)
    read = common.metric_reader("valid_rows_per_ms", folder)
    us = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",  # noqa
                                "name": name, "ts": ts, "dur": dur, "tid": 1}
    t = devtrace.read_events([
        us("bench.window", 0, 1000), us("mdgat.data.host_batch", 10, 200),
        us("mdgat.data.host_batch", 500, 400), us("mdgat.data.upload", 0, 9),
        us("mdgat.data.host_batch", 2000, 50)])       # after the window
    assert t.program_spans("mdgat.data.host_batch") == [
        (pytest.approx(10e-6), pytest.approx(210e-6), 1),
        (pytest.approx(500e-6), pytest.approx(900e-6), 1)]
    assert read(Readings(trace=t, work={"valid_rows": 900.0})) == \
        pytest.approx(900.0 / 0.3)
    assert read(Readings(trace=t)) is None
    assert read(Readings(work={"valid_rows": 900.0})) is None


FINDERS = [
    ("architectures/nosuch.py",
     lambda f: common.architecture({"architecture": "nosuch"}, f)),
    ("configs/nosuch.json", lambda f: common.config("nosuch", f)),
    ("workloads/nosuch.json", lambda f: common.workload("nosuch", f)),
    ("metrics/nosuch.py", lambda f: common.metric_reader("nosuch", f)),
]


@pytest.mark.parametrize("path,find", FINDERS, ids=[p for p, _ in FINDERS])
def test_bg_a_missing_file_names_its_path(tmp_path, path, find):
    with pytest.raises(FileNotFoundError) as err:
        find(tmp_path)
    assert str(tmp_path / path) in str(err.value)


def test_bg_a_configuration_naming_a_missing_architecture(tmp_path):
    folder = tmp_path / "bench"
    (folder / "configs").mkdir(parents=True)
    shutil.copy(common.PKG / "configs" / "mdgat-fpfh.json",
                folder / "configs" / "mdgat-fpfh.json")
    cfg = common.config("mdgat-fpfh", folder)
    cfg["architecture"] = "lightglue"
    run = cells.Run("x", common.workload("fpfh-match-b64n256"), cfg, 1, 1.0,
                    False, torch.device("cpu"), 0.0, folder=folder)
    with pytest.raises(FileNotFoundError) as err:
        run.weights("cpu")
    assert str(folder / "architectures" / "lightglue.py") in str(err.value)
    # without the key a configuration is MDGAT's
    assert common.architecture(common.config("mdgat-fpfh")).__name__ == \
        "bench_gpu_architecture_mdgat"


def string_constants(path):
    """Every string constant of the module but its docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", LOOPS, ids=lambda p: p.name)
def test_bg_no_loop_reads_an_mdgat_key(path):
    bad = [s for s in string_constants(path)
           if s.split(".")[0] in MDGAT_KEYS or s.startswith("final_proj")]
    assert not bad, (path.name, bad)


def test_bg_the_key_check_sees_a_key():
    assert "topk_bisection_iters" in string_constants(
        common.PKG / "architectures" / "mdgat.py")
