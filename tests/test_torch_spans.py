"""The port's program spans and the graph runtime's counters
(``mdgat_tpu_torch/utils/profiling.py``, ``utils/graphs.py``), on the CPU.

* With no profiling session a span records nothing and is one shared
  no-op context.
* Under ``torch.profiler`` a CPU ``Matcher.match_batch`` exports a Chrome
  trace in which the data spans nest inside ``mdgat.entry.match_batch``,
  which carries the call's number; the eval pipeline's batches carry
  their index; ``Captured``'s warm-up, capture and replay are spans.
* The graph runtime's account (``graphs.TOTALS``) under a CPU stand-in of
  the backend: seconds, less a kernel build, and the live pools' bytes.
* ``tools/trace_idle.py::idle_by_span`` on synthetic trace events: idle
  time goes to the innermost span open on the window's thread; another
  thread's spans take none.
* The benchmark's readers of the graph runtime's account give nothing
  where the process captured nothing.
"""

import gc
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.eval.runner import EvalPipeline
from mdgat_tpu_torch.ops.cuda import _build
from mdgat_tpu_torch.utils import graphs, profiling
from mdgat_tpu_torch.utils.graphs import Captured
from mdgat_tpu_torch.utils.profiling import span

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(rel):
    """A script or a metric reader of the repo, by its path."""
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


idle_by_span = _load("tools/trace_idle.py").idle_by_span

TINY = dict(L=1, k=(8, None), descriptor_dim=32, keypoint_encoder=(16, 32),
            descriptor_encoder=(16,), sinkhorn_iterations=4)


def _trace(tmp_path, fn):
    """The Chrome trace events of ``fn()`` under a CPU profiling session
    that records shapes (where the spans' identifiers go)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("mdgat.")]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _ident(e):
    return e["args"].get("Concrete Inputs", [None])[0]


def test_span_off_records_nothing_and_is_shared():
    assert not torch.autograd._profiler_enabled()
    off = span("mdgat.data.upload")
    assert off is span("mdgat.entry.match_batch", 7) is profiling._OFF
    with off as got:
        assert got is None


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_matcher_spans_nest_inside_the_call_with_its_number(tmp_path,
                                                             normalize):
    """The data spans in the call's order; ``mdgat.data.normalize`` (the
    descriptors' normalisation on the batch's device) once, between the
    upload and the readback, and not at all under ``normalize=False``."""
    rng = np.random.default_rng(0)

    def pair(n):
        return dict(kp0=rng.normal(size=(n, 3)) * 10,
                    desc0=rng.normal(size=(n, 33)),
                    kp1=rng.normal(size=(n + 10, 3)) * 10,
                    desc1=rng.normal(size=(n + 10, 33)))
    m = Matcher(device="cpu", seed=0, **TINY)
    pairs = [pair(20), pair(30)]
    want = m.match_batch(pairs, normalize)
    got = []
    spans = _spans(_trace(tmp_path, lambda: got.append(
        m.match_batch(pairs, normalize))))
    for g, w in zip(got[0], want):
        np.testing.assert_array_equal(g["matches0"], w["matches0"])
    by = {e["name"]: e for e in spans}
    entry = by["mdgat.entry.match_batch"]
    assert _ident(entry) == "2"
    names = ["host_batch", "upload", "normalize", "readback", "unpack"]
    if not normalize:
        names.remove("normalize")
    assert sorted(e["name"] for e in spans
                  if e["name"].startswith("mdgat.data.")) == sorted(
        "mdgat.data." + n for n in names)      # each once
    for name in names:
        e = by["mdgat.data." + name]
        assert _inside(e, entry), name
        assert _ident(e) is None, name      # grouped by time, not by args
    order = sorted(by[f"mdgat.data.{n}"]["ts"] for n in names)
    assert order == [by[f"mdgat.data.{n}"]["ts"] for n in names]


class _Batches:
    def batches(self, batch_size, shuffle=False, drop_last=False):
        for i in range(3):
            yield {"idx0": np.arange(2 * i, 2 * i + 2),
                   "gt_matches0": np.full((2, 4), i, np.int32),
                   "mask0": np.ones((2, 4), bool)}


def test_eval_pipeline_spans_carry_the_batch_index(tmp_path):
    def prepare(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    def eval_step(inputs):
        return {"matches0": inputs["gt_matches0"] * 10}

    pipe = EvalPipeline(_Batches(), prepare, eval_step, 2)
    seen = []
    spans = _spans(_trace(tmp_path, lambda: seen.extend(
        int(got["matches0"][0, 0]) for _, got in pipe)))
    assert seen == [0, 10, 20]
    batches = [e for e in spans if e["name"] == "mdgat.entry.eval_batch"]
    # three batches and the iteration that finds the end
    assert [_ident(e) for e in batches] == ["0", "1", "2", "3"]
    waits = [e for e in spans if e["name"] == "mdgat.data.wait"]
    assert len(waits) == 4
    assert all(any(_inside(w, b) for b in batches) for w in waits)
    # batch i is read back inside batch i+1's iteration, the last after
    reads = [e for e in spans if e["name"] == "mdgat.data.readback"]
    assert len(reads) == 3
    for r, b in zip(reads, batches[1:]):
        assert _inside(r, b) == (b is not batches[-1])
    assert reads[2]["ts"] >= batches[3]["ts"] + batches[3]["dur"]


class StandIn:
    """A CPU stand-in of ``graphs.CudaGraphs``: no capture, a replay re-runs
    the step on the static inputs; its capture reports ``pool`` bytes."""

    def __init__(self, pool=0):
        self.pool = pool

    @staticmethod
    def supports(device):
        return device.type == "cpu"

    @staticmethod
    def context(device):
        return {}

    @staticmethod
    def warm_up(fn, batch, ctx):
        return fn(batch)

    def capture(self, fn, static, ctx):
        if self.pool:
            ctx["pool_bytes"] = self.pool
        return lambda: fn(static)

    @staticmethod
    def before_replay(ctx, device):
        pass

    @staticmethod
    def after_replay(ctx, device):
        pass

    @staticmethod
    def release(ctx):
        pass


@pytest.fixture
def totals(monkeypatch):
    fresh = graphs.Totals()
    monkeypatch.setattr(graphs, "TOTALS", fresh)
    return fresh


def _double(b):
    return {"y": b["x"] * 2}


def test_captured_counts_seconds_and_no_pool_on_the_stand_in(
        monkeypatch, totals):
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    cap = Captured(_double)
    for _ in range(3):
        cap({"x": torch.arange(3.0)})
    assert (cap.warm_ups, cap.captures, cap.replays) == (1, 1, 2)
    assert totals.warm_up_s > 0 and totals.capture_s > 0
    assert totals.pool_bytes == totals.pool_bytes_peak == 0


def test_a_kernel_build_is_not_counted_as_graph_set_up(monkeypatch, totals):
    """A warm-up that builds the kernel library at its first use counts
    its seconds without the build's."""
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    monkeypatch.setattr(_build, "_LIBRARY", None)

    class Library:
        built = None

    def build_then_double(b):
        if _build._LIBRARY is None:
            t0 = time.perf_counter()
            time.sleep(0.3)
            Library.built = (t0, time.perf_counter())
            _build._LIBRARY = Library
        return _double(b)
    cap = Captured(build_then_double)
    cap({"x": torch.zeros(2)})
    cap({"x": torch.zeros(2)})
    assert 0 < totals.warm_up_s < 0.1
    assert 0 < totals.capture_s < 0.1


def test_an_eviction_is_counted_and_takes_its_pool_off(monkeypatch, totals):
    """A key dropped for the bound leaves the cache and takes its pool off
    the process's account; so do ``clear`` and a collected cache."""
    monkeypatch.setattr(graphs, "BACKEND", StandIn(pool=1000))
    cap = Captured(_double, max_graphs=2)
    for n in (2, 3):                    # two keys, each captured
        cap({"x": torch.zeros(n)})
        cap({"x": torch.zeros(n)})
    assert totals.pool_bytes == 2000
    cap({"x": torch.zeros(4)})          # a third key drops the oldest
    assert len(cap) == 2 and totals.pool_bytes == 1000
    cap({"x": torch.zeros(4)})          # its capture
    assert totals.pool_bytes == totals.pool_bytes_peak == 2000
    other = Captured(_double)
    other({"x": torch.zeros(5)})
    other({"x": torch.zeros(5)})
    assert totals.pool_bytes == totals.pool_bytes_peak == 3000
    cap.clear()
    assert len(cap) == 0 and totals.pool_bytes == 1000
    del other                           # a dropped cache's pools leave
    assert totals.pool_bytes == 0 and totals.pool_bytes_peak == 3000


def test_threads_keep_the_process_account_whole(monkeypatch, totals):
    """Caches on more threads than cores, each capturing and dropping
    keys, with a short switch interval: no update of ``TOTALS`` is lost,
    and every pool leaves it with its cache."""
    import sys
    import threading
    monkeypatch.setattr(graphs, "BACKEND", StandIn(pool=1000))
    n_threads, n_keys = 12, 6
    caps = []

    def work():
        cap = Captured(_double, max_graphs=2)
        for n in range(1, n_keys + 1):
            cap({"x": torch.zeros(n)})
            cap({"x": torch.zeros(n)})
        caps.append(cap)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sum(c.captures for c in caps) == n_threads * n_keys
    assert totals.pool_bytes == n_threads * 2000   # two live keys a cache
    assert 2000 <= totals.pool_bytes_peak <= n_threads * 2000
    del caps[:]
    gc.collect()
    assert totals.pool_bytes == 0


def test_graph_runtime_spans(monkeypatch, tmp_path, totals):
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    cap = Captured(_double)
    names = [e["name"] for e in _spans(_trace(tmp_path, lambda: [
        cap({"x": torch.arange(3.0)}) for _ in range(3)]))]
    assert names == ["mdgat.graphs.warm_up", "mdgat.graphs.capture",
                     "mdgat.graphs.replay", "mdgat.graphs.replay"]


@pytest.mark.parametrize("metric", ["graph_setup_s", "graph_pool_gib"])
def test_graph_readers(monkeypatch, totals, metric):
    read = _load(f"bench_gpu/metrics/{metric}.py").read
    assert read(None) is None                   # nothing captured
    monkeypatch.setattr(graphs, "BACKEND", StandIn(pool=3 * 2 ** 29))
    cap = Captured(_double)
    cap({"x": torch.zeros(2)})
    cap({"x": torch.zeros(2)})
    want = {"graph_setup_s": totals.warm_up_s + totals.capture_s,
            "graph_pool_gib": 1.5}[metric]
    assert read(None) == pytest.approx(want)


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid}


def _events():
    """A 100 us window, busy 0-10, 30-40, 90-95; one call with two data
    spans; a span on another thread over most of the window."""
    return [_x("bench.window", 0, 100), _x("k", 0, 10, "kernel"),
            _x("k", 30, 10, "kernel"), _x("c", 90, 5, "gpu_memcpy"),
            _x("mdgat.entry.match_batch", 5, 80),
            _x("bench.host_batch", 12, 10),
            _x("mdgat.data.host_batch", 10, 15),
            _x("mdgat.data.readback", 50, 30),
            _x("mdgat.data.wait", 40, 50, tid=2)]


def test_idle_goes_to_the_innermost_span_of_the_window_thread():
    got = idle_by_span(_events(), "bench.window")
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(25e-6)
    assert got["idle_s"] == pytest.approx(75e-6)
    assert got["calls"] == 1
    want = {"mdgat.data.host_batch": 15e-6, "mdgat.entry.match_batch": 20e-6,
            "mdgat.data.readback": 30e-6, "": 10e-6}
    assert got["idle_s_by_span"] == pytest.approx(want)
    assert [g[0] for g in got["gaps"]] == ["mdgat.data.readback",
                                           "mdgat.data.host_batch", ""]
    # with the harness's spans, the innermost of either names a gap
    both = idle_by_span(_events(), "bench.window", ("mdgat.", "bench."))
    assert both["idle_s_by_span"]["bench.host_batch"] == pytest.approx(10e-6)
    assert both["gaps"][1][0] == "bench.host_batch"


def test_idle_without_a_window_or_device_work():
    got = idle_by_span(_events())
    assert got["window_s"] == pytest.approx(95e-6)      # 0 to 95
    assert idle_by_span([e for e in _events() if e["cat"] != "kernel"
                         and e["cat"] != "gpu_memcpy"]) is None
