"""Reading the device trace: busy time is the union of the device
intervals in the window, idle gaps carry the host span open at the time."""

import pytest

from bench_gpu.harness import devtrace
from bench_gpu.harness.common import Readings
from bench_gpu.harness import readers


def events():
    us = lambda name, cat, ts, dur: {"ph": "X", "cat": cat, "name": name,  # noqa
                                     "ts": ts, "dur": dur}
    return [us("bench.window", "user_annotation", 0, 100),
            us("void ns::(anonymous namespace)::k1<float>(int)", "kernel", 10,
               20),
            us("Memcpy HtoD", "gpu_memcpy", 20, 20),      # overlaps k1
            us("gemm_tn_kernel", "kernel", 90, 50),       # runs past the end
            us("bench.prepare", "user_annotation", 40, 30),
            us("bench.step", "user_annotation", 35, 60),
            us("cudaLaunchKernel", "cuda_runtime", 5, 1)]


def test_union_and_gaps():
    t = devtrace.read_events(events())
    assert t.window_s == pytest.approx(100e-6)
    # [10, 40] once, [90, 100] clipped to the window
    assert t.busy_s == pytest.approx(40e-6)
    gaps = t.idle_gaps()
    assert gaps[0][0] == "bench.prepare" and gaps[0][1] == pytest.approx(50e-6)
    assert gaps[1] == ["no harness span", pytest.approx(10e-6)]
    assert t.top_ops()[0] == ["ns::k1", pytest.approx(20e-6)]
    assert t.seconds(readers.kernel_pattern("gemm_tn_kernel")) == \
        pytest.approx(10e-6)
    assert t.seconds(readers.kernel_pattern("gemm_kernel")) == 0


def test_no_window_or_no_device_work():
    assert devtrace.read_events(events()[1:]) is None
    # a trace of the host alone: spans, and nothing the device's readers
    # can read
    t = devtrace.read_events([events()[0], events()[4]])
    assert t.ops == [] and t.busy_s == 0
    assert t.spans == [("bench.prepare", pytest.approx(40e-6),
                        pytest.approx(70e-6))]
    r = Readings(trace=t, work={"flops": 1.0, "attention_bound_s": 1.0})
    assert readers.idle_pct(r) is None and readers.mfu_pct(r) is None
    assert readers.roofline_pct(r, readers.kernel_pattern("k1"),
                                "attention_bound_s") is None


def test_readers_leave_out_what_they_cannot_read():
    empty = Readings()
    assert readers.idle_pct(empty) is None
    assert readers.mfu_pct(empty) is None
    assert readers.span_ms(empty, "prepare") is None
    t = devtrace.read_events(events())
    r = Readings(trace=t, work={"flops": 67e12 * 50e-6,
                                "attention_bound_s": 5e-6},
                 spans={"prepare": [0.002, 0.004]})
    assert readers.idle_pct(r) == pytest.approx(60.0)
    assert readers.mfu_pct(r) == pytest.approx(50.0)
    assert readers.span_ms(r, "prepare") == pytest.approx(3.0)
    # a kernel that did not run gives no roofline, not 0
    assert readers.roofline_pct(r, readers.kernel_pattern("absent"),
                                "attention_bound_s") is None
    assert readers.roofline_pct(r, readers.kernel_pattern("gemm_tn_kernel"),
                                "attention_bound_s") == pytest.approx(50.0)
