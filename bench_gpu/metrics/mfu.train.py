"""mfu.train: the model operations of the training steps in the traced
window (``harness/work.py``: forward, weight and input gradients, from
shapes, masks and k) over the window at 67 TFLOP/s, the H100 SXM's float32
rate outside the tensor cores."""

from bench_gpu.harness.readers import mfu_pct


def read(r):
    return mfu_pct(r)
