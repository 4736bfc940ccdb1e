"""mfu.match: the model operations of the forwards in the traced window
(encoders, the learned one included, the GNN, the score product) over the
window at 67 TFLOP/s float32."""

from bench_gpu.harness.readers import mfu_pct


def read(r):
    return mfu_pct(r)
