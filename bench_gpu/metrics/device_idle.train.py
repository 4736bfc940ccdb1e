"""device_idle.train: the share of the traced training window in which no
kernel, copy or set ran on the card (the union of their intervals)."""

from bench_gpu.harness.readers import idle_pct


def read(r):
    return idle_pct(r)
