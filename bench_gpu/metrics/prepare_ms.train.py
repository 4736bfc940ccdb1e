"""prepare_ms.train: host ms a step in ``prepare_batch`` + ``model_inputs``
(the harness's span around its own call)."""

from bench_gpu.harness.readers import span_ms


def read(r):
    return span_ms(r, "prepare")
