"""host_ms.match: host ms a call in ``Matcher._host_batch`` (padding and
stacking the pairs; the descriptors are normalised on the card after the
upload), from the span the harness wraps around that bound method of its
own Matcher in the traced run."""

from bench_gpu.harness.readers import span_ms


def read(r):
    return span_ms(r, "host_batch")
