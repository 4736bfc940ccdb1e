"""encoder_ms.match: device ms of ``MDGAT.encode`` over both clouds of one
batch of the pool, by CUDA events after a warm-up, outside the window."""


def read(r):
    return r.extra.get("encoder_ms")
