"""graph_pool_gib: GiB of the card's memory that the program's CUDA
graphs hold in their private pools (``utils/graphs.py::TOTALS.
pool_bytes_peak``: the most the live graphs' pools held at once, each
pool the caching allocator's reserve after its capture less before it).
Every cell captures in set-up and neither captures nor drops a graph in
its window, so this is what the pools hold at the window's close: the
graph runtime's part of ``peak_gib``. None where the program keeps no
such account, or captured nothing."""

GIB = float(2 ** 30)


def read(r):
    try:
        from mdgat_tpu_torch.utils.graphs import TOTALS
    except ImportError:
        return None
    if not getattr(TOTALS, "capture_s", 0):
        return None
    return TOTALS.pool_bytes_peak / GIB
