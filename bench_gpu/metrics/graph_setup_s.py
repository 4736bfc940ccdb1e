"""graph_setup_s: host seconds the program's graph runtime spent warming
up and capturing (``utils/graphs.py::TOTALS``, ``warm_up_s`` +
``capture_s`` over every ``Captured`` of the process; a warm-up's
seconds hold the kernels built at their first use). Every cell warms up
and captures in set-up and only replays in its window, so this is the
graph runtime's part of ``setup_s``. None where the program keeps no such
account, or captured nothing."""


def read(r):
    try:
        from mdgat_tpu_torch.utils.graphs import TOTALS
    except ImportError:
        return None
    if not getattr(TOTALS, "capture_s", 0):
        return None
    return TOTALS.warm_up_s + TOTALS.capture_s
