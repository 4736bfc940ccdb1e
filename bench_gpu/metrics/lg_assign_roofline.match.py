"""lg_assign_roofline.match: the least time the traced forwards' LightGlue
assignment and decision need (``sim`` of the final projections once, those
and the matchability in, matches and scores out, over valid keypoints:
``architectures/lightglue.py::work``, ``lg_assign_bound_s``) over the
device time of its four kernels."""

from bench_gpu.harness.readers import kernel_pattern, roofline_pct

KERNELS = kernel_pattern("lg_assign_stats_kernel", "lg_assign_lse_kernel",
                         "lg_assign_max_kernel", "lg_assign_decide_kernel")


def read(r):
    return roofline_pct(r, KERNELS, "lg_assign_bound_s")
