"""gemm_roofline.match: the least time the six products of every eval GNN
layer call in the traced forwards need (valid rows, each byte once) over
the device time of ``gemm_kernel``, which does them."""

from bench_gpu.harness.readers import kernel_pattern, roofline_pct

KERNELS = kernel_pattern("gemm_kernel")


def read(r):
    return roofline_pct(r, KERNELS, "gemm_bound_s")
