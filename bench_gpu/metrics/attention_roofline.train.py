"""attention_roofline.train: the least time the traced steps' attention
work needs (forward scores over the valid keys and values over the kept
entries; backward scores once and four products over the kept entries;
each byte once) over the device time of the kernels that do it."""

from bench_gpu.harness.readers import kernel_pattern, roofline_pct

KERNELS = kernel_pattern("topk_attention_kernel", "mha_bwd_rows_kernel",
                         "mha_bwd_keys_kernel")


def read(r):
    return roofline_pct(r, KERNELS, "attention_bound_s")
