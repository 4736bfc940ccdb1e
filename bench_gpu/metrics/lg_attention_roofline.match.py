"""lg_attention_roofline.match: the least time the traced forwards'
LightGlue attention needs (every self-attention call's scores and values
and every cross-attention call's sim once and both value products, over
valid keypoints, each byte once: ``architectures/lightglue.py::work``,
``lg_attention_bound_s``) over the device time of the kernels that do it:
the self-attention kernel, the two-way cross-attention kernel and the
merge of its column partials."""

from bench_gpu.harness.readers import kernel_pattern, roofline_pct

KERNELS = kernel_pattern("lg_self_attention_kernel",
                         "lg_cross_attention_kernel", "lg_cross_merge_kernel")


def read(r):
    return roofline_pct(r, KERNELS, "lg_attention_bound_s")
