"""Top-k / dense attention kernel (``csrc/attention.cu``) and its plain twin.

Replaces ``mdgat_tpu/ops/pallas/attention.py::pallas_topk_attention`` /
``_attn_kernel`` and the exact arm of its selection core ``_stacked_prob``.
See the source note in ``csrc/attention.cu`` for the design and what bounds
it on the H100.

:func:`topk_attention` takes q ``[B, H, N, Dh]``, k and v ``[B, H, M, Dh]``
(float32 or bfloat16), a key mask ``[B, M]`` and ``topk`` (0 = dense), and
returns the output ``[B, H, N, Dh]`` in the input dtype and the per-row
threshold ``[B, H, N, 1]`` in float32; with ``return_lse`` also the per-row
logsumexp over the kept entries ``[B, H, N, 1]``, the residual from which
the fused-MHA backward (``ops/cuda/mha.py``) rebuilds the probabilities. A
CUDA tensor launches the kernel; a CPU tensor takes
:func:`topk_attention_reference`. Nothing falls back:
a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdgat_tpu_torch.ops.attention import acc_dtype, attention_core
from mdgat_tpu_torch.ops.cuda._build import DTYPE_CODES, library

_HEAD_DIMS = (8, 16, 32, 64)
MAX_KEYS = 1024


def topk_attention_reference(q, k, v, kv_mask: Optional[torch.Tensor],
                             topk: int, scale: float,
                             return_lse: bool = False):
    """Plain PyTorch twin of the kernel: the same selection and softmax
    (``ops/attention.py``), f32 internals for f32/bf16 inputs."""
    acc = acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    out, thr, lse = attention_core(s, v, kv_mask, topk, return_lse=True)
    if return_lse:
        return out.to(q.dtype), thr.to(torch.float32), lse.to(torch.float32)
    return out.to(q.dtype), thr.to(torch.float32)


def topk_attention(q, k, v, kv_mask: Optional[torch.Tensor], topk: int,
                   scale: float, return_lse: bool = False):
    if q.device.type == "cpu":
        return topk_attention_reference(q, k, v, kv_mask, topk, scale,
                                        return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, h, n, dh = q.shape
    m = k.shape[2]
    _check(q.dtype in DTYPE_CODES, f"dtype {q.dtype} (float32 / bfloat16)")
    _check(k.shape == v.shape == (b, h, m, dh), "k/v shape")
    _check(k.dtype == v.dtype == q.dtype, "q/k/v dtypes differ")
    _check(dh in _HEAD_DIMS, f"head dim {dh} not in {_HEAD_DIMS}")
    _check(0 < m <= MAX_KEYS, f"{m} keys (at most {MAX_KEYS})")
    _check(topk >= 0, "topk < 0")
    if kv_mask is None:
        mask = torch.ones((b, m), dtype=torch.uint8, device=q.device)
    else:
        _check(kv_mask.shape == (b, m), "mask shape")
        mask = kv_mask.to(torch.uint8).contiguous()
    for t in (q, k, v, mask):
        _check(t.device == q.device and t.is_contiguous(),
               "inputs must be contiguous and on one device")
    out = torch.empty_like(q)
    thr = torch.empty((b, h, n, 1), dtype=torch.float32, device=q.device)
    lse = torch.empty_like(thr) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        library().call("mdgat_topk_attention", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                       thr.data_ptr(),
                       lse.data_ptr() if return_lse else None, b, h, n, m,
                       dh, int(topk), float(scale), DTYPE_CODES[q.dtype],
                       stream)
    topk_attention.launches += 1
    return (out, thr, lse) if return_lse else (out, thr)


topk_attention.launches = 0


def _check(ok: bool, what: str):
    if not ok:
        raise ValueError(f"attention kernel: {what}")
