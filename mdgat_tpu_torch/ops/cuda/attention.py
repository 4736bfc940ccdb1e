"""Top-k / dense attention kernel (``csrc/attention.cu``) and its plain twin.

Replaces ``mdgat_tpu/ops/pallas/attention.py::pallas_topk_attention`` /
``_attn_kernel`` and both arms of its selection core ``_stacked_prob``.
See the source note in ``csrc/attention.cu`` for the design and what bounds
it on the H100.

:func:`topk_attention` takes q ``[B, H, N, Dh]``, k and v ``[B, H, M, Dh]``
(float32 or bfloat16), a key mask ``[B, M]`` and ``topk`` (0 = dense), and
returns the output ``[B, H, N, Dh]`` in the input dtype and the per-row
threshold ``[B, H, N, 1]`` in float32; with ``return_lse`` also the per-row
logsumexp over the kept entries ``[B, H, N, 1]``, the residual from which
the fused-MHA backward (``ops/cuda/mha.py``) rebuilds the probabilities.
``exact`` picks the arm: the exact k-th value, or (``exact=False``) the JAX
package's default value bisection at the resolution ``fine_iters``, which
defaults to :func:`~mdgat_tpu_torch.ops.attention.fast_iters` of q's dtype;
the routes that feed the kernel float32 projections of a narrower input
pass the resolution of that input. A
CUDA tensor launches the kernel; a CPU tensor takes
:func:`topk_attention_reference`. Nothing falls back:
a CUDA call the kernel cannot take raises.

:func:`check_shape` refuses the shapes the kernel has no instantiation for
(the launch in ``csrc/attention.cu`` plans the rest: rows a block, shared
memory). Every key count is taken: above :data:`REGISTER_KEYS` the wide
arm keeps a row's scores in a slab, in shared memory where it fits and in a
global scratch of :func:`slab_floats` floats beyond (device memory is the
only limit). :func:`selection_mirror` is the kernel's exact k-th-value
search, step for step, in plain PyTorch on int32 keys: it runs on the CPU,
where the tests hold it to the twin.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdgat_tpu_torch.ops.attention import (BIG_NEG, acc_dtype,
                                           attention_core, fast_iters,
                                           fast_plan)
from mdgat_tpu_torch.ops.cuda._build import (DTYPE_CODES, _ptr,
                                             device_scratch, library)
from mdgat_tpu_torch.utils.counting import tick

HEAD_DIMS = (8, 16, 32, 64)
REGISTER_KEYS = 1024    # keys the register arms hold; the wide arm beyond
VALUE_STEPS = 12        # kValueSteps of csrc/attention.cu
CANDIDATES = 32         # kCandidates
SMEM_CAP = 227 * 1024   # shared memory a block may take on the H100
WIDE_ROWS = 8           # query rows a block of the wide arm (TR = 1)
KEY_TILE = 256          # kKT of csrc/common.cuh


def check_shape(m: int, dh: int, topk: int):
    """Raises ``ValueError`` unless the kernel takes ``m`` keys at head size
    ``dh`` with ``topk`` kept (0 = dense)."""
    _check(dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    _check(m > 0, f"{m} keys")
    _check(topk >= 0, "topk < 0")


def slab_stride(m: int) -> int:
    """Floats a row of the score slab (``csrc/common.cuh::slab_stride``)."""
    return (m + 31) // 32 * 32 + 8


def slab_floats(b: int, h: int, n: int, m: int, dh: int,
                staged: int = 1) -> int:
    """Floats of the global scratch that the wide arm's score slab needs:
    0 at ``m <= REGISTER_KEYS`` and wherever the slab of ``WIDE_ROWS`` rows
    fits in shared memory beside the key tile and ``staged`` row tiles of
    ``dh`` (1: Q, the forward; 2: Q and dO, the backward's rows kernel),
    else a ``WIDE_ROWS``-row slab for every block of the grid. Mirrors the
    launches of ``csrc/attention.cu`` and ``csrc/mha_bwd.cu``."""
    if m <= REGISTER_KEYS:
        return 0
    tile = max(KEY_TILE * (dh + 4), 128 * WIDE_ROWS)
    rows = WIDE_ROWS * slab_stride(m)
    if 4 * (rows + tile + staged * WIDE_ROWS * (dh + 4)) <= SMEM_CAP:
        return 0
    return -(-n // WIDE_ROWS) * b * h * rows


def _monotone_key(s: torch.Tensor) -> torch.Tensor:
    bits = s.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _key_to_float(key: torch.Tensor) -> torch.Tensor:
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)


def _ceil_avg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fa = (a >> 1) + (b >> 1) + (a & b & 1)
    return fa + ((a ^ b) & 1)


def selection_mirror(s: torch.Tensor, valid: torch.Tensor,
                     topk: int) -> torch.Tensor:
    """The kernel's search for the per-row k-th largest valid score
    ``[..., 1]``, step for step on order-preserving int32 keys (phase B of
    ``csrc/attention.cu``): an interval ``[lo, hi]`` of keys with the counts
    ``count(key >= lo)`` and ``count(key > hi)``; pivots that bisect the
    value interval for the first ``VALUE_STEPS`` steps and the key interval
    after; and, once at most ``CANDIDATES`` keys are undecided, their
    ranking. ``s`` is float32 ``[..., M]``, ``valid`` its boolean mask.
    Equal to :func:`~mdgat_tpu_torch.ops.attention.topk_threshold` bit for
    bit, ties, signed zeros and all-masked rows included."""
    shape = s.shape[:-1]
    m = s.shape[-1]
    valid = valid.expand(s.shape).reshape(-1, m)
    s = torch.where(valid, s.reshape(-1, m).to(torch.float32),
                    torch.tensor(BIG_NEG, dtype=torch.float32, device=s.device))
    key = _monotone_key(s)
    none = _monotone_key(torch.tensor(-BIG_NEG, dtype=torch.float32,
                                      device=s.device))
    hi = key.amax(-1)
    lo = torch.where(valid, key, none).amin(-1)
    nvalid = valid.sum(-1).to(torch.int32)
    search = nvalid > topk
    c_lo, c_hi = nvalid.clone(), torch.zeros_like(nvalid)
    step = 0
    while True:
        active = search & (lo < hi) & (c_lo - c_hi > CANDIDATES)
        if not bool(active.any()):
            break
        mid = _ceil_avg(lo, hi)
        if step < VALUE_STEPS:
            vmid = _monotone_key(0.5 * _key_to_float(lo)
                                 + 0.5 * _key_to_float(hi))
            mid = torch.where((vmid > lo) & (vmid <= hi), vmid, mid)
        cnt = (key >= mid[:, None]).sum(-1).to(torch.int32)
        up, down = active & (cnt >= topk), active & (cnt < topk)
        lo, c_lo = torch.where(up, mid, lo), torch.where(up, cnt, c_lo)
        hi, c_hi = torch.where(down, mid - 1, hi), torch.where(down, cnt, c_hi)
        step += 1
    # the undecided keys, ranked: the (topk - c_hi)-th largest of them
    rank_rows = search & (lo < hi)
    inside = (key >= lo[:, None]) & (key <= hi[:, None])
    lowest = torch.iinfo(torch.int32).min
    ranked = torch.where(inside, key, lowest).sort(-1, descending=True).values
    rank = (topk - c_hi).clamp(1, m).long()
    picked = ranked.gather(-1, rank[:, None] - 1)[:, 0]
    lo = torch.where(rank_rows, picked, lo)
    return _key_to_float(lo).reshape(*shape, 1)


def resolution(dtype: torch.dtype, exact: bool,
               fine_iters: Optional[int] = None) -> int:
    """The ``fine_iters`` that :func:`~mdgat_tpu_torch.ops.attention.
    attention_core` takes: 0 for the exact arm, else ``fine_iters`` or the
    fast arm's resolution for an input of ``dtype``."""
    if exact:
        return 0
    return int(fine_iters) if fine_iters else fast_iters(dtype)


def topk_attention_reference(q, k, v, kv_mask: Optional[torch.Tensor],
                             topk: int, scale: float,
                             return_lse: bool = False, exact: bool = True,
                             fine_iters: Optional[int] = None):
    """Plain PyTorch twin of the kernel: the same selection and softmax
    (``ops/attention.py``), f32 internals for f32/bf16 inputs."""
    acc = acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    out, thr, lse = attention_core(s, v, kv_mask, topk, return_lse=True,
                                   fine_iters=resolution(q.dtype, exact,
                                                         fine_iters))
    if return_lse:
        return out.to(q.dtype), thr.to(torch.float32), lse.to(torch.float32)
    return out.to(q.dtype), thr.to(torch.float32)


def topk_attention(q, k, v, kv_mask: Optional[torch.Tensor], topk: int,
                   scale: float, return_lse: bool = False, exact: bool = True,
                   fine_iters: Optional[int] = None):
    if q.device.type == "cpu":
        return topk_attention_reference(q, k, v, kv_mask, topk, scale,
                                        return_lse, exact, fine_iters)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, h, n, dh = q.shape
    m = k.shape[2]
    _check(q.dtype in DTYPE_CODES, f"dtype {q.dtype} (float32 / bfloat16)")
    _check(k.shape == v.shape == (b, h, m, dh), "k/v shape")
    _check(k.dtype == v.dtype == q.dtype, "q/k/v dtypes differ")
    check_shape(m, dh, int(topk))
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
    fine = resolution(q.dtype, exact, fine_iters)
    mids, passes = fast_plan(m, fine) if fine and topk else (0, 0)
    floats = slab_floats(b, h, n, m, dh)
    slab = device_scratch(floats, q.device, f"attention kernel ({m} keys)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        library().call("mdgat_topk_attention", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                       thr.data_ptr(),
                       _ptr(lse), _ptr(slab), floats,
                       b, h, n, m, dh, int(topk), mids, passes, float(scale),
                       DTYPE_CODES[q.dtype], stream)
    tick(topk_attention)
    return (out, thr, lse) if return_lse else (out, thr)


topk_attention.launches = 0


def _check(ok: bool, what: str):
    if not ok:
        raise ValueError(f"attention kernel: {what}")
