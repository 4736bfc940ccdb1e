"""What the redesigned attention and GEMM kernels of the PyTorch port keep
off the card: the exact k-th-value search of ``csrc/attention.cu`` mirrored
step for step in plain PyTorch on int32 keys
(``ops/cuda/attention.py::selection_mirror``), held bit-equal to the twin's
threshold and to the JAX package's exact Pallas kernel (interpret mode, as
``tests/test_pallas.py`` runs it); the shapes the wrappers refuse before a
launch (the launches in ``csrc/`` plan tiles and shared memory); and the row
splits of the transposed-A GEMM (``ops/cuda/layer.py::tn_plan``), whose
wrapper sizes the scratch from them and takes its plain twin on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.pallas import pallas_topk_attention

from mdgat_tpu_torch.ops.attention import BIG_NEG, topk_threshold
from mdgat_tpu_torch.ops.cuda import attention as kernel
from mdgat_tpu_torch.ops.cuda import layer as layer_kernel


def _mirror(s, valid, topk):
    s = torch.from_numpy(np.array(s, np.float32))
    valid = torch.from_numpy(np.array(valid, bool))
    masked = torch.where(valid, s, torch.tensor(BIG_NEG, dtype=torch.float32))
    return (kernel.selection_mirror(s, valid, topk),
            topk_threshold(masked, valid, topk))


@pytest.mark.parametrize("m", [45, 200, 231, 256, 513, 1024])
@pytest.mark.parametrize("topk", [1, 8, 64, 128, 2000])
def test_selection_mirror_bit_equal_to_twin_threshold(m, topk):
    """Random scores of every sign, ragged masks, one all-masked row, and
    k from 1 to beyond the valid count."""
    rng = np.random.default_rng(500 + m + topk)
    s = (rng.normal(size=(2, 3, 17, m)) * 3).astype(np.float32)
    valid = np.arange(m)[None, None, None, :] < rng.integers(
        1, m + 1, size=(2, 3, 17, 1))
    valid[1, 2, 5] = False
    got, want = _mirror(s, valid, topk)
    assert got.shape == (2, 3, 17, 1) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert (got[1, 2, 5] == 1e30).all()


@pytest.mark.parametrize("topk", [1, 3, 5, 40, 100])
def test_selection_mirror_on_ties_zeros_and_tiny_gaps(topk):
    """Exact ties at the k-th value (few distinct values, so the undecided
    set never shrinks below the tie), +0 / -0, 1-ulp neighbours, and scores
    spread over many binades (where bisecting the value interval stalls and
    the key interval takes over)."""
    rng = np.random.default_rng(520 + topk)
    m = 300
    rows = [np.round(rng.normal(size=m)),                       # heavy ties
            np.full(m, 0.5),                                     # all equal
            np.where(rng.random(m) < 0.5, 0.0, -0.0),            # signed zeros
            np.concatenate([[0.0, -0.0], rng.normal(size=m - 2) * 1e-3]),
            np.exp(rng.uniform(-80, 80, size=m)) * rng.choice([-1, 1], m),
            -np.abs(rng.normal(size=m)) - 5.0]                   # all negative
    base = np.float32(1.25)
    ulps = np.array([base] * 60 + [np.nextafter(base, np.float32(2))] * 60
                    + [np.nextafter(base, np.float32(1))] * 60
                    + list(rng.normal(size=m - 180)), np.float32)
    s = np.stack(rows + [ulps]).astype(np.float32)
    valid = np.ones_like(s, bool)
    valid[:, 250:] = False
    got, want = _mirror(s, valid, topk)
    assert torch.equal(got, want)
    # the all-equal row: the threshold is that value, every tie is kept
    assert got[1, 0] == 0.5


@pytest.mark.parametrize("topk", [1, 5, 33, 63])
def test_selection_mirror_bit_equal_to_exact_pallas(topk):
    """Where the JAX exact kernel reproduces the scores bit for bit (unit
    queries, head dim 1), the mirror's threshold equals its threshold."""
    m = 64
    rng = np.random.default_rng(540)
    vals = (rng.normal(size=(m,)) * 10).astype(np.float32)
    vals[10] = vals[11]
    vals[12] = np.nextafter(vals[11], np.float32(1e30))
    vals[13] = np.nextafter(vals[11], np.float32(-1e30))
    vals[20:24] = -np.abs(vals[20:24])
    vals[30], vals[31] = 0.0, -0.0
    q = np.ones((1, 1, 4, 1), np.float32)
    k = vals.reshape(1, 1, m, 1)
    v = rng.normal(size=(1, 1, m, 1)).astype(np.float32)
    mask = np.ones((1, m), bool)
    mask[0, 50:] = False
    _, ref_t = pallas_topk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), topk,
        kv_mask=jnp.asarray(mask), interpret=True, return_threshold=True,
        exact=True)
    s = np.broadcast_to(vals, (1, 1, 4, m))
    got, want = _mirror(s, np.broadcast_to(mask[:, None, None, :], s.shape), topk)
    assert torch.equal(got, want)
    assert (got.numpy() == np.asarray(ref_t)).all()


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
def test_attention_plan_covers_every_supported_shape(dh):
    """The launch in ``csrc/attention.cu`` plans every key count up to 1024
    at every head size; the wrapper's shape check lets all of them through,
    dense and top-k."""
    assert dh in kernel.HEAD_DIMS
    for m in range(1, kernel.MAX_KEYS + 1):
        kernel.check_shape(m, dh, 128)
        kernel.check_shape(m, dh, 0)


@pytest.mark.parametrize("m, dh, topk", [
    (0, 32, 8), (1025, 32, 8), (256, 12, 8), (256, 128, 8), (256, 32, -1)])
def test_attention_plan_refuses_unsupported_shapes(m, dh, topk):
    with pytest.raises(ValueError, match="attention kernel"):
        kernel.check_shape(m, dh, topk)


def test_gemm_refuses_cpu_tensors():
    """The GEMM has no plain twin of its own (the layer's twin covers it):
    off the card it raises instead of computing something else."""
    a, w, b = torch.ones(4, 8), torch.ones(8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="GEMM kernel"):
        layer_kernel.gemm(a, w, b)


@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("r", [1, 511, 512, 513, 32768, 32769])
def test_tn_plan_covers_every_row_once(r, c):
    """Split z covers rows [z * rows, min(r, (z + 1) * rows)): together
    every row once, none empty, each a whole number of ring stages (the C
    entry refuses a plan that misses a row or leaves a split empty, and a
    scratch of other than splits * (K1 + 1) * C floats). At the train step's
    row count the grid fills the card with at most one block an SM, and the
    scratch stays under the operands' size."""
    k1 = 128
    rows, splits = layer_kernel.tn_plan(r, k1, c)
    assert rows % layer_kernel.TN_STAGE_ROWS == 0 and 1 <= splits <= 65535
    spans = [(z * rows, min(r, (z + 1) * rows)) for z in range(splits)]
    assert all(lo < hi for lo, hi in spans)                  # none empty
    assert spans[0][0] == 0 and spans[-1][1] == r
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # once each
    scratch = splits * (k1 + 1) * c
    if r >= 32768:
        blocks = splits * -(-c // layer_kernel.TN_TILE)
        assert layer_kernel.NUM_SMS // 2 < blocks <= layer_kernel.NUM_SMS
        assert scratch <= r * (k1 + c)


def test_gemm_tn_takes_its_twin_on_cpu():
    """On CPU tensors the transposed-A GEMM is ``(a^T b, colsum(b))``."""
    rng = np.random.default_rng(560)
    a, b = rng.normal(size=(513, 45)), rng.normal(size=(513, 70))
    dw, db = layer_kernel.gemm_tn(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(dw.numpy(), a.T @ b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(db.numpy(), b.sum(0), rtol=0, atol=1e-12)
