"""What the redesigned attention and GEMM kernels of the PyTorch port keep
off the card: the exact k-th-value search of ``csrc/attention.cu`` mirrored
step for step in plain PyTorch on int32 keys
(``ops/cuda/attention.py::selection_mirror``), held bit-equal to the twin's
threshold and to the JAX package's exact Pallas kernel (interpret mode, as
``tests/test_pallas.py`` runs it); the shapes the wrappers refuse before a
launch (the launches in ``csrc/`` plan tiles and shared memory); the row
splits of the transposed-A GEMM (``ops/cuda/layer.py::tn_plan``), whose
wrapper sizes the scratch from them and takes its plain twin on the CPU;
the Sinkhorn forward's cluster plan (``ops/cuda/sinkhorn.py::
sinkhorn_plan``: bands of rows a CTA, resident or streamed, shared memory);
the row plans of the train layer's h1, fwd2, dh2 and dw2 launches
(``ops/cuda/train_layer.py::h1_plan``, ``fwd2_plan``, ``dh2_plan``,
``dw2_plan``), whose check refuses a plan that misses or repeats a row,
with the wrappers' plain twins on CPU tensors; and the gap-loss forward's
cluster plan (``ops/cuda/gap_loss.py::gap_plan``: cluster size and bands of
rows a CTA).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.pallas import pallas_topk_attention

from mdgat_tpu_torch.ops.attention import BIG_NEG, topk_threshold
from mdgat_tpu_torch.ops.cuda import _build
from mdgat_tpu_torch.ops.cuda import attention as kernel
from mdgat_tpu_torch.ops.cuda import gap_loss as gap
from mdgat_tpu_torch.ops.cuda import layer as layer_kernel
from mdgat_tpu_torch.ops.cuda import sinkhorn as sk
from mdgat_tpu_torch.ops.cuda import train_layer as tl
from mdgat_tpu_torch.ops.mlp import BN_EPS


def _mirror(s, valid, topk):
    s = torch.from_numpy(np.array(s, np.float32))
    valid = torch.from_numpy(np.array(valid, bool))
    masked = torch.where(valid, s, torch.tensor(BIG_NEG, dtype=torch.float32))
    return (kernel.selection_mirror(s, valid, topk),
            topk_threshold(masked, valid, topk))


@pytest.mark.parametrize("m", [45, 200, 231, 256, 513, 1024, 1025, 1500,
                               4096])
@pytest.mark.parametrize("topk", [1, 8, 64, 128, 2000])
def test_selection_mirror_bit_equal_to_twin_threshold(m, topk):
    """Random scores of every sign, ragged masks, one all-masked row, and
    k from 1 to beyond the valid count; past 1024 keys the wide arm walks
    the same pivots over the slab."""
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


@pytest.mark.parametrize("m", [1025, 1500, 4096])
@pytest.mark.parametrize("topk", [1, 40, 128, 1000])
def test_selection_mirror_on_ties_past_1024_keys(m, topk):
    """The wide arm's key counts: heavy ties at the k-th value (every tie
    kept), signed zeros, an all-equal row, an all-masked row and a ragged
    mask; the mirror's threshold equals the twin's bit for bit."""
    rng = np.random.default_rng(530 + m + topk)
    rows = [np.round(rng.normal(size=m)), np.full(m, -0.25),
            np.where(rng.random(m) < 0.5, 0.0, -0.0),
            np.exp(rng.uniform(-60, 60, size=m)) * rng.choice([-1, 1], m),
            rng.normal(size=m)]
    s = np.stack(rows).astype(np.float32)
    valid = np.ones_like(s, bool)
    valid[:, m - 97:] = False
    valid[4] = False                                       # all masked
    got, want = _mirror(s, valid, topk)
    assert torch.equal(got, want)
    assert got[1, 0] == -0.25 and got[4, 0] == 1e30


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
    """The launch in ``csrc/attention.cu`` plans every key count at every
    head size (the register arms up to 1024 keys, the wide arm beyond); the
    wrapper's shape check lets all of them through, dense and top-k."""
    assert dh in kernel.HEAD_DIMS
    for m in list(range(1, 2049)) + [4095, 4096, 8192, 32768, 100000]:
        kernel.check_shape(m, dh, 128)
        kernel.check_shape(m, dh, 0)


@pytest.mark.parametrize("m, dh, topk", [
    (0, 32, 8), (-3, 32, 8), (256, 12, 8), (256, 128, 8), (256, 32, -1)])
def test_attention_plan_refuses_unsupported_shapes(m, dh, topk):
    with pytest.raises(ValueError, match="attention kernel"):
        kernel.check_shape(m, dh, topk)


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
@pytest.mark.parametrize("staged", [1, 2], ids=["forward", "backward_rows"])
def test_attention_wide_slab_plan(dh, staged):
    """The wide arm's score slab (``slab_floats``): none at or below 1024
    keys (the register arms); in shared memory, and so no scratch, while 8
    rows of it fit beside the key tile and the staged row tiles (227 KB);
    beyond, a slab of 8 rows for every block of the grid, so every query
    row of every (batch, head) has one. The first count that spills is
    the smallest whose 8-row slab passes the shared memory."""
    b, h, n = 2, 4, 1500
    first_global = None
    for m in range(1, 8193):
        floats = kernel.slab_floats(b, h, n, m, dh, staged)
        tile = max(kernel.KEY_TILE * (dh + 4), 128 * kernel.WIDE_ROWS)
        smem = 4 * (kernel.WIDE_ROWS * kernel.slab_stride(m) + tile
                    + staged * kernel.WIDE_ROWS * (dh + 4))
        if m <= kernel.REGISTER_KEYS or smem <= kernel.SMEM_CAP:
            assert floats == 0, m
            continue
        first_global = first_global or m
        blocks = -(-n // kernel.WIDE_ROWS) * b * h
        assert floats == blocks * kernel.WIDE_ROWS * kernel.slab_stride(m)
        assert floats >= b * h * n * m           # a row of slab a query row
    assert 4096 < first_global < 8192            # 4096 keys stay on chip


def test_wide_scratch_is_refused_for_memory_naming_the_plain_route(monkeypatch):
    """The wide arms' only limit is device memory: a scratch larger than the
    card's free memory (and what PyTorch's allocator holds unused) raises a
    ValueError that names ``use_kernels=False`` before any allocation; no
    scratch needs no card."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (4000, 10 ** 10))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 3000)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1000)
    monkeypatch.setattr(torch, "empty", lambda *a, **k: pytest.fail("allocated"))
    assert _build.device_scratch(0, "cuda:0", "attention kernel") is None
    with pytest.raises(ValueError, match="use_kernels=False"):
        _build.device_scratch(1501, "cuda:0", "attention kernel (8192 keys)")


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


def _no_library(monkeypatch):
    def refuse(*_):
        raise AssertionError("a launch reached the kernel library")
    for mod in (_build, sk, tl, gap):
        monkeypatch.setattr(mod, "library", refuse)


SIZES = [1, 31, 200, 256, 257, 512, 513, 1024]


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("n", SIZES)
def test_sinkhorn_plan_bands_cover_every_row_once(n, m):
    """For a pair of n x m scores the plan's cluster splits the rows into
    bands of ceil(n / G): together every row once, no CTA without a row;
    the band stays resident wherever some cluster size lets it, and the
    CTA's shared memory (resident or streamed) is at most 227 KB."""
    for b in (1, 8, 64):
        g, resident = sk.sinkhorn_plan(b, n, m)
        assert 1 <= g <= sk.MAX_CLUSTER
        band = -(-n // g)
        spans = [(r * band, min(n, (r + 1) * band)) for r in range(g)]
        assert all(lo < hi for lo, hi in spans)                   # none empty
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))  # once each
        assert resident == sk.fwd_resident(n, m, g)
        assert sk.fwd_smem_bytes(band, m, resident) <= 227 * 1024
        fits_somewhere = any(sk.fwd_resident(n, m, c)
                             for c in (1, 2, 4, 8, 16))
        assert resident == fits_somewhere
        # a small batch spreads over the card: doubling the cluster would
        # overfill one wave, pass the portable 8 or leave a CTA without rows
        g2 = 2 * g
        assert (g >= 8 or b * g2 > layer_kernel.NUM_SMS
                or (g2 - 1) * -(-n // g2) >= n)


WIDE_N = [1, 31, 1025, 1500, 4096, 16385, 32768]
WIDE_M = [1025, 1500, 2048, 4096, 8192]


@pytest.mark.parametrize("m", WIDE_M)
@pytest.mark.parametrize("n", WIDE_N)
def test_sinkhorn_wide_plans_cover_every_row_once(n, m):
    """Above 1024 columns both kernels take their wide arm: the forward's
    plan streams (never resident) on clusters of 8 doubled up to 16 for a
    small batch, its shared memory a few bytes and its scratch every CTA's
    vectors; the backward's plan names a cluster and a scratch of its own.
    Both plans' bands cover every row once with no CTA empty."""
    for b in (1, 2, 8, 64):
        for g, resident, floats in (
                (*sk.sinkhorn_plan(b, n, m), None), (*sk.bwd_plan(b, n, m),)[:1]
                + (False, sk.bwd_plan(b, n, m)[1])):
            assert 1 <= g <= sk.MAX_CLUSTER and not resident
            band = -(-n // g)
            spans = [(r * band, min(n, (r + 1) * band)) for r in range(g)]
            assert all(lo < hi for lo, hi in spans)
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
            assert g >= 8 or (g - 1) * -(-n // (2 * g)) < n <= 8 * band
            if floats is None:     # the forward
                assert sk.fwd_wide(n, m, g)
                mp = -(-m // 4) * 4
                assert (sk.fwd_scratch_floats(b, n, m, g)
                        >= b * g * (5 * mp + band))
            else:
                assert sk.bwd_wide(n, m, g)
                assert floats == sk.bwd_scratch_floats(b, n, m, g) > 0


@pytest.mark.parametrize("n", [1, 512, 1024, 16384, 32768, 300000])
def test_sinkhorn_register_arms_up_to_1024_columns(n):
    """At 1024 columns and below the register arms keep their plans at
    every row count whose streamed band fits in shared memory (no scratch);
    a band too long for it (hundreds of thousands of rows) goes to the
    wide arm instead of being refused."""
    for m in (1, 256, 512, 1024):
        g, resident = sk.sinkhorn_plan(8, n, m)
        band = -(-n // g)
        if sk.fwd_wide(n, m, g):
            assert n >= 100000 and not resident
            assert sk.fwd_scratch_floats(8, n, m, g) > 0
        else:
            assert sk.fwd_scratch_floats(8, n, m, g) == 0
            assert sk.fwd_smem_bytes(band, m, resident) <= sk.SMEM_CAP
        bg, floats = sk.bwd_plan(8, n, m)
        assert (bg, floats) == ((0, 0) if not sk.bwd_wide(n, m, 8)
                                else (bg, sk.bwd_scratch_floats(8, n, m, bg)))
        if (bg, floats) == (0, 0):
            assert sk.bwd_smem_bytes(-(-n // 8), m) <= sk.SMEM_CAP


def test_sinkhorn_plan_at_the_main_path_shapes():
    """Serving (64 x 256 x 256) and the train step (64 x 512 x 512) keep
    their bands on chip; 8 x 1024 x 1024 streams on clusters of 8."""
    assert sk.sinkhorn_plan(64, 512, 512) == (8, True)
    g, resident = sk.sinkhorn_plan(64, 256, 256)
    assert resident and 64 * g <= layer_kernel.NUM_SMS
    assert sk.sinkhorn_plan(8, 1024, 1024) == (8, False)


@pytest.mark.parametrize("cluster", [17, -1, 32, 1024])
def test_sinkhorn_launch_refuses_bad_parameters(monkeypatch, cluster):
    """A cluster size outside 1-16 is refused before the kernel library."""
    _no_library(monkeypatch)
    b, n, m = 2, 40, 50
    z = torch.zeros((b, n, m), device="meta")
    with pytest.raises(ValueError, match="CTAs a pair"):
        sk._forward(z, torch.zeros((b, 4), device="meta"),
                    torch.zeros((b, n), device="meta"),
                    torch.zeros((b, m), device="meta"), 20, cluster)


def test_sinkhorn_entry_takes_its_twin_on_cpu(monkeypatch):
    """A CPU tensor takes the plain transport and never reaches the kernel
    library; the launch counts stay where they were."""
    _no_library(monkeypatch)
    rng = np.random.default_rng(570)
    scores = torch.from_numpy(rng.normal(size=(3, 37, 45)).astype(np.float32))
    rm = torch.from_numpy(np.arange(37)[None] < np.array([[37], [30], [5]]))
    cm = torch.from_numpy(np.arange(45)[None] < np.array([[45], [1], [40]]))
    before = (sk.log_optimal_transport_kernel.launches,
              sk.log_optimal_transport_kernel.backward_launches)
    for iters in (0, 20):
        got = sk.log_optimal_transport_kernel(scores, 0.7, iters, rm, cm)
        want = sk.log_optimal_transport_reference(scores, 0.7, iters, rm, cm)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert before == (sk.log_optimal_transport_kernel.launches,
                      sk.log_optimal_transport_kernel.backward_launches)


@pytest.mark.parametrize("r", [1, 63, 64, 65, 1000, 8191, 32767, 32768,
                               32769, 70000])
def test_dh2_plan_covers_every_row_once(r):
    """Block z covers rows [z * rows, min(r, (z + 1) * rows)): together
    every row once, none empty, whole 64-row tiles, at most one block an SM;
    the train step's 32768 rows go to 128 blocks of four tiles."""
    rows, blocks = tl.dh2_plan(r)
    tl.check_row_plan("dh2", r, rows, blocks, tl.DH2_TILE_ROWS)
    assert rows % tl.DH2_TILE_ROWS == 0 and 1 <= blocks <= layer_kernel.NUM_SMS
    spans = [(z * rows, min(r, (z + 1) * rows)) for z in range(blocks)]
    assert all(lo < hi for lo, hi in spans)
    assert spans[0][0] == 0 and spans[-1][1] == r
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    if r == 32768:
        assert (rows, blocks) == (256, 128)


@pytest.mark.parametrize("rows, blocks", [(0, 1), (64, 15), (64, 17),
                                          (100, 10), (1024, 2), (-64, 1)])
def test_dh2_plan_refused_before_any_launch(monkeypatch, rows, blocks):
    """For 1000 rows: a plan that misses rows, leaves a block empty or cuts
    a tile is refused by the check (the C entries refuse the same plans)
    while the wrappers' own plan passes it; both wrappers stop at the device
    check before the kernel library (tensors on the meta device, which no
    kernel takes)."""
    _no_library(monkeypatch)
    r, d = 1000, 32
    with pytest.raises(ValueError, match="row plan"):
        tl.check_row_plan("dh2", r, rows, blocks, tl.DH2_TILE_ROWS)
    tl.check_row_plan("dh2", r, *tl.dh2_plan(r), tl.DH2_TILE_ROWS)
    meta = lambda *shape: torch.zeros(shape, device="meta")
    g, h1, w2 = meta(r, d), meta(r, 2 * d), meta(2 * d, d)
    for call in (lambda: tl.bn_backward_sums(g, h1, w2, meta(4, 2 * d)),
                 lambda: tl.dh1_kernel(g, h1, w2, meta(6, 2 * d), None)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_dh2_wrappers_take_their_twins_on_cpu(monkeypatch):
    """On CPU tensors the two dh2 wrappers are their formulas (numpy at
    float64, 100 rows: not whole tiles): the four sums over every row, and
    dh1 with the row mask on the centering correction only."""
    _no_library(monkeypatch)
    rng = np.random.default_rng(580)
    r, d = 100, 24
    g, h1 = rng.normal(size=(r, d)), rng.normal(size=(r, 2 * d))
    w2 = rng.normal(size=(2 * d, d))
    mean, var = rng.normal(size=2 * d) * 0.3, rng.uniform(0.5, 1.5, 2 * d)
    scale, bias = rng.uniform(0.5, 1.5, 2 * d), rng.normal(size=2 * d) * 0.2
    c1, c2 = rng.normal(size=2 * d), rng.normal(size=2 * d)
    mask = rng.random(r) < 0.7
    inv = 1 / np.sqrt(var + BN_EPS)
    hhat = (h1 - mean) * inv
    dbn = (g @ w2.T) * (hhat * scale + bias > 0)
    big_g = dbn * scale
    t = torch.from_numpy
    vec4 = t(np.stack([mean, inv, scale, bias]))
    sums = tl.bn_backward_sums(t(g), t(h1), t(w2), vec4)
    want = np.stack([big_g.sum(0), (big_g * hhat).sum(0), (dbn * hhat).sum(0),
                     dbn.sum(0)])
    np.testing.assert_allclose(sums.numpy(), want, rtol=0, atol=1e-9)
    vec6 = t(np.stack([mean, inv, scale, bias, c1, c2]))
    dh1 = tl.dh1_kernel(t(g), t(h1), t(w2), vec6,
                        t(mask.astype(np.uint8)))
    want = inv * (big_g - (c1 + hhat * c2) * mask[:, None])
    np.testing.assert_allclose(dh1.numpy(), want, rtol=0, atol=1e-9)
    ref = tl.bn_backward_sums_reference(t(g), t(h1), t(w2), t(mean), t(var),
                                        t(scale), t(bias))
    for a, b in zip(sums, (ref[0], ref[1], ref[4], ref[5])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)


PLAN_ROWS = [1, 63, 64, 65, 1000, 32767, 32768, 32769, 70000]


@pytest.mark.parametrize("kind", ["h1", "dw2", "fwd2"])
@pytest.mark.parametrize("r", PLAN_ROWS)
def test_h1_and_dw2_plans_cover_every_row_once(kind, r):
    """Block z covers rows [z * rows, min(r, (z + 1) * rows)): together
    every row once, none empty, whole tiles (128-row tiles of h1 and fwd2,
    32-row ring stages of dw2), at most one block an SM over the grid (two
    column halves of h1, the two 128 x 128 output tiles of dw2 at D = 128,
    one column block of fwd2); the train step's 32768 rows go to 64 row
    blocks of 512 in h1 and dw2, to 128 blocks of 256 in fwd2."""
    if kind == "h1":
        rows, blocks = tl.h1_plan(r)
        tile, per_block, at_train = tl.H1_TILE_ROWS, 2, (512, 64)
    elif kind == "dw2":
        rows, blocks = tl.dw2_plan(r, 128)
        tile, per_block, at_train = layer_kernel.TN_STAGE_ROWS, 2, (512, 64)
    else:
        rows, blocks = tl.fwd2_plan(r)
        tile, per_block, at_train = tl.FWD2_TILE_ROWS, 1, (256, 128)
    tl.check_row_plan(kind, r, rows, blocks, tile)
    assert rows % tile == 0 and 1 <= blocks * per_block <= layer_kernel.NUM_SMS
    spans = [(z * rows, min(r, (z + 1) * rows)) for z in range(blocks)]
    assert all(lo < hi for lo, hi in spans)
    assert spans[0][0] == 0 and spans[-1][1] == r
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    if r == 32768:
        assert (rows, blocks) == at_train


def test_fwd2_plan_covers_every_row_count_up_to_70000():
    """fwd2_plan for every R in 1 .. 70000: the check passes (every row
    once, whole 128-row tiles, no block empty) within one block an SM, and
    the blocks use as few tiles each as the SMs allow."""
    for r in range(1, 70001):
        rows, blocks = tl.fwd2_plan(r)
        tiles = -(-r // tl.FWD2_TILE_ROWS)
        assert blocks <= layer_kernel.NUM_SMS
        assert rows == -(-tiles // layer_kernel.NUM_SMS) * tl.FWD2_TILE_ROWS
        assert rows * blocks >= r > rows * (blocks - 1)


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_dw2_plan_fills_the_card_at_every_width(d):
    """The dw2 splits times the output's 128 x 128 tiles stay within one
    block an SM at every width the route takes, and fill most of the SMs."""
    rows, splits = tl.dw2_plan(32768, d)
    tiles = -(-2 * d // 128) * -(-d // 128)
    assert rows % layer_kernel.TN_STAGE_ROWS == 0
    assert layer_kernel.NUM_SMS // 2 < splits * tiles <= layer_kernel.NUM_SMS


@pytest.mark.parametrize("rows, blocks, tile", [
    (0, 1, 128), (128, 7, 128), (128, 9, 128), (100, 10, 128), (1024, 2, 128),
    (-128, 1, 128), (32, 31, 32), (32, 33, 32), (48, 21, 32), (992, 1, 32)])
def test_h1_and_dw2_plans_refused_before_any_launch(monkeypatch, rows, blocks,
                                                    tile):
    """For 1000 rows: a plan that misses rows, leaves a block empty or cuts
    a tile (128 rows for h1, 32 for dw2) is refused by the check (the C
    entries refuse the same plans) while the wrappers' own plans pass it;
    both wrappers stop at the device check before the kernel library
    (tensors on the meta device, which no kernel takes)."""
    _no_library(monkeypatch)
    r, d = 1000, 32
    with pytest.raises(ValueError, match="row plan"):
        tl.check_row_plan("plan", r, rows, blocks, tile)
    tl.check_row_plan("h1", r, *tl.h1_plan(r), tl.H1_TILE_ROWS)
    tl.check_row_plan("fwd2", r, *tl.fwd2_plan(r), tl.FWD2_TILE_ROWS)
    tl.check_row_plan("dw2", r, *tl.dw2_plan(r, d), layer_kernel.TN_STAGE_ROWS)
    meta = lambda *shape: torch.zeros(shape, device="meta")
    for call in (lambda: tl.h1_stats(meta(r, d), meta(r, d), meta(2 * d, 2 * d),
                                     meta(2 * d), None),
                 lambda: tl.bn_relu_conv2(meta(r, d), meta(r, 2 * d), meta(2 * d),
                                          meta(2 * d), meta(2 * d, d), meta(d)),
                 lambda: tl.dw2_db2(meta(r, d), meta(r, 2 * d), meta(4, 2 * d))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_h1_and_dw2_wrappers_take_their_twins_on_cpu(monkeypatch):
    """On CPU tensors the h1, fwd2 and dw2 wrappers are their formulas
    (numpy at float64, 100 rows: not whole tiles): h1 = x @ w1x + msg @ w1m
    + b1 with the sums of h1 * m and h1^2 * m over the masked rows, y = x +
    relu(h1 * a + c) @ w2 + b2, and relu(bn(h1))^T g with the column sums of
    g over every row; the launch counts stay where they were."""
    _no_library(monkeypatch)
    rng = np.random.default_rng(590)
    r, d = 100, 24
    x, msg, g = (rng.normal(size=(r, d)) for _ in range(3))
    w1, b1 = rng.normal(size=(2 * d, 2 * d)), rng.normal(size=2 * d)
    h1 = rng.normal(size=(r, 2 * d))
    mean, var = rng.normal(size=2 * d) * 0.3, rng.uniform(0.5, 1.5, 2 * d)
    scale, bias = rng.uniform(0.5, 1.5, 2 * d), rng.normal(size=2 * d) * 0.2
    mask = rng.random(r) < 0.7
    t = torch.from_numpy
    got_h1, sums = tl.h1_stats(t(x), t(msg), t(w1), t(b1), t(mask.astype(np.uint8)))
    want = np.concatenate([x, msg], 1) @ w1 + b1
    np.testing.assert_allclose(got_h1.numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sums.numpy(), np.stack(
        [want[mask].sum(0), (want[mask] ** 2).sum(0)]), rtol=0, atol=1e-9)
    _, all_rows = tl.h1_stats(t(x), t(msg), t(w1), t(b1), None)
    np.testing.assert_allclose(all_rows[0].numpy(), want.sum(0), rtol=0, atol=1e-9)
    inv = 1 / np.sqrt(var + BN_EPS)
    u = np.maximum((h1 - mean) * inv * scale + bias, 0)
    dw2, db2 = tl.dw2_db2(t(g), t(h1), t(np.stack([mean, inv, scale, bias])))
    np.testing.assert_allclose(dw2.numpy(), u.T @ g, rtol=0, atol=1e-9)
    np.testing.assert_allclose(db2.numpy(), g.sum(0), rtol=0, atol=1e-9)
    a, c = scale * inv, bias - mean * scale * inv
    w2, b2 = rng.normal(size=(2 * d, d)), rng.normal(size=d)
    launches = (tl.h1_stats.launches, tl.bn_relu_conv2.launches,
                tl.dw2_db2.launches)
    y = tl.bn_relu_conv2(t(x.reshape(4, 25, d)), t(h1), t(a), t(c), t(w2), t(b2))
    assert y.shape == (4, 25, d) and y.dtype == torch.float64
    np.testing.assert_allclose(
        y.numpy().reshape(r, d), x + np.maximum(h1 * a + c, 0) @ w2 + b2,
        rtol=0, atol=1e-9)
    assert launches == (tl.h1_stats.launches, tl.bn_relu_conv2.launches,
                        tl.dw2_db2.launches)


GAP_ROWS = range(1, 1025)


@pytest.mark.parametrize("b", [1, 3, 8, 64, 5000])
def test_gap_plan_bands_cover_every_row_once(b):
    """For every N in 1 .. 1024 (and M over the same range, which leaves
    the plan as it is): a legal cluster size (a power of two of 1-16; above
    8 the launch sets the non-portable attribute), bands of at most 1024
    rows that together cover every row once with no CTA empty, and the card
    filled where the batch allows (a larger cluster would pass one wave of
    a CTA an SM, pass 16 or leave a CTA without rows)."""
    for n in GAP_ROWS:
        g, band = gap.gap_plan(b, n, 1 + (n * 7) % 1024)
        assert 1 <= g <= gap.MAX_CLUSTER and g & (g - 1) == 0 and band <= 1024
        spans = [(r * band, min(n, (r + 1) * band)) for r in range(g)]
        assert all(lo < hi for lo, hi in spans)                   # none empty
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))  # once each
        g2 = 2 * g
        assert (g2 > gap.MAX_CLUSTER or b * g2 > layer_kernel.NUM_SMS
                or (g2 - 1) * -(-n // g2) >= n)
    for m in GAP_ROWS:
        assert gap.gap_plan(b, 512, m) == gap.gap_plan(b, 512, 512)


def test_gap_plan_at_the_main_path_shapes_and_refused_shapes(monkeypatch):
    """The train step's 64 x 512 x 512 runs clusters of 2 CTAs of 256 rows
    (128 CTAs), 8 x 1024 x 1024 clusters of 16 (128 CTAs); a 1-row pair a
    cluster of one; 4096 rows in bands of at most 1024 rows. More than 1024
    columns or 16384 rows is taken (columns in chunks, a band in pieces of
    1024 rows); no row, no column or no pair is refused by the plan and,
    on meta-device tensors, by the forward before the kernel library."""
    _no_library(monkeypatch)
    monkeypatch.setattr(gap, "_launch", lambda *_: pytest.fail("launched"))
    assert gap.gap_plan(64, 512, 512) == (2, 256)
    assert gap.gap_plan(8, 1024, 1024) == (16, 64)
    assert gap.gap_plan(64, 1, 1) == (1, 1)
    assert gap.gap_plan(2, 1024, 1024) == (16, 64)
    assert gap.gap_plan(200, 4096, 10) == (4, 1024)
    assert gap.gap_plan(1, 16384, 10) == (16, 1024)
    assert gap.gap_plan(2, 10, 1025) == gap.gap_plan(2, 10, 10)
    assert gap.gap_plan(1, 16385, 10) == (16, 1025)
    for b, n, m in ((2, 0, 10), (0, 10, 10), (2, 10, 0)):
        with pytest.raises(ValueError, match="at least one row"):
            gap.gap_plan(b, n, m)
    meta = lambda *shape, dt=torch.float32: torch.zeros(shape, device="meta",
                                                         dtype=dt)
    b, n, m = 2, 10, 0
    with pytest.raises(ValueError, match="at least one row"):
        gap._margins_forward(meta(b, n, m), meta(b, m), meta(b, n),
                             meta(b, n, dt=torch.int32),
                             meta(b, m, dt=torch.int32), None, None, 0.5)


GAP_WIDE_N = [1, 1000, 1025, 1500, 4096, 16384, 16385, 20000, 32768]
GAP_WIDE_M = [1, 512, 1024, 1025, 1500, 4096, 8192]


@pytest.mark.parametrize("b", [1, 2, 8, 64])
def test_gap_plans_take_wide_clouds(b):
    """The gap-loss plan (the forward's and the backward's) at N up to
    32768 and M up to 8192: a legal cluster (a power of two of 1-16),
    bands that cover every row once with no CTA empty, in pieces of at
    most 1024 rows past 16 CTAs, the columns leaving the plan as it is,
    and one wave of a CTA an SM filled where the batch allows (a larger
    cluster would pass it, pass 16 or leave a CTA without rows)."""
    for n in GAP_WIDE_N:
        g, band = gap.gap_plan(b, n, 512)
        assert 1 <= g <= gap.MAX_CLUSTER and g & (g - 1) == 0
        assert band == -(-n // g) and (band <= gap.PIECE or g == 16)
        spans = [(r * band, min(n, (r + 1) * band)) for r in range(g)]
        assert all(lo < hi for lo, hi in spans)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        g2 = 2 * g
        assert (g2 > gap.MAX_CLUSTER or b * g2 > layer_kernel.NUM_SMS
                or (g2 - 1) * -(-n // g2) >= n)
        for m in GAP_WIDE_M:
            assert gap.gap_plan(b, n, m) == (g, band)
