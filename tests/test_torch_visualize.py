"""The port's match-panel assembly (``mdgat_tpu_torch/eval/visualize.py``,
its own numpy copy) against ``mdgat_tpu/eval/visualize.py``: the fixtures of
``tests/test_visualize.py`` through both, every array equal; and
``plot_match`` raises the open3d ImportError where open3d is absent."""

import sys

import numpy as np
import pytest

from mdgat_tpu.eval.visualize import assemble_match_panels as jax_panels
from test_visualize import _fixture

from mdgat_tpu_torch.eval import visualize


def _args(f):
    return (f["kpts0"], f["kpts1"], f["mkpts0"], f["mkpts1"], f["mk0_gt"],
            f["mk1_gt"], f["matches"], f["mconf"], f["tp"], f["fp"])


def _empty(f):
    f = dict(f, matches=np.full(4, -1), mconf=np.zeros((0,)),
             tp=np.zeros(4, bool), fp=np.zeros(4, bool))
    for k in ("mkpts0", "mkpts1", "mk0_gt", "mk1_gt"):
        f[k] = np.zeros((0, 3))
    return f


def _clouds():
    pc0 = np.zeros((7, 3))
    pc0[:3, 2] = -10.0
    return pc0, np.full((5, 3), 2.0)


@pytest.mark.parametrize("case", ["keypoints", "clouds", "no_matches"])
@pytest.mark.parametrize("offset", [50.0, 12.5])
def test_panels_equal_the_jax_package(case, offset):
    f = _fixture() if case != "no_matches" else _empty(_fixture())
    pc0, pc1 = _clouds() if case == "clouds" else ((), ())
    got = visualize.assemble_match_panels(pc0, *_args(f), offset=offset,
                                          pc1=pc1)
    want = jax_panels(pc0, *_args(f), offset=offset, pc1=pc1)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_plot_match_needs_open3d(monkeypatch):
    """Without open3d (neither the CPU host nor the card machine has it;
    made absent here whatever is installed) the guard raises before any
    rendering."""
    monkeypatch.setitem(sys.modules, "open3d", None)
    f = _fixture()
    with pytest.raises(ImportError, match="open3d is required"):
        visualize.plot_match([], [], *_args(f)[:6], f["matches"], f["mconf"],
                             f["tp"], f["fp"])
