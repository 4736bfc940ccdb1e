"""Open3D match visualization (``plot_match``/``LineMesh``,
``utils/utils_test.py:149-403``).

A copy of ``mdgat_tpu/eval/visualize.py`` (numpy and Open3D, no JAX). Three
side-by-side panels over the two clouds: (1) predicted matches with
confidence-colored lines, (2) ground-truth matches in green, (3) true
positives green / false positives red. Keypoints render as red spheres and
match lines as cylinder meshes (Open3D line widths are unreliable, hence
the cylinder trick — same approach as the reference's LineMesh).

The geometry assembly (panel layout, line endpoints, per-line colors) is
pure numpy (:func:`assemble_match_panels`) so it runs under headless
pytest; only the rendering tail touches Open3D. Open3D is an optional
dependency (not required by train/eval); importing this module without it
raises only when the plot function is called.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _require_o3d():
    try:
        import open3d as o3d
        return o3d
    except ImportError as e:
        raise ImportError(
            "open3d is required for visualization: pip install open3d"
        ) from e


def assemble_match_panels(pc0, kpts0, kpts1, mkpts0, mkpts1, mkpts0_gt,
                          mkpts1_gt, matches, mconf, true_positive,
                          false_positive, offset: float = 50.0,
                          pc1=()) -> List[Dict]:
    """Pure-numpy layout of the three-panel comparison
    (``utils/utils_test.py:149-296`` panel scheme).

    Returns one dict per panel:
      ``spheres0``/``spheres1``  [N,3]/[M,3] keypoint sphere centers
      ``segments``               [K,2,3] match-line endpoints
      ``colors``                 [K,3] per-line RGB
      ``cloud0``/``cloud1``      [P,3] background scans or None
      ``cloud``                  alias of ``cloud0`` (back-compat)

    Cloud 1 sits ``offset/2`` above cloud 0 in y (same placement as the
    keypoints); panels stack at ``2*offset`` intervals. Both raw scans
    get the reference's ground cut ``z > -5``
    (``utils/utils_test.py:151-152``). Panel colors: (1) predictions
    shaded by confidence blue->red, (2) GT green, (3) TP green / FP red.
    """
    kpts0 = np.asarray(kpts0, np.float64)
    kpts1 = np.asarray(kpts1, np.float64)
    matches = np.asarray(matches)
    shift = np.array([0.0, offset, 0.0])

    def cut(pc):
        if not len(pc):
            return None
        pc = np.asarray(pc, np.float64)[:, :3]
        return pc[pc[:, 2] > -5]                 # utils_test.py:151-152

    bg0, bg1 = cut(pc0), cut(pc1)

    def panel(dy, pairs0, pairs1, colors):
        off = np.array([0.0, dy, 0.0])
        pairs0 = np.asarray(pairs0, np.float64).reshape(-1, 3)
        pairs1 = np.asarray(pairs1, np.float64).reshape(-1, 3)
        k = len(pairs0)
        segments = np.stack([pairs0 + off, pairs1 + off + shift / 2],
                            axis=1) if k else np.zeros((0, 2, 3))
        colors = np.asarray(colors, np.float64).reshape(-1, 3)
        line_colors = (colors[np.arange(k) % len(colors)] if k
                       else np.zeros((0, 3)))
        cloud0 = bg0 + off if bg0 is not None else None
        cloud1 = bg1 + off + shift / 2 if bg1 is not None else None
        return {
            "spheres0": kpts0 + off,
            "spheres1": kpts1 + off + shift / 2,
            "segments": segments,
            "colors": line_colors,
            "cloud0": cloud0,
            "cloud1": cloud1,
            "cloud": cloud0,
        }

    # panel 1: predictions colored by confidence (blue->red)
    conf_colors = [[float(c), 0.2, 1.0 - float(c)] for c in
                   np.clip(np.asarray(mconf, np.float64), 0, 1)] or [[0, 0, 1]]
    panels = [panel(0.0, mkpts0, mkpts1, conf_colors)]
    # panel 2: ground truth in green
    panels.append(panel(2 * offset, mkpts0_gt, mkpts1_gt, [[0, 1, 0]]))
    # panel 3: TP green / FP red (every valid prediction gets a line)
    tp_idx = np.nonzero(np.asarray(true_positive))[0]
    valid_idx = np.nonzero(matches > -1)[0]
    tp_set = set(tp_idx.tolist())
    colors3 = [[0, 1, 0] if i in tp_set else [1, 0, 0] for i in valid_idx]
    panels.append(panel(4 * offset, kpts0[valid_idx],
                        kpts1[matches[valid_idx]], colors3 or [[1, 0, 0]]))
    return panels


def _cylinder_lines(o3d, segments, colors, radius):
    """Cylinder meshes along each line segment (LineMesh equivalent)."""
    meshes = []
    for li, (p0, p1) in enumerate(np.asarray(segments)):
        seg = p1 - p0
        length = float(np.linalg.norm(seg))
        if length < 1e-9:
            continue
        mesh = o3d.geometry.TriangleMesh.create_cylinder(radius, length)
        mesh.paint_uniform_color(colors[li])
        # rotate z-axis onto the segment direction
        z = np.array([0.0, 0.0, 1.0])
        d = seg / length
        axis = np.cross(z, d)
        s = np.linalg.norm(axis)
        if s > 1e-9:
            axis = axis / s * np.arccos(np.clip(np.dot(z, d), -1, 1))
            R = o3d.geometry.get_rotation_matrix_from_axis_angle(axis)
            mesh.rotate(R, center=(0, 0, 0))
        mesh.translate((p0 + p1) / 2)
        meshes.append(mesh)
    return meshes


def _spheres(o3d, pts, color, radius=0.3):
    out = []
    for p in pts:
        s = o3d.geometry.TriangleMesh.create_sphere(radius)
        s.paint_uniform_color(color)
        s.translate(p)
        out.append(s)
    return out


def plot_match(pc0, pc1, kpts0, kpts1, mkpts0, mkpts1, mkpts0_gt, mkpts1_gt,
               matches, mconf, true_positive, false_positive,
               T: Optional[np.ndarray] = None, line_radius: float = 0.2,
               offset: float = 50.0):
    """Render the three-panel match comparison. Blocking Open3D window."""
    o3d = _require_o3d()
    panels = assemble_match_panels(pc0, kpts0, kpts1, mkpts0, mkpts1,
                                   mkpts0_gt, mkpts1_gt, matches, mconf,
                                   true_positive, false_positive, offset,
                                   pc1=pc1)
    geoms = []
    for p in panels:
        geoms += _spheres(o3d, p["spheres0"], [1, 0, 0])
        geoms += _spheres(o3d, p["spheres1"], [1, 0, 0])
        geoms += _cylinder_lines(o3d, p["segments"], p["colors"],
                                 line_radius)
        for key in ("cloud0", "cloud1"):
            if p[key] is not None:
                c = o3d.geometry.PointCloud()
                c.points = o3d.utility.Vector3dVector(p[key])
                c.paint_uniform_color([0.7, 0.7, 0.7])
                geoms.append(c)

    o3d.visualization.draw_geometries(geoms)
