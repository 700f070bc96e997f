# Copied from dmnerf_tpu/mesh/grid.py (the reference checkout's absolute path in the docstring became "the reference's").
"""3D query-grid construction for meshing.

Parity with the reference's tools/visualizer.py:111-155 (make_3D_grid /
grid_within_bound): a normalized [-1, 1]^3 grid of grid_dim^3 points, scaled by
extents/2 and transformed by the scene's oriented-bounds transform.

The reference obtains the transform from a GT .ply via trimesh's oriented
bounds (mesh_generator.py:23-27). `oriented_bounds` reimplements that
algorithm (convex hull -> per-hull-face rotating-calipers minimal rectangle ->
min volume over faces; by O'Rourke's flush-face property this is the same
search trimesh does) on scipy's ConvexHull. A PCA fallback remains for
degenerate clouds. Config-driven extents remain the default knob (SURVEY.md §7
hard parts).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _min_area_rect(pts2: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Rotating calipers: minimal-area enclosing rectangle of 2D points.
    Returns (area, R2 [2,2] rows = rect axes, extents2 [2])."""
    from scipy.spatial import ConvexHull

    hull = pts2[ConvexHull(pts2).vertices]
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    ang = np.arctan2(edges[:, 1], edges[:, 0])
    ang = np.unique(np.mod(ang, np.pi / 2))
    c, s = np.cos(ang), np.sin(ang)
    # rotate hull by each candidate edge angle, take axis-aligned bbox
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], 1)  # [A,2,2]
    proj = rot @ hull.T                                               # [A,2,H]
    lo, hi = proj.min(-1), proj.max(-1)                               # [A,2]
    wh = hi - lo
    areas = wh[:, 0] * wh[:, 1]
    k = int(np.argmin(areas))
    return float(areas[k]), rot[k], wh[k]


def oriented_bounds(vertices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-volume oriented bounding box over hull-face-flush orientations
    (the same search as trimesh.bounds.oriented_bounds).

    Returns (to_origin [4,4], extents [3]): to_origin maps scene coords into
    the box frame centered at the origin.
    """
    from scipy.spatial import ConvexHull

    v = np.asarray(vertices, np.float64)
    try:
        hull = ConvexHull(v)
    except Exception:
        return oriented_bounds_pca(v)
    hv = v[hull.vertices]
    # unique face normals, sign-canonicalized on the first nonzero component
    # so n and -n dedup to one row
    normals = hull.equations[:, :3]
    first_nz = normals[np.arange(len(normals)),
                       np.argmax(np.abs(normals) > 1e-12, axis=1)]
    normals = normals * np.where(first_nz < 0, -1.0, 1.0)[:, None]
    normals = np.unique(np.round(normals, 9), axis=0)

    best = (np.inf, None, None)
    for n in normals:
        n = n / np.linalg.norm(n)
        # plane basis orthogonal to n
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        u = np.cross(n, a)
        u /= np.linalg.norm(u)
        w = np.cross(n, u)
        pts2 = np.stack([hv @ u, hv @ w], -1)
        area, R2, wh = _min_area_rect(pts2)
        h = hv @ n
        height = h.max() - h.min()
        vol = area * height
        if vol < best[0]:
            # box axes in scene coords: rows of R (box frame <- scene)
            R = np.vstack([R2[0, 0] * u + R2[0, 1] * w,
                           R2[1, 0] * u + R2[1, 1] * w, n])
            best = (vol, R, np.array([wh[0], wh[1], height]))

    vol, R, extents = best
    if R is None:
        return oriented_bounds_pca(v)
    if np.linalg.det(R) < 0:
        R[2] *= -1
    local = hv @ R.T
    lo, hi = local.min(0), local.max(0)
    center_local = (lo + hi) / 2
    to_origin = np.eye(4)
    to_origin[:3, :3] = R
    to_origin[:3, 3] = -center_local
    return to_origin, extents


def oriented_bounds_pca(vertices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """PCA-approximate oriented bounding box (fallback for degenerate clouds).

    Returns (to_origin [4,4], extents [3]): to_origin maps scene coords into the
    box frame centered at the origin (same contract as trimesh.bounds.oriented_bounds).
    """
    v = np.asarray(vertices, np.float64)
    centroid = v.mean(0)
    cov = np.cov((v - centroid).T)
    _, vecs = np.linalg.eigh(cov)
    R = vecs[:, ::-1].T  # principal axes, descending variance
    if np.linalg.det(R) < 0:
        R[2] *= -1
    local = (v - centroid) @ R.T
    lo, hi = local.min(0), local.max(0)
    extents = hi - lo
    center_local = (lo + hi) / 2
    to_origin = np.eye(4)
    to_origin[:3, :3] = R
    to_origin[:3, 3] = -(R @ centroid + center_local)
    return to_origin, extents


def make_3d_grid(occ_range, dim: int, transform: np.ndarray = None,
                 scale: np.ndarray = None) -> np.ndarray:
    t = np.linspace(occ_range[0], occ_range[1], dim)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    grid = np.stack([gx, gy, gz], -1)
    if scale is not None:
        grid = grid * scale
    if transform is not None:
        grid = grid @ transform[:3, :3].T + transform[:3, 3]
    return grid


def grid_within_bound(occ_range, extents: np.ndarray, transform: np.ndarray,
                      grid_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    range_dist = occ_range[1] - occ_range[0]
    scene_scale = np.asarray(extents, np.float64) / range_dist
    grid = make_3d_grid(occ_range, grid_dim, transform=transform, scale=scene_scale)
    return grid.reshape(-1, 3), scene_scale
