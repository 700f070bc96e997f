# Copied from dmnerf_tpu/mesh/marching.py (the docstring's speed-up no longer names the host it was measured on).
"""Isosurface extraction: marching cubes (default) + marching tetrahedra.

The reference uses skimage.measure.marching_cubes (mesh_generator.py:68), which
is unavailable here. `marching_cubes` extracts the same cube-cell isosurface
with case tables DERIVED algorithmically (mesh/mc_tables.py) instead of a
transcribed blob; the crack-free saddle rule is validated by watertightness +
analytic-surface tests. `marching_tetrahedra` (each cube split into 6 tets —
more triangles, no tables at all) is kept as a cross-check/fallback. Vertices
are deduplicated on global edge ids; normals come from the trilinearly-
interpolated volume gradient (matching skimage's gradient_direction='ascent').
Both have C++ fast paths (native/marching.cpp, ~25x numpy at 256^3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# cube corner offsets (x, y, z)
_CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], np.int64)

# 6 tetrahedra sharing the 0-6 main diagonal
_TETS = np.array([
    (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
    (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
], np.int64)

# tet edges as (corner_a, corner_b) local indices
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

# case -> list of triangles, each a triple of tet-edge indices.
# case bit i set == corner i is "inside" (value > level).
_CASES = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 3, 4), (1, 4, 2)],
    0b0101: [(0, 2, 5), (0, 5, 3)],
    0b1001: [(0, 4, 5), (0, 5, 1)],
    0b0110: [(0, 5, 4), (0, 1, 5)],
    0b1010: [(0, 5, 2), (0, 3, 5)],
    0b1100: [(1, 4, 3), (1, 2, 4)],
    0b1110: [(0, 2, 1)],
    0b1101: [(0, 4, 3)],
    0b1011: [(1, 5, 3)],
    0b0111: [(2, 5, 4)],
}


def _interp_normals(volume: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Volume-gradient normals trilinearly sampled at vertex positions."""
    g = np.stack(np.gradient(volume.astype(np.float32)), axis=-1)  # [D0,D1,D2,3]
    base = np.floor(verts).astype(np.int64)
    mx = np.array(volume.shape) - 2
    base = np.clip(base, 0, mx)
    frac = verts - base
    out = np.zeros_like(verts)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (np.where(dx, frac[:, 0], 1 - frac[:, 0])
                     * np.where(dy, frac[:, 1], 1 - frac[:, 1])
                     * np.where(dz, frac[:, 2], 1 - frac[:, 2]))
                out += w[:, None] * g[base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz]
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-12)


def _dedup_and_finish(vol, ka, kb, t, D0, D1, D2):
    """Shared tail: canonical-edge dedup -> verts/faces/normals."""
    swap = ka > kb
    lo = np.where(swap, kb, ka)
    hi = np.where(swap, ka, kb)
    t = np.where(swap, 1.0 - t, t)

    edge_key = lo.astype(np.int64) * np.int64(D0 * D1 * D2) + hi
    uniq, inverse = np.unique(edge_key.ravel(), return_inverse=True)
    faces = inverse.reshape(-1, 3)

    rep = np.zeros(len(uniq))
    rep_lo = np.zeros(len(uniq), np.int64)
    rep_hi = np.zeros(len(uniq), np.int64)
    rep[inverse] = t.ravel()
    rep_lo[inverse] = lo.ravel()
    rep_hi[inverse] = hi.ravel()

    def unflatten(idx):
        z = idx % D2
        y = (idx // D2) % D1
        x = idx // (D1 * D2)
        return np.stack([x, y, z], -1).astype(np.float64)

    pa = unflatten(rep_lo)
    pb = unflatten(rep_hi)
    verts = pa + rep[:, None] * (pb - pa)

    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]
    normals = _interp_normals(vol, verts)
    return (verts.astype(np.float32), faces.astype(np.int64),
            normals.astype(np.float32))


def marching_cubes(volume: np.ndarray, level: float, slab: int = 32,
                   use_native: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract the `level` isosurface with marching cubes (generated tables).

    Returns (vertices [V,3] float in index coordinates, faces [F,3] int,
    vertex_normals [V,3], 'ascent' convention) — the same contract the
    reference gets from skimage.marching_cubes (mesh_generator.py:68).
    """
    from dmnerf_torch.mesh.mc_tables import EDGES, build_tables

    tri_table, n_tris = build_tables()
    vol = np.ascontiguousarray(volume, np.float32)
    D0, D1, D2 = vol.shape

    if use_native:
        from dmnerf_torch import native
        mod = native.load()
        if mod is not None and hasattr(mod, "marching_cubes"):
            verts, faces = mod.marching_cubes(
                vol, float(level), np.ascontiguousarray(tri_table),
                np.ascontiguousarray(EDGES.astype(np.int32)))
            if len(verts) == 0:
                return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                        np.zeros((0, 3), np.float32))
            return (verts.astype(np.float32), faces,
                    _interp_normals(vol, verts).astype(np.float32))

    all_ka, all_kb, all_t = [], [], []
    for z0 in range(0, D0 - 1, slab):
        z1 = min(z0 + slab, D0 - 1)
        bx, by, bz = np.meshgrid(np.arange(z0, z1), np.arange(D1 - 1),
                                 np.arange(D2 - 1), indexing="ij")
        base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], -1)

        corner_coords = base[:, None, :] + _CORNERS[None]
        vals = vol[corner_coords[..., 0], corner_coords[..., 1],
                   corner_coords[..., 2]]
        active = (vals.min(1) < level) & (vals.max(1) > level)
        if not active.any():
            continue
        vals = vals[active]
        corner_coords = corner_coords[active]
        cid = (corner_coords[..., 0] * D1 + corner_coords[..., 1]) * D2 \
            + corner_coords[..., 2]

        case = ((vals > level) << np.arange(8)).sum(-1)
        for cs in np.unique(case):
            nt = int(n_tris[cs])
            if nt == 0:
                continue
            sel = case == cs
            scid = cid[sel]
            svals = vals[sel]
            tris = tri_table[cs, :3 * nt].reshape(nt, 3)
            for tri in tris:
                ea = EDGES[tri, 0]
                eb = EDGES[tri, 1]
                ka = scid[:, ea]
                kb = scid[:, eb]
                va = svals[:, ea]
                vb = svals[:, eb]
                all_ka.append(ka)
                all_kb.append(kb)
                tt = (level - va) / np.where(vb - va == 0, 1e-12, vb - va)
                all_t.append(np.clip(tt, 0.0, 1.0))

    if not all_ka:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))
    return _dedup_and_finish(vol, np.concatenate(all_ka), np.concatenate(all_kb),
                             np.concatenate(all_t), D0, D1, D2)


def marching_tetrahedra(volume: np.ndarray, level: float, slab: int = 32,
                        use_native: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a 3D scalar volume.

    Returns (vertices [V, 3] float in index coordinates, faces [F, 3] int,
    vertex_normals [V, 3] pointing toward increasing values — skimage 'ascent').
    Uses the C++ extension (dmnerf_torch/native/marching.cpp, ~25x faster at
    256^3) when available; numpy fallback processes the volume in
    z-slabs to bound memory.
    """
    if use_native:
        from dmnerf_torch import native
        mod = native.load()
        if mod is not None:
            vol32 = np.ascontiguousarray(volume, np.float32)
            verts, faces = mod.marching_tetrahedra(vol32, float(level))
            if len(verts) == 0:
                return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                        np.zeros((0, 3), np.float32))
            normals = _interp_normals(vol32, verts)
            return (verts.astype(np.float32), faces,
                    normals.astype(np.float32))
    D0, D1, D2 = volume.shape
    all_keys_a, all_keys_b, all_t = [], [], []
    tri_edge_keys = []  # list of [n_tris, 3, 2] endpoint global-ids

    vol = volume.astype(np.float32)

    for z0 in range(0, D0 - 1, slab):
        z1 = min(z0 + slab, D0 - 1)
        # cube base coordinates in this slab
        bx, by, bz = np.meshgrid(np.arange(z0, z1), np.arange(D1 - 1),
                                 np.arange(D2 - 1), indexing="ij")
        base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], -1)  # [C, 3]

        corner_coords = base[:, None, :] + _CORNERS[None]           # [C, 8, 3]
        vals = vol[corner_coords[..., 0], corner_coords[..., 1],
                   corner_coords[..., 2]]                            # [C, 8]
        active = (vals.min(1) < level) & (vals.max(1) > level)
        if not active.any():
            continue
        base = base[active]
        vals = vals[active]
        corner_coords = corner_coords[active]
        # flat global corner ids for vertex dedup
        cid = (corner_coords[..., 0] * D1 + corner_coords[..., 1]) * D2 \
            + corner_coords[..., 2]                                  # [C, 8]

        for tet in _TETS:
            tv = vals[:, tet]                                        # [C, 4]
            tc = cid[:, tet]                                         # [C, 4]
            case = ((tv[:, 0] > level).astype(np.int32)
                    | ((tv[:, 1] > level) << 1)
                    | ((tv[:, 2] > level) << 2)
                    | ((tv[:, 3] > level) << 3))
            for cs, tris in _CASES.items():
                sel = case == cs
                if not sel.any():
                    continue
                stc = tc[sel]
                stv = tv[sel]
                for tri in tris:
                    # endpoints of the three cut edges
                    ea = np.array([_TET_EDGES[e][0] for e in tri])
                    eb = np.array([_TET_EDGES[e][1] for e in tri])
                    ka = stc[:, ea]  # [n, 3] global corner id a
                    kb = stc[:, eb]
                    va = stv[:, ea]
                    vb = stv[:, eb]
                    all_keys_a.append(ka)
                    all_keys_b.append(kb)
                    t = (level - va) / np.where(vb - va == 0, 1e-12, vb - va)
                    all_t.append(np.clip(t, 0.0, 1.0))

    if not all_keys_a:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))
    return _dedup_and_finish(vol, np.concatenate(all_keys_a),
                             np.concatenate(all_keys_b),
                             np.concatenate(all_t), D0, D1, D2)
