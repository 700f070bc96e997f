# Copied from dmnerf_tpu/mesh/mc_tables.py.
"""Marching-cubes case tables, generated algorithmically.

The reference uses skimage.measure.marching_cubes (mesh_generator.py:68).
Rather than transcribing the classic 256x16 triangle table (an opaque blob
that cannot be reviewed), we DERIVE it: for each of the 256 corner-sign
configurations, trace the isosurface polygons by walking the cube's faces —
on each face the isoline pairs up the cut edges; on ambiguous (saddle) faces
the pairing keeps the INSIDE corners separated. Since a shared face has the
same corner signs seen from both neighboring cubes, both cubes make the same
pairing choice, so the mesh is crack-free and watertight by construction
(validated in tests/test_mesh.py: structural table checks + analytic
sphere/box isosurfaces).

Cube layout matches mesh/marching.py's _CORNERS:
  0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], np.int64)

# 12 cube edges as (corner_a, corner_b)
EDGES = np.array([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
], np.int64)

# 6 faces as corner cycles
_FACES = [
    (0, 1, 2, 3), (4, 5, 6, 7),
    (0, 1, 5, 4), (3, 2, 6, 7),
    (0, 3, 7, 4), (1, 2, 6, 5),
]

_EDGE_OF = {frozenset(e): i for i, e in enumerate(map(tuple, EDGES))}

MAX_TRIS = 5  # a cube case yields at most 5 triangles under this rule


# outward unit normals of _FACES, same order
_FACE_N = np.array([
    (0, 0, -1), (0, 0, 1),
    (0, -1, 0), (0, 1, 0),
    (-1, 0, 0), (1, 0, 0),
], np.float64)


def _case_polygons(case: int) -> List[List[int]]:
    """Isosurface polygons (lists of cut-edge indices) for one sign case,
    consistently oriented."""
    inside = [(case >> i) & 1 for i in range(8)]
    cut = [i for i, (a, b) in enumerate(EDGES) if inside[a] != inside[b]]
    if not cut:
        return []

    # pairing of cut edges per face: each cut edge gets one partner per
    # adjacent face -> every cut edge has exactly two links -> cycles.
    # Record the face of each link for the orientation rule below.
    links = {e: [] for e in cut}
    for fi, face in enumerate(_FACES):
        fedges = [_EDGE_OF[frozenset((face[k], face[(k + 1) % 4]))]
                  for k in range(4)]
        fcut = [e for e in fedges if e in links]
        if len(fcut) == 2:
            a, b = fcut
            links[a].append((b, fi))
            links[b].append((a, fi))
        elif len(fcut) == 4:
            # saddle: pair edges sharing an INSIDE corner (separates the two
            # inside corners; sign-symmetric across neighboring cubes)
            for i in range(4):
                for j in range(i + 1, 4):
                    ei, ej = fedges[i], fedges[j]
                    shared = set(EDGES[ei]) & set(EDGES[ej])
                    if shared and inside[shared.pop()]:
                        links[ei].append((ej, fi))
                        links[ej].append((ei, fi))

    for e, l in links.items():
        assert len(l) == 2, (case, e, l)

    mids = (CORNERS[EDGES[:, 0]] + CORNERS[EDGES[:, 1]]) / 2.0
    polys = []
    todo = set(cut)
    while todo:
        start = min(todo)
        poly = [start]
        faces_used = []
        todo.discard(start)
        prev, cur = None, start
        while True:
            nxt, fi = links[cur][0] if links[cur][0][0] != prev else links[cur][1]
            faces_used.append(fi)
            if nxt == start:
                break
            poly.append(nxt)
            todo.discard(nxt)
            prev, cur = cur, nxt

        # Orientation is decided PER FACE SEGMENT, which both cubes sharing a
        # face evaluate with opposite outward normals -> globally consistent
        # winding (a centroid/gradient heuristic is NOT: point-symmetric cases
        # degenerate and noisy gradients flip neighbors independently).
        # Rule: traverse each face's isoline with the INSIDE region on the
        # left when viewed from outside the cube. For the first segment
        # eA->eB on face F: keep iff dot(cross(n_F, s), inside_dir) > 0 where
        # s = mid(eB)-mid(eA) and inside_dir points from the segment toward
        # eA's inside corner (which lies on F). Empirically validated against
        # per-case exhaustive neighbor checks + the ascent-normal convention
        # (tests/test_mesh.py winding + sphere tests).
        eA, eB = poly[0], poly[1 % len(poly)]
        fi0 = faces_used[0]
        s = mids[eB] - mids[eA]
        iA = EDGES[eA][0] if inside[EDGES[eA][0]] else EDGES[eA][1]
        inside_dir = CORNERS[iA] - mids[eA]
        if np.dot(np.cross(_FACE_N[fi0], s), inside_dir) < 0:
            poly = poly[::-1]
        polys.append(poly)
    return polys


@functools.lru_cache(maxsize=1)
def build_tables() -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tri_table [256, 3*MAX_TRIS] int32, -1 padded;
    n_tris [256] int32). tri_table entries are cube-edge indices."""
    tri_table = -np.ones((256, 3 * MAX_TRIS), np.int32)
    n_tris = np.zeros(256, np.int32)
    for case in range(256):
        tris = []
        for poly in _case_polygons(case):
            for k in range(1, len(poly) - 1):  # fan triangulation
                tris.append((poly[0], poly[k], poly[k + 1]))
        assert len(tris) <= MAX_TRIS, (case, len(tris))
        n_tris[case] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[case, 3 * t:3 * t + 3] = tri
    return tri_table, n_tris
