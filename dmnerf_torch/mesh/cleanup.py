# Copied from dmnerf_tpu/mesh/cleanup.py.
"""Mesh cleanup: remove small connected triangle clusters.

Replaces open3d's cluster_connected_triangles + remove_triangles_by_mask
(visualizer.py:169-194, mesh_generator.py:98): triangles are connected iff they
share an edge; clusters below min_num_cluster triangles are dropped and
unreferenced vertices removed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


def _face_adjacency(faces: np.ndarray) -> coo_matrix:
    """Sparse [F, F] adjacency of faces sharing an edge."""
    F = len(faces)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], 0)
    edges = np.sort(edges, axis=1)
    face_ids = np.tile(np.arange(F), 3)
    # group identical edges
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    e = edges[order]
    fi = face_ids[order]
    same = (e[1:] == e[:-1]).all(1)
    a = fi[:-1][same]
    b = fi[1:][same]
    data = np.ones(len(a), np.int8)
    return coo_matrix((data, (a, b)), shape=(F, F))


def clean_mesh(vertices: np.ndarray, faces: np.ndarray,
               keep_single_cluster: bool = False, min_num_cluster: int = 200
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (vertices, faces, vertex_index_map) after cluster removal.
    vertex_index_map maps old vertex id -> new id (-1 if dropped)."""
    if len(faces) == 0:
        return vertices, faces, np.arange(len(vertices))
    adj = _face_adjacency(faces)
    n_comp, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels, minlength=n_comp)
    if keep_single_cluster:
        keep = labels == np.argmax(counts)
    else:
        keep = counts[labels] >= min_num_cluster
    faces = faces[keep]
    used = np.unique(faces.ravel())
    remap = -np.ones(len(vertices), np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[faces], remap
