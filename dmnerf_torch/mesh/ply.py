# Copied from dmnerf_tpu/mesh/ply.py.
"""Minimal PLY mesh IO (ascii + binary_little_endian), replacing the
trimesh/open3d loaders the reference relies on (mesh_generator.py:23,139-142)."""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
              vertex_colors: Optional[np.ndarray] = None, binary: bool = True):
    """vertices [V,3] float; faces [F,3] int; vertex_colors [V,3] uint8 (0-255)."""
    vertices = np.asarray(vertices, np.float32)
    n_v = len(vertices)
    n_f = 0 if faces is None else len(faces)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header += [f"element face {n_f}", "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if vertex_colors is not None:
                vc = np.asarray(vertex_colors, np.uint8)
                rec = np.zeros(n_v, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = vertices
                rec["rgb"] = vc
                f.write(rec.tobytes())
            else:
                f.write(vertices.tobytes())
            if faces is not None:
                fc = np.asarray(faces, np.int32)
                rec = np.zeros(n_f, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
                rec["n"] = 3
                rec["idx"] = fc
                f.write(rec.tobytes())
        else:
            for i in range(n_v):
                line = " ".join(f"{x:.6f}" for x in vertices[i])
                if vertex_colors is not None:
                    line += " " + " ".join(str(int(c)) for c in vertex_colors[i])
                f.write((line + "\n").encode())
            if faces is not None:
                for tri in np.asarray(faces, np.int64):
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (vertices [V,3] float64, faces [F,3] int64 or None).
    Supports ascii and binary_little_endian with float/double xyz and
    uchar-count int-index face lists; extra vertex properties are skipped."""
    with open(path, "rb") as f:
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or ('list', ct, it, name)])
        line = f.readline().strip()
        assert line == b"ply", "not a ply file"
        cur = None
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[1], parts[2]))
            elif line == "end_header":
                break

        _SIZES = {"float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
                  "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
                  "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2),
                  "ushort": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
                  "uint": ("I", 4), "uint32": ("I", 4)}

        vertices, faces = None, None
        for name, count, props in elements:
            if name == "vertex":
                codes = [(_SIZES[t][0], _SIZES[t][1], pn) for t, pn in props]
                rec_fmt = "<" + "".join(c for c, _, _ in codes)
                rec_size = sum(s for _, s, _ in codes)
                names = [pn for _, _, pn in codes]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.array(rows, np.float64)
                    vertices = arr[:, [xi, yi, zi]]
                else:
                    buf = f.read(rec_size * count)
                    arr = np.array([struct.unpack_from(rec_fmt, buf, i * rec_size)
                                    for i in range(count)], np.float64)
                    vertices = arr[:, [xi, yi, zi]]
            elif name == "face":
                if fmt == "ascii":
                    faces = np.array([f.readline().split()[1:4] for _ in range(count)],
                                     np.int64)
                else:
                    lt = props[0]
                    cc, cs = _SIZES[lt[1]][0], _SIZES[lt[1]][1]
                    ic, isz = _SIZES[lt[2]][0], _SIZES[lt[2]][1]
                    out = []
                    for _ in range(count):
                        n = struct.unpack("<" + cc, f.read(cs))[0]
                        idx = struct.unpack(f"<{n}{ic}", f.read(isz * n))
                        out.append(idx[:3])
                    faces = np.array(out, np.int64)
        return vertices, faces
