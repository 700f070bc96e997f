"""Mesh extraction (port of dmnerf_tpu/mesh/extract.py): density grid ->
occupancy -> marching cubes -> cleanup -> per-vertex instance labels -> PLY.

The steps and their order are the JAX package's (the reference's
tools/mesh_generator.py:12-143):
- a grid_dim^3 grid in the scene bounds (the GT ply's oriented bounds, or the
  mesh_extents box), axis swap [0,2,1] with y negated;
- the fine field's density with zero view directions, through kernel K1
  (kernels/field.py::field_forward) when use_pallas, one launch per batch of
  points; only the density column comes back to the host;
- occupancy 1 - exp(-relu(sigma) * (far-near)/N_importance), iso level 0.45;
- index -> canonical [-1,1] -> scene coordinates; {expname}.ply;
- cluster cleanup (min_num_cluster 400), area-weighted vertex normals;
- a coarse->fine render from just behind each vertex along -normal, with the
  reference's fixed near 0.01 / far 15, through eval/renderer.py's batch
  renderer (kernels K4 + K3 when use_pallas); the argmax label is taken on
  the device and only the int32 labels come back;
- color_{expname}.ply, coloured through render_label2world or a seeded
  palette.

Marching cubes and cleanup run on the host (mesh/marching.py, its C++ fast
path in native/, or numpy). params is {"coarse": DMNeRFField, "fine":
DMNeRFField} on `device`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dmnerf_torch.eval.renderer import make_batch_renderer
from dmnerf_torch.kernels.field import field_forward
from dmnerf_torch.kernels.render_field import pack_field
from dmnerf_torch.mesh.cleanup import clean_mesh
from dmnerf_torch.mesh.grid import grid_within_bound, oriented_bounds
from dmnerf_torch.mesh.marching import marching_cubes
from dmnerf_torch.mesh.ply import read_ply, write_ply
from dmnerf_torch.models.fields import FieldConfig
from dmnerf_torch.utils.viz import render_label2world

# points per density launch (the JAX package's N_test * 512 at N_test 4096):
# on an NVIDIA H100 (700 W) K1's time over a 256^3 grid moved by under 3%
# between 2^19, 2^21 and 2^23 points per launch (PERF.md §5)
DENSITY_BATCH = 1 << 21
# the reference's fixed bounds of the vertex-colouring rays
# (mesh_generator.py:119): the scene's near would start a ray past the surface
LABEL_NEAR, LABEL_FAR = 0.01, 15.0


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a float32 tensor on device."""
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def make_density_fn(cfg: FieldConfig, batch: int, *, device, use_pallas: bool):
    """query(field, pts [N,3] numpy) -> sigma [N] float32 numpy: column 3 of
    the field's raw with zero view directions, `batch` points per call
    (through K1 when use_pallas, else DMNeRFField.forward)."""
    device = torch.device(device)

    @torch.no_grad()
    def query(field, pts_np: np.ndarray) -> np.ndarray:
        if field.cfg != cfg:
            raise ValueError("make_density_fn: the field was built for another FieldConfig")
        fn = field_forward if use_pallas else (lambda f, p, d: f(p, d))
        params = pack_field(field) if use_pallas else field
        pts = to_device(pts_np, device)
        sigma = torch.empty(pts.shape[0], dtype=torch.float32, device=device)
        for s in range(0, pts.shape[0], batch):
            p = pts[s:s + batch]
            sigma[s:s + batch] = fn(params, p, torch.zeros_like(p))[:, 3]
        return sigma.cpu().numpy()

    return query


def make_label_fn(cfg: FieldConfig, args, chunk: int, *, device, use_pallas: bool,
                  fused=None):
    """query(params, rays_o [V,3], rays_d [V,3] numpy) -> int32 [V]: the
    argmax instance label of a coarse->fine render of each ray between the
    fixed LABEL_NEAR and LABEL_FAR, `chunk` rays at a time. fused defaults to
    use_pallas (K4 + K3); the rays are edge-padded to a multiple of chunk."""
    device = torch.device(device)

    @torch.no_grad()
    def query(params, rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
        n = rays_o.shape[0]
        n_pad = (-n) % chunk
        render_all = make_batch_renderer(cfg, args.N_samples, args.N_importance,
                                         LABEL_NEAR, LABEL_FAR, chunk, n + n_pad,
                                         device=device, use_pallas=use_pallas, fused=fused)
        ro, rd = to_device(rays_o, device), to_device(rays_d, device)
        if n_pad:
            ro = torch.cat([ro, ro[-1:].expand(n_pad, 3)])
            rd = torch.cat([rd, rd[-1:].expand(n_pad, 3)])
        _, ins, _ = render_all(params, ro, rd)
        return torch.argmax(ins[:n], dim=-1).to(torch.int32).cpu().numpy()

    return query


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals [V,3]."""
    vn = np.zeros_like(verts)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    return vn


def vertex_rays(verts: np.ndarray, faces: np.ndarray, near: float):
    """The vertex-colouring rays in the field's axes ([0,2,1], y negated):
    from 0.03 * near behind each vertex along its -normal. -> float32
    (rays_o [V,3], rays_d [V,3])."""
    rays_d = -vertex_normals(verts, faces)[:, [0, 2, 1]]
    rays_d[:, 1] *= -1
    v_sw = verts[:, [0, 2, 1]].copy()
    v_sw[:, 1] *= -1
    rays_o = v_sw - rays_d * 0.03 * near
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def extract_mesh(params, cfg: FieldConfig, args, scene_ply_path: Optional[str],
                 save_dir: str, ins_rgbs=None, color_dict=None, ins_map=None, *,
                 device):
    """The whole pipeline. Returns (vertices, faces, labels); labels is None
    for an empty isosurface."""
    use_pallas = bool(getattr(args, "use_pallas", True))
    grid_dim = int(getattr(args, "mesh_grid_dim", 256))
    level = float(getattr(args, "mesh_level", 0.45))
    extents = np.array([float(x) for x in
                        str(getattr(args, "mesh_extents", "1.9,7.0,7.0")).split(",")])

    if scene_ply_path and os.path.exists(scene_ply_path):
        verts_gt, _ = read_ply(scene_ply_path)
        to_origin, _ = oriented_bounds(verts_gt)
        scene_transform = np.linalg.inv(to_origin)
    else:
        scene_transform = np.eye(4)

    grid_pts, _ = grid_within_bound([-1.0, 1.0], extents, scene_transform, grid_dim)
    # axis convention swap (mesh_generator.py:28-29)
    q = grid_pts[:, [0, 2, 1]].copy()
    q[:, 1] *= -1

    density = make_density_fn(cfg, DENSITY_BATCH, device=device, use_pallas=use_pallas)(
        params["fine"], q.astype(np.float32))
    voxel = (args.far - args.near) / args.N_importance
    occ = 1.0 - np.exp(-np.maximum(density, 0.0) * voxel)
    occ = occ.reshape(grid_dim, grid_dim, grid_dim)

    verts_idx, faces, _ = marching_cubes(occ, level)
    if len(faces) == 0:
        print("extract_mesh: empty isosurface")
        return verts_idx, faces, None

    # index coords -> [-1,1] canonical -> scene coords (mesh_generator.py:71-86)
    verts = verts_idx / (grid_dim - 1)
    verts = (verts - 0.5) * 2.0
    verts = verts * (extents / 2.0)
    verts = verts @ scene_transform[:3, :3].T + scene_transform[:3, 3]

    os.makedirs(save_dir, exist_ok=True)
    write_ply(os.path.join(save_dir, args.expname + ".ply"), verts, faces)

    verts_c, faces_c, _ = clean_mesh(verts, faces, min_num_cluster=400)
    if len(faces_c) == 0:
        verts_c, faces_c = verts, faces

    rays_o, rays_d = vertex_rays(verts_c, faces_c, args.near)
    labels = make_label_fn(cfg, args, int(args.N_test), device=device, use_pallas=use_pallas)(
        params, rays_o, rays_d)

    if ins_rgbs is not None and color_dict is not None and ins_map is not None:
        colors = render_label2world(labels, ins_rgbs, color_dict, ins_map)
    else:
        rng = np.random.default_rng(0)
        palette = rng.integers(0, 255, (int(labels.max()) + 1, 3))
        colors = palette[labels]
    write_ply(os.path.join(save_dir, "color_" + args.expname + ".ply"),
              verts_c, faces_c, vertex_colors=colors.astype(np.uint8))
    print(f"extract_mesh: {len(verts_c)} verts, {len(faces_c)} faces -> {save_dir}")
    return verts_c, faces_c, labels
