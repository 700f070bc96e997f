"""Render-time scene manipulation (port of dmnerf_tpu/edit/manipulator.py).

The edited object is rendered by querying the field along the rays moved by
the object's inverse motion (target rays). Per ray chunk (manipulate_chunk):
coarse fields on the original and every target's rays; the fine
"accumulated label" passes, which only composite the instance map (kernel
K5, kernels/render_field.render_field_ins, when use_pallas); the exchanger
swaps raw samples between original and target rays by their labels;
re-composite, importance-resample, fine fields on the sorted z union,
exchange again, final composite. Masks are torch.where chains in the
reference's in-place mutation order, as in the JAX package.

With use_pallas the fields go through kernel K1 (kernels/field.make_pallas_field)
and the accumulated-label passes through K5; on a CUDA device each launches
its kernel or raises, and on the CPU the wrappers run their plain versions.
Without it the fields are the modules and the accumulated-label passes
composite their raw.

The edit chunk is args.N_test (the JAX package's v5e cap, EDIT_CHUNK, is not
ported); ray generation and the deform offsets run on the device, the offsets
in f32 (the JAX package's documented deviation). params is
{"coarse": DMNeRFField, "fine": DMNeRFField} on the device.

Under a ray mesh (mesh=DataMesh, parallel/mesh.py) the original and every
object's target rays are split the same way over the ranks (N_test must
split over them): each rank edits its rows (K1 on raws and K5) and the rows
are gathered, so every rank holds the whole result. An edited ray's work
does not depend on the other rays. Under the 2-D mesh (Mesh2D) the rays
split over its data axis, and every model rank edits its data row's rays
with the whole fields (ModelShardedFields gathered once, at construction).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from dmnerf_torch.core.rays import get_rays
from dmnerf_torch.core.rendering import composite
from dmnerf_torch.core.sampling import sample_pdf, z_val_sample
from dmnerf_torch.kernels.field import make_pallas_field
from dmnerf_torch.kernels.render_field import make_render_field, pack_params
from dmnerf_torch.edit.deform import deform_curve
from dmnerf_torch.parallel.mesh import data_axis, gather, rank_share
from dmnerf_torch.parallel.model_parallel import gather_params_model
from dmnerf_torch.utils.profiling import span


def _field_raw(field_fn, rays_o, rays_d, z_vals):
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return field_fn(pts, viewdirs[..., None, :])


def _sorted_union(*zs):
    """Sorted concatenation of z-value sets along the sample axis."""
    return torch.sort(torch.cat(zs, dim=-1), dim=-1)[0]


def exchanger(ori_raw, tar_raws: Sequence[torch.Tensor], ori_accum_ins,
              tar_accum_inss: Sequence[torch.Tensor], move_labels: Sequence[int]):
    """Label-guided raw swap (reference manipulator.py:18-83).

    ori_raw: [N, S, C]; tar_raws[i]: [N, S, C]; ori_accum_ins and
    tar_accum_inss[i]: [N, K+1] composited instance maps (sigmoid, air channel
    kept; the argmaxes drop it). argmax(sigmoid(x)) == argmax(x), so the
    per-point labels come from the logits; torch.argmax, like jnp.argmax,
    takes the first of tied maxima."""
    ori_pred_label = torch.argmax(ori_raw[..., 4:], dim=-1)                 # [N, S]
    ori_accum_label = torch.argmax(ori_accum_ins[..., :-1], dim=-1)        # [N]
    ori_accum_label = ori_accum_label[:, None].expand(ori_pred_label.shape)

    out = ori_raw
    for tar_raw, tar_accum, move_label in zip(tar_raws, tar_accum_inss, move_labels):
        # occlusion fix on ori: points claiming the object while the composited
        # ray label disagrees are reassigned to the ray label
        ori_occludes = (ori_accum_label != move_label) & (ori_pred_label == move_label)
        ori_pred_label = torch.where(ori_occludes, ori_accum_label, ori_pred_label)

        # filling: ray-level label says object, per-point labels don't
        fillings = (ori_pred_label != move_label) & (ori_accum_label == move_label)

        tar_pred_label = torch.argmax(tar_raw[..., 4:], dim=-1)
        tar_accum_label = torch.argmax(tar_accum[..., :-1], dim=-1)
        tar_accum_label = tar_accum_label[:, None].expand(tar_pred_label.shape)
        tar_occludes = (tar_accum_label != move_label) & (tar_pred_label == move_label)
        tar_pred_label = torch.where(tar_occludes, tar_accum_label, tar_pred_label)

        # exchange wherever tar rays see the object; eliminate where only ori
        # rays see it; else keep (reference manipulator.py:64-75)
        tar_move = tar_pred_label == move_label
        exchange = tar_move | fillings
        eliminate = (ori_pred_label == move_label) & ~tar_move

        out = torch.where(exchange[..., None], tar_raw, out)
        out = torch.where(eliminate[..., None], torch.zeros_like(out), out)
    return out


def manipulate_chunk(coarse_fn, fine_fn, ori_rays, tar_rays,
                     move_labels: Sequence[int], n_samples: int,
                     n_importance: int, near: float, far: float,
                     fine_accum_fn=None):
    """Edit one ray chunk. ori_rays: (o, d) each [N, 3]; tar_rays: a list of
    (o, d) pairs, one per moved object. Returns (rgb [N,3], ins [N,K+1],
    tar_rgb [N,3], tar_ins [N,K+1]), ins with the air channel kept.

    coarse_fn/fine_fn(pts [N,S,3], viewdirs [N,1,3]) -> raw [N,S,C].
    fine_accum_fn(rays_o, rays_d, z_full) -> ins map [N, K+1] (air kept): the
    fused field+composite for the accumulated-label passes, whose raws are
    only composited; None composites fine_fn's raw.

    The phases are spans (utils/profiling.py::span), disjoint and in the
    order the chain of dependencies runs them: edit.coarse, edit.resample,
    edit.accum, edit.exchange, edit.resample, edit.fine, edit.exchange,
    edit.fine (so three of the five names open twice a chunk)."""
    ori_o, ori_d = ori_rays
    N = ori_o.shape[0]
    n_obj = len(tar_rays)

    with span("edit.coarse"):
        ori_z = z_val_sample(N, near, far, n_samples, device=ori_o.device)
        ori_raw = _field_raw(coarse_fn, ori_o, ori_d, ori_z)
        ori_w = composite(ori_raw, ori_z, ori_d, keep_air=True).weights
        ori_mid = 0.5 * (ori_z[..., 1:] + ori_z[..., :-1])

        # coarse fields and composites for every target first, so the (1 + n_obj)
        # det inverse-CDF samplings are one sample_pdf call; the targets share
        # ori_z (the same det linspace), so ori_mid serves every row
        tar_raws, tar_rgbs = [], []
        for tar_o, tar_d in tar_rays:
            tar_raw = _field_raw(coarse_fn, tar_o, tar_d, ori_z)
            c = composite(tar_raw, ori_z, tar_d, keep_air=True)
            tar_raws.append(tar_raw)
            tar_rgbs.append((c.rgb, c.weights))

    with span("edit.resample"):
        w_all = torch.cat([ori_w[..., 1:-1]] + [tw[..., 1:-1] for _, tw in tar_rgbs], dim=0)
        mid_all = ori_mid[:1].expand(w_all.shape[0], ori_mid.shape[1])
        zs_all = sample_pdf(mid_all, w_all, n_importance, det=True)
        ori_zs = zs_all[:N]
        tar_zs_list = [zs_all[(i + 1) * N:(i + 2) * N] for i in range(n_obj)]
        ori_union = _sorted_union(ori_z, ori_zs)
        tar_unions = [_sorted_union(ori_z, tar_zs) for tar_zs in tar_zs_list]

    def _accum(o, d, z_full):
        if fine_accum_fn is not None:
            return fine_accum_fn(o, d, z_full)
        return composite(_field_raw(fine_fn, o, d, z_full), z_full, d, keep_air=True).ins

    with span("edit.accum"):
        ori_accum = _accum(ori_o, ori_d, ori_union)
        tar_accums = [_accum(tar_o, tar_d, z_full)
                      for (tar_o, tar_d), z_full in zip(tar_rays, tar_unions)]
    tar_rgb, tar_ins_accum = tar_rgbs[-1][0], tar_accums[-1]

    # pass 1: exchange coarse raws, re-composite
    with span("edit.exchange"):
        ori_raw_x = exchanger(ori_raw, tar_raws, ori_accum, tar_accums, move_labels)
        w2 = composite(ori_raw_x, ori_z, ori_d, keep_air=True).weights

    # pass 2: importance-resample, fine fields on the z union, exchange again,
    # final composite. As in the JAX package, every object reuses the one
    # union ori_z2 (the reference re-sorts it per object from tar_z == ori_z;
    # PARITY.md)
    with span("edit.resample"):
        ori_zs2 = sample_pdf(ori_mid, w2[..., 1:-1], n_importance, det=True)
        ori_z2 = _sorted_union(ori_z, ori_zs2, *tar_zs_list)
    with span("edit.fine"):
        ori_raw_f = _field_raw(fine_fn, ori_o, ori_d, ori_z2)
        tar_raws_f = [_field_raw(fine_fn, tar_o, tar_d, ori_z2) for tar_o, tar_d in tar_rays]
    with span("edit.exchange"):
        final_raw = exchanger(ori_raw_f, tar_raws_f, ori_accum, tar_accums, move_labels)
    with span("edit.fine"):
        f = composite(final_raw, ori_z2, ori_d, keep_air=True)
    return f.rgb, f.ins, tar_rgb, tar_ins_accum


def _field_fns(cfg, params, use_pallas: bool):
    if use_pallas:
        f = make_pallas_field(cfg)
        return (lambda pts, vd: f(params["coarse"], pts, vd),
                lambda pts, vd: f(params["fine"], pts, vd))
    return params["coarse"], params["fine"]


def _fine_accum_fn(cfg, params, use_pallas: bool):
    """K5 + sigmoid for the fine accumulated-label passes (air kept), or None
    to take the raw + composite path."""
    if not use_pallas:
        return None
    rf = make_render_field(cfg, heads="ins")

    def accum(rays_o, rays_d, z_full):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_full[:, :, None]
        return torch.sigmoid(rf(params["fine"], pts, z_full.contiguous(), rays_d))

    return accum


def _edit_params(params, use_pallas: bool):
    """Whole fields (ModelShardedFields gathered over their model group),
    packed once for the kernels' wrappers (the CPU plain versions unpack)."""
    if params is not None:
        params = gather_params_model(params)
    return pack_params(params) if use_pallas else params


def make_manipulator(cfg, params, args, n_obj: int, move_labels: List[int],
                     use_pallas: bool = False, mesh=None):
    """run(ori_o [N,3], ori_d [N,3], tar_os [n_obj,N,3], tar_ds [n_obj,N,3])
    -> manipulate_chunk's outputs for one chunk (under a mesh, each rank's
    N/R rows, gathered; a Mesh2D splits them over its data axis)."""
    mesh = data_axis(mesh)
    params = _edit_params(params, use_pallas)
    coarse_fn, fine_fn = _field_fns(cfg, params, use_pallas)
    accum_fn = _fine_accum_fn(cfg, params, use_pallas)

    @torch.no_grad()
    def run(ori_o, ori_d, tar_os, tar_ds):
        if mesh is not None:
            rows = mesh.rows(ori_o.shape[0], "N_test")
            ori_o, ori_d, tar_os, tar_ds = (ori_o[rows], ori_d[rows],
                                            tar_os[:, rows], tar_ds[:, rows])
        tar_rays = [(tar_os[i], tar_ds[i]) for i in range(n_obj)]
        return gather(manipulate_chunk(coarse_fn, fine_fn, (ori_o, ori_d), tar_rays,
                                       move_labels, args.N_samples, args.N_importance,
                                       args.near, args.far, fine_accum_fn=accum_fn), mesh)

    return run


def make_image_manipulator(cfg, params, args, n_obj: int, move_labels: List[int],
                           n_rays: int, use_pallas: bool = False, mesh=None):
    """run_image(ori_o [n,3], ori_d [n,3], tar_os [n_obj,n,3], tar_ds
    [n_obj,n,3]) -> (rgb [n,3], label_full [n] i32, label_noair [n] i32,
    conf_noair [n] f32): the whole-image edit, one N_test chunk at a time,
    with the instance map reduced on the device (the runners use only the
    argmax over all K+1 channels, for visualisation, and the argmax/max over
    the air-dropped channels, for AP). n_rays must be a multiple of
    args.N_test (callers pad). Under a mesh each rank edits its contiguous
    n_rays/R rows in chunks of N_test/R, and the outputs are gathered."""
    chunk = int(args.N_test)
    if n_rays % chunk:
        raise ValueError(f"n_rays {n_rays} is not a multiple of the chunk {chunk}")
    mesh = data_axis(mesh)
    if mesh is not None:
        chunk, rows = rank_share(chunk, mesh, "N_test"), mesh.rows(n_rays)
        n_rays = rows.stop - rows.start
    params = _edit_params(params, use_pallas)
    coarse_fn, fine_fn = _field_fns(cfg, params, use_pallas)
    accum_fn = _fine_accum_fn(cfg, params, use_pallas)

    @torch.no_grad()
    def run_image(ori_o, ori_d, tar_os, tar_ds):
        if mesh is not None:
            ori_o, ori_d, tar_os, tar_ds = (ori_o[rows], ori_d[rows],
                                            tar_os[:, rows], tar_ds[:, rows])
        outs = []
        for s in range(0, n_rays, chunk):
            sl = slice(s, s + chunk)
            tar_rays = [(tar_os[i, sl], tar_ds[i, sl]) for i in range(n_obj)]
            rgb, ins, _, _ = manipulate_chunk(
                coarse_fn, fine_fn, (ori_o[sl], ori_d[sl]), tar_rays, move_labels,
                args.N_samples, args.N_importance, args.near, args.far,
                fine_accum_fn=accum_fn)
            outs.append((rgb, torch.argmax(ins, -1).to(torch.int32),
                         torch.argmax(ins[..., :-1], -1).to(torch.int32),
                         torch.amax(ins[..., :-1], -1)))
        return gather(tuple(torch.cat(x, dim=0) for x in zip(*outs)), mesh)

    return run_image


def make_pose_image_manipulator(cfg, params, args, objs, move_labels: List[int],
                                H: int, W: int, K, *, device,
                                use_pallas: bool = False, mesh=None):
    """Whole-image edit from poses: rays, padding and deform offsets are made
    on the device.

    objs: per-object specs, dicts with 'mode' ('rigid' | 'deform') and, for
    deform, 'deform_func' (edit/deform.py curves). A rigid object's target
    rays come from get_rays(K, tar_pose); a deform object's are the original
    rays with the per-row curve times the per-view scale added to origin x
    (reference manipulator.py:397-429).

    Returns run(ori_pose [4,4], tar_poses [n_obj,4,4], dscales [n_obj]) with
    make_image_manipulator's outputs, padded to a multiple of N_test
    (callers crop to H*W). The offsets are computed in f32 on the device, as
    the JAX package does (its documented deviation from the host's f64)."""
    device = torch.device(device)
    n_obj = len(objs)
    n = H * W
    n_pad = (-n) % int(args.N_test)
    core = make_image_manipulator(cfg, params, args, n_obj, move_labels, n + n_pad,
                                  use_pallas=use_pallas, mesh=mesh)
    K_dev = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=device)
    curves = [torch.as_tensor(deform_curve(o["deform_func"], H, W), dtype=torch.float32,
                              device=device) if o["mode"] == "deform" else None
              for o in objs]

    def _pad(x):
        # edge-pad (repeat the last ray): works even when n_pad > n
        return torch.cat([x, x[-1:].expand(n_pad, 3)]) if n_pad else x

    def _rays(pose):
        ro, rd = get_rays(H, W, K_dev, pose)
        return _pad(ro.reshape(-1, 3)), _pad(rd.reshape(-1, 3))

    @torch.no_grad()
    def run(ori_pose, tar_poses, dscales):
        f32 = dict(dtype=torch.float32, device=device)
        ori_pose = torch.as_tensor(np.asarray(ori_pose), **f32)
        tar_poses = torch.as_tensor(np.asarray(tar_poses), **f32)
        dscales = torch.as_tensor(np.asarray(dscales), **f32)
        ro, rd = _rays(ori_pose)
        tar_os, tar_ds = [], []
        for i, obj in enumerate(objs):
            if obj["mode"] == "deform":
                to, td = ro + _pad((curves[i] * dscales[i])[:, None] * x_axis), rd
            else:
                to, td = _rays(tar_poses[i])
            tar_os.append(to)
            tar_ds.append(td)
        return core(ro, rd, torch.stack(tar_os), torch.stack(tar_ds))

    return run
