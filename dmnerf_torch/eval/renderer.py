"""Tiled full-image renderer (port of dmnerf_tpu/eval/renderer.py).

Every chunk has the same size (the ray list is edge-padded to a multiple of
the chunk and cropped after), and the chunks run in a Python loop: PyTorch
runs eagerly, so there is nothing to compile once. With fused=True (the
default when use_pallas is on) each chunk goes through the fused
field+composite kernels of kernels/render_field.py; the unfused path is
core/rendering.render_rays, with the field through kernel K1
(kernels/field.make_pallas_field) when use_pallas is on and the field modules
otherwise. The chunk is N_test rays.

params is {"coarse": DMNeRFField, "fine": DMNeRFField} on `device`.

Under a ray mesh (mesh=DataMesh, parallel/mesh.py) each rank renders 1/R of
the rays in chunks of N_test/R (N_test must split over the ranks): its
contiguous rows of the whole image in make_batch_renderer, of each chunk in
make_chunk_renderer; the rows are gathered, so every rank holds the whole
result. Each ray's work does not depend on the rest of its chunk.

Under the 2-D mesh (mesh=Mesh2D) the rays split over its data axis in the
same way, and every model rank of a data row renders the same rows with the
whole fields: ModelShardedFields are gathered over the model group once per
image (once per chunk in make_chunk_renderer), as the JAX package's
shard_map over 'data' takes the weights whole.
"""

from __future__ import annotations

import numpy as np
import torch

from dmnerf_torch.core.rays import get_rays
from dmnerf_torch.core.rendering import render_rays
from dmnerf_torch.core.sampling import z_val_sample
from dmnerf_torch.kernels.field import make_pallas_field
from dmnerf_torch.kernels.render_field import make_fused_chunk_renderer, pack_params
from dmnerf_torch.models.fields import FieldConfig
from dmnerf_torch.parallel.mesh import data_axis, gather, rank_share, shard_batch
from dmnerf_torch.parallel.model_parallel import gather_params_model
from dmnerf_torch.utils.profiling import span


def make_chunk_renderer(cfg: FieldConfig, n_samples: int, n_importance: int,
                        near: float, far: float, chunk: int, *, device,
                        use_pallas: bool = False, mesh=None):
    """render_chunk(params, rays_o [chunk,3], rays_d [chunk,3])
    -> (rgb [chunk,3], ins [chunk,K], depth [chunk]) on the unfused path:
    the field through K1 when use_pallas, else the field modules (under a
    mesh, each rank renders its chunk/R rows and the rows are gathered)."""
    device = torch.device(device)
    field = make_pallas_field(cfg) if use_pallas else None
    mesh = data_axis(mesh)
    chunk = rank_share(chunk, mesh, "N_test")

    @torch.no_grad()
    def render_chunk(params, rays_o, rays_d):
        params = gather_params_model(params)
        rays_o, rays_d = shard_batch((rays_o, rays_d), mesh)
        if use_pallas:
            params = pack_params(params)
            coarse_fn = lambda pts, vd: field(params["coarse"], pts, vd)
            fine_fn = lambda pts, vd: field(params["fine"], pts, vd)
        else:
            coarse_fn, fine_fn = params["coarse"], params["fine"]
        z = z_val_sample(chunk, near, far, n_samples, device=device)
        out = render_rays(coarse_fn, fine_fn, rays_o, rays_d, z,
                          n_importance, generator=None, perturb=False)
        return gather((out["rgb_fine"], out["ins_fine"], out["depth_fine"]), mesh)

    return render_chunk


def make_batch_renderer(cfg: FieldConfig, n_samples: int, n_importance: int,
                        near: float, far: float, chunk: int, n_rays: int, *,
                        device, use_pallas: bool = False, fused=None, mesh=None):
    """render_all(params, rays_o [n_rays,3], rays_d [n_rays,3]) -> (rgb, ins,
    depth) over the whole ray set, one fixed-size chunk at a time (under a
    mesh, this rank's rows in chunks of chunk/R, then gathered). n_rays must
    be a multiple of chunk (callers pad). fused defaults to use_pallas."""
    if n_rays % chunk:
        raise ValueError(f"n_rays {n_rays} is not a multiple of chunk {chunk}")
    if fused is None:
        fused = use_pallas
    device = torch.device(device)
    mesh = data_axis(mesh)
    if mesh is not None:
        n_rays, chunk = n_rays // mesh.size, rank_share(chunk, mesh, "N_test")

    if fused:
        render_chunk_fused = make_fused_chunk_renderer(cfg, n_importance)
    else:
        render_chunk = make_chunk_renderer(cfg, n_samples, n_importance, near, far,
                                           chunk, device=device, use_pallas=use_pallas)

    @torch.no_grad()
    def render_all(params, rays_o, rays_d):
        params = gather_params_model(params)
        rays_o, rays_d = shard_batch((rays_o, rays_d), mesh)
        if fused or use_pallas:
            params = pack_params(params)          # once per image
        if fused:
            z = z_val_sample(chunk, near, far, n_samples, device=device).contiguous()
        outs = []
        for s in range(0, n_rays, chunk):
            ro, rd = rays_o[s:s + chunk], rays_d[s:s + chunk]
            outs.append(render_chunk_fused(params, ro, rd, z) if fused
                        else render_chunk(params, ro, rd))
        rgb, ins, depth = (torch.cat(x, dim=0) for x in zip(*outs))
        return gather((rgb, ins, depth), mesh)

    return render_all


def render_rays_chunked(render_chunk, params, rays_o: np.ndarray,
                        rays_d: np.ndarray, chunk: int, *, device):
    """Render an arbitrary ray list with a fixed-size chunk renderer -> numpy."""
    n = rays_o.shape[0]
    n_pad = (-n) % chunk
    ro = np.concatenate([rays_o, np.repeat(rays_o[-1:], n_pad, 0)], 0) if n_pad else rays_o
    rd = np.concatenate([rays_d, np.repeat(rays_d[-1:], n_pad, 0)], 0) if n_pad else rays_d
    rgbs, inss, depths = [], [], []
    for s in range(0, n + n_pad, chunk):
        rgb, ins, depth = render_chunk(
            params,
            torch.as_tensor(ro[s:s + chunk], dtype=torch.float32, device=device),
            torch.as_tensor(rd[s:s + chunk], dtype=torch.float32, device=device))
        rgbs.append(rgb.cpu().numpy())
        inss.append(ins.cpu().numpy())
        depths.append(depth.cpu().numpy())
    return (np.concatenate(rgbs, 0)[:n], np.concatenate(inss, 0)[:n],
            np.concatenate(depths, 0)[:n])


def render_image(render_chunk, params, H: int, W: int, K: np.ndarray,
                 c2w: np.ndarray, chunk: int, *, device):
    """Render one full image -> numpy (rgb [H,W,3], ins [H,W,Kc], depth [H,W])."""
    rays_o, rays_d = get_rays(H, W, torch.as_tensor(K, dtype=torch.float32),
                              torch.as_tensor(c2w, dtype=torch.float32))
    rgb, ins, depth = render_rays_chunked(
        render_chunk, params, rays_o.reshape(-1, 3).numpy(),
        rays_d.reshape(-1, 3).numpy(), chunk, device=device)
    return rgb.reshape(H, W, 3), ins.reshape(H, W, -1), depth.reshape(H, W)


def make_image_renderer(cfg: FieldConfig, args, H: int, W: int, *, device,
                        use_pallas: bool = False, fused=None, mesh=None):
    """render_im(params, K, c2w) -> numpy (rgb [H,W,3] f32, label [H,W] i32,
    conf [H,W] f32, depth [H,W] f32). Rays are made on the device, and the
    instance map is reduced to its argmax label and max-prob confidence there,
    before the copy to the host.

    render_im.many(params, K, c2ws) yields one such tuple per pose, launching
    view i+1 before it waits for view i's copy, so host work on view i
    (metrics, pngs) overlaps the device's work on view i+1; render_im.device
    is `device`, render_im.mesh is `mesh`. Each view is one `render.view`
    span (utils/profiling.py)."""
    chunk = int(args.N_test)
    device = torch.device(device)
    n = H * W
    n_pad = (-n) % chunk
    render_all = make_batch_renderer(cfg, args.N_samples, args.N_importance,
                                     args.near, args.far, chunk, n + n_pad,
                                     device=device, use_pallas=use_pallas, fused=fused,
                                     mesh=mesh)

    @torch.no_grad()
    def render_im_dev(params, K, c2w):
        with span("render.view"):
            K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
            c2w = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
            rays_o, rays_d = get_rays(H, W, K, c2w)
            rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
            if n_pad:
                # edge-pad (repeat the last ray): works even when n_pad > n
                rays_o = torch.cat([rays_o, rays_o[-1:].expand(n_pad, 3)])
                rays_d = torch.cat([rays_d, rays_d[-1:].expand(n_pad, 3)])
            rgb, ins, depth = render_all(params, rays_o, rays_d)
            label = torch.argmax(ins[:n], dim=-1).to(torch.int32)
            conf = torch.amax(ins[:n], dim=-1)
            out = (rgb[:n].reshape(H, W, 3), label.reshape(H, W),
                   conf.reshape(H, W), depth[:n].reshape(H, W))
            return _copy_to_host(out, device)

    def render_im(params, K, c2w):
        return _wait(render_im_dev(params, K, c2w))

    def render_many(params, K, c2ws):
        params = gather_params_model(params)
        pending = None
        for c2w in c2ws:
            cur = render_im_dev(params, K, c2w)
            if pending is not None:
                yield _wait(pending)
            pending = cur
        if pending is not None:
            yield _wait(pending)

    render_im.many = render_many
    render_im.device = device
    render_im.mesh = mesh
    return render_im


def _copy_to_host(tensors, device: torch.device):
    """Start the device->host copies; on CUDA they go to pinned memory on the
    current stream and an event marks their end."""
    if device.type != "cuda":
        return tensors, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 .copy_(t, non_blocking=True) for t in tensors)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _wait(pending):
    host, done = pending
    if done is not None:
        done.synchronize()
    return tuple(t.numpy() for t in host)
