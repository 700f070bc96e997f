# Ported from __graft_entry__.py (entry and dryrun_multichip on the port; dryrun_multichip runs one process per rank under torchrun).
"""Entry points of the port (entry, dryrun_multichip).

- entry(): the flagship forward step, a coarse -> fine render of 1024 rays
  through both 8x256 DM-NeRF fields (PE 10/4, 32 instance slots, bf16) on
  K1, with its example arguments.
- dryrun_multichip(n): the flagship model over n ranks on all three sharded
  paths: (1) 8 scanned training steps (rays over the data axis, the loss
  statistics and gradients summed over it; the fields tensor-parallel over
  a model axis of 2 when n >= 4 and even), (2) the whole-image render and
  (3) a two-object edit (rigid + sin deform), both held equal to one rank.
  Image and sample counts are small; the model is full scale.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m dmnerf_torch.graft_entry N [--device cuda|cuda:0|cpu] [--backend gloo|nccl]

`--device cuda` puts rank r on cuda:r; several ranks share one card with
`--device cuda:0 --backend gloo` (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def entry(device="cuda", n_rays: int = 1024):
    """(forward, (params, rays_o, rays_d)): forward(params, rays_o, rays_d)
    -> (rgb_fine, ins_fine, depth_fine) of the flagship fields at bf16,
    seed 0, 64 + 128 samples, no perturbation; the fields run on K1 (its
    plain version when the caller asks for the CPU)."""
    from dmnerf_torch.core.rendering import render_rays
    from dmnerf_torch.core.sampling import z_val_sample
    from dmnerf_torch.kernels.field import make_pallas_field
    from dmnerf_torch.kernels.render_field import pack_params
    from dmnerf_torch.models.fields import FieldConfig, init_field_params

    device = torch.device(device)
    cfg = FieldConfig(netdepth=8, netwidth=256, multires=10, multires_views=4, ins_num=32,
                      compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    params = {"coarse": init_field_params(gen, cfg, device=device),
              "fine": init_field_params(gen, cfg, device=device)}
    n_samples, n_importance = 64, 128
    field = make_pallas_field(cfg)

    @torch.no_grad()
    def forward(params, rays_o, rays_d):
        packed = pack_params(params)
        z = z_val_sample(rays_o.shape[0], 1.0, 12.0, n_samples, device=rays_o.device)
        out = render_rays(lambda p, v: field(packed["coarse"], p, v),
                          lambda p, v: field(packed["fine"], p, v), rays_o, rays_d, z,
                          n_importance, generator=None, perturb=False)
        return out["rgb_fine"], out["ins_fine"], out["depth_fine"]

    rays_o = torch.randn(n_rays, 3, generator=gen).to(device)
    rays_d = rays_o + torch.tensor([0.0, 0.0, 1.0], device=device)
    return forward, (params, rays_o, rays_d)


def dryrun_multichip(n_devices: int, device="cuda", backend=None):
    """The three sharded paths over the n_devices ranks torchrun launched
    (make_mesh_2d(n // 2, 2) when n >= 4 and even, else the ray mesh), each
    printed as it passes; an AssertionError names a miss. Returns (the mesh,
    the last training loss); the caller closes the mesh."""
    from dmnerf_torch.config import default_config
    from dmnerf_torch.data.synthetic import make_scene
    from dmnerf_torch.edit.manipulator import make_pose_image_manipulator
    from dmnerf_torch.eval.renderer import make_image_renderer
    from dmnerf_torch.models.fields import FieldConfig
    from dmnerf_torch.parallel.mesh import is_main, make_mesh, make_mesh_2d
    from dmnerf_torch.parallel.model_parallel import gather_params_model
    from dmnerf_torch.train.step import create_train_state, make_train_scan_step, scene_arrays

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh_2d(n_devices // 2, 2, device, backend)
    else:
        mesh = make_mesh(n_devices, device, backend)
    dev = mesh.device
    say = print if is_main(mesh) else (lambda *a, **k: None)

    H = W = 16
    scene = make_scene(H=H, W=W, n_train=2, n_test=1)
    # the flagship shape (reference train_dmsr defaults): 8x256, PE 10/4, 32 slots
    args = default_config(
        N_train=16 * n_devices, N_samples=16, N_importance=32, near=1.0, far=12.0,
        perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05, lrate=5e-4,
        lrate_decay=500, precision="f32", netdepth=8, netwidth=256, multires=10,
        multires_views=4)
    args.ins_num = max(32, scene.ins_num)
    cfg = FieldConfig.from_args(args)
    state = create_train_state(0, cfg, args.lrate, args.lrate_decay, device=dev, mesh=mesh)

    # ---- path 1: 8 scanned steps, rays over the data axis
    scan = make_train_scan_step(args, cfg, mesh=mesh)
    metrics = scan(state, scene_arrays(scene, dev), 1, np.asarray(scene.i_train), 8)
    total = float(metrics["total_loss"])
    assert np.isfinite(total), f"non-finite loss {total}"
    assert state.step == 8, state.step
    say(f"dryrun_multichip({n_devices}): train ok, 8 scanned steps, loss={total:.4f}")

    # ---- path 2: the sharded whole-image render == one rank
    whole = gather_params_model(state.params)
    args.N_test = 32 * n_devices
    pose = scene.poses[0]
    rgb_m, lab_m, conf_m, _ = make_image_renderer(cfg, args, H, W, device=dev, use_pallas=True,
                                                  mesh=mesh)(state.params, scene.K, pose)
    rgb_1, lab_1, conf_1, _ = make_image_renderer(cfg, args, H, W, device=dev,
                                                  use_pallas=True)(whole, scene.K, pose)
    np.testing.assert_allclose(rgb_m, rgb_1, atol=1e-5)
    np.testing.assert_array_equal(lab_m, lab_1)
    np.testing.assert_allclose(conf_m, conf_1, atol=1e-5)
    say(f"dryrun_multichip({n_devices}): sharded eval render == single-device")

    # ---- path 3: the sharded two-object edit (rigid + deform) == one rank
    objs = [{"mode": "rigid"}, {"mode": "deform", "deform_func": "sin"}]
    tar_pose = np.asarray(pose, np.float64).copy()
    tar_pose[0, 3] += 0.2
    tar_poses = np.stack([tar_pose, np.eye(4)])
    dscales = np.asarray([0.0, 0.15])
    outs = [make_pose_image_manipulator(cfg, p, args, objs, move_labels=[1, 2], H=H, W=W,
                                        K=scene.K, device=dev, use_pallas=True, mesh=m)(
        pose, tar_poses, dscales) for p, m in ((state.params, mesh), (whole, None))]
    np.testing.assert_allclose(outs[0][0].cpu().numpy(), outs[1][0].cpu().numpy(), atol=1e-5)
    np.testing.assert_array_equal(outs[0][1].cpu().numpy(), outs[1][1].cpu().numpy())
    say(f"dryrun_multichip({n_devices}): sharded 2-object (rigid+deform) edit == "
        f"single-device")
    say(f"dryrun_multichip({n_devices}): ok, loss={total:.4f}")
    return mesh, total


def main(argv=None) -> int:
    from dmnerf_torch.parallel.mesh import close_mesh

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    a = p.parse_args(argv)
    mesh, _ = dryrun_multichip(a.n_devices, a.device, a.backend)
    close_mesh(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
