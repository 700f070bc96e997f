"""Test CLI of the port: `python -m dmnerf_torch.cli.test --config ...` with
--render, --mani_eval, --mani_demo or --mesh.

Mirrors dmnerf_tpu/cli/test.py. Flags and config files are
the JAX package's (copied into dmnerf_torch.config), plus --device (default cuda; a CUDA
device that is not there is an error, never a silent move to the CPU). The
weights come from {basedir}/{expname}/{log_time}/NNNNNN.tar in the reference
DM-NeRF layout: the latest one, or the one --test_model names. A JAX orbax
checkpoint becomes such a file through tools/export_torch_ckpt.py.

--mani_eval reads the DM-SR manipulation ground truth (data/dmsr_mani.py) and
--mani_demo the DM-SR objs_info files (data/dmsr.py). --mesh writes mesh_NNNNNN/{expname}.ply and
color_{expname}.ply (mesh/extract.py), in the bounds of
{datadir}/{expname}.ply where that file exists, else of --mesh_extents.

Under torchrun (`python -m torch.distributed.run --nproc_per_node R -m
dmnerf_torch.cli.test ...`; see cli/train.py for --device and
--data_devices) --render, --mani_eval and --mani_demo split each view's
rays over the R ranks and rank 0 writes the outputs; --mesh is not sharded:
rank 0 extracts it and the other ranks wait for it, then exit.
"""

from __future__ import annotations

import argparse
import os
import re

import torch
import torch.distributed as dist

from dmnerf_torch.config import initial, log_dir
from dmnerf_torch.data.base import dataset_name_from_dir, load_dataset
from dmnerf_torch.eval.renderer import make_image_renderer
from dmnerf_torch.eval.tester import render_test
from dmnerf_torch.models.convert import load_tar
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig
from dmnerf_torch.parallel.mesh import (barrier, broadcast_object, close_mesh, is_main,
                                        launched, make_mesh)

def _resolve_test_model(ldir: str, test_model: str):
    """--test_model ('200000.tar' or '200000') -> the .tar path, or None when
    unset ('000000.tar' is the reference's default and means unset). A named
    checkpoint that does not exist is an error."""
    if not test_model or test_model == "000000.tar":
        return None
    name = test_model[:-len(".tar")] if test_model.endswith(".tar") else test_model
    if not name.isdigit():
        raise ValueError(f"--test_model {test_model!r}: expected 'NNNNNN(.tar)'")
    cand = os.path.join(ldir, f"{int(name):06d}.tar")
    if not os.path.isfile(cand):
        raise FileNotFoundError(f"--test_model {test_model!r}: {cand} does not exist")
    return cand


def latest_tar(ldir: str):
    """The highest-numbered NNNNNN.tar under ldir, or None."""
    steps = [int(m.group(1)) for f in (os.listdir(ldir) if os.path.isdir(ldir) else [])
             if (m := re.fullmatch(r"(\d+)\.tar", f))]
    return os.path.join(ldir, f"{max(steps):06d}.tar") if steps else None


def load_fields(path: str, cfg: FieldConfig, device):
    """-> ({"coarse": DMNeRFField, "fine": DMNeRFField} on device, iteration)."""
    coarse_sd, fine_sd, iteration = load_tar(path)
    params = {}
    for key, sd in (("coarse", coarse_sd), ("fine", fine_sd)):
        field = DMNeRFField(cfg)
        field.load_state_dict(sd)
        params[key] = field.to(device).eval()
    return params, iteration


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here "
                           "(pass --device cpu to run the plain PyTorch path)")
    return device


def launch_mesh(args, device):
    """Under torchrun: the ray mesh of the launched ranks (--data_devices 0
    or the world size) with rank 0's log_time on every rank; else None."""
    if not launched():
        return None
    mesh = make_mesh(args.data_devices, device)
    args.log_time = broadcast_object(args.log_time, mesh)
    print(f"rank {mesh.rank} of {mesh.size} on {mesh.device} ({dist.get_backend()})")
    return mesh


def _color_dict(args):
    """GT-label -> palette-index map for this scene from data/color_dict.json,
    or None for scenes it does not list (e.g. the synthetic fixture)."""
    from dmnerf_torch.utils.viz import load_color_dict
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for path in (os.path.join("data", "color_dict.json"),
                 os.path.join(repo_root, "data", "color_dict.json")):
        if os.path.exists(path):
            try:
                parts = [p for p in args.datadir.replace("\\", "/").split("/") if p]
                return load_color_dict(path, dataset_name_from_dir(args.datadir),
                                       parts[-1])
            except KeyError:
                continue
    return None


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    device = resolve_device(ns.device)
    args = initial(rest)
    args.is_train = False
    args.perturb = 0.0
    data_mesh = launch_mesh(args, device)
    if data_mesh is not None:
        device = data_mesh.device
    savedir = run(args, device, data_mesh)
    close_mesh(data_mesh)
    return savedir


def run(args, device, data_mesh):
    """The test CLI's work on parsed flags: one mode's outputs (under a ray
    mesh, rendered over its ranks)."""
    if args.mani_eval:
        from dmnerf_torch.data.dmsr_mani import load_data as load_mani
        scene = load_mani(args)
    else:
        scene = load_dataset(args)
    args.ins_num = scene.ins_num

    ldir = log_dir(args)
    ckpt = _resolve_test_model(ldir, args.test_model) or latest_tar(ldir)
    if ckpt is None:
        raise FileNotFoundError(f"no NNNNNN.tar checkpoint under {ldir}")
    cfg = FieldConfig.from_args(args)
    params, iteration = load_fields(ckpt, cfg, device)

    if args.render:
        savedir = os.path.join(ldir, f"render_test_{iteration:06d}")
        os.makedirs(savedir, exist_ok=True)
        i_test = scene.i_test
        render_im = make_image_renderer(cfg, args, scene.H, scene.W, device=device,
                                        use_pallas=args.use_pallas, mesh=data_mesh)
        render_test(render_im, params, scene.poses[i_test], scene.hwk, args,
                    gt_imgs=scene.images[i_test], gt_labels=scene.gt_labels[i_test],
                    ins_rgbs=scene.ins_rgbs, savedir=savedir,
                    crop_mask=scene.crop_mask, color_dict=_color_dict(args))
        print("Rendering Done", savedir)
        return savedir

    if args.mani_eval:
        from dmnerf_torch.edit.runner import manipulator_eval, resolve_target_channel
        from dmnerf_torch.edit.transforms import generate_poses_eval, load_mani_poses
        if args.resolve_target_label:
            plain = load_dataset(args)      # the unedited scene: GT labels per view
            args.target_label = resolve_target_channel(cfg, params, args, plain,
                                                       device=device, mesh=data_mesh)
        generate_poses_eval(args)
        savedir = os.path.join(ldir, f"mani_eval_{iteration:06d}")
        os.makedirs(savedir, exist_ok=True)
        manipulator_eval(cfg, params, scene.poses, scene.hwk, load_mani_poses(args), savedir,
                         scene.ins_rgbs, args, gt_rgbs=scene.images,
                         gt_labels=scene.gt_labels, color_dict=_color_dict(args),
                         device=device, mesh=data_mesh)
        print("Manipulating Done", savedir)
        return savedir

    if args.mani_demo:
        from dmnerf_torch.edit.runner import manipulator_demo, resolve_target_channel
        from dmnerf_torch.edit.transforms import generate_poses_demo, load_mani_demo_poses
        if args.resolve_target_label:
            # objs_info tar_ids are GT labels here: resolve all of them to
            # channels in one Hungarian-matching pass
            ch_map = resolve_target_channel(cfg, params, args, scene, device=device,
                                            targets=[int(o["tar_id"]) for o in scene.objs],
                                            mesh=data_mesh)
            for o in scene.objs:
                o["tar_id"] = ch_map[int(o["tar_id"])]
        generate_poses_demo(scene.objs, args)
        savedir = os.path.join(ldir, f"mani_demo_{iteration:06d}")
        os.makedirs(savedir, exist_ok=True)
        manipulator_demo(cfg, params, scene.hwk, load_mani_demo_poses(args), savedir,
                         scene.ins_rgbs, scene.objs, scene.view_poses, scene.ins_map, args,
                         color_dict=_color_dict(args), device=device, mesh=data_mesh)
        print("Manipulating Demo Done", savedir)
        return savedir

    if args.mesh:
        from dmnerf_torch.mesh.extract import extract_mesh
        savedir = os.path.join(ldir, f"mesh_{iteration:06d}")
        if is_main(data_mesh):
            os.makedirs(savedir, exist_ok=True)
            ply_path = os.path.join(args.datadir, args.expname + ".ply")
            extract_mesh(params, cfg, args, ply_path if os.path.exists(ply_path) else None,
                         savedir, ins_rgbs=scene.ins_rgbs, color_dict=_color_dict(args),
                         ins_map=scene.ins_map, device=device)
            print("Meshing Done", savedir)
        barrier(data_mesh)
        return savedir
    return None


if __name__ == "__main__":
    main()
