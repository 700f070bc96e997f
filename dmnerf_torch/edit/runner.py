"""Manipulation eval and demo (port of dmnerf_tpu/edit/runner.py).

- manipulator_eval: one rigid transform (edit/transforms.generate_poses_eval)
  applied to every test pose; per view the edited render against the ground
  truth manipulated render (PSNR, SSIM, LPIPS, AP with the air channel
  dropped); writes {i}_rgb.png, {i}_ins.png, {i}_rgb_gt.png,
  {i}_ins_gt.png, matching_log.json and test_results.txt (PSNR SSIM LPIPS
  AP50 AP75 AP80 AP85 AP90 AP95; one row per view and the mean).
- manipulator_demo: per-view transform sequences of several objects;
  'deform' objects shift ray origins row by row; writes {i}_rgb.png,
  {i}_ins.png and {i}_ins_pred_mask.png.

Views are launched one ahead: view i+1's edit runs on the device while the
host copies view i and computes its metrics and pngs. LPIPS
(eval/lpips.py) runs on the edit's device with --lpips_weights; without
weights its column and mean are NaN, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter

import numpy as np
import torch

from dmnerf_torch.edit.manipulator import make_pose_image_manipulator
from dmnerf_torch.eval import renderer
from dmnerf_torch.eval.instance_ap import ins_eval_from_labels
from dmnerf_torch.eval.lpips import load_lpips
from dmnerf_torch.eval.metrics import psnr as psnr_fn, ssim as ssim_fn
from dmnerf_torch.eval.renderer import _copy_to_host, _wait
from dmnerf_torch.utils.png import write_png
from dmnerf_torch.edit.deform import deform_scale
from dmnerf_torch.utils.viz import render_gt_label2img, render_label2img, to8b


def _prefetch_map(dispatch, items, n: int, device):
    """Yield dispatch(i, item)'s outputs cropped to n rows, as numpy, in input
    order, launching one item ahead of the one being copied to the host."""
    pending = None
    for i, item in enumerate(items):
        cur = _copy_to_host(tuple(t[:n] for t in dispatch(i, item)), device)
        if pending is not None:
            yield _wait(pending)
        pending = cur
    if pending is not None:
        yield _wait(pending)


def resolve_target_channel(cfg, params, args, scene, *, device, n_views=3, targets=None):
    """Map GT instance label(s) to the trained model's instance channel(s).

    The Hungarian instance loss binds prediction channels to objects by an
    arbitrary permutation, so the reference's --target_label is a channel.
    This renders up to n_views unedited test views, Hungarian-matches channels
    to GT labels and majority-votes the channel bound to each wanted label.
    targets: GT labels to resolve in one pass, returning {gt_label: channel};
    None resolves args.target_label and returns its channel."""
    render_im = renderer.make_image_renderer(cfg, args, scene.H, scene.W, device=device,
                                             use_pallas=getattr(args, "use_pallas", False))
    _, _, K = scene.hwk
    wanted = ([int(args.target_label)] if targets is None else [int(t) for t in targets])
    votes = {t: Counter() for t in wanted}
    for vi in list(scene.i_test)[:n_views]:
        _, label, conf, _ = render_im(params, K, np.asarray(scene.poses[vi]))
        gt_label = np.asarray(scene.gt_labels[vi])
        _, _, matched = ins_eval_from_labels(label, conf, gt_label, args.ins_num)
        valid_gt = np.unique(gt_label)
        for idx, ch in enumerate(matched):
            if ch != -1 and int(valid_gt[idx]) in votes:
                votes[int(valid_gt[idx])][int(ch)] += 1
    resolved = {}
    for t in wanted:
        if not votes[t]:
            raise ValueError(f"--resolve_target_label: GT label {t} was not matched to "
                             f"any prediction channel in {n_views} test views")
        ch, n = votes[t].most_common(1)[0]
        print(f"[MANI] resolved GT label {t} -> instance channel {ch} "
              f"({n}/{sum(votes[t].values())} view votes)")
        resolved[t] = ch
    return resolved if targets is not None else resolved[wanted[0]]


def manipulator_eval(cfg, params, ori_poses, hwk, trans_dicts, save_dir, ins_rgbs, args,
                     gt_rgbs=None, gt_labels=None, color_dict=None, *, device):
    """Returns (mean PSNR, mean AP[6]) with ground truth, else None."""
    H, W, K = hwk
    trans_dict = trans_dicts["transformations"][0]
    trans = np.array(trans_dict["transformation"], np.float64)
    save_dir = os.path.join(save_dir, trans_dict["mode"])
    os.makedirs(save_dir, exist_ok=True)

    run_pose = make_pose_image_manipulator(
        cfg, params, args, objs=[{"mode": "rigid"}], move_labels=[int(args.target_label)],
        H=H, W=W, K=K, device=device, use_pallas=getattr(args, "use_pallas", False))
    if color_dict is None:
        color_dict = {str(i): i for i in range(len(ins_rgbs))}
    lpips_fn = load_lpips(getattr(args, "lpips_weights", None), device=device)

    psnrs, ssims, lpipses, aps, full_map = [], [], [], [], {}

    def _dispatch(_i, ori_pose):
        return run_pose(ori_pose, (trans @ ori_pose)[None], np.zeros(1))

    poses_np = np.asarray(ori_poses)
    stream = _prefetch_map(_dispatch, poses_np, H * W, torch.device(device))
    for i in range(len(poses_np)):
        t0 = time.time()
        rgb, label_full, label, conf = next(stream)
        rgb = rgb.reshape(H, W, 3)

        ins_map = {}
        pred_label = label_full.reshape(H, W)
        if gt_rgbs is not None:
            gt_img = np.asarray(gt_rgbs[i])
            psnrs.append(psnr_fn(rgb, gt_img))
            ssims.append(ssim_fn(rgb, gt_img))
            lpipses.append(lpips_fn(rgb, gt_img) if lpips_fn else float("nan"))
            gt_label = np.asarray(gt_labels[i])
            # air channel dropped before AP (reference manipulator.py:294)
            _, ap, matched = ins_eval_from_labels(
                label.reshape(H, W), conf.reshape(H, W), gt_label, args.ins_num)
            valid_gt = np.unique(gt_label)
            for idx, plab in enumerate(matched):
                if plab != -1:
                    ins_map[str(int(plab))] = int(valid_gt[idx])
            full_map[i] = ins_map
            aps.append(ap)
            print(f"[MANI {i}] PSNR {psnrs[-1]:.4f} SSIM {ssims[-1]:.4f} "
                  f"AP {np.round(ap, 4)} ({time.time() - t0:.1f}s)")

        write_png(os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb))
        write_png(os.path.join(save_dir, f"{i}_ins.png"),
                  render_label2img(pred_label, ins_rgbs, color_dict, ins_map))
        if gt_rgbs is not None:
            write_png(os.path.join(save_dir, f"{i}_rgb_gt.png"), to8b(np.asarray(gt_rgbs[i])))
            write_png(os.path.join(save_dir, f"{i}_ins_gt.png"),
                      render_gt_label2img(np.asarray(gt_labels[i]), ins_rgbs, color_dict))

    if gt_rgbs is None:
        return None
    with open(os.path.join(save_dir, "matching_log.json"), "w") as f:
        json.dump(full_map, f)
    aps_arr = np.array(aps)
    rows = np.stack([psnrs, ssims, lpipses] + [aps_arr[:, k] for k in range(6)], 1)
    # nanmean of an all-NaN column (no weights) warns: keep the NaN instead
    lpips_mean = np.nanmean(lpipses) if np.isfinite(lpipses).any() else float("nan")
    mean_row = np.concatenate([[np.nanmean(psnrs), np.nanmean(ssims), lpips_mean],
                               aps_arr.mean(0)])
    np.savetxt(os.path.join(save_dir, "test_results.txt"),
               np.concatenate([rows, mean_row[None]], 0), fmt="%.6f", delimiter=" ")
    print(f"[MANI avg] PSNR {np.nanmean(psnrs):.4f} SSIM {np.nanmean(ssims):.4f} "
          f"AP {np.round(aps_arr.mean(0), 4)}")
    return float(np.nanmean(psnrs)), aps_arr.mean(0)


def manipulator_demo(cfg, params, hwk, objs_trans, save_dir, ins_rgbs, objs, view_poses,
                     ins_map, args, color_dict=None, *, device):
    H, W, K = hwk
    save_dir = os.path.join(save_dir, args.mani_type)
    os.makedirs(save_dir, exist_ok=True)
    if color_dict is None:
        color_dict = {str(i): i for i in range(len(ins_rgbs))}

    pose_objs = [{"mode": "deform", "deform_func": o["deform_func"]}
                 if o["mani_mode"] == "deform" else {"mode": "rigid"} for o in objs]
    run_pose = make_pose_image_manipulator(
        cfg, params, args, objs=pose_objs, move_labels=[int(o["tar_id"]) for o in objs],
        H=H, W=W, K=K, device=device, use_pallas=getattr(args, "use_pallas", False))

    def _dispatch(i, ori_pose):
        # poses and per-view deform scales only; rays are made on the device
        tar_poses, dscales = [], []
        for obj in objs:
            if obj["mani_mode"] == "deform":
                tar_poses.append(np.asarray(ori_pose, np.float64))  # unused
                dscales.append(deform_scale(obj["deform_func"], i))
            else:
                seq = objs_trans[obj["obj_name"]]
                trans = np.array(seq[min(i, len(seq) - 1)]["transformation"])
                tar_poses.append(trans @ ori_pose)
                dscales.append(0.0)
        return run_pose(ori_pose, np.stack(tar_poses), np.asarray(dscales))

    poses_np = np.asarray(view_poses)
    stream = _prefetch_map(_dispatch, poses_np, H * W, torch.device(device))
    for i in range(len(poses_np)):
        t0 = time.time()
        rgb, label_full, _, _ = next(stream)
        label = label_full.reshape(H, W)
        write_png(os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb.reshape(H, W, 3)))
        write_png(os.path.join(save_dir, f"{i}_ins.png"),
                  render_label2img(label, ins_rgbs, color_dict, ins_map or {}))
        write_png(os.path.join(save_dir, f"{i}_ins_pred_mask.png"), label.astype(np.uint8))
        print(f"[DEMO {i}] {time.time() - t0:.1f}s")
