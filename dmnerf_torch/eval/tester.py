"""Test rendering + metrics harness (port of dmnerf_tpu/eval/tester.py).

Per test pose: a full-image render, PSNR/SSIM/LPIPS, the per-view instance
AP, and the prediction/ground-truth instance images. ScanNet scenes crop the
render and the ground truth to the centre before the metrics and mask the
out-of-crop prediction. Writes {i:03d}.png, instance_{i:03d}.png,
{i}_ins_gt.png, {i}_ins_gt_mask.png, matching_log.json and test_results.txt
(PSNR SSIM LPIPS AP50 AP75 AP80 AP85 AP90 AP95; one row per view + the mean).

LPIPS (eval/lpips.py) runs on the renderer's device with --lpips_weights; on
ScanNet it is taken on the centre crop. Without weights its column is NaN,
as in the JAX package.

Under a ray mesh (render_im.mesh) every rank renders its share of each view;
rank 0 alone computes the metrics and writes the artifacts, and returns the
means (the other ranks return None).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from dmnerf_torch.eval.instance_ap import ins_eval_from_labels
from dmnerf_torch.eval.lpips import load_lpips
from dmnerf_torch.eval.metrics import psnr as psnr_fn, ssim as ssim_fn
from dmnerf_torch.parallel.mesh import is_main
from dmnerf_torch.utils.png import write_png
from dmnerf_torch.utils.viz import render_gt_label2img, render_label2img, to8b


def render_test(render_im, params, render_poses, hwk, args,
                gt_imgs=None, gt_labels=None, ins_rgbs=None,
                savedir: Optional[str] = None, crop_mask=None,
                color_dict: Optional[dict] = None):
    """Returns (mean_psnr, mean_ssim, mean_lpips, mean_ap[6]) and writes the
    artifacts. render_im comes from eval.renderer.make_image_renderer."""
    H, W, K = hwk
    if not is_main(render_im.mesh):
        for _ in render_im.many(params, K, np.asarray(render_poses)):
            pass
        return None
    lpips_fn = load_lpips(getattr(args, "lpips_weights", None), device=render_im.device)
    psnrs, ssims, lpipses, aps = [], [], [], []
    full_map = {}

    if crop_mask is not None:
        cm = np.asarray(crop_mask)
        flat_mask = cm.reshape(-1) == 1
        ch, cw = args.crop_height, args.crop_width
        if not ch or not cw:
            # the mask IS the crop rectangle
            rows = np.where(cm.any(1))[0]
            cols = np.where(cm.any(0))[0]
            ch = int(rows[-1] - rows[0] + 1)
            cw = int(cols[-1] - cols[0] + 1)

    if color_dict is None:
        color_dict = {str(i): i for i in range(len(ins_rgbs))} if ins_rgbs is not None else {}

    poses_np = np.asarray(render_poses)
    stream = render_im.many(params, K, poses_np)

    for i in range(len(poses_np)):
        t0 = time.time()
        rgb, label, conf, _ = next(stream)

        gt_img = None if gt_imgs is None else np.asarray(gt_imgs[i])
        gt_label = None if gt_labels is None else np.asarray(gt_labels[i])
        mask = None
        if crop_mask is not None:
            rgb = rgb.reshape(-1, 3)[flat_mask].reshape(ch, cw, 3)
            label = label.reshape(-1)[flat_mask].reshape(ch, cw)
            conf = conf.reshape(-1)[flat_mask].reshape(ch, cw)
            if gt_img is not None:
                gt_img = gt_img.reshape(-1, 3)[flat_mask].reshape(ch, cw, 3)
                gt_label = gt_label.reshape(-1)[flat_mask].reshape(ch, cw)
                mask = (gt_label < args.ins_num).astype(np.float32)

        pred_label = None
        ins_map = {}
        if gt_img is not None:
            psnrs.append(psnr_fn(rgb, gt_img))
            ssims.append(ssim_fn(rgb, gt_img))
            lpipses.append(lpips_fn(rgb, gt_img) if lpips_fn else float("nan"))

            pred_label, ap, matched = ins_eval_from_labels(
                label, conf, gt_label, args.ins_num, mask)
            valid_gt = np.unique(gt_label)
            if mask is not None:
                valid_gt = valid_gt[valid_gt != args.ins_num]
            for idx, pl in enumerate(matched):
                if pl != -1:
                    ins_map[str(int(pl))] = int(valid_gt[idx])
            full_map[i] = ins_map
            aps.append(ap)
            print(f"[TEST {i}] PSNR {psnrs[-1]:.4f} SSIM {ssims[-1]:.4f} "
                  f"AP {np.round(ap, 4)} ({time.time() - t0:.2f}s)")

        if savedir is not None:
            write_png(os.path.join(savedir, f"{i:03d}.png"), to8b(rgb))
            if pred_label is not None and ins_rgbs is not None:
                ins_img = render_label2img(pred_label, ins_rgbs, color_dict, ins_map)
                write_png(os.path.join(savedir, f"instance_{i:03d}.png"), ins_img)
                gt_ins_img = render_gt_label2img(gt_label, ins_rgbs, color_dict)
                write_png(os.path.join(savedir, f"{i}_ins_gt.png"), gt_ins_img)
                write_png(os.path.join(savedir, f"{i}_ins_gt_mask.png"),
                          gt_label.astype(np.uint8))

    if gt_imgs is not None and savedir is not None:
        with open(os.path.join(savedir, "matching_log.json"), "w") as f:
            json.dump(full_map, f)

    if not psnrs:
        return None

    aps_arr = np.array(aps)
    rows = np.stack([psnrs, ssims, lpipses] + [aps_arr[:, k] for k in range(6)], 1)
    mean_row = np.concatenate([[np.mean(psnrs), np.mean(ssims), np.mean(lpipses)],
                               aps_arr.mean(0)])
    table = np.concatenate([rows, mean_row[None]], 0)
    if savedir is not None:
        np.savetxt(os.path.join(savedir, "test_results.txt"), table,
                   fmt="%.6f", delimiter=" ")
    print("=" * 20, "Avg", "=" * 20)
    print(f"PSNR: {np.mean(psnrs):.4f}, SSIM: {np.mean(ssims):.4f}, "
          f"LPIPS: {np.mean(lpipses):.4f}")
    print("AP:", np.round(aps_arr.mean(0), 4))
    return float(np.mean(psnrs)), float(np.mean(ssims)), float(np.mean(lpipses)), \
        aps_arr.mean(0)
