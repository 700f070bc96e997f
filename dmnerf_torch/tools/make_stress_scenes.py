"""Write stress-test scenes TO DISK in the reference dataset formats (port of
tools/make_stress_scenes.py): the same layouts, file names, poses, palettes,
JSON contents and default sizes, with the analytic ground truth rendered in
torch (data/procedural.py) and the files written without imageio or h5py
(utils/png.py, utils/jpeg.py, utils/hdf5.py).

    python -m dmnerf_torch.tools.make_stress_scenes --out data/stress_scenes \
        [--only dmsr|dmsr_quality|replica|replica64|scannet] [--device cuda|cpu]

Layouts written (matching the reference's datasets/loader_*.py):
  dmsr/stress/     train|test/{rgbs,semantic_instance,transforms.json},
                   ins_rgb.hdf5, mani/{translation/{rgbs,semantic_instance},
                   transforms.json, obj_center.json, objs_info_rigid.json,
                   objs_info_deform.json}
  replica/stress/  traj_w_c.txt (900 poses), rgb/rgb_{i}.png,
                   semantic_instance/semantic_instance_{i}.png, ins_rgb.hdf5
                   (replica64/stress/: the same with 64 objects)
  scannet/stress/  {train,test}_split.txt, {split}/{split}_images/{i}.jpg,
                   {split}/{split}_pose/{i}.txt, {split}/{split}_ins/{i}.npz
                   (ins_2d_label_id, -1 = unlabeled room), intrinsic/
                   intrinsic_color.txt, ins_rgb.hdf5

The ScanNet frames are written by utils/jpeg.py::write_jpeg: the bytes
that imageio.v2.imwrite writes for the same array. --device defaults to cuda
and raises without a card.
"""

import argparse
import json
import os

import numpy as np

from dmnerf_torch.cli.test import resolve_device
from dmnerf_torch.data.procedural import (edited_objects, make_objects, palette,
                                          render_gt)
from dmnerf_torch.edit.transforms import (_center_conjugate, _mode_matrix,
                                          pose_spherical)
from dmnerf_torch.utils.hdf5 import write_dataset
from dmnerf_torch.utils.jpeg import write_jpeg
from dmnerf_torch.utils.png import write_png

GL2CV = np.diag([1.0, -1.0, -1.0])  # right-handed look-down--z -> z-forward


def _orbit_poses(n, radius=4.0, phis=(-20.0, -35.0, -50.0)):
    return [pose_spherical(th, phis[k % len(phis)], radius)
            for k, th in enumerate(np.linspace(0, 360, n, endpoint=False))]


def _to8b(img):
    return (255 * np.clip(img, 0, 1)).astype(np.uint8)


class Renderer:
    def __init__(self, device, near=1.0, far=14.0, n_samples=192):
        self.near, self.far, self.n = near, far, n_samples
        self.device = resolve_device(str(device))

    def __call__(self, pose, H, W, K, objs):
        return render_gt(pose, H, W, K, self.near, self.far, objs, n_samples=self.n,
                         device=self.device)


# ------------------------------------------------------------------- DM-SR

def write_dmsr(out, rend, n_obj=16, H=480, W=640, n_train=48, n_test=4,
               target_label=5, mani_mode="translation", scene_name="stress",
               train_phis=(-20.0, -35.0, -50.0), test_phis=(-28.0, -44.0),
               test_radius=4.3, test_theta0=0.0):
    base = os.path.join(out, "dmsr", scene_name)
    objs = make_objects(n_obj, seed=0)
    pal = palette(n_obj + 1)
    angle_x = 1.2
    focal = 0.5 * W / np.tan(0.5 * angle_x)
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1.0]])

    test_orbit = [pose_spherical(test_theta0 + th,
                                 test_phis[k % len(test_phis)], test_radius)
                  for k, th in enumerate(np.linspace(0, 360, n_test,
                                                     endpoint=False))]
    for split, poses in (("train", _orbit_poses(n_train, phis=train_phis)),
                         ("test", test_orbit)):
        rgb_dir = os.path.join(base, split, "rgbs")
        ins_dir = os.path.join(base, split, "semantic_instance")
        os.makedirs(rgb_dir, exist_ok=True)
        os.makedirs(ins_dir, exist_ok=True)
        frames = []
        for i, pose in enumerate(poses):
            img, lab = rend(pose, H, W, K, objs)
            write_png(os.path.join(rgb_dir, f"{i:04d}.png"), _to8b(img))
            write_png(os.path.join(ins_dir, f"{i:04d}.png"), lab.astype(np.uint8))
            frames.append({"transform_matrix": np.asarray(pose).tolist()})
            print(f"dmsr/{split} {i + 1}/{len(poses)}", flush=True)
        with open(os.path.join(base, split, "transforms.json"), "w") as f:
            json.dump({"camera_angle_x": angle_x, "frames": frames}, f)

    write_dataset(os.path.join(base, "ins_rgb.hdf5"), "datasets", pal)

    # manipulation GT: the eval transformation T (same construction the CLI's
    # generate_poses_eval rebuilds from obj_center.json), object moved per the
    # manipulator convention (field queried at T(p))
    center = objs[target_label - 1].center.tolist()
    T = _center_conjugate(_mode_matrix(mani_mode), center)
    edited = edited_objects(objs, target_label, T)
    mani = os.path.join(base, "mani")
    rgb_dir = os.path.join(mani, mani_mode, "rgbs")
    ins_dir = os.path.join(mani, mani_mode, "semantic_instance")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(ins_dir, exist_ok=True)
    frames = []
    mani_poses = test_orbit
    for i, pose in enumerate(mani_poses):
        img, lab = rend(pose, H, W, K, edited)
        write_png(os.path.join(rgb_dir, f"{i:04d}.png"), _to8b(img))
        write_png(os.path.join(ins_dir, f"{i:04d}.png"), lab.astype(np.uint8))
        frames.append({"transform_matrix": np.asarray(pose).tolist()})
        print(f"dmsr/mani {i + 1}/{len(mani_poses)}", flush=True)
    with open(os.path.join(mani, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": angle_x, "frames": frames}, f)
    with open(os.path.join(mani, "obj_center.json"), "w") as f:
        json.dump({"center": center, "target_label": target_label}, f)
    ins_map = {str(i): i for i in range(n_obj + 1)}
    with open(os.path.join(mani, "objs_info_rigid.json"), "w") as f:
        json.dump({"objects": [{
            "obj_name": f"obj{target_label}", "tar_id": target_label,
            "mani_mode": "translation", "obj_center": center,
            "distance": [1.2]}],
            "view_id": 0, "ins_map": ins_map}, f)
    # demo deform spec: a MIXED deform + rigid pair. tar_id holds the GT
    # label: the drill configs set resolve_target_label, so cli.test maps it
    # to the trained channel (the Hungarian binding is arbitrary).
    rigid2 = min(9, n_obj)
    with open(os.path.join(mani, "objs_info_deform.json"), "w") as f:
        json.dump({"objects": [
            {"obj_name": f"obj{target_label}", "tar_id": target_label,
             "mani_mode": "deform", "deform_func": "sin",
             "obj_center": center},
            {"obj_name": f"obj{rigid2}", "tar_id": rigid2,
             "mani_mode": "translation",
             "obj_center": objs[rigid2 - 1].center.tolist(),
             "distance": [0.8]}],
            "view_id": 0, "ins_map": ins_map}, f)


# ------------------------------------------------------------------- Replica

def write_replica(out, rend, n_obj=10, H=120, W=160, name="replica"):
    """Replica's loader hardcodes a 900-frame trajectory, train = every 5th,
    test = train+2 — 360 rendered frames, so this fixture is low-res.

    name="replica64" / n_obj=64 writes the high-instance-count variant
    (real Replica scenes carry 59+ object codes, loader_replica.py:78-97) —
    the K>=64 instance-loss/LAP drill fixture."""
    base = os.path.join(out, name, "stress")
    os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(base, "semantic_instance"), exist_ok=True)
    objs = make_objects(n_obj, seed=3)
    pal = palette(n_obj + 1)
    focal = W / 2.0
    K = np.array([[focal, 0, (W - 1) * 0.5], [0, focal, (H - 1) * 0.5],
                  [0, 0, 1.0]])

    Ts = []
    for i in range(900):
        gl = pose_spherical(i * 0.4, -20.0 - 25.0 * ((i // 5) % 3) / 2.0, 4.0)
        cv = np.array(gl, np.float64)
        cv[:3, :3] = cv[:3, :3] @ GL2CV
        Ts.append(cv)
    Ts = np.stack(Ts)
    np.savetxt(os.path.join(base, "traj_w_c.txt"), Ts.reshape(900, 16),
               delimiter=" ")

    need = sorted(set(range(0, 900, 5)) | {i + 2 for i in range(0, 900, 5)})
    for n, i in enumerate(need):
        img, lab = rend(Ts[i], H, W, K, objs)
        write_png(os.path.join(base, "rgb", f"rgb_{i}.png"), _to8b(img))
        write_png(os.path.join(base, "semantic_instance", f"semantic_instance_{i}.png"),
                  lab.astype(np.uint8))
        if n % 40 == 0:
            print(f"{name} {n + 1}/{len(need)}", flush=True)
    write_dataset(os.path.join(base, "ins_rgb.hdf5"), "datasets", pal)


# ------------------------------------------------------------------- ScanNet

def write_scannet(out, rend, n_obj=16, H=480, W=640, n_train=20, n_test=3):
    """Weak-label crop variant: room pixels are UNLABELED (-1 in the npz, the
    loader remaps them to ins_num='air'); objects carry labels 0..n_obj-1."""
    base = os.path.join(out, "scannet", "stress")
    objs = make_objects(n_obj, seed=7)
    pal = palette(n_obj + 1)[1:]  # loader truncates to ins_num
    focal = 0.6 * W
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = focal, focal, W / 2, H / 2
    os.makedirs(os.path.join(base, "intrinsic"), exist_ok=True)
    np.savetxt(os.path.join(base, "intrinsic", "intrinsic_color.txt"), K4,
               delimiter=" ")

    ids = {"train": list(range(0, n_train * 10, 10)),
           "test": list(range(5, n_test * 10, 10))}
    for split, frame_ids in ids.items():
        for sub in (f"{split}_images", f"{split}_pose", f"{split}_ins"):
            os.makedirs(os.path.join(base, split, sub), exist_ok=True)
        np.savetxt(os.path.join(base, f"{split}_split.txt"),
                   np.array(frame_ids, np.int32), fmt="%d")
        for n, i in enumerate(frame_ids):
            gl = pose_spherical(i * 1.7, -22.0 - 9.0 * (n % 3), 4.1)
            cv = np.array(gl, np.float64)
            cv[:3, :3] = cv[:3, :3] @ GL2CV
            img, lab = rend(cv, H, W, K4[:3, :3], objs)
            write_jpeg(os.path.join(base, split, f"{split}_images", f"{i}.jpg"), _to8b(img))
            np.savetxt(os.path.join(base, split, f"{split}_pose", f"{i}.txt"),
                       cv, delimiter=" ")
            ins = lab.astype(np.int16) - 1          # room 0 -> -1 unlabeled
            np.savez(os.path.join(base, split, f"{split}_ins", f"{i}.npz"),
                     ins_2d_label_id=ins)
            print(f"scannet/{split} {n + 1}/{len(frame_ids)}", flush=True)
    write_dataset(os.path.join(base, "ins_rgb.hdf5"), "datasets", pal)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/stress_scenes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=None,
                    choices=[None, "dmsr", "dmsr_quality", "replica",
                             "replica64", "scannet"])
    ap.add_argument("--dmsr_train_views", type=int, default=48,
                    help="train-view count for the DM-SR scene (the reference "
                         "DM-SR scenes ship ~300 views; 96 is enough to push "
                         "the rigid-mani AP50 over 0.9 on the 17-object scene)")
    args = ap.parse_args(argv)
    rend = Renderer(args.device)
    if args.only in (None, "dmsr"):
        write_dmsr(args.out, rend, n_train=args.dmsr_train_views)
    if args.only == "dmsr_quality":
        # quality-convergence fixture: 240 train views over 5 elevation rings
        # spanning the test range, 24 held-out test views at in-span
        # elevations and half-step offset azimuths, same 16-object scene
        write_dmsr(args.out, rend, scene_name="quality", n_train=240,
                   n_test=24, train_phis=(-20.0, -28.0, -36.0, -44.0, -52.0),
                   test_phis=(-24.0, -32.0, -40.0, -48.0), test_radius=4.0,
                   test_theta0=7.5)
    if args.only in (None, "replica"):
        write_replica(args.out, rend)
    if args.only == "replica64":
        write_replica(args.out, rend, n_obj=64, name="replica64")
    if args.only in (None, "scannet"):
        write_scannet(args.out, rend)
    print("done:", args.out)


if __name__ == "__main__":
    main()
