# Copied from dmnerf_tpu/edit/transforms.py.
"""Object/camera transformation helpers for manipulation.

Behavior parity with the reference's tools/pose_generator.py and the rotation
helpers in networks/helpers.py:6-20:
- pose_spherical(theta, phi, radius): spherical camera poses (:29-34).
- generate_poses_eval: per-scene hardcoded object centers; builds
  T = Tc^-1 @ M @ Tc (center-conjugated translate/rotate/scale/multi) and writes
  mani/{mode}/transformation_matrix.json (:53-128).
- generate_poses_demo: per-object transform *sequences* over `views` frames,
  written to mani/transformation_matrix.json (:131-232).
All host-side numpy — these run once per eval, not in the hot path.
"""

from __future__ import annotations

import json
import os

import numpy as np


def r_x(roll):
    c, s = np.cos(roll), np.sin(roll)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1.0]])


def r_y(pitch):
    c, s = np.cos(pitch), np.sin(pitch)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1.0]])


def r_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    trans_t = np.eye(4)
    trans_t[2, 3] = radius
    ph = phi_deg / 180.0 * np.pi
    th = theta_deg / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0],
                        [0, np.cos(ph), -np.sin(ph), 0],
                        [0, np.sin(ph), np.cos(ph), 0],
                        [0, 0, 0, 1.0]])
    # note: the reference's rot_theta uses -sin in [0, 2] (pose_generator.py:22-26)
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0],
                          [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0],
                          [0, 0, 0, 1.0]])
    c2w = rot_theta @ rot_phi @ trans_t
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]])
    return (flip @ c2w).astype(np.float32)


# per-scene object centers used by the eval transforms (pose_generator.py:54-57)
MANI_CENTERS = {
    "bathroom": [0.779178, 1.05247, 0.380208], "bedroom": [-1.29552, 1.72703, 0.2946],
    "dinning": [-0.633653, 0.295162, 0.279743], "kitchen": [-2.52579, -0.103821, 1.47165],
    "reception": [0.579352, -0.099242, 0.092597], "restroom": [-0.001277, -2.85079, 0.588084],
    "office": [-0.717374, 0.929292, 0.904515], "study": [-0.519422, -2.16509, 1.07392],
}


def _center_conjugate(M: np.ndarray, center) -> np.ndarray:
    """T_center^-1 @ M @ T_center: apply M about `center`."""
    t = np.eye(4, dtype=np.float32)
    t[:3, -1] = -np.asarray(center)
    t_inv = np.eye(4, dtype=np.float32)
    t_inv[:3, -1] = np.asarray(center)
    return t_inv @ M @ t


def _mode_matrix(mode: str) -> np.ndarray:
    if mode == "translation":
        m = np.eye(4)
        m[1, 3] = -0.25
        return m
    if mode == "rotation":
        return r_z(90 * np.pi / 180)
    if mode == "scale":
        m = np.eye(4)
        m[0, 0] = m[1, 1] = m[2, 2] = 1.2
        return m
    if mode == "multi":
        s = np.eye(4)
        s[0, 0] = s[1, 1] = s[2, 2] = 1.2
        r = r_z(90 * np.pi / 180)
        t = np.eye(4)
        t[1, 3] = -0.25
        return s @ r @ t
    raise ValueError(f"unknown mani_mode {mode!r}")


def generate_poses_eval(args, center=None) -> dict:
    """Build + persist the eval transformation for args.mani_mode.

    Center lookup: the reference hardcodes per-scene centers
    (pose_generator.py:54-57); scenes outside that table (e.g. stress
    fixtures) ship their own mani/obj_center.json {"center": [x,y,z]}."""
    if center is None:
        center = MANI_CENTERS.get(args.expname)
    if center is None:
        cpath = os.path.join(args.datadir, "mani", "obj_center.json")
        if os.path.exists(cpath):
            with open(cpath) as f:
                center = json.load(f)["center"]
        else:
            raise KeyError(
                f"no manipulation center for scene {args.expname!r}: not in "
                f"MANI_CENTERS and {cpath} does not exist")
    tar = _center_conjugate(_mode_matrix(args.mani_mode), center)
    transformations = {"transformations": [
        {"transformation": tar.tolist(), "mode": args.mani_mode}]}
    save_path = os.path.join(args.datadir, "mani", args.mani_mode,
                             "transformation_matrix.json")
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    with open(save_path, "w") as f:
        json.dump(transformations, f, ensure_ascii=False, indent=2)
    return transformations


def load_mani_poses(args) -> dict:
    with open(os.path.join(args.datadir, "mani", args.mani_mode,
                           "transformation_matrix.json")) as f:
        return json.load(f)


def generate_poses_demo(objs, args) -> dict:
    """Per-object transform sequences for the demo (pose_generator.py:131-232)."""
    views = args.views
    outputs = {}
    for obj in objs:
        mode = obj["mani_mode"]
        if mode == "deform":
            continue
        center = obj["obj_center"]
        poses_list = []
        if mode == "translation":
            for oper_dist in obj["distance"]:
                step = np.eye(4)
                step[0, 3] = oper_dist / views
                t = np.eye(4)
                for i in range(views):
                    if i > 0:
                        t = t @ step
                    tar = _center_conjugate(t, center)
                    poses_list.append({"transformation": tar.tolist(),
                                       "mode": "translation"})
        elif mode == "rotation":
            for deg in np.linspace(0, 180, views):
                tar = _center_conjugate(r_z(deg * np.pi / 180), center)
                poses_list.append({"transformation": tar.tolist(), "mode": "rotation"})
        elif mode in ("scale", "multi"):
            tar = _center_conjugate(_mode_matrix(mode), center)
            poses_list.append({"transformation": tar.tolist(), "mode": mode})
        outputs[obj["obj_name"]] = poses_list

    save_path = os.path.join(args.datadir, "mani", "transformation_matrix.json")
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    with open(save_path, "w") as f:
        json.dump(outputs, f, ensure_ascii=False, indent=2)
    return outputs


def load_mani_demo_poses(args) -> dict:
    with open(os.path.join(args.datadir, "mani", "transformation_matrix.json")) as f:
        return json.load(f)
