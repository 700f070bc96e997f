"""Reference-format scenes in the port, against the JAX package:

- the port's DM-SR, DM-SR-mani, Replica and ScanNet readers give a SceneData
  equal to the JAX loaders' to the bit, on scenes that the JAX package's own
  tools/make_stress_scenes.py wrote (small sizes), and do so in a fresh
  interpreter where imageio, h5py, cv2 and PIL cannot be imported; that
  interpreter then trains 2 steps through dmnerf_torch.cli.train and runs
  cli.test --mani_eval on the CPU;
- ScanNet's nearest resize equals cv2.resize(INTER_NEAREST);
- data/procedural.py's torch march equals the JAX package's numpy march
  (images within 1e-5, labels on at least 99.9% of the pixels);
- dmnerf_torch.tools.make_stress_scenes writes the JAX tool's layout: the
  same files, equal JSON, poses and palettes, and PNGs and JPEGs equal on at
  least 99.9% of the pixels and within 1 everywhere; each ScanNet .jpg is
  equal to the JAX tool's byte for byte wherever the two GT frames are equal
  as uint8, and every one is when both tools write from one GT renderer;
- in a fresh interpreter where imageio, h5py, cv2 and PIL cannot be
  imported, the ScanNet stress scene loads with and without resize to the
  JAX loader's SceneData and trains 2 steps through cli.train on the CPU.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
import types

import cv2
import h5py
import imageio.v2 as imageio
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import dmnerf_torch.data.base as tbase  # noqa: E402
import dmnerf_torch.data.dmsr_mani as tmani  # noqa: E402
import dmnerf_torch.data.procedural as tproc  # noqa: E402
import dmnerf_torch.data.scannet as tscannet  # noqa: E402
import dmnerf_tpu.data.base as jbase  # noqa: E402
import dmnerf_tpu.data.dmsr_mani as jmani  # noqa: E402
import dmnerf_tpu.data.procedural as jproc  # noqa: E402
from dmnerf_torch.tools import make_stress_scenes as ttool  # noqa: E402
from dmnerf_tpu.edit.transforms import (_center_conjugate, _mode_matrix,  # noqa: E402
                                        pose_spherical)
from tools import make_stress_scenes as jtool  # noqa: E402

BLOCKED = ("imageio", "h5py", "cv2", "PIL")
SIZES = {"dmsr": dict(n_obj=5, H=24, W=32, n_train=3, n_test=2, target_label=2),
         "replica": dict(n_obj=3, H=16, W=20),
         "replica64": dict(n_obj=64, H=8, W=10, name="replica64"),
         "scannet": dict(n_obj=5, H=24, W=32, n_train=3, n_test=2)}


def _write(tool, out, scene, rend):
    writer = {"dmsr": tool.write_dmsr, "replica": tool.write_replica,
              "replica64": tool.write_replica, "scannet": tool.write_scannet}[scene]
    writer(out, rend, **SIZES[scene])
    return os.path.join(out, scene, "stress")


def _recording(renderer):
    """The tool's GT renderer, keeping each frame's uint8 image in call order."""
    class Recording(renderer):
        def __call__(self, *a):
            img, lab = super().__call__(*a)
            self.frames.append((255 * np.clip(img, 0, 1)).astype(np.uint8))
            return img, lab
    rend = Recording("cpu", n_samples=48)
    rend.frames = []
    return rend


GT_FRAMES = {}      # tool -> the uint8 GT frames of its ScanNet scene, in write order


@pytest.fixture(scope="module")
def jax_scenes(tmp_path_factory):
    """scene -> directory, written by the JAX package's tool (numpy GT)."""
    out = str(tmp_path_factory.mktemp("jax_scenes"))
    rend = jtool.Renderer("cpu", n_samples=48)
    dirs = {s: _write(jtool, out, s, rend) for s in SIZES if s != "scannet"}
    rend = _recording(jtool.Renderer)
    dirs["scannet"] = _write(jtool, out, "scannet", rend)
    GT_FRAMES["tpu"] = rend.frames
    return dirs


@pytest.fixture(scope="module")
def port_scenes(tmp_path_factory):
    """scene -> directory, written by the port's tool (torch GT on the CPU)."""
    out = str(tmp_path_factory.mktemp("port_scenes"))
    rend = ttool.Renderer("cpu", n_samples=48)
    dirs = {s: _write(ttool, out, s, rend) for s in SIZES if s != "scannet"}
    rend = _recording(ttool.Renderer)
    dirs["scannet"] = _write(ttool, out, "scannet", rend)
    GT_FRAMES["torch"] = rend.frames
    return dirs


def _scannet_jpgs(root):
    """The ScanNet scene's .jpg files in the order the tools write them."""
    out = []
    for split in ("train", "test"):
        ids = np.loadtxt(os.path.join(root, f"{split}_split.txt")).astype(int).reshape(-1)
        out += [os.path.join(split, f"{split}_images", f"{i}.jpg") for i in ids]
    return out


def _equal(a, b):
    """Bit-for-bit equality of two loaded values (arrays, lists, dicts, scalars)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _same_scene(got, want):
    for f in dataclasses.fields(want):
        assert _equal(getattr(got, f.name), getattr(want, f.name)), f.name


LOADS = {
    "dmsr_train": ("dmsr", dict(is_train=True)),
    "dmsr_test_views": ("dmsr", dict(is_train=False, views=3)),
    "dmsr_testskip2": ("dmsr", dict(is_train=True, testskip=2)),
    "dmsr_mesh_rigid": ("dmsr", dict(is_train=False, mesh=True, mani_type="rigid", views=2)),
    "dmsr_demo_deform": ("dmsr", dict(is_train=False, mani_demo=True, mani_type="deform",
                                      views=2)),
    "replica": ("replica", dict()),
    "replica_testskip8": ("replica", dict(testskip=8)),
    "replica64": ("replica64", dict()),
    "scannet": ("scannet", dict(resize=False, crop_width=28, crop_height=20)),
    "scannet_resized": ("scannet", dict(resize=True, crop_width=576, crop_height=432)),
}


@pytest.mark.parametrize("case", sorted(LOADS))
def test_readers_give_the_jax_scene_to_the_bit(jax_scenes, case, tmp_path):
    scene, kw = LOADS[case]
    datadir = jax_scenes[scene]
    if scene == "scannet" and kw["resize"]:          # the resize reads intrinsic_depth.txt
        datadir = shutil.copytree(datadir, tmp_path / "scannet" / "stress")
        K = np.loadtxt(os.path.join(datadir, "intrinsic", "intrinsic_color.txt"))
        np.savetxt(os.path.join(datadir, "intrinsic", "intrinsic_depth.txt"), K)
    args = types.SimpleNamespace(datadir=str(datadir), **{"testskip": 1, **kw})
    _same_scene(tbase.load_dataset(args), jbase.load_dataset(args))


@pytest.mark.parametrize("testskip", [1, 2])
def test_mani_reader_gives_the_jax_scene_to_the_bit(jax_scenes, testskip):
    args = types.SimpleNamespace(datadir=jax_scenes["dmsr"], mani_mode="translation",
                                 testskip=testskip)
    _same_scene(tmani.load_data(args), jmani.load_data(args))


@pytest.mark.parametrize("src,dst", [((968, 1296), (480, 640)), ((24, 32), (480, 640)),
                                     ((7, 9), (3, 4)), ((100, 101), (333, 77))])
def test_nearest_resize_equals_cv2(src, dst):
    """cv2.resize(INTER_NEAREST) per image into a float64 array (the JAX
    loader's _resize) against the port's numpy index map, exactly."""
    rng = np.random.default_rng(0)
    for data in (rng.random((2,) + src + (3,)).astype(np.float32),
                 rng.integers(-1, 9, (2,) + src).astype(np.int16)):
        want = np.zeros((2,) + dst + data.shape[3:])
        for i in range(2):
            want[i] = cv2.resize(data[i], dst[::-1], interpolation=cv2.INTER_NEAREST)
        assert _equal(tscannet._resize(data, *dst), want)


def _dmsr_k(H, W):
    focal = 0.5 * W / np.tan(0.6)
    return np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1.0]])


@pytest.mark.parametrize("edited", [False, True])
@pytest.mark.parametrize("scene", ["dmsr", "replica64"])
def test_render_gt_equals_the_jax_march(scene, edited):
    """24x32 at 64 samples, 4 views: images within 1e-5, labels equal on at
    least 99.9% of the pixels (the argmax of equal weights up to rounding;
    ties are the only exemption)."""
    H, W = 24, 32
    n, seed = (16, 0) if scene == "dmsr" else (64, 3)
    K = _dmsr_k(H, W) if scene == "dmsr" else np.array(
        [[W / 2, 0, (W - 1) / 2], [0, W / 2, (H - 1) / 2], [0, 0, 1.0]])
    j_objs, t_objs = jproc.make_objects(n, seed=seed), tproc.make_objects(n, seed=seed)
    if edited:
        T = _center_conjugate(_mode_matrix("translation"), j_objs[4].center.tolist())
        j_objs, t_objs = jproc.edited_objects(j_objs, 5, T), tproc.edited_objects(t_objs, 5, T)
    for k in range(4):
        pose = np.asarray(pose_spherical(90.0 * k + 10.0, -20.0 - 10.0 * k, 4.0))
        if scene != "dmsr":
            pose[:3, :3] = pose[:3, :3] @ jtool.GL2CV
        want_img, want_lab = jproc.render_gt(pose, H, W, K, 1.0, 14.0, j_objs, n_samples=64)
        got_img, got_lab = tproc.render_gt(pose, H, W, K, 1.0, 14.0, t_objs, n_samples=64,
                                           device="cpu")
        assert got_img.dtype == want_img.dtype and got_lab.dtype == want_lab.dtype
        assert got_img.shape == want_img.shape and got_lab.shape == want_lab.shape
        assert np.abs(got_img - want_img).max() <= 1e-5
        assert (got_lab == want_lab).mean() >= 0.999


def test_scene_description_is_the_jax_packages():
    for n, seed in ((16, 0), (64, 3)):
        for a, b in zip(tproc.make_objects(n, seed), jproc.make_objects(n, seed)):
            assert _equal(dataclasses.asdict(a), dataclasses.asdict(b))
    assert _equal(tproc.palette(65), jproc.palette(65))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("scene", sorted(SIZES))
def test_port_tool_writes_the_jax_tools_layout(jax_scenes, port_scenes, scene):
    j, t = jax_scenes[scene], port_scenes[scene]
    files = _files(j)
    assert _files(t) == files and files
    equal_px = total_px = 0
    for f in files:
        a, b = os.path.join(j, f), os.path.join(t, f)
        if f.endswith((".png", ".jpg")):
            x, y = imageio.imread(a), imageio.imread(b)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            diff = np.abs(x.astype(np.int64) - y.astype(np.int64))
            assert diff.max() <= 1, f
            equal_px += int((diff.reshape(x.shape[0], x.shape[1], -1) == 0).all(-1).sum())
            total_px += x.shape[0] * x.shape[1]
        elif f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), f
        elif f.endswith(".txt"):
            assert open(a).read() == open(b).read(), f
        elif f.endswith(".hdf5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert _equal(fa["datasets"][()], fb["datasets"][()]), f
        elif f.endswith(".npz"):
            assert _equal(np.load(a)["ins_2d_label_id"], np.load(b)["ins_2d_label_id"]), f
        else:
            raise AssertionError(f"unexpected file {f}")
    assert equal_px >= 0.999 * total_px
    if scene == "scannet":
        jpgs = _scannet_jpgs(j)
        assert sorted(jpgs) == sorted(f for f in files if f.endswith(".jpg"))
        same_gt = [np.array_equal(a, b) for a, b in zip(GT_FRAMES["tpu"], GT_FRAMES["torch"])]
        assert len(same_gt) == len(jpgs) and any(same_gt)
        for f, same in zip(jpgs, same_gt):
            if same:
                assert open(os.path.join(j, f), "rb").read() == \
                    open(os.path.join(t, f), "rb").read(), f


def test_scannet_jpgs_equal_the_jax_tools_on_one_gt(tmp_path):
    """Both tools write the ScanNet scene from one GT renderer (the JAX
    package's numpy march): every file is equal byte for byte."""
    march = jtool.Renderer("cpu", n_samples=16)
    objs = jproc.make_objects(SIZES["scannet"]["n_obj"], seed=7)    # write_scannet's scene

    def rend(pose, H, W, K, _objs):
        return march(pose, H, W, K, objs)
    j = _write(jtool, str(tmp_path / "j"), "scannet", rend)
    t = _write(ttool, str(tmp_path / "t"), "scannet", rend)
    files = _files(j)
    assert _files(t) == files and sum(f.endswith(".jpg") for f in files) == 5
    for f in files:
        a, b = os.path.join(j, f), os.path.join(t, f)
        if f.endswith(".npz"):
            assert _equal(np.load(a)["ins_2d_label_id"], np.load(b)["ins_2d_label_id"]), f
        elif f.endswith(".hdf5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert _equal(fa["datasets"][()], fb["datasets"][()]), f
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f


def test_scannet_loads_and_trains_without_the_reader_libraries(jax_scenes, tmp_path):
    """A fresh interpreter where imageio, h5py, cv2 and PIL cannot be
    imported loads the ScanNet stress scene through the port with and without
    resize (the arrays come back through an .npz and must equal the JAX
    loader's to the bit), then trains 2 steps on it through
    dmnerf_torch.cli.train on the CPU."""
    datadir = shutil.copytree(jax_scenes["scannet"], tmp_path / "scannet" / "stress")
    K = np.loadtxt(os.path.join(datadir, "intrinsic", "intrinsic_color.txt"))
    np.savetxt(os.path.join(datadir, "intrinsic", "intrinsic_depth.txt"), K)
    kws = {"plain": dict(resize=False, crop_width=28, crop_height=20),
           "resized": dict(resize=True, crop_width=576, crop_height=432)}
    cfg = tmp_path / "tiny.txt"
    cfg.write_text("\n".join([
        "expname = tiny", f"basedir = {tmp_path / 'logs'}", "log_time = run",
        f"datadir = {datadir}", "N_train = 32", "N_samples = 8", "N_importance = 8",
        "N_test = 256", "near = 0.5", "far = 16.0", "testskip = 1", "netdepth = 2",
        "netwidth = 32", "multires = 4", "multires_views = 2", "penalize",
        "tolerance = 0.1", "deta_w = 0.1", "crop_width = 28", "crop_height = 20",
        "n_iters = 1", "i_print = 1", "i_save = 2", "i_test = 0"]) + "\n")
    script = textwrap.dedent(f"""
        import json, sys, types
        for m in {BLOCKED!r}:
            sys.modules[m] = None
        import numpy as np
        from dmnerf_torch.data.base import load_dataset
        import dmnerf_torch.cli.train as cli_train

        out, nones = {{}}, []
        for key, kw in {kws!r}.items():
            scene = load_dataset(types.SimpleNamespace(datadir={str(datadir)!r}, testskip=1,
                                                       **kw))
            for name, value in vars(scene).items():
                if value is None:
                    nones.append(f"{{key}}.{{name}}")
                elif name == "ins_indices":
                    out.update({{f"{{key}}.{{name}}.{{i}}": v for i, v in enumerate(value)}})
                else:
                    out[f"{{key}}.{{name}}"] = np.asarray(value)
        np.savez({str(tmp_path / 'scenes.npz')!r}, **out)
        state = cli_train.main(["--config", {str(cfg)!r}, "--device", "cpu"])
        print(json.dumps({{
            "nones": nones, "step": state.step,
            "loaded": sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                             and sys.modules[m] is not None)}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["step"] == 2 and res["loaded"] == []
    got = np.load(tmp_path / "scenes.npz")
    for key, kw in kws.items():
        want = jbase.load_dataset(types.SimpleNamespace(datadir=str(datadir), testskip=1, **kw))
        for f in dataclasses.fields(want):
            value = getattr(want, f.name)
            if value is None:
                assert f"{key}.{f.name}" in res["nones"], f"{key}.{f.name}"
            elif f.name == "ins_indices":
                assert len(value) == sum(k.startswith(f"{key}.ins_indices.") for k in got.files)
                for i, v in enumerate(value):
                    assert _equal(got[f"{key}.ins_indices.{i}"], v), f"{key}.ins_indices.{i}"
            else:
                assert _equal(got[f"{key}.{f.name}"], np.asarray(value)), f"{key}.{f.name}"


def test_readers_and_clis_run_without_the_reader_libraries(jax_scenes, tmp_path):
    """A fresh interpreter where imageio, h5py, cv2 and PIL cannot be
    imported loads the DM-SR, mani and Replica scenes through the port (the
    loaded arrays come back through an .npz and must equal the JAX loaders'
    to the bit), then trains 2 steps on the DM-SR scene through
    dmnerf_torch.cli.train and runs cli.test --mani_eval, on the CPU."""
    cfg = tmp_path / "tiny.txt"
    cfg.write_text("\n".join([
        "expname = tiny", f"basedir = {tmp_path / 'logs'}", "log_time = run",
        f"datadir = {jax_scenes['dmsr']}", "N_train = 32", "N_samples = 8",
        "N_importance = 8", "N_test = 256", "near = 0.5", "far = 16.0", "testskip = 1",
        "netdepth = 2", "netwidth = 32", "multires = 4", "multires_views = 2",
        "n_iters = 1", "i_print = 1", "i_save = 2", "i_test = 0", "target_label = 2",
        "mani_mode = translation", "views = 2"]) + "\n")
    script = textwrap.dedent(f"""
        import json, os, sys, types
        for m in {BLOCKED!r}:
            sys.modules[m] = None
        import numpy as np
        from dmnerf_torch.data.base import load_dataset
        from dmnerf_torch.data.dmsr_mani import load_data as load_mani
        import dmnerf_torch.cli.test as cli_test
        import dmnerf_torch.cli.train as cli_train

        out, nones = {{}}, []
        loads = {{"dmsr": lambda: load_dataset(types.SimpleNamespace(
                     datadir={jax_scenes['dmsr']!r}, testskip=1, is_train=True)),
                 "mani": lambda: load_mani(types.SimpleNamespace(
                     datadir={jax_scenes['dmsr']!r}, testskip=1, mani_mode="translation")),
                 "replica": lambda: load_dataset(types.SimpleNamespace(
                     datadir={jax_scenes['replica']!r}, testskip=1))}}
        for key, load in loads.items():
            for name, value in vars(load()).items():
                if value is None:
                    nones.append(f"{{key}}.{{name}}")
                else:
                    out[f"{{key}}.{{name}}"] = np.asarray(value)
        np.savez({str(tmp_path / 'scenes.npz')!r}, **out)
        state = cli_train.main(["--config", {str(cfg)!r}, "--device", "cpu"])
        savedir = cli_test.main(["--config", {str(cfg)!r}, "--mani_eval", "--device", "cpu"])
        print(json.dumps({{
            "nones": nones, "step": state.step,
            "results": os.path.exists(os.path.join(savedir, "translation",
                                                   "test_results.txt")),
            "loaded": sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                             and sys.modules[m] is not None)}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["step"] == 2 and res["results"] and res["loaded"] == []
    got = np.load(tmp_path / "scenes.npz")
    wants = {"dmsr": jbase.load_dataset(types.SimpleNamespace(
                 datadir=jax_scenes["dmsr"], testskip=1, is_train=True)),
             "mani": jmani.load_data(types.SimpleNamespace(
                 datadir=jax_scenes["dmsr"], testskip=1, mani_mode="translation")),
             "replica": jbase.load_dataset(types.SimpleNamespace(
                 datadir=jax_scenes["replica"], testskip=1))}
    for key, want in wants.items():
        for f in dataclasses.fields(want):
            value = getattr(want, f.name)
            if value is None:
                assert f"{key}.{f.name}" in res["nones"], f"{key}.{f.name}"
            else:
                assert _equal(got[f"{key}.{f.name}"], np.asarray(value)), f"{key}.{f.name}"
