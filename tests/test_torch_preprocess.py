"""ScanNet's offline pipeline in the port (dmnerf_torch/data/scannet_preprocess)
against the JAX package's, on a small raw scene written here: a version-4
.sens with real JPEG colour blobs (written by imageio) and zlib depth,
label-filt and instance-filt PNGs (imageio) and a label-map TSV.

- `run.main` of both packages gives the same output tree, file by file:
  .jpg bytes, decoded .png arrays, .npz arrays and .txt text; and the port's
  ScanNet reader loads the result (with resize) to the JAX reader's
  SceneData to the bit;
- SensorData parses the same header and frames, export_all with a nearest
  resize gives the same files, and write_sens writes a file that the JAX
  parser reads back;
- the label remap, the instance re-index (set order) and the split's
  instance count agree;
- write_png's 16-bit greyscale reads back equal through read_png and
  imageio.
"""

import dataclasses
import io
import os
import shutil
import struct
import sys
import types
import zlib

import cv2
import h5py
import imageio.v2 as imageio
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests", "torch_golden", "jpeg"))

import dmnerf_torch.data.scannet as tscannet  # noqa: E402
import dmnerf_torch.data.scannet_preprocess.preprocess as tprep  # noqa: E402
import dmnerf_torch.data.scannet_preprocess.run as trun  # noqa: E402
import dmnerf_torch.data.scannet_preprocess.sensordata as tsens  # noqa: E402
import dmnerf_torch.data.scannet_preprocess.split as tsplit  # noqa: E402
import dmnerf_tpu.data.scannet as jscannet  # noqa: E402
import dmnerf_tpu.data.scannet_preprocess.preprocess as jprep  # noqa: E402
import dmnerf_tpu.data.scannet_preprocess.run as jrun  # noqa: E402
import dmnerf_tpu.data.scannet_preprocess.sensordata as jsens  # noqa: E402
import dmnerf_tpu.data.scannet_preprocess.split as jsplit  # noqa: E402
import jpeg_fixtures  # noqa: E402
from dmnerf_torch.utils.png import read_png, write_png  # noqa: E402

SCENE = "scene0007_00"
COLOR_HW, DEPTH_HW = (29, 38), (14, 19)
N_FRAMES = 9


def _jpeg(img):
    bio = io.BytesIO()
    imageio.imwrite(bio, img, format="jpeg")
    return bio.getvalue()


def _write_sens(path, colors, depths, poses, Kc, Kd):
    """The .sens writer of this test (independent of the port's write_sens)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        f.write(struct.pack("<Q", 7) + b"testcam")
        for m in (Kc, np.eye(4), Kd, np.eye(4)):
            f.write(np.asarray(m, np.float32).tobytes())
        f.write(struct.pack("<ii", 2, 1))
        f.write(struct.pack("<IIII", COLOR_HW[1], COLOR_HW[0], DEPTH_HW[1], DEPTH_HW[0]))
        f.write(struct.pack("<f", 1000.0) + struct.pack("<Q", len(colors)))
        for i, (c, d, p) in enumerate(zip(colors, depths, poses)):
            blob = zlib.compress(d.tobytes())
            f.write(np.asarray(p, np.float32).tobytes() + struct.pack("<QQ", i, i))
            f.write(struct.pack("<QQ", len(c), len(blob)) + c + blob)


def _raw_scene(root):
    """scans/{SCENE}/{SCENE}.sens, out/{SCENE}/{label,instance}-filt/*.png
    and labels.tsv under root. Frame 4 has no object in its centre crop, so
    the split drops it."""
    rng = np.random.default_rng(0)
    colors, depths, poses = [], [], []
    os.makedirs(os.path.join(root, "scans", SCENE))
    for sub in ("label-filt", "instance-filt"):
        os.makedirs(os.path.join(root, "out", SCENE, sub))
    for i in range(N_FRAMES):
        img = np.clip(jpeg_fixtures.smooth_frame(*COLOR_HW).astype(np.int64)
                      + rng.integers(-30, 31, COLOR_HW + (3,)), 0, 255).astype(np.uint8)
        colors.append(_jpeg(img))
        depths.append(rng.integers(0, 6000, DEPTH_HW).astype(np.uint16))
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3) * (i + 1) / 3.0
        poses.append(pose)
        ins = np.zeros(DEPTH_HW, np.uint8)
        sem = np.ones(DEPTH_HW, np.uint16)                 # wall: not a training class
        if i != 4:
            for k in range(1, 4 + i % 3):
                r, c = rng.integers(0, DEPTH_HW[0] - 4), rng.integers(0, DEPTH_HW[1] - 5)
                ins[r:r + 4, c:c + 5] = k * 3
                sem[r:r + 4, c:c + 5] = (2, 4, 6, 40)[k % 4]
            sem[ins == 3 * (3 if i % 2 else 1)] = 1000    # an id the TSV does not list
        imageio.imwrite(os.path.join(root, "out", SCENE, "label-filt", f"{i}.png"), sem)
        imageio.imwrite(os.path.join(root, "out", SCENE, "instance-filt", f"{i}.png"), ins)
    Kc = np.array([[30.0, 0, 19, 0], [0, 30.0, 14.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    Kd = np.diag([19 / 38, 14 / 29, 1.0, 1.0]) @ Kc
    _write_sens(os.path.join(root, "scans", SCENE, f"{SCENE}.sens"), colors, depths, poses,
                Kc, Kd)
    with open(os.path.join(root, "labels.tsv"), "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\n")
        for rid, name, nyu in ((1, "wall", 1), (2, "chair", 5), (4, "table", 7),
                               (6, "couch", 6), (40, "lamp", 35), (41, "floor", 2)):
            f.write(f"{rid}\t{name}\t{name}\t1\t{nyu}\t\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"torch": root, "tpu": root}: each package's run.main on its own copy
    of the raw scene."""
    base = tmp_path_factory.mktemp("prep")
    _raw_scene(str(base / "raw"))
    out = {}
    for name, run in (("torch", trun), ("tpu", jrun)):
        root = base / name
        shutil.copytree(base / "raw", root)
        run.main(["--scans", str(root / "scans"), "--out", str(root / "out"),
                  "--label_map", str(root / "labels.tsv"),
                  "--save_dir", str(root / "scannet"), "--frames", "3"])
        out[name] = root
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


KINDS = {".jpg": "bytes", ".png": "decoded arrays", ".npz": "arrays", ".txt": "text"}


@pytest.mark.parametrize("ext", sorted(KINDS))
def test_run_main_gives_the_jax_tree(trees, ext):
    t, j = trees["torch"], trees["tpu"]
    files = _files(j)
    assert _files(t) == files
    assert {os.path.splitext(f)[1] for f in files} <= set(KINDS) | {".sens", ".tsv"}
    chosen = [f for f in files if f.endswith(ext) and not f.startswith("scans")]
    assert len(chosen) >= N_FRAMES
    for f in chosen:
        a, b = os.path.join(t, f), os.path.join(j, f)
        if ext == ".jpg":
            assert open(a, "rb").read() == open(b, "rb").read(), f
        elif ext == ".png":
            x, y = imageio.imread(a), imageio.imread(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
            assert np.array_equal(read_png(a), x), f
        elif ext == ".npz":
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files), f
            for k in x.files:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (f, k)
        else:
            assert open(a).read() == open(b).read(), f


def test_the_split_kept_the_frames_with_objects(trees):
    d = os.path.join(trees["torch"], "scannet", SCENE)
    train = np.loadtxt(os.path.join(d, "train_split.txt")).astype(int)
    assert 4 not in train and len(train) >= 3
    depth = read_png(os.path.join(d, "train", "train_depth", f"{train[0]}.png"))
    assert depth.dtype == np.uint16 and depth.shape == DEPTH_HW


def _same_scene(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, list):
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("testskip", [1, 2])
def test_the_preprocessed_scene_loads_to_the_jax_scene(trees, testskip, tmp_path):
    """The port's tree through the port's reader, the JAX package's tree
    through the JAX reader, both with resize (intrinsic_depth.txt): the same
    SceneData to the bit."""
    got = {}
    for name, mod in (("torch", tscannet), ("tpu", jscannet)):
        datadir = tmp_path / name
        shutil.copytree(os.path.join(trees[name], "scannet", SCENE), datadir)
        with h5py.File(datadir / "ins_rgb.hdf5", "w") as f:
            f.create_dataset("datasets", data=np.arange(60, dtype=np.uint8).reshape(20, 3))
        got[name] = mod.load_data(types.SimpleNamespace(
            datadir=str(datadir), testskip=testskip, resize=True, crop_width=600,
            crop_height=450))
    assert got["torch"].images.shape[1:3] == (480, 640) and got["torch"].ins_num >= 2
    _same_scene(got["torch"], got["tpu"])


def test_sensordata_parses_the_same(trees):
    path = os.path.join(trees["torch"], "scans", SCENE, f"{SCENE}.sens")
    t, j = tsens.SensorData(path), jsens.SensorData(path)
    for k in ("sensor_name", "color_compression", "depth_compression", "color_width",
              "color_height", "depth_width", "depth_height", "depth_shift", "num_frames",
              "intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        a, b = getattr(t, k), getattr(j, k)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, k
    for (i, p, c, d), (i2, p2, c2, d2) in zip(t.iter_frames(2), j.iter_frames(2)):
        assert i == i2 and np.array_equal(p, p2) and c == c2 and d == d2
        assert np.array_equal(t.decode_depth(d), j.decode_depth(d2))


@pytest.mark.parametrize("image_size", [(17, 23), (40, 70)])
def test_export_all_with_a_resize_gives_the_same_files(trees, image_size, tmp_path):
    path = os.path.join(trees["torch"], "scans", SCENE, f"{SCENE}.sens")
    tsens.SensorData(path).export_all(str(tmp_path / "t"), frame_skip=3, image_size=image_size)
    jsens.SensorData(path).export_all(str(tmp_path / "j"), frame_skip=3, image_size=image_size)
    files = _files(tmp_path / "j")
    assert _files(tmp_path / "t") == files and len(files) == 3 * 3 + 4
    for f in files:
        a, b = tmp_path / "t" / f, tmp_path / "j" / f
        if f.endswith(".png"):
            x, y = imageio.imread(a), imageio.imread(b)
            assert x.dtype == y.dtype == np.uint16 and x.shape == image_size
            assert np.array_equal(x, y), f
        else:
            assert a.read_bytes() == b.read_bytes(), f


def test_write_sens_reads_back_in_the_jax_parser(tmp_path):
    rng = np.random.default_rng(3)
    colors = [_jpeg(rng.integers(0, 256, (11, 13, 3), dtype=np.uint8)) for _ in range(3)]
    depths = [rng.integers(0, 9000, (5, 7)).astype(np.uint16) for _ in range(3)]
    poses = [rng.normal(size=(4, 4)) for _ in range(3)]
    Kc, Kd = np.diag([9.0, 9.0, 1, 1]), np.diag([5.0, 5.0, 1, 1])
    tsens.write_sens(str(tmp_path / "a.sens"), colors, depths, poses, Kc, Kd)
    sd = jsens.SensorData(str(tmp_path / "a.sens"))
    assert (sd.color_width, sd.color_height, sd.depth_width, sd.depth_height) == (13, 11, 7, 5)
    assert sd.num_frames == 3 and sd.color_compression == "jpeg"
    assert np.array_equal(sd.intrinsic_color, Kc.astype(np.float32))
    assert np.array_equal(sd.intrinsic_depth, Kd.astype(np.float32))
    for (i, p, c, d), color, depth, pose in zip(sd.iter_frames(), colors, depths, poses):
        assert c == color and np.array_equal(sd.decode_depth(d), depth)
        assert np.array_equal(p, pose.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_maps_agree(seed, tmp_path):
    rng = np.random.default_rng(seed)
    tsv = tmp_path / "l.tsv"
    tsv.write_text("id\tnyu40id\n" + "".join(f"{i}\t{rng.integers(0, 41)}\n" for i in range(60)))
    assert tprep.read_label_mapping(str(tsv)) == jprep.read_label_mapping(str(tsv))
    mapping = jprep.read_label_mapping(str(tsv))
    raw = rng.integers(0, 70, (23, 31)).astype(np.int16)
    nyu = tprep.map_sem_nyu(raw, mapping)
    assert np.array_equal(nyu, jprep.map_sem_nyu(raw, mapping))
    sem = tprep.map_sem_train_ids(nyu)
    assert sem.dtype == np.int16 and np.array_equal(sem, jprep.map_sem_train_ids(nyu))
    ins = rng.integers(0, 40, (23, 31)).astype(np.int16) * 37
    sem1 = np.where(sem >= 0, 2, -1).astype(np.int16)      # one class: every instance maps
    assert np.array_equal(tprep.map_ins_ids(ins, sem1), jprep.map_ins_ids(ins, sem1))
    with pytest.raises(ValueError):
        tprep.map_ins_ids(np.zeros((2, 2), np.int16), np.array([[0, 1], [0, 1]], np.int16))


@pytest.mark.parametrize("shape", [(480, 640), (968, 1296), (21, 33)])
def test_split_instance_count_agrees(shape, tmp_path):
    rng = np.random.default_rng(shape[0])
    ins = np.full(shape, -1, np.int16)
    for k in range(6):
        r, c = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        ins[r:r + shape[0] // 5, c:c + shape[1] // 5] = k
    np.savez(tmp_path / "a.npz", ins_2d_label_id=ins)
    assert tsplit._ins_count(str(tmp_path / "a.npz")) == jsplit._ins_count(str(tmp_path / "a.npz"))


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (480, 640)])
def test_write_png_uint16_round_trip(shape, tmp_path):
    img = np.random.default_rng(7).integers(0, 65536, shape).astype(np.uint16)
    write_png(str(tmp_path / "d.png"), img)
    for got in (read_png(str(tmp_path / "d.png")), imageio.imread(tmp_path / "d.png")):
        assert got.dtype == np.uint16 and np.array_equal(got, img)
    assert np.array_equal(cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED), img)
