"""The port's copies of the JAX package's host modules (config, data/base
and data/synthetic, edit transforms and deform, utils/viz, mesh and native)
give what their sources give, and no module of the port imports the JAX
package, imageio, h5py, cv2 or PIL.

The copies live in dmnerf_torch/ and name their source on their first line
("Copied from"); each case here runs a source and its copy on the same
inputs. The DM-SR, DM-SR-mani, Replica and ScanNet readers, ScanNet's
preprocessing and data/procedural.py are ported ("Ported from": PNG, JPEG and
HDF5 through utils/png.py, utils/jpeg.py and utils/hdf5.py, the march in
torch); tests/test_torch_scenes.py and tests/test_torch_preprocess.py hold
them to the JAX package's.
"""

import ast
import dataclasses
import glob
import os
import shutil
import types

import numpy as np
import pytest

import dmnerf_torch.config as tcfg
import dmnerf_torch.data.base as tbase
import dmnerf_torch.edit.deform as tdeform
import dmnerf_torch.edit.transforms as ttrans
import dmnerf_torch.mesh.cleanup as tclean
import dmnerf_torch.mesh.grid as tgrid
import dmnerf_torch.mesh.marching as tmarch
import dmnerf_torch.mesh.mc_tables as ttables
import dmnerf_torch.mesh.ply as tply
import dmnerf_torch.native as tnative
import dmnerf_torch.utils.viz as tviz
import dmnerf_tpu.config as jcfg
import dmnerf_tpu.data.base as jbase
import dmnerf_tpu.edit.deform as jdeform
import dmnerf_tpu.edit.transforms as jtrans
import dmnerf_tpu.mesh.cleanup as jclean
import dmnerf_tpu.mesh.grid as jgrid
import dmnerf_tpu.mesh.marching as jmarch
import dmnerf_tpu.mesh.mc_tables as jtables
import dmnerf_tpu.mesh.ply as jply
import dmnerf_tpu.native as jnative
import dmnerf_tpu.utils.viz as jviz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.txt"), recursive=True))
PORT_FILES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "dmnerf_torch", "**", "*.py"), recursive=True)) + ["chip_smoke.py"]


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


@pytest.mark.parametrize("path", CONFIGS)
def test_config_files_parse_the_same(path):
    argv = ["--config", os.path.join(REPO, path)]
    assert vars(tcfg.parse_args(argv)) == vars(jcfg.parse_args(argv))


def test_the_configs_were_found():
    assert len(CONFIGS) >= 50


@pytest.mark.parametrize("datadir", ["./data/synthetic/boxroom8x4",
                                     "./data/synthetic/boxroomcrop8x4"])
def test_load_dataset_gives_the_same_scene(datadir):
    args = types.SimpleNamespace(datadir=datadir)
    got, want = tbase.load_dataset(args), jbase.load_dataset(args)
    assert type(got).__name__ == type(want).__name__ == "SceneData"
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    for name in fields:
        assert _equal(getattr(got, name), getattr(want, name)), name
    if "crop" in datadir:
        assert got.crop_mask is not None and got.ins_indices is not None


@pytest.mark.parametrize("mode", ["translation", "rotation", "scale", "multi"])
def test_transforms_agree(mode, tmp_path):
    rng = np.random.default_rng(0)
    center = rng.normal(size=3)
    for fn in ("r_x", "r_y", "r_z"):
        a = rng.uniform(-np.pi, np.pi)
        assert _equal(getattr(ttrans, fn)(a), getattr(jtrans, fn)(a))
    th, ph, r = rng.uniform(0, 360), rng.uniform(-90, 0), rng.uniform(1, 5)
    assert _equal(ttrans.pose_spherical(th, ph, r), jtrans.pose_spherical(th, ph, r))
    assert _equal(ttrans._mode_matrix(mode), jtrans._mode_matrix(mode))
    M = rng.normal(size=(4, 4))
    assert _equal(ttrans._center_conjugate(M, center), jtrans._center_conjugate(M, center))

    out = {}
    for name, mod in (("torch", ttrans), ("tpu", jtrans)):
        args = types.SimpleNamespace(expname="not_a_scene", mani_mode=mode, views=3,
                                     datadir=str(tmp_path / name))
        ev = mod.generate_poses_eval(args, center=list(center))
        objs = [{"obj_name": "a", "mani_mode": mode, "obj_center": list(center),
                 "distance": [0.3, -0.2]},
                {"obj_name": "b", "mani_mode": "deform", "obj_center": [0, 0, 0]}]
        demo = mod.generate_poses_demo(objs, args)
        out[name] = (ev, mod.load_mani_poses(args), demo, mod.load_mani_demo_poses(args))
    assert _equal(out["torch"], out["tpu"])


@pytest.mark.parametrize("func", ["sin", "ex", "linear", "abs_linear", "ln"])
def test_deform_agrees(func):
    rng = np.random.default_rng(1)
    H, W = 7, 5
    ro, rd = rng.normal(size=(H * W, 3)), rng.normal(size=(H * W, 3))
    assert _equal(tdeform.deform_curve(func, H, W), jdeform.deform_curve(func, H, W))
    for view in range(4):
        assert _equal(tdeform.deform_scale(func, view), jdeform.deform_scale(func, view))
        assert _equal(tdeform.deform_offsets(func, H, W, view),
                      jdeform.deform_offsets(func, H, W, view))
        assert _equal(tdeform.deform_rays(ro, rd, func, H, W, view),
                      jdeform.deform_rays(ro, rd, func, H, W, view))


def test_viz_label_mappers_agree(tmp_path):
    rng = np.random.default_rng(2)
    rgbs = rng.integers(0, 255, (6, 3))
    labels = rng.integers(-2, 6, (9, 11))
    pos = np.abs(labels) % 6
    color_dict = {str(i): (i * 5) % 6 for i in range(6)}
    ins_map = {str(i): (i + 1) % 6 for i in range(5)}
    probs = rng.uniform(size=(9, 11, 6))
    x = rng.uniform(-0.5, 1.5, (4, 3))
    assert _equal(tviz.to8b(x), jviz.to8b(x))
    for fn, fargs in (("render_label2img", (pos, rgbs, color_dict, ins_map)),
                      ("render_gt_label2img", (pos, rgbs, color_dict)),
                      ("render_label2world", (pos.reshape(-1), rgbs, color_dict, ins_map)),
                      ("ins2img", (probs, rgbs)),
                      ("matching_label2img", (labels.clip(-2, 5), rgbs))):
        assert _equal(getattr(tviz, fn)(*fargs), getattr(jviz, fn)(*fargs)), fn
    path = tmp_path / "colors.json"
    path.write_text('{"dmsr": {"tiny": {"1": 2, "3": 0}}}')
    assert tviz.load_color_dict(str(path), "dmsr", "tiny") == \
        jviz.load_color_dict(str(path), "dmsr", "tiny")


def test_dmsr_mani_readers_agree(tmp_path):
    pytest.importorskip("imageio")
    pytest.importorskip("h5py")
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_edit import _dmsr_fixture

    import dmnerf_torch.data.dmsr_mani as tmani
    import dmnerf_tpu.data.dmsr_mani as jmani

    root = tmp_path / "dmsr" / "tiny"
    _dmsr_fixture(str(root))
    args = types.SimpleNamespace(datadir=str(root), mani_mode="translation", testskip=1)
    got, want = tmani.load_data(args), jmani.load_data(args)
    for f in dataclasses.fields(want):
        assert _equal(getattr(got, f.name), getattr(want, f.name)), f.name


def _volume(kind):
    """tests/test_mesh.py's volumes: a sphere of radius 10 in 32^3, and a
    lightly smoothed random 14^3 volume (saddle cases)."""
    if kind == "sphere":
        t = np.arange(32) - 16.0
        x, y, z = np.meshgrid(t, t, t, indexing="ij")
        return (10.0 - np.sqrt(x ** 2 + y ** 2 + z ** 2)).astype(np.float32)
    vol = np.random.default_rng(0).normal(size=(14, 14, 14)).astype(np.float32)
    for ax in range(3):
        vol = (vol + np.roll(vol, 1, ax) + np.roll(vol, -1, ax)) / 3.0
    return vol


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kind", ["sphere", "random"])
@pytest.mark.parametrize("fn", ["marching_cubes", "marching_tetrahedra"])
def test_marching_agrees(fn, kind, use_native):
    if use_native:
        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the native marching module")
        assert tnative.load() is not None and jnative.load() is not None
    vol = _volume(kind)
    got = getattr(tmarch, fn)(vol, 0.0, use_native=use_native)
    want = getattr(jmarch, fn)(vol, 0.0, use_native=use_native)
    assert len(got[1]) > 100
    assert _equal(got, want)


def test_native_library_is_built_under_build_native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native marching module")
    mod = tnative.load()
    assert mod is not None
    built = os.path.realpath(mod.__file__)
    assert os.path.dirname(built) == os.path.join(REPO, "build", "native")
    assert not glob.glob(os.path.join(REPO, "dmnerf_torch", "**", "*.so"), recursive=True)


def test_mesh_tables_and_bounds_agree():
    assert _equal(ttables.build_tables(), jtables.build_tables())
    assert _equal(ttables.EDGES, jtables.EDGES)
    rng = np.random.default_rng(4)
    cloud = rng.uniform(-1, 1, (500, 3)) * [4.0, 2.0, 1.0] @ np.linalg.qr(
        rng.normal(size=(3, 3)))[0] + [5.0, -3.0, 2.0]
    for fn in ("oriented_bounds", "oriented_bounds_pca"):
        assert _equal(getattr(tgrid, fn)(cloud), getattr(jgrid, fn)(cloud)), fn
    to_origin, extents = jgrid.oriented_bounds(cloud)
    assert _equal(tgrid.grid_within_bound([-1.0, 1.0], extents, np.linalg.inv(to_origin), 6),
                  jgrid.grid_within_bound([-1.0, 1.0], extents, np.linalg.inv(to_origin), 6))


def test_clean_mesh_agrees():
    verts, faces, _ = jmarch.marching_cubes(_volume("random"), 0.0, use_native=False)
    for min_num_cluster in (5, 40):
        got = tclean.clean_mesh(verts, faces, min_num_cluster=min_num_cluster)
        want = jclean.clean_mesh(verts, faces, min_num_cluster=min_num_cluster)
        assert 0 < len(got[1]) < len(faces) and _equal(got, want)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer", ["torch", "tpu"])
def test_ply_written_by_one_reads_back_in_the_other(writer, binary, tmp_path):
    rng = np.random.default_rng(5)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, (30, 3))
    c = rng.integers(0, 255, (50, 3)).astype(np.uint8)
    mine, other = (tply, jply) if writer == "torch" else (jply, tply)
    mine.write_ply(str(tmp_path / "a.ply"), v, f, vertex_colors=c, binary=binary)
    other.write_ply(str(tmp_path / "b.ply"), v, f, vertex_colors=c, binary=binary)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert _equal(other.read_ply(str(tmp_path / "a.ply")), mine.read_ply(str(tmp_path / "a.ply")))


def _imports(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_the_port_imports_nothing_of_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("dmnerf_tpu", "jax", "jaxlib")]
    assert not bad, f"{path} imports {bad}"


READER_LIBRARIES = ("imageio", "h5py", "cv2", "PIL")


@pytest.mark.parametrize("path", PORT_FILES)
def test_the_port_imports_no_reader_library(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in READER_LIBRARIES]
    assert not bad, f"{path} imports {bad}"


PORTED = ["dmnerf_torch/data/dmsr.py", "dmnerf_torch/data/dmsr_mani.py",
          "dmnerf_torch/data/replica.py", "dmnerf_torch/data/scannet.py",
          "dmnerf_torch/data/procedural.py", "dmnerf_torch/eval/lpips.py",
          "dmnerf_torch/utils/profiling.py", "dmnerf_torch/parallel/mesh.py",
          "dmnerf_torch/parallel/model_parallel.py", "dmnerf_torch/graft_entry.py"] + [
    f"dmnerf_torch/data/scannet_preprocess/{m}.py"
    for m in ("__init__", "sensordata", "preprocess", "split", "run")]


@pytest.mark.parametrize("path", [p for p in PORT_FILES if open(os.path.join(REPO, p))
                                  .readline().startswith(("# Copied from", "# Ported from"))])
def test_copies_and_ports_name_a_source_that_exists(path):
    first = open(os.path.join(REPO, path)).readline()
    kind, source = first[2:].split(" from ", 1)
    source = source.split()[0].rstrip(".")
    assert kind == ("Ported" if path in PORTED else "Copied"), first
    # the JAX package, or its entry points file at the root of the repo
    assert (source.startswith("dmnerf_tpu/") or source == "__graft_entry__.py") and \
        os.path.exists(os.path.join(REPO, source)), first
