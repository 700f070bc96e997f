"""The port imports neither jax, orbax, imageio, h5py, cv2, PIL nor anything
of the JAX package dmnerf_tpu: `import dmnerf_torch`, its edit modules, every
module of the port, a tiny CPU render, training run and mesh through its
CLIs, and ScanNet's preprocessing, in a fresh interpreter; trace_step's
reader and LPIPS in render_test with jax and dmnerf_tpu blocked from
loading."""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_and_cli_render_load_no_jax(tmp_path):
    script = textwrap.dedent(f"""
        import json, os, sys
        import torch
        import dmnerf_torch
        import dmnerf_torch.cli.test as cli
        import dmnerf_torch.edit.manipulator
        import dmnerf_torch.edit.runner
        from dmnerf_torch.models.convert import save_tar
        from dmnerf_torch.models.fields import FieldConfig, init_field_params

        cfg = FieldConfig(netdepth=2, netwidth=32, multires=2, multires_views=2, ins_num=4)
        g = torch.Generator().manual_seed(0)
        fields = [init_field_params(g, cfg) for _ in range(2)]
        ldir = os.path.join({str(tmp_path)!r}, "logs", "nj", "run")
        os.makedirs(ldir)
        save_tar(os.path.join(ldir, "000001.tar"), fields[0].state_dict(),
                 fields[1].state_dict(), 1)
        with open(os.path.join({str(tmp_path)!r}, "c.txt"), "w") as f:
            f.write("expname = nj\\nbasedir = {tmp_path / 'logs'}\\nlog_time = run\\n"
                    "datadir = ./data/synthetic/boxroom8x4\\nN_test = 64\\n"
                    "N_samples = 4\\nN_importance = 4\\nnear = 1.0\\nfar = 12.0\\n"
                    "netdepth = 2\\nnetwidth = 32\\nmultires = 2\\nmultires_views = 2\\n")
        savedir = cli.main(["--config", os.path.join({str(tmp_path)!r}, "c.txt"),
                            "--render", "--device", "cpu"])
        print(json.dumps({{
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "imageio",
                                                     "h5py", "cv2", "PIL", "dmnerf_tpu")),
            "results": os.path.exists(os.path.join(savedir, "test_results.txt")),
        }}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"loaded": [], "results": True}


def test_cli_train_loads_no_jax(tmp_path):
    """A tiny CPU run of dmnerf_torch.cli.train (boxroom8x4, 3 steps, a
    checkpoint and an in-train eval) in a fresh interpreter loads none of
    jax, orbax, imageio, h5py, cv2, PIL or dmnerf_tpu."""
    script = textwrap.dedent(f"""
        import json, os, sys
        import dmnerf_torch.cli.train as cli

        with open(os.path.join({str(tmp_path)!r}, "c.txt"), "w") as f:
            f.write("expname = nj\\nbasedir = {tmp_path / 'logs'}\\nlog_time = run\\n"
                    "datadir = ./data/synthetic/boxroom8x4\\nN_train = 32\\nN_test = 64\\n"
                    "N_samples = 4\\nN_importance = 4\\nnear = 1.0\\nfar = 12.0\\n"
                    "netdepth = 2\\nnetwidth = 32\\nmultires = 2\\nmultires_views = 2\\n"
                    "penalize\\ntolerance = 0.05\\ndeta_w = 0.05\\nn_iters = 2\\n"
                    "i_print = 1\\ni_save = 3\\ni_test = 2\\neval_views = 1\\n")
        state = cli.main(["--config", os.path.join({str(tmp_path)!r}, "c.txt"),
                          "--device", "cpu"])
        print(json.dumps({{
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "imageio",
                                                     "h5py", "cv2", "PIL", "dmnerf_tpu")),
            "step": state.step,
            "tar": os.path.exists(os.path.join({str(tmp_path)!r}, "logs", "nj", "run",
                                               "000003.tar")),
        }}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"loaded": [], "step": 3, "tar": True}


def test_cli_mesh_loads_no_jax(tmp_path):
    """A tiny CPU run of dmnerf_torch.cli.test --mesh (boxroom8x4, grid 16) in
    a fresh interpreter loads none of jax, orbax, imageio, h5py, cv2, PIL or
    dmnerf_tpu and writes both PLY files."""
    script = textwrap.dedent(f"""
        import json, os, sys
        import torch
        import dmnerf_torch.cli.test as cli
        from dmnerf_torch.models.convert import save_tar
        from dmnerf_torch.models.fields import FieldConfig, init_field_params

        cfg = FieldConfig(netdepth=2, netwidth=32, multires=2, multires_views=2, ins_num=4)
        g = torch.Generator().manual_seed(0)
        fields = [init_field_params(g, cfg) for _ in range(2)]
        ldir = os.path.join({str(tmp_path)!r}, "logs", "nj", "run")
        os.makedirs(ldir)
        save_tar(os.path.join(ldir, "000001.tar"), fields[0].state_dict(),
                 fields[1].state_dict(), 1)
        with open(os.path.join({str(tmp_path)!r}, "c.txt"), "w") as f:
            f.write("expname = nj\\nbasedir = {tmp_path / 'logs'}\\nlog_time = run\\n"
                    "datadir = ./data/synthetic/boxroom8x4\\nN_test = 64\\n"
                    "N_samples = 4\\nN_importance = 4\\nnear = 1.0\\nfar = 12.0\\n"
                    "netdepth = 2\\nnetwidth = 32\\nmultires = 2\\nmultires_views = 2\\n"
                    "mesh_grid_dim = 16\\nmesh_extents = 8,8,8\\n")
        savedir = cli.main(["--config", os.path.join({str(tmp_path)!r}, "c.txt"),
                            "--mesh", "--device", "cpu"])
        print(json.dumps({{
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "imageio",
                                                     "h5py", "cv2", "PIL", "dmnerf_tpu")),
            "plys": sorted(f for f in os.listdir(savedir) if f.endswith(".ply")),
        }}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"loaded": [], "plys": ["color_nj.ply", "nj.ply"]}


def test_every_port_module_and_the_scannet_preprocessing_load_no_jax(tmp_path):
    """A fresh interpreter imports every module of dmnerf_torch, writes a
    tiny raw ScanNet scene (chip_smoke.write_raw_scannet on the CPU: a .sens
    of JPEG frames, label PNGs, a TSV) and runs
    dmnerf_torch.data.scannet_preprocess.run on it; none of jax, orbax,
    imageio, h5py, cv2, PIL or dmnerf_tpu is loaded."""
    script = textwrap.dedent(f"""
        import glob, importlib, json, os, sys
        import chip_smoke as cs
        from dmnerf_torch.data.procedural import make_objects
        from dmnerf_torch.data.scannet_preprocess import run

        mods = sorted(os.path.relpath(p, {REPO!r})[:-3].replace(os.sep, ".").replace(
            ".__init__", "") for p in glob.glob(os.path.join({REPO!r}, "dmnerf_torch", "**",
                                                             "*.py"), recursive=True))
        for m in mods:
            importlib.import_module(m)
        cs.COLOR_HW, cs.DEPTH_HW, cs.SENS_FRAMES = (25, 34), (12, 17), 4
        root = {str(tmp_path)!r}
        tsv = cs.write_raw_scannet(root, "scene0001_00", make_objects(3, seed=1), "cpu",
                                   device="cpu")
        run.main(["--scans", os.path.join(root, "scans"), "--out", os.path.join(root, "out"),
                  "--label_map", tsv, "--save_dir", os.path.join(root, "scannet"),
                  "--frames", "2"])
        print(json.dumps({{
            "modules": len(mods),
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "orbax", "imageio",
                                                     "h5py", "cv2", "PIL", "dmnerf_tpu")),
            "split": os.path.exists(os.path.join(root, "scannet", "scene0001_00",
                                                 "train_split.txt")),
        }}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 60 and out["loaded"] == [] and out["split"]


# a fresh interpreter in which importing jax, jaxlib, orbax or dmnerf_tpu raises
BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    class Blocked(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbax", "dmnerf_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Blocked())
""")


def test_trace_step_reader_runs_with_jax_blocked():
    """python -m dmnerf_torch.tools.trace_step --parse_only on the committed
    fixture, with jax and dmnerf_tpu blocked."""
    fixture = os.path.join(REPO, "tests", "torch_golden", "trace")
    script = BLOCK + textwrap.dedent(f"""
        import runpy
        sys.argv = ["trace_step", "--parse_only", "--out", {fixture!r}, "--steps", "2"]
        runpy.run_module("dmnerf_torch.tools.trace_step", run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "device time 1.180 ms" in proc.stdout and "field_forward" in proc.stdout


def test_lpips_in_render_test_runs_with_jax_blocked(tmp_path):
    """load_lpips and render_test with --lpips_weights (random weights, a
    16x16 render on the CPU) with jax and dmnerf_tpu blocked: a finite LPIPS
    column."""
    script = BLOCK + textwrap.dedent(f"""
        import json, os
        import numpy as np
        import torch
        from dmnerf_torch.config import default_config
        from dmnerf_torch.data.synthetic import make_scene
        from dmnerf_torch.eval.lpips import load_lpips, random_weights
        from dmnerf_torch.eval.renderer import make_image_renderer
        from dmnerf_torch.eval.tester import render_test
        from dmnerf_torch.models.fields import FieldConfig, init_field_params

        weights = os.path.join({str(tmp_path)!r}, "lpips.npz")
        np.savez(weights, **random_weights(0))
        scene = make_scene(H=16, W=16, n_train=1, n_test=1)
        args = default_config(N_test=64, N_samples=4, N_importance=4, near=1.0, far=12.0,
                              netdepth=2, netwidth=32, multires=2, multires_views=2,
                              ins_num=scene.ins_num, lpips_weights=weights)
        cfg = FieldConfig.from_args(args)
        g = torch.Generator().manual_seed(0)
        params = {{"coarse": init_field_params(g, cfg), "fine": init_field_params(g, cfg)}}
        sel = scene.i_test
        out = render_test(make_image_renderer(cfg, args, 16, 16, device="cpu"), params,
                          scene.poses[sel], scene.hwk, args, gt_imgs=scene.images[sel],
                          gt_labels=scene.gt_labels[sel], ins_rgbs=scene.ins_rgbs,
                          savedir={str(tmp_path)!r})
        table = np.loadtxt(os.path.join({str(tmp_path)!r}, "test_results.txt"))
        print(json.dumps({{"lpips": table[:, 2].tolist(), "mean": out[2],
                          "metric": load_lpips(weights, device="cpu") is not None}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] and len(out["lpips"]) == 2
    assert all(0 < v < float("inf") for v in out["lpips"] + [out["mean"]])


def test_2d_mesh_runs_with_jax_blocked(tmp_path):
    """parallel/model_parallel.py, make_mesh_2d (a one-rank gloo group on the
    CPU), a train step on sharded fields, the .tar of that state and
    graft_entry.entry, with jax and dmnerf_tpu blocked."""
    script = BLOCK + textwrap.dedent(f"""
        import json, os
        import numpy as np
        os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[1])
        from dmnerf_torch.config import default_config
        from dmnerf_torch.data.synthetic import make_scene
        from dmnerf_torch.graft_entry import entry
        from dmnerf_torch.models.fields import FieldConfig
        from dmnerf_torch.parallel.mesh import close_mesh, make_mesh_2d
        from dmnerf_torch.parallel.model_parallel import ModelShardedField
        from dmnerf_torch.train.checkpoint import save_checkpoint
        from dmnerf_torch.train.step import (create_train_state, make_train_scan_step,
                                             scene_arrays)

        mesh = make_mesh_2d(1, 1, "cpu")
        scene = make_scene(H=8, W=8, n_train=1, n_test=1)
        args = default_config(N_train=16, N_samples=4, N_importance=4, near=1.0, far=12.0,
                              netdepth=2, netwidth=32, multires=2, multires_views=2,
                              ins_num=scene.ins_num)
        cfg = FieldConfig.from_args(args)
        state = create_train_state(0, cfg, mesh=mesh)
        m = make_train_scan_step(args, cfg, mesh=mesh)(state, scene_arrays(scene, "cpu"), 0,
                                                       np.asarray(scene.i_train), 1)
        tar = save_checkpoint({str(tmp_path)!r}, state, 1)
        forward, (params, ro, rd) = entry(device="cpu", n_rays=4)
        rgb = forward(params, ro, rd)[0]
        close_mesh(mesh)
        print(json.dumps({{"sharded": isinstance(state.params["fine"], ModelShardedField),
                          "loss": float(m["total_loss"]), "tar": os.path.exists(tar),
                          "rgb": list(rgb.shape)}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script, str(_free_port())], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["sharded"] and out["tar"] and out["rgb"] == [4, 3]
    assert out["loss"] == out["loss"] and abs(out["loss"]) < float("inf")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
