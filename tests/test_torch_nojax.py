"""The port imports neither jax, orbax, imageio, h5py, cv2, PIL nor anything
of the JAX package dmnerf_tpu: `import dmnerf_torch`, its edit modules, every
module of the port, a tiny CPU render, training run and mesh through its
CLIs, and ScanNet's preprocessing, in a fresh interpreter."""

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
