"""One rank of the port's ray-mesh checks, and the same work on one process.

tests/test_torch_parallel.py (and, on the card, tests/test_torch_cuda.py)
start this file once per rank through run_ranks,

    python tests/torch_parallel_ranks.py JOB DIR [DEVICE [BACKEND]]

with torchrun's variables (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) set; each rank builds its DataMesh (default: the CPU over
gloo), or the Mesh2D of make_mesh_2d(*inputs["mesh2d"]) when the inputs
name one, runs JOB on DIR/inputs.pt and writes DIR/rank{r}.pt. The tests
call the same job functions with mesh=None for the one-rank reference.
Imports no jax.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dmnerf_torch.config import default_config  # noqa: E402
from dmnerf_torch.data.synthetic import make_scene, make_scene_crop  # noqa: E402
from dmnerf_torch.losses.instance import build_gt_onehot  # noqa: E402
from dmnerf_torch.models.fields import DMNeRFField, FieldConfig  # noqa: E402
from dmnerf_torch.parallel.mesh import (barrier, broadcast_object, close_mesh,  # noqa: E402
                                        make_mesh, make_mesh_2d, put_replicated, put_sharded)
from dmnerf_torch.train.schedule import make_optimizer  # noqa: E402
from dmnerf_torch.train.step import (TrainState, create_train_state,  # noqa: E402
                                     make_train_scan_step, make_train_step, scene_arrays,
                                     step_randomness)

NET = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)
GROUP_TIMEOUT = 120
DIST_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(**kw):
    """This process's environment without torchrun's variables, one thread
    per rank, and kw."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **{k: str(v) for k, v in kw.items()})
    return env


def run_ranks(job, world, tmp, inputs, *device_backend):
    """Start `world` ranks of this file on JOB; fail if any fails or the
    group outlives GROUP_TIMEOUT (every rank is killed then). Returns each
    rank's result."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(tmp), *device_backend],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=rank_env(WORLD_SIZE=world, RANK=r, LOCAL_RANK=r, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port)) for r in range(world)]
    try:
        outs = [p.communicate(timeout=GROUP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [(r, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, failed
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def one_process(job, inputs):
    """JOB with mesh=None in this process, on one thread as the ranks run
    (a CPU matmul's sums can depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return JOBS[job](None, inputs)
    finally:
        torch.set_num_threads(threads)


def tiny_args(**kw):
    """tests/test_torch_train.py::tiny_args (f32, penalizer on, perturb on)."""
    args = default_config(N_train=64, N_samples=8, N_importance=8, near=1.0, far=12.0,
                          perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05,
                          lrate=5e-3, lrate_decay=500, precision="f32", i_print=1000,
                          i_save=1000, i_test=0, seed=0, **NET)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _fields(cfg, sds):
    out = {}
    for key, sd in sds.items():
        out[key] = DMNeRFField(cfg)
        out[key].load_state_dict(sd)
    return out


def _params(state):
    return [p.detach().clone() for g in state.opt.param_groups for p in g["params"]]


def _moments(state):
    st = state.opt.state_dict()["state"]
    return [(st[i]["exp_avg"].clone(), st[i]["exp_avg_sq"].clone()) for i in sorted(st)]


def train_render_edit(mesh, inputs):
    """(a) one step, perturb off, from the given fields on all 64 pixels of
    an 8x8 view; (b) 3 steps, perturb and penalizer on, from seed 0 on a
    16x16 scene; (d) a render (fused and unfused) and a 2-object edit (rigid
    and deform; whole image and one chunk) with the given fields, and
    manipulator_eval through the runner; under a mesh also
    build_gt_onehot of each rank's rows of each set of inputs["gt_labels"]."""
    from dmnerf_torch.edit.manipulator import make_manipulator, make_pose_image_manipulator
    from dmnerf_torch.eval.renderer import (make_chunk_renderer, make_image_renderer,
                                            render_image)

    out = {}
    scene = make_scene(H=8, W=8, n_train=1, n_test=1)
    args = tiny_args(perturb=0.0, pallas_train=True)
    args.ins_num = scene.ins_num
    cfg = FieldConfig.from_args(args)
    fields = _fields(cfg, inputs["fields"])
    opt, sched = make_optimizer(fields, args.lrate, args.lrate_decay)
    state = TrainState(fields, opt, sched, 0)
    _, gen = step_randomness(0, 0, 1, "cpu")
    m = make_train_step(args, cfg, mesh=mesh)(state, scene_arrays(scene, "cpu"), gen, 0)
    out["a_metrics"] = {k: float(v) for k, v in m.items()}
    out["a_grads"] = [p.grad.clone() for g in opt.param_groups for p in g["params"]]
    out["a_params"] = _params(state)

    scene16 = make_scene(H=16, W=16, n_train=3, n_test=1)
    args_b = tiny_args()
    args_b.ins_num = scene16.ins_num
    cfg_b = FieldConfig.from_args(args_b)
    state = create_train_state(0, cfg_b, args_b.lrate, args_b.lrate_decay)
    scan = make_train_scan_step(args_b, cfg_b, mesh=mesh)
    arrs = scene_arrays(scene16, "cpu")
    out["b_steps"] = []
    for _ in range(3):
        m = scan(state, arrs, 7, np.asarray(scene16.i_train), 1)
        out["b_steps"].append({"metrics": {k: float(v) for k, v in m.items()},
                               "params": _params(state), "moments": _moments(state)})

    fields = _fields(cfg, inputs["fields"])
    K, pose = scene.K, scene.poses[0]
    r_args = tiny_args(N_test=32)
    out["render_fused"] = make_image_renderer(cfg, r_args, 8, 8, device="cpu",
                                              use_pallas=True, mesh=mesh)(fields, K, pose)
    out["render_unfused"] = make_image_renderer(cfg, r_args, 8, 8, device="cpu",
                                                mesh=mesh)(fields, K, pose)
    chunk = make_chunk_renderer(cfg, 8, 8, 1.0, 12.0, 32, device="cpu", mesh=mesh)
    out["render_chunks"] = render_image(chunk, fields, 8, 8, K, pose, 32, device="cpu")

    objs = [{"mode": "rigid"}, {"mode": "deform", "deform_func": "sin"}]
    tar_pose = np.asarray(pose, np.float64).copy()
    tar_pose[0, 3] += 0.2
    run = make_pose_image_manipulator(cfg, fields, r_args, objs, move_labels=[1, 2], H=8,
                                      W=8, K=K, device="cpu", use_pallas=True, mesh=mesh)
    out["edit"] = run(pose, np.stack([tar_pose, np.eye(4)]), np.asarray([0.0, 0.15]))
    g = torch.Generator().manual_seed(5)
    rays = [torch.randn(s, generator=g) for s in ((32, 3), (32, 3), (2, 32, 3), (2, 32, 3))]
    rays[1] = torch.nn.functional.normalize(rays[1], dim=-1)
    rays[3] = torch.nn.functional.normalize(rays[3], dim=-1)
    out["edit_chunk"] = make_manipulator(cfg, fields, r_args, 2, [1, 2], use_pallas=True,
                                         mesh=mesh)(*rays)
    out["mani_eval"] = _mani_eval(cfg, fields, scene, mesh)
    if mesh is not None:
        out["gt_onehot"] = {key: build_gt_onehot(labels[mesh.rows(len(labels))], key[1], mesh)
                            for key, labels in inputs.get("gt_labels", {}).items()}
        out["put_sharded"] = put_sharded(np.arange(12.0).reshape(6, 2), mesh)
        out["put_replicated"] = put_replicated(np.full(3, float(mesh.rank)), mesh)
        out["broadcast_object"] = broadcast_object(f"rank {mesh.rank}", mesh)
    return out


def _mani_eval(cfg, fields, scene, mesh):
    """edit/runner.manipulator_eval of both views (a 0.2 translation of
    label 1): (its return value, test_results.txt or None where this rank
    wrote nothing)."""
    import tempfile

    from dmnerf_torch.edit.runner import manipulator_eval

    args = tiny_args(N_test=32, target_label=1, use_pallas=True)
    args.ins_num = scene.ins_num
    move = np.eye(4)
    move[0, 3] = 0.2
    trans = {"transformations": [{"transformation": move.tolist(), "mode": "translation"}]}
    with tempfile.TemporaryDirectory() as tmp:
        res = manipulator_eval(cfg, fields, scene.poses, scene.hwk, trans, tmp, scene.ins_rgbs,
                               args, gt_rgbs=scene.images, gt_labels=scene.gt_labels,
                               device="cpu", mesh=mesh)
        table = os.path.join(tmp, "translation", "test_results.txt")
        return res, (open(table).read() if os.path.exists(table) else None)


def crop_step(mesh, inputs):
    """(c) one step of the crop sampler at N_train 40: its 12 labeled rays
    are the batch's last, rows 28-39, which at world size 4 span ranks 2
    (rows 28-29) and 3; ranks 0 and 1 hold none."""
    scene = make_scene_crop(H=16, W=16, n_train=2, n_test=1)
    args = tiny_args(N_train=40)
    args.ins_num = scene.ins_num
    cfg = FieldConfig.from_args(args)
    state = create_train_state(1, cfg, args.lrate, args.lrate_decay)
    scan = make_train_scan_step(args, cfg, sampler="crop", mesh=mesh)
    m = scan(state, scene_arrays(scene, "cpu"), 3, np.asarray(scene.i_train), 1)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": [p.grad.clone() for g in state.opt.param_groups for p in g["params"]],
            "params": _params(state)}


def card_step(mesh, inputs):
    """One train step through K1 and K2 on cuda:0 at a small width (the
    shapes of test_train_steps_run_through_the_kernels): the launches, the
    metrics, the gradients and the parameters."""
    from dmnerf_torch.kernels import field as kf

    dev = torch.device("cuda:0") if mesh is None else mesh.device
    scene = make_scene(H=16, W=16, n_train=2, n_test=1)
    args = default_config(N_train=256, N_samples=16, N_importance=16, near=1.0, far=12.0,
                          penalize=True, tolerance=0.05, deta_w=0.05, netdepth=8,
                          netwidth=64, multires=10, multires_views=4)
    args.ins_num = scene.ins_num
    cfg = FieldConfig.from_args(args)
    state = create_train_state(0, cfg, device=dev)
    kf.reset_launches()
    m = make_train_scan_step(args, cfg, mesh=mesh)(state, scene_arrays(scene, dev), 1,
                                                  np.asarray(scene.i_train), 1)
    torch.cuda.synchronize()
    return {"launches": dict(kf.LAUNCHES), "metrics": {k: float(v) for k, v in m.items()},
            "grads": [p.grad.cpu() for g in state.opt.param_groups for p in g["params"]],
            "params": [p.cpu() for p in _params(state)]}


def _whole(module, mesh, grads=False):
    """A field's parameters (or gradients) whole, in parameter order:
    gathered over the model group under a Mesh2D."""
    from dmnerf_torch.parallel.model_parallel import gather_rows

    ts = [p.grad if grads else p.detach() for p in module.parameters()]
    if mesh is None:
        return [t.clone() for t in ts]
    return [gather_rows(t, s, mesh) for t, s in zip(ts, module.splits())]


def model_parallel_work(mesh, inputs):
    """The 2-D mesh's checks on one rank of a Mesh2D (or, mesh None, one
    process with whole fields), from the fields in inputs: (b) the field's
    raw and gradients of sum(raw * w), plain and through the kernels'
    wrappers on gathered weights, at ins_num 4 and 5; (c) two steps, perturb
    off, on all 64 pixels of an 8x8 view, for pallas_train False and True:
    metrics, whole gradients of each step, whole parameters after, and this
    rank's leaf shapes; (f) the .tar of the plain run's state (rank 0
    writes it) and a fresh 2-D state restored from it; (d) a render, fused
    and plain, and a two-object edit; and create_train_state's whole
    weights."""
    from dmnerf_torch.edit.manipulator import make_pose_image_manipulator
    from dmnerf_torch.eval.renderer import make_image_renderer
    from dmnerf_torch.kernels.field import make_trainable_pallas_field
    from dmnerf_torch.parallel.model_parallel import shard_params_model
    from dmnerf_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    def sharded(fields):
        return fields if mesh is None else shard_params_model(fields, mesh)

    out = {}
    scene = make_scene(H=8, W=8, n_train=1, n_test=1)
    for ins_num, sds in inputs["field_cases"].items():
        cfg = FieldConfig.from_args(tiny_args(ins_num=ins_num))
        for path in ("plain", "kernel"):
            field = sharded(_fields(cfg, sds))["coarse"]
            if path == "plain":
                raw = field(inputs["pts"], inputs["vd"])
            else:
                raw = make_trainable_pallas_field(cfg)(
                    field if mesh is None else field.gathered(), inputs["pts"], inputs["vd"])
            (raw * inputs["w"][..., :raw.shape[-1]]).sum().backward()
            out[f"field_{ins_num}_{path}"] = (raw.detach(), _whole(field, mesh, grads=True))

    args = tiny_args(perturb=0.0)
    args.ins_num = scene.ins_num
    cfg = FieldConfig.from_args(args)
    arrs = scene_arrays(scene, "cpu")
    for pallas in (False, True):
        args.pallas_train = pallas
        fields = sharded(_fields(cfg, inputs["fields"]))
        opt, sched = make_optimizer(fields, args.lrate, args.lrate_decay)
        state = TrainState(fields, opt, sched, 0)
        step = make_train_step(args, cfg, mesh=mesh)
        steps = []
        for i in range(2):
            _, gen = step_randomness(0, i, 1, "cpu")
            m = step(state, arrs, gen, 0)
            steps.append({"metrics": {k: float(v) for k, v in m.items()},
                          "grads": [g for k in ("coarse", "fine")
                                    for g in _whole(fields[k], mesh, grads=True)]})
        out[f"steps_{pallas}"] = {
            "steps": steps, "params": [t for k in ("coarse", "fine")
                                       for t in _whole(fields[k], mesh)],
            "local_params": _params(state), "local_moments": _moments(state),
            "shapes": [tuple(p.shape) for k in ("coarse", "fine")
                       for p in fields[k].parameters()]}
        if not pallas:
            tar_dir = os.path.join(inputs["dir"], "one" if mesh is None else "grid")
            os.makedirs(tar_dir, exist_ok=True)
            path = save_checkpoint(tar_dir, state, 2)
            barrier(mesh)
            fresh = create_train_state(9, cfg, args.lrate, args.lrate_decay, mesh=mesh)
            restore_checkpoint(path, fresh, args.lrate, args.lrate_decay)
            out["tar"] = path
            out["reloaded"] = {"params": _params(fresh), "moments": _moments(fresh),
                               "step": fresh.step}

    st = create_train_state(3, cfg, args.lrate, args.lrate_decay, mesh=mesh)
    out["created"] = [t for k in ("coarse", "fine") for t in _whole(st.params[k], mesh)]

    fields = sharded(_fields(cfg, inputs["fields"]))
    K, pose = scene.K, scene.poses[0]
    r_args = tiny_args(N_test=32)
    for name, pallas in (("render_fused", True), ("render_plain", False)):
        out[name] = make_image_renderer(cfg, r_args, 8, 8, device="cpu", use_pallas=pallas,
                                        mesh=mesh)(fields, K, pose)
    objs = [{"mode": "rigid"}, {"mode": "deform", "deform_func": "sin"}]
    tar_pose = np.asarray(pose, np.float64).copy()
    tar_pose[0, 3] += 0.2
    run = make_pose_image_manipulator(cfg, fields, r_args, objs, move_labels=[1, 2], H=8,
                                      W=8, K=K, device="cpu", use_pallas=True, mesh=mesh)
    out["edit"] = run(pose, np.stack([tar_pose, np.eye(4)]), np.asarray([0.0, 0.15]))
    return out


JOBS = {"train_render_edit": train_render_edit, "crop_step": crop_step,
        "card_step": card_step, "model_parallel_work": model_parallel_work}


def main(job: str, out_dir: str, device: str = "cpu", backend: str = None) -> int:
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    if isinstance(inputs, dict) and "mesh2d" in inputs:
        mesh = make_mesh_2d(*inputs["mesh2d"], device, backend)
    else:
        mesh = make_mesh(0, device, backend)
    result = JOBS[job](mesh, inputs)
    torch.save(result, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    close_mesh(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
