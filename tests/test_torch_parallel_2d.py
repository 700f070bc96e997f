"""The port's 2-D (data, model) mesh (dmnerf_torch/parallel/mesh.py::
make_mesh_2d, parallel/model_parallel.py) on the CPU over gloo: ranks of
tests/torch_parallel_ranks.py's model_parallel_work at (2, 2), (1, 2) and
(1, 1), each group under a 120 s timeout, against one process of the port
and against the JAX package's shard_params_model, apply_field, train step
and renderer under its own make_mesh_2d; the split rule, the layout of the
ranks, the world-size check, and dryrun_multichip(4) under torchrun."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.data.synthetic import make_scene as jax_make_scene
from dmnerf_tpu.eval.renderer import make_image_renderer as jax_image_renderer
from dmnerf_tpu.models import fields as jf
from dmnerf_tpu.parallel import mesh as jmesh
from dmnerf_tpu.train.step import TrainState as JaxTrainState
from dmnerf_tpu.train.step import make_optimizer as jax_make_optimizer
from dmnerf_tpu.train.step import make_train_step as jax_make_train_step
from dmnerf_torch.models import fields as tf
from dmnerf_torch.models.convert import _HEAD_NAMES, load_tar, state_dict_from_jax
from dmnerf_torch.parallel import mesh as pm
from dmnerf_torch.parallel import model_parallel as mp

import torch_parallel_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INS_CASES = (4, 5)          # instance heads of 5 (replicated at m=2) and 6 (split) columns


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_fields(cfg_j, seed):
    return {k: jf.init_field_params(jax.random.PRNGKey(seed + i), cfg_j)
            for i, k in enumerate(("coarse", "fine"))}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX fields and inputs of model_parallel_work, its runs at (2, 2),
    (1, 2) and (1, 1), and its one-process reference."""
    args = ranks.tiny_args(perturb=0.0)
    args.ins_num = ranks.make_scene(H=8, W=8, n_train=1, n_test=1).ins_num
    cfg_j = jf.FieldConfig.from_args(args)
    pj = _jax_fields(cfg_j, 0)
    cases_j = {n: _jax_fields(jf.FieldConfig.from_args(ranks.tiny_args(ins_num=n)), 10 * n)
               for n in INS_CASES}
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(6, 5, 3)).astype(np.float32)
    vd = rng.normal(size=(6, 1, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    w = rng.normal(size=(6, 5, max(INS_CASES) + 5)).astype(np.float32)
    base = {"fields": {k: state_dict_from_jax(_np(v)) for k, v in pj.items()},
            "field_cases": {n: {k: state_dict_from_jax(_np(v)) for k, v in c.items()}
                            for n, c in cases_j.items()},
            "pts": torch.from_numpy(pts), "vd": torch.from_numpy(vd), "w": torch.from_numpy(w)}
    got = {}
    for shape in ((2, 2), (1, 2), (1, 1)):
        tmp = tmp_path_factory.mktemp(f"grid{shape[0]}x{shape[1]}")
        got[shape] = ranks.run_ranks("model_parallel_work", shape[0] * shape[1], tmp,
                                     dict(base, mesh2d=shape, dir=str(tmp)))
    ref_dir = tmp_path_factory.mktemp("one")
    ref = ranks.one_process("model_parallel_work", dict(base, dir=str(ref_dir)))
    return {"got": got, "ref": ref, "args": args, "cfg_j": cfg_j, "pj": pj,
            "cases_j": cases_j, "pts": pts, "vd": vd, "w": w}


def _jax_specs(ins_num):
    """{torch parameter name: the PartitionSpec tuple that JAX's own
    shard_params_model gives the leaf under jit at make_mesh_2d(2, 2)}."""
    cfg_j = jf.FieldConfig.from_args(ranks.tiny_args(ins_num=ins_num))
    params = jf.init_field_params(jax.random.PRNGKey(0), cfg_j)
    mesh = jmesh.make_mesh_2d(2, 2)
    out = jax.jit(lambda p: jmesh.shard_params_model(p, mesh))(params)
    specs = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(out):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        prefix = f"mlps.{keys[1]}" if keys[0] == "trunk" else _HEAD_NAMES[keys[0]]
        spec = list(leaf.sharding.spec)
        while spec and spec[-1] is None:
            spec.pop()
        specs[f"{prefix}.{'weight' if keys[-1] == 'w' else 'bias'}"] = (tuple(spec),
                                                                         leaf.shape)
    return specs


@pytest.mark.parametrize("ins_num", INS_CASES)
def test_model_spec_matches_jax_shard_params_model(ins_num):
    """(a) model_spec on every leaf's reference shape equals the spec JAX's
    own shard_params_model gives it at make_mesh_2d(2, 2); the port's
    shard_params_model holds, on each of the two model ranks, half of the
    rows of exactly those leaves (the two halves are the whole leaf) and the
    whole of every other; the instance head splits at ins_num 5 only."""
    specs = _jax_specs(ins_num)
    cfg = tf.FieldConfig.from_args(ranks.tiny_args(ins_num=ins_num))
    whole = tf.init_field_params(torch.Generator().manual_seed(0), cfg)
    shards = [mp.shard_params_model({"c": whole}, pm.Mesh2D(r, 2, 2, torch.device("cpu"),
                                                             None, None))["c"]
              for r in range(2)]
    assert set(specs) == set(tf.param_names(cfg))
    for (name, p), a, b in zip(whole.named_parameters(), *(s.parameters() for s in shards)):
        spec, shape = specs[name]
        assert mp.model_spec(shape, 2) == spec, name
        split = "model" in spec
        assert tuple(a.shape) == ((p.shape[0] // 2,) + tuple(p.shape[1:]) if split
                                  else tuple(p.shape)), name
        assert torch.equal(torch.cat([a, b]) if split else a, p.detach()), name
    assert ("model" in specs["ins_linear.weight"][0]) == ((ins_num + 1) % 2 == 0)


@pytest.mark.parametrize("rank", range(4))
def test_ranks_are_laid_out_row_major(rank):
    """Rank r of a (2, 2) mesh is data index r // 2 and model index r % 2,
    as JAX's reshape(data, model) lays the devices out."""
    m = pm.Mesh2D(rank, 2, 2, torch.device("cpu"), None, None)
    assert (m.data_axis.rank, m.data_axis.size) == (rank // 2, 2)
    assert (m.model_axis.rank, m.model_axis.size) == (rank % 2, 2)
    assert pm.data_axis(m) == m.data_axis and pm.data_axis(None) is None


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("ins_num", INS_CASES)
def test_sharded_field_matches_jax_and_one_rank(setup, shape, path, ins_num):
    """(b) ModelShardedField (plain: column-parallel products) and the
    kernels' wrappers on weights gathered from it (kernel), on every rank:
    raw within 1e-5 of JAX apply_field and gradients of sum(raw * w) within
    1e-4 relative L2 of jax.grad (f32; the bars absorb the order of fp32
    sums in XLA's products against torch's), and within 1e-6 relative L2 of
    the port's one rank (the partial input gradients summed over the model
    group in another order)."""
    cfg_j = jf.FieldConfig.from_args(ranks.tiny_args(ins_num=ins_num))
    pj = setup["cases_j"][ins_num]["coarse"]
    pts, vd = jnp.asarray(setup["pts"]), jnp.asarray(setup["vd"])
    w = jnp.asarray(setup["w"][..., :ins_num + 5])
    raw_j = np.asarray(jf.apply_field(pj, cfg_j, pts, vd))
    g_j = state_dict_from_jax(_np(jax.grad(
        lambda p: jnp.sum(jf.apply_field(p, cfg_j, pts, vd) * w))(pj)))
    names = tf.param_names(tf.FieldConfig.from_args(ranks.tiny_args(ins_num=ins_num)))
    ref_raw, ref_g = setup["ref"][f"field_{ins_num}_{path}"]
    for r in setup["got"][shape]:
        raw, grads = r[f"field_{ins_num}_{path}"]
        np.testing.assert_allclose(raw.numpy(), raw_j, rtol=0, atol=1e-5)
        for name, g, g1 in zip(names, grads, ref_g):
            assert _rel(g, g_j[name]) <= 1e-4, (name, _rel(g, g_j[name]))
            assert _rel(g, g1) <= 1e-6, (name, _rel(g, g1))


def _jax_two_steps(setup, pallas):
    args = ranks.tiny_args(perturb=0.0, pallas_train=pallas)
    args.ins_num = setup["args"].ins_num
    cfg_j = jf.FieldConfig.from_args(args)
    mesh = jmesh.make_mesh_2d(2, 2)
    scene = jax_make_scene(H=8, W=8, n_train=1, n_test=1)
    tx = jax_make_optimizer(args.lrate, args.lrate_decay)
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), setup["pj"])  # the step donates
    state = JaxTrainState(params, tx.init(params), jnp.int32(0))
    step = jax_make_train_step(args, cfg_j, mesh=mesh)
    arrs = scene.to_device_arrays(mesh)
    out = []
    for i in range(2):
        state, m = step(state, arrs, jax.random.PRNGKey(i + 1), jnp.int32(0))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("pallas", [False, True])
def test_two_steps_match_jax_step_on_its_2d_mesh(setup, pallas):
    """(c) Two steps at (2, 2), perturb off, on all 64 pixels of an 8x8
    view (the port's and JAX's pixel orders differ; every loss is a mean or
    a matching over the whole set): the losses of both steps within rtol
    2e-3 of the JAX step under make_mesh_2d(2, 2) on the same pallas_train
    path (tests/test_train_smoke.py's bar for a 2-D mesh against one
    device), on every rank."""
    want = _jax_two_steps(setup, pallas)
    for r in setup["got"][(2, 2)]:
        for got_m, want_m in zip(r[f"steps_{pallas}"]["steps"], want):
            for k in ("total_loss", "rgb_loss", "ins_loss"):
                np.testing.assert_allclose(got_m["metrics"][k], want_m[k], rtol=2e-3,
                                           err_msg=k)


@pytest.mark.parametrize("pallas", [False, True])
def test_first_step_gradients_match_one_rank(setup, pallas):
    """(c) The first step's gradients at (2, 2), gathered whole, within 1e-4
    relative L2 of one rank's (a double count over the model group would be
    a factor of 2, a missing copy-in sum ~50%), and the first step's losses
    within 1e-6 relative; the second step's too, and the parameters after
    two steps within Adam's scale, 5e-3 (lr 5e-3: an update near a zero
    gradient is +-lr whatever the sum order gives it)."""
    ref = setup["ref"][f"steps_{pallas}"]
    for r in setup["got"][(2, 2)]:
        got = r[f"steps_{pallas}"]
        for s in range(2):
            for k, v in ref["steps"][s]["metrics"].items():
                np.testing.assert_allclose(got["steps"][s]["metrics"][k], v, rtol=1e-6)
        errs = [_rel(a, b) for a, b in zip(got["steps"][0]["grads"], ref["steps"][0]["grads"])]
        assert max(errs) <= 1e-4, errs
        worst = max(float((a - b).abs().max()) for a, b in zip(got["params"], ref["params"]))
        assert worst <= 5e-3, worst


def test_each_rank_holds_its_rows_and_adam_shards(setup):
    """Under (2, 2) each rank's parameters and Adam moments are its rows of
    the split leaves and the whole replicated ones (the heads: density,
    rgb, and the 5-column instance head); the model ranks of a data row hold
    different rows, the data ranks of a model index the same."""
    cfg = tf.FieldConfig.from_args(setup["args"])
    whole = [tuple(p.shape) for _ in range(2) for p in tf.DMNeRFField(cfg).parameters()]
    got = setup["got"][(2, 2)]
    names = [n for _ in range(2) for n in tf.param_names(cfg)]
    for r, g in enumerate(got):
        st = g["steps_False"]
        for name, shape, want, (m1, _) in zip(names, st["shapes"], whole, st["local_moments"]):
            split = mp.is_split(want, 2)
            assert shape == ((want[0] // 2,) + want[1:] if split else want), name
            assert tuple(m1.shape) == shape, name
            assert split != name.startswith(("density", "rgb_linear", "ins_linear")), name
    for a, b in zip(got[0]["steps_False"]["local_params"], got[2]["steps_False"]["local_params"]):
        assert torch.equal(a, b)


def test_render_and_edit_match_one_rank(setup):
    """(d) At (2, 2), on every rank: the fused and the plain render of an
    8x8 view and a two-object edit (rigid + sin deform) from sharded fields,
    against one rank with the whole fields: rgb, conf and depth within 1e-5,
    labels equal (the dry run's bars)."""
    for r in setup["got"][(2, 2)]:
        for key in ("render_fused", "render_plain", "edit"):
            for a, b in zip(r[key], setup["ref"][key]):
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape and a.dtype == b.dtype, key
                if np.issubdtype(a.dtype, np.integer):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)


def test_render_matches_jax_fused_renderer_on_its_2d_mesh(setup):
    """(d) The port's fused render at (2, 2) against JAX make_image_renderer
    (..., mesh=make_mesh_2d(4, 2), fused=True) on the same fields, at
    tests/test_render_field.py's bars for that renderer against the plain
    XLA path: rgb 5e-3, labels exact, conf 5e-3, depth 5e-2 absolute, 6e-3
    relative."""
    args = ranks.tiny_args(N_test=32)
    args.ins_num = setup["args"].ins_num
    scene = ranks.make_scene(H=8, W=8, n_train=1, n_test=1)
    want = jax_image_renderer(setup["cfg_j"], args, 8, 8, mesh=jmesh.make_mesh_2d(4, 2),
                              fused=True)(setup["pj"], scene.K, scene.poses[0])
    for r in setup["got"][(2, 2)]:
        for g, w, tol in zip(r["render_fused"], want, (5e-3, 0, 5e-3, 5e-2)):
            np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=6e-3)


def test_one_by_one_mesh_equals_no_mesh_bit_for_bit(setup):
    """(e) make_mesh_2d(1, 1) (real gloo groups of one rank) gives mesh=None's
    numbers bit for bit: the field and its gradients, both training paths,
    the render, the edit and create_train_state."""
    (got,) = setup["got"][(1, 1)]
    ref = setup["ref"]
    for key in [f"field_{n}_{p}" for n in INS_CASES for p in ("plain", "kernel")]:
        assert torch.equal(got[key][0], ref[key][0]), key
        assert all(torch.equal(a, b) for a, b in zip(got[key][1], ref[key][1])), key
    for pallas in (False, True):
        g, w = got[f"steps_{pallas}"], ref[f"steps_{pallas}"]
        assert [s["metrics"] for s in g["steps"]] == [s["metrics"] for s in w["steps"]]
        for a, b in zip(g["steps"][0]["grads"] + g["params"], w["steps"][0]["grads"] + w["params"]):
            assert torch.equal(a, b), pallas
    for key in ("render_fused", "render_plain", "edit"):
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(got[key], ref[key])), key
    assert all(torch.equal(a, b) for a, b in zip(got["created"], ref["created"]))


def test_create_train_state_2d_holds_one_rank_weights(setup):
    """create_train_state(seed, mesh=Mesh2D) builds the whole fields on every
    rank and keeps its rows: gathered, they are the one-rank weights bit for
    bit."""
    for shape in ((2, 2), (1, 2)):
        for r in setup["got"][shape]:
            assert all(torch.equal(a, b) for a, b in zip(r["created"], setup["ref"]["created"]))


def test_checkpoint_of_a_2d_state_is_whole_and_reloads(setup):
    """(f) The reference .tar written from a (2, 2) state (rank 0 writes)
    holds the whole fields and Adam moments: each split leaf the two model
    ranks' rows joined, bit for bit, in the layout one rank writes; loading
    it into a fresh (2, 2) state re-shards it to the same rows and moments
    bit for bit, at the same step."""
    got = setup["got"][(2, 2)]
    cfg = tf.FieldConfig.from_args(setup["args"])
    coarse, fine, it, opt = load_tar(got[0]["tar"], with_optimizer=True)
    one = load_tar(setup["ref"]["tar"], with_optimizer=True)
    assert it == 2 and set(coarse) == set(one[0]) and set(opt["state"]) == set(one[3]["state"])
    names = [(sd, n) for sd in (coarse, fine) for n in tf.param_names(cfg)]
    st0, st1 = got[0]["steps_False"], got[1]["steps_False"]
    for i, (sd, name) in enumerate(names):
        split = mp.is_split(sd[name].shape, 2)
        join = (lambda a, b: torch.cat([a, b])) if split else (lambda a, b: a)
        assert torch.equal(sd[name], join(st0["local_params"][i], st1["local_params"][i])), name
        for j, key in enumerate(("exp_avg", "exp_avg_sq")):
            assert torch.equal(opt["state"][i][key], join(st0["local_moments"][i][j],
                                                          st1["local_moments"][i][j])), name
    for r in got:
        rl, st = r["reloaded"], r["steps_False"]
        assert rl["step"] == 2
        assert all(torch.equal(a, b) for a, b in zip(rl["params"], st["local_params"]))
        assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(rl["moments"], st["local_moments"]))


@pytest.mark.parametrize("data, model", [(3, 2), (1, 2), (8, 1)])
def test_make_mesh_2d_raises_unless_the_world_size(monkeypatch, data, model):
    """(g) data * model other than the world size raises, naming all three
    numbers, before any process group is made."""
    import torch.distributed as dist

    for k, v in dict(WORLD_SIZE=4, RANK=0, LOCAL_RANK=0, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=ranks.free_port()).items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(ValueError, match=f"data {data} x model {model} does not match the "
                                         f"world size 4"):
        pm.make_mesh_2d(data, model, "cpu")
    assert not dist.is_initialized()


def test_dryrun_multichip_four_ranks_under_torchrun():
    """(h) `torch.distributed.run --nproc_per_node 4 -m dmnerf_torch.graft_entry
    4 --device cpu`: the (2, 2) mesh runs the flagship model's three paths
    with their asserts (train finite after 8 steps; render and two-object
    edit equal to one rank, 1e-5, labels exact), and rank 0 prints each."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "4", "-m", "dmnerf_torch.graft_entry", "4", "--device", "cpu"],
        cwd=REPO, env=ranks.rank_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("dryrun_multichip(4)")]
    assert [l.split(":", 1)[1].split(",")[0].strip() for l in lines] == [
        "train ok", "sharded eval render == single-device",
        "sharded 2-object (rigid+deform) edit == single-device", "ok"], proc.stdout


def test_entry_forward_on_the_cpu():
    """entry(device="cpu") runs the flagship coarse -> fine forward (the
    kernels' plain versions on the CPU): finite outputs of the right shapes
    at 16 rays."""
    from dmnerf_torch.graft_entry import entry

    forward, (params, ro, rd) = entry(device="cpu", n_rays=16)
    rgb, ins, depth = forward(params, ro, rd)
    assert rgb.shape == (16, 3) and ins.shape == (16, 32) and depth.shape == (16,)
    assert all(bool(torch.isfinite(t).all()) for t in (rgb, ins, depth))
