"""Weights carried across: the JAX param pytree and the reference `.tar`.

A field's JAX params are a pytree {"trunk": [{"w", "b"}, ...], "density",
"rgb_feat", "rgb_hidden", "rgb_out", "ins_feat", "ins_hidden", "ins_out"} with
w:[in, out]; a torch nn.Linear stores weight:[out, in]. state_dict_from_jax is
the mapping of tools/export_torch_ckpt.py::params_to_state_dict, on numpy
arrays, so this module needs no jax.

The `.tar` layout is the original DM-NeRF's (written by its train scripts and
by tools/export_torch_ckpt.py from any orbax checkpoint):
{iteration, network_coarse_state_dict, network_fine_state_dict,
optimizer_state_dict}. The port's trainer keeps its torch.optim.Adam
state_dict there (over the coarse, then the fine parameters), so a run
resumes from the file. train_state_from_jax carries a JAX TrainState (params
and optax Adam mu/nu/count) across into that form.

A train state under the 2-D mesh (parallel/model_parallel.py) holds each
rank's rows: train_state_dicts gathers the fields and Adam's moments over
the model group first, so it writes the file one rank would write, and
load_train_state_dicts takes this rank's rows of a whole file again.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

# JAX pytree key -> reference state_dict prefix
_HEAD_NAMES = {
    "density": "density_linear",
    "rgb_feat": "rgb_feature_linear",
    "rgb_hidden": "rgb_feature_linears.0",
    "rgb_out": "rgb_linear",
    "ins_feat": "ins_feature_linear",
    "ins_hidden": "ins_feature_linears.0",
    "ins_out": "ins_linear",
}


def state_dict_from_jax(field_params_np: Mapping) -> Dict[str, torch.Tensor]:
    """One field's JAX params (numpy leaves) -> the reference state_dict (fp32)."""
    sd = {}

    def put(prefix, layer):
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.asarray(layer["w"], dtype=np.float32).T.copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(layer["b"], dtype=np.float32).copy())

    for i, layer in enumerate(field_params_np["trunk"]):
        put(f"mlps.{i}", layer)
    for ours, theirs in _HEAD_NAMES.items():
        put(theirs, field_params_np[ours])
    return sd


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_tar(path: str, coarse_sd: Mapping[str, torch.Tensor],
             fine_sd: Mapping[str, torch.Tensor], iteration: int,
             optimizer_state: Optional[dict] = None) -> None:
    """Write the reference checkpoint layout; optimizer_state is a torch
    optimizer state_dict (empty when None: the test entries never read it)."""
    torch.save({
        "iteration": int(iteration),
        "network_coarse_state_dict": _to_cpu(dict(coarse_sd)),
        "network_fine_state_dict": _to_cpu(dict(fine_sd)),
        "optimizer_state_dict": _to_cpu(optimizer_state or {}),
    }, path)


def load_tar(path: str, with_optimizer: bool = False):
    """-> (coarse state_dict, fine state_dict, iteration), tensors on the CPU;
    with_optimizer adds the optimizer state_dict ({} when none was saved)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    out = (blob["network_coarse_state_dict"], blob["network_fine_state_dict"],
           int(blob["iteration"]))
    return out + (blob["optimizer_state_dict"],) if with_optimizer else out


def train_state_from_jax(params_np: Mapping, mu_np: Mapping, nu_np: Mapping, count: int,
                         cfg, lrate: float, lrate_decay_k: int):
    """A JAX TrainState as numpy -- params {"coarse", "fine"} and the optax
    Adam moments mu/nu (same pytrees) with its step count -- -> ({"coarse",
    "fine"} DMNeRFFields, a state_dict for the port's Adam over them, as
    train/schedule.make_optimizer builds it)."""
    from dmnerf_torch.models.fields import DMNeRFField
    from dmnerf_torch.train.schedule import make_optimizer

    fields = {}
    for key in ("coarse", "fine"):
        fields[key] = DMNeRFField(cfg)
        fields[key].load_state_dict(state_dict_from_jax(params_np[key]))
    opt, _ = make_optimizer(fields, lrate, lrate_decay_k, start_step=int(count))
    state, i = {}, 0
    for key in ("coarse", "fine"):
        mu, nu = state_dict_from_jax(mu_np[key]), state_dict_from_jax(nu_np[key])
        for name, _ in fields[key].named_parameters():
            state[i] = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
            i += 1
    sd = opt.state_dict()
    sd["state"] = state
    return fields, sd


def _shards(state):
    """(the state's ModelShardedFields in Adam's order, each parameter's
    split), or (None, None) for whole fields."""
    from dmnerf_torch.parallel.model_parallel import model_sharded

    if not model_sharded(state.params):
        return None, None
    fields = [state.params[k] for k in ("coarse", "fine")]
    return fields, [s for f in fields for s in f.splits()]


def train_state_dicts(state):
    """(coarse state_dict, fine state_dict, Adam state_dict) of a train
    state, whole: under the 2-D mesh the fields and Adam's moments are
    gathered over the model group (collective: every rank calls it)."""
    from dmnerf_torch.parallel.model_parallel import gather_params_model, gather_rows

    fields, splits = _shards(state)
    opt_sd = state.opt.state_dict()
    if fields is None:
        return state.params["coarse"].state_dict(), state.params["fine"].state_dict(), opt_sd
    whole = gather_params_model(state.params)
    mesh = fields[0].mesh
    opt_sd["state"] = {i: {k: gather_rows(v, splits[i], mesh) if k.startswith("exp_avg") else v
                           for k, v in st.items()} for i, st in opt_sd["state"].items()}
    return whole["coarse"].state_dict(), whole["fine"].state_dict(), opt_sd


def load_train_state_dicts(state, coarse_sd, fine_sd, opt_sd) -> None:
    """Whole state_dicts (as train_state_dicts gives them) into `state` in
    place; under the 2-D mesh each rank takes its rows of every split leaf
    and of its Adam moments. An empty opt_sd leaves Adam as it is."""
    from dmnerf_torch.parallel.model_parallel import take_rows

    fields, splits = _shards(state)
    sds = {"coarse": coarse_sd, "fine": fine_sd}
    if fields is None:
        for k, sd in sds.items():
            state.params[k].load_state_dict(sd)
    else:
        mesh = fields[0].mesh
        for k, f in zip(("coarse", "fine"), fields):
            f.load_state_dict({n: take_rows(sds[k][n], s, mesh) for (n, _), s in
                               zip(f.named_parameters(), f.splits())})
        if opt_sd:
            opt_sd = dict(opt_sd, state={
                i: {k: take_rows(v, splits[i], mesh) if k.startswith("exp_avg") else v
                    for k, v in st.items()} for i, st in opt_sd["state"].items()})
    if opt_sd:
        state.opt.load_state_dict(opt_sd)
