"""Weights carried across: the JAX param pytree and the reference `.tar`.

A field's JAX params are a pytree {"trunk": [{"w", "b"}, ...], "density",
"rgb_feat", "rgb_hidden", "rgb_out", "ins_feat", "ins_hidden", "ins_out"} with
w:[in, out]; a torch nn.Linear stores weight:[out, in]. state_dict_from_jax is
the mapping of tools/export_torch_ckpt.py::params_to_state_dict, on numpy
arrays, so this module needs no jax.

The `.tar` layout is the original DM-NeRF's (written by its train scripts and
by tools/export_torch_ckpt.py from any orbax checkpoint):
{iteration, network_coarse_state_dict, network_fine_state_dict,
optimizer_state_dict}.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def save_tar(path: str, coarse_sd: Mapping[str, torch.Tensor],
             fine_sd: Mapping[str, torch.Tensor], iteration: int) -> None:
    """Write the reference checkpoint layout (optimizer state left empty: the
    test entries never read it)."""
    torch.save({
        "iteration": int(iteration),
        "network_coarse_state_dict": {k: v.detach().cpu() for k, v in coarse_sd.items()},
        "network_fine_state_dict": {k: v.detach().cpu() for k, v in fine_sd.items()},
        "optimizer_state_dict": {},
    }, path)


def load_tar(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
    """-> (coarse state_dict, fine state_dict, iteration), tensors on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return (blob["network_coarse_state_dict"], blob["network_fine_state_dict"],
            int(blob["iteration"]))
