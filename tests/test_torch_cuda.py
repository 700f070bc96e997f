"""The render kernels K3/K4 on an NVIDIA card against their plain versions.

Imports no jax, so the machine with the card runs it without the JAX package's
conftest:  python -m pytest --noconftest tests/test_torch_cuda.py -q
Without a card it skips.
"""

import numpy as np
import pytest
import torch

from dmnerf_torch.kernels import render_field as krf
from dmnerf_torch.models.fields import FieldConfig, init_field_params


def _rays(R, S, seed=3):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(R, 3)) * 0.1).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True) \
        * rng.uniform(0.8, 1.2, (R, 1)).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 6.0, (R, S)), -1).astype(np.float32)
    pts = ro[:, None, :] + rd[:, None, :] * z[:, :, None]
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True))[:, None, :]
    return [torch.from_numpy(np.array(x)).cuda() for x in (pts, vd, z, rd)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,ins_num,S", [(64, 11, 100), (256, 32, 192)])
def test_kernels_match_plain_versions_on_the_card(width, ins_num, S):
    """Both kernels vs their plain versions on the same card: bf16 operands
    and fp32 accumulation both ways (TF32 off), so only the summation order
    differs, which can flip a stored bf16 activation by one ulp (2^-8
    relative). Bound: 2e-2 abs per ray on any output (weights and rgb in
    [0,1], depth up to 6, logits of a few units), median error 1e-4. The last
    sample's distance is 1e10, so its alpha is a step in sign(sigma): a ray
    whose plain last-sample |sigma| < 0.05 may jump, and is exempt (at most
    2 of 64). S=100 leaves a partial 64-point tile in the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = FieldConfig(netdepth=8, netwidth=width, multires=10, multires_views=4,
                      ins_num=ins_num)
    field = init_field_params(torch.Generator().manual_seed(4), cfg, device="cuda")
    pts, vd, z, rd = _rays(64, S)
    krf.reset_launches()
    with torch.no_grad():
        pairs = [(krf.render_field_sigma(field, pts, z, rd),
                  krf.render_field_sigma_ref(field, pts, z, rd))]
        pairs += list(zip(krf.render_field_all(field, pts, vd, z, rd),
                          krf.render_field_all_ref(field, pts, vd, z, rd)))
        step = field.density(pts[:, -1])[..., 0].abs() < 0.05
    torch.cuda.synchronize()
    assert krf.LAUNCHES == {"render_field_sigma": 1, "render_field_all": 1}
    for got, want in pairs:
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got - want).abs()
        off = err.reshape(64, -1).amax(1) > 2e-2
        assert not (off & ~step).any() and off.sum() <= 2, (err.max(), off.sum())
        assert err.median() <= 1e-4, err.median()


@pytest.mark.cuda
def test_f32_precision_has_no_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = FieldConfig(netdepth=2, netwidth=32, multires=4, multires_views=2, ins_num=4,
                      compute_dtype=torch.float32)
    field = init_field_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    pts, vd, z, rd = _rays(4, 8)
    with pytest.raises(NotImplementedError):
        krf.render_field_sigma(field, pts, z, rd)
