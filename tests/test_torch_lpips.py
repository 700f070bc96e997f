"""The port's LPIPS (dmnerf_torch/eval/lpips.py) against the JAX package's
(dmnerf_tpu/eval/lpips_jax.py) on the CPU, on random VGG16/LPIPS weights
from a numpy seed in the shared .npz layout; load_lpips's gating; and the
port's convert_lpips against tools/convert_lpips.py.

Tolerance 1e-5 relative: both sides run the same fp32 convolutions, pools
and sums, in another order."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmnerf_tpu.eval import lpips_jax as jl
from dmnerf_torch.eval import lpips as tl
from dmnerf_torch.tools import convert_lpips as tconv
from tools import convert_lpips as jconv

RTOL = 1e-5


def _pair(H, W, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_the_layout_constants_are_the_jax_packages():
    assert tl._VGG_CFG == jl._VGG_CFG and tl._TAPS == jl._TAPS
    np.testing.assert_array_equal(tl._SHIFT, jl._SHIFT)
    np.testing.assert_array_equal(tl._SCALE, jl._SCALE)


# 37x53: odd sides at every pool (floor mode drops the last row/column)
@pytest.mark.parametrize("hw", [(37, 53), (64, 64)])
@pytest.mark.parametrize("normalize", [False, True])
def test_lpips_distance_matches_jax(hw, normalize):
    w = tl.random_weights(0)
    a, b = _pair(*hw)
    want = float(jl.lpips_distance({k: jnp.asarray(v) for k, v in w.items()}, a, b,
                                   normalize=normalize))
    got = tl.lpips_distance(tl.prepare_params(w, "cpu"), torch.from_numpy(a),
                            torch.from_numpy(b), normalize=normalize)
    assert got.shape == () and got.dtype == torch.float32
    assert want > 0
    assert float(got) == pytest.approx(want, rel=RTOL, abs=0)


def test_identical_images_are_at_distance_zero():
    a, _ = _pair(32, 40)
    t = torch.from_numpy(a)
    assert float(tl.lpips_distance(tl.prepare_params(tl.random_weights(2), "cpu"), t, t)) == 0.0


def test_load_lpips_gating_and_metric(tmp_path):
    assert tl.load_lpips(None, device="cpu") is None
    assert tl.load_lpips("", device="cpu") is None
    assert tl.load_lpips(str(tmp_path / "missing.npz"), device="cpu") is None
    path = str(tmp_path / "w.npz")
    np.savez(path, **tl.random_weights(3))
    a, b = _pair(40, 48, seed=4)
    for normalize in (False, True):
        got = tl.load_lpips(path, normalize=normalize, device="cpu")(a, b)
        want = jl.load_lpips(path, normalize=normalize)(a, b)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=RTOL, abs=0)


_CHANS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]


def _state_dicts(rng, form):
    """Fabricated torch state dicts in the public checkpoints' layouts: the
    full lpips.LPIPS state dict ("full": net.slice{s}.{ti}.*, lins.{k}.*) or
    torchvision's features state dict plus the lin checkpoint ("split")."""
    vgg, lin, cin = {}, {}, 3
    for ci, ti in enumerate(jconv.VGG16_CONV_IDX):
        key = f"net.slice{1 + ci // 3}.{ti}" if form == "full" else f"{ti}"
        vgg[f"{key}.weight"] = torch.tensor(
            rng.normal(0, 0.08, (_CHANS[ci], cin, 3, 3)).astype(np.float32))
        vgg[f"{key}.bias"] = torch.tensor(rng.normal(0, 0.01, _CHANS[ci]).astype(np.float32))
        cin = _CHANS[ci]
    for k, c in enumerate(jconv.LIN_CHANNELS):
        key = f"lins.{k}" if form == "full" else f"lin{k}"
        # some negative entries: both converters clamp them to 0
        lin[f"{key}.model.1.weight"] = torch.tensor(
            rng.uniform(-0.02, 0.1, (1, c, 1, 1)).astype(np.float32))
    return vgg, lin


@pytest.mark.parametrize("form", ["full", "split"])
def test_convert_lpips_equals_the_jax_tool(form, tmp_path, monkeypatch):
    vgg, lin = _state_dicts(np.random.default_rng(5), form)
    if form == "full":
        full = str(tmp_path / "lpips_full.pth")
        torch.save({**vgg, **lin}, full)
        flags = ["--lpips", full]
    else:
        torch.save(vgg, str(tmp_path / "vgg.pth"))
        torch.save(lin, str(tmp_path / "lin.pth"))
        flags = ["--vgg", str(tmp_path / "vgg.pth"), "--lin", str(tmp_path / "lin.pth")]
    tconv.main(flags + ["--out", str(tmp_path / "torch.npz")])
    monkeypatch.setattr(sys, "argv", ["convert_lpips", *flags, "--out",
                                      str(tmp_path / "jax.npz")])
    jconv.main()
    with np.load(tmp_path / "torch.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 31
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert min(got[f"lin{k}_w"].min() for k in range(5)) == 0.0
    # the converted file loads in both packages and gives one distance
    a, b = _pair(33, 35, seed=6)
    got = tl.load_lpips(str(tmp_path / "torch.npz"), device="cpu")(a, b)
    assert got == pytest.approx(jl.load_lpips(str(tmp_path / "jax.npz"))(a, b), rel=RTOL)
