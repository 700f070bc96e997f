"""The benchmark's work counts at the flagship shapes: the arithmetic of the
DM-NeRF field (8x256, PE 10/4, skip after layer 4), K2 as dX + dW with no
forward recompute."""

import json
from pathlib import Path

import pytest

from benchmark import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name,macs", [("dmsr_k32", 695_936), ("replica_k64", 700_032)])
def test_forward_macs_per_point(name, macs):
    assert counts.forward_macs(cfg(name)) == macs


def test_trunk_and_density_macs():
    # 63x256 + 7 x 256x256 + the skip layer's 63 more inputs x 256 + 256
    assert counts.trunk_macs(cfg("dmsr_k32")) == 63 * 256 + 7 * 256 * 256 + 63 * 256 + 256


def test_backward_is_dx_plus_dw_without_the_recompute():
    c = cfg("dmsr_k32")
    fwd = counts.forward_macs(c)
    dx = counts.backward_dx_macs(c)
    # heads back to their hidden layers, hidden layers back to the features,
    # density and rgb feature layers back into the trunk, trunk layers 1..7
    assert dx == (128 * 33 + 128 * 3) + 256 * 128 + 256 * 128 + 256 + 256 * 256 + 7 * 256 * 256
    assert counts.backward_macs(c) == dx + fwd == 1_290_624
    # at most twice the forward: no forward recompute is counted
    assert counts.backward_macs(c) < 2 * fwd


def test_step_and_view_flops():
    c = cfg("dmsr_k32")
    assert counts.points_per_step(c) == 3072 * (64 + 64 + 128)
    assert counts.train_model_flops_per_step(c) == pytest.approx(3.284e12, rel=1e-3)
    assert counts.render_flops_per_view(c) == pytest.approx(1.014e14, rel=1e-3)


def test_least_time_names_its_bound():
    assert counts.least_time_s(989e12, 1.0) == (1.0, "operations")
    assert counts.least_time_s(1.0, 3.35e12) == (1.0, "bytes")
    assert counts.roofline_share(0.0, 1.0, 1.0) is None
