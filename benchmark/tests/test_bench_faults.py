"""A run with the timed path broken underneath comes out not correct: the
look for a card is skipped and the rest of a run is driven at a toy size on
the CPU, with the cell's own limits, once for each fault a cell can have."""

import pytest
import torch

from bench_tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["dmsr-train", "replica-train"])
def test_a_step_that_leaves_its_state_unchanged(name, capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    rc, res, _ = run_tiny(tiny_cell(name), capsys)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["dmsr-train", "replica-train"])
def test_half_of_each_batch_left_out(name, capsys, monkeypatch):
    from dmnerf_torch.train import step

    select = step._select_pixels_full

    def first_half_twice(gen, H, W, n_train, device):
        pix = select(gen, H, W, n_train, device)
        half = pix[:n_train // 2]
        return torch.cat([half, half])          # the mean is over the first half's pixels

    monkeypatch.setattr(step, "_select_pixels_full", first_half_twice)
    rc, res, _ = run_tiny(tiny_cell(name), capsys)
    assert rc == 0 and res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", ["dmsr-render", "replica-render"])
def test_an_answer_altered_where_it_is_produced(name, capsys, monkeypatch):
    from dmnerf_torch.eval import renderer

    make = renderer.make_fused_chunk_renderer
    cell = tiny_cell(name)
    chunks = -(-int(cell.cfg["H"]) * int(cell.cfg["W"]) // int(cell.cfg["N_test"]))

    def broken(cfg, n_importance):
        chunk = make(cfg, n_importance)
        calls = [0]

        def render_chunk(*a):
            rgb, ins, depth = chunk(*a)
            if calls[0] % chunks == 0:          # each view's first chunk: labels moved on
                ins = torch.roll(ins, 1, dims=-1)
            calls[0] += 1
            return rgb, ins, depth
        return render_chunk

    monkeypatch.setattr(renderer, "make_fused_chunk_renderer", broken)
    rc, res, _ = run_tiny(cell, capsys)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["label_gap_p999"]["value"] > res["checks"]["label_gap_p999"]["limit"]


@pytest.mark.parametrize("name", ["dmsr-train", "dmsr-render"])
def test_the_same_run_unbroken_is_correct_in_f32(name, capsys):
    rc, res, _ = run_tiny(tiny_cell(name, precision="f32"), capsys)
    assert rc == 0 and res["correct"] is True
