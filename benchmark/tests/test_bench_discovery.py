"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new entries are found by name, with no existing file of the
benchmark edited."""

import hashlib
import importlib.util
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "benchmark")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "dmsr_k32.json").read_text())
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps({**conf, "name": "dummy_cfg",
                                                               "ins_num": 8}))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps({"driver": "train", "why": "x",
                                                              "perturb": False,
                                                              "checked_steps": 2}))
    (b / "limits" / "dummy-cell.json").write_text(json.dumps({"change_gap": 0.5}))
    (b / "layer_metrics" / "dummy_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "dummy_cfg", "source": "x", "file":
                            "benchmark/configs/dummy_cfg.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("dummy-cell")
    spec["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "train_rays_per_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    mod_spec = importlib.util.spec_from_file_location("_tmp_harness", b / "harness.py")
    harness = importlib.util.module_from_spec(mod_spec)
    sys.modules["_tmp_harness"] = harness
    try:
        mod_spec.loader.exec_module(harness)
    finally:
        sys.modules.pop("_tmp_harness")
    cell = harness.load_cell("dummy-cell")
    assert cell.cfg["ins_num"] == 8 and cell.traffic["checked_steps"] == 2
    assert cell.limits == {"change_gap": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert harness.driver(cell.traffic).__file__ == str(b / "drivers" / "train.py")
    assert harness.per_layer_metrics(cell, {}) == {"dummy_metric": {"value": 42.0, "unit": "%"}}
    # the cells already there still find theirs, and no file was edited
    assert {m["name"] for m in harness.load_cell("dmsr-train").per_layer} >= {"train_mfu"}
    after = digests(b)
    assert {k: v for k, v in after.items() if k in before} == before
