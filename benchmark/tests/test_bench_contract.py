"""BENCHMARK.json parses, keeps to the contract's names, units and keys, and
every file it names is where the harness looks for it."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (REPO / p).is_dir()
    for word in SPEC["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_just_their_keys(section, keys):
    for e in SPEC[section]:
        extra = set(e) - keys - ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert keys <= set(e) and not extra, (e["name"], extra)
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert TEXT.match(e[k])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_names_are_unique_and_references_resolve():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    configs = {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["traffic"])
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    assert {w["config"] for w in SPEC["workloads"]} == configs
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m.get("workloads", [])) <= cells
        assert (REPO / "benchmark" / "layer_metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in SPEC["per_layer"])


def test_config_files_hold_their_entries():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert conf["precision"] == "bf16" and conf["netwidth"] == 256


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
