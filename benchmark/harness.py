"""What every cell's run shares: the files that BENCHMARK.json names, the
program's arguments from a configuration, the weights from the seed, the
traced window, the per-layer readers, the checks and the result line."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent          # benchmark/
REPO = ROOT.parent
# top-level modules that no process of the benchmark may hold: JAX, and the
# JAX package with the repository's scripts built on it
FORBIDDEN = ("jax", "jaxlib", "flax", "dmnerf_tpu", "bench", "chip_smoke", "tools")


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict                  # the configuration file, as run
    traffic: dict              # the traffic file
    limits: dict               # {number: limit} of the comparison that decides correct
    per_layer: list            # the BENCHMARK.json entries of the per-layer metrics it reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json: its configuration, traffic and limits
    found by name, and the per-layer metrics whose `workloads` list it (or
    that have no such list and move an end-to-end metric it reports)."""
    spec = spec if spec is not None else load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m["name"] for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e else [])]
    return Cell(name, load_json(REPO / conf["file"]),
                load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
                load_json(ROOT / "limits" / f"{name}.json"), per_layer)


def driver(traffic: dict):
    """The module under drivers/ that runs this traffic's kind of work."""
    return _load(ROOT / "drivers" / f"{traffic['driver']}.py", f"_bench_driver_{traffic['driver']}")


def layer_reader(name: str) -> Callable:
    """read(ctx) of layer_metrics/<name>.py."""
    return _load(ROOT / "layer_metrics" / f"{name}.py", f"_bench_metric_{name}").read


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seeds(seed: int, n: int) -> list:
    """n independent 63-bit seeds from the run's seed."""
    return [int(s) >> 1 for s in np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)]


def program_args(cfg: dict, **extra):
    """The port's flags for a configuration."""
    from dmnerf_torch.config import default_config

    keys = ("N_train", "N_samples", "N_importance", "N_test", "near", "far", "tolerance",
            "deta_w", "lrate", "lrate_decay", "netdepth", "netwidth", "multires",
            "multires_views", "ins_num", "precision")
    return default_config(**{k: cfg[k] for k in keys}, penalize=bool(cfg["penalize"]),
                          **extra)


def field_config(args):
    from dmnerf_torch.models.fields import FieldConfig

    fc = FieldConfig.from_args(args)
    if fc.skip != 4:
        raise ValueError(f"the port's skip is {fc.skip}; the configurations state 4")
    return fc


def make_weights(cfg: dict, seed: int, device, surfaces: bool = False) -> dict:
    """{"coarse": {name: tensor}, "fine": {...}} of `seed`, made on the device
    (reference/field.py::make_weights). With `surfaces` (a trained scene
    served), each field's density head is set so that the density is
    positive in half of the ball between the near and far planes and its
    75th percentile there is 20 / (far - near): a ray meets surfaces and
    turns opaque within a few samples of them, as in a trained scene. The
    head's raw output of a random field has one sign almost everywhere,
    which renders nothing or only the first sample."""
    import torch

    from benchmark.reference.field import density, make_weights as one

    seeds = sub_seeds(seed, 3)
    out = {"coarse": one(cfg, seeds[0], device), "fine": one(cfg, seeds[1], device)}
    if not surfaces:
        return out
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds[2])
    r = 0.5 * (float(cfg["far"]) - float(cfg["near"]))
    u = torch.randn((65536, 3), generator=gen, device=device)
    rad = torch.rand((65536, 1), generator=gen, device=device) ** (1 / 3)
    pts = r * rad * u / torch.linalg.norm(u, dim=-1, keepdim=True)
    for w in out.values():
        with torch.no_grad():
            sigma = density(w, cfg, pts)
        q50, q75 = torch.quantile(sigma, 0.5), torch.quantile(sigma, 0.75)
        scale = 10.0 / r / torch.clamp(q75 - q50, min=1e-6)
        w["density_linear.weight"] = w["density_linear.weight"] * scale
        w["density_linear.bias"] = (w["density_linear.bias"] - q50) * scale
    return out


def check_card(chips: int) -> str:
    """The card's name; exits without a result when CUDA has fewer cards."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("error: CUDA is not available; this benchmark runs on an NVIDIA card")
    if torch.cuda.device_count() < chips:
        sys.exit(f"error: the cell asks for {chips} cards, CUDA has "
                 f"{torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def profiled(device):
    """torch.profiler over the block (host ops and the device's kernels);
    yields a dict that holds the Chrome trace once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out["trace"] = load_json(Path(path))


def timed_window(seconds: float, work: Callable[[], None], sync: Callable[[], None]):
    """Call work() until `seconds` have passed on the host clock, then wait
    for the device. Returns (calls, wall seconds)."""
    t0 = time.perf_counter()
    n = 0
    while True:
        work()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return n, time.perf_counter() - t0


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every compared number at or
    under its limit; a number that is not finite fails."""
    checks = {k: {"value": float(readings[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def per_layer_metrics(cell: Cell, ctx: dict) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose reader
    found something to read."""
    out = {}
    for m in cell.per_layer:
        v = layer_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def emit(result: dict, checks: dict) -> int:
    """Print each compared number beside its limit as the last lines on
    standard error, and the result as the last line on standard output with
    the checks under the last key. Refuses (exit 1, no result) where a
    forbidden module was loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
    return 0
