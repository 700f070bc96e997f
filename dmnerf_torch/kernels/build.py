"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled, at first
use, into `build/kernels/lib<name>_<hash>.so` at the repo root, where the hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags: an edited
source rebuilds, an unchanged one loads what is there. The compiler's report
(`-Xptxas -v`: registers, shared memory, spills per kernel) is kept beside
the library as `.log`. `build_all` starts one nvcc per source at once.

Nothing is compiled at import time; this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    """build/kernels/lib<name>_<hash>.so for the current sources and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names) -> dict:
    """Compile every csrc/<name>.cu whose library is not current, one nvcc
    process per source, all started together.
    Returns {name: (library path, seconds spent compiling: 0.0 if current)}."""
    out, procs = {}, {}
    for name in names:
        so = library_path(name)
        if so.exists():
            out[name] = (so, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
        out[name] = (so, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> tuple[Path, float]:
    """Compile csrc/<name>.cu unless its library is current.
    Returns (library path, seconds spent compiling: 0.0 if it was current)."""
    return build_all([name])[name]


_P, _I = ctypes.c_void_p, ctypes.c_int
_K4 = [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P]
_K3 = [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P]
_K1 = [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P]
_K2 = [_P, _P, _I, _I, _P, _P, _P, _I, _P,
       _P, _I, _P, _I, _P, _P,
       _P, _I, _P, _I, _I,
       _P, _P, _P]
_K2W = [*_K2[:13], _P, _I, *_K2[13:]]         # and the ReLU masks' scratch
# argument types of each entry point of csrc/render_field.cu and csrc/field.cu
RENDER_FIELD_ENTRIES = {
    "render_field_sigma": _K4, "render_field_sigma_f32": _K4,
    "render_field_all": _K3, "render_field_all_f32": _K3,
    "render_field_ins": _K4, "render_field_ins_f32": _K4,
}
FIELD_ENTRIES = {
    "field_tile_rows": [], "field_tile_rows_f32": [], "field_scratch_widths": [_P, _I, _P, _P],
    "field_forward": _K1, "field_forward_f32": _K1,
    "field_backward": _K2, "field_backward_f32": _K2, "field_backward_wgmma": _K2W,
    "field_mask_words": [_P, _I],
}


def bind(so, entries: dict, error: str) -> ctypes.CDLL:
    """The library so with the argument types of each of its entries (all
    return an int) and of its error-string function `error`."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    err = getattr(lib, error)
    err.argtypes, err.restype = [_I], ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_render_field() -> ctypes.CDLL:
    """csrc/render_field.cu (K3, K4, K5 and their f32 builds), built if
    needed, with its argument types set."""
    return bind(build("render_field")[0], RENDER_FIELD_ENTRIES, "render_field_error_string")


@functools.lru_cache(maxsize=None)
def load_field() -> ctypes.CDLL:
    """csrc/field.cu (K1, K2 and their f32 builds), built if needed, with its
    argument types set."""
    return bind(build("field")[0], FIELD_ENTRIES, "field_error_string")
