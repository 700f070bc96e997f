"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled, at first
use, into `build/kernels/lib<name>_<hash>.so` at the repo root, where the hash
covers the source and the flags: an edited source rebuilds, an unchanged one
loads what is there. The compiler's report (`-Xptxas -v`: registers, shared
memory, spills per kernel) is kept beside the library as `.log`.

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


def build(name: str) -> tuple[Path, float]:
    """Compile csrc/<name>.cu unless its library is current.
    Returns (library path, seconds spent compiling: 0.0 if it was current)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so, seconds


@functools.lru_cache(maxsize=None)
def load_render_field() -> ctypes.CDLL:
    """csrc/render_field.cu, built if needed, with its argument types set."""
    so, _ = build("render_field")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.render_field_sigma.argtypes = [p, p, p, i, i, p, p, p, i, p, p]
    lib.render_field_sigma.restype = i
    lib.render_field_all.argtypes = [p, p, p, p, i, i, p, p, p, i, p, p, p, p]
    lib.render_field_all.restype = i
    lib.render_field_error_string.argtypes = [i]
    lib.render_field_error_string.restype = ctypes.c_char_p
    return lib
