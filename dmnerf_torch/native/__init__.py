# Copied from dmnerf_tpu/native/__init__.py (the .so is built into build/native/ at the repo root through a temporary name and an atomic rename, not into the package directory, and is named by a hash of its source; the docstring names the port's compute path and none of the source's host timings; require() adds the JPEG codec's build, which raises instead of falling back, and load() is require() with the fallback).
"""Native (C++) components, built lazily on first use.

The compute path stays PyTorch/CUDA; these are host-runtime accelerators
where the interpreter would serialize offline work (mesh isosurface extraction
at 256^3).
The marching module is optional: load() returns None and its callers fall
back to the numpy implementations if the toolchain is unavailable. The JPEG
codec (jpeg.cpp, utils/jpeg.py) has no fallback: require() raises a
RuntimeError that names g++ and its message.
Each library is named by a hash of its source's bytes, so a build copied
from elsewhere, or one left from an older source, is never taken for the
current one.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_cached = {}


def _so_path(name: str, source: str) -> str:
    """build/native/<name>_<sha256 of the source, 8 hex digits><suffix>."""
    with open(os.path.join(_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"{name}_{digest}{suffix}")


def _build(so: str, source: str):
    """Compile a single-file CPython extension with g++ unless `so` exists:
    None, or the error."""
    import numpy as np

    if os.path.exists(so):
        return None
    py_inc = sysconfig.get_paths()["include"]
    np_inc = np.get_include()
    # two processes may build at once: each writes its own file, and the
    # rename puts a whole library in place
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           f"-I{py_inc}", f"-I{np_inc}", os.path.join(_DIR, source), "-o", tmp]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, so)
        return None
    except Exception as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"{e}\n{getattr(e, 'stderr', '') or ''}".strip()


def require(name: str, source: str):
    """Import (building if needed) a native module, or raise a RuntimeError
    that names g++ and its message."""
    if _cached.get(name) is not None:
        return _cached[name]
    import importlib.util

    so = _so_path(name, source)
    err = _build(so, source)
    if err is not None:
        raise RuntimeError(f"building {source} with g++ failed: {err}")
    try:
        spec = importlib.util.spec_from_file_location(name, so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception as e:
        raise RuntimeError(f"importing {source}, built with g++ into {BUILD_DIR}, "
                           f"failed: {e}") from e
    _cached[name] = mod
    return mod


def load(name: str = "_marching_native", source: str = "marching.cpp"):
    """require(), or None (once written to stderr, then cached) on failure."""
    if name in _cached:
        return _cached[name]
    try:
        return require(name, source)
    except RuntimeError as e:
        sys.stderr.write(f"native load of {name} failed: {e}\n")
        _cached[name] = None
        return None
