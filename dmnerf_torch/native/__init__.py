# Copied from dmnerf_tpu/native/__init__.py (the .so is built into build/native/ at the repo root through a temporary name and an atomic rename, not into the package directory; the docstring names the port's compute path and none of the source's host timings).
"""Native (C++) components, built lazily on first use.

The compute path stays PyTorch/CUDA; these are host-runtime accelerators
where the interpreter would serialize offline work (mesh isosurface extraction
at 256^3).
Everything here is optional: callers fall back to the numpy implementations if
the toolchain is unavailable.
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_cached = {}


def _so_path(name: str) -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, name + suffix)


def _build(name: str, source: str) -> bool:
    """Compile a single-file CPython extension with g++."""
    import numpy as np

    so = _so_path(name)
    src = os.path.join(_DIR, source)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return True
    py_inc = sysconfig.get_paths()["include"]
    np_inc = np.get_include()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # two processes may build at once: each writes its own file, and the
    # rename puts a whole library in place
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           f"-I{py_inc}", f"-I{np_inc}", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except Exception as e:
        sys.stderr.write(f"native build of {name} failed: {e}\n")
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load(name: str = "_marching_native", source: str = "marching.cpp"):
    """Import (building if needed) a native module; None on failure."""
    if name in _cached:
        return _cached[name]
    mod = None
    try:
        if _build(name, source):
            import importlib.util
            spec = importlib.util.spec_from_file_location(name, _so_path(name))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
    except Exception as e:
        sys.stderr.write(f"native load of {name} failed: {e}\n")
        mod = None
    _cached[name] = mod
    return mod
