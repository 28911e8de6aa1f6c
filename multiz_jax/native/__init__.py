"""Build/load the native host runtime (_mzcore C++ extension).

The extension is compiled on demand with g++ against the running
Python's headers (no numpy C API, buffer protocol only), cached next to
the source, and loaded via importlib. Everything degrades gracefully:
callers treat a None return as "use the NumPy fallback".

Set MULTIZ_NO_NATIVE=1 to force the pure-Python path.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mzcore.cpp")
_cached = None
_tried = False


def _so_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_HERE, "_mzcore" + suffix)


def build(force: bool = False) -> str | None:
    """Compile mzcore.cpp -> _mzcore.*.so; returns the path or None."""
    so = _so_path()
    if (
        not force
        and os.path.exists(so)
        and os.path.getmtime(so) >= os.path.getmtime(_SRC)
    ):
        return so
    include = sysconfig.get_paths()["include"]
    # build to a private name and rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}", _SRC, "-o", tmp,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def load():
    """Return the _mzcore module, building it if needed, or None."""
    global _cached, _tried
    if _tried:
        return _cached
    _tried = True
    if os.environ.get("MULTIZ_NO_NATIVE"):
        return None
    so = build()
    if so is None:
        return None
    try:
        spec = importlib.util.spec_from_file_location("multiz_jax._mzcore", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception:
        return None
    _cached = mod
    return mod
