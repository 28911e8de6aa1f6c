"""Build, load and call the CUDA yama kernel (ops/cuda/yama_dp.cu).

The shared library is compiled with nvcc for sm_90a from the committed
sources at first use, into ``ops/cuda/build/`` (listed in .gitignore),
under a name keyed by the sources' hash, so an edited source never loads
a stale build. ``python -m multiz_jax.ops.yama_cuda`` builds it ahead of
time. Set NVCC to choose the compiler; otherwise it is looked up on PATH
and then under /usr/local/cuda.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SOURCES = ("yama_dp.cu", "yama_dp.cuh")
_TARGET = "mz_yama_dp"
_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC): the CUDA DP core needs the CUDA toolkit"
    )


def library_path() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_HERE, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(_HERE, "build", f"libmzyama_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library if it is missing; returns its path."""
    import jax.ffi

    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-I", _HERE,
        "-o", tmp, os.path.join(_HERE, "yama_dp.cu"),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        import jax.ffi

        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.MzYamaDp), platform="CUDA"
        )
        _registered = True


def yama_dp(cstat, rstat, mnkl, *, go: int, ge: int, wcap: int, outw: int):
    """The kernel as a JAX operation: (B, outw) uint8 result payloads.
    Operand layouts: ops/cuda/yama_dp.cu."""
    import jax
    import jax.numpy as jnp

    _register()
    B, nrow = rstat.shape[0], rstat.shape[1]
    out, _ = jax.ffi.ffi_call(
        _TARGET,
        (
            jax.ShapeDtypeStruct((B, outw), jnp.uint8),
            jax.ShapeDtypeStruct((B, nrow, wcap), jnp.uint8),
        ),
    )(cstat, rstat, mnkl, go=np.int32(go), ge=np.int32(ge))
    return out


if __name__ == "__main__":
    print(build())
