"""Select the DP execution backend for the multiz/tba pipeline.

The reference runs every overlap DP serially in-process
(multiz.c:149, mz_yama.c:50). Here the pipeline *plans* all DPs and
executes them through one of:

  * ``packed``  — the streaming device executor (ops/yama_pack.py) over
                  the band-local CUDA kernel; picked automatically when
                  the default device is a GPU.
  * ``jax``     — the same executor over the plain full-row XLA core
                  (ops/yama_jax.py); runs on any JAX backend.
  * ``host``    — per-problem NumPy/C++ oracle loop (yama.py); used to
                  exercise the two-phase plan/execute/stitch machinery
                  without a device.
  * ``none``    — disable batching; the merge scan calls the oracle
                  inline (the reference's shape).

Override with MULTIZ_DEVICE=packed|jax|host|none (default: auto).
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def host_batch(jobs, sp=None):
    """Per-problem host loop with the batch_fn signature."""
    from ..yama import yama_numpy

    return [yama_numpy(A, B, LB, RB, sp=sp) for (A, B, LB, RB) in jobs]


def default_batch_fn() -> Optional[Callable]:
    """Resolve the batch DP backend from MULTIZ_DEVICE / hardware."""
    mode = os.environ.get("MULTIZ_DEVICE", "auto").lower()
    if mode in ("0", "off", "none"):
        return None
    if mode == "host":
        return host_batch
    if mode == "jax":
        from .yama_pack import packed_batch_fn

        return packed_batch_fn("xla")
    if mode == "packed":
        from .yama_pack import yama_batch_packed

        return yama_batch_packed
    if mode != "auto":
        raise ValueError(f"MULTIZ_DEVICE={mode!r} is not a DP backend")
    import jax

    if jax.devices()[0].platform == "gpu":
        from .yama_pack import yama_batch_packed

        return yama_batch_packed
    return None
