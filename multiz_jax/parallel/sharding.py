"""Device-mesh sharding for the batched yama DP.

The reference toolkit has no parallelism of any kind (SURVEY.md §2.5): the
all_bz driver runs its O(N^2) pairwise jobs serially via system()
(all_bz.c:385-402) and multiz processes overlap DPs one at a time inside
the merge scan (multiz.c:68-175). The replacement here treats the
batch of independent banded DP problems as the data-parallel axis:

  * ``blocks`` mesh axis — problems shard over devices; each device runs
    the vmapped kernel on its shard (pure data parallelism; no cross-
    device communication in the forward pass).
  * ``band`` mesh axis — column statistics of the B-side alignment (and
    the per-row DP vectors derived from them) shard over columns
    (sequence parallelism for very long bands); XLA partitions the
    in-row cumsum/cummax chains with collective-permute scans.

Multi-host scaling rides the same mesh: `jax.distributed` extends
`jax.devices()` across hosts, the ``blocks`` axis spans them all, and
hosts feed their local shard of problems (`make_array_from_process_local
data` semantics via `jax.device_put` with a NamedSharding).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    devices: Optional[Sequence] = None,
    band: int = 1,
) -> Mesh:
    """Build a (blocks, band) mesh over ``devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if band < 1 or n % band != 0:
        raise ValueError(f"band={band} must divide device count {n}")
    arr = np.asarray(devices).reshape(n // band, band)
    return Mesh(arr, ("blocks", "band"))


def batch_shardings(mesh: Mesh):
    """NamedShardings for the stacked yama-batch operands.

    Returns (spec_2d, spec_3d, spec_1d): batch-major arrays shard their
    leading (problem) dim over ``blocks``; the column-statistics dim of
    2D/3D arrays additionally shards over ``band``. Scalars-per-problem
    arrays (M/N/K/L) shard over ``blocks`` only.
    """
    s2 = NamedSharding(mesh, P("blocks", "band"))
    s3 = NamedSharding(mesh, P("blocks", "band", None))
    s1 = NamedSharding(mesh, P("blocks"))
    return s2, s3, s1


def pad_batch(n: int, mesh: Mesh) -> int:
    """Problems per bucket must be divisible by the block axis size."""
    nb = mesh.shape["blocks"] * mesh.shape["band"]
    return -(-n // nb) * nb


def shard_stacked(stacked: dict, mesh: Mesh) -> dict:
    """device_put each stacked operand with its mesh sharding.

    ``stacked`` maps operand name -> jnp array with leading batch dim,
    as built by ``multiz_jax.ops.yama_jax.yama_batch``. The jitted kernel
    then runs SPMD: computation follows data, XLA partitions the vmap
    across the ``blocks`` axis and the column vectors across ``band``.
    """
    s2, s3, s1 = batch_shardings(mesh)
    band = mesh.shape["band"]
    out = {}
    for k, v in stacked.items():
        if v.ndim == 1:
            sh = s1
        elif v.ndim == 2:
            # column dims are bucket_pad+1 (1-indexed stats); shard over
            # ``band`` only when evenly divisible, else replicate
            sh = s2 if v.shape[1] % band == 0 else s1
        else:
            sh = (
                s3
                if v.shape[1] % band == 0
                else NamedSharding(mesh, P("blocks", None, None))
            )
        out[k] = jax.device_put(v, sh)
    return out
