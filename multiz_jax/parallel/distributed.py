"""Multi-host execution: jax.distributed init + per-host job feeding.

The reference's "distributed runtime" is /tmp files + system()
(speciesTree.c:16-35); the replacement here is one SPMD program over a
mesh that spans every device of every host. Each host holds only
its own shard of the DP problem batch; `make_global` assembles the
global jax.Array from per-process local shards
(jax.make_array_from_process_local_data), computation follows the
sharding, and each host reads back only its local rows.

Entry points:
  * ``init_from_env()`` — call once per process before any jax op.
    Uses MULTIZ_COORDINATOR / MULTIZ_NUM_PROCS /
    MULTIZ_PROC_ID; without a coordinator it does nothing.
  * ``local_shard(n, ...)`` — which slice of a global job list this
    process owns.
  * ``distributed_yama_batch(jobs)`` — run the full-row batched DP over
    a global mesh, feeding only local jobs; returns results for the
    local shard.

Tested by tests/test_distributed.py, which launches real multi-process
jax.distributed over the CPU backend and asserts bit-equality against
the host oracle.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def init_from_env() -> bool:
    """jax.distributed.initialize from MULTIZ_* env; returns True if
    a multi-process runtime was initialized."""
    import jax

    coord = os.environ.get("MULTIZ_COORDINATOR")
    nproc = os.environ.get("MULTIZ_NUM_PROCS")
    pid = os.environ.get("MULTIZ_PROC_ID")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc) if nproc else None,
        process_id=int(pid) if pid else None,
    )
    return True


def local_shard(n: int, process_id: Optional[int] = None,
                num_processes: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of a length-n global work list owned by this process
    (contiguous block partition, remainder to the front processes)."""
    import jax

    p = jax.process_index() if process_id is None else process_id
    np_ = jax.process_count() if num_processes is None else num_processes
    base, rem = divmod(n, np_)
    lo = p * base + min(p, rem)
    hi = lo + base + (1 if p < rem else 0)
    return lo, hi


def make_global(local_np: np.ndarray, mesh, pspec):
    """Assemble a global jax.Array from this process's shard (leading
    dim sharded per ``pspec`` over ``mesh``)."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, pspec)
    return jax.make_array_from_process_local_data(
        sharding, local_np
    )


def global_batch_shardings(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return {
        1: NamedSharding(mesh, P("blocks")),
        2: NamedSharding(mesh, P("blocks", None)),
        3: NamedSharding(mesh, P("blocks", None, None)),
    }


def distributed_yama_batch(local_jobs: List, sp=None):
    """Run the batched full-row DP across every process's devices.

    ``local_jobs``: this process's shard of a GLOBAL job list whose
    bucket composition must be identical across processes (all
    processes must enter the same compiled programs — the caller
    achieves this by sharding a deterministic global list with
    ``local_shard``). Every process must call this collectively.
    Returns results for the local jobs, bit-identical to yama_numpy.

    NOTE: because buckets are derived from the LOCAL shard, a
    heterogeneous global list can still bucket differently across
    processes and diverge into mismatched collectives. The production
    multi-device path is ``distributed_yama_batch_packed`` below, which
    buckets on the global list and runs the device DP core; this
    full-row XLA path is kept for CPU-backend testing."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from .. import scores as sc
    from ..yama import _check_band
    from ..ops.yama_jax import (
        STACK_KEYS, _pad_to, _yama_device_batch, stack_jobs,
    )

    if sp is None:
        sp = sc.current
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    ss_cat = jnp.asarray(sp.ss_cat)
    nproc = jax.process_count()
    devices = np.asarray(jax.devices()).reshape(-1)
    mesh = Mesh(devices, ("blocks",))
    shardings = global_batch_shardings(mesh)

    buckets = {}
    for idx, (A, B, LB, RB) in enumerate(local_jobs):
        M, K = A.shape
        N, L = B.shape
        _check_band(np.asarray(LB), np.asarray(RB), M, N)
        key = (_pad_to(M), _pad_to(N))
        buckets.setdefault(key, []).append(idx)

    results = [None] * len(local_jobs)
    for (m_pad, n_pad), idxs in sorted(buckets.items()):
        # local shard size must be uniform across processes *per device*
        nloc = -(-len(idxs) // len(mesh.local_devices)) * len(
            mesh.local_devices
        )
        run = idxs + [idxs[-1]] * (nloc - len(idxs))
        stacked = stack_jobs([local_jobs[i] for i in run], m_pad, n_pad)
        gstacked = {}
        for k, v in stacked.items():
            v = np.asarray(v)
            gstacked[k] = make_global(
                v, mesh, P("blocks", *([None] * (v.ndim - 1)))
            )
        scripts, nedits = _yama_device_batch(
            gstacked["histA"], gstacked["a0"], gstacked["a1"],
            gstacked["pa"], gstacked["histB"], gstacked["b0"],
            gstacked["b1"], gstacked["pb"], gstacked["LB"],
            gstacked["RB"], gstacked["M"], gstacked["N"],
            gstacked["K"], gstacked["L"], ss_cat,
            go=go, ge=ge, m_pad=m_pad, n_pad=n_pad,
        )
        # read back only this process's rows
        loc_scripts = _local_rows(scripts)
        loc_nedits = _local_rows(nedits)
        from ..yama import _mzcore, _replay, YamaError

        for slot, idx in enumerate(idxs):
            A, B, _, _ = local_jobs[idx]
            ne = int(loc_nedits[slot])
            M, K = A.shape
            N, L = B.shape
            if _mzcore is not None:
                merged = np.empty((ne, K + L), dtype=np.uint8)
                try:
                    _mzcore.replay_into(
                        loc_scripts[slot], ne, True,
                        np.ascontiguousarray(A), M, K,
                        np.ascontiguousarray(B), N, L, merged,
                    )
                except ValueError as e:
                    raise YamaError(str(e))
                results[idx] = merged
            else:
                results[idx] = _replay(
                    loc_scripts[slot][:ne][::-1].copy(), A, B
                )
    return results


import functools


@functools.lru_cache(maxsize=None)
def _sharded_db(mesh, go, ge, m_pad, n_pad, wcap, core):
    """Jitted shard_map of the production device DP (_db_core) over
    ``mesh``'s ``blocks`` axis, cached per (mesh, bucket shape, core).
    Each device runs _db_core on its problem shard; results are
    all-gathered so every process holds the full payload (SURVEY.md
    §2.5 comm-backend row: collectives replace the reference's
    /tmp-file hand-off)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..ops.yama_pack import _db_core

    def local(at, bt, lb, rb, mn, ss):
        out = _db_core(at, bt, lb, rb, mn, ss, go=go, ge=ge,
                       m_pad=m_pad, n_pad=n_pad, wcap=wcap, core=core)
        return jax.lax.all_gather(out, "blocks", axis=0, tiled=True)

    sm = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("blocks", None, None), P("blocks", None, None),
            P("blocks", None), P("blocks", None),
            P("blocks", None), P(None, None),
        ),
        out_specs=P(None, None),
        check_vma=False,
    )
    return jax.jit(sm)


def distributed_yama_batch_packed(jobs, mesh=None, sp=None, core="cuda"):
    """Run the production device DP over every device of a mesh.

    ``jobs``: the GLOBAL job list — identical on every process (the
    tree pipeline is deterministic, so each host plans the same DP
    jobs; what is sharded is the device compute). Buckets are computed
    from the global list, so every process enters the same compiled
    programs with the same global shapes — per-process bucketing on
    heterogeneous shards cannot diverge into mismatched collectives.
    Results are all-gathered on device, so every process returns the
    full result list, bit-identical to yama_numpy. ``core`` names the DP
    core (ops/yama_pack.py).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from .. import scores as sc
    from ..ops import yama_pack as YP
    from ..ops.yama_jax import _pad_to
    from ..yama import _check_band, yama_numpy

    if sp is None:
        sp = sc.current
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), ("blocks",))
    ndev = mesh.shape["blocks"]
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    ss_cat = jnp.asarray(sp.ss_cat)

    buckets = {}
    results = [None] * len(jobs)
    for idx, (A, B, LB, RB) in enumerate(jobs):
        M, K = A.shape
        N, L = B.shape
        LBa = np.asarray(LB, dtype=np.int64)
        RBa = np.asarray(RB, dtype=np.int64)
        _check_band(LBa, RBa, M, N)
        wcap = YP.pick_wcap(LBa, RBa, M)
        if wcap is None or N > 65535:
            results[idx] = yama_numpy(A, B, LBa, RBa, sp=sp)
            continue
        p = max(_pad_to(M), _pad_to(N))
        key = (p, p, YP._pad8(K), YP._pad8(L), wcap)
        buckets.setdefault(key, []).append(idx)

    nproc = jax.process_count()
    pid = jax.process_index()
    for (m_pad, n_pad, Kp, Lp, wcap), idxs in sorted(buckets.items()):
        # the same count on every device, from the GLOBAL job count
        # (identical on every process); padding slots repeat the last
        # job and are not replayed
        nb = -(-len(idxs) // ndev) * ndev
        run = idxs + [idxs[-1]] * (nb - len(idxs))
        mp1 = m_pad + 1
        # this process's contiguous row range (mesh devices are
        # process-major, so P("blocks") rows land on local devices)
        lo = pid * (nb // nproc)
        hi = lo + nb // nproc
        Kp2 = -(-Kp // 2)
        Lp2 = -(-Lp // 2)
        Atex = np.zeros((hi - lo, Kp2, m_pad), np.uint8)
        Btex = np.zeros((hi - lo, Lp2, n_pad), np.uint8)
        LBp = np.zeros((hi - lo, mp1), np.int32)
        RBp = np.zeros((hi - lo, mp1), np.int32)
        MNKL = np.zeros((hi - lo, 4), np.int32)
        for slot in range(lo, hi):
            A, B, LB, RB = jobs[run[slot]]
            M, K = A.shape
            N, L = B.shape
            s = slot - lo
            YP._pack_cat_rows(Atex[s], A, K, Kp2)
            YP._pack_cat_rows(Btex[s], B, L, Lp2)
            LBp[s, : M + 1] = LB[: M + 1]
            RBp[s, : M + 1] = RB[: M + 1]
            LBp[s, M + 1 :] = LB[M]
            RBp[s, M + 1 :] = RB[M]
            MNKL[s] = (M, N, K, L)

        def garr(arr):
            spec = P("blocks", *([None] * (arr.ndim - 1)))
            sharding = NamedSharding(mesh, spec)
            if nproc == 1:
                return jax.device_put(arr, sharding)
            return jax.make_array_from_process_local_data(sharding, arr)

        fn = _sharded_db(mesh, go, ge, m_pad, n_pad, wcap, core)
        ss_rep = jax.device_put(
            ss_cat, NamedSharding(mesh, P(None, None))
        )
        out = fn(garr(Atex), garr(Btex), garr(LBp), garr(RBp),
                 garr(MNKL), ss_rep)
        YP._replay_payload(np.asarray(out), idxs, jobs, results)
    return results


def _local_rows(garr) -> np.ndarray:
    """Gather this process's rows of a leading-dim-sharded global array,
    in shard order."""
    shards = sorted(
        garr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
