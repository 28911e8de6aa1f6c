"""Batched banded yama DP on the device: wire packing, device prep, the
DP core and the streaming executor that feeds it (the production path).

Per launch, the host packs one contiguous uint8 buffer (category-nibble
texts, uint16 band planes, M/N/K/L); one jitted program turns it into
per-column and per-row statistics (`_prep_one`, plain jax.numpy) and
runs a DP core that returns, per problem, the op count and the edit
script packed four 2-bit ops per byte, newest-first. The host replays
the scripts into merged column matrices. Results are bit-identical to
`yama.yama_numpy` (same int32 arithmetic and C >= D > I tie-breaking,
mz_yama.c:138-154).

Two cores take the same operands and give the same payload:

  * ``cuda`` — the band-local CUDA kernel (ops/cuda/yama_dp.cu, called
    through jax.ffi): one warp per problem, rows in an in-kernel loop,
    traceback in the same kernel. Needs a GPU.
  * ``xla``  — the full-row `lax.scan` formulation of ops/yama_jax.py,
    vmapped over the launch. Runs on any backend; the CPU tests use it
    as the stand-in for the kernel.

The caller names the core; nothing falls back from one to the other.
"""

from __future__ import annotations

import functools
import os as _os
import threading

import numpy as np

import jax
import jax.numpy as jnp

from .. import scores as sc
from ..yama import _check_band
from .yama_jax import _pad_to, _traceback_core, _yama_core, sub_right

# Flag-row widths: a bucket uses the smallest rung that holds its widest
# band row (RB - LB + 1 columns). Wider bands fall back to the oracle.
WCAPS = (64, 256, 1024)
CORES = ("cuda", "xla")

# column statistics (stat-major) and row statistics (row-major) as the
# kernel reads them; layouts mirrored in ops/cuda/yama_dp.cuh
NCSTAT, NRSTAT = 12, 16
RS_LB, RS_RB = 12, 13

# jobs per mid-stream launch of one bucket
LAUNCH_CHUNK = 256


# ---------------------------------------------------------------------------
# Device-side prep: packed texts -> kernel operands (no gathers)
# ---------------------------------------------------------------------------


def _cats(packed, nrows):
    """Unpack host-packed category nibbles into per-row categories.

    ``packed`` (rp2, cols) uint8: the low nibble of packed row p is the
    BYTE2CAT category (scores.py:46-50) of alignment row p, the high
    nibble is row p + rp2, so unpacking is a plain concat. Rows >= nrows
    are padding, masked by rmask."""
    lo = (packed & jnp.uint8(0x0F)).astype(jnp.int32)
    hi = (packed >> 4).astype(jnp.int32)
    cat = jnp.concatenate([lo, hi], axis=0)  # (2*rp2, cols)
    rmask = jax.lax.broadcasted_iota(jnp.int32, cat.shape, 0) < nrows
    return cat, rmask


def _col_stats(text, nrows):
    """Per-column stats of one packed text (rp, cols): histogram (6, cols),
    nondash/ndash (cols,), pair patterns 4 x (cols,) with the col-1 quirk
    (yama.py:96-107)."""
    cat, rmask = _cats(text, nrows)
    hist = jnp.stack(
        [((cat == c) & rmask).sum(axis=0, dtype=jnp.int32) for c in range(6)],
        axis=0,
    )  # (6, cols)
    dash = (cat == 4) & rmask
    ndash = hist[4]
    nond = rmask.sum(axis=0, dtype=jnp.int32) - ndash
    f = jnp.concatenate([dash[:, :1], dash[:, :-1]], axis=1)  # prev col
    s = dash
    p00 = ((~f) & (~s) & rmask).sum(axis=0, dtype=jnp.int32)
    p01 = ((~f) & s & rmask).sum(axis=0, dtype=jnp.int32)
    p10 = (f & (~s) & rmask).sum(axis=0, dtype=jnp.int32)
    p11 = (f & s & rmask).sum(axis=0, dtype=jnp.int32)
    # first-bit forced 0 (mz_yama.c:128-129)
    zero = jnp.zeros((1,), jnp.int32)
    p00 = jnp.concatenate([nond[:1], p00[1:]])
    p01 = jnp.concatenate([ndash[:1], p01[1:]])
    p10 = jnp.concatenate([zero, p10[1:]])
    p11 = jnp.concatenate([zero, p11[1:]])
    return hist, nond, ndash, (p00, p01, p10, p11)


def _prep_one(Atex, Btex, LB, RB, K, L, ss_cat):
    """Kernel operands for ONE problem.

    Returns cstat (12, n_pad+1): [b0, b1, pb0..pb3, sbp0..sbp5] per B
    column, with sbp = ss_cat . histB (the substitution projection), and
    rstat (m_pad+1, 16): [a0, a1, pa0..pa3, histA0..5, LB, RB, 0, 0] per
    A column. Columns are 1-based as in yama.ColStats: index 0 is zero."""
    histA, a0, a1, paA = _col_stats(Atex, K)
    histB, b0, b1, pbB = _col_stats(Btex, L)
    sbp = sub_right(histB.T, ss_cat).T  # (6, n_pad)
    cst = jnp.concatenate([jnp.stack([b0, b1, *pbB], axis=0), sbp], axis=0)
    cstat = jnp.pad(cst, ((0, 0), (1, 0)))
    rows = jnp.concatenate(
        [jnp.stack([a0, a1, *paA], axis=1), histA.T], axis=1
    )  # (m_pad, 12)
    rows = jnp.pad(rows, ((1, 0), (0, 0)))
    pad = jnp.zeros((rows.shape[0], NRSTAT - 14), jnp.int32)
    rstat = jnp.concatenate([rows, LB[:, None], RB[:, None], pad], axis=1)
    return cstat, rstat


def _out_width(m_pad: int, n_pad: int) -> int:
    """Payload bytes per problem: int32 op count + 4 ops per byte."""
    return 4 + -(-(m_pad + n_pad) // 4)


def _xla_core(cstat, rstat, mnkl, *, go, ge, m_pad, n_pad):
    """The plain core: ops/yama_jax.py's full-row scan + scan traceback,
    vmapped over the launch, packed into the kernel's payload format."""

    def one(cst, rst, m):
        LB, RB = rst[:, RS_LB], rst[:, RS_RB]
        flags, lc, ld, li = _yama_core(
            rst[:, 6:12], rst[:, 0], rst[:, 1], rst[:, 2:6],
            cst[6:12].T, cst[0], cst[1], cst[2:6].T,
            LB, RB, m[0], m[1], m[2], m[3],
            go=go, ge=ge, m_pad=m_pad, n_pad=n_pad,
        )
        return _traceback_core(
            flags, LB, RB, m[0], m[1], lc, ld, li, m_pad=m_pad, n_pad=n_pad
        )

    scripts, ne = jax.vmap(one)(cstat, rstat, mnkl)
    B = scripts.shape[0]
    nbytes = _out_width(m_pad, n_pad) - 4
    ops = jnp.pad(scripts, ((0, 0), (0, 4 * nbytes - scripts.shape[1])))
    k = jnp.arange(4 * nbytes, dtype=jnp.int32)
    ops = jnp.where(k[None, :] < ne[:, None], ops.astype(jnp.int32) & 3, 0)
    shifts = jnp.arange(0, 8, 2, dtype=jnp.int32)
    packed = (ops.reshape(B, nbytes, 4) << shifts).sum(axis=-1)
    ne8 = (ne[:, None] >> jnp.arange(0, 32, 8, dtype=jnp.int32)) & 0xFF
    return jnp.concatenate([ne8, packed], axis=1).astype(jnp.uint8)


def _prep_batch(Atex, Btex, LB, RB, MNKL, ss_cat):
    """_prep_one over a launch: (cstat (B, 12, n_pad+1), rstat (B,
    m_pad+1, 16)), the operands both cores read."""
    return jax.vmap(_prep_one, in_axes=(0, 0, 0, 0, 0, 0, None))(
        Atex, Btex, LB, RB, MNKL[:, 2], MNKL[:, 3], ss_cat
    )


def _db_core(Atex, Btex, LB, RB, MNKL, ss_cat, *, go, ge, m_pad, n_pad,
             wcap, core):
    """Per-problem operand arrays (leading dim B) -> result payload
    (B, _out_width) uint8. Called directly under shard_map for
    multi-device execution (parallel/distributed.py); every operand
    shards on dim 0."""
    cstat, rstat = _prep_batch(Atex, Btex, LB, RB, MNKL, ss_cat)
    return _run_core(cstat, rstat, MNKL, go=go, ge=ge, m_pad=m_pad,
                     n_pad=n_pad, wcap=wcap, core=core)


def _run_core(cstat, rstat, MNKL, *, go, ge, m_pad, n_pad, wcap, core):
    """The named DP core over prepped operands -> result payload."""
    if core == "cuda":
        from . import yama_cuda

        return yama_cuda.yama_dp(
            cstat, rstat, MNKL, go=go, ge=ge, wcap=wcap,
            outw=_out_width(m_pad, n_pad),
        )
    if core == "xla":
        return _xla_core(cstat, rstat, MNKL, go=go, ge=ge, m_pad=m_pad,
                         n_pad=n_pad)
    raise ValueError(f"unknown DP core {core!r} (expected one of {CORES})")


def _wire_offsets(B, m_pad, n_pad, Kp, Lp):
    """Byte offsets of the packed host buffer's sections: A texts, B
    texts, LB lo/hi planes, RB lo/hi planes, MNKL, end."""
    mp1 = m_pad + 1
    oB = B * m_pad * (-(-Kp // 2))
    oLB = oB + B * n_pad * (-(-Lp // 2))
    oRB = oLB + B * mp1 * 2
    oS = oRB + B * mp1 * 2
    return 0, oB, oLB, oRB, oS, oS + B * 16


@functools.partial(
    jax.jit,
    static_argnames=("go", "ge", "m_pad", "n_pad", "Kp", "Lp", "B", "wcap",
                     "core"),
)
def _device_batch(buf, ss_cat, go, ge, m_pad, n_pad, Kp, Lp, B, wcap, core):
    """Packed host buffer -> prep -> DP core, one jitted program with one
    H2D operand and one D2H payload."""
    return _db_core(*_unpack_wire(buf, B, m_pad, n_pad, Kp, Lp), ss_cat,
                    go=go, ge=ge, m_pad=m_pad, n_pad=n_pad, wcap=wcap,
                    core=core)


def _unpack_wire(buf, B, m_pad, n_pad, Kp, Lp):
    """Packed host buffer -> (Atex, Btex, LB, RB, MNKL) device arrays.

    Wire format (written by PackedDPStream._pack): category nibbles 2
    rows/byte (see _cats) and uint16 band bounds as lo/hi byte planes."""
    mp1 = m_pad + 1
    oA, oB, oLB, oRB, oS, end = _wire_offsets(B, m_pad, n_pad, Kp, Lp)
    Atex = buf[oA:oB].reshape(B, -(-Kp // 2), m_pad)
    Btex = buf[oB:oLB].reshape(B, -(-Lp // 2), n_pad)

    def bands16(seg):
        lo = seg[: B * mp1].reshape(B, mp1).astype(jnp.int32)
        hi = seg[B * mp1 :].reshape(B, mp1).astype(jnp.int32)
        return lo | (hi << 8)

    LB = bands16(buf[oLB:oRB])
    RB = bands16(buf[oRB:oS])
    MNKL = jax.lax.bitcast_convert_type(
        buf[oS:end].reshape(B, 4, 4), jnp.int32
    )
    return Atex, Btex, LB, RB, MNKL


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------


def _pack_cat_rows(dst, X, nrow, rp2):
    """Pack BYTE2CAT categories of X (ncol, nrow) into dst (rp2, >=ncol)
    uint8 nibbles: low nibble of packed row p = row p, high nibble =
    row p + rp2 (so the device unpack is a plain concat, see _cats)."""
    cat = sc.BYTE2CAT[X].astype(np.uint8).T  # (nrow, ncol)
    ncol = cat.shape[1]
    lo = min(nrow, rp2)
    dst[:lo, :ncol] = cat[:lo]
    if nrow > rp2:
        hi = nrow - rp2
        dst[:hi, :ncol] |= cat[rp2:] << 4


def pick_wcap(LB, RB, M) -> int | None:
    """Smallest flag-row width that holds every band row of the problem,
    or None (-> host oracle fallback)."""
    need = int((np.asarray(RB[: M + 1]) - np.asarray(LB[: M + 1])).max()) + 1
    for w in WCAPS:
        if need <= w:
            return w
    return None


def _pad8(n: int) -> int:
    return -(-max(n, 1) // 8) * 8


def _launch_size(n: int) -> int:
    """Padded job count of a launch: the smallest of 8, 12, 16, 24, 32,
    48, ... that holds ``n``. The count is a static compile parameter,
    so the ladder bounds the compiled variants; padding is <= 1/3."""
    s = 8
    while s < n:
        s = s * 3 // 2 if s & (s - 1) == 0 else s * 4 // 3
    return s


@functools.lru_cache(maxsize=None)
def _device_memory_bytes() -> int:
    """Memory of the default device as it reports it; the CPU backend
    reports none, and then the host's physical memory stands in."""
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    return _os.sysconf("SC_PAGE_SIZE") * _os.sysconf("SC_PHYS_PAGES")


def _job_bytes(m_pad, n_pad, Kp, Lp, wcap, core) -> int:
    """Device bytes one job holds during a launch: operands, prep
    temporaries (int32 category planes), statistics, flags, payload."""
    texts = 4 * (2 * -(-Kp // 2) * m_pad + 2 * -(-Lp // 2) * n_pad)
    stats = 4 * (NCSTAT * (n_pad + 1) + NRSTAT * (m_pad + 1))
    flags = (m_pad + 1) * (wcap if core == "cuda" else 4 * (n_pad + 1))
    return 3 * texts + 2 * stats + flags + _out_width(m_pad, n_pad)


def _launch_cap(m_pad, n_pad, Kp, Lp, wcap, core) -> int:
    """Most jobs one launch may take: a quarter of the device memory over
    the per-job bytes, rounded down to the launch ladder."""
    cap = (_device_memory_bytes() // 4) // _job_bytes(
        m_pad, n_pad, Kp, Lp, wcap, core
    )
    s = 8
    while _launch_size(s + 1) <= cap:
        s = _launch_size(s + 1)
    return s


_COUNT_KEYS = (
    "device_jobs", "device_cells", "host_jobs", "host_cells",
    "fallback_jobs", "fallback_cells", "launches",
)
_counts_lock = threading.Lock()
_counts = dict.fromkeys(_COUNT_KEYS, 0)


def route_counts() -> dict:
    """DP jobs and band cells routed to the device, to the host (native
    lane or inline oracle) and to the oracle fallback, summed over every
    finished PackedDPStream since the last reset."""
    with _counts_lock:
        return dict(_counts)


def reset_route_counts() -> None:
    with _counts_lock:
        for k in _COUNT_KEYS:
            _counts[k] = 0


class PackedDPStream:
    """Streaming batched DP over (A, B, LB, RB) jobs.

    The merge scan submits DP jobs one at a time as it plans them
    (multiz._DeferredDP); jobs accumulate into square shape buckets and
    a bucket is packed + dispatched ASYNCHRONOUSLY once it holds enough
    jobs or ``flush_cells`` band cells, so the device computes while the
    host keeps planning. ``finish()`` dispatches the leftovers (routing
    still-tiny buckets to the native host DP), fetches every payload,
    and replays the edit scripts. Results are bit-identical to
    yama_numpy regardless of chunking.

    ``core`` names the device DP core (see module doc)."""

    def __init__(
        self,
        sp: sc.ScoreParams | None = None,
        flush_cells: int | None = None,
        host_route: int | None = None,
        host_lane_cells: int | None = None,
        autoflush: bool = True,
        core: str = "cuda",
        host_threads: int | None = None,
    ):
        from ..yama import _mzcore

        if core not in CORES:
            raise ValueError(f"unknown DP core {core!r}")
        self.core = core
        self.sp = sp if sp is not None else sc.current
        self.go, self.ge = int(self.sp.gap_open), int(self.sp.gap_extend)
        self.ss_cat = jnp.asarray(self.sp.ss_cat)
        self.flush_cells = (
            flush_cells
            if flush_cells is not None
            else int(_os.environ.get("MZ_FLUSH_CELLS", "4000000"))
        )
        self.host_route = (
            host_route
            if host_route is not None
            else int(_os.environ.get("MZ_HOST_ROUTE_CELLS", "1000000"))
        )
        self._binfo = getattr(_mzcore, "band_info", None) if _mzcore else None
        self._wcaps = np.asarray(WCAPS, dtype=np.int64)
        self.n = 0
        self.jobs: dict = {}  # slot -> (A, B, LB, RB); dropped after replay
        self.results: dict = {}  # slot -> merged matrix
        self.job_cells: dict = {}
        self.buckets: dict = {}  # key -> [slot, ...]
        self.bucket_cells: dict = {}
        self.dispatched: set = set()  # keys that had a device launch
        self.pending: list = []  # (slots, device_out)
        self.counts = dict.fromkeys(_COUNT_KEYS, 0)
        self.tot_cells = 0
        self.timing = _os.environ.get("MZ_TIME")
        self.autoflush = autoflush
        self._pack_s = self._disp_s = 0.0
        # ---- host DP lane ----
        # The native host DP releases the GIL, so worker threads run it
        # concurrently with the (Python) merge-scan planning on the main
        # thread. Jobs up to MZ_HOST_JOB_CELLS go there; the device takes
        # the bigger ones. MZ_HOST_LANE_CELLS bounds the lane's backlog
        # (default: unbounded). One-shot callers (yama_batch_packed)
        # pass a cap instead: all jobs arrive at once there, and the cap
        # leaves the lane what it can finish in the shadow of the device.
        self.host_job_cells = int(
            _os.environ.get("MZ_HOST_JOB_CELLS", "65536")
        )
        self.host_lane_cells = (
            host_lane_cells
            if host_lane_cells is not None
            else int(_os.environ.get("MZ_HOST_LANE_CELLS", str(1 << 60)))
        )
        nthreads = (
            host_threads
            if host_threads is not None
            else int(_os.environ.get("MZ_HOST_DP_THREADS", "2"))
        )
        self._host_pool = None
        self._host_futs: list = []
        self._host_backlog = 0  # cells; GIL-atomic +=/-= in int steps
        self._host_chunk: list = []
        self._host_chunk_jobs = int(_os.environ.get("MZ_HOST_CHUNK", "96"))
        self._lane_busy_s = 0.0
        if nthreads > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._host_pool = ThreadPoolExecutor(
                max_workers=nthreads,
                thread_name_prefix="mz-hostdp",
            )

    def _count(self, route: str, cells: int, jobs: int = 1) -> None:
        self.counts[route + "_jobs"] += jobs
        self.counts[route + "_cells"] += cells

    def _host_submit(self, slot, A, B, LBa, RBa, cells) -> None:
        # chunked: the worker runs a whole chunk under ONE GIL release
        # (mzcore.yama_many) — per-job handoffs would convoy against
        # the planning thread's 5 ms GIL slices
        self._count("host", cells)
        self._host_backlog += cells
        self._host_chunk.append((slot, A, B, LBa, RBa, cells))
        if len(self._host_chunk) >= self._host_chunk_jobs:
            self._host_flush()

    def _host_flush(self) -> None:
        from ..yama import _mzcore, yama_numpy

        chunk, self._host_chunk = self._host_chunk, []
        if not chunk:
            return
        total = sum(c[5] for c in chunk)
        many = getattr(_mzcore, "yama_many", None) if _mzcore else None
        if many is None:
            for slot, A, B, LB, RB, _ in chunk:
                self.results[slot] = yama_numpy(A, B, LB, RB, sp=self.sp)
            self._host_backlog -= total
            return
        # All Python/numpy prep happens HERE on the calling thread; the
        # worker runs nothing but the GIL-free native batch call (a
        # worker that interleaves Python bookkeeping with native work
        # convoys the planning thread's own numpy GIL releases).
        probs = []
        outs = []
        for slot, A, B, LB, RB, _ in chunk:
            M, K = A.shape
            N, L = B.shape
            out = np.empty((M + N, K + L), dtype=np.uint8)
            probs.append((
                np.ascontiguousarray(A), M, K,
                np.ascontiguousarray(B), N, L,
                np.ascontiguousarray(LB[: M + 1]),
                np.ascontiguousarray(RB[: M + 1]), out,
            ))
            outs.append(out)
        ss_cat, cat = self.sp.ss_cat, sc.BYTE2CAT
        go, ge = int(self.sp.gap_open), int(self.sp.gap_extend)

        def work():
            import time as _t

            t0 = _t.perf_counter()
            try:
                return many(probs, ss_cat, cat, go, ge)
            finally:
                self._host_backlog -= total
                self._lane_busy_s += _t.perf_counter() - t0

        self._host_futs.append(
            (chunk, outs, self._host_pool.submit(work))
        )

    def submit(self, job) -> int:
        from ..yama import YamaError, yama_numpy

        A, B, LB, RB = job
        slot = self.n
        self.n += 1
        M, K = A.shape
        N, L = B.shape
        LBa = np.asarray(LB, dtype=np.int64)
        RBa = np.asarray(RB, dtype=np.int64)
        if self._binfo is not None:
            # one native pass: validation + width rung + cell count
            try:
                wcap, _, cells = self._binfo(
                    np.ascontiguousarray(LBa[: M + 1]),
                    np.ascontiguousarray(RBa[: M + 1]),
                    M, N, self._wcaps,
                )
            except ValueError as e:
                raise YamaError(str(e))
            wcap = wcap or None
        else:
            _check_band(LBa, RBa, M, N)
            cells = int(
                (np.minimum(RBa[: M + 1], N) - LBa[: M + 1]).sum()
            ) + M
            wcap = pick_wcap(LBa, RBa, M)
        self.tot_cells += cells
        self.job_cells[slot] = cells
        if wcap is None or N > 65535:  # band bounds travel as uint16
            self._count("fallback", cells)
            self.results[slot] = yama_numpy(A, B, LBa, RBa, sp=self.sp)
            return slot
        if (
            self._host_pool is not None
            and cells <= self.host_job_cells
            and self._host_backlog < self.host_lane_cells
        ):
            self._host_submit(slot, A, B, LBa, RBa, cells)
            return slot
        self.jobs[slot] = (A, B, LBa, RBa)
        # square buckets: fewer compiled shapes and launches; the kernel
        # is band-local so the padding costs only prep width, and the
        # traceback stops at the real script length
        p = max(_pad_to(M), _pad_to(N))
        key = (p, p, _pad8(K), _pad8(L), wcap)
        lst = self.buckets.setdefault(key, [])
        lst.append(slot)
        c = self.bucket_cells.get(key, 0) + cells
        self.bucket_cells[key] = c
        if not self.autoflush:
            # one-shot mode: buffer everything so finish() flushes the
            # whole bucket globally size-sorted (a mid-stream chunk of
            # mixed sizes makes every traceback pay the chunk's max M+N)
            return slot
        # Mid-stream flushes dispatch job counts on the launch ladder
        # only: the count is a static compile parameter, so arbitrary
        # flush points would each compile a fresh program.
        if len(lst) >= LAUNCH_CHUNK:
            self._flush(key, exact=LAUNCH_CHUNK)
        elif c >= self.flush_cells and len(lst) >= 32:
            self._flush(key, exact=32 << ((len(lst) // 32).bit_length() - 1))
        return slot

    def _pack(self, run, nb, key) -> np.ndarray:
        """One contiguous uint8 buffer for a launch of ``nb`` slots (see
        _device_batch); slots past ``run`` are zero padding (M = 0)."""
        m_pad, n_pad, Kp, Lp, _ = key
        mp1 = m_pad + 1
        Kp2, Lp2 = -(-Kp // 2), -(-Lp // 2)
        oA, oB, oLB, oRB, oS, end = _wire_offsets(nb, m_pad, n_pad, Kp, Lp)
        buf = np.zeros(end, np.uint8)
        Atex = buf[oA:oB].reshape(nb, Kp2, m_pad)
        Btex = buf[oB:oLB].reshape(nb, Lp2, n_pad)
        LBs = np.zeros((nb, mp1), np.uint16)
        RBs = np.zeros((nb, mp1), np.uint16)
        MNKL = buf[oS:].view(np.int32).reshape(nb, 4)
        for i, slot in enumerate(run):
            A, B, LB, RB = self.jobs[slot]
            M, K = A.shape
            N, L = B.shape
            _pack_cat_rows(Atex[i], A, K, Kp2)
            _pack_cat_rows(Btex[i], B, L, Lp2)
            LBs[i, : M + 1] = LB[: M + 1]
            RBs[i, : M + 1] = RB[: M + 1]
            LBs[i, M + 1 :] = LB[M]
            RBs[i, M + 1 :] = RB[M]
            MNKL[i] = (M, N, K, L)
        nbm = nb * mp1
        buf[oLB : oLB + nbm] = (LBs & 0xFF).astype(np.uint8).reshape(-1)
        buf[oLB + nbm : oRB] = (LBs >> 8).astype(np.uint8).reshape(-1)
        buf[oRB : oRB + nbm] = (RBs & 0xFF).astype(np.uint8).reshape(-1)
        buf[oRB + nbm : oS] = (RBs >> 8).astype(np.uint8).reshape(-1)
        return buf

    def _flush(self, key, exact: int | None = None) -> None:
        """Pack + dispatch one bucket's jobs (async). With ``exact``,
        dispatch only the ``exact`` LARGEST pending jobs as one
        zero-padding launch and keep the rest buffered."""
        import time as _t

        slots = self.buckets.pop(key)
        _tp0 = _t.perf_counter()
        m_pad, n_pad, Kp, Lp, wcap = key
        # sort by problem size so a launch's tracebacks end together
        slots.sort(
            key=lambda s: self.jobs[s][0].shape[0]
            + self.jobs[s][1].shape[0],
            reverse=True,
        )
        if exact is not None:
            keep = slots[exact:]
            slots = slots[:exact]
            if keep:
                self.buckets[key] = keep
                self.bucket_cells[key] = sum(
                    self.job_cells[s] for s in keep
                )
            else:
                self.bucket_cells.pop(key, None)
        else:
            self.bucket_cells.pop(key, None)
        self.dispatched.add(key)
        cap = _launch_cap(m_pad, n_pad, Kp, Lp, wcap, self.core)
        for lo_ in range(0, len(slots), cap):
            part = slots[lo_ : lo_ + cap]
            nb = _launch_size(len(part))
            buf = self._pack(part, nb, key)
            _tp1 = _t.perf_counter()
            self._pack_s += _tp1 - _tp0
            out = _device_batch(
                jnp.asarray(buf), self.ss_cat, go=self.go, ge=self.ge,
                m_pad=m_pad, n_pad=n_pad, Kp=Kp, Lp=Lp, B=nb, wcap=wcap,
                core=self.core,
            )
            self.pending.append((part, out))
            self._count("device", sum(self.job_cells[s] for s in part),
                        len(part))
            self.counts["launches"] += 1
            _tp0 = _t.perf_counter()
            self._disp_s += _tp0 - _tp1

    def finish(self) -> list:
        """Dispatch/host-route leftovers, fetch, replay; returns results
        in submission order."""
        from ..yama import yama_numpy

        # Buckets still below MZ_HOST_ROUTE_CELLS that never had a
        # launch go to the host DP lane, in the shadow of the device
        # tail's fetch below. Buckets that already had a launch keep
        # going to the device (their shapes are compiled and warm).
        for key in list(self.buckets.keys()):
            if (
                key not in self.dispatched
                and self.bucket_cells.get(key, 0) < self.host_route
            ):
                for slot in self.buckets.pop(key):
                    A, B, LB, RB = self.jobs.pop(slot)
                    if self._host_pool is not None:
                        self._host_submit(
                            slot, A, B, LB, RB, self.job_cells[slot]
                        )
                    else:
                        self._count("host", self.job_cells[slot])
                        self.results[slot] = yama_numpy(
                            A, B, LB, RB, sp=self.sp
                        )
                self.bucket_cells.pop(key, None)
            else:
                self._flush(key)
        if self._host_pool is not None:
            self._host_flush()  # partial chunk
        timing = self.timing
        if timing:
            import time as _t

            print(
                f"[MZ_TIME] pack={self._pack_s:.4f} "
                f"dispatch={self._disp_s:.4f}",
                flush=True,
            )
            t0 = _t.perf_counter()
            for _, out in self.pending:
                jax.block_until_ready(out)
            t1 = _t.perf_counter()
        # one D2H per group of up to 8 launches: one jit variant per
        # arity, and chromosome-scale runs can have dozens of launches
        outs_np = []
        for i in range(0, len(self.pending), 8):
            grp = [out for _, out in self.pending[i : i + 8]]
            if len(grp) == 1:
                outs_np.append(np.asarray(grp[0]))
                continue
            flat = np.asarray(_fetch_concat(*grp))
            off = 0
            for out in grp:
                nel = int(np.prod(out.shape))
                outs_np.append(flat[off : off + nel].reshape(out.shape))
                off += nel
        if timing:
            t2 = _t.perf_counter()
            print(
                f"[MZ_TIME] device-sync={t1 - t0:.4f} d2h={t2 - t1:.4f} "
                f"launches={[len(p) for p, _ in self.pending]}",
                flush=True,
            )
            _t0 = _t.perf_counter()
        for (slots, _), out_np in zip(self.pending, outs_np):
            _replay_payload(out_np, slots, self.jobs, self.results, pop=True)
        if timing:
            print(
                f"[MZ_TIME] replay={_t.perf_counter() - _t0:.4f}",
                flush=True,
            )
        self.pending = []
        # drain the host DP lane (it has been computing in the shadow of
        # planning and of the device fetch above)
        if self._host_futs:
            from ..yama import YamaError

            if timing:
                _tl = _t.perf_counter()
            futs, self._host_futs = self._host_futs, []
            for chunk, outs, f in futs:
                try:
                    nedits = f.result()  # re-raises worker exceptions
                except ValueError as e:
                    raise YamaError(str(e))
                for (slot, *_), out, ne in zip(chunk, outs, nedits):
                    self.results[slot] = out[:ne]
            if timing:
                print(
                    f"[MZ_TIME] lane-wait={_t.perf_counter() - _tl:.4f} "
                    f"lane-busy={self._lane_busy_s:.4f} "
                    f"jobs={self.counts['host_jobs']} "
                    f"cells={self.counts['host_cells']}",
                    flush=True,
                )
        if self._host_pool is not None:
            self._host_pool.shutdown(wait=False)
        with _counts_lock:
            for k, v in self.counts.items():
                _counts[k] += v
        self.counts = dict.fromkeys(_COUNT_KEYS, 0)
        return [self.results[i] for i in range(self.n)]


def yama_batch_packed(jobs, sp: sc.ScoreParams | None = None,
                      core: str = "cuda", host_threads: int | None = None,
                      host_route: int | None = None):
    """Batched DP over (A, B, LB, RB) jobs through the device core.

    Jobs whose bands are wider than the widest rung fall back to the
    exact host oracle. Results are merged column matrices in input
    order, bit-identical to yama_numpy. (One-shot use of
    PackedDPStream; the one-shot lane cap keeps the host lane to what it
    can drain in the shadow of the device.)"""
    st = PackedDPStream(
        sp=sp,
        host_lane_cells=int(
            _os.environ.get("MZ_HOST_LANE_CELLS", "8000000")
        ),
        autoflush=False,
        core=core,
        host_threads=host_threads,
        host_route=host_route,
    )
    for j in jobs:
        st.submit(j)
    return st.finish()


def packed_batch_fn(core: str):
    """batch_fn for multiz._DeferredDP over the given core, with the
    streaming protocol marker (``stream_cls``)."""
    fn = functools.partial(yama_batch_packed, core=core)
    fn.stream_cls = functools.partial(PackedDPStream, core=core)
    return fn


# streaming protocol marker for multiz._DeferredDP
yama_batch_packed.stream_cls = PackedDPStream


def _replay_payload(out_np, slots, jobs, results, pop: bool = False):
    """Replay payload rows ([op count LE32] + 2-bit ops, newest-first)
    into merged column matrices: row i belongs to job ``slots[i]``;
    results[slot] receives it. With ``pop``, each job is dropped after
    replay so a long stream does not hold every operand alive."""
    from ..yama import YamaError, _mzcore, _replay

    for i, slot in enumerate(slots):
        A, B, _, _ = jobs.pop(slot) if pop else jobs[slot]
        ne = int(out_np[i, :4].view("<u4")[0])
        if ne == 0xFFFFFFFF:
            raise YamaError("Error generating edit script.")
        pk = out_np[i, 4 : 4 + (ne + 3) // 4]
        script_rev = (
            (pk[:, None] >> (np.arange(4, dtype=np.uint8) * 2)) & 3
        ).astype(np.uint8).reshape(-1)[:ne]
        M, K = A.shape
        N, L = B.shape
        if _mzcore is not None:
            merged = np.empty((ne, K + L), dtype=np.uint8)
            try:
                _mzcore.replay_into(
                    np.ascontiguousarray(script_rev), ne, True,
                    np.ascontiguousarray(A), M, K,
                    np.ascontiguousarray(B), N, L, merged,
                )
            except ValueError as e:
                raise YamaError(str(e))
            results[slot] = merged
        else:
            results[slot] = _replay(script_rev[::-1].copy(), A, B)


@jax.jit
def _fetch_concat(*outs):
    """Concatenate per-launch result payloads into one D2H transfer."""
    return jnp.concatenate([o.reshape(-1) for o in outs])
