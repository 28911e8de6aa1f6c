"""Jitted/batched yama DP in plain JAX — full-row formulation.

The recurrence (mz_yama.c:97-254) has three per-cell nodes: D depends on
the previous row, C on the previous row's diagonal, and I on the previous
column of the same row. Rows are computed as vectors (one ``lax.scan``
step per row); the in-row I chain
``I[c] = prefmax(x[c], y[c], I[c-1] - z[c]) - e[c]`` is solved exactly in
parallel with a prefix-max transform: with P[c] = sum_{lb<k<=c}(z[k]+e[k])
and V[c] = max_pref(x,y)[c] - e[c] + P[c], W[c] = I[c] + P[c] satisfies
W[c] = max(V[c], W[c-1]) — a cummax. The C/D/I tie-breaking preference
(mz_yama.c:138-154) is recovered exactly from (V, W_prev, x<y) in integer
arithmetic.

**Full-row storage.** The device state is the whole dp row in absolute
column coordinates (n_pad+1 lanes). Out-of-band lanes are masked to
MININT after every row, which is exactly the reference's
MININT-initialized full matrix (mz_yama.c:77-94): every read the C code
makes outside the band of the previous row sees MININT, and so does this
kernel. Compared to a band-local window this wastes lanes on out-of-band
columns, but it removes ALL data-dependent gathers from the scan body —
the previous-row diagonal is a static shift-by-one, and the B-side
per-column statistics are consumed in place with no per-row dynamic
slices: the row step is one fused, fully static loop body. This is the
plain core of the device DP (ops/yama_pack.py, core "xla") that the
band-local CUDA kernel is measured against.

All arithmetic is int32, matching the C's ``int``; the prefix-max offsets
accumulate only over in-band columns, so they stay far from overflow.
Traceback also runs on device over the (m_pad+1, n_pad+1) flag matrix;
only the (m_pad+n_pad)-byte edit scripts travel back to host.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import scores as sc
from ..yama import (
    FLAG_C,
    FLAG_D,
    FLAG_I,
    MININT,
    YamaError,
    _check_band,
    _mzcore,
    column_stats,
    _replay,
)

# Sentinel for non-chain cells: below MININT minus any legitimate P-shifted
# value, but well inside int32.
NEG_HUGE = jnp.int32(-(2**30) - (2**29))


def _shift1(v):
    """v shifted right one lane, MININT shifted in (the dp[col-1] read)."""
    return jnp.concatenate([jnp.full(1, MININT, jnp.int32), v[:-1]])


def _yama_core(
    histA,  # (m_pad+1, 6) int32
    a0, a1,  # (m_pad+1,) int32 non-dash / dash counts of A columns
    pa,  # (m_pad+1, 4) int32 pair counts
    sub_right,  # (n_pad+1, 6) int32: ss_cat . histB per B column
    b0, b1,  # (n_pad+1,)
    pb,  # (n_pad+1, 4)
    LB, RB,  # (m_pad+1,) int32
    M, N,  # scalars int32 (actual sizes)
    K, L,  # scalars int32 (row counts; arithmetic only)
    go: int, ge: int, m_pad: int, n_pad: int,
):
    js = jnp.arange(n_pad + 1, dtype=jnp.int32)

    # ---- row 0 init (mz_yama.c:82-94) ----
    dpC = jnp.full(n_pad + 1, MININT, jnp.int32).at[0].set(0)
    dpD = dpC
    chain0 = (js >= 1) & (js <= RB[0])
    i0 = -jnp.cumsum(jnp.where(chain0, b0, 0)) * K * ge
    dpI = jnp.where(chain0, i0, jnp.where(js == 0, 0, MININT)).astype(
        jnp.int32
    )
    flags0 = jnp.where(chain0, jnp.uint8(FLAG_I << 4), jnp.uint8(0))

    def row_step(carry, xs):
        dpC, dpD, dpI = carry
        (row, lb, lbm1, lbm2, rb, ha, a0r, a1r, par) = xs
        row_valid = row <= M
        cw = js  # absolute dp columns
        in_band = (js >= lb) & (js <= rb)
        last_row = row == M

        # previous-row values: direct (up) and one-lane shift (diagonal)
        upC, upD, upI = dpC, dpD, dpI
        diagC = _shift1(dpC)
        diagD = _shift1(dpD)
        diagI = _shift1(dpI)

        # ---------- D node ----------
        xs_ = upC
        ys_ = upD
        zs_ = upI
        inner = (cw > 0) & (cw < N)
        not1 = row > 1
        xD = go * (par[0] * b0 + par[2] * L)
        yD = go * par[2] * L
        xs_ = xs_ - jnp.where(inner & (cw > lbm2) & not1, xD, 0)
        ys_ = ys_ - jnp.where(inner & not1, yD, 0)
        zD = go * a0r * L
        zs_ = zs_ - jnp.where(inner & (cw > lbm1), zD, 0)
        pickC = (xs_ >= ys_) & (xs_ >= zs_)
        pickD = (~pickC) & (ys_ > zs_)
        D_new = (
            jnp.where(pickC, xs_, jnp.where(pickD, ys_, zs_)) - a0r * L * ge
        )
        flag_d = jnp.where(
            pickC, jnp.uint8(FLAG_C),
            jnp.where(pickD, jnp.uint8(FLAG_D), jnp.uint8(FLAG_I)),
        )
        D_row = jnp.where(in_band, D_new, MININT)

        # ---------- C node ----------
        xs_ = diagC
        ys_ = diagD
        zs_ = diagI
        gt1 = cw > 1
        xC = go * (
            par[0] * pb[:, 1]
            + par[1] * (pb[:, 0] + pb[:, 2])
            + par[2] * (pb[:, 1] + pb[:, 3])
            + par[3] * pb[:, 2]
        )
        yC = go * (par[1] * b0 + par[2] * b1 + par[3] * b0)
        zC = go * (a0r * (pb[:, 1] + pb[:, 3]) + a1r * pb[:, 2])
        xs_ = xs_ - jnp.where(gt1 & (cw > lbm2 + 1) & not1, xC, 0)
        ys_ = ys_ - jnp.where(gt1 & not1, yC, 0)
        zs_ = zs_ - jnp.where(gt1 & (cw > lbm1 + 1), zC, 0)
        pickC = (xs_ >= ys_) & (xs_ >= zs_)
        pickD = (~pickC) & (ys_ > zs_)
        sub = (sub_right * ha).sum(axis=1)  # (n_pad+1,), exact int32
        C_new = jnp.where(pickC, xs_, jnp.where(pickD, ys_, zs_)) + sub
        flag_c = jnp.where(
            pickC, jnp.uint8(FLAG_C),
            jnp.where(pickD, jnp.uint8(FLAG_D), jnp.uint8(FLAG_I)),
        )
        reach = cw > lbm1
        C_new = jnp.where(reach, C_new, MININT)
        flag_c = jnp.where(reach, flag_c, jnp.uint8(0))
        C_row = jnp.where(in_band, C_new, MININT)

        # ---------- I node: parallel prefix-max chain ----------
        live = ~last_row
        xI = jnp.where(
            live, go * (a0r * (pb[:, 0] + pb[:, 2]) + a1r * pb[:, 2]), 0
        )
        yI = jnp.where(live, go * K * b0, 0)
        zI = jnp.where(live, go * K * pb[:, 2], 0)
        e = b0 * K * ge
        Cw = _shift1(C_row)
        Dw = _shift1(D_row)
        xv = Cw - jnp.where(cw > lbm1 + 1, xI, 0)
        yv = Dw - yI
        chain = (cw >= lb + 1) & (cw <= rb)
        sz = jnp.where(cw > lb + 1, zI, 0) + e
        P = jnp.cumsum(jnp.where(chain, sz, 0), dtype=jnp.int32)
        from_y = xv < yv
        xy = jnp.maximum(xv, yv)
        V = xy - e + P
        # chain base: cells at or left of lb are never real I candidates
        Vp = jnp.where(cw <= lb, jnp.int32(MININT), V)
        R = lax.cummax(Vp)
        Wprev = jnp.concatenate([jnp.full(1, NEG_HUGE, jnp.int32), R[:-1]])
        zwin = (Wprev > V) | ((Wprev == V) & from_y)
        I_chain = R - P
        flag_i = jnp.where(
            cw <= lb,
            jnp.uint8(0),
            jnp.where(
                zwin, jnp.uint8(FLAG_I),
                jnp.where(~from_y, jnp.uint8(FLAG_C), jnp.uint8(FLAG_D)),
            ),
        )
        I_row = jnp.where(in_band & (cw > lb), I_chain, MININT)

        frow = jnp.where(
            in_band & row_valid,
            flag_c | (flag_d << 2) | (flag_i << 4),
            jnp.uint8(0),
        )
        dpC2 = jnp.where(row_valid, C_row, dpC)
        dpD2 = jnp.where(row_valid, D_row, dpD)
        dpI2 = jnp.where(row_valid, I_row, dpI)
        return (dpC2, dpD2, dpI2), frow

    rows = jnp.arange(1, m_pad + 1, dtype=jnp.int32)
    lbv = LB[1 : m_pad + 1]
    lbm1v = LB[0:m_pad]
    lbm2v = jnp.concatenate([jnp.zeros(1, jnp.int32), LB[: m_pad - 1]])
    rbv = RB[1 : m_pad + 1]
    xs = (
        rows, lbv, lbm1v, lbm2v, rbv,
        histA[1:], a0[1:], a1[1:], pa[1:],
    )
    (dpC, dpD, dpI), frows = lax.scan(
        row_step, (dpC, dpD, dpI), xs
    )
    flags = jnp.concatenate([flags0[None, :], frows], axis=0)
    lastC = dpC[N]
    lastD = dpD[N]
    lastI = dpI[N]
    return flags, lastC, lastD, lastI


SELECT_CID = 3


def _traceback_core(
    flags, LB, RB, M, N, lastC, lastD, lastI, m_pad: int, n_pad: int
):
    """On-device edit-script extraction (mz_yama.c:257-291) over the
    (m_pad+1, n_pad+1) flag matrix: flags[row, col] when (row, col) is in
    band, else 0 (matching the zero-initialized full matrix).

    Returns (script, nedit): script[k] is the k-th op walking BACKWARD
    from (M, N); entries past nedit are 255. Fixed-trip scan so it vmaps
    cleanly over a batch."""
    node0 = jnp.where(
        (lastC >= lastD) & (lastC >= lastI),
        jnp.int32(FLAG_C),
        jnp.where(lastD >= lastI, jnp.int32(FLAG_D), jnp.int32(FLAG_I)),
    )

    def step(carry, _):
        row, col, node, k = carry
        done = (row <= 0) & (col <= 0)
        inb = (col >= LB[row]) & (col <= RB[row])
        jc = jnp.clip(col, 0, n_pad)
        st = jnp.where(inb, flags[row, jc], jnp.uint8(0)).astype(jnp.int32)
        out = jnp.where(done, jnp.int32(-1), node)
        is_i = node == FLAG_I
        is_d = node == FLAG_D
        nrow = jnp.where(is_i, row, row - 1)
        ncol = jnp.where(is_d, col, col - 1)
        nnode = jnp.where(
            is_i, st >> 4,
            jnp.where(is_d, (st >> 2) & SELECT_CID, st & SELECT_CID),
        )
        row2 = jnp.where(done, row, nrow)
        col2 = jnp.where(done, col, ncol)
        node2 = jnp.where(done, node, nnode)
        k2 = jnp.where(done, k, k + 1)
        return (row2, col2, node2, k2), out

    (r, c, n_, k), ops = lax.scan(
        step, (M, N, node0, jnp.int32(0)), None, length=m_pad + n_pad
    )
    script = jnp.where(ops < 0, jnp.uint8(255), ops.astype(jnp.uint8))
    return script, k


@functools.partial(
    jax.jit, static_argnames=("go", "ge", "m_pad", "n_pad")
)
def _yama_device_batch(
    histA, a0, a1, pa, histB, b0, b1, pb, LB, RB, M, N, K, L, ss_cat,
    go: int, ge: int, m_pad: int, n_pad: int,
):
    """vmap over a bucket of same-padded-shape problems. Traceback runs on
    device too: only the (m_pad+n_pad)-byte edit scripts travel to host,
    not the O(m_pad*n_pad) flags."""

    def fn(*args):
        args = list(args)
        args[4] = sub_right(args[4], ss_cat)
        flags, lc, ld, li = _yama_core(
            *args, go=go, ge=ge, m_pad=m_pad, n_pad=n_pad
        )
        lb, rb = args[8], args[9]
        m, n = args[10], args[11]
        script, nedit = _traceback_core(
            flags, lb, rb, m, n, lc, ld, li, m_pad=m_pad, n_pad=n_pad,
        )
        return script, nedit

    return jax.vmap(fn)(
        histA, a0, a1, pa, histB, b0, b1, pb, LB, RB, M, N, K, L
    )


def sub_right(histB, ss_cat):
    """Substitution projection ss_cat . histB per B column (n+1, 6), as an
    elementwise sum so that it stays exact int32 on every backend."""
    return (histB[..., None, :] * ss_cat).sum(axis=-1)


def _prep(X: np.ndarray, pad: int):
    """Pad ColStats arrays of X (ncol, nrow) to ``pad`` rows."""
    st = column_stats(X)
    ncol = st.ncol

    def p(arr):
        shape = list(arr.shape)
        shape[0] = pad
        out = np.zeros(shape, dtype=np.int32)
        out[: ncol + 1] = arr
        return out

    return p(st.hist), p(st.nond), p(st.ndash), p(st.pair), ncol


def _pad_to(n: int) -> int:
    """Pad sizes to limit compilation count: next power of two, >= 16."""
    p = 16
    while p < n:
        p *= 2
    return p


STACK_KEYS = (
    "histA", "a0", "a1", "pa", "histB", "b0", "b1", "pb",
    "LB", "RB", "M", "N", "K", "L",
)


def stack_jobs(jobs, m_pad: int, n_pad: int) -> dict:
    """Stack a list of same-bucket (A, B, LB, RB) problems into the
    batched device operands (dict keyed by STACK_KEYS, jnp arrays).

    With the native host runtime, per-column statistics are written
    straight into the pre-allocated batch buffers (zero-copy packing);
    otherwise the NumPy column_stats path fills them."""
    nb = len(jobs)
    mp, np1 = m_pad + 1, n_pad + 1
    out = {
        "histA": np.zeros((nb, mp, 6), np.int32),
        "a0": np.zeros((nb, mp), np.int32),
        "a1": np.zeros((nb, mp), np.int32),
        "pa": np.zeros((nb, mp, 4), np.int32),
        "histB": np.zeros((nb, np1, 6), np.int32),
        "b0": np.zeros((nb, np1), np.int32),
        "b1": np.zeros((nb, np1), np.int32),
        "pb": np.zeros((nb, np1, 4), np.int32),
        "LB": np.zeros((nb, mp), np.int32),
        "RB": np.zeros((nb, mp), np.int32),
        "M": np.zeros(nb, np.int32),
        "N": np.zeros(nb, np.int32),
        "K": np.zeros(nb, np.int32),
        "L": np.zeros(nb, np.int32),
    }

    def fill(i, side, X, pad):
        ncol, nrow = X.shape
        if _mzcore is not None:
            _mzcore.colstats_into(
                np.ascontiguousarray(X), ncol, nrow, sc.BYTE2CAT,
                out["hist" + side][i], out[side.lower() + "0"][i],
                out[side.lower() + "1"][i], out["p" + side.lower()][i],
            )
        else:
            st = column_stats(X)
            out["hist" + side][i, : ncol + 1] = st.hist
            out[side.lower() + "0"][i, : ncol + 1] = st.nond
            out[side.lower() + "1"][i, : ncol + 1] = st.ndash
            out["p" + side.lower()][i, : ncol + 1] = st.pair

    for i, (A, B, LB, RB) in enumerate(jobs):
        M, K = A.shape
        N, L = B.shape
        fill(i, "A", A, mp)
        fill(i, "B", B, np1)
        out["LB"][i, : M + 1] = LB
        out["RB"][i, : M + 1] = RB
        out["LB"][i, M + 1 :] = LB[M]
        out["RB"][i, M + 1 :] = RB[M]
        out["M"][i] = M
        out["N"][i] = N
        out["K"][i] = K
        out["L"][i] = L
    return {k: jnp.asarray(v) for k, v in out.items()}


def yama_jax(
    A: np.ndarray,
    B: np.ndarray,
    LB: np.ndarray,
    RB: np.ndarray,
    sp: sc.ScoreParams | None = None,
) -> np.ndarray:
    """Drop-in replacement for yama_numpy using the jitted device kernel."""
    return yama_batch([(A, B, LB, RB)], sp=sp)[0]


def yama_batch(jobs, sp: sc.ScoreParams | None = None, mesh=None):
    """Batched DP over a list of (A, B, LB, RB) problems.

    Problems are bucketed by padded shape and executed as one vmapped
    kernel launch per bucket; tracebacks run on device, replay on host.
    Returns merged column matrices in input order.

    With ``mesh`` (a `jax.sharding.Mesh` from `parallel.sharding.make_mesh`)
    each bucket is padded to the device count and sharded over the mesh's
    ``blocks`` axis — the SPMD replacement for the reference's serial
    block loop (multiz.c:68-175)."""
    if sp is None:
        sp = sc.current
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    ss_cat = jnp.asarray(sp.ss_cat)
    buckets = {}
    for idx, (A, B, LB, RB) in enumerate(jobs):
        M, K = A.shape
        N, L = B.shape
        LB = np.asarray(LB, dtype=np.int64)
        RB = np.asarray(RB, dtype=np.int64)
        _check_band(LB, RB, M, N)
        key = (_pad_to(M), _pad_to(N))
        buckets.setdefault(key, []).append(idx)
    results = [None] * len(jobs)
    for (m_pad, n_pad), idxs in buckets.items():
        run_idxs = list(idxs)
        if mesh is not None:
            from ..parallel.sharding import pad_batch

            want = pad_batch(len(idxs), mesh)
            run_idxs = idxs + [idxs[-1]] * (want - len(idxs))
        stacked = stack_jobs([jobs[i] for i in run_idxs], m_pad, n_pad)
        if mesh is not None:
            from ..parallel.sharding import shard_stacked

            stacked = shard_stacked(stacked, mesh)
        scripts, nedits = _yama_device_batch(
            stacked["histA"], stacked["a0"], stacked["a1"], stacked["pa"],
            stacked["histB"], stacked["b0"], stacked["b1"], stacked["pb"],
            stacked["LB"], stacked["RB"],
            stacked["M"], stacked["N"], stacked["K"], stacked["L"],
            ss_cat, go=go, ge=ge, m_pad=m_pad, n_pad=n_pad,
        )
        scripts_np = np.asarray(scripts)
        nedits_np = np.asarray(nedits)
        for slot, idx in enumerate(idxs):
            A, B, _, _ = jobs[idx]
            ne = int(nedits_np[slot])
            if _mzcore is not None:
                # device scripts are newest-first; replay in place
                M, K = A.shape
                N, L = B.shape
                merged = np.empty((ne, K + L), dtype=np.uint8)
                try:
                    _mzcore.replay_into(
                        scripts_np[slot], ne, True,
                        np.ascontiguousarray(A), M, K,
                        np.ascontiguousarray(B), N, L, merged,
                    )
                except ValueError as e:
                    raise YamaError(str(e))
                results[idx] = merged
            else:
                script = scripts_np[slot][:ne][::-1].copy()
                results[idx] = _replay(script, A, B)
    return results
