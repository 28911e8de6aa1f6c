"""The "yama" DP: banded alignment of two alignments (align-two-alignments).

Re-derivation of the reference kernel ``mz_yama.c:50-320`` in a form that
vectorizes on an accelerator. The reference spends O(K*L) work per DP cell adjusting
Altschul quasi-natural gap-open counts (mz_yama.c:123-137,174-187,211-225)
and summing sum-of-pairs substitution scores (mz_yama.c:199-201). Both
collapse to bilinear forms of per-column statistics:

  * substitution:  SUB[m,n] = histA[m] . S6 . histB[n]   (6-category base
    histograms per alignment column)
  * gap corrections: products of per-column dash counts and adjacent-column
    dash-pattern pair counts (4 categories per column pair), because
    GAP(s,t,u,v) factors over (s,u) from A and (t,v) from B
    (mz_scores.c:56-80).

This module holds the exact integer NumPy implementation (the oracle and the
host fallback); ``multiz_jax.ops.yama_jax`` implements the same recurrence as
a jitted wavefront for device execution. Tie-breaking (C >= D > I preference,
mz_yama.c:138-154,189-198,226-235) and traceback-start choice
(mz_yama.c:262-267) are replicated bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import scores as sc

try:  # optional native fast path (see native/mzcore.cpp)
    from .native import load as _load_native

    _mzcore = _load_native()
except Exception:
    _mzcore = None

DASH = ord("-")

# Hugely negative but away from the underflow threshold (mz_yama.c:29).
MININT = -(2**30)

FLAG_C = 0
FLAG_I = 1
FLAG_D = 2
SELECT_CID = FLAG_I | FLAG_D | FLAG_C  # == 3


class YamaError(Exception):
    pass


@dataclass
class ColStats:
    """Per-column statistics of one column-major alignment (ncol, nrow).

    All arrays are 1-indexed by column (index 0 unused) to mirror the C
    code's 1-based columns.
    """

    nrow: int
    ncol: int
    ndash: np.ndarray  # (ncol+1,) dashes per column
    nond: np.ndarray  # (ncol+1,) non-dashes per column
    hist: np.ndarray  # (ncol+1, 6) category histogram per column
    # pair[i, (first<<1)|second] = #rows with given dash pattern in
    # columns (i-1, i); pair[1] has first-bit forced to 0.
    pair: np.ndarray  # (ncol+1, 4)


def column_stats(X: np.ndarray) -> ColStats:
    """Compute ColStats for X of shape (ncol, nrow), uint8 text bytes."""
    ncol, nrow = X.shape
    if _mzcore is not None:
        hist = np.zeros((ncol + 1, sc.NCAT), dtype=np.int32)
        nond = np.zeros(ncol + 1, dtype=np.int32)
        ndash = np.zeros(ncol + 1, dtype=np.int32)
        pair = np.zeros((ncol + 1, 4), dtype=np.int32)
        _mzcore.colstats_into(
            np.ascontiguousarray(X), ncol, nrow, sc.BYTE2CAT,
            hist, nond, ndash, pair,
        )
        return ColStats(
            nrow=nrow, ncol=ncol, ndash=ndash, nond=nond, hist=hist,
            pair=pair,
        )
    dash = X == DASH
    ndash = np.zeros(ncol + 1, dtype=np.int32)
    ndash[1:] = dash.sum(axis=1)
    nond = np.zeros(ncol + 1, dtype=np.int32)
    nond[1:] = nrow - ndash[1:]
    cats = sc.BYTE2CAT[X]  # (ncol, nrow)
    hist = np.zeros((ncol + 1, sc.NCAT), dtype=np.int32)
    for c in range(sc.NCAT):
        hist[1:, c] = (cats == c).sum(axis=1)
    pair = np.zeros((ncol + 1, 4), dtype=np.int32)
    if ncol >= 2:
        f = dash[:-1]  # first column of the pair
        s = dash[1:]  # second column
        pair[2:, 0] = (~f & ~s).sum(axis=1)
        pair[2:, 1] = (~f & s).sum(axis=1)
        pair[2:, 2] = (f & ~s).sum(axis=1)
        pair[2:, 3] = (f & s).sum(axis=1)
    if ncol >= 1:
        # first-bit forced 0 (used for I-node at col==1, mz_yama.c:128-129)
        pair[1, 0] = nond[1]
        pair[1, 1] = ndash[1]
    return ColStats(
        nrow=nrow, ncol=ncol, ndash=ndash, nond=nond, hist=hist, pair=pair
    )


def _check_band(LB: np.ndarray, RB: np.ndarray, M: int, N: int) -> None:
    """Entry sanity checks of yama (mz_yama.c:58-71)."""
    if LB[0] != 0 or RB[M] != N:
        raise YamaError(f"LB and RB not terminated properly: {LB[0]} {RB[M]} {N}")
    w = RB[: M + 1] - LB[: M + 1]
    if np.any(w < min(N, 10)):
        r = int(np.argmax(w < min(N, 10)))
        raise YamaError(f"RB[{r}] - LB[{r}] < {min(N, 10)}")
    if np.any(np.diff(LB[: M + 1]) < 0):
        raise YamaError("LB not monotonic")
    if np.any(np.diff(RB[: M + 1]) < 0):
        raise YamaError("RB not monotonic")


def yama_numpy(
    A: np.ndarray,
    B: np.ndarray,
    LB: np.ndarray,
    RB: np.ndarray,
    sp: sc.ScoreParams | None = None,
) -> np.ndarray:
    """Exact integer port of yama (mz_yama.c:50-320).

    A: (M, K) uint8 column-major alignment (A[i] is alignment column i+1).
    B: (N, L) uint8. LB/RB: (M+1,) int band bounds over columns of B.
    Returns the merged column-major alignment (M_new, K+L) uint8.

    Dispatches to the native C++ DP (mzcore.yama_into) when available;
    the pure-NumPy implementation below is the oracle and the
    MULTIZ_NO_NATIVE=1 fallback — both bit-identical.
    """
    if sp is None:
        sp = sc.current
    M, K = A.shape
    N, L = B.shape
    LB = np.asarray(LB, dtype=np.int64)
    RB = np.asarray(RB, dtype=np.int64)

    if _mzcore is not None and hasattr(_mzcore, "yama_into") and M >= 1:
        # band validation happens inside yama_into (same checks as
        # _check_band, mz_yama.c:58-71) — no second pass here
        out = np.empty((M + N, K + L), dtype=np.uint8)
        try:
            nedit = _mzcore.yama_into(
                np.ascontiguousarray(A), M, K,
                np.ascontiguousarray(B), N, L,
                np.ascontiguousarray(LB[: M + 1]),
                np.ascontiguousarray(RB[: M + 1]),
                np.ascontiguousarray(sp.ss_cat.astype(np.int32)),
                sc.BYTE2CAT, int(sp.gap_open), int(sp.gap_extend), out,
            )
            # copy: results are retained pipeline-wide; a view would pin
            # the full worst-case (M+N, K+L) backing buffer.
            return out[:nedit].copy()
        except ValueError as e:
            raise YamaError(str(e))

    _check_band(LB, RB, M, N)
    go = int(sp.gap_open)
    ge = int(sp.gap_extend)

    sa = column_stats(A)
    sb = column_stats(B)
    # Substitution bilinear form SUB[m, n] = histA[m] . ss . histB[n],
    # projected through B once: sbp[n] = ss @ histB[n]. Materializing
    # the dense (M+1, N+1) product would cost 20GB at 50kb x 50kb; the
    # DP only ever reads the band of each row (computed per row below).
    sbp = sb.hist.astype(np.int64) @ sp.ss_cat.astype(np.int64).T  # (N+1, 6)
    histA64 = sa.hist.astype(np.int64)  # (M+1, 6)

    b0 = sb.nond.astype(np.int64)  # (N+1,)
    b1 = sb.ndash.astype(np.int64)
    pb = sb.pair.astype(np.int64)  # (N+1, 4)
    a0 = sa.nond.astype(np.int64)  # (M+1,)
    a1 = sa.ndash.astype(np.int64)
    pa = sa.pair.astype(np.int64)  # (M+1, 4)

    cols = np.arange(N + 1, dtype=np.int64)

    # dp state across rows (persistent, replicating stale-cell semantics of
    # the single rolling dp array, mz_yama.c:82-94).
    dpC = np.full(N + 1, MININT, dtype=np.int64)
    dpD = np.full(N + 1, MININT, dtype=np.int64)
    dpI = np.full(N + 1, MININT, dtype=np.int64)
    dpC[0] = dpD[0] = dpI[0] = 0
    r0 = int(RB[0])
    if r0 >= 1:
        # row-0 I chain: free end-gap? No: charged extension only.
        dpI[1 : r0 + 1] = -np.cumsum(b0[1 : r0 + 1]) * K * ge

    # Band-sized traceback storage, exactly like the reference's
    # tback_size = sum over rows of RB-LB+1 (mz_yama.c:60-77) and the
    # native path (mzcore.cpp:302-313): a 50kb x 50kb R=30 problem
    # needs ~14MB of flags, not the (M+1)*(N+1) = 2.5GB dense matrix.
    widths = (RB[: M + 1] - LB[: M + 1] + 1).astype(np.int64)
    toff = np.zeros(M + 1, dtype=np.int64)
    toff[1:] = np.cumsum(widths[:-1])
    flags = np.zeros(int(widths.sum()), dtype=np.uint8)
    flags[toff[0] + 1 : toff[0] + r0 + 1] = FLAG_I << 4

    lastC = lastD = lastI = MININT  # running values at (M, N) after the loop

    for row in range(1, M + 1):
        lb = int(LB[row])
        rb = int(RB[row])
        lbm1 = int(LB[row - 1])
        lbm2 = int(LB[row - 2]) if row > 1 else 0
        w = rb - lb + 1
        cs = cols[lb : rb + 1]  # absolute columns in this row's band

        # ---------- D node (vertical), always computed ----------
        xs = dpC[lb : rb + 1].copy()
        ys = dpD[lb : rb + 1].copy()
        zs = dpI[lb : rb + 1].copy()
        inner = (cs > 0) & (cs < N)  # no corrections for end-gaps
        if row > 1:
            xD = go * (pa[row, 0] * b0[cs] + pa[row, 2] * L)
            yD = np.full(w, go * pa[row, 2] * L, dtype=np.int64)
            xs = xs - np.where(inner & (cs > lbm2), xD, 0)
            ys = ys - np.where(inner, yD, 0)
        zD = go * a0[row] * L
        zs = zs - np.where(inner & (cs > lbm1), zD, 0)
        pickC = (xs >= ys) & (xs >= zs)
        pickD = ~pickC & (ys > zs)
        D_row = np.where(pickC, xs, np.where(pickD, ys, zs)) - a0[row] * L * ge
        flag_d = np.where(pickC, FLAG_C, np.where(pickD, FLAG_D, FLAG_I)).astype(
            np.uint8
        )

        # ---------- C node (diagonal) ----------
        # diag values: dp[col-1] pre-update; at col==lb use the C rule.
        diagC = np.full(w, MININT, dtype=np.int64)
        diagD = np.full(w, MININT, dtype=np.int64)
        diagI = np.full(w, MININT, dtype=np.int64)
        if lb >= 1:
            diagC[:] = dpC[lb - 1 : rb]
            diagD[:] = dpD[lb - 1 : rb]
            diagI[:] = dpI[lb - 1 : rb]
            if lbm1 > lb - 1:  # mz_yama.c:101-106
                diagC[0] = diagD[0] = diagI[0] = MININT
        else:
            diagC[1:] = dpC[lb : rb]
            diagD[1:] = dpD[lb : rb]
            diagI[1:] = dpI[lb : rb]
        xs = diagC.copy()
        ys = diagD.copy()
        zs = diagI.copy()
        gt1 = cs > 1  # corrections only when col > 1 (mz_yama.c:173)
        if row > 1:
            xC = go * (
                pa[row, 0] * pb[cs, 1]
                + pa[row, 1] * (pb[cs, 0] + pb[cs, 2])
                + pa[row, 2] * (pb[cs, 1] + pb[cs, 3])
                + pa[row, 3] * pb[cs, 2]
            )
            yC = go * (pa[row, 1] * b0[cs] + pa[row, 2] * b1[cs] + pa[row, 3] * b0[cs])
            xs = xs - np.where(gt1 & (cs > lbm2 + 1), xC, 0)
            ys = ys - np.where(gt1, yC, 0)
        zC = go * (a0[row] * (pb[cs, 1] + pb[cs, 3]) + a1[row] * pb[cs, 2])
        zs = zs - np.where(gt1 & (cs > lbm1 + 1), zC, 0)
        pickC = (xs >= ys) & (xs >= zs)
        pickD = ~pickC & (ys > zs)
        C_row = np.where(pickC, xs, np.where(pickD, ys, zs)) + sbp[cs] @ histA64[row]
        flag_c = np.where(pickC, FLAG_C, np.where(pickD, FLAG_D, FLAG_I)).astype(
            np.uint8
        )
        reach = cs > lbm1  # C node exists only when col > LB[row-1]
        C_row = np.where(reach, C_row, MININT)
        flag_c = np.where(reach, flag_c, 0).astype(np.uint8)

        # ---------- I node (horizontal), sequential chain ----------
        # candidates: x=C[row,col-1]-xI, y=D[row,col-1]-yI, z=I[row,col-1]-zI
        I_row = np.full(w, MININT, dtype=np.int64)
        flag_i = np.zeros(w, dtype=np.uint8)
        if row < M:
            xI = go * (a0[row] * (pb[cs, 0] + pb[cs, 2]) + a1[row] * pb[cs, 2])
            yI = go * K * b0[cs]
            zI = go * K * pb[cs, 2]
        else:
            xI = yI = zI = np.zeros(w, dtype=np.int64)
        xmask = cs > lbm1 + 1
        zmask = cs > lb + 1
        ext = b0[cs] * K * ge
        Iprev = MININT
        for k in range(w):
            c = lb + k
            if c <= lb:  # col == LB[row]: I not computed
                Iprev = MININT
                continue
            x = C_row[k - 1] - (xI[k] if xmask[k] else 0)
            y = D_row[k - 1] - yI[k]
            z = Iprev - (zI[k] if zmask[k] else 0)
            if x >= y and x >= z:
                val, fl = x, FLAG_C
            elif y > z:
                val, fl = y, FLAG_D
            else:
                val, fl = z, FLAG_I
            val -= ext[k]
            I_row[k] = val
            flag_i[k] = fl
            Iprev = val

        flags[toff[row] : toff[row] + w] = flag_c | (flag_d << 2) | (flag_i << 4)
        dpC[lb : rb + 1] = C_row
        dpD[lb : rb + 1] = D_row
        dpI[lb : rb + 1] = I_row
        lastC, lastD, lastI = int(C_row[-1]), int(D_row[-1]), int(I_row[-1])

    if M == 0:
        lastC = lastD = lastI = MININT  # mz_yama.c:96 before an empty loop

    script = _traceback_banded(flags, toff, LB, RB, M, N, lastC, lastD, lastI)
    return _replay(script, A, B)


def _traceback_banded(
    flags: np.ndarray,
    toff: np.ndarray,
    LB: np.ndarray,
    RB: np.ndarray,
    M: int,
    N: int,
    C: int,
    D: int,
    I: int,
) -> np.ndarray:
    """Edit-script extraction over band-local flag storage
    (mz_yama.c:257-291 with the trow addressing of mz_yama.c:77-91).
    A walk leaving the band means a malformed script (the native path
    treats it the same way, mzcore.cpp:425-427). Ops oldest-first."""
    if C >= D and C >= I:
        node = FLAG_C
    elif D >= I:
        node = FLAG_D
    else:
        node = FLAG_I
    row, col = M, N
    script = np.empty(M + N, dtype=np.uint8)
    nedit = 0
    while row > 0 or col > 0:
        if row < 0 or col < 0 or col < LB[row] or col > RB[row]:
            raise YamaError("Error generating edit script.")
        st = flags[toff[row] + col - LB[row]]
        script[nedit] = node
        nedit += 1
        if node == FLAG_I:
            col -= 1
            node = st >> 4
        elif node == FLAG_D:
            row -= 1
            node = (st >> 2) & SELECT_CID
        elif node == FLAG_C:
            row -= 1
            col -= 1
            node = st & SELECT_CID
        else:
            raise YamaError("illegal node type in traceback")
    return script[:nedit][::-1].copy()


def traceback(
    flags: np.ndarray, LB: np.ndarray, M: int, N: int, C: int, D: int, I: int
) -> np.ndarray:
    """Edit-script extraction (mz_yama.c:257-291). Returns ops oldest-first."""
    if _mzcore is not None:
        script = np.empty(M + N, dtype=np.uint8)
        nedit = _mzcore.traceback_into(
            np.ascontiguousarray(flags), int(M), int(N),
            int(C), int(D), int(I), script,
        )
        return script[:nedit][::-1].copy()
    if C >= D and C >= I:
        node = FLAG_C
    elif D >= I:
        node = FLAG_D
    else:
        node = FLAG_I
    row, col = M, N
    script = np.empty(M + N, dtype=np.uint8)
    nedit = 0
    while row > 0 or col > 0:
        if row < 0 or col < 0:
            raise YamaError("Error generating edit script.")
        st = flags[row, col]
        script[nedit] = node
        nedit += 1
        if node == FLAG_I:
            col -= 1
            node = st >> 4
        elif node == FLAG_D:
            row -= 1
            node = (st >> 2) & SELECT_CID
        elif node == FLAG_C:
            row -= 1
            col -= 1
            node = st & SELECT_CID
        else:
            raise YamaError("illegal node type in traceback")
    return script[:nedit][::-1].copy()


def _replay(script: np.ndarray, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Rebuild the merged column matrix from the edit script
    (mz_yama.c:294-309), vectorized."""
    M, K = A.shape
    N, L = B.shape
    n = script.shape[0]
    if _mzcore is not None:
        out = np.empty((n, K + L), dtype=np.uint8)
        try:
            _mzcore.replay_into(
                np.ascontiguousarray(script), n, False,
                np.ascontiguousarray(A), M, K,
                np.ascontiguousarray(B), N, L, out,
            )
        except ValueError as e:
            raise YamaError(str(e))
        return out
    out = np.full((n, K + L), DASH, dtype=np.uint8)
    useA = script != FLAG_I  # C or D consume a column of A
    useB = script != FLAG_D  # C or I consume a column of B
    ai = np.cumsum(useA) - 1  # index into A for rows where useA
    bi = np.cumsum(useB) - 1
    if int(useA.sum()) != M or int(useB.sum()) != N:
        raise YamaError("new_align: script does not consume A and B exactly")
    out[useA, :K] = A[ai[useA]]
    out[useB, K:] = B[bi[useB]]
    return out
