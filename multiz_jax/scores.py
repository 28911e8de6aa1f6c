"""Substitution + quasi-natural gap scoring as dense arrays.

Re-design of the reference scoring layer (``mz_scores.c:9-152``):
the 128x128 ``ss`` table and 16-entry ``gop`` table become NumPy arrays used
for vectorized block scoring on host, and a compact 6-category matrix
(A/C/G/T/dash/other) is derived for device kernels, where per-column base
histograms turn the K*L sum-of-pairs substitution loop into a bilinear form
(see mz_yama.c:199-201 and the histogram trick in multi_util.c:1152-1214).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

try:  # native sum-of-pairs scorer (see native/mzcore.cpp score_range)
    from .native import load as _load_native

    _nat = _load_native()
    _mzcore_score = getattr(_nat, "score_range", None) if _nat else None
except Exception:
    _mzcore_score = None

DASH = ord("-")

# HOX70 (human-rodent default) and HOX85 (mouse-rat), mz_scores.c:9-29.
HOX70 = np.array(
    [
        [91, -114, -31, -123],
        [-114, 100, -125, -31],
        [-31, -125, 100, -114],
        [-123, -31, -114, 91],
    ],
    dtype=np.int32,
)
HOX85 = np.array(
    [
        [86, -135, -68, -157],
        [-135, 100, -148, -68],
        [-68, -148, 100, -135],
        [-157, -68, -135, 86],
    ],
    dtype=np.int32,
)

UNSPECIFIED = -100  # mz_scores.c:29

# Category codes for the compact device-side representation.
CAT_A, CAT_C, CAT_G, CAT_T, CAT_DASH, CAT_OTHER = 0, 1, 2, 3, 4, 5
NCAT = 6

# byte -> category lookup (A/a C/c G/g T/t, '-', everything else).
BYTE2CAT = np.full(256, CAT_OTHER, dtype=np.int8)
for _ch, _cat in (("A", CAT_A), ("C", CAT_C), ("G", CAT_G), ("T", CAT_T)):
    BYTE2CAT[ord(_ch)] = _cat
    BYTE2CAT[ord(_ch.lower())] = _cat
BYTE2CAT[DASH] = CAT_DASH


@dataclass(frozen=True)
class ScoreParams:
    """One initialized scoring scheme (ss/gop/gap_open/gap_extend)."""

    ss: np.ndarray  # (128, 128) int32
    gop: np.ndarray  # (16,) int32, indexed by (s<<3)|(t<<2)|(u<<1)|v
    ss_cat: np.ndarray  # (6, 6) int32 category-level substitution scores
    gap_open: int
    gap_extend: int

    def gap2(self, a: np.ndarray, b: np.ndarray, c: np.ndarray, d: np.ndarray):
        """Vectorized GAP2 macro (mz_scores.h:15): dash-pattern lookup."""
        idx = (
            ((a == DASH).astype(np.int32) << 3)
            | ((b == DASH).astype(np.int32) << 2)
            | ((c == DASH).astype(np.int32) << 1)
            | (d == DASH).astype(np.int32)
        )
        return self.gop[idx]


def _build(sub4: np.ndarray, filler: int, gap_op: int, gap_ex: int) -> ScoreParams:
    """init_scores (mz_scores.c:34-81)."""
    ss = np.full((128, 128), filler, dtype=np.int32)
    chars = "ACGT"
    for i, ci in enumerate(chars):
        for j, cj in enumerate(chars):
            for a in (ord(ci), ord(ci.lower())):
                for b in (ord(cj), ord(cj.lower())):
                    ss[a, b] = sub4[i, j]
    ss[DASH, :] = -gap_ex
    ss[:, DASH] = -gap_ex
    ss[DASH, DASH] = 0

    gop = np.zeros(16, dtype=np.int32)
    # The six gap-open configurations (mz_scores.c:61-79), as (s,t,u,v) bits.
    for s, t, u, v in [
        (0, 0, 0, 1),
        (0, 0, 1, 0),
        (0, 1, 1, 0),
        (1, 0, 0, 1),
        (1, 1, 0, 1),
        (1, 1, 1, 0),
    ]:
        gop[(s << 3) | (t << 2) | (u << 1) | v] = gap_op

    # Category-level matrix: rows/cols A,C,G,T,dash,other.
    ss_cat = np.empty((NCAT, NCAT), dtype=np.int32)
    reps = [ord("A"), ord("C"), ord("G"), ord("T"), DASH, ord("N")]
    for i, a in enumerate(reps):
        for j, b in enumerate(reps):
            ss_cat[i, j] = ss[a, b]
    return ScoreParams(
        ss=ss, gop=gop, ss_cat=ss_cat, gap_open=gap_op, gap_extend=gap_ex
    )


_SS70 = _build(HOX70, UNSPECIFIED, 400, 30)
_SS85 = _build(HOX85, UNSPECIFIED, 600, 50)

# Module-level current scheme, mirroring the reference's globals
# (mz_scores.c:94-122). init_scores70() is the default everywhere.
current: ScoreParams = _SS70


def init_scores70() -> ScoreParams:
    global current
    current = _SS70
    return current


def init_scores85() -> ScoreParams:
    global current
    current = _SS85
    return current


def score_range_texts(
    texts, start: int, size: int, sp: ScoreParams | None = None
) -> float:
    """Sum-of-pairs score of columns [start, start+size) (mz_scores.c:124-152).

    ``texts``: iterable of uint8 row arrays (all the same length).
    Includes the reference's quirk that the gap term for column ``i`` reaches
    back to absolute column ``i-1`` even when i == start > 0.
    """
    if sp is None:
        sp = current
    rows = list(texts)
    n = len(rows)
    if n == 0:
        return 0.0
    text_size = rows[0].shape[0]
    if start < 0 or size <= 0 or start + size > text_size:
        raise ValueError(
            f"score_range: start={start}, size={size}, textSize={text_size}"
        )
    if _mzcore_score is not None and n >= 2:
        T = np.stack(rows, axis=0)  # np.stack output is C-contiguous
        return float(
            _mzcore_score(T, n, text_size, start, size, sp.ss, sp.gop)
        )
    lo = max(start, 1)  # gap terms exist only for absolute column i > 0
    hi = start + size
    total = np.int64(0)
    for i in range(n):
        ti = rows[i]
        for j in range(i + 1, n):
            tj = rows[j]
            total += sp.ss[ti[start:hi], tj[start:hi]].sum(dtype=np.int64)
            if lo < hi:
                total -= sp.gap2(
                    ti[lo - 1 : hi - 1],
                    tj[lo - 1 : hi - 1],
                    ti[lo:hi],
                    tj[lo:hi],
                ).sum(dtype=np.int64)
    return float(total)


def score_matrix(
    T: np.ndarray, start: int, size: int, sp: ScoreParams | None = None
) -> float:
    """score_range_texts on an already-stacked (n, W) uint8 row matrix
    (skips the per-call np.stack when the caller holds one, e.g.
    preyama.maf_build's merged transpose)."""
    if sp is None:
        sp = current
    n, W = T.shape
    if n < 2:
        return 0.0
    if start < 0 or size <= 0 or start + size > W:
        raise ValueError(
            f"score_range: start={start}, size={size}, textSize={W}"
        )
    if _mzcore_score is not None:
        return float(
            _mzcore_score(
                np.ascontiguousarray(T), n, W, start, size, sp.ss, sp.gop
            )
        )
    return score_range_texts(list(T), start, size, sp=sp)


def score_range(ali, start: int, size: int, sp: ScoreParams | None = None) -> float:
    """mafScoreRange on an Ali block."""
    return score_range_texts(
        (c.text for c in ali.comps), start, size, sp=sp
    )
