"""Native host runtime (_mzcore) vs pure-NumPy equivalence."""

import numpy as np
import pytest

from multiz_jax import scores as sc
from multiz_jax import yama as Y
from multiz_jax.native import load
from multiz_jax.ops.synth import synth_jobs


@pytest.fixture(scope="module")
def mz():
    mod = load()
    if mod is None:
        pytest.skip("native module unavailable (no g++?)")
    return mod


def _pure_colstats(X):
    ncol, nrow = X.shape
    dash = X == Y.DASH
    ndash = np.zeros(ncol + 1, dtype=np.int32)
    ndash[1:] = dash.sum(axis=1)
    nond = np.zeros(ncol + 1, dtype=np.int32)
    nond[1:] = nrow - ndash[1:]
    cats = sc.BYTE2CAT[X]
    hist = np.zeros((ncol + 1, sc.NCAT), dtype=np.int32)
    for c in range(sc.NCAT):
        hist[1:, c] = (cats == c).sum(axis=1)
    pair = np.zeros((ncol + 1, 4), dtype=np.int32)
    if ncol >= 2:
        f, s = dash[:-1], dash[1:]
        pair[2:, 0] = (~f & ~s).sum(axis=1)
        pair[2:, 1] = (~f & s).sum(axis=1)
        pair[2:, 2] = (f & ~s).sum(axis=1)
        pair[2:, 3] = (f & s).sum(axis=1)
    if ncol >= 1:
        pair[1, 0] = nond[1]
        pair[1, 1] = ndash[1]
    return hist, nond, ndash, pair


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colstats(mz, seed):
    rng = np.random.default_rng(seed)
    ncol, nrow = int(rng.integers(1, 200)), int(rng.integers(1, 8))
    X = rng.choice(
        np.frombuffer(b"ACGTacgtNn-", dtype=np.uint8), size=(ncol, nrow)
    )
    hist = np.zeros((ncol + 1, sc.NCAT), dtype=np.int32)
    nond = np.zeros(ncol + 1, dtype=np.int32)
    ndash = np.zeros(ncol + 1, dtype=np.int32)
    pair = np.zeros((ncol + 1, 4), dtype=np.int32)
    mz.colstats_into(
        np.ascontiguousarray(X), ncol, nrow, sc.BYTE2CAT,
        hist, nond, ndash, pair,
    )
    h, n0, n1, pr = _pure_colstats(X)
    np.testing.assert_array_equal(hist, h)
    np.testing.assert_array_equal(nond, n0)
    np.testing.assert_array_equal(ndash, n1)
    np.testing.assert_array_equal(pair, pr)


def test_replay_roundtrip(mz):
    rng = np.random.default_rng(7)
    for _ in range(10):
        M, K = int(rng.integers(1, 40)), int(rng.integers(1, 4))
        N, L = int(rng.integers(1, 40)), int(rng.integers(1, 4))
        A = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(M, K))
        B = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(N, L))
        # random valid script consuming A and B exactly
        ops = [Y.FLAG_D] * M + [Y.FLAG_I] * N
        rng.shuffle(ops)
        script = np.asarray(ops, dtype=np.uint8)
        out = np.empty((len(ops), K + L), dtype=np.uint8)
        mz.replay_into(script, len(ops), False, A, M, K, B, N, L, out)
        pure = np.full((len(ops), K + L), Y.DASH, dtype=np.uint8)
        ai = bi = 0
        for t, op in enumerate(ops):
            if op != Y.FLAG_I:
                pure[t, :K] = A[ai]
                ai += 1
            if op != Y.FLAG_D:
                pure[t, K:] = B[bi]
                bi += 1
        np.testing.assert_array_equal(out, pure)


def test_replay_bad_script_raises(mz):
    A = np.full((2, 1), ord("A"), np.uint8)
    B = np.full((2, 1), ord("C"), np.uint8)
    script = np.asarray([Y.FLAG_D] * 4, dtype=np.uint8)  # over-consumes A
    out = np.empty((4, 2), dtype=np.uint8)
    with pytest.raises(ValueError):
        mz.replay_into(script, 4, False, A, 2, 1, B, 2, 1, out)


def test_yama_large_band(mz):
    """50kb x 50kb at radius 30: O(band) traceback memory (mz_yama.c:60-77),
    not (M+1)*(N+1) — this problem was refused before the band tback."""
    rng = np.random.default_rng(3)
    M = N = 50_000
    A = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(M, 1))
    B = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(N, 1))
    i = np.arange(M + 1, dtype=np.int64)
    LB = np.maximum(0, i - 30)
    RB = np.minimum(N, i + 30)
    RB[M] = N
    out = Y.yama_numpy(A, B, LB, RB)
    assert max(M, N) <= out.shape[0] <= M + N
    # the merged matrix must project back to the inputs exactly
    np.testing.assert_array_equal(out[out[:, 0] != Y.DASH, 0], A[:, 0])
    np.testing.assert_array_equal(out[out[:, 1] != Y.DASH, 1], B[:, 0])


def test_yama_oversized_raises(mz):
    """The too-large guard must raise cleanly (with the GIL held)."""
    M = N = 300_000  # full band: ~9e10 flag cells > the 2^36 cap
    A = np.full((M, 1), ord("A"), np.uint8)
    B = np.full((N, 1), ord("C"), np.uint8)
    LB = np.zeros(M + 1, dtype=np.int64)
    RB = np.full(M + 1, N, dtype=np.int64)
    with pytest.raises(Y.YamaError, match="too large"):
        Y.yama_numpy(A, B, LB, RB)


def test_yama_native_vs_pure(mz, monkeypatch):
    """Full DP: force pure path and diff against the native-backed path."""
    jobs = synth_jobs(8, m_lo=20, m_hi=80, radius=10, seed=13)
    native_outs = [Y.yama_numpy(*j) for j in jobs]
    monkeypatch.setattr(Y, "_mzcore", None)
    pure_outs = [Y.yama_numpy(*j) for j in jobs]
    for a, b in zip(native_outs, pure_outs):
        np.testing.assert_array_equal(a, b)
