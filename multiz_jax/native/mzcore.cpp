// Native host runtime for multiz_jax: the hot host-side paths around the
// device DP kernel, as a CPython extension (buffer protocol only — no
// numpy C API, so it builds with just g++ + Python headers).
//
// The reference implements these in C as part of its single address space
// (mz_yama.c:257-313 traceback + rebuild; the per-cell stats gathering is
// implicit in its K*L inner loops). Here they are the host runtime feeding
// the device kernel:
//   * colstats_into — per-column base histograms / dash counts / adjacent
//     dash-pair counts, written straight into the pre-allocated stacked
//     batch operands (zero-copy bucket packing).
//   * traceback_into — edit-script extraction over the flag matrix
//     (mz_yama.c:257-291), for the host oracle path.
//   * replay_into — edit script -> merged (K+L)-row column matrix
//     (mz_yama.c:294-309).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t FLAG_C = 0;
constexpr uint8_t FLAG_I = 1;
constexpr uint8_t FLAG_D = 2;
constexpr uint8_t SELECT_CID = 3;
constexpr uint8_t DASH = '-';

struct Buf {
    Py_buffer view{};
    bool ok = false;
    Buf(PyObject* obj, int flags) { ok = PyObject_GetBuffer(obj, &view, flags) == 0; }
    ~Buf() { if (ok) PyBuffer_Release(&view); }
    uint8_t* u8() const { return static_cast<uint8_t*>(view.buf); }
    int32_t* i32() const { return static_cast<int32_t*>(view.buf); }
    Py_ssize_t len() const { return view.len; }
};

// colstats_into(X, ncol, nrow, cat, hist, nond, ndash, pair)
//   X:    uint8 (ncol, nrow) C-contiguous
//   cat:  int8[256] byte -> category (6 categories)
//   hist: int32 (pad, 6); nond/ndash: int32 (pad,); pair: int32 (pad, 4)
// Rows 1..ncol are written; row 0 and padding are left untouched.
PyObject* colstats_into(PyObject*, PyObject* args) {
    PyObject *xo, *cato, *histo, *nondo, *ndasho, *pairo;
    Py_ssize_t ncol, nrow;
    if (!PyArg_ParseTuple(args, "OnnOOOOO", &xo, &ncol, &nrow, &cato,
                          &histo, &nondo, &ndasho, &pairo))
        return nullptr;
    Buf X(xo, PyBUF_SIMPLE), cat(cato, PyBUF_SIMPLE);
    Buf hist(histo, PyBUF_WRITABLE), nond(nondo, PyBUF_WRITABLE),
        ndash(ndasho, PyBUF_WRITABLE), pair(pairo, PyBUF_WRITABLE);
    if (!X.ok || !cat.ok || !hist.ok || !nond.ok || !ndash.ok || !pair.ok)
        return nullptr;
    if (X.len() < ncol * nrow || cat.len() < 256) {
        PyErr_SetString(PyExc_ValueError, "colstats_into: bad buffer sizes");
        return nullptr;
    }
    const uint8_t* x = X.u8();
    const int8_t* c8 = reinterpret_cast<const int8_t*>(cat.u8());
    int32_t* h = hist.i32();
    int32_t* n0 = nond.i32();
    int32_t* n1 = ndash.i32();
    int32_t* pr = pair.i32();
    for (Py_ssize_t i = 1; i <= ncol; ++i) {
        const uint8_t* col = x + (i - 1) * nrow;
        int32_t hc[6] = {0, 0, 0, 0, 0, 0};
        int32_t dash = 0;
        for (Py_ssize_t r = 0; r < nrow; ++r) {
            uint8_t b = col[r];
            hc[c8[b]] += 1;
            dash += (b == DASH);
        }
        for (int k = 0; k < 6; ++k) h[i * 6 + k] = hc[k];
        n1[i] = dash;
        n0[i] = (int32_t)nrow - dash;
        if (i == 1) {
            pr[4 + 0] = n0[1];
            pr[4 + 1] = n1[1];
            pr[4 + 2] = 0;
            pr[4 + 3] = 0;
        } else {
            const uint8_t* prev = col - nrow;
            int32_t p[4] = {0, 0, 0, 0};
            for (Py_ssize_t r = 0; r < nrow; ++r) {
                int f = prev[r] == DASH;
                int s = col[r] == DASH;
                p[(f << 1) | s] += 1;
            }
            for (int k = 0; k < 4; ++k) pr[i * 4 + k] = p[k];
        }
    }
    Py_RETURN_NONE;
}

// traceback_into(flags, M, N, C, D, I, script_out) -> nedit
//   flags: uint8 (M+1, N+1) C-contiguous; script_out: uint8 (M+N,)
//   Writes ops newest-first (walking back from (M,N)), like the C's
//   script buffer before reversal (mz_yama.c:257-291).
PyObject* traceback_into(PyObject*, PyObject* args) {
    PyObject *fo, *so;
    Py_ssize_t M, N;
    long C, D, I;
    if (!PyArg_ParseTuple(args, "OnnlllO", &fo, &M, &N, &C, &D, &I, &so))
        return nullptr;
    Buf F(fo, PyBUF_SIMPLE), S(so, PyBUF_WRITABLE);
    if (!F.ok || !S.ok) return nullptr;
    if (F.len() < (M + 1) * (N + 1) || S.len() < M + N) {
        PyErr_SetString(PyExc_ValueError, "traceback_into: bad buffer sizes");
        return nullptr;
    }
    const uint8_t* flags = F.u8();
    uint8_t* script = S.u8();
    const Py_ssize_t ld = N + 1;
    uint8_t node;
    if (C >= D && C >= I) node = FLAG_C;
    else if (D >= I) node = FLAG_D;
    else node = FLAG_I;
    Py_ssize_t row = M, col = N, nedit = 0;
    while (row > 0 || col > 0) {
        if (row < 0 || col < 0) {
            PyErr_SetString(PyExc_ValueError, "Error generating edit script.");
            return nullptr;
        }
        uint8_t st = flags[row * ld + col];
        script[nedit++] = node;
        if (node == FLAG_I) {
            col -= 1;
            node = st >> 4;
        } else if (node == FLAG_D) {
            row -= 1;
            node = (st >> 2) & SELECT_CID;
        } else if (node == FLAG_C) {
            row -= 1;
            col -= 1;
            node = st & SELECT_CID;
        } else {
            PyErr_SetString(PyExc_ValueError, "illegal node type in traceback");
            return nullptr;
        }
    }
    return PyLong_FromSsize_t(nedit);
}

// replay_into(script, n, reversed, A, M, K, B, N, L, out)
//   script: uint8 ops; if reversed != 0 the ops are newest-first (walked
//   back-to-front), else oldest-first. A: (M, K) uint8; B: (N, L) uint8;
//   out: (n, K+L) uint8, fully overwritten.
PyObject* replay_into(PyObject*, PyObject* args) {
    PyObject *so, *ao, *bo, *oo;
    Py_ssize_t n, M, K, N, L;
    int reversed_;
    if (!PyArg_ParseTuple(args, "OnpOnnOnnO", &so, &n, &reversed_, &ao, &M,
                          &K, &bo, &N, &L, &oo))
        return nullptr;
    Buf S(so, PyBUF_SIMPLE), A(ao, PyBUF_SIMPLE), B(bo, PyBUF_SIMPLE),
        O(oo, PyBUF_WRITABLE);
    if (!S.ok || !A.ok || !B.ok || !O.ok) return nullptr;
    const Py_ssize_t W = K + L;
    if (S.len() < n || A.len() < M * K || B.len() < N * L ||
        O.len() < n * W) {
        PyErr_SetString(PyExc_ValueError, "replay_into: bad buffer sizes");
        return nullptr;
    }
    const uint8_t* script = S.u8();
    const uint8_t* a = A.u8();
    const uint8_t* b = B.u8();
    uint8_t* out = O.u8();
    Py_ssize_t ai = 0, bi = 0;
    for (Py_ssize_t t = 0; t < n; ++t) {
        uint8_t op = script[reversed_ ? n - 1 - t : t];
        uint8_t* row = out + t * W;
        if (op != FLAG_I) {  // C or D consume a column of A
            if (ai >= M) goto bad;
            std::memcpy(row, a + ai * K, K);
            ++ai;
        } else {
            std::memset(row, DASH, K);
        }
        if (op != FLAG_D) {  // C or I consume a column of B
            if (bi >= N) goto bad;
            std::memcpy(row + K, b + bi * L, L);
            ++bi;
        } else {
            std::memset(row + K, DASH, L);
        }
    }
    if (ai != M || bi != N) goto bad;
    Py_RETURN_NONE;
bad:
    PyErr_SetString(PyExc_ValueError,
                    "new_align: script does not consume A and B exactly");
    return nullptr;
}

// score_range(T, n, W, start, size, ss, gop) -> int64
//   Sum-of-pairs score of columns [start, start+size) of n stacked text
//   rows (mafScoreRange, mz_scores.c:124-152), incl. the reference's
//   quirk that the gap term for column i reaches back to absolute
//   column i-1 even when i == start > 0.
//   T: uint8 (n, W) C-contiguous; ss: int32 (128,128); gop: int32 (16,)
PyObject* score_range(PyObject*, PyObject* args) {
    PyObject *to, *sso, *gopo;
    Py_ssize_t n, W, start, size;
    if (!PyArg_ParseTuple(args, "OnnnnOO", &to, &n, &W, &start, &size,
                          &sso, &gopo))
        return nullptr;
    Buf T(to, PyBUF_SIMPLE), SS(sso, PyBUF_SIMPLE), GOP(gopo, PyBUF_SIMPLE);
    if (!T.ok || !SS.ok || !GOP.ok) return nullptr;
    if (T.len() < n * W || start < 0 || size <= 0 || start + size > W ||
        SS.len() < (Py_ssize_t)(128 * 128 * sizeof(int32_t)) ||
        GOP.len() < (Py_ssize_t)(16 * sizeof(int32_t))) {
        PyErr_SetString(PyExc_ValueError, "score_range: bad args");
        return nullptr;
    }
    const uint8_t* t = T.u8();
    const int32_t* ss = SS.i32();
    const int32_t* gop = GOP.i32();
    const Py_ssize_t lo = start > 1 ? start : 1;
    const Py_ssize_t hi = start + size;
    int64_t total = 0;
    // Release the GIL only when the work is long enough to matter:
    // most calls score a few hundred columns (~microseconds), and
    // forfeiting the GIL there makes the calling thread queue behind
    // the host-DP lane worker for milliseconds per call (measured:
    // +27 us/call average under lane load).
    const bool big = (int64_t)size * n * (n - 1) > 200000;
    PyThreadState* _save = big ? PyEval_SaveThread() : nullptr;
    for (Py_ssize_t i = 0; i < n; ++i) {
        const uint8_t* a = t + i * W;
        for (Py_ssize_t j = i + 1; j < n; ++j) {
            const uint8_t* b = t + j * W;
            for (Py_ssize_t c = start; c < hi; ++c)
                total += ss[a[c] * 128 + b[c]];
            for (Py_ssize_t c = lo; c < hi; ++c) {
                int idx = ((a[c - 1] == DASH) << 3) |
                          ((b[c - 1] == DASH) << 2) |
                          ((a[c] == DASH) << 1) | (b[c] == DASH);
                total -= gop[idx];
            }
        }
    }
    if (_save) PyEval_RestoreThread(_save);
    return PyLong_FromLongLong((long long)total);
}

// band_info(LB, RB, M, N, wcaps) -> (wcap, maxwidth, cells)
//   One pass over a job's band: entry validation (mz_yama.c:58-71),
//   flag-row width selection (yama_pack.pick_wcap) and band cell
//   counting — replaces three numpy passes per job in the batched
//   dispatch admission loop. LB/RB int64 (>= M+1); wcaps: int64 ladder.
//   wcap == 0 means no ladder width holds the band (host fallback).
PyObject* band_info(PyObject*, PyObject* args) {
    PyObject *lbo, *rbo, *wco;
    Py_ssize_t M, N;
    if (!PyArg_ParseTuple(args, "OOnnO", &lbo, &rbo, &M, &N, &wco))
        return nullptr;
    Buf LBb(lbo, PyBUF_SIMPLE), RBb(rbo, PyBUF_SIMPLE),
        WC(wco, PyBUF_SIMPLE);
    if (!LBb.ok || !RBb.ok || !WC.ok) return nullptr;
    if (LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t))) {
        PyErr_SetString(PyExc_ValueError, "band_info: bad buffers");
        return nullptr;
    }
    const int64_t* LB = reinterpret_cast<const int64_t*>(LBb.u8());
    const int64_t* RB = reinterpret_cast<const int64_t*>(RBb.u8());
    const int64_t* wcaps = reinterpret_cast<const int64_t*>(WC.u8());
    const Py_ssize_t nwc = WC.len() / (Py_ssize_t)sizeof(int64_t);

    if (LB[0] != 0 || RB[M] != N) {
        PyErr_Format(PyExc_ValueError,
                     "LB and RB not terminated properly: %lld %lld %lld",
                     (long long)LB[0], (long long)RB[M], (long long)N);
        return nullptr;
    }
    const int64_t minw = N < 10 ? N : 10;
    int64_t width = 0, cells = 0;
    for (Py_ssize_t r = 0; r <= M; ++r) {
        int64_t w = RB[r] - LB[r];
        if (w < minw) {
            PyErr_Format(PyExc_ValueError, "RB[%zd] - LB[%zd] < %lld", r, r,
                         (long long)minw);
            return nullptr;
        }
        if (r > 0 && (LB[r] < LB[r - 1] || RB[r] < RB[r - 1])) {
            PyErr_SetString(PyExc_ValueError, "band not monotonic");
            return nullptr;
        }
        if (w > width) width = w;
        int64_t rb = RB[r] < N ? RB[r] : N;
        cells += rb - LB[r];
    }
    cells += M;
    int64_t wcap = 0;
    for (Py_ssize_t i = 0; i < nwc; ++i)
        if (width + 1 <= wcaps[i]) { wcap = wcaps[i]; break; }
    return Py_BuildValue("(LLL)", (long long)wcap, (long long)width,
                         (long long)cells);
}

// smooth: monotonize band bounds, then dilate into a radius-R sausage
// (mz_preyama.c:17-35; preyama.smooth). In place on int64 LB/RB (M+1,).
void smooth_c(int64_t* LB, int64_t* RB, Py_ssize_t M, int64_t N,
              int64_t radius) {
    for (Py_ssize_t i = 1; i <= M; ++i)
        if (LB[i] < LB[i - 1]) LB[i] = LB[i - 1];
    for (Py_ssize_t i = 0; i <= M; ++i)
        if (RB[i] > N) RB[i] = N;
    for (Py_ssize_t i = M - 1; i >= 0; --i)
        if (RB[i] > RB[i + 1]) RB[i] = RB[i + 1];
    int64_t radi = radius < (int64_t)M ? radius : (int64_t)M;
    // L2[i] = min(max(LB[i]-radi, 0), LB[i-radi]) for i > radi; else 0.
    // Descending order: reads at i-radi happen before that slot is
    // overwritten (it is only written when the loop reaches it).
    for (Py_ssize_t i = M; i >= radi + 1; --i) {
        int64_t v = LB[i] - radi;
        if (v < 0) v = 0;
        if (LB[i - radi] < v) v = LB[i - radi];
        LB[i] = v;
    }
    for (Py_ssize_t i = 0; i <= radi && i <= M; ++i) LB[i] = 0;
    // R2[i] = max(min(RB[i]+radi, N), RB[i+radi]) for i < M-radi; else N.
    for (Py_ssize_t i = 0; i < M - radi; ++i) {
        int64_t v = RB[i] + radi;
        if (v > N) v = N;
        if (RB[i + radi] > v) v = RB[i + radi];
        RB[i] = v;
    }
    for (Py_ssize_t i = M - radi < 0 ? 0 : M - radi; i <= M; ++i) RB[i] = N;
}

// smooth_into(LB, RB, M, N, radius) — preyama.smooth in place.
PyObject* smooth_into(PyObject*, PyObject* args) {
    PyObject *lbo, *rbo;
    Py_ssize_t M;
    long long N, radius;
    if (!PyArg_ParseTuple(args, "OOnLL", &lbo, &rbo, &M, &N, &radius))
        return nullptr;
    Buf LBb(lbo, PyBUF_WRITABLE), RBb(rbo, PyBUF_WRITABLE);
    if (!LBb.ok || !RBb.ok) return nullptr;
    if (LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t))) {
        PyErr_SetString(PyExc_ValueError, "smooth_into: bad buffers");
        return nullptr;
    }
    smooth_c(reinterpret_cast<int64_t*>(LBb.u8()),
             reinterpret_cast<int64_t*>(RBb.u8()), M, N, radius);
    Py_RETURN_NONE;
}

// preyama_prep1(Bfull, N, L, top1s, M, top2s, radius, Bout, LB, RB) -> N_new
//   The v==1 prep of pre_yama in one pass (mz_preyama.c:203-259):
//   compact all-dash columns of B, derive the band from the lockstep
//   walk of the two reference-row slices, monotonize + dilate.
//   Bfull: uint8 (N, L) column-major C-contig; top1s: uint8 (M,);
//   top2s: uint8 (N,); Bout: uint8 (>= N, L) writable;
//   LB/RB: int64 (M+1,) writable (fully overwritten).
PyObject* preyama_prep1(PyObject*, PyObject* args) {
    PyObject *bo, *t1o, *t2o, *bouto, *lbo, *rbo;
    Py_ssize_t N, L, M;
    long long radius;
    if (!PyArg_ParseTuple(args, "OnnOnOLOOO", &bo, &N, &L, &t1o, &M, &t2o,
                          &radius, &bouto, &lbo, &rbo))
        return nullptr;
    Buf B(bo, PyBUF_SIMPLE), T1(t1o, PyBUF_SIMPLE), T2(t2o, PyBUF_SIMPLE),
        BO(bouto, PyBUF_WRITABLE), LBb(lbo, PyBUF_WRITABLE),
        RBb(rbo, PyBUF_WRITABLE);
    if (!B.ok || !T1.ok || !T2.ok || !BO.ok || !LBb.ok || !RBb.ok)
        return nullptr;
    if (B.len() < N * L || T1.len() < M || T2.len() < N ||
        BO.len() < N * L ||
        LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t))) {
        PyErr_SetString(PyExc_ValueError, "preyama_prep1: bad buffers");
        return nullptr;
    }
    const uint8_t* b = B.u8();
    const uint8_t* t1 = T1.u8();
    const uint8_t* t2 = T2.u8();
    uint8_t* bout = BO.u8();
    int64_t* LB = reinterpret_cast<int64_t*>(LBb.u8());
    int64_t* RB = reinterpret_cast<int64_t*>(RBb.u8());
    // short call (tens of us): keep the GIL — releasing it queues this
    // thread behind the host-DP lane worker (see score_range)
    const bool big = (int64_t)N * (L + 1) > 500000;
    PyThreadState* _save = big ? PyEval_SaveThread() : nullptr;
    // compact all-dash columns; map2[j] = 1-based new col or -1
    int64_t* map2 = new int64_t[N + 1];
    Py_ssize_t nn = 0;
    for (Py_ssize_t j = 0; j < N; ++j) {
        const uint8_t* col = b + j * L;
        bool keep = false;
        for (Py_ssize_t r = 0; r < L; ++r)
            if (col[r] != DASH) { keep = true; break; }
        if (keep) {
            std::memcpy(bout + nn * L, col, L);
            ++nn;
            map2[j + 1] = nn;
        } else {
            map2[j + 1] = -1;
        }
    }
    if (nn > 0) {
        for (Py_ssize_t i = 0; i <= M; ++i) { LB[i] = 0; RB[i] = nn; }
        // lockstep walk: t-th non-dash of top1s pairs with t-th of top2s
        Py_ssize_t j = 0;  // 0-based scan over top2s
        for (Py_ssize_t i = 1; i <= M; ++i) {
            if (t1[i - 1] == DASH) continue;
            while (j < N && t2[j] == DASH) ++j;
            if (j >= N) break;
            ++j;  // j is now the 1-based paired column of B
            int64_t c2 = map2[j];
            if (c2 != -1) { LB[i] = c2; RB[i] = c2; }
        }
        smooth_c(LB, RB, M, nn, radius);
    }
    delete[] map2;
    if (_save) PyEval_RestoreThread(_save);
    return PyLong_FromSsize_t(nn);
}

// Core of the host DP: validation happens in the wrappers (so errors
// can raise with the GIL held); this body is pure C and runs with the
// GIL released. Returns nedit, or -1 on an internal traceback error.
Py_ssize_t yama_run(const uint8_t* a, Py_ssize_t M, Py_ssize_t K,
                    const uint8_t* b, Py_ssize_t N, Py_ssize_t L,
                    const int64_t* LB, const int64_t* RB,
                    const int32_t* ss, const int8_t* c8,
                    long go, long ge, int64_t tb_cells, uint8_t* outbuf) {
    constexpr int64_t MININT = -(int64_t(1) << 30);

    // ---- per-column stats (yama.py column_stats) ----
    auto stats = [&](const uint8_t* x, Py_ssize_t ncol, Py_ssize_t nrow,
                     int32_t* hist, int64_t* n0, int64_t* n1, int64_t* pr) {
        for (Py_ssize_t i = 1; i <= ncol; ++i) {
            const uint8_t* col = x + (i - 1) * nrow;
            int32_t hc[6] = {0, 0, 0, 0, 0, 0};
            int64_t dash = 0;
            for (Py_ssize_t r = 0; r < nrow; ++r) {
                hc[c8[col[r]]] += 1;
                dash += (col[r] == DASH);
            }
            for (int k = 0; k < 6; ++k) hist[i * 6 + k] = hc[k];
            n1[i] = dash;
            n0[i] = (int64_t)nrow - dash;
            if (i == 1) {
                pr[4 + 0] = n0[1];
                pr[4 + 1] = n1[1];
                pr[4 + 2] = 0;
                pr[4 + 3] = 0;
            } else {
                const uint8_t* prev = col - nrow;
                int64_t p[4] = {0, 0, 0, 0};
                for (Py_ssize_t r = 0; r < nrow; ++r)
                    p[((prev[r] == DASH) << 1) | (col[r] == DASH)] += 1;
                for (int k = 0; k < 4; ++k) pr[i * 4 + k] = p[k];
            }
        }
    };
    int32_t* histA = new int32_t[(M + 1) * 6]();
    int32_t* histB = new int32_t[(N + 1) * 6]();
    int64_t* a0 = new int64_t[M + 1]();
    int64_t* a1 = new int64_t[M + 1]();
    int64_t* pa = new int64_t[(M + 1) * 4]();
    int64_t* b0 = new int64_t[N + 1]();
    int64_t* b1 = new int64_t[N + 1]();
    int64_t* pb = new int64_t[(N + 1) * 4]();
    stats(a, M, K, histA, a0, a1, pa);
    stats(b, N, L, histB, b0, b1, pb);
    // substitution projection: sr[col][c] = sum_c' ss[c][c'] * histB[col][c']
    int64_t* sr = new int64_t[(N + 1) * 6]();
    for (Py_ssize_t j = 1; j <= N; ++j)
        for (int c = 0; c < 6; ++c) {
            int64_t s = 0;
            for (int d = 0; d < 6; ++d)
                s += (int64_t)ss[c * 6 + d] * histB[j * 6 + d];
            sr[j * 6 + c] = s;
        }

    int64_t* dpC = new int64_t[N + 1];
    int64_t* dpD = new int64_t[N + 1];
    int64_t* dpI = new int64_t[N + 1];
    // Row-indexed band traceback: trow[r] + col addresses the flag of
    // in-band cell (r, col) (the reference's tback_row[row] = tbp - LB[row],
    // mz_yama.c:77-91).
    uint8_t* flags = new uint8_t[tb_cells]();
    uint8_t** trow = new uint8_t*[M + 1];
    {
        uint8_t* tbp = flags;
        for (Py_ssize_t r = 0; r <= M; ++r) {
            trow[r] = tbp - LB[r];
            tbp += RB[r] - LB[r] + 1;
        }
    }
    for (Py_ssize_t j = 0; j <= N; ++j) dpC[j] = dpD[j] = dpI[j] = MININT;
    dpC[0] = dpD[0] = dpI[0] = 0;
    {
        int64_t acc = 0;
        for (Py_ssize_t j = 1; j <= RB[0]; ++j) {
            acc += b0[j];
            dpI[j] = -acc * (int64_t)K * ge;
            trow[0][j] = FLAG_I << 4;
        }
    }
    int64_t lastC = MININT, lastD = MININT, lastI = MININT;

    for (Py_ssize_t row = 1; row <= M; ++row) {
        const int64_t lb = LB[row], rb = RB[row];
        const int64_t lbm1 = LB[row - 1];
        const int64_t lbm2 = row > 1 ? LB[row - 2] : 0;
        const int64_t pa0 = pa[row * 4 + 0], pa1 = pa[row * 4 + 1],
                      pa2 = pa[row * 4 + 2], pa3 = pa[row * 4 + 3];
        const int64_t a0r = a0[row], a1r = a1[row];
        const int32_t* hA = histA + row * 6;
        uint8_t* frow = trow[row];
        int64_t diagC, diagD, diagI;  // previous row's value at col-1
        if (lb >= 1) {
            diagC = dpC[lb - 1];
            diagD = dpD[lb - 1];
            diagI = dpI[lb - 1];
            if (lbm1 > lb - 1) diagC = diagD = diagI = MININT;
        } else {
            diagC = diagD = diagI = MININT;
        }
        int64_t prevC = MININT, prevD = MININT, Iprev = MININT;
        const bool live = row < M;
        for (int64_t c = lb; c <= rb; ++c) {
            const int64_t upC = dpC[c], upD = dpD[c], upI = dpI[c];
            const bool inner = c > 0 && c < N;
            // ---- D node ----
            int64_t xs = upC, ys = upD, zs = upI;
            if (row > 1 && inner) {
                if (c > lbm2) xs -= go * (pa0 * b0[c] + pa2 * (int64_t)L);
                ys -= go * pa2 * (int64_t)L;
            }
            if (inner && c > lbm1) zs -= go * a0r * (int64_t)L;
            uint8_t fd;
            int64_t Dv;
            if (xs >= ys && xs >= zs) { Dv = xs; fd = FLAG_C; }
            else if (ys > zs) { Dv = ys; fd = FLAG_D; }
            else { Dv = zs; fd = FLAG_I; }
            Dv -= a0r * (int64_t)L * ge;
            // ---- C node ----
            const int64_t pb0c = pb[c * 4 + 0], pb1c = pb[c * 4 + 1],
                          pb2c = pb[c * 4 + 2], pb3c = pb[c * 4 + 3];
            xs = diagC; ys = diagD; zs = diagI;
            const bool gt1 = c > 1;
            if (row > 1 && gt1) {
                if (c > lbm2 + 1)
                    xs -= go * (pa0 * pb1c + pa1 * (pb0c + pb2c)
                                + pa2 * (pb1c + pb3c) + pa3 * pb2c);
                ys -= go * (pa1 * b0[c] + pa2 * b1[c] + pa3 * b0[c]);
            }
            if (gt1 && c > lbm1 + 1)
                zs -= go * (a0r * (pb1c + pb3c) + a1r * pb2c);
            uint8_t fc = 0;
            int64_t Cv = MININT;
            if (c > lbm1) {
                int64_t sub = 0;
                const int64_t* src = sr + c * 6;
                for (int d = 0; d < 6; ++d) sub += hA[d] * src[d];
                if (xs >= ys && xs >= zs) { Cv = xs; fc = FLAG_C; }
                else if (ys > zs) { Cv = ys; fc = FLAG_D; }
                else { Cv = zs; fc = FLAG_I; }
                Cv += sub;
            }
            // ---- I node ----
            uint8_t fi = 0;
            int64_t Iv = MININT;
            if (c > lb) {
                int64_t xI = 0, yI = 0, zI = 0;
                if (live) {
                    xI = go * (a0r * (pb0c + pb2c) + a1r * pb2c);
                    yI = go * (int64_t)K * b0[c];
                    zI = go * (int64_t)K * pb2c;
                }
                int64_t x = prevC - (c > lbm1 + 1 ? xI : 0);
                int64_t y = prevD - yI;
                int64_t z = Iprev - (c > lb + 1 ? zI : 0);
                if (x >= y && x >= z) { Iv = x; fi = FLAG_C; }
                else if (y > z) { Iv = y; fi = FLAG_D; }
                else { Iv = z; fi = FLAG_I; }
                Iv -= b0[c] * (int64_t)K * ge;
                Iprev = Iv;
            } else {
                Iprev = MININT;
            }
            frow[c] = fc | (fd << 2) | (fi << 4);
            // roll the diagonal and store
            diagC = dpC[c]; diagD = dpD[c]; diagI = dpI[c];
            dpC[c] = Cv; dpD[c] = Dv; dpI[c] = Iv;
            prevC = Cv; prevD = Dv;
        }
        lastC = dpC[rb]; lastD = dpD[rb]; lastI = dpI[rb];
    }
    if (M == 0) lastC = lastD = lastI = MININT;

    // ---- traceback (newest-first) + replay into out ----
    uint8_t* script = new uint8_t[M + N];
    uint8_t node;
    if (lastC >= lastD && lastC >= lastI) node = FLAG_C;
    else if (lastD >= lastI) node = FLAG_D;
    else node = FLAG_I;
    Py_ssize_t row = M, col = N, nedit = 0;
    bool bad = false;
    while (row > 0 || col > 0) {
        if (row < 0 || col < 0 || nedit >= M + N ||
            col < LB[row] || col > RB[row]) { bad = true; break; }
        uint8_t st = trow[row][col];
        script[nedit++] = node;
        if (node == FLAG_I) { col -= 1; node = st >> 4; }
        else if (node == FLAG_D) { row -= 1; node = (st >> 2) & SELECT_CID; }
        else if (node == FLAG_C) { row -= 1; col -= 1; node = st & SELECT_CID; }
        else { bad = true; break; }
    }
    Py_ssize_t result = -1;
    if (!bad) {
        uint8_t* out = outbuf;
        const Py_ssize_t W = K + L;
        Py_ssize_t ai = 0, bi = 0;
        for (Py_ssize_t t = 0; t < nedit && !bad; ++t) {
            uint8_t op = script[nedit - 1 - t];
            uint8_t* r = out + t * W;
            if (op != FLAG_I) {
                if (ai >= M) { bad = true; break; }
                std::memcpy(r, a + ai * K, K);
                ++ai;
            } else {
                std::memset(r, DASH, K);
            }
            if (op != FLAG_D) {
                if (bi >= N) { bad = true; break; }
                std::memcpy(r + K, b + bi * L, L);
                ++bi;
            } else {
                std::memset(r + K, DASH, L);
            }
        }
        if (!bad && (ai != M || bi != N)) bad = true;
        if (!bad) result = nedit;
    }
    delete[] histA; delete[] histB; delete[] a0; delete[] a1; delete[] pa;
    delete[] b0; delete[] b1; delete[] pb; delete[] sr;
    delete[] dpC; delete[] dpD; delete[] dpI; delete[] flags; delete[] trow;
    delete[] script;
    return result;
}

// Validate one problem's band with the GIL held; returns tb_cells or -1
// with a Python error set.
int64_t yama_validate(Py_ssize_t M, Py_ssize_t N, const int64_t* LB,
                      const int64_t* RB) {
    // Traceback storage is band-sized, exactly like the reference's
    // tback_size = sum over rows of RB-LB+1 (mz_yama.c:60-77): a 50kb x
    // 50kb R=30 problem needs ~3MB, not (M+1)*(N+1) = 2.5GB.
    // Full entry sanity checks of yama (mz_yama.c:58-71), so the Python
    // caller can skip its own pass when dispatching here.
    if (LB[0] != 0 || RB[M] != N) {
        PyErr_SetString(PyExc_ValueError,
                        "LB and RB not terminated properly");
        return -1;
    }
    const int64_t minw = N < 10 ? N : 10;
    int64_t tb_cells = 0;
    for (Py_ssize_t r = 0; r <= M; ++r) {
        if (RB[r] < LB[r] || LB[r] < 0 || RB[r] > N ||
            RB[r] - LB[r] < minw) {
            PyErr_SetString(PyExc_ValueError, "yama_into: bad band");
            return -1;
        }
        if (r > 0 && (LB[r] < LB[r - 1] || RB[r] < RB[r - 1])) {
            PyErr_SetString(PyExc_ValueError,
                            "yama_into: band not monotonic");
            return -1;
        }
        tb_cells += RB[r] - LB[r] + 1;
    }
    if (tb_cells > (int64_t)1 << 36) {  // 64 GiB of flags: hopeless
        PyErr_SetString(PyExc_ValueError, "yama_into: problem too large");
        return -1;
    }
    return tb_cells;
}

// yama_into(A, M, K, B, N, L, LB, RB, ss_cat, cat, go, ge, out) -> nedit
//   Full banded DP + traceback + replay on host: the same integer
//   recurrence as multiz_jax/yama.py yama_numpy (per-column statistics
//   collapse the reference's K*L inner loops, mz_yama.c:123-225, into
//   a handful of products), with identical C>=D>I tie-breaking.
//   A: uint8 (M, K); B: uint8 (N, L); LB/RB: int64 (M+1,);
//   ss_cat: int32 (6, 6); cat: int8[256]; out: uint8 (M+N, K+L).
PyObject* yama_into(PyObject*, PyObject* args) {
    PyObject *ao, *bo, *lbo, *rbo, *sso, *cato, *oo;
    Py_ssize_t M, K, N, L;
    long go, ge;
    if (!PyArg_ParseTuple(args, "OnnOnnOOOOllO", &ao, &M, &K, &bo, &N, &L,
                          &lbo, &rbo, &sso, &cato, &go, &ge, &oo))
        return nullptr;
    Buf A(ao, PyBUF_SIMPLE), B(bo, PyBUF_SIMPLE), LBb(lbo, PyBUF_SIMPLE),
        RBb(rbo, PyBUF_SIMPLE), SS(sso, PyBUF_SIMPLE), CAT(cato, PyBUF_SIMPLE),
        O(oo, PyBUF_WRITABLE);
    if (!A.ok || !B.ok || !LBb.ok || !RBb.ok || !SS.ok || !CAT.ok || !O.ok)
        return nullptr;
    if (A.len() < M * K || B.len() < N * L ||
        LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
        SS.len() < (Py_ssize_t)(36 * sizeof(int32_t)) || CAT.len() < 256 ||
        O.len() < (M + N) * (K + L)) {
        PyErr_SetString(PyExc_ValueError, "yama_into: bad buffer sizes");
        return nullptr;
    }
    const int64_t* LB = reinterpret_cast<const int64_t*>(LBb.u8());
    const int64_t* RB = reinterpret_cast<const int64_t*>(RBb.u8());
    int64_t tb_cells = yama_validate(M, N, LB, RB);
    if (tb_cells < 0) return nullptr;
    Py_ssize_t result;
    {
        PyThreadState* _save = PyEval_SaveThread();  // pure C below
        result = yama_run(
            A.u8(), M, K, B.u8(), N, L, LB, RB, SS.i32(),
            reinterpret_cast<const int8_t*>(CAT.u8()), go, ge, tb_cells,
            O.u8());
        PyEval_RestoreThread(_save);
    }
    if (result < 0) {
        PyErr_SetString(PyExc_ValueError,
                        "yama_into: error generating edit script");
        return nullptr;
    }
    return PyLong_FromSsize_t(result);
}

// yama_many(problems, ss_cat, cat, go, ge) -> list[nedit]
//   problems: sequence of (A, M, K, B, N, L, LB, RB, out) tuples.
//   Runs every DP under ONE GIL release — the host DP lane's worker
//   thread uses this so it re-acquires the GIL once per chunk instead
//   of once per job (per-job handoffs convoy against the planning
//   thread's 5 ms GIL slices).
PyObject* yama_many(PyObject*, PyObject* args) {
    PyObject* seq;
    PyObject *sso, *cato;
    long go, ge;
    if (!PyArg_ParseTuple(args, "OOOll", &seq, &sso, &cato, &go, &ge))
        return nullptr;
    Buf SS(sso, PyBUF_SIMPLE), CAT(cato, PyBUF_SIMPLE);
    if (!SS.ok || !CAT.ok) return nullptr;
    if (SS.len() < (Py_ssize_t)(36 * sizeof(int32_t)) || CAT.len() < 256) {
        PyErr_SetString(PyExc_ValueError, "yama_many: bad tables");
        return nullptr;
    }
    PyObject* fast = PySequence_Fast(seq, "yama_many: expected a sequence");
    if (!fast) return nullptr;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    struct Job {
        Buf A, B, LBb, RBb, O;
        Py_ssize_t M, K, N, L;
        int64_t tb_cells;
        Py_ssize_t nedit;
        Job(PyObject* a, PyObject* b, PyObject* lb, PyObject* rb,
            PyObject* o)
            : A(a, PyBUF_SIMPLE), B(b, PyBUF_SIMPLE),
              LBb(lb, PyBUF_SIMPLE), RBb(rb, PyBUF_SIMPLE),
              O(o, PyBUF_WRITABLE) {}
    };
    std::vector<Job*> jobs;
    jobs.reserve(n);
    bool ok = true;
    for (Py_ssize_t i = 0; i < n && ok; ++i) {
        PyObject* t = PySequence_Fast_GET_ITEM(fast, i);
        PyObject *ao, *bo, *lbo, *rbo, *oo;
        Py_ssize_t M, K, N, L;
        if (!PyArg_ParseTuple(t, "OnnOnnOOO", &ao, &M, &K, &bo, &N, &L,
                              &lbo, &rbo, &oo)) {
            ok = false;
            break;
        }
        Job* j = new Job(ao, bo, lbo, rbo, oo);
        j->M = M; j->K = K; j->N = N; j->L = L;
        jobs.push_back(j);
        if (!j->A.ok || !j->B.ok || !j->LBb.ok || !j->RBb.ok || !j->O.ok) {
            ok = false;
            break;
        }
        if (j->A.len() < M * K || j->B.len() < N * L ||
            j->LBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
            j->RBb.len() < (Py_ssize_t)((M + 1) * sizeof(int64_t)) ||
            j->O.len() < (M + N) * (K + L)) {
            PyErr_SetString(PyExc_ValueError, "yama_many: bad buffers");
            ok = false;
            break;
        }
        j->tb_cells = yama_validate(
            M, N, reinterpret_cast<const int64_t*>(j->LBb.u8()),
            reinterpret_cast<const int64_t*>(j->RBb.u8()));
        if (j->tb_cells < 0) ok = false;
    }
    Py_ssize_t bad_at = -1;
    if (ok) {
        const int32_t* ss = SS.i32();
        const int8_t* c8 = reinterpret_cast<const int8_t*>(CAT.u8());
        PyThreadState* _save = PyEval_SaveThread();
        for (Py_ssize_t i = 0; i < (Py_ssize_t)jobs.size(); ++i) {
            Job* j = jobs[i];
            j->nedit = yama_run(
                j->A.u8(), j->M, j->K, j->B.u8(), j->N, j->L,
                reinterpret_cast<const int64_t*>(j->LBb.u8()),
                reinterpret_cast<const int64_t*>(j->RBb.u8()),
                ss, c8, go, ge, j->tb_cells, j->O.u8());
            if (j->nedit < 0) { bad_at = i; break; }
        }
        PyEval_RestoreThread(_save);
    }
    PyObject* out = nullptr;
    if (ok && bad_at < 0) {
        out = PyList_New(jobs.size());
        if (out)
            for (Py_ssize_t i = 0; i < (Py_ssize_t)jobs.size(); ++i)
                PyList_SET_ITEM(out, i, PyLong_FromSsize_t(jobs[i]->nedit));
    } else if (ok) {
        PyErr_Format(PyExc_ValueError,
                     "yama_many: error generating edit script (job %zd)",
                     bad_at);
    }
    for (Job* j : jobs) delete j;
    Py_DECREF(fast);
    return out;
}

PyMethodDef methods[] = {
    {"colstats_into", colstats_into, METH_VARARGS,
     "per-column stats into pre-allocated int32 buffers"},
    {"yama_into", yama_into, METH_VARARGS,
     "full banded DP + traceback + replay; returns nedit"},
    {"yama_many", yama_many, METH_VARARGS,
     "batched host DP: many problems under one GIL release"},
    {"score_range", score_range, METH_VARARGS,
     "sum-of-pairs mafScoreRange over stacked text rows"},
    {"band_info", band_info, METH_VARARGS,
     "band validation + flag-row width pick + cell count in one pass"},
    {"smooth_into", smooth_into, METH_VARARGS,
     "monotonize + radius-dilate band bounds in place (preyama.smooth)"},
    {"preyama_prep1", preyama_prep1, METH_VARARGS,
     "v==1 pre_yama prep: compact B, lockstep band, smooth; returns N'"},
    {"traceback_into", traceback_into, METH_VARARGS,
     "edit-script extraction (newest-first); returns nedit"},
    {"replay_into", replay_into, METH_VARARGS,
     "edit script -> merged column matrix"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_mzcore",
    "native host runtime for multiz_jax", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__mzcore(void) { return PyModule_Create(&moduledef); }
