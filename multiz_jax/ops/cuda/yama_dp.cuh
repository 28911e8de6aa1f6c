// Band-local yama DP + traceback for one problem, run by one warp.
//
// The recurrence is mz_yama.c:97-291 over per-column statistics (see
// yama.py): D reads the previous row at the same column, C the previous
// row at column-1, I the current row at column-1. One warp owns one
// problem and walks its rows in order; each row's band [LB[r], RB[r]]
// is covered in segments of 32 columns, one column per lane.
//
//  * The previous and current rows live in a shared-memory ring
//    (two buffers of C/D/I, each `wcap` ints, indexed by column mod
//    wcap). A read outside the previous row's band yields MININT, which
//    is what the reference reads from its MININT-initialised matrix
//    (mz_yama.c:77-106): bands are monotone, so such a cell was never
//    written or belongs to an older row.
//  * The in-row I chain I[c] = max(xy[c], I[c-1] - z[c]) - e[c] is a
//    composition of max-plus maps f(v) = max(a, v + b); a warp scan
//    composes them exactly in integers, so each lane gets I[c-1] and
//    applies the reference's C >= D > I tie-breaking (mz_yama.c:138-154)
//    to the same three candidates.
//  * Flags are one byte per band cell (flag_c | flag_d << 2 |
//    flag_i << 4), stored at [r][c - LB[r]] with row stride wcap.
//  * After the last row, lane 0 walks the flags from (M, N)
//    (mz_yama.c:257-291) and writes the edit script newest-first, four
//    2-bit ops per byte, after a little-endian int32 op count
//    (0xFFFFFFFF when the walk leaves the band).
//
// All arithmetic is int32, like the reference's `int`. The warp
// primitives come from a policy type so that the same code runs as a
// CUDA kernel and, for tests, on the CPU with one thread per lane.
#pragma once

#include <stdint.h>

#ifndef MZ_HD
#define MZ_HD
#endif

namespace mzdp {

constexpr int32_t MININT = -(1 << 30);
constexpr int32_t NEG_HUGE = -(1 << 30) - (1 << 29);
constexpr int FLAG_C = 0, FLAG_I = 1, FLAG_D = 2;

// column statistics, stat-major: cstat[k * ncol + c], c = 0..n_pad
enum { CS_B0, CS_B1, CS_PB0, CS_PB1, CS_PB2, CS_PB3, CS_S0, NCSTAT = 12 };
// row statistics, row-major: rstat[r * NRSTAT + k], r = 0..m_pad
enum {
  RS_A0, RS_A1, RS_PA0, RS_PA1, RS_PA2, RS_PA3, RS_H0,
  RS_LB = 12, RS_RB = 13, NRSTAT = 16
};

struct Problem {
  const int32_t* cstat;  // (NCSTAT, ncol)
  const int32_t* rstat;  // (nrow, NRSTAT)
  uint8_t* flags;        // (nrow, wcap)
  uint8_t* out;          // (4 + nscript)
  int ncol, wcap, nscript;
  int M, N, K, L;
};

MZ_HD inline int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// the reference's three-way choice: C if x is maximal, else D if y > z,
// else I (mz_yama.c:138-154)
MZ_HD inline int pick3(int32_t x, int32_t y, int32_t z, int32_t* v) {
  if (x >= y && x >= z) { *v = x; return FLAG_C; }
  if (y > z) { *v = y; return FLAG_D; }
  *v = z;
  return FLAG_I;
}

template <class Warp>
MZ_HD inline void yama_warp(const Problem& p, int32_t* ring, Warp& w,
                            int32_t go, int32_t ge) {
  const int lane = w.lane();
  const int M = p.M, N = p.N, K = p.K, L = p.L;
  if (M <= 0) {  // padding slot
    if (lane == 0) p.out[0] = p.out[1] = p.out[2] = p.out[3] = 0;
    return;
  }
  const int wcap = p.wcap, mask = wcap - 1, ncol = p.ncol;
  const int32_t* cs = p.cstat;
  const int32_t* rs = p.rstat;

  // ---- row 0 (mz_yama.c:82-94): C = D = I = 0 at column 0; I chain
  // of extension costs along [1, RB[0]] ----
  {
    const int rb0 = rs[RS_RB];
    int32_t carry = 0;
    for (int s = 0; s <= rb0; s += 32) {
      const int c = s + lane;
      const bool v = c <= rb0;
      int32_t pre = (v && c >= 1) ? cs[CS_B0 * ncol + c] * K * ge : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t t = w.shfl_up(pre, d);
        if (lane >= d) pre += t;
      }
      if (v) {
        ring[c & mask] = c == 0 ? 0 : MININT;
        ring[wcap + (c & mask)] = c == 0 ? 0 : MININT;
        ring[2 * wcap + (c & mask)] = c == 0 ? 0 : -(carry + pre);
        p.flags[c] = c >= 1 ? (uint8_t)(FLAG_I << 4) : 0;
      }
      carry += w.shfl(pre, 31);
    }
    w.sync();
  }

  for (int r = 1; r <= M; ++r) {
    const int32_t* R = rs + r * NRSTAT;
    const int lb = R[RS_LB], rb = R[RS_RB];
    const int lbm1 = R[RS_LB - NRSTAT], rbm1 = R[RS_RB - NRSTAT];
    const int lbm2 = r > 1 ? R[RS_LB - 2 * NRSTAT] : 0;
    const int32_t a0 = R[RS_A0], a1 = R[RS_A1];
    const int32_t pa0 = R[RS_PA0], pa1 = R[RS_PA1], pa2 = R[RS_PA2],
                  pa3 = R[RS_PA3];
    const bool not1 = r > 1, live = r < M;
    const int32_t* pC = ring + ((r - 1) & 1) * 3 * wcap;
    const int32_t* pD = pC + wcap;
    const int32_t* pI = pD + wcap;
    int32_t* cC = ring + (r & 1) * 3 * wcap;
    int32_t* cD = cC + wcap;
    int32_t* cI = cD + wcap;
    uint8_t* frow = p.flags + (size_t)r * wcap;
    // carries from the previous segment: C, D and I at column s-1
    int32_t cm1C = MININT, cm1D = MININT, iin = MININT;

    for (int s = lb; s <= rb; s += 32) {
      const int c = s + lane;
      const bool v = c <= rb;
      const int cc = v ? c : rb;
      const int32_t b0 = cs[CS_B0 * ncol + cc], b1 = cs[CS_B1 * ncol + cc];
      const int32_t pb0 = cs[CS_PB0 * ncol + cc], pb1 = cs[CS_PB1 * ncol + cc],
                    pb2 = cs[CS_PB2 * ncol + cc], pb3 = cs[CS_PB3 * ncol + cc];
      int32_t sub = 0;
      for (int i = 0; i < 6; ++i)
        sub += cs[(CS_S0 + i) * ncol + cc] * R[RS_H0 + i];

      const bool upok = c <= rbm1;  // c >= lb >= lbm1 always
      const bool dgok = c - 1 >= lbm1 && c - 1 <= rbm1;
      const int32_t uC = upok ? pC[c & mask] : MININT;
      const int32_t uD = upok ? pD[c & mask] : MININT;
      const int32_t uI = upok ? pI[c & mask] : MININT;
      const int32_t dC = dgok ? pC[(c - 1) & mask] : MININT;
      const int32_t dD = dgok ? pD[(c - 1) & mask] : MININT;
      const int32_t dI = dgok ? pI[(c - 1) & mask] : MININT;

      // ---- D node (vertical) ----
      const bool inner = c > 0 && c < N;
      int32_t xs = uC, ys = uD, zs = uI;
      if (not1) {
        if (inner && c > lbm2) xs -= go * (pa0 * b0 + pa2 * L);
        if (inner) ys -= go * pa2 * L;
      }
      if (inner && c > lbm1) zs -= go * a0 * L;
      int32_t Dv;
      const int fD = pick3(xs, ys, zs, &Dv);
      Dv -= a0 * L * ge;

      // ---- C node (diagonal) ----
      const bool gt1 = c > 1;
      xs = dC;
      ys = dD;
      zs = dI;
      if (not1) {
        if (gt1 && c > lbm2 + 1)
          xs -= go * (pa0 * pb1 + pa1 * (pb0 + pb2) + pa2 * (pb1 + pb3) +
                      pa3 * pb2);
        if (gt1) ys -= go * (pa1 * b0 + pa2 * b1 + pa3 * b0);
      }
      if (gt1 && c > lbm1 + 1) zs -= go * (a0 * (pb1 + pb3) + a1 * pb2);
      int32_t Cv;
      int fC = pick3(xs, ys, zs, &Cv);
      Cv += sub;
      if (c <= lbm1) {  // C exists only when col > LB[row-1]
        Cv = MININT;
        fC = 0;
      }

      // ---- I node (horizontal): max-plus scan over the segment ----
      int32_t Cm1 = w.shfl_up(Cv, 1), Dm1 = w.shfl_up(Dv, 1);
      if (lane == 0) {
        Cm1 = cm1C;
        Dm1 = cm1D;
      }
      const int32_t xI = live ? go * (a0 * (pb0 + pb2) + a1 * pb2) : 0;
      const int32_t yI = live ? go * K * b0 : 0;
      const int32_t zI = live ? go * K * pb2 : 0;
      const int32_t xv = Cm1 - (c > lbm1 + 1 ? xI : 0);
      const int32_t yv = Dm1 - yI;
      const int32_t e = b0 * K * ge;
      const int32_t zm = c > lb + 1 ? zI : 0;
      const bool chain = v && c > lb;
      // lane's map: I[c] = max(a, I[c-1] + b); identity off the chain
      int32_t ma = chain ? imax(xv, yv) - e : NEG_HUGE;
      int32_t mb = chain ? -(zm + e) : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t ta = w.shfl_up(ma, d), tb = w.shfl_up(mb, d);
        if (lane >= d) {
          ma = imax(ma, ta + mb);
          mb = tb + mb;
        }
      }
      const int32_t Iv = imax(ma, iin + mb);
      int32_t Ip = w.shfl_up(Iv, 1);
      if (lane == 0) Ip = iin;
      int32_t Isel;
      int fI = pick3(xv, yv, Ip - zm, &Isel);
      int32_t Irow = Isel - e;  // == Iv on the chain
      if (!chain) {
        fI = 0;
        Irow = MININT;
      }

      if (v) {
        cC[c & mask] = Cv;
        cD[c & mask] = Dv;
        cI[c & mask] = Irow;
        frow[c - lb] = (uint8_t)(fC | (fD << 2) | (fI << 4));
      }
      cm1C = w.shfl(Cv, 31);
      cm1D = w.shfl(Dv, 31);
      iin = w.shfl(Iv, 31);
    }
    w.sync();
  }

  if (lane != 0) return;
  // ---- traceback (mz_yama.c:257-291) ----
  const int32_t* last = ring + (M & 1) * 3 * wcap + (N & mask);
  const int32_t lC = last[0], lD = last[wcap], lI = last[2 * wcap];
  int node = (lC >= lD && lC >= lI) ? FLAG_C : (lD >= lI ? FLAG_D : FLAG_I);
  int row = M, col = N, k = 0;
  unsigned acc = 0;
  bool bad = false;
  const int kmax = 4 * p.nscript;
  while (row > 0 || col > 0) {
    if (row < 0 || col < 0 || k >= kmax || node > FLAG_D) {
      bad = true;
      break;
    }
    const int lbr = rs[row * NRSTAT + RS_LB], rbr = rs[row * NRSTAT + RS_RB];
    if (col < lbr || col > rbr) {
      bad = true;
      break;
    }
    const int st = p.flags[(size_t)row * wcap + (col - lbr)];
    acc |= (unsigned)node << (2 * (k & 3));
    if ((k & 3) == 3) {
      p.out[4 + (k >> 2)] = (uint8_t)acc;
      acc = 0;
    }
    ++k;
    if (node == FLAG_I) {
      --col;
      node = st >> 4;
    } else if (node == FLAG_D) {
      --row;
      node = (st >> 2) & 3;
    } else {
      --row;
      --col;
      node = st & 3;
    }
  }
  if (k & 3) p.out[4 + (k >> 2)] = (uint8_t)acc;
  const uint32_t ne = bad ? 0xFFFFFFFFu : (uint32_t)k;
  p.out[0] = ne & 0xFF;
  p.out[1] = (ne >> 8) & 0xFF;
  p.out[2] = (ne >> 16) & 0xFF;
  p.out[3] = (ne >> 24) & 0xFF;
}

}  // namespace mzdp
