"""Host-side traceback: exterior W pass + stack-machine structure recovery.

Exact port of W_final::backtrack (reference: src/W_final.cc:175-719) and
pseudo_loop::backtrack (reference: src/pseudo_loop.cc:861-2820).  The DP
matrices come from the device fill; the traceback re-derives argmins with the
reference's branch order and strict-less-than tie-breaking, then assigns
bracket families (W_final.cc:764-819).

All quirks are preserved, including backtrack scans that differ from the fill
(e.g. the MULTI case always evaluates all 8 dangle rows, W_final.cc:244-305,
and P_PMmloop10 scans WBP(d,j)+PMmloop00(i,d-1,k,l), pseudo_loop.cc:2564).
"""

from __future__ import annotations

import numpy as np

from ..params.io_par import INF, MAXLOOP, TURN
from ..params.pk import PKPenalties
from ..params.scaling import ScaledParams
from ..precompute import SeqTables

# interval types (reference: src/constants.hh)
FREE, LOOP, M_WM, M_WMv, M_WMp = "W", "V", "B", "v", "p"
P_P, P_PK, P_PL, P_PR, P_PM, P_PO = "P", "k", "l", "r", "m", "o"
P_PfromL, P_PfromR, P_PfromM, P_PfromMprime, P_PfromMdp, P_PfromO = (
    "f", "g", "h", "[", "]", "i")
P_PLiloop, P_PLmloop, P_PLmloop00, P_PLmloop01, P_PLmloop10 = "j", "c", "a", "n", "e"
P_PRiloop, P_PRmloop, P_PRmloop00, P_PRmloop01, P_PRmloop10 = "q", "t", "9", "&", "u"
P_PMiloop, P_PMmloop, P_PMmloop00, P_PMmloop01, P_PMmloop10 = "w", "y", "8", "1", "0"
P_POiloop, P_POmloop, P_POmloop00, P_POmloop01, P_POmloop10 = "z", "+", "_", "=", "-"
P_WB, P_WBP, P_WP, P_WPP = "*", "^", "#", "@"

HAIRP, INTER, MULTI = 1, 2, 3  # Vtype codes from the fill

# CCJ_DEBUG=1 turns on DP-state invariant checks: interval bounds on every
# stack push, pair-conflict detection, and end-of-run structure balance —
# the fail-loudly semantics of the reference's backtrack
# (src/pseudo_loop.cc:874-915), which release builds skip for speed.
import os as _os

_DEBUG = bool(_os.environ.get("CCJ_DEBUG"))
_P_TYPES = frozenset(
    [P_P, P_PK, P_PL, P_PR, P_PM, P_PO,
     P_PfromL, P_PfromR, P_PfromM, P_PfromMprime, P_PfromMdp, P_PfromO,
     P_PLiloop, P_PLmloop, P_PLmloop00, P_PLmloop01, P_PLmloop10,
     P_PRiloop, P_PRmloop, P_PRmloop00, P_PRmloop01, P_PRmloop10,
     P_PMiloop, P_PMmloop, P_PMmloop00, P_PMmloop01, P_PMmloop10,
     P_POiloop, P_POmloop, P_POmloop00, P_POmloop01, P_POmloop10])


class Traceback:
    def __init__(self, tabs: SeqTables, P: ScaledParams, pk: PKPenalties, mats):
        self.t = tabs
        self.P = P
        self.pk = pk
        self.m = mats
        self.n = tabs.n
        self.dangles = P.dangles
        self.f_pair = np.full(self.n + 2, -1, dtype=np.int64)
        self.stack = []

    # ---- matrix accessors (reference get semantics) ----------------------
    def V(self, i, j):
        if i >= j:
            return INF
        return int(self.m["V"][i, j])

    def Vtype(self, i, j):
        return int(self.m["Vtype"][i, j])

    def _tri(self, name, i, j):
        if i >= j:
            return INF
        return int(self.m[name][i, j])

    def WM(self, i, j):
        return self._tri("WM", i, j)

    def WMv(self, i, j):
        return self._tri("WMv", i, j)

    def WMp(self, i, j):
        return self._tri("WMp", i, j)

    def P2(self, i, j):
        # TriangleMatrix::get — return_val INF only for i > j
        if i > j:
            return INF
        return int(self.m["P2"][i, j])

    def WBPg(self, i, j):
        if i > j:
            return INF
        return int(self.m["WBP"][i, j])

    def WPPg(self, i, j):
        if i > j:
            return INF
        return int(self.m["WPP"][i, j])

    def WB(self, i, j):
        n = self.n
        if i <= 0 or j <= 0 or i > n or j > n:
            return INF
        if i > j:
            return 0
        return min(self.pk.cp * (j - i + 1), self.WBPg(i, j))

    def WP(self, i, j):
        n = self.n
        if i <= 0 or j <= 0 or i > n or j > n:
            return INF
        if i > j:
            return 0
        return min(self.pk.PUP * (j - i + 1), self.WPPg(i, j))

    def g4(self, name, i, j, k, l):
        """Matrix4D::get."""
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        return int(self.m[name][k - j - 2, l - i, i, j])

    # ---- energy kernels (host lookups into precomputed tables) -----------
    def e_stP(self, i, j):
        return int(self.t.ESTP[i, j])

    def e_intP(self, i, d, dp, j):
        return int(self.t.EINTP[d - i, j - dp, i, j])

    def v_int(self, i, j, k, l):
        """s_energy_matrix::compute_int = E_IntLoop + V(k,l)."""
        return int(self.t.EINT[k - i, j - l, i, j]) + self.V(k, l)

    def mb(self, name, i, j):
        return int(getattr(self.t, name)[i, j])

    # ---- iloop helpers (pseudo_loop.cc:682-820) --------------------------
    def PLiloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        if not self.t.can_pair[i, j]:
            return INF
        e = INF
        if i + TURN + 2 < j:
            e = self.g4("PL", i + 1, j - 1, k, l) + self.e_stP(i, j)
        for d in range(i + 1, min(j, i + MAXLOOP)):
            for dp in range(j - 1, max(d + TURN, j - MAXLOOP), -1):
                if not self.t.can_pair[d, dp]:
                    continue
                e = min(e, self.e_intP(i, d, dp, j) + self.g4("PL", d, dp, k, l))
        return e

    def PLmloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        return min(
            self.g4("PLmloop10", i + 1, j - 1, k, l),
            self.g4("PLmloop01", i + 1, j - 1, k, l),
        ) + self.pk.ap + self.pk.bp

    def PRiloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        if not self.t.can_pair[k, l]:
            return INF
        e = INF
        if k + TURN + 2 < l:
            e = self.g4("PR", i, j, k + 1, l - 1) + self.e_stP(k, l)
        for d in range(k + 1, min(l, k + MAXLOOP)):
            for dp in range(l - 1, max(d + TURN, l - MAXLOOP), -1):
                if not self.t.can_pair[d, dp]:
                    continue
                e = min(e, self.e_intP(k, d, dp, l) + self.g4("PR", i, j, d, dp))
        return e

    def PRmloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        return min(
            self.g4("PRmloop10", i, j, k + 1, l - 1),
            self.g4("PRmloop01", i, j, k + 1, l - 1),
        ) + self.pk.ap + self.pk.bp

    def PMiloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        if not self.t.can_pair[j, k]:
            return INF
        e = INF
        if i < j and k < l:
            e = self.g4("PM", i, j - 1, k + 1, l) + self.e_stP(j - 1, k + 1)
        for d in range(j - 1, max(i, j - MAXLOOP), -1):
            for dp in range(k + 1, min(l, k + MAXLOOP)):
                if not self.t.can_pair[d, dp]:
                    continue
                e = min(e, self.e_intP(d, j, k, dp) + self.g4("PM", i, d, dp, l))
        return e

    def PMmloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        return min(
            self.g4("PMmloop10", i, j - 1, k + 1, l),
            self.g4("PMmloop01", i, j - 1, k + 1, l),
        ) + self.pk.ap + self.pk.bp

    def POiloop(self, i, j, k, l):
        # generic interior branch reads an invalid tuple (pseudo_loop.cc:804)
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        if not self.t.can_pair[i, l]:
            return INF
        e = INF
        if i < j and k < l:
            e = self.g4("PO", i + 1, j, k, l - 1) + self.e_stP(i, l)
        return e

    def POmloop(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        return min(
            self.g4("POmloop10", i + 1, j, k, l - 1),
            self.g4("POmloop01", i + 1, j, k, l - 1),
        ) + self.pk.ap + self.pk.bp

    def PfromMdp(self, i, j, k, l):
        if not (i <= j and j < k - 1 and k <= l):
            return INF
        if i == j and k == l:
            return 0 if self.t.ptype[i, l] > 0 else INF
        return min(
            self.g4("PL", i, j, k, l) + self.pk.PB,
            self.g4("PR", i, j, k, l) + self.pk.PB,
        )

    # ---- stack machine ---------------------------------------------------
    def push(self, typ, i, j, k=-1, l=-1):
        if _DEBUG:
            # reference semantics: impossible DP states fail loudly
            # (pseudo_loop.cc:874-915 "This should not have happened!")
            n = self.n
            bad = not (0 <= i <= n + 1 and 0 <= j <= n + 1)
            if typ in _P_TYPES:
                # P-family intervals carry (i, l, j, k): a degenerate split
                # (the reference's "no finite candidate" zeros) is an
                # impossible DP state
                bad = bad or not (1 <= i <= j <= n)
            elif k != -1 or l != -1:
                bad = bad or not (-1 <= k <= n + 1 and -1 <= l <= n + 1)
            if bad:
                raise RuntimeError(
                    f"This should not have happened! (interval {typ!r} "
                    f"i={i} j={j} k={k} l={l}, n={n})")
        self.stack.append((typ, i, j, k, l))

    def set_pair(self, a, b):
        if _DEBUG and (self.f_pair[a] not in (-1, b)
                       or self.f_pair[b] not in (-1, a)):
            raise RuntimeError(
                f"This should not have happened! (pair ({a},{b}) conflicts "
                f"with ({a},{int(self.f_pair[a])})/"
                f"({b},{int(self.f_pair[b])}))")
        self.f_pair[a] = b
        self.f_pair[b] = a

    # ---- exterior W pass (W_final.cc:68-79) ------------------------------
    def compute_W(self):
        n, t, d = self.n, self.t, self.dangles
        W = np.zeros(n + 1, dtype=np.int64)
        for j in range(TURN + 1, n + 1):
            m1 = W[j - 1]
            m2 = INF
            m3 = INF
            for k in range(1, j - TURN):
                acc = W[k - 1] if k > 1 else 0
                m2 = min(m2, acc + self.ext_stem(k, j))
                m3 = min(
                    m3,
                    acc
                    + min(
                        self.P2(k, j), self.P2(k + 1, j),
                        self.P2(k, j - 1), self.P2(k + 1, j - 1),
                    )
                    + self.pk.PS,
                )
            W[j] = min(m1, m2, m3)
        self.W = W
        return W

    def ext_stem(self, i, j):
        """W_final::E_ext_Stem (W_final.cc:118-173)."""
        t, d = self.t, self.dangles
        e = INF
        en = self.V(i, j)
        if en != INF:
            en += int((t.EXT2 if d == 2 else t.EXT0)[i, j])
            e = min(e, en)
        if d == 1:
            en = self.V(i + 1, j) if j - i - 1 > TURN else INF
            if en != INF:
                e = min(e, en + int(t.EXT_ip1[i, j]))
            en = self.V(i, j - 1) if j - 1 - i > TURN else INF
            if en != INF:
                e = min(e, en + int(t.EXT_jm1[i, j]))
            en = self.V(i + 1, j - 1) if j - 1 - i - 1 > TURN else INF
            if en != INF:
                e = min(e, en + int(t.EXT_both[i, j]))
        return e

    def ml_stem(self, i, j):
        """s_energy_matrix::E_MLStem (s_energy_matrix.cc:54-112)."""
        t, d = self.t, self.dangles
        e = INF
        en = self.V(i, j)
        if en != INF:
            en += int((t.ML2 if d == 2 else t.ML0)[i, j])
            e = min(e, en)
        if d == 1:
            MLb = self.P.MLbase
            en = self.V(i + 1, j) if j - i - 1 > TURN else INF
            if en != INF:
                e = min(e, en + MLb + int(t.ML_ip1[i, j]))
            en = self.V(i, j - 1) if j - 1 - i > TURN else INF
            if en != INF:
                e = min(e, en + MLb + int(t.ML_jm1[i, j]))
            en = self.V(i + 1, j - 1) if j - 1 - i - 1 > TURN else INF
            if en != INF:
                e = min(e, en + 2 * MLb + int(t.ML_both[i, j]))
        return e

    # ---- driver ----------------------------------------------------------
    def run(self):
        n = self.n
        self.compute_W()
        self.stack = [(FREE, 1, n, -1, -1)]
        while self.stack:
            typ, i, j, k, l = self.stack.pop()
            self.dispatch(typ, i, j, k, l)
        structure = self.fill_structure()
        if _DEBUG:
            pair = self.f_pair
            for a in range(1, n + 1):
                b = int(pair[a])
                if b != -1 and int(pair[b]) != a:
                    raise RuntimeError(
                        "This should not have happened! (asymmetric pair "
                        f"{a}<->{b})")
            opens = sum(structure.count(c) for c in "([{<")
            closes = sum(structure.count(c) for c in ")]}>")
            if opens != closes:
                raise RuntimeError(
                    "This should not have happened! (unbalanced structure "
                    f"{opens} openers vs {closes} closers)")
        return int(self.W[n]), structure

    def dispatch(self, typ, i, j, k, l):
        fn = CASES.get(typ)
        if fn is None:
            raise RuntimeError(f"unknown interval type {typ!r}")
        fn(self, i, j, k, l)

    # ---- W_final cases ---------------------------------------------------
    def case_free(self, I, j, *_):
        """FREE (W_final.cc:344-539); the interval is always (1, j)."""
        n, d, pk = self.n, self.dangles, self.pk
        if j == 1:
            return
        W = self.W
        best = INF
        best_row, best_i = -1, -1
        if W[j - 1] < best:
            best = W[j - 1]
            best_row = 0
        for i in range(1, j):
            acc = W[i - 1] if i > 1 else 0
            eij = self.V(i, j)
            if eij < INF:
                tmp = eij + int((self.t.EXT2 if d == 2 else self.t.EXT0)[i, j]) + acc
                if tmp < best:
                    best, best_i, best_row = tmp, i, 1
            if d == 1:
                eij = self.V(i + 1, j)
                if eij < INF:
                    tmp = eij + int(self.t.EXT_ip1[i, j]) + acc
                    if tmp < best:
                        best, best_i, best_row = tmp, i, 2
                eij = self.V(i, j - 1)
                if eij < INF:
                    tmp = eij + int(self.t.EXT_jm1[i, j]) + acc
                    if tmp < best:
                        best, best_i, best_row = tmp, i, 3
                eij = self.V(i + 1, j - 1)
                if eij < INF:
                    tmp = eij + int(self.t.EXT_both[i, j]) + acc
                    if tmp < best:
                        best, best_i, best_row = tmp, i, 4
        for i in range(1, j):
            acc = W[i - 1] if i - 1 > 0 else 0
            eij = self.P2(i, j)
            if eij < INF:
                tmp = eij + pk.PS + acc
                if tmp < best:
                    best, best_row, best_i = tmp, 5, i
            if d == 1:
                eij = self.P2(i + 1, j)
                if eij < INF:
                    tmp = eij + pk.PS + acc
                    if tmp < best:
                        best, best_row, best_i = tmp, 6, i
                eij = self.P2(i, j - 1)
                if eij < INF:
                    tmp = eij + pk.PS + acc
                    if tmp < best:
                        best, best_row, best_i = tmp, 7, i
                eij = self.P2(i + 1, j - 1)
                if eij < INF:
                    tmp = eij + pk.PS + acc
                    if tmp < best:
                        best, best_row, best_i = tmp, 8, i
        bi = best_i
        if best_row == 0:
            self.push(FREE, 1, j - 1)
        elif best_row == 1:
            self.push(LOOP, bi, j)
            if bi - 1 > 1:
                self.push(FREE, 1, bi - 1)
        elif best_row == 2:
            self.push(LOOP, bi + 1, j)
            if bi >= 1:
                self.push(FREE, 1, bi)
        elif best_row == 3:
            self.push(LOOP, bi, j - 1)
            if bi - 1 > 1:
                self.push(FREE, 1, bi - 1)
        elif best_row == 4:
            self.push(LOOP, bi + 1, j - 1)
            if bi >= 1:
                self.push(FREE, 1, bi)
        elif best_row == 5:
            self.push(P_P, bi, j)
            if bi - 1 > 1:
                self.push(FREE, 1, bi - 1)
        elif best_row == 6:
            self.push(P_P, bi + 1, j)
            if bi >= 1:
                self.push(FREE, 1, bi)
        elif best_row == 7:
            self.push(P_P, bi, j - 1)
            if bi - 1 > 1:
                self.push(FREE, 1, bi - 1)
        elif best_row == 8:
            self.push(P_P, bi + 1, j - 1)
            if bi >= 1:
                self.push(FREE, 1, bi)

    def case_loop(self, i, j, *_):
        """LOOP (W_final.cc:179-342)."""
        if i >= j:
            return
        self.set_pair(i, j)
        vt = self.Vtype(i, j)
        if vt == INTER:
            best = INF
            best_ip, best_jp = j, i
            max_ip = min(j - TURN - 2, i + MAXLOOP + 1)
            for k in range(i + 1, max_ip + 1):
                min_l = max(k + TURN + 1 + MAXLOOP + 2, k + j - i) - MAXLOOP - 2
                for lp in range(j - 1, min_l - 1, -1):
                    tmp = self.v_int(i, j, k, lp)
                    if tmp < best:
                        best, best_ip, best_jp = tmp, k, lp
            if best_ip < best_jp:
                self.push(LOOP, best_ip, best_jp)
            else:
                raise RuntimeError("NOT GOOD RESTR INTER")
        elif vt == MULTI:
            t, P = self.t, self.P
            MLb = P.MLbase
            best_k, best_row = -1, -1
            best = INF
            for k in range(i + 1, j):
                vmp = min(self.WMv(k, j - 1), self.WMp(k, j - 1))
                vmp2 = min(self.WMv(k, j - 2), self.WMp(k, j - 2))
                tmp = self.WM(i + 1, k - 1) + vmp + int(t.MB0[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 1
                tmp = self.WM(i + 2, k - 1) + vmp + int(t.MB_5[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 2
                tmp = self.WM(i + 1, k - 1) + vmp2 + int(t.MB_3[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 3
                tmp = self.WM(i + 2, k - 1) + vmp2 + int(t.MB_53[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 4
                tmp = (k - i - 1) * MLb + self.WMp(k, j - 1) + int(t.MB0[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 5
                if k - (i + 1) - 1 >= 0:
                    tmp = (k - i - 2) * MLb + self.WMp(k, j - 1) + int(t.MB_5[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 6
                tmp = (k - i - 1) * MLb + self.WMp(k, j - 2) + int(t.MB_3[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 7
                if k - (i + 1) - 1 >= 0:
                    tmp = (k - i - 2) * MLb + self.WMp(k, j - 2) + int(t.MB_53[i, j])
                if tmp < best:
                    best, best_k, best_row = tmp, k, 8
            bk = best_k
            if best_row in (1, 2):
                self.push(M_WM, i + 1 if best_row == 1 else i + 2, bk - 1)
                self.push(M_WM, bk, j - 1)
            elif best_row in (3, 4):
                self.push(M_WM, i + 1 if best_row == 3 else i + 2, bk - 1)
                self.push(M_WM, bk, j - 2)
            elif best_row in (5, 6):
                self.push(M_WM, bk, j - 1)
            elif best_row in (7, 8):
                self.push(M_WM, bk, j - 2)

    def case_wm(self, i, j, *_):
        """M_WM (W_final.cc:541-595)."""
        MLb = self.P.MLbase
        best = self.WM(i, j - 1) + MLb
        best_row, best_k = 5, j
        for k in range(i, j - TURN):
            m1 = (k - i) * MLb + self.WMv(k, j)
            if m1 < best:
                best, best_k, best_row = m1, k, 1
            m2 = (k - i) * MLb + self.WMp(k, j)
            if m2 < best:
                best, best_k, best_row = m2, k, 2
            m3 = self.WM(i, k - 1) + self.WMv(k, j)
            if m3 < best:
                best, best_k, best_row = m3, k, 3
            m4 = self.WM(i, k - 1) + self.WMp(k, j)
            if m4 < best:
                best, best_k, best_row = m4, k, 4
        bk = best_k
        if best_row == 1:
            self.push(M_WMv, bk, j)
        elif best_row == 2:
            self.push(M_WMp, bk, j)
        elif best_row == 3:
            self.push(M_WM, i, bk - 1)
            self.push(M_WMv, bk, j)
        elif best_row == 4:
            # quirk preserved: recurses into (best_k+1, j) (W_final.cc:590)
            self.push(M_WM, i, bk - 1)
            self.push(M_WMp, bk + 1, j)
        elif best_row == 5:
            self.push(M_WM, i, j - 1)

    def case_wmv(self, i, j, *_):
        """M_WMv (W_final.cc:597-644)."""
        t, d = self.t, self.dangles
        MLb = self.P.MLbase
        best = self.V(i, j) + int((t.ML2 if d == 2 else t.ML0)[i, j])
        best_row = 1
        if d == 1:
            tmp = self.V(i + 1, j) + int(t.ML_ip1[i, j]) + MLb
            if tmp < best:
                best, best_row = tmp, 2
            tmp = self.V(i, j - 1) + int(t.ML_jm1[i, j]) + MLb
            if tmp < best:
                best, best_row = tmp, 3
            tmp = self.V(i + 1, j - 1) + int(t.ML_both[i, j]) + 2 * MLb
            if tmp < best:
                best, best_row = tmp, 4
        tmp = self.WMv(i, j - 1) + MLb
        if tmp < best:
            best, best_row = tmp, 5
        if best_row == 1:
            self.push(LOOP, i, j)
        elif best_row == 2:
            self.push(LOOP, i + 1, j)
        elif best_row == 3:
            self.push(LOOP, i, j - 1)
        elif best_row == 4:
            self.push(LOOP, i + 1, j - 1)
        elif best_row == 5:
            self.push(M_WMv, i, j - 1)

    def case_wmp(self, i, j, *_):
        """M_WMp (W_final.cc:646-665); quirk: the P branch pushes nothing
        (case 1 is commented out in the reference)."""
        best = self.P2(i, j) + self.pk.PSM + self.pk.b
        best_row = 1
        tmp = self.WMp(i, j - 1) + self.P.MLbase
        if tmp < best:
            best, best_row = tmp, 2
        if best_row == 2:
            self.push(M_WMp, i, j - 1)

    # ---- pseudo_loop cases (interval carries (i, l, j, k)) ---------------
    def case_p(self, i, l, *_):
        """P_P (pseudo_loop.cc:867-897).

        Vectorized over the (j, d, k) candidate cube: the strict-< update
        of the reference's sequential scan keeps the FIRST minimum in
        (j, d, k) lexicographic order, which is exactly what np.argmin
        returns on the C-ordered cube — so the recovered split is
        bit-identical, at numpy speed instead of an O(n^3) Python loop
        (n=200: ~0.1s vs minutes)."""
        if i >= l:
            raise RuntimeError("border case P_P")
        if hasattr(self.m, "case_p_argmin"):
            # lazy device-backed matrices: the O(n^3) cube argmin runs on
            # device and only the split indices come back (engine/lazy.py)
            bj, bd, bk, _v = self.m.case_p_argmin(i, l)
            if _DEBUG and _v >= 32767:
                # a P entry points here but every split candidate is built
                # from unset (int16-saturated) cells: impossible DP state
                raise RuntimeError(
                    "This should not have happened! (P split at "
                    f"({i},{l}) has no computed candidate, best={_v})")
            self.push(P_PK, i, bk, bj, bd + 1)
            self.push(P_PK, bj + 1, l, bd, bk + 1)
            return
        PK = self.m["PK"]
        m = l - i  # j, d, k live in [i, l): index by offsets 0..m-1
        jj = i + np.arange(m)[:, None, None]
        dd = i + np.arange(m)[None, :, None]
        kk = i + np.arange(m)[None, None, :]
        ok = (dd >= jj + 1) & (kk >= dd + 1)

        def g4v(ii_, jj_, kk_, ll_):
            valid = (ii_ <= jj_) & (jj_ < kk_ - 1) & (kk_ <= ll_)
            tt = np.clip(kk_ - jj_ - 2, 0, PK.shape[0] - 1)
            ss = np.clip(ll_ - ii_, 0, PK.shape[1] - 1)
            v = PK[tt, ss, np.clip(ii_, 0, PK.shape[2] - 1),
                   np.clip(jj_, 0, PK.shape[3] - 1)].astype(np.int64)
            return np.where(valid, v, INF)

        vals = g4v(np.asarray(i), jj, dd + 1, kk) + \
            g4v(jj + 1, dd, kk + 1, np.asarray(l))
        vals = np.where(ok, vals, np.int64(INF) * 4)
        flat = int(np.argmin(vals))
        best = int(vals.flat[flat])
        if _DEBUG and best >= 32767:
            # every candidate is unset (int16-saturated) or out of range:
            # the P entry pointing here is an impossible DP state
            raise RuntimeError(
                "This should not have happened! (P split at "
                f"({i},{l}) has no computed candidate, best={best})")
        if best >= INF:
            bj = bd = bk = 0  # no finite candidate: reference leaves zeros
        else:
            oj, od, ok_ = np.unravel_index(flat, vals.shape)
            bj, bd, bk = int(i + oj), int(i + od), int(i + ok_)
        self.push(P_PK, i, bk, bj, bd + 1)
        self.push(P_PK, bj + 1, l, bd, bk + 1)

    def case_pk(self, i, l, j, k):
        """P_PK (pseudo_loop.cc:899-997)."""
        best = INF
        best_row, best_d = -1, -1
        for d in range(i + 1, j):
            tmp = self.g4("PK", i, d, k, l) + self.WP(d + 1, j)
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
        for d in range(k + 1, l):
            tmp = self.g4("PK", i, j, d, l) + self.WP(k, d - 1)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        tmp = self.g4("PL", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 3, -1
        tmp = self.g4("PM", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 4, -1
        tmp = self.g4("PR", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 5, -1
        tmp = self.g4("PO", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 6, -1
        if best_row == 1 and best_d > -1:
            self.push(P_PK, i, l, best_d, k)
            self.push(P_WP, best_d + 1, j)
        elif best_row == 2 and best_d > -1:
            self.push(P_PK, i, l, j, best_d)
            self.push(P_WP, k, best_d - 1)
        elif best_row == 3:
            self.push(P_PL, i, l, j, k)
        elif best_row == 4:
            self.push(P_PM, i, l, j, k)
        elif best_row == 5:
            self.push(P_PR, i, l, j, k)
        elif best_row == 6:
            self.push(P_PO, i, l, j, k)

    def case_pl(self, i, l, j, k):
        """P_PL (pseudo_loop.cc:1000-1064)."""
        best, best_row = INF, -1
        if self.t.ptype[i, j] > 0:
            tmp = self.PLiloop(i, j, k, l)
            if tmp < best:
                best, best_row = tmp, 1
            tmp = self.PLmloop(i, j, k, l) + self.pk.bp
            if tmp < best:
                best, best_row = tmp, 2
            if j >= i + TURN + 1:
                tmp = self.g4("PfromL", i + 1, j - 1, k, l)
                if tmp < best:
                    best, best_row = tmp, 3
        if best_row == 1:
            self.push(P_PLiloop, i, l, j, k)
        elif best_row == 2:
            self.push(P_PLmloop, i, l, j, k)
        elif best_row == 3:
            self.push(P_PfromL, i + 1, l, j - 1, k)
            self.set_pair(i, j)

    def case_pr(self, i, l, j, k):
        """P_PR (pseudo_loop.cc:1067-1129)."""
        best, best_row = INF, -1
        if self.t.ptype[k, l] > 0:
            tmp = self.PRiloop(i, j, k, l)
            if tmp < best:
                best, best_row = tmp, 1
            tmp = self.PRmloop(i, j, k, l) + self.pk.bp
            if tmp < best:
                best, best_row = tmp, 2
            if l >= k + TURN + 1:
                tmp = self.g4("PfromR", i, j, k + 1, l - 1)
                if tmp < best:
                    best, best_row = tmp, 3
        if best_row == 1:
            self.push(P_PRiloop, i, l, j, k)
        elif best_row == 2:
            self.push(P_PRmloop, i, l, j, k)
        elif best_row == 3:
            self.push(P_PfromR, i, l - 1, j, k + 1)
            self.set_pair(k, l)

    def case_pm(self, i, l, j, k):
        """P_PM (pseudo_loop.cc:1132-1199)."""
        if i == j and k == l:
            self.set_pair(j, k)
            return
        best, best_row = INF, -1
        if self.t.ptype[j, k] > 0:
            tmp = self.PMiloop(i, j, k, l)
            if tmp < best:
                best, best_row = tmp, 1
            tmp = self.PMmloop(i, j, k, l) + self.pk.bp
            if tmp < best:
                best, best_row = tmp, 2
            if k >= j + TURN - 1:
                tmp = self.g4("PfromM", i, j - 1, k + 1, l)
                if tmp < best:
                    best, best_row = tmp, 3
        if best_row == 1:
            self.push(P_PMiloop, i, l, j, k)
        elif best_row == 2:
            self.push(P_PMmloop, i, l, j, k)
        elif best_row == 3:
            self.push(P_PfromM, i, l, j - 1, k + 1)
            self.set_pair(j, k)

    def case_po(self, i, l, j, k):
        """P_PO (pseudo_loop.cc:1202-1260)."""
        best, best_row = INF, -1
        if self.t.ptype[i, l] > 0:
            tmp = self.POiloop(i, j, k, l)
            if tmp < best:
                best, best_row = tmp, 1
            tmp = self.POmloop(i, j, k, l) + self.pk.bp
            if tmp < best:
                best, best_row = tmp, 2
            if l >= i + TURN + 1:
                tmp = self.g4("PfromO", i + 1, j, k, l - 1)
                if tmp < best:
                    best, best_row = tmp, 3
        if best_row == 1:
            self.push(P_POiloop, i, l, j, k)
        elif best_row == 2:
            self.push(P_POmloop, i, l, j, k)
        elif best_row == 3:
            self.push(P_PfromO, i + 1, l - 1, j, k)
            self.set_pair(i, l)

    def case_froml(self, i, l, j, k):
        """P_PfromL (pseudo_loop.cc:1263-1354)."""
        if i == j and k == l:
            return
        best, best_row, best_d = INF, -1, -1
        for d in range(i + 1, j):
            tmp = self.g4("PfromL", d, j, k, l) + self.WP(i, d - 1)
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
            tmp = self.g4("PfromL", i, d, k, l) + self.WP(d + 1, j)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        tmp = self.g4("PR", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 3, -1
        tmp = self.g4("PM", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 4, -1
        tmp = self.g4("PO", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 5, -1
        if best_row == 1 and best_d > -1:
            self.push(P_PfromL, best_d, l, j, k)
            self.push(P_WP, i, best_d - 1)
        elif best_row == 2 and best_d > -1:
            self.push(P_PfromL, i, l, best_d, k)
            self.push(P_WP, best_d + 1, j)
        elif best_row == 3:
            self.push(P_PR, i, l, j, k)
        elif best_row == 4:
            self.push(P_PM, i, l, j, k)
        elif best_row == 5:
            self.push(P_PO, i, l, j, k)

    def case_fromr(self, i, l, j, k):
        """P_PfromR (pseudo_loop.cc:1356-1436)."""
        if i == j and k == l:
            return
        best, best_row, best_d = INF, -1, -1
        for d in range(k + 1, l):
            tmp = self.g4("PfromR", i, j, d, l) + self.WP(k, d - 1)
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
            tmp = self.g4("PfromR", i, j, k, d) + self.WP(d + 1, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        tmp = self.g4("PM", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 3, -1
        tmp = self.g4("PO", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 4, -1
        if best_row == 1 and best_d > -1:
            self.push(P_PfromR, i, l, j, best_d)
            self.push(P_WP, k, best_d - 1)
        elif best_row == 2 and best_d > -1:
            self.push(P_PfromR, i, best_d, j, k)
            self.push(P_WP, best_d + 1, l)
        elif best_row == 3:
            self.push(P_PM, i, l, j, k)
        elif best_row == 4:
            self.push(P_PO, i, l, j, k)

    def case_fromm(self, i, l, j, k):
        """P_PfromM (pseudo_loop.cc:1439-1480)."""
        if i == j and k == l:
            return
        best, best_d = INF, -1
        for d in range(i + 1, j):
            tmp = self.g4("PfromMprime", i, d, k, l) + self.WP(d + 1, j)
            if tmp < best:
                best, best_d = tmp, d
        if best_d > -1:
            self.push(P_PfromMprime, i, l, best_d, k)
            self.push(P_WP, best_d + 1, j)

    def case_frommprime(self, i, l, j, k):
        """P_PfromMprime (pseudo_loop.cc:1482-1522)."""
        if i == j and k == l:
            return
        best, best_d = INF, -1
        for d in range(k + 1, l):
            tmp = self.PfromMdp(i, j, d, l) + self.WP(k, d - 1)
            if tmp < best:
                best, best_d = tmp, d
        if best_d > -1:
            self.push(P_PfromMdp, i, l, j, best_d)
            self.push(P_WP, k, best_d - 1)

    def case_frommdp(self, i, l, j, k):
        """P_PfromMdoubleprime (pseudo_loop.cc:1524-1574)."""
        if i == j and k == l:
            return
        best, best_row = INF, -1
        tmp = self.g4("PL", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row = tmp, 1
        tmp = self.g4("PR", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row = tmp, 2
        if best_row == 1:
            self.push(P_PL, i, l, j, k)
        elif best_row == 2:
            self.push(P_PR, i, l, j, k)

    def case_fromo(self, i, l, j, k):
        """P_PfromO (pseudo_loop.cc:1576-1659)."""
        if i == j and k == l:
            return
        best, best_row, best_d = INF, -1, -1
        for d in range(i + 1, j):
            tmp = self.g4("PfromO", d, j, k, l) + self.WP(i, d - 1)
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
        for d in range(k + 1, l):
            tmp = self.g4("PfromO", i, j, k, d) + self.WP(d + 1, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        tmp = self.g4("PL", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 3, -1
        tmp = self.g4("PR", i, j, k, l) + self.pk.PB
        if tmp < best:
            best, best_row, best_d = tmp, 4, -1
        if best_row == 1 and best_d > -1:
            self.push(P_PfromO, best_d, l, j, k)
            self.push(P_WP, i, best_d - 1)
        elif best_row == 2 and best_d > -1:
            self.push(P_PfromO, i, best_d, j, k)
            self.push(P_WP, best_d + 1, l)
        elif best_row == 3:
            self.push(P_PL, i, l, j, k)
        elif best_row == 4:
            self.push(P_PR, i, l, j, k)

    def case_wb(self, i, l, *_):
        """P_WB (pseudo_loop.cc:1660-1700)."""
        if i > l:
            return
        best, best_row = INF, -1
        tmp = self.WBPg(i, l)
        if tmp < best:
            best, best_row = tmp, 1
        tmp = self.pk.cp * (l - i + 1)
        if tmp < best:
            best, best_row = tmp, 2
        if best_row == 1:
            self.push(P_WBP, i, l)

    def case_wbp(self, i, l, *_):
        """P_WBP (pseudo_loop.cc:1701-1756)."""
        best, best_row, best_d = INF, -1, -1
        for d in range(i, l):
            tmp = self.WB(i, d - 1) + self.V(d, l) + self.pk.bp + self.pk.PPS
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
            tmp = self.WB(i, d - 1) + self.P2(d, l) + self.pk.PSM + self.pk.PPS
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        tmp = self.WBPg(i, l - 1) + self.pk.cp
        if tmp < best:
            best, best_row = tmp, 3
        if best_row == 1:
            self.push(P_WB, i, best_d - 1)
            self.push(LOOP, best_d, l)
        elif best_row == 2:
            self.push(P_WB, i, best_d - 1)
            self.push(P_P, best_d, l)
        elif best_row == 3:
            self.push(P_WBP, i, l - 1)

    def case_wp(self, i, l, *_):
        """P_WP (pseudo_loop.cc:1758-1798)."""
        if i > l:
            return
        best, best_row = INF, -1
        tmp = self.WPPg(i, l)
        if tmp < best:
            best, best_row = tmp, 1
        tmp = self.pk.PUP * (l - i + 1)
        if tmp < best:
            best, best_row = tmp, 2
        if best_row == 1:
            self.push(P_WPP, i, l)

    def case_wpp(self, i, l, *_):
        """P_WPP (pseudo_loop.cc:1799-1854)."""
        best, best_row, best_d = INF, -1, -1
        for d in range(i, l):
            tmp = self.WP(i, d - 1) + self.V(d, l) + self.pk.PPS
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
            tmp = self.WP(i, d - 1) + self.P2(d, l) + self.pk.PSP + self.pk.PPS
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        tmp = self.WPPg(i, l - 1) + self.pk.PUP
        if tmp < best:
            best, best_row = tmp, 3
        if best_row == 1:
            self.push(P_WP, i, best_d - 1)
            self.push(LOOP, best_d, l)
        elif best_row == 2:
            self.push(P_WP, i, best_d - 1)
            self.push(P_P, best_d, l)
        elif best_row == 3:
            self.push(P_WPP, i, l - 1)

    def case_pliloop(self, i, l, j, k):
        """P_PLiloop (pseudo_loop.cc:1855-1913)."""
        self.set_pair(i, j)
        best, best_row, bd, bdp = INF, -1, -1, -1
        if self.t.ptype[i, j] > 0:
            tmp = self.g4("PL", i + 1, j - 1, k, l) + self.e_stP(i, j)
            if tmp < best:
                best, best_row = tmp, 1
            for d in range(i + 1, min(j, i + MAXLOOP)):
                for dp in range(j - 1, max(d + TURN, j - MAXLOOP), -1):
                    tmp = self.e_intP(i, d, dp, j) + self.g4("PL", d, dp, k, l)
                    if tmp < best:
                        best, bd, bdp, best_row = tmp, d, dp, 2
        if best_row == 1:
            self.push(P_PL, i + 1, l, j - 1, k)
        elif best_row == 2:
            self.push(P_PL, bd, l, bdp, k)

    def case_plmloop(self, i, l, j, k):
        """P_PLmloop (pseudo_loop.cc:1915-1953)."""
        self.set_pair(i, j)
        b1 = self.g4("PLmloop10", i + 1, j - 1, k, l) + self.pk.ap + self.pk.bp
        b2 = self.g4("PLmloop01", i + 1, j - 1, k, l) + self.pk.ap + self.pk.bp
        if b1 < b2:
            self.push(P_PLmloop10, i + 1, l, j - 1, k)
        else:
            self.push(P_PLmloop01, i + 1, l, j - 1, k)

    def case_plmloop00(self, i, l, j, k):
        """P_PLmloop00 (pseudo_loop.cc:1955-2010)."""
        best = self.g4("PL", i, j, k, l) + self.pk.bp
        best_row, best_d = 1, -1
        for d in range(i, j + 1):
            if d > i:
                tmp = self.WB(i, d - 1) + self.g4("PLmloop00", d, j, k, l)
                if tmp < best:
                    best, best_row, best_d = tmp, 2, d
            if d < j:
                tmp = self.g4("PLmloop00", i, d, k, l) + self.WB(d + 1, j)
                if tmp < best:
                    best, best_row, best_d = tmp, 3, d
        if best_row == 1:
            self.push(P_PL, i, l, j, k)
        elif best_row == 2:
            self.push(P_PLmloop00, best_d, l, j, k)
            self.push(P_WB, i, best_d - 1)
        elif best_row == 3:
            self.push(P_PLmloop00, i, l, best_d, k)
            self.push(P_WB, best_d + 1, j)

    def case_plmloop01(self, i, l, j, k):
        """P_PLmloop01 (pseudo_loop.cc:2011-2041)."""
        best, best_d = INF, -1
        for d in range(i, j):
            tmp = self.g4("PLmloop00", i, d, k, l) + self.WBPg(d + 1, j)
            if tmp < best:
                best, best_d = tmp, d
        self.push(P_PLmloop00, i, l, best_d, k)
        self.push(P_WBP, best_d + 1, j)

    def case_plmloop10(self, i, l, j, k):
        """P_PLmloop10 (pseudo_loop.cc:2042-2089)."""
        best, best_row, best_d = INF, -1, -1
        for d in range(i + 1, j + 1):
            tmp = self.WBPg(i, d - 1) + self.g4("PLmloop00", d, j, k, l)
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
            if d < j:
                tmp = self.g4("PLmloop10", i, d, k, l) + self.WB(d + 1, j)
                if tmp < best:
                    best, best_row, best_d = tmp, 2, d
        if best_row == 1:
            self.push(P_WBP, i, best_d - 1)
            self.push(P_PLmloop00, best_d, l, j, k)
        elif best_row == 2:
            self.push(P_PLmloop10, i, l, best_d, k)
            self.push(P_WB, best_d + 1, j)

    def case_priloop(self, i, l, j, k):
        """P_PRiloop (pseudo_loop.cc:2091-2152)."""
        self.set_pair(k, l)
        best, best_row, bd, bdp = INF, -1, -1, -1
        if self.t.ptype[k, l] > 0:
            tmp = self.g4("PR", i, j, k + 1, l - 1) + self.e_stP(k, l)
            if tmp < best:
                best, best_row = tmp, 1
            for d in range(k + 1, min(l, k + MAXLOOP)):
                for dp in range(l - 1, max(d + TURN, l - MAXLOOP), -1):
                    tmp = self.e_intP(k, d, dp, l) + self.g4("PR", i, j, d, dp)
                    if tmp < best:
                        best, bd, bdp, best_row = tmp, d, dp, 2
        if best_row == 1:
            self.push(P_PR, i, l - 1, j, k + 1)
        elif best_row == 2:
            self.push(P_PR, i, bdp, j, bd)

    def case_prmloop(self, i, l, j, k):
        """P_PRmloop (pseudo_loop.cc:2154-2196)."""
        self.set_pair(k, l)
        b1 = self.g4("PRmloop10", i, j, k + 1, l - 1) + self.pk.ap + self.pk.bp
        b2 = self.g4("PRmloop01", i, j, k + 1, l - 1) + self.pk.ap + self.pk.bp
        if b1 < b2:
            self.push(P_PRmloop10, i, l - 1, j, k + 1)
        else:
            self.push(P_PRmloop01, i, l - 1, j, k + 1)

    def case_prmloop00(self, i, l, j, k):
        """P_PRmloop00 (pseudo_loop.cc:2198-2253); quirk preserved: child
        nodes are pushed with (i, j) as the outer pair (insert_node(i,j,...))."""
        best = self.g4("PR", i, j, k, l) + self.pk.bp
        best_row, best_d = 1, -1
        for d in range(k, l + 1):
            if d > k:
                tmp = self.WB(k, d - 1) + self.g4("PRmloop00", i, j, d, l)
                if tmp < best:
                    best, best_row, best_d = tmp, 2, d
            if d < l:
                tmp = self.g4("PRmloop00", i, j, k, d) + self.WB(d + 1, l)
                if tmp < best:
                    best, best_row, best_d = tmp, 3, d
        if best_row == 1:
            self.push(P_PR, i, j, k, l)
        elif best_row == 2:
            self.push(P_PRmloop00, i, j, best_d, l)
            self.push(P_WB, k, best_d - 1)
        elif best_row == 3:
            self.push(P_PRmloop00, i, j, k, best_d)
            self.push(P_WB, best_d + 1, l)

    def case_prmloop01(self, i, l, j, k):
        """P_PRmloop01 (pseudo_loop.cc:2255-2296)."""
        best = self.g4("PRmloop01", i, j, k, l - 1) + self.pk.cp
        best_row, best_d = 1, -1
        for d in range(k, l):
            tmp = self.g4("PRmloop00", i, j, k, d) + self.WBPg(d + 1, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        if best_row == 1:
            self.push(P_PRmloop01, i, l - 1, j, k)
        elif best_row == 2:
            self.push(P_WBP, best_d + 1, l)
            self.push(P_PRmloop00, i, best_d, j, k)

    def case_prmloop10(self, i, l, j, k):
        """P_PRmloop10 (pseudo_loop.cc:2298-2339)."""
        best = self.g4("PRmloop10", i, j, k + 1, l) + self.pk.cp
        best_row, best_d = 1, -1
        for d in range(k + 1, l + 1):
            tmp = self.WBPg(k, d - 1) + self.g4("PRmloop00", i, j, d, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        if best_row == 1:
            self.push(P_PRmloop10, i, l, j, k + 1)
        elif best_row == 2:
            self.push(P_WBP, k, best_d - 1)
            self.push(P_PRmloop00, i, l, j, best_d)

    def case_pmiloop(self, i, l, j, k):
        """P_PMiloop (pseudo_loop.cc:2341-2398)."""
        self.set_pair(j, k)
        best, best_row, bd, bdp = INF, -1, -1, -1
        if self.t.ptype[j, k] > 0:
            tmp = self.g4("PM", i, j - 1, k + 1, l) + self.e_stP(j - 1, k + 1)
            if tmp < best:
                best, best_row = tmp, 1
            for d in range(j - 1, max(i, j - MAXLOOP), -1):
                for dp in range(k + 1, min(l, k + MAXLOOP)):
                    tmp = self.e_intP(d, j, k, dp) + self.g4("PM", i, d, dp, l)
                    if tmp < best:
                        best, bd, bdp, best_row = tmp, d, dp, 2
        if best_row == 1:
            self.push(P_PM, i, l, j - 1, k + 1)
        elif best_row == 2:
            self.push(P_PM, i, l, bd, bdp)

    def case_pmmloop(self, i, l, j, k):
        """P_PMmloop (pseudo_loop.cc:2399-2436)."""
        self.set_pair(j, k)
        b1 = self.g4("PMmloop10", i, j - 1, k + 1, l) + self.pk.ap + self.pk.bp
        b2 = self.g4("PMmloop01", i, j - 1, k + 1, l) + self.pk.ap + self.pk.bp
        if b1 < b2:
            self.push(P_PMmloop10, i, l, j - 1, k + 1)
        else:
            self.push(P_PMmloop01, i, l, j - 1, k + 1)

    def case_pmmloop00(self, i, l, j, k):
        """P_PMmloop00 (pseudo_loop.cc:2437-2496)."""
        self.set_pair(j, k)
        best = self.g4("PM", i, j, k, l) + self.pk.bp
        best_row, best_d = 1, -1
        for d in range(i, j):
            tmp = self.WB(d + 1, j) + self.g4("PMmloop00", i, d, k, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        for d in range(k + 1, l + 1):
            tmp = self.g4("PMmloop00", i, j, d, l) + self.WB(k, d - 1)
            if tmp < best:
                best, best_row, best_d = tmp, 3, d
        if best_row == 1:
            self.push(P_PM, i, l, j, k)
        elif best_row == 2:
            self.push(P_PMmloop00, i, l, best_d, k)
            self.push(P_WB, best_d + 1, j)
        elif best_row == 3:
            self.push(P_PMmloop00, i, l, j, best_d)
            self.push(P_WB, k, best_d - 1)

    def case_pmmloop01(self, i, l, j, k):
        """P_PMmloop01 (pseudo_loop.cc:2498-2540)."""
        best = self.g4("PMmloop01", i, j, k + 1, l) + self.pk.cp
        best_row, best_d = 1, -1
        for d in range(k + 1, l + 1):
            tmp = self.g4("PMmloop00", i, j, d, l) + self.WBPg(k, d - 1)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        if best_row == 1:
            self.push(P_PMmloop01, i, l, j, k + 1)
        elif best_row == 2:
            self.push(P_PMmloop00, i, l, j, best_d)
            self.push(P_WBP, k, best_d - 1)

    def case_pmmloop10(self, i, l, j, k):
        """P_PMmloop10 (pseudo_loop.cc:2542-2583); quirk preserved: the scan
        uses WBP(d,j) + PMmloop00(i,d-1,k,l), unlike the fill."""
        best = self.g4("PMmloop10", i, j - 1, k, l) + self.pk.cp
        best_row, best_d = 1, -1
        for d in range(i + 1, j):
            tmp = self.WBPg(d, j) + self.g4("PMmloop00", i, d - 1, k, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        if best_row == 1:
            self.push(P_PMmloop10, i, l, j - 1, k)
        elif best_row == 2:
            self.push(P_PMmloop00, i, l, best_d - 1, k)
            self.push(P_WBP, best_d, j)

    def case_poiloop(self, i, l, j, k):
        """P_POiloop (pseudo_loop.cc:2585-2651); branch 2 reads an invalid
        tuple and can never win, but the scan is preserved."""
        self.set_pair(i, l)
        best, best_row, bd, bdp = INF, -1, -1, -1
        if self.t.ptype[i, l] > 0:
            tmp = self.g4("PO", i + 1, j, k, l - 1) + self.e_stP(i, l)
            if tmp < best:
                best, best_row = tmp, 1
            for d in range(i + 1, min(j, i + MAXLOOP)):
                for dp in range(l - 1, max(l - MAXLOOP, k), -1):
                    tmp = self.e_intP(i, d, dp, l) + self.g4("PO", d, j, dp, k)
                    if tmp < best:
                        best, best_row, bd, bdp = tmp, 2, d, dp
        if best_row == 1:
            self.push(P_PO, i + 1, l - 1, j, k)
        elif best_row == 2:
            self.push(P_PO, bd, k, j, bdp)

    def case_pomloop(self, i, l, j, k):
        """P_POmloop (pseudo_loop.cc:2652-2692)."""
        self.set_pair(i, l)
        b1 = self.g4("POmloop10", i + 1, j, k, l - 1) + self.pk.ap + self.pk.bp
        b2 = self.g4("POmloop01", i + 1, j, k, l - 1) + self.pk.ap + self.pk.bp
        if b1 < b2:
            self.push(P_POmloop10, i + 1, l - 1, j, k)
        else:
            self.push(P_POmloop01, i + 1, l - 1, j, k)

    def case_pomloop00(self, i, l, j, k):
        """P_POmloop00 (pseudo_loop.cc:2694-2749); quirk preserved: the
        i-shrink child gap is pushed as P_WBP (insert_node .. P_WBP)."""
        best = self.g4("PO", i, j, k, l) + self.pk.bp
        best_row, best_d = 1, -1
        for d in range(i + 1, j + 1):
            tmp = self.WB(i, d - 1) + self.g4("POmloop00", d, j, k, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        for d in range(k, l):
            tmp = self.g4("POmloop00", i, j, k, d) + self.WB(d + 1, l)
            if tmp < best:
                best, best_row, best_d = tmp, 3, d
        if best_row == 1:
            self.push(P_PO, i, l, j, k)
        elif best_row == 2:
            self.push(P_POmloop00, best_d, l, j, k)
            self.push(P_WBP, i, best_d - 1)
        elif best_row == 3:
            self.push(P_POmloop00, i, best_d, j, k)
            self.push(P_WB, best_d + 1, l)

    def case_pomloop01(self, i, l, j, k):
        """P_POmloop01 (pseudo_loop.cc:2751-2782)."""
        best, best_d = INF, -1
        for d in range(k, l):
            tmp = self.g4("POmloop00", i, j, k, d) + self.WBPg(d + 1, l)
            if tmp < best:
                best, best_d = tmp, d
        self.push(P_POmloop00, i, best_d, j, k)
        self.push(P_WBP, best_d + 1, l)

    def case_pomloop10(self, i, l, j, k):
        """P_POmloop10 (pseudo_loop.cc:2783-2824)."""
        best, best_row, best_d = INF, -1, -1
        for d in range(i + 1, j + 1):
            tmp = self.WBPg(i, d - 1) + self.g4("POmloop00", d, j, k, l)
            if tmp < best:
                best, best_row, best_d = tmp, 1, d
        for d in range(k + 1, l):
            tmp = self.g4("POmloop10", i, j, k, d) + self.WB(d + 1, l)
            if tmp < best:
                best, best_row, best_d = tmp, 2, d
        if best_row == 1:
            self.push(P_POmloop00, best_d, l, j, k)
            self.push(P_WBP, i, best_d - 1)
        elif best_row == 2:
            self.push(P_POmloop10, i, best_d, j, k)
            self.push(P_WB, best_d + 1, l)

    # ---- structure assembly (W_final.cc:764-819) -------------------------
    def fill_structure(self):
        n = self.n
        st = [("<", ">"), ("{", "}"), ("[", "]"), ("(", ")")]  # stack, top last
        bands = [["|", "|", 0, 0, 0, 0]]  # open, close, o_start, o_end, i_start, i_end
        structure = ["."] * (n + 2)
        for i in range(1, n + 1):
            j = int(self.f_pair[i])
            if j == -1:
                structure[i] = "."
            elif i < j:
                in_band = False
                for b in bands:
                    if i > b[4] and j < b[5]:
                        b[4], b[5] = i, j
                        structure[i], structure[j] = b[0], b[1]
                        in_band = True
                        break
                if not in_band:
                    op, cl = st.pop()
                    bands.append([op, cl, i, j, i, j])
                    structure[i], structure[j] = op, cl
            else:
                for b in bands:
                    if i == b[3]:
                        st.append((b[0], b[1]))
                        break
        return "".join(structure[1 : n + 1])


CASES = {
    FREE: Traceback.case_free,
    LOOP: Traceback.case_loop,
    M_WM: Traceback.case_wm,
    M_WMv: Traceback.case_wmv,
    M_WMp: Traceback.case_wmp,
    P_P: Traceback.case_p,
    P_PK: Traceback.case_pk,
    P_PL: Traceback.case_pl,
    P_PR: Traceback.case_pr,
    P_PM: Traceback.case_pm,
    P_PO: Traceback.case_po,
    P_PfromL: Traceback.case_froml,
    P_PfromR: Traceback.case_fromr,
    P_PfromM: Traceback.case_fromm,
    P_PfromMprime: Traceback.case_frommprime,
    P_PfromMdp: Traceback.case_frommdp,
    P_PfromO: Traceback.case_fromo,
    P_WB: Traceback.case_wb,
    P_WBP: Traceback.case_wbp,
    P_WP: Traceback.case_wp,
    P_WPP: Traceback.case_wpp,
    P_PLiloop: Traceback.case_pliloop,
    P_PLmloop: Traceback.case_plmloop,
    P_PLmloop00: Traceback.case_plmloop00,
    P_PLmloop01: Traceback.case_plmloop01,
    P_PLmloop10: Traceback.case_plmloop10,
    P_PRiloop: Traceback.case_priloop,
    P_PRmloop: Traceback.case_prmloop,
    P_PRmloop00: Traceback.case_prmloop00,
    P_PRmloop01: Traceback.case_prmloop01,
    P_PRmloop10: Traceback.case_prmloop10,
    P_PMiloop: Traceback.case_pmiloop,
    P_PMmloop: Traceback.case_pmmloop,
    P_PMmloop00: Traceback.case_pmmloop00,
    P_PMmloop01: Traceback.case_pmmloop01,
    P_PMmloop10: Traceback.case_pmmloop10,
    P_POiloop: Traceback.case_poiloop,
    P_POmloop: Traceback.case_pomloop,
    P_POmloop00: Traceback.case_pomloop00,
    P_POmloop01: Traceback.case_pomloop01,
    P_POmloop10: Traceback.case_pomloop10,
}
