"""Partition function (sum-product semiring) over the CCJ grammar.

The reference ships a partition-function variant that is compiled out and
visibly unfinished (reference: src/CCJ.cc:51-56 commented, src/part_func.cc
with `+`-for-`*` typos e.g. :646,:678,:700, a self-acknowledged broken
pf_scale :107, integer penalties used as Boltzmann factors :365,:760, and the
same read-before-write mloop00 dead code as the MFE fill).  This module
implements the *intended* CCJ grammar correctly instead of replicating that
dead code:

* Boltzmann factors are exact exponentials of the same integer dcal/mol
  tables the MFE engine uses: w(E) = exp(-E * 10 / kT).  This makes the
  ensemble thermodynamically consistent with the MFE fold
  (Z >= exp(-MFE*10/kT) always, checked in tests).
* within each cell the PX families are computed before the band-spanning
  multiloop families, so PXmloop00's base case contributes (unlike the
  reference, where it reads an unset cell).
* per-length scale vectors (scale[], expMLbase[], ...) are carried exactly
  like the reference's machinery (part_func.cc:97-125) with pf_scale
  configurable (default 1).

Matrices are float64 in the same [tt, s, i, j] wavefront layout as the MFE
fill; unset/invalid reads are 0 (Matrix4DPF semantics, matrices.hh:258-263).
"""

from __future__ import annotations

import functools

import numpy as np

from ..params.io_par import INF, MAXLOOP, TURN
from ..params.pk import PKPenalties
from ..params.scaling import GASCONST, K0, ScaledParams
from ..precompute import SeqTables

M4PF_NAMES = [
    "PK", "PL", "PR", "PM", "PO",
    "PfromL", "PfromR", "PfromM", "PfromMprime", "PfromO",
    "PLmloop00", "PLmloop01", "PLmloop10",
    "PRmloop00", "PRmloop01", "PRmloop10",
    "PMmloop00", "PMmloop01", "PMmloop10",
    "POmloop00", "POmloop01", "POmloop10",
]


class PFTables:
    """Boltzmann-factor tables derived from the integer energy tables."""

    def __init__(self, tabs: SeqTables, P: ScaledParams, pk: PKPenalties,
                 pf_scale: float = 1.0):
        self.n = n = tabs.n
        self.kT = (P.temperature + K0) * GASCONST  # cal/mol
        kT = self.kT
        self.pf_scale = pf_scale

        def bf(E):
            E = np.asarray(E, dtype=np.float64)
            # INF sentinels map to weight 0
            return np.where(E >= INF // 2, 0.0, np.exp(-E * 10.0 / kT))

        self.scale = np.zeros(n + 2)
        self.scale[0] = 1.0
        self.scale[1] = 1.0 / pf_scale
        for i in range(2, n + 2):
            self.scale[i] = self.scale[i // 2] * self.scale[i - i // 2]

        mlb = bf(P.MLbase)
        self.expMLbase = (mlb ** np.arange(n + 2)) * self.scale
        self.expcp = (bf(pk.cp) ** np.arange(n + 2)) * self.scale
        self.expPUP = (bf(pk.PUP) ** np.arange(n + 2)) * self.scale

        # hairpin already includes the closing-pair typing; scale[size+2]
        sz = np.arange(n + 2)[None, :] - np.arange(n + 2)[:, None] + 1
        self.expH = bf(tabs.H) * self.scale[np.clip(sz, 0, n + 1)]
        # interior loops: scale[u1+u2+2] = scale[di+dj]
        di = np.arange(MAXLOOP + 2)[:, None, None, None]
        dj = np.arange(MAXLOOP + 2)[None, :, None, None]
        self.expEINT = bf(tabs.EINT) * self.scale[np.clip(di + dj, 0, n + 1)]
        self.expEINTP = bf(tabs.EINTP) * self.scale[np.clip(di + dj, 0, n + 1)]
        self.expESTP = bf(tabs.ESTP) * self.scale[2]

        self.expML0 = bf(tabs.ML0)
        self.expML2 = bf(tabs.ML2)
        self.expMB0 = bf(tabs.MB0)
        self.expMB2 = bf(tabs.MB2)
        self.expEXT0 = bf(tabs.EXT0)
        self.expEXT2 = bf(tabs.EXT2)

        for name in ("PS", "PSM", "PSP", "PB", "PPS", "b", "bp", "ap"):
            setattr(self, "exp" + name, float(bf(getattr(pk, name))))
        self.expMLclosing_in_MB = True  # MB tables already include MLclosing


def pf_fill(tabs: SeqTables, P: ScaledParams, pk: PKPenalties,
            pf_scale: float = 1.0):
    """Sum-product wavefront fill (numpy host implementation).

    The PF stack mirrors the MFE wavefront; a JAX device version follows the
    same structure (engine/fold.py) and is planned once the MFE device path
    is tuned — the host version is the correctness anchor and handles the
    corpus scales used for dot plots.
    """
    pf = PFTables(tabs, P, pk, pf_scale)
    n = pf.n
    n2 = n + 2
    d = P.dangles

    V = np.zeros((n2, n2))
    WM = np.zeros((n2, n2))
    WMv = np.zeros((n2, n2))
    WMp = np.zeros((n2, n2))
    P2 = np.zeros((n2, n2))
    WBP = np.zeros((n2, n2))
    WPP = np.zeros((n2, n2))
    M4 = {name: {} for name in M4PF_NAMES}  # dict[(i,j,k,l)] -> float

    def g4(name, i, j, k, l):
        if not (1 <= i <= j and j < k - 1 and k <= l <= n):
            return 0.0
        return M4[name].get((i, j, k, l), 0.0)

    def WB(i, j):
        if i <= 0 or j <= 0 or i > n or j > n:
            return 0.0
        if i > j:
            return 1.0
        return pf.expcp[j - i + 1] + WBP[i, j]

    def WP(i, j):
        if i <= 0 or j <= 0 or i > n or j > n:
            return 0.0
        if i > j:
            return 1.0
        return pf.expPUP[j - i + 1] + WPP[i, j]

    expML = pf.expML2 if d in (1, 2) else pf.expML0
    expMB = pf.expMB2 if d in (1, 2) else pf.expMB0
    expEXT = pf.expEXT2 if d in (1, 2) else pf.expEXT0

    cells = [(i, i + s) for s in range(n) for i in range(1, n - s + 1)]
    # span-ordered iteration (i descending within a span is irrelevant here)
    for i, l in cells:
        s = l - i
        j = l
        # ---- V(i, j=l) ----------------------------------------------------
        contributions = pf.expH[i, j]
        # interior loops
        for dk in range(1, min(s - TURN - 1, MAXLOOP + 1) + 1):
            for dl in range(1, min(s - TURN - 1 - dk, MAXLOOP + 2 - dk) + 1):
                contributions += pf.expEINT[dk, dl, i, j] * V[i + dk, j - dl]
        # multiloop
        vm = 0.0
        for c in range(i + 1, j - TURN):
            vm += WM[i + 1, c - 1] * WMv[c, j - 1]
            vm += WM[i + 1, c - 1] * WMp[c, j - 1]
            vm += pf.expMLbase[c - i - 1] * WMp[c, j - 1]
        contributions += vm * expMB[i, j] * pf.scale[2]
        V[i, j] = contributions

        # ---- P(i, l) ------------------------------------------------------
        tot = 0.0
        for jj in range(i, l):
            for dd in range(jj + 1, l):
                for kk in range(dd + 1, l):
                    tot += g4("PK", i, jj, dd + 1, kk) * g4("PK", jj + 1, dd, kk + 1, l)
        P2[i, l] = tot

        # ---- WBP / WPP ----------------------------------------------------
        tot = 0.0
        for dd in range(i, l):
            tot += WB(i, dd - 1) * V[dd, l] * pf.expbp * pf.expPPS
            tot += WB(i, dd - 1) * P2[dd, l] * pf.expPSM * pf.expPPS
        tot += WBP[i, l - 1] * pf.expcp[1]
        WBP[i, l] = tot
        tot = 0.0
        for dd in range(i, l):
            tot += WP(i, dd - 1) * V[dd, l] * pf.expPPS
            tot += WP(i, dd - 1) * P2[dd, l] * pf.expPSP * pf.expPPS
        tot += WPP[i, l - 1] * pf.expPUP[1]
        WPP[i, l] = tot

        # ---- gapped families ---------------------------------------------
        pt = tabs.ptype
        for jj in range(i, l):
            for kk in range(l, jj + 1, -1):
                # PL
                tot = 0.0
                if pt[i, jj] > 0:
                    if tabs.can_pair[i, jj]:
                        tot += g4("PL", i + 1, jj - 1, kk, l) * pf.expESTP[i, jj]
                        for dd in range(i + 1, min(jj, i + MAXLOOP)):
                            for dp in range(jj - 1, max(dd + TURN, jj - MAXLOOP), -1):
                                if tabs.can_pair[dd, dp]:
                                    tot += (pf.expEINTP[dd - i, jj - dp, i, jj]
                                            * g4("PL", dd, dp, kk, l))
                    tot += (g4("PLmloop10", i + 1, jj - 1, kk, l)
                            + g4("PLmloop01", i + 1, jj - 1, kk, l)) \
                        * pf.expap * pf.expbp * pf.expbp
                    if jj >= i + TURN + 1:
                        tot += g4("PfromL", i + 1, jj - 1, kk, l)
                M4["PL"][(i, jj, kk, l)] = tot

                # PR
                tot = 0.0
                if pt[kk, l] > 0:
                    if tabs.can_pair[kk, l]:
                        tot += g4("PR", i, jj, kk + 1, l - 1) * pf.expESTP[kk, l]
                        for dd in range(kk + 1, min(l, kk + MAXLOOP)):
                            for dp in range(l - 1, max(dd + TURN, l - MAXLOOP), -1):
                                if tabs.can_pair[dd, dp]:
                                    tot += (pf.expEINTP[dd - kk, l - dp, kk, l]
                                            * g4("PR", i, jj, dd, dp))
                    tot += (g4("PRmloop10", i, jj, kk + 1, l - 1)
                            + g4("PRmloop01", i, jj, kk + 1, l - 1)) \
                        * pf.expap * pf.expbp * pf.expbp
                    if l >= kk + TURN + 1:
                        tot += g4("PfromR", i, jj, kk + 1, l - 1)
                M4["PR"][(i, jj, kk, l)] = tot

                # PM
                tot = 0.0
                if pt[jj, kk] > 0:
                    if tabs.can_pair[jj, kk]:
                        if i < jj and kk < l:
                            tot += g4("PM", i, jj - 1, kk + 1, l) * pf.expESTP[jj - 1, kk + 1]
                        for dd in range(jj - 1, max(i, jj - MAXLOOP), -1):
                            for dp in range(kk + 1, min(l, kk + MAXLOOP)):
                                if tabs.can_pair[dd, dp]:
                                    tot += (pf.expEINTP[jj - dd, dp - kk, dd, dp]
                                            * g4("PM", i, dd, dp, l))
                    tot += (g4("PMmloop10", i, jj - 1, kk + 1, l)
                            + g4("PMmloop01", i, jj - 1, kk + 1, l)) \
                        * pf.expap * pf.expbp * pf.expbp
                    if kk >= jj + TURN - 1:
                        tot += g4("PfromM", i, jj - 1, kk + 1, l)
                    if i == jj and kk == l:
                        tot += 1.0
                M4["PM"][(i, jj, kk, l)] = tot

                # PO
                tot = 0.0
                if pt[i, l] > 0:
                    if tabs.can_pair[i, l] and i < jj and kk < l:
                        tot += g4("PO", i + 1, jj, kk, l - 1) * pf.expESTP[i, l]
                        for dd in range(i + 1, min(jj, i + MAXLOOP)):
                            for dp in range(l - 1, max(l - MAXLOOP, kk), -1):
                                if tabs.can_pair[dd, dp]:
                                    tot += (pf.expEINTP[dd - i, l - dp, i, l]
                                            * g4("PO", dd, jj, kk, dp))
                    tot += (g4("POmloop10", i + 1, jj, kk, l - 1)
                            + g4("POmloop01", i + 1, jj, kk, l - 1)) \
                        * pf.expap * pf.expbp * pf.expbp
                    if l >= i + TURN + 1:
                        tot += g4("PfromO", i + 1, jj, kk, l - 1)
                M4["PO"][(i, jj, kk, l)] = tot

                # band-spanning multiloop fragments (PX computed above, so the
                # base case contributes — intended grammar)
                tot = M4["PL"][(i, jj, kk, l)] * pf.expbp
                for dd in range(i, jj + 1):
                    if dd > i:
                        tot += WB(i, dd - 1) * g4("PLmloop00", dd, jj, kk, l)
                    if dd < jj:
                        tot += g4("PLmloop00", i, dd, kk, l) * WB(dd + 1, jj)
                M4["PLmloop00"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(i, jj):
                    tot += g4("PLmloop00", i, dd, kk, l) * WBP[dd + 1, jj]
                M4["PLmloop01"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(i + 1, jj + 1):
                    tot += WBP[i, dd - 1] * g4("PLmloop00", dd, jj, kk, l)
                    if dd < jj:
                        tot += g4("PLmloop10", i, dd, kk, l) * WB(dd + 1, jj)
                M4["PLmloop10"][(i, jj, kk, l)] = tot

                tot = M4["PR"][(i, jj, kk, l)] * pf.expbp
                for dd in range(kk, l + 1):
                    if dd > kk:
                        tot += WB(kk, dd - 1) * g4("PRmloop00", i, jj, dd, l)
                    if dd < l:
                        tot += g4("PRmloop00", i, jj, kk, dd) * WB(dd + 1, l)
                M4["PRmloop00"][(i, jj, kk, l)] = tot

                tot = g4("PRmloop01", i, jj, kk, l - 1) * pf.expcp[1]
                for dd in range(kk, l):
                    tot += g4("PRmloop00", i, jj, kk, dd) * WBP[dd + 1, l]
                M4["PRmloop01"][(i, jj, kk, l)] = tot

                tot = g4("PRmloop10", i, jj, kk + 1, l) * pf.expcp[1]
                for dd in range(kk + 1, l + 1):
                    tot += WBP[kk, dd - 1] * g4("PRmloop00", i, jj, dd, l)
                M4["PRmloop10"][(i, jj, kk, l)] = tot

                tot = M4["PM"][(i, jj, kk, l)] * pf.expbp
                for dd in range(i, jj):
                    tot += g4("PMmloop00", i, dd, kk, l) * WB(dd + 1, jj)
                for dd in range(kk + 1, l + 1):
                    tot += g4("PMmloop00", i, jj, dd, l) * WB(kk, dd - 1)
                M4["PMmloop00"][(i, jj, kk, l)] = tot

                tot = g4("PMmloop01", i, jj, kk + 1, l) * pf.expcp[1]
                for dd in range(kk, l):
                    tot += g4("PMmloop00", i, jj, kk, dd) * WBP[dd + 1, l]
                M4["PMmloop01"][(i, jj, kk, l)] = tot

                tot = g4("PMmloop10", i, jj - 1, kk, l) * pf.expcp[1]
                for dd in range(i + 1, jj + 1):
                    tot += WBP[i, dd - 1] * g4("PMmloop00", dd, jj, kk, l)
                for dd in range(kk + 1, l):
                    tot += g4("PMmloop10", i, jj, kk, dd) * WB(dd + 1, l)
                M4["PMmloop10"][(i, jj, kk, l)] = tot

                tot = M4["PO"][(i, jj, kk, l)] * pf.expbp
                for dd in range(i + 1, jj + 1):
                    tot += WB(i, dd - 1) * g4("POmloop00", dd, jj, kk, l)
                for dd in range(kk, l):
                    tot += g4("POmloop00", i, jj, kk, dd) * WB(dd + 1, l)
                M4["POmloop00"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(kk, l):
                    tot += g4("POmloop00", i, jj, kk, dd) * WBP[dd + 1, l]
                M4["POmloop01"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(i + 1, jj + 1):
                    tot += WBP[i, dd - 1] * g4("POmloop00", dd, jj, kk, l)
                for dd in range(kk + 1, l):
                    tot += g4("POmloop10", i, jj, kk, dd) * WB(dd + 1, l)
                M4["POmloop10"][(i, jj, kk, l)] = tot

                # transition families
                tot = 0.0
                for dd in range(i + 1, jj):
                    tot += g4("PfromL", dd, jj, kk, l) * WP(i, dd - 1)
                    tot += g4("PfromL", i, dd, kk, l) * WP(dd + 1, jj)
                tot += M4["PR"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PM"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PO"][(i, jj, kk, l)] * pf.expPB
                M4["PfromL"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(kk + 1, l):
                    tot += g4("PfromR", i, jj, dd, l) * WP(kk, dd - 1)
                    tot += g4("PfromR", i, jj, kk, dd) * WP(dd + 1, l)
                tot += M4["PM"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PO"][(i, jj, kk, l)] * pf.expPB
                M4["PfromR"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(i + 1, jj):
                    tot += g4("PfromMprime", i, dd, kk, l) * WP(dd + 1, jj)
                M4["PfromM"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(kk + 1, l):
                    mdp = (g4("PL", i, jj, dd, l) + g4("PR", i, jj, dd, l)) * pf.expPB
                    tot += mdp * WP(kk, dd - 1)
                M4["PfromMprime"][(i, jj, kk, l)] = tot

                tot = 0.0
                for dd in range(i + 1, jj):
                    tot += g4("PfromO", dd, jj, kk, l) * WP(i, dd - 1)
                for dd in range(kk + 1, l):
                    tot += g4("PfromO", i, jj, kk, dd) * WP(dd + 1, l)
                tot += M4["PL"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PR"][(i, jj, kk, l)] * pf.expPB
                M4["PfromO"][(i, jj, kk, l)] = tot

                # PK
                tot = 0.0
                for dd in range(i + 1, jj):
                    tot += g4("PK", i, dd, kk, l) * WP(dd + 1, jj)
                for dd in range(kk + 1, l):
                    tot += g4("PK", i, jj, dd, l) * WP(kk, dd - 1)
                tot += M4["PL"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PM"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PR"][(i, jj, kk, l)] * pf.expPB
                tot += M4["PO"][(i, jj, kk, l)] * pf.expPB
                M4["PK"][(i, jj, kk, l)] = tot

        # ---- WMv / WMp / WM ----------------------------------------------
        if s >= 3:
            stem = V[i, j] * expML[i, j]
            WMv[i, j] = stem + WMv[i, j - 1] * pf.expMLbase[1]
            WMp[i, j] = (P2[i, j] * pf.expPSM * pf.expb
                         + WMp[i, j - 1] * pf.expMLbase[1])
            tot = 0.0
            for k in range(i, j - TURN):
                qbt1 = V[k, j] * expML[k, j]
                qbt2 = P2[k, j] * pf.expPSM * pf.expb
                tot += pf.expMLbase[k - i] * (qbt1 + qbt2)
                tot += WM[i, k - 1] * (qbt1 + qbt2)
            tot += WM[i, j - 1] * pf.expMLbase[1]
            WM[i, j] = tot

    # ---- exterior W -------------------------------------------------------
    W = np.zeros(n + 1)
    W[0] = 1.0
    for j in range(1, n + 1):
        if j <= TURN:
            W[j] = pf.scale[1] * (W[j - 1] if j > 1 else pf.scale[0])
            W[j] = W[j - 1] * pf.scale[1] if j > 1 else pf.scale[1]
            continue
        tot = W[j - 1] * pf.scale[1]
        for k in range(1, j - TURN):
            acc = W[k - 1] if k > 1 else 1.0
            tot += acc * V[k, j] * expEXT[k, j]
            tot += acc * P2[k, j] * pf.expPS
        W[j] = tot

    return {
        "pf": pf, "V": V, "WM": WM, "WMv": WMv, "WMp": WMp, "P2": P2,
        "WBP": WBP, "WPP": WPP, "M4": M4, "W": W,
    }


def ensemble_energy(res) -> float:
    """-kT ln Z in kcal/mol (part_func.cc:148-150 to_Energy)."""
    pf = res["pf"]
    n = pf.n
    return float(
        (-np.log(res["W"][n]) - n * np.log(pf.pf_scale)) * pf.kT / 1000.0
    )
