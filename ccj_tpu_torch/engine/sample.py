"""Stochastic backtrack (Boltzmann sampling) from the partition function.

Mirrors the reference's sampler design (reference: src/stoch_backtrack.cc:
Sample_W/V/VM/WM/WMv/WMp draw splits proportional to their partition-function
contributions) and **completes it**: the reference's ``Sample_P`` is an empty
stub (stoch_backtrack.cc:323-326), so pseudoknotted samples were impossible;
here the full gapped-family grammar is sampled, matching pf_fill's corrected
recurrences term for term.

Also provides sampled base-pair probabilities and the PS dot plot
(reference: src/dot_plot.cc — upper triangle ubox = sqrt(count/num_samples),
lower triangle lbox = MFE pairs).
"""

from __future__ import annotations

import numpy as np

from ..params.io_par import MAXLOOP, TURN


class PFSampler:
    def __init__(self, tabs, P, pk, res, seed=0):
        self.t = tabs
        self.P = P
        self.pk = pk
        self.res = res
        self.pf = res["pf"]
        self.n = tabs.n
        self.rng = np.random.default_rng(seed)
        d = P.dangles
        self.expML = self.pf.expML2 if d in (1, 2) else self.pf.expML0
        self.expMB = self.pf.expMB2 if d in (1, 2) else self.pf.expMB0
        self.expEXT = self.pf.expEXT2 if d in (1, 2) else self.pf.expEXT0

    # ---- helpers ---------------------------------------------------------
    def g4(self, name, i, j, k, l):
        if not (1 <= i <= j and j < k - 1 and k <= l <= self.n):
            return 0.0
        return self.res["M4"][name].get((i, j, k, l), 0.0)

    def WB(self, i, j):
        n = self.n
        if i <= 0 or j <= 0 or i > n or j > n:
            return 0.0
        if i > j:
            return 1.0
        return self.pf.expcp[j - i + 1] + self.res["WBP"][i, j]

    def WP(self, i, j):
        n = self.n
        if i <= 0 or j <= 0 or i > n or j > n:
            return 0.0
        if i > j:
            return 1.0
        return self.pf.expPUP[j - i + 1] + self.res["WPP"][i, j]

    def _choose(self, weights):
        total = sum(w for _, w in weights)
        if total <= 0.0:
            return None
        r = self.rng.random() * total
        acc = 0.0
        for tag, w in weights:
            acc += w
            if r <= acc:
                return tag
        return weights[-1][0]

    # ---- sampling --------------------------------------------------------
    def sample(self):
        """Draw one structure; returns the pair vector (1-based, -1 unpaired)."""
        self.pairs = np.full(self.n + 2, -1, dtype=np.int64)
        self.stack = [("W", self.n, 0, 0, 0)]
        while self.stack:
            typ, a, b, c, e = self.stack.pop()
            getattr(self, "s_" + typ)(a, b, c, e)
        return self.pairs.copy()

    def set_pair(self, a, b):
        self.pairs[a] = b
        self.pairs[b] = a

    def s_W(self, j, *_):
        if j <= TURN:
            return
        res, pf = self.res, self.pf
        W = res["W"]
        weights = [(("unp",), W[j - 1] * pf.scale[1])]
        for k in range(1, j - TURN):
            acc = W[k - 1] if k > 1 else 1.0
            weights.append((("V", k), acc * res["V"][k, j] * self.expEXT[k, j]))
            weights.append((("P", k), acc * res["P2"][k, j] * pf.expPS))
        tag = self._choose(weights)
        if tag is None or tag[0] == "unp":
            self.stack.append(("W", j - 1, 0, 0, 0))
            return
        kind, k = tag
        if k > 1:
            self.stack.append(("W", k - 1, 0, 0, 0))
        if kind == "V":
            self.stack.append(("V", k, j, 0, 0))
        else:
            self.stack.append(("P", k, j, 0, 0))

    def s_V(self, i, j, *_):
        t, res, pf = self.t, self.res, self.pf
        self.set_pair(i, j)
        weights = [(("hp",), pf.expH[i, j])]
        s = j - i
        for dk in range(1, min(s - TURN - 1, MAXLOOP + 1) + 1):
            for dl in range(1, min(s - TURN - 1 - dk, MAXLOOP + 2 - dk) + 1):
                weights.append(
                    (("int", dk, dl),
                     pf.expEINT[dk, dl, i, j] * res["V"][i + dk, j - dl])
                )
        mbf = self.expMB[i, j] * pf.scale[2]
        for c in range(i + 1, j - TURN):
            weights.append((("m1", c), res["WM"][i + 1, c - 1] * res["WMv"][c, j - 1] * mbf))
            weights.append((("m2", c), res["WM"][i + 1, c - 1] * res["WMp"][c, j - 1] * mbf))
            weights.append((("m3", c), pf.expMLbase[c - i - 1] * res["WMp"][c, j - 1] * mbf))
        tag = self._choose(weights)
        if tag is None or tag[0] == "hp":
            return
        if tag[0] == "int":
            _, dk, dl = tag
            self.stack.append(("V", i + dk, j - dl, 0, 0))
        elif tag[0] == "m1":
            self.stack.append(("WM", i + 1, tag[1] - 1, 0, 0))
            self.stack.append(("WMv", tag[1], j - 1, 0, 0))
        elif tag[0] == "m2":
            self.stack.append(("WM", i + 1, tag[1] - 1, 0, 0))
            self.stack.append(("WMp", tag[1], j - 1, 0, 0))
        elif tag[0] == "m3":
            self.stack.append(("WMp", tag[1], j - 1, 0, 0))

    def s_WM(self, i, j, *_):
        res, pf = self.res, self.pf
        weights = []
        for k in range(i, j - TURN):
            qbt1 = res["V"][k, j] * self.expML[k, j]
            qbt2 = res["P2"][k, j] * pf.expPSM * pf.expb
            weights.append((("b1", k), pf.expMLbase[k - i] * qbt1))
            weights.append((("b2", k), pf.expMLbase[k - i] * qbt2))
            weights.append((("c1", k), res["WM"][i, k - 1] * qbt1))
            weights.append((("c2", k), res["WM"][i, k - 1] * qbt2))
        weights.append((("unp",), res["WM"][i, j - 1] * pf.expMLbase[1]))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("WM", i, j - 1, 0, 0))
            return
        kind, k = tag
        if kind in ("c1", "c2"):
            self.stack.append(("WM", i, k - 1, 0, 0))
        if kind in ("b1", "c1"):
            self.stack.append(("V", k, j, 0, 0))
        else:
            self.stack.append(("P", k, j, 0, 0))

    def s_WMv(self, i, j, *_):
        res, pf = self.res, self.pf
        weights = [
            (("stem",), res["V"][i, j] * self.expML[i, j]),
            (("unp",), res["WMv"][i, j - 1] * pf.expMLbase[1]),
        ]
        tag = self._choose(weights)
        if tag and tag[0] == "stem":
            self.stack.append(("V", i, j, 0, 0))
        elif tag:
            self.stack.append(("WMv", i, j - 1, 0, 0))

    def s_WMp(self, i, j, *_):
        res, pf = self.res, self.pf
        weights = [
            (("pk",), res["P2"][i, j] * pf.expPSM * pf.expb),
            (("unp",), res["WMp"][i, j - 1] * pf.expMLbase[1]),
        ]
        tag = self._choose(weights)
        if tag and tag[0] == "pk":
            self.stack.append(("P", i, j, 0, 0))
        elif tag:
            self.stack.append(("WMp", i, j - 1, 0, 0))

    def s_P(self, i, l, *_):
        """Sample the two interleaved PK halves (completes Sample_P)."""
        weights = []
        for j in range(i, l):
            for d in range(j + 1, l):
                for k in range(d + 1, l):
                    weights.append(
                        ((j, d, k),
                         self.g4("PK", i, j, d + 1, k) * self.g4("PK", j + 1, d, k + 1, l))
                    )
        tag = self._choose(weights)
        if tag is None:
            return
        j, d, k = tag
        self.stack.append(("PK", i, j, d + 1, k))
        self.stack.append(("PK", j + 1, d, k + 1, l))

    def s_PK(self, i, j, k, l):
        pf = self.pf
        weights = []
        for d in range(i + 1, j):
            weights.append((("gapj", d), self.g4("PK", i, d, k, l) * self.WP(d + 1, j)))
        for d in range(k + 1, l):
            weights.append((("gapk", d), self.g4("PK", i, j, d, l) * self.WP(k, d - 1)))
        for nm in ("PL", "PM", "PR", "PO"):
            weights.append(((nm,), self.g4(nm, i, j, k, l) * pf.expPB))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "gapj":
            d = tag[1]
            self.stack.append(("PK", i, d, k, l))
            self.stack.append(("WPx", d + 1, j, 0, 0))
        elif tag[0] == "gapk":
            d = tag[1]
            self.stack.append(("PK", i, j, d, l))
            self.stack.append(("WPx", k, d - 1, 0, 0))
        else:
            self.stack.append((tag[0], i, j, k, l))

    def _px_common(self, which, i, j, k, l, pair_ij, iloop_terms, mloop_names,
                   from_name, from_idx, extra=()):
        pf = self.pf
        weights = list(iloop_terms)
        m10 = self.g4(mloop_names[0], *mloop_names[2]) * pf.expap * pf.expbp * pf.expbp
        m01 = self.g4(mloop_names[1], *mloop_names[2]) * pf.expap * pf.expbp * pf.expbp
        weights.append((("m10",), m10))
        weights.append((("m01",), m01))
        if from_name is not None:
            weights.append((("from",), self.g4(from_name, *from_idx)))
        weights.extend(extra)
        tag = self._choose(weights)
        if tag is None:
            return None
        self.set_pair(*pair_ij)
        return tag

    def s_PL(self, i, j, k, l):
        t, pf = self.t, self.pf
        if t.ptype[i, j] == 0:
            return
        ilt = []
        if t.can_pair[i, j]:
            ilt.append((("st",), self.g4("PL", i + 1, j - 1, k, l) * pf.expESTP[i, j]))
            for d in range(i + 1, min(j, i + MAXLOOP)):
                for dp in range(j - 1, max(d + TURN, j - MAXLOOP), -1):
                    if t.can_pair[d, dp]:
                        ilt.append(
                            (("il", d, dp),
                             pf.expEINTP[d - i, j - dp, i, j] * self.g4("PL", d, dp, k, l))
                        )
        tag = self._px_common(
            "PL", i, j, k, l, (i, j), ilt,
            ("PLmloop10", "PLmloop01", (i + 1, j - 1, k, l)),
            "PfromL" if j >= i + TURN + 1 else None, (i + 1, j - 1, k, l),
        )
        if tag is None:
            return
        if tag[0] == "st":
            self.stack.append(("PL", i + 1, j - 1, k, l))
        elif tag[0] == "il":
            self.stack.append(("PL", tag[1], tag[2], k, l))
        elif tag[0] == "m10":
            self.stack.append(("PLm10", i + 1, j - 1, k, l))
        elif tag[0] == "m01":
            self.stack.append(("PLm01", i + 1, j - 1, k, l))
        elif tag[0] == "from":
            self.stack.append(("fromL", i + 1, j - 1, k, l))

    def s_PR(self, i, j, k, l):
        t, pf = self.t, self.pf
        if t.ptype[k, l] == 0:
            return
        ilt = []
        if t.can_pair[k, l]:
            ilt.append((("st",), self.g4("PR", i, j, k + 1, l - 1) * pf.expESTP[k, l]))
            for d in range(k + 1, min(l, k + MAXLOOP)):
                for dp in range(l - 1, max(d + TURN, l - MAXLOOP), -1):
                    if t.can_pair[d, dp]:
                        ilt.append(
                            (("il", d, dp),
                             pf.expEINTP[d - k, l - dp, k, l] * self.g4("PR", i, j, d, dp))
                        )
        tag = self._px_common(
            "PR", i, j, k, l, (k, l), ilt,
            ("PRmloop10", "PRmloop01", (i, j, k + 1, l - 1)),
            "PfromR" if l >= k + TURN + 1 else None, (i, j, k + 1, l - 1),
        )
        if tag is None:
            return
        if tag[0] == "st":
            self.stack.append(("PR", i, j, k + 1, l - 1))
        elif tag[0] == "il":
            self.stack.append(("PR", i, j, tag[1], tag[2]))
        elif tag[0] == "m10":
            self.stack.append(("PRm10", i, j, k + 1, l - 1))
        elif tag[0] == "m01":
            self.stack.append(("PRm01", i, j, k + 1, l - 1))
        elif tag[0] == "from":
            self.stack.append(("fromR", i, j, k + 1, l - 1))

    def s_PM(self, i, j, k, l):
        t, pf = self.t, self.pf
        if t.ptype[j, k] == 0:
            return
        ilt = []
        if t.can_pair[j, k]:
            if i < j and k < l:
                ilt.append(
                    (("st",), self.g4("PM", i, j - 1, k + 1, l) * pf.expESTP[j - 1, k + 1])
                )
            for d in range(j - 1, max(i, j - MAXLOOP), -1):
                for dp in range(k + 1, min(l, k + MAXLOOP)):
                    if t.can_pair[d, dp]:
                        ilt.append(
                            (("il", d, dp),
                             pf.expEINTP[j - d, dp - k, d, dp] * self.g4("PM", i, d, dp, l))
                        )
        extra = []
        if i == j and k == l:
            extra.append((("base",), 1.0))
        tag = self._px_common(
            "PM", i, j, k, l, (j, k), ilt,
            ("PMmloop10", "PMmloop01", (i, j - 1, k + 1, l)),
            "PfromM" if k >= j + TURN - 1 else None, (i, j - 1, k + 1, l),
            extra,
        )
        if tag is None:
            return
        if tag[0] == "st":
            self.stack.append(("PM", i, j - 1, k + 1, l))
        elif tag[0] == "il":
            self.stack.append(("PM", i, tag[1], tag[2], l))
        elif tag[0] == "m10":
            self.stack.append(("PMm10", i, j - 1, k + 1, l))
        elif tag[0] == "m01":
            self.stack.append(("PMm01", i, j - 1, k + 1, l))
        elif tag[0] == "from":
            self.stack.append(("fromM", i, j - 1, k + 1, l))

    def s_PO(self, i, j, k, l):
        t, pf = self.t, self.pf
        if t.ptype[i, l] == 0:
            return
        ilt = []
        if t.can_pair[i, l] and i < j and k < l:
            ilt.append((("st",), self.g4("PO", i + 1, j, k, l - 1) * pf.expESTP[i, l]))
            for d in range(i + 1, min(j, i + MAXLOOP)):
                for dp in range(l - 1, max(l - MAXLOOP, k), -1):
                    if t.can_pair[d, dp]:
                        ilt.append(
                            (("il", d, dp),
                             pf.expEINTP[d - i, l - dp, i, l] * self.g4("PO", d, j, k, dp))
                        )
        tag = self._px_common(
            "PO", i, j, k, l, (i, l), ilt,
            ("POmloop10", "POmloop01", (i + 1, j, k, l - 1)),
            "PfromO" if l >= i + TURN + 1 else None, (i + 1, j, k, l - 1),
        )
        if tag is None:
            return
        if tag[0] == "st":
            self.stack.append(("PO", i + 1, j, k, l - 1))
        elif tag[0] == "il":
            self.stack.append(("PO", tag[1], j, k, tag[2]))
        elif tag[0] == "m10":
            self.stack.append(("POm10", i + 1, j, k, l - 1))
        elif tag[0] == "m01":
            self.stack.append(("POm01", i + 1, j, k, l - 1))
        elif tag[0] == "from":
            self.stack.append(("fromO", i + 1, j, k, l - 1))

    # transition families
    def s_fromL(self, i, j, k, l):
        pf = self.pf
        weights = []
        for d in range(i + 1, j):
            weights.append((("a", d), self.g4("PfromL", d, j, k, l) * self.WP(i, d - 1)))
            weights.append((("b", d), self.g4("PfromL", i, d, k, l) * self.WP(d + 1, j)))
        for nm in ("PR", "PM", "PO"):
            weights.append(((nm,), self.g4(nm, i, j, k, l) * pf.expPB))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "a":
            self.stack.append(("fromL", tag[1], j, k, l))
            self.stack.append(("WPx", i, tag[1] - 1, 0, 0))
        elif tag[0] == "b":
            self.stack.append(("fromL", i, tag[1], k, l))
            self.stack.append(("WPx", tag[1] + 1, j, 0, 0))
        else:
            self.stack.append((tag[0], i, j, k, l))

    def s_fromR(self, i, j, k, l):
        pf = self.pf
        weights = []
        for d in range(k + 1, l):
            weights.append((("a", d), self.g4("PfromR", i, j, d, l) * self.WP(k, d - 1)))
            weights.append((("b", d), self.g4("PfromR", i, j, k, d) * self.WP(d + 1, l)))
        for nm in ("PM", "PO"):
            weights.append(((nm,), self.g4(nm, i, j, k, l) * pf.expPB))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "a":
            self.stack.append(("fromR", i, j, tag[1], l))
            self.stack.append(("WPx", k, tag[1] - 1, 0, 0))
        elif tag[0] == "b":
            self.stack.append(("fromR", i, j, k, tag[1]))
            self.stack.append(("WPx", tag[1] + 1, l, 0, 0))
        else:
            self.stack.append((tag[0], i, j, k, l))

    def s_fromM(self, i, j, k, l):
        weights = []
        for d in range(i + 1, j):
            weights.append(((d,), self.g4("PfromMprime", i, d, k, l) * self.WP(d + 1, j)))
        tag = self._choose(weights)
        if tag is None:
            return
        d = tag[0]
        self.stack.append(("fromMp", i, d, k, l))
        self.stack.append(("WPx", d + 1, j, 0, 0))

    def s_fromMp(self, i, j, k, l):
        pf = self.pf
        weights = []
        for d in range(k + 1, l):
            mdp_L = self.g4("PL", i, j, d, l) * pf.expPB
            mdp_R = self.g4("PR", i, j, d, l) * pf.expPB
            weights.append((("L", d), mdp_L * self.WP(k, d - 1)))
            weights.append((("R", d), mdp_R * self.WP(k, d - 1)))
        tag = self._choose(weights)
        if tag is None:
            return
        which, d = tag
        self.stack.append(("PL" if which == "L" else "PR", i, j, d, l))
        self.stack.append(("WPx", k, d - 1, 0, 0))

    def s_fromO(self, i, j, k, l):
        pf = self.pf
        weights = []
        for d in range(i + 1, j):
            weights.append((("a", d), self.g4("PfromO", d, j, k, l) * self.WP(i, d - 1)))
        for d in range(k + 1, l):
            weights.append((("b", d), self.g4("PfromO", i, j, k, d) * self.WP(d + 1, l)))
        for nm in ("PL", "PR"):
            weights.append(((nm,), self.g4(nm, i, j, k, l) * pf.expPB))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "a":
            self.stack.append(("fromO", tag[1], j, k, l))
            self.stack.append(("WPx", i, tag[1] - 1, 0, 0))
        elif tag[0] == "b":
            self.stack.append(("fromO", i, j, k, tag[1]))
            self.stack.append(("WPx", tag[1] + 1, l, 0, 0))
        else:
            self.stack.append((tag[0], i, j, k, l))

    # band-spanning multiloop fragments
    def _mloop00(self, fam, i, j, k, l, side):
        """PXmloop00: base PX + WB-gap extensions on the given band side."""
        pf = self.pf
        px = fam[:2]
        weights = [(("px",), self.g4(px, i, j, k, l) * pf.expbp)]
        if side == "L":
            for d in range(i, j + 1):
                if d > i:
                    weights.append((("a", d), self.WB(i, d - 1) * self.g4(fam, d, j, k, l)))
                if d < j:
                    weights.append((("b", d), self.g4(fam, i, d, k, l) * self.WB(d + 1, j)))
        elif side == "R":
            for d in range(k, l + 1):
                if d > k:
                    weights.append((("a", d), self.WB(k, d - 1) * self.g4(fam, i, j, d, l)))
                if d < l:
                    weights.append((("b", d), self.g4(fam, i, j, k, d) * self.WB(d + 1, l)))
        elif side == "M":
            for d in range(i, j):
                weights.append((("b", d), self.g4(fam, i, d, k, l) * self.WB(d + 1, j)))
            for d in range(k + 1, l + 1):
                weights.append((("a", d), self.g4(fam, i, j, d, l) * self.WB(k, d - 1)))
        else:  # O
            for d in range(i + 1, j + 1):
                weights.append((("a", d), self.WB(i, d - 1) * self.g4(fam, d, j, k, l)))
            for d in range(k, l):
                weights.append((("b", d), self.g4(fam, i, j, k, d) * self.WB(d + 1, l)))
        return weights

    def _push_m00(self, fam, side, tag, i, j, k, l):
        px = fam[:2]
        m00 = fam[0:2] + "m00"
        if tag[0] == "px":
            self.stack.append((px, i, j, k, l))
            return
        kind, d = tag
        if side == "L":
            if kind == "a":
                self.stack.append((m00, d, j, k, l))
                self.stack.append(("WBx", i, d - 1, 0, 0))
            else:
                self.stack.append((m00, i, d, k, l))
                self.stack.append(("WBx", d + 1, j, 0, 0))
        elif side == "R":
            if kind == "a":
                self.stack.append((m00, i, j, d, l))
                self.stack.append(("WBx", k, d - 1, 0, 0))
            else:
                self.stack.append((m00, i, j, k, d))
                self.stack.append(("WBx", d + 1, l, 0, 0))
        elif side == "M":
            if kind == "a":
                self.stack.append((m00, i, j, d, l))
                self.stack.append(("WBx", k, d - 1, 0, 0))
            else:
                self.stack.append((m00, i, d, k, l))
                self.stack.append(("WBx", d + 1, j, 0, 0))
        else:
            if kind == "a":
                self.stack.append((m00, d, j, k, l))
                self.stack.append(("WBx", i, d - 1, 0, 0))
            else:
                self.stack.append((m00, i, j, k, d))
                self.stack.append(("WBx", d + 1, l, 0, 0))

    def s_PLm00(self, i, j, k, l):
        tag = self._choose(self._mloop00("PLmloop00", i, j, k, l, "L"))
        if tag:
            self._push_m00("PLmloop00", "L", tag, i, j, k, l)

    def s_PRm00(self, i, j, k, l):
        tag = self._choose(self._mloop00("PRmloop00", i, j, k, l, "R"))
        if tag:
            self._push_m00("PRmloop00", "R", tag, i, j, k, l)

    def s_PMm00(self, i, j, k, l):
        tag = self._choose(self._mloop00("PMmloop00", i, j, k, l, "M"))
        if tag:
            self._push_m00("PMmloop00", "M", tag, i, j, k, l)

    def s_POm00(self, i, j, k, l):
        tag = self._choose(self._mloop00("POmloop00", i, j, k, l, "O"))
        if tag:
            self._push_m00("POmloop00", "O", tag, i, j, k, l)

    def _m01_weights(self, fam, i, j, k, l, shrink, gaps):
        pf = self.pf
        weights = [(("unp",), self.g4(fam, *shrink) * pf.expcp[1])] if shrink else []
        for tag, w in gaps:
            weights.append((tag, w))
        return weights

    def s_PLm01(self, i, j, k, l):
        weights = []
        for d in range(i, j):
            weights.append(
                (("g", d), self.g4("PLmloop00", i, d, k, l) * self.res["WBP"][d + 1, j])
            )
        tag = self._choose(weights)
        if tag is None:
            return
        d = tag[1]
        self.stack.append(("PLm00", i, d, k, l))
        self.stack.append(("WBPx", d + 1, j, 0, 0))

    def s_PLm10(self, i, j, k, l):
        weights = []
        for d in range(i + 1, j + 1):
            weights.append(
                (("a", d), self.res["WBP"][i, d - 1] * self.g4("PLmloop00", d, j, k, l))
            )
            if d < j:
                weights.append((("b", d), self.g4("PLmloop10", i, d, k, l) * self.WB(d + 1, j)))
        tag = self._choose(weights)
        if tag is None:
            return
        kind, d = tag
        if kind == "a":
            self.stack.append(("PLm00", d, j, k, l))
            self.stack.append(("WBPx", i, d - 1, 0, 0))
        else:
            self.stack.append(("PLm10", i, d, k, l))
            self.stack.append(("WBx", d + 1, j, 0, 0))

    def s_PRm01(self, i, j, k, l):
        weights = [(("unp",), self.g4("PRmloop01", i, j, k, l - 1) * self.pf.expcp[1])]
        for d in range(k, l):
            weights.append((("g", d), self.g4("PRmloop00", i, j, k, d) * self.res["WBP"][d + 1, l]))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("PRm01", i, j, k, l - 1))
        else:
            d = tag[1]
            self.stack.append(("PRm00", i, j, k, d))
            self.stack.append(("WBPx", d + 1, l, 0, 0))

    def s_PRm10(self, i, j, k, l):
        weights = [(("unp",), self.g4("PRmloop10", i, j, k + 1, l) * self.pf.expcp[1])]
        for d in range(k + 1, l + 1):
            weights.append((("g", d), self.res["WBP"][k, d - 1] * self.g4("PRmloop00", i, j, d, l)))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("PRm10", i, j, k + 1, l))
        else:
            d = tag[1]
            self.stack.append(("PRm00", i, j, d, l))
            self.stack.append(("WBPx", k, d - 1, 0, 0))

    def s_PMm01(self, i, j, k, l):
        weights = [(("unp",), self.g4("PMmloop01", i, j, k + 1, l) * self.pf.expcp[1])]
        for d in range(k, l):
            weights.append((("g", d), self.g4("PMmloop00", i, j, k, d) * self.res["WBP"][d + 1, l]))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("PMm01", i, j, k + 1, l))
        else:
            d = tag[1]
            self.stack.append(("PMm00", i, j, k, d))
            self.stack.append(("WBPx", d + 1, l, 0, 0))

    def s_PMm10(self, i, j, k, l):
        weights = [(("unp",), self.g4("PMmloop10", i, j - 1, k, l) * self.pf.expcp[1])]
        for d in range(i + 1, j + 1):
            weights.append((("a", d), self.res["WBP"][i, d - 1] * self.g4("PMmloop00", d, j, k, l)))
        for d in range(k + 1, l):
            weights.append((("b", d), self.g4("PMmloop10", i, j, k, d) * self.WB(d + 1, l)))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("PMm10", i, j - 1, k, l))
        elif tag[0] == "a":
            d = tag[1]
            self.stack.append(("PMm00", d, j, k, l))
            self.stack.append(("WBPx", i, d - 1, 0, 0))
        else:
            d = tag[1]
            self.stack.append(("PMm10", i, j, k, d))
            self.stack.append(("WBx", d + 1, l, 0, 0))

    def s_POm01(self, i, j, k, l):
        weights = []
        for d in range(k, l):
            weights.append((("g", d), self.g4("POmloop00", i, j, k, d) * self.res["WBP"][d + 1, l]))
        tag = self._choose(weights)
        if tag is None:
            return
        d = tag[1]
        self.stack.append(("POm00", i, j, k, d))
        self.stack.append(("WBPx", d + 1, l, 0, 0))

    def s_POm10(self, i, j, k, l):
        weights = []
        for d in range(i + 1, j + 1):
            weights.append((("a", d), self.res["WBP"][i, d - 1] * self.g4("POmloop00", d, j, k, l)))
        for d in range(k + 1, l):
            weights.append((("b", d), self.g4("POmloop10", i, j, k, d) * self.WB(d + 1, l)))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "a":
            d = tag[1]
            self.stack.append(("POm00", d, j, k, l))
            self.stack.append(("WBPx", i, d - 1, 0, 0))
        else:
            d = tag[1]
            self.stack.append(("POm10", i, j, k, d))
            self.stack.append(("WBx", d + 1, l, 0, 0))

    # gap fillers
    def s_WPx(self, i, l, *_):
        if i > l:
            return
        weights = [
            (("empty",), self.pf.expPUP[l - i + 1]),
            (("wpp",), self.res["WPP"][i, l]),
        ]
        tag = self._choose(weights)
        if tag and tag[0] == "wpp":
            self.stack.append(("WPP", i, l, 0, 0))

    def s_WPP(self, i, l, *_):
        pf = self.pf
        weights = []
        for d in range(i, l):
            weights.append((("v", d), self.WP(i, d - 1) * self.res["V"][d, l] * pf.expPPS))
            weights.append((("p", d), self.WP(i, d - 1) * self.res["P2"][d, l] * pf.expPSP * pf.expPPS))
        weights.append((("unp",), self.res["WPP"][i, l - 1] * pf.expPUP[1]))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("WPP", i, l - 1, 0, 0))
            return
        kind, d = tag
        self.stack.append(("WPx", i, d - 1, 0, 0))
        self.stack.append(("V" if kind == "v" else "P", d, l, 0, 0))

    def s_WBx(self, i, l, *_):
        if i > l:
            return
        weights = [
            (("empty",), self.pf.expcp[l - i + 1]),
            (("wbp",), self.res["WBP"][i, l]),
        ]
        tag = self._choose(weights)
        if tag and tag[0] == "wbp":
            self.stack.append(("WBPx", i, l, 0, 0))

    def s_WBPx(self, i, l, *_):
        pf = self.pf
        if i > l:
            return
        weights = []
        for d in range(i, l):
            weights.append((("v", d), self.WB(i, d - 1) * self.res["V"][d, l] * pf.expbp * pf.expPPS))
            weights.append((("p", d), self.WB(i, d - 1) * self.res["P2"][d, l] * pf.expPSM * pf.expPPS))
        weights.append((("unp",), self.res["WBP"][i, l - 1] * pf.expcp[1]))
        tag = self._choose(weights)
        if tag is None:
            return
        if tag[0] == "unp":
            self.stack.append(("WBPx", i, l - 1, 0, 0))
            return
        kind, d = tag
        self.stack.append(("WBx", i, d - 1, 0, 0))
        self.stack.append(("V" if kind == "v" else "P", d, l, 0, 0))


def sample_structures(tabs, P, pk, res, num_samples=1000, seed=0):
    """Draw Boltzmann samples; returns (pair_count[i,j], samples list)."""
    sampler = PFSampler(tabs, P, pk, res, seed=seed)
    n = tabs.n
    counts = np.zeros((n + 1, n + 1), dtype=np.int64)
    samples = []
    for _ in range(num_samples):
        pairs = sampler.sample()
        samples.append(pairs)
        for i in range(1, n + 1):
            j = pairs[i]
            if j > i:
                counts[i, j] += 1
    return counts, samples


def write_dot_plot(path, seq, counts, num_samples, mfe_pairs=None):
    """PS dot plot: upper triangle sqrt(p) 'ubox', lower triangle MFE 'lbox'
    (functional port of src/dot_plot.cc:52-134; the reference's decorative
    PostScript prolog blobs are replaced by a minimal equivalent prolog)."""
    n = len(seq)
    lines = [
        "%!PS-Adobe-3.0 EPSF-3.0",
        "%%Title: RNA Dot Plot",
        "%%Creator: ccj_tpu",
        f"%%BoundingBox: 0 0 {n * 6 + 72} {n * 6 + 72}",
        "%%EndComments",
        "/box { %size x y box - draws box centered on x,y",
        "   2 index 0.5 mul sub            % x -= 0.5",
        "   exch 2 index 0.5 mul sub exch  % y -= 0.5",
        "   3 -1 roll dup rectfill",
        "} bind def",
        "/ubox { 3 1 roll exch len exch sub 1 add box } bind def",
        "/lbox { 3 1 roll len exch sub 1 add box } bind def",
        f"/len {n} def",
        "72 72 translate",
        "6 6 scale",
        "0.5 dup translate",
        "/sequence (" + seq + ") def",
        "0 0 0 setrgbcolor",
    ]
    for i in range(1, n + 1):
        for j in range(i + 1, n + 1):
            if counts[i, j] > 0:
                p = np.sqrt(counts[i, j] / num_samples)
                lines.append(f"{p:.7f} {i} {j} ubox")
    if mfe_pairs is not None:
        for i in range(1, n + 1):
            j = int(mfe_pairs[i])
            if j > i:
                lines.append(f"0.95 {i} {j} lbox")
    lines.append("showpage")
    lines.append("%%EOF")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
