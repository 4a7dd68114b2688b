"""Per-sequence precomputed energy tables.

The reference evaluates its loop-energy kernels (E_Hairpin / E_IntLoop /
E_MLstem, reference: src/ViennaRNA/loops/*.h) inline per DP cell.  On TPU we
precompute them once per sequence into dense lookup tables so the DP fill is
pure gather + min-plus arithmetic:

  * ``H[i,j]``           hairpin energy closing (i,j)  (incl. special loops)
  * ``EINT[di,dj,i,j]``  interior-loop energy, outer (i,j), inner (i+di,j-dj)
  * ``EINTP``            lrint(0.74 * EINT)   (pseudoknot interior, h_globals)
  * ``ESTP[i,j]``        lrint(0.89 * stack)  (pseudoknot stack)
  * multiloop/exterior stem constant tables for all dangle models

All energies int32 dcal/mol; INF = 10^7.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from .params.io_par import INF, MAXLOOP, TURN
from .params.pk import PKPenalties
from .params.scaling import ScaledParams
from .seq import RTYPE, can_pair_table, encode, ptype_table


def _loop_extend(table30, lxc, size):
    """table[30] + int(lxc * log(size/30)) for size > 30, truncated like C."""
    return table30 + np.trunc(lxc * np.log(size / 30.0)).astype(np.int64)


def _E_IntLoop_slice(n1: int, n2: int, typ, typ2, si1, sj1, sp1, sq1,
                     P: ScaledParams):
    """Exact port of E_IntLoop (ViennaRNA/loops/internal.h:477-569) for ONE
    (n1, n2) loop-size pair, vectorized over the (i, j) plane.

    The branch on (ns, nl) is a compile-time scalar decision per slice, so
    only the one live formula's table gathers are evaluated — the fully
    4-D-vectorized predecessor materialized ~20 temporaries of D^2*n^2
    int64 each and dominated per-fold host time (~5 s at n=100).
    """
    nl, ns = max(n1, n2), min(n1, n2)
    stack = P.stack
    lxc = P.lxc

    if nl == 0:                                  # coaxial stack
        return stack[typ, typ2].astype(np.int64)

    if ns == 0:                                  # bulge
        if nl <= MAXLOOP:
            e = int(P.bulge[nl])
        else:
            e = int(_loop_extend(int(P.bulge[30]), lxc, np.float64(nl)))
        if nl == 1:
            return e + stack[typ, typ2].astype(np.int64)
        term_au = (typ > 2) * P.TerminalAU + (typ2 > 2) * P.TerminalAU
        return e + term_au.astype(np.int64)

    if ns == 1 and nl == 1:                      # 1x1
        return P.int11[typ, typ2, si1, sj1].astype(np.int64)

    if ns == 1 and nl == 2:                      # 2x1
        if n1 == 1:
            return P.int21[typ, typ2, si1, sq1, sj1].astype(np.int64)
        return P.int21[typ2, typ, sq1, si1, sp1].astype(np.int64)

    if ns == 1:                                  # 1xn, n > 2
        if nl + 1 <= MAXLOOP:
            e = int(P.internal_loop[nl + 1])
        else:
            e = int(_loop_extend(int(P.internal_loop[30]), lxc,
                                 np.float64(nl + 1)))
        e += min(int(P.MAX_NINIO), (nl - ns) * int(P.ninio2))
        return (e + P.mismatch1nI[typ, si1, sj1].astype(np.int64)
                + P.mismatch1nI[typ2, sq1, sp1].astype(np.int64))

    if ns == 2 and nl == 2:                      # 2x2
        return P.int22[typ, typ2, si1, sp1, sq1, sj1].astype(np.int64)

    if ns == 2 and nl == 3:                      # 2x3
        e = int(P.internal_loop[5]) + int(P.ninio2)
        return (e + P.mismatch23I[typ, si1, sj1].astype(np.int64)
                + P.mismatch23I[typ2, sq1, sp1].astype(np.int64))

    # generic interior loop
    u = nl + ns
    if u <= MAXLOOP:
        e = int(P.internal_loop[u])
    else:
        e = int(_loop_extend(int(P.internal_loop[30]), lxc, np.float64(u)))
    e += min(int(P.MAX_NINIO), (nl - ns) * int(P.ninio2))
    return (e + P.mismatchI[typ, si1, sj1].astype(np.int64)
            + P.mismatchI[typ2, sq1, sp1].astype(np.int64))


def _hairpin_table(seq, S, pt, P: ScaledParams, n):
    """Exact port of HairpinE/E_Hairpin (s_energy_matrix.cc:275, hairpin.h:148)."""
    H = np.full((n + 2, n + 2), INF, dtype=np.int64)
    # strstr finds the FIRST occurrence; keep the first-listed entry per loop
    tetra = {}
    for s, e in P.Tetraloops:
        tetra.setdefault(s, e)
    tri = {}
    for s, e in P.Triloops:
        tri.setdefault(s, e)
    hexa = {}
    for s, e in P.Hexaloops:
        hexa.setdefault(s, e)

    hp = P.hairpin.astype(np.int64)
    for i in range(1, n + 1):
        for j in range(i + 1, n + 1):
            typ = pt[i, j]
            if typ == 0:
                continue
            size = j - i - 1
            if size <= 30:
                energy = int(hp[size])
            else:
                energy = int(hp[30]) + int(np.trunc(P.lxc * np.log(size / 30.0)))
            if size < 3:
                H[i, j] = energy
                continue
            if P.special_hp:
                if size == 4:
                    tl = seq[i - 1 : i + 5]
                    if tl in tetra:
                        H[i, j] = tetra[tl]
                        continue
                elif size == 6:
                    tl = seq[i - 1 : i + 7]
                    if tl in hexa:
                        H[i, j] = hexa[tl]
                        continue
                elif size == 3:
                    tl = seq[i - 1 : i + 4]
                    if tl in tri:
                        H[i, j] = tri[tl]
                        continue
                    H[i, j] = energy + (P.TerminalAU if typ > 2 else 0)
                    continue
            H[i, j] = energy + int(P.mismatchH[typ, S[i + 1], S[j - 1]])
    return H


@dataclasses.dataclass
class SeqTables:
    """Per-sequence tables (numpy; engine.fold.consts_from_numpy moves them
    to the fill's device)."""

    n: int
    seq: str
    S: np.ndarray          # [n+2] encoding
    ptype: np.ndarray      # [n+2, n+2]
    can_pair: np.ndarray   # [n+2, n+2] bool
    H: np.ndarray          # [n+2, n+2] hairpin
    EINT: np.ndarray       # [32, 32, n+2, n+2] interior loops (di,dj in 1..31)
    EINTP: np.ndarray      # lrint(e_intP * EINT)
    ESTP: np.ndarray       # [n+2, n+2] pseudoknot stack
    ML0: np.ndarray        # E_MLstem(type,-1,-1)
    ML2: np.ndarray        # E_MLstem(type, S[i-1], S[j+1]) boundary-aware
    ML_ip1: np.ndarray     # E_MLstem(ptype(i+1,j), S[i], -1)      (dangles=1)
    ML_jm1: np.ndarray     # E_MLstem(ptype(i,j-1), -1, S[j])      (dangles=1)
    ML_both: np.ndarray    # E_MLstem(ptype(i+1,j-1), S[i], S[j])  (dangles=1)
    MB0: np.ndarray        # E_MLstem(rev type,-1,-1) + MLclosing
    MB2: np.ndarray        # E_MLstem(rev, S[j-1], S[i+1]) + MLclosing
    MB_5: np.ndarray       # dangles=1 closing variants (incl. MLbase terms)
    MB_3: np.ndarray
    MB_53: np.ndarray
    EXT0: np.ndarray       # vrna_E_ext_stem(type,-1,-1)
    EXT2: np.ndarray       # vrna_E_ext_stem(type, S[i-1], S[j+1]) boundary-aware
    EXT_ip1: np.ndarray    # vrna_E_ext_stem(ptype(i+1,j), S[i], -1)
    EXT_jm1: np.ndarray
    EXT_both: np.ndarray


def _stem(typ, mm5, mm3, P: ScaledParams, ml: bool):
    """E_MLstem / vrna_E_ext_stem, vectorized; mm = -1 means 'no dangle'."""
    typ = np.asarray(typ)
    mm5 = np.asarray(mm5)
    mm3 = np.asarray(mm3)
    both = (mm5 >= 0) & (mm3 >= 0)
    only5 = (mm5 >= 0) & (mm3 < 0)
    only3 = (mm5 < 0) & (mm3 >= 0)
    mm5c = np.clip(mm5, 0, 4)
    mm3c = np.clip(mm3, 0, 4)
    tab = P.mismatchM if ml else P.mismatchExt
    e = np.where(both, tab.astype(np.int64)[typ, mm5c, mm3c], 0)
    e = np.where(only5, P.dangle5.astype(np.int64)[typ, mm5c], e)
    e = np.where(only3, P.dangle3.astype(np.int64)[typ, mm3c], e)
    e = e + (typ > 2) * P.TerminalAU
    if ml:
        e = e + P.MLintern.astype(np.int64)[typ]
    return e


def build_seq_tables(
    seq: str, P: ScaledParams, pk: PKPenalties, no_gu: bool = False
) -> SeqTables:
    n = len(seq)
    S = encode(seq)
    pt = ptype_table(S, no_gu)
    cp = can_pair_table(S, no_gu)

    # ---- interior loop stencil table -------------------------------------
    # One (di, dj) slice at a time: the E_IntLoop case split is a scalar
    # decision per slice, so each slice costs O(n^2) with at most two small
    # table gathers (see _E_IntLoop_slice).
    D = MAXLOOP + 2  # di, dj in [1, MAXLOOP+1]
    n2v = n + 2
    ii2 = np.arange(n2v)[:, None]
    jj2 = np.arange(n2v)[None, :]
    typ = pt[np.clip(ii2, 0, n + 1), np.clip(jj2, 0, n + 1)]
    Sc = np.clip(S, 0, 4)  # S[0] holds the length; masked cells clip codes
    si1 = Sc[np.clip(ii2 + 1, 0, n + 1)]
    sj1 = Sc[np.clip(jj2 - 1, 0, n + 1)]
    ptp = np.pad(pt, D, mode="constant")              # pt[k, l] shifted reads
    Scp = np.pad(Sc, D, mode="constant")
    EINT = np.full((D, D, n2v, n2v), INF, dtype=np.int32)
    base_valid = (ii2 >= 1) & (jj2 <= n) & (ii2 < jj2)
    for di in range(1, D):
        sp1 = Scp[D + np.clip(ii2 + di - 1, -D, n + 1 + D)]
        kk_ok = ii2 + di <= n
        for dj in range(1, D):
            # kk = ii+di, ll = jj-dj as shifted slices of the padded tables
            typ2 = RTYPE[ptp[D + ii2 + di, D + jj2 - dj]]
            sq1 = Scp[D + np.clip(jj2 - dj + 1, -D, n + 1 + D)]
            valid = (base_valid & kk_ok & (jj2 - dj >= 1)
                     & (ii2 + di <= jj2 - dj))
            e = _E_IntLoop_slice(di - 1, dj - 1, typ, typ2, si1, sj1,
                                 sp1, sq1, P)
            EINT[di, dj] = np.where(valid, e, INF)

    # pseudoknot-scaled variants (lrint = round-half-even, matching C lrint)
    EINTP = np.rint(pk.e_intP * EINT.astype(np.float64)).astype(np.int32)
    estp = np.rint(pk.e_stP * EINT[1, 1].astype(np.float64)).astype(np.int64)
    # get_e_stP returns INF when i+1 == j-1 (pseudo_loop.cc:828-834)
    iij = np.arange(n + 2)
    ESTP = np.where(iij[None, :] <= iij[:, None] + 2, INF, estp).astype(np.int32)

    H = _hairpin_table(seq, S, pt, P, n).astype(np.int32)

    # ---- multiloop / exterior stem tables --------------------------------
    i2 = np.arange(n + 2)[:, None]
    j2 = np.arange(n + 2)[None, :]
    mm5 = np.where(i2 > 1, S[np.clip(i2 - 1, 0, n + 1)], -1)
    mm3 = np.where(j2 < n, S[np.clip(j2 + 1, 0, n + 1)], -1)
    neg = np.full_like(mm5, -1)

    pt_ip1 = pt[np.clip(i2 + 1, 0, n + 1), j2]
    pt_jm1 = pt[i2, np.clip(j2 - 1, 0, n + 1)]
    pt_both = pt[np.clip(i2 + 1, 0, n + 1), np.clip(j2 - 1, 0, n + 1)]
    Si = S[np.clip(i2, 0, n + 1)] + 0 * j2
    Sj = S[np.clip(j2, 0, n + 1)] + 0 * i2

    ML0 = _stem(pt, neg, neg, P, True).astype(np.int32)
    ML2 = _stem(pt, mm5, mm3, P, True).astype(np.int32)
    ML_ip1 = _stem(pt_ip1, Si, neg, P, True).astype(np.int32)
    ML_jm1 = _stem(pt_jm1, neg, Sj, P, True).astype(np.int32)
    ML_both = _stem(pt_both, Si, Sj, P, True).astype(np.int32)

    # multiloop closing (VM): reversed pair type (s_energy_matrix.cc:125)
    ptr = pt.T
    Sip1 = S[np.clip(i2 + 1, 0, n + 1)] + 0 * j2
    Sjm1 = S[np.clip(j2 - 1, 0, n + 1)] + 0 * i2
    MB0 = (_stem(ptr, neg, neg, P, True) + P.MLclosing).astype(np.int32)
    MB2 = (_stem(ptr, Sjm1, Sip1, P, True) + P.MLclosing).astype(np.int32)
    MB_5 = (_stem(ptr, neg, Sip1, P, True) + P.MLclosing + P.MLbase).astype(np.int32)
    MB_3 = (_stem(ptr, Sjm1, neg, P, True) + P.MLclosing + P.MLbase).astype(np.int32)
    MB_53 = (_stem(ptr, Sjm1, Sip1, P, True) + P.MLclosing + 2 * P.MLbase).astype(
        np.int32
    )

    EXT0 = _stem(pt, neg, neg, P, False).astype(np.int32)
    EXT2 = _stem(pt, mm5, mm3, P, False).astype(np.int32)
    EXT_ip1 = _stem(pt_ip1, Si, neg, P, False).astype(np.int32)
    EXT_jm1 = _stem(pt_jm1, neg, Sj, P, False).astype(np.int32)
    EXT_both = _stem(pt_both, Si, Sj, P, False).astype(np.int32)

    return SeqTables(
        n=n, seq=seq, S=S, ptype=pt, can_pair=cp, H=H,
        EINT=EINT, EINTP=EINTP, ESTP=ESTP,
        ML0=ML0, ML2=ML2, ML_ip1=ML_ip1, ML_jm1=ML_jm1, ML_both=ML_both,
        MB0=MB0, MB2=MB2, MB_5=MB_5, MB_3=MB_3, MB_53=MB_53,
        EXT0=EXT0, EXT2=EXT2, EXT_ip1=EXT_ip1, EXT_jm1=EXT_jm1, EXT_both=EXT_both,
    )


def pad_seq_tables(
    tabs: SeqTables, n_pad: int, P: ScaledParams, pk, no_gu: bool = False
) -> SeqTables:
    """Tables for a fill padded to length n_pad whose [0..n+1]^2 window is
    bit-identical to the unpadded tables.

    A DP cell over a region [i, l] with l <= n only reads table entries with
    both sequence coordinates <= n+1, so overlaying the true-sequence tables
    onto an 'A'-padded build makes every true-window cell of the padded fill
    bit-identical to the unpadded fill — including the dangle-model boundary
    entries at j = n (ML2/MB2/EXT2 see the true sequence end instead of a
    padding base; without the overlay those entries leak the padding base
    into WM/WMv's last column).  Cells with l > n read padded-build entries
    and are never consumed (the host traceback stays inside [1, n]).
    """
    import dataclasses as _dc

    if n_pad == tabs.n:
        return tabs
    if n_pad < tabs.n:
        raise ValueError(f"n_pad={n_pad} < n={tabs.n}")
    big = build_seq_tables(tabs.seq + "A" * (n_pad - tabs.n), P, pk, no_gu=no_gu)
    w = tabs.n + 2
    out = {}
    for f in _dc.fields(SeqTables):
        bv = getattr(big, f.name)
        if f.name in ("n", "seq", "S"):
            out[f.name] = bv
            continue
        tv = getattr(tabs, f.name)
        bv = bv.copy()
        if bv.ndim == 2:
            bv[:w, :w] = tv
        else:  # EINT / EINTP: [D, D, n+2, n+2]
            bv[:, :, :w, :w] = tv
        out[f.name] = bv
    return SeqTables(**out)
