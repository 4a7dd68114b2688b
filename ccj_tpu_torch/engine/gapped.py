"""Gapped-region (pseudoknot) DP: the 22 four-dimensional matrix families.

Counterpart of the parts of ``ccj_tpu/engine/gapped.py`` the dense fill
(``fold.fill6``) reads: the family names, the WB/WP lookup tables, the P
diagonal write and the WBP/WPP span update.  Storage layout is
``M[tt, s, i, j]`` with ``s = l - i`` (outer span) and ``tt = k - j - 2``
(gap diagonal); k and l are implicit.  The reference's quirks are kept
exactly (see ``ccj_tpu/engine/gapped.py`` for the pseudo_loop.cc citations).

The layout constants ``DS``, ``PADT``, ``C_MATS`` and ``dims`` come from
``ccj_tpu/engine/gapped2.py`` (the v2-lineage layout vocabulary shared by
the v3+ engines); the rest of that module is not on the dense path.
"""

from __future__ import annotations

import torch

from .common import INF, MAXLOOP, mmin, v_get

M4_NAMES = [
    "PK", "PL", "PR", "PM", "PO",
    "PfromL", "PfromR", "PfromM", "PfromMprime", "PfromO",
    "PLmloop00", "PLmloop01", "PLmloop10",
    "PRmloop00", "PRmloop01", "PRmloop10",
    "PMmloop00", "PMmloop01", "PMmloop10",
    "POmloop00", "POmloop01", "POmloop10",
]

# ---- from ccj_tpu/engine/gapped2.py ---------------------------------------
DS = MAXLOOP - 1       # interior-loop stencil offsets run 1..29
PADT = 32              # tt-axis stencil padding (the PM stencil reads tt + 2*DS)
# families with a C-layout copy [tt, s, l, j], l = i + s, for i-shrink scans
C_MATS = ("PLmloop00", "PMmloop00", "POmloop00", "PfromL", "PfromO")


def dims(n):
    """(n2, T, S, U): padded length, tt extent, span extent, u = j + tt extent."""
    n2 = n + 2
    T = max(n - 1, 1)
    S = max(n, 1)
    U = n2 + T
    return n2, T, S, U


def _wx_tables(C, st):
    """Dense WB/WP/WBP-get/WPP-get lookup tables for the current state."""
    n = C["n"]
    n2 = n + 2
    dev = st["WBP"].device
    a = torch.arange(n2, device=dev)[:, None]
    b = torch.arange(n2, device=dev)[None, :]
    inb = (a >= 1) & (b >= 1) & (a <= n) & (b <= n)

    def wx(raw, unit):
        base = torch.minimum((unit * (b - a + 1)).to(torch.int32), raw)
        return torch.where(inb, torch.where(a > b, 0, base), INF)

    WB = wx(st["WBP"], C["cp"])
    WP = wx(st["WPP"], C["PUP"])
    # TriangleMatrix::get (i>j -> INF) for the >=1-pair variants
    WBPg = torch.where(a > b, INF, st["WBP"])
    WPPg = torch.where(a > b, INF, st["WPP"])
    return WB, WP, WBPg, WPPg


def _set_P_diag(st, n, s, p_min):
    """Write the span-s diagonal of P from the candidate minima p_min[i];
    in place."""
    n2 = n + 2
    P2 = st["P2"]
    ii = torch.arange(n2, device=P2.device)
    ll = ii + s
    llc = ll.clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (ll <= n)
    old = P2[ii, llc]
    newP = torch.where(p_min < INF // 2, p_min, old)
    P2[ii, llc] = torch.where(row_valid, newP, old)
    return st


def compute_WBP_WPP_span(C, st, s):
    """compute_WBP / compute_WPP for all blocks (i, l=i+s)
    (pseudo_loop.cc:134-164); P(.,.) of this span must be written already.
    Updates WBP and WPP in place."""
    n = C["n"]
    n2 = n + 2
    dev = st["WBP"].device
    ii = torch.arange(n2, device=dev)
    ll = ii + s
    llc = ll.clamp(0, n2 - 1)
    lm1 = (ll - 1).clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (ll <= n)

    WB, WP, _, _ = _wx_tables(C, st)
    gg = torch.arange(n2, device=dev)[:, None]          # g = d - i in [0, s-1]
    iv2 = ii[None, :]
    dd = iv2 + gg
    ok = (gg >= 0) & (gg <= s - 1) & (iv2 >= 1) & (iv2 + s <= n)
    ddc = dd.clamp(0, n2 - 1)
    lv = (iv2 + s).clamp(0, n2 - 1)
    vdl = v_get(st["V"], ddc, lv)
    pdl = torch.where(dd > iv2 + s, INF, st["P2"][ddc, lv])  # P.get(d,l), d<=l
    ivc = iv2.clamp(0, n2 - 1)
    dm1 = (dd - 1).clamp(0, n2 - 1)

    WBPr = st["WBP"]
    wb_prev = torch.where(dd - 1 >= 0, WB[ivc, dm1], INF)
    b1 = torch.where(ok, wb_prev + vdl + C["bp"] + C["PPS"], INF).amin(dim=0)
    b2 = torch.where(ok, wb_prev + pdl + C["PSM"] + C["PPS"], INF).amin(dim=0)
    b3 = torch.where(ii > ll - 1, INF, WBPr[ii, lm1]) + C["cp"]
    wbp_min = mmin(b1, b2, b3)

    WPPr = st["WPP"]
    wp_prev = torch.where(dd - 1 >= 0, WP[ivc, dm1], INF)
    c1 = torch.where(ok, wp_prev + vdl + C["PPS"], INF).amin(dim=0)
    c2 = torch.where(ok, wp_prev + pdl + C["PSP"] + C["PPS"], INF).amin(dim=0)
    c3 = torch.where(ii > ll - 1, INF, WPPr[ii, lm1]) + C["PUP"]
    wpp_min = mmin(c1, c2, c3)

    old = WBPr[ii, llc]
    newWBP = torch.where(wbp_min < INF // 2, wbp_min, old)
    WBPr[ii, llc] = torch.where(row_valid, newWBP, old)
    old = WPPr[ii, llc]
    newWPP = torch.where(wpp_min < INF // 2, wpp_min, old)
    WPPr[ii, llc] = torch.where(row_valid, newWPP, old)
    return st
