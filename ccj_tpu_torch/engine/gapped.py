"""Gapped-region (pseudoknot) DP: the 22 four-dimensional matrix families.

Counterpart of the parts of ``ccj_tpu/engine/gapped.py`` the dense fill
(``fold.fill6``) reads: the family names, the WB/WP lookup tables, the P
diagonal write and the WBP/WPP span update.  Storage layout is
``M[tt, s, i, j]`` with ``s = l - i`` (outer span) and ``tt = k - j - 2``
(gap diagonal); k and l are implicit.  The reference's quirks are kept
exactly (see ``ccj_tpu/engine/gapped.py`` for the pseudo_loop.cc citations).
State arrays carry a leading batch axis, as in engine/nested.py.

On the card the WB/WP tables are one ``cuda_ops.wx_tables`` launch a fill,
not a span: a fill keeps them in its tables' dict under :data:`WX` and
``cuda_ops.span_wbp`` (csrc/span2d.cu), one launch a span, writes P's
span-s diagonal from the P split's minima, WBP / WPP and the kept tables'
span-s cells (each table cell depends on WBP / WPP at that cell alone, and
only this update writes them).  ``cuda_ops`` is imported where it is
called, since it imports this module.

The layout constants ``DS``, ``PADT``, ``C_MATS`` and ``dims`` come from
``ccj_tpu/engine/gapped2.py`` (the v2-lineage layout vocabulary shared by
the v3+ engines); the rest of that module is not on the dense path.
"""

from __future__ import annotations

import torch

from .common import INF, MAXLOOP

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


# the key of a fill's kept weight tables in its tables' dict C: int32
# [4, B, n2, n2] (WB, WP, WBPg, WPPg), current for every span done so far
WX = "WX"


def _wx_tables(C, st):
    """Dense WB/WP/WBP-get/WPP-get lookup tables for the current state, made
    from scratch: int32 [4, B, n2, n2] (WB, WP, WBPg, WPPg along its first
    axis): one ``cuda_ops.wx_tables``."""
    from . import cuda_ops

    return cuda_ops.wx_tables(C, st)


def step_tables(C, st):
    """``C`` with the weight tables the gapped step reads (:data:`WX`) made
    from ``st``: for a step run outside a fill, which keeps its own."""
    return {**C, WX: _wx_tables(C, st)}


def _set_P_diag(st, n, s, p_min):
    """Write the span-s diagonal of P from the candidate minima
    p_min[b, i]; in place (``cuda_ops.span_wbp`` does the same in its
    launch)."""
    n2 = n + 2
    P2 = st["P2"]
    ii = torch.arange(n2, device=P2.device)
    ll = ii + s
    llc = ll.clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (ll <= n)
    old = P2[:, ii, llc]
    newP = torch.where(p_min < INF // 2, p_min, old)
    P2[:, ii, llc] = torch.where(row_valid, newP, old)
    return st


def compute_WBP_WPP_span(C, st, s, p_min=None):
    """compute_WBP / compute_WPP for all blocks (i, l=i+s)
    (pseudo_loop.cc:134-164).  P(.,.) of this span must be written already,
    or its candidate minima given (``p_min`` [B, n2], the P split's): then
    P's span-s diagonal is written first (the rule of :func:`_set_P_diag`).
    Updates P, WBP and WPP in place, and the fill's kept weight tables
    where ``C`` holds them (:data:`WX`): one ``cuda_ops.span_wbp``."""
    from . import cuda_ops

    cuda_ops.span_wbp(C, st, s, p_min, C.get(WX))
    return st
