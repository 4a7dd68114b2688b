"""Gapped-region DP, segment-packed ("fill7") storage for long sequences
(PyTorch).

Counterpart of ``ccj_tpu/engine/gapped5.py``.  The dense layout stores every
family as [T, S, n2, n2], n^4 cells of which ~1/24 are valid: 97.5 GB of
state at n=200 with the C skews, PKD and PKE, more than one 80 GB H100
holds.  This engine keeps the dense compute (the same recurrences,
``gapped4.span_families``, bit-identical) but stores each family per SPAN
SEGMENT with exact extents:

    name@g   : [TB_g, ns_g, IB_g, n2]   spans [lo_g, hi_g)
    C_name@g : [TB_g, ns_g, Lc_g, n2]   C rows l - lo_g - 1
    TB_g = hi_g - 2   (tt <= s - 2 < hi_g - 2)
    IB_g = n - lo_g + 2   (i <= n - s + 1 < IB_g)

Cross-span reads are resolved per segment with Python-int span arithmetic:

* fixed-offset reads at spans s-1 / s-2 and the MAXLOOP stencil windows read
  segment g or (for spans below lo_g) segment g-1; no overlap copies exist,
  so segments are at least ``MIN_SEG`` wide; a stencil window is one int16
  view of each of the two segments, read in place by the kernel
  (``cuda_ops.stencil_pl`` / ``stencil_pr``);
* the l-shrink / i-shrink history scans (RL / RI) read ALL prior
  segments, each segment's exact-extent block one part of its window in
  the span's one ``cuda_ops.history_min`` launch.

Rows beyond a segment's extents do not exist; every read pads them with the
int16 unset value, the same losing candidates the dense layout holds there.

One deliberate deviation from the JAX module: **PKD and PKE stay dense**
(``gapped4.init_big_state4``'s shapes), so the span step reuses the port's
in-place PK write-back (``gapped4.pk_dests``) and ``gapped3.compute_P_span3``
unchanged, and ``update_pk_skews7`` / ``compute_P_span7`` are not ported.
The JAX module stores PKE per segment because XLA copied the dense PKE on
every span's scatter; an in-place ``index_put`` makes no such copy.  The
dense PKE costs 5.1 GB more at n=200 (31.4 GB of state in all, against
26.2 GB), and spares the card ``compute_P_span7``'s per-lane x per-segment
loop, about six times the P split's dispatches at n=200.

Every array carries the shared span assembly's leading batch axis, of one:
the JAX package has no batched packed fill, and ``fold.fill7`` drops the
axis from the state it returns.
"""

from __future__ import annotations

import torch

from . import cuda_ops
from .common import I16, SAT16
from .cuda_ops import StoreDest
from .gapped import C_MATS, DS, M4_NAMES, dims
from .gapped4 import (SpanReads, history_groups, history_launch, pk_dests, span_families,
                      store_span)

MIN_SEG = DS + 2   # every cross-span window must fit within one neighbor

# Families with NO canonical-layout reads in the fill: PK's history lives
# in the PKD diagonal skew, PLmloop00/PfromL's in their C skews (their only
# cross-span reads are the RI i-shrink scans and one C-servable fixed-
# offset read).  The traceback reads them through the surviving layouts
# (engine/lazy.py translations).
DROPPED = ("PK", "PLmloop00", "PfromL")
M4_STORED = tuple(m for m in M4_NAMES if m not in DROPPED)


def segments7(n: int, width: int | None = None):
    """Static segment schedule: ((lo, hi, TB, IB, Lc), ...).

    Lc is the C-layout row extent (rows l - lo - 1; writes of span s touch
    rows up to (n + 1 - lo) + (s - lo) - 1, see the write-back)."""
    if width is None:
        width = max(MIN_SEG, (n + 5) // 6)
    segs = []
    lo = 0
    while lo < n:
        # every segment but the LAST must be at least MIN_SEG wide (its
        # successor's fixed-offset and stencil-window reads reach at most
        # one segment back); a short final segment is fine
        hi = min(lo + width, n)
        TB = max(hi - 2, 1)
        IB = n - lo + 2
        Lc = (n + 2 - lo) + (hi - lo - 1)
        segs.append((lo, hi, TB, IB, Lc))
        lo = hi
    assert all(h - l >= MIN_SEG for l, h, *_ in segs[:-1]), segs
    return tuple(segs)


def init_big_state7(n: int, SEGS, device):
    """Per-segment packed families and C skews, plus the dense PK diagonal
    skews PKD / PKE (see the module docstring), each with a leading batch
    axis of one."""
    n2, T, S, U = dims(n)
    st = {}
    for g, (lo, hi, TB, IB, Lc) in enumerate(SEGS):
        ns = hi - lo
        for m in M4_STORED:
            st[f"{m}@{g}"] = torch.full((1, TB, ns, IB, n2), SAT16, dtype=I16,
                                        device=device)
        for m in C_MATS:
            st[f"C_{m}@{g}"] = torch.full((1, TB, ns, Lc, n2), SAT16,
                                          dtype=I16, device=device)
    st["PKD"] = torch.full((1, T, S, n2, n2), SAT16, dtype=I16, device=device)
    st["PKE"] = torch.full((1, T, S + T + 2, n2, n2), SAT16, dtype=I16,
                           device=device)
    return st


def prior_spans(SEGS, h: int, s: int) -> int:
    """Spans of segment h that span s's history scans reduce: those below
    s.  Spans u >= s of the current segment are not written yet and every
    term they give is masked (d = s - u <= 0), so the scans stop at s - 1:
    the same minimum over fewer terms."""
    loh, hih = SEGS[h][0], SEGS[h][1]
    return min(hih, s) - loh


def prior_segments(SEGS, gi: int, s: int):
    """[(h, lo_h, spans)]: the segments up to gi with a span below s, and
    how many (:func:`prior_spans`): every part of a span-s history scan."""
    out = [(h, SEGS[h][0], prior_spans(SEGS, h, s)) for h in range(gi + 1)]
    return [(h, loh, nsh) for h, loh, nsh in out if nsh > 0]


def packed_rl(st, s, gi: int, SEGS, IB):
    """The packed layout's RL windows for span s of segment gi over the
    first IB rows of every ``name@h`` block in ``st``: ``family -> [(view,
    d0)]``, a part per prior segment (its tt rows past the segment's read
    SAT16).  Row-local; a row shard of dist/wavefront.py (its blocks' rows
    from ``i0``) uses it as it is."""
    hist = prior_segments(SEGS, gi, s)
    return lambda fam: [(st[f"{fam}@{h}"][:, :, :nsh, :IB], s - loh)
                        for h, loh, nsh in hist]


def packed_reads(st, n, s, gi: int, SEGS):
    """``gapped4.SpanReads`` of the segment-packed layout for span s of
    segment gi (``SEGS[gi]`` gives the span's TB and IB)."""
    n2, T, S, U = dims(n)
    lo, hi, TB, IB, _Lc = SEGS[gi]

    def seg_of(u):
        """The segment a fixed-offset read at span u takes: gi, or gi - 1
        for spans below lo (spans below 0 are masked by the caller, so
        segment 0 serves them with a clamped, unused read)."""
        return gi if gi == 0 or u >= lo else gi - 1

    # ---- segment-resolved plane reads, in place -------------------------
    def parts(name, c, b, di):
        """Family ``name`` at span u = s-b from its segment (``seg_of``), tt
        rows from c, rows from di; a family stored ONLY as its C skew
        (``DROPPED``) from that skew's rows l = i + di + u, local row
        l - lo_h - 1 (rows before its row 0 read unset).  Extents the
        segment does not hold read unset."""
        u = s - b
        h = seg_of(u)
        loh, hih = SEGS[h][:2]
        span = min(max(u - loh, 0), hih - loh - 1)
        if name in DROPPED:
            return [(st[f"C_{name}@{h}"][:, :, span], c, u + di - loh - 1)]
        return [(st[f"{name}@{h}"][:, :, span], c, di)]

    # ---- cross-span reductions: ALL prior segments -------------------------
    def history(W):
        """Every scan in one launch, a part per prior segment: RL over the
        family's blocks (:func:`packed_rl`), RI over its C skews' rows
        l = i + s (local row l - lo_h - 1 of segment h's skew, s - lo_h - 1
        >= 0 where the segment has a prior span; rows l >= n2 have none)."""
        rows = min(IB, n2 - s)
        rl = packed_rl(st, s, gi, SEGS, IB)
        hist = prior_segments(SEGS, gi, s)

        def windows(mode, fam):
            if mode == cuda_ops.RL:
                return rl(fam)
            return [(st[f"C_{fam}@{h}"][:, :, :nsh, s - loh - 1:s - loh - 1 + rows], s - loh)
                    for h, loh, nsh in hist]

        return dict(zip(*history_launch(history_groups(), windows, W, s, 0, TB, IB)))

    # ---- MAXLOOP stencil windows (PL / PR) -------------------------------
    def window(name, halo=DS):
        """The stencil window (``gapped4.SpanReads``), read in place: one
        view of segment gi - 1 for the spans below lo (it holds all of
        them: segments are at least MIN_SEG wide) and one of segment gi
        from lo, every row the segment stores, whatever ``halo``; spans
        below 0 are in neither."""
        return [(st[f"{name}@{h}"][:, :, a - SEGS[h][0]:b - SEGS[h][0]], a)
                for h, a, b in window_spans(s, gi, SEGS)]

    return SpanReads(parts, history, window)


def window_spans(s, gi: int, SEGS):
    """[(h, a, b)]: the segments h a span-s stencil window reads and the
    spans [a, b) of s - DS .. s - 1 each holds (segment gi - 1 below lo_gi,
    gi from it; spans below 0 in neither)."""
    lo = SEGS[gi][0]
    out = []
    for h, a, b in ((gi - 1, max(s - DS, 0), min(lo, s)), (gi, max(s - DS, lo), s)):
        if h >= 0 and a < b:
            out.append((h, a, b))
    return out


def packed_dests(st, n, s, gi: int, SEGS):
    """The packed layout's write-back of span s of segment gi
    (``cuda_ops.StoreDest`` s): each stored family's block at span s, each
    C skew's rows from i = 1 (local row l - lo - 1 = (s - lo) + (i - 1); the
    invalid i = 0 row is dropped), the dense PKD and PKE
    (``gapped4.pk_dests``)."""
    u, IB = s - SEGS[gi][0], SEGS[gi][3]
    return ([StoreDest(name, st[f"{name}@{gi}"][:, :, u]) for name in M4_STORED]
            + [StoreDest(name, st[f"C_{name}@{gi}"][:, :, u, u:u + IB - 1], 1)
               for name in C_MATS]
            + pk_dests(st, s, n))


def span_gapped7(C, SC4, st, s, gi: int, SEGS):
    """All 22 gapped families for span s of segment gi; updates the packed
    state in place (every read of the span's inputs happens before the
    write-back into segment gi) and returns it."""
    n = C["n"]
    lo, hi, TB, IB, _Lc = SEGS[gi]
    store_span(span_families(C, SC4, st, s, TB, IB, packed_reads(st, n, s, gi, SEGS)),
               packed_dests(st, n, s, gi, SEGS))
    return st
