"""Gapped-region DP: span-bucketed step with a batched cross-span phase
(PyTorch).

Counterpart of ``ccj_tpu/engine/gapped4.py`` (the dense engine's span step;
that module's docstring explains the design).  Per span s:

* bucketed shapes — static (TB, IB) with TB >= s-1 covering the tt axis and
  IB >= n-s+2 covering the i axis;
* batched cross-span phase — every family with no same-span reads (PL, PR,
  PO, PRmloop01, POmloop00/01/10, PfromO) and every cross-span reduction
  base (the l-shrink / i-shrink history scans, all 16 in one
  ``cuda_ops.history_min`` launch, :data:`HISTORY_SCANS`) for ALL tt of the
  span at once; the PL/PR interior-loop stencils
  (one ``cuda_ops.stencil_pl`` / ``stencil_pr`` each a span) read the big
  PL/PR arrays in place, through the layout's window of int16 views
  (:class:`SpanReads`: the dense layout's one block of the DS spans below
  s, the packed layout's two segments, a row shard's halo), and one
  ``cuda_ops.span_assemble`` reads the 13 fixed-offset planes in place
  (``SpanReads.parts``) and assembles the rest;
* the serial tt loop (engine/ttloop.py) for the self-referential families,
  on INF-encoded int32 span slabs;
* one ``cuda_ops.span_store`` that packs the span's 22 families and writes
  them, their C skews and PKD / PKE into the layout's slots.

Energy-model quirks (mloop00 read-before-write, dead PO interior branch,
int16 store saturation) are reproduced exactly.  :func:`span_families`
assembles the recurrences once for both storage layouts: the dense one
here (:func:`dense_reads`, :func:`dense_dests`, :func:`span_gapped4`) and
the segment-packed one of engine/gapped5.py; each layout supplies its
reads and its write-back's destinations.  The span steps update the big
state IN PLACE: every read of the span's inputs happens before the
write-back at its end, as in the JAX data flow.

Every state array and per-sequence table carries a leading batch axis
(``[B, T, S, n2, n2]`` families, ``[B, n2, n2]`` tables, ``[B, ...]``
stencil weights); the scalar energies stay Python ints and the
shape-only masks (``valid4``) are shared by the batch.  One span step runs
the whole batch: ``fold.fill6`` is a batch of one, ``dist.batch`` a
bucket's batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import cuda_ops
from .common import I16, I32, INF, MAXLOOP, SAT16, TURN, pad_axis
from .cuda_ops import StoreDest
from .gapped import C_MATS, DS, M4_NAMES, WX, dims
from .ttloop import run_tt_loop

# families updated in the serial tt loop (same-span dependencies)
LOOP_MATS = (
    "PLmloop00", "PLmloop01", "PLmloop10",
    "PRmloop00", "PRmloop10",
    "PMmloop00", "PMmloop01", "PMmloop10",
    "PM", "PfromL", "PfromR", "PfromM", "PfromMprime", "PK",
)

_BUCKETS = (16, 32, 64, 128, 256, 512)


def bucket_dims(n: int, s: int):
    """Static (TB, IB) for span s: TB covers tt in [0, s-2], IB covers
    i in [0, n-s+1]."""
    T = max(n - 1, 1)
    n2 = n + 2
    TB = min(next((b for b in _BUCKETS if b >= max(s - 1, 1)), T), T)
    IB = min(next((b for b in _BUCKETS if b >= n - s + 2), n2), n2)
    return TB, IB


def _shift_window(x, DSZ, row_sign, col_sign, fill):
    """[DS, DS, A, B] windows W[d1-1, d2-1, a, b] = x[a + row_sign*d1,
    b + col_sign*d2] (out-of-range -> fill), from pad + slice pairs."""
    A, B = x.shape
    xpr = pad_axis(x, 0, DSZ + 1, DSZ + 1, fill)
    R = torch.stack([xpr[DSZ + 1 + row_sign * d1: DSZ + 1 + row_sign * d1 + A]
                     for d1 in range(1, DSZ + 1)])           # [DS, A, B]
    xpc = pad_axis(R, 2, DSZ + 1, DSZ + 1, fill)
    return torch.stack(
        [xpc[:, :, DSZ + 1 + col_sign * d2: DSZ + 1 + col_sign * d2 + B]
         for d2 in range(1, DSZ + 1)], dim=1)                # [DS, DS, A, B]


def build_sc4(EINTP, canp, n: int):
    """Static per-sequence stencil weight tables of the dense engine, built
    on the tables' device (the ``_sc4_device`` math of the JAX module).

    W4PL[d1, d2, i, j]: PL interior-loop weight with every loop bound of
    pseudo_loop.cc:694-699 folded in (d ranges, TURN clearance, inner-pair
    pairability).  W4PR[d1, d2, k, l]: the PR analogue
    (pseudo_loop.cc:729-734) on padded (k, l) axes so the u- and l-windows
    slice without clamping.  DPM[d1, d2, tt, u]: the PM stencil weight
    EINTP[d1, d2, j, k] at j = u - tt - d1, k = u + 2 + d2, masked to
    j >= 1, k <= n, canp(j, k) and u - tt in [1, n2), u + 2 < n2.
    ``EINTP`` is [32, 32, n2, n2] int32, ``canp`` [n2, n2] bool.
    """
    n2, T, S, U = dims(n)
    dev = EINTP.device
    EINTP = EINTP.to(I32)
    ar = lambda m: torch.arange(m, device=dev)  # noqa: E731
    d1 = ar(DS)[:, None, None, None] + 1
    d2 = ar(DS)[None, :, None, None] + 1

    iv = ar(n2)[None, None, :, None]
    jv = ar(n2)[None, None, None, :]
    sj = jv - iv
    canL = _shift_window(canp, DS, +1, -1, False)
    okL = ((d1 <= sj.clamp(max=MAXLOOP) - 1)
           & (d2 <= MAXLOOP - 1)
           & (d1 + d2 <= sj - TURN - 1)
           & (iv + d1 <= n2 - 1) & (jv - d2 >= 0)
           & canL)
    W4PL = torch.where(okL, EINTP[1:DS + 1, 1:DS + 1], INF)

    KP = n2 + T + 2          # k axis, accessed at k = u + 2, u < n2 + TB
    LP = 2 * n2              # l axis, accessed at l = i + s
    kv = ar(KP)[None, None, :, None]
    lv = ar(LP)[None, None, None, :]
    G = lv - kv
    canp_kl = torch.nn.functional.pad(canp, (0, LP - n2, 0, KP - n2), value=False)
    canR = _shift_window(canp_kl, DS, +1, -1, False)
    # every okR-valid (k, l) lies inside [0, n2): the pad value is never read
    eR = torch.nn.functional.pad(EINTP[1:DS + 1, 1:DS + 1],
                                 (0, LP - n2, 0, KP - n2), value=INF)
    okR = ((d1 <= G.clamp(max=MAXLOOP) - 1)
           & (d2 <= MAXLOOP - 1)
           & (d1 + d2 <= G - TURN - 1)
           & (kv + d1 <= n) & (lv - d2 >= 1) & (lv <= n)
           & canR)
    W4PR = torch.where(okR, eR, INF)

    # ---- DPM[d1, d2, tt, u] = EINTP[d1, d2, u-tt-d1, u+2+d2] masked ------
    jrow = ar(n2)[:, None]
    kcol = ar(n2)[None, :]
    B = torch.where(canp & (jrow >= 1) & (kcol <= n),
                    EINTP[1:DS + 1, 1:DS + 1], INF)           # [d1, d2, j, k]
    tt = ar(T)[:, None]
    u = ar(U)[None, :]
    jj = u - tt - d1                                          # [DS, 1, T, U]
    kk = u + 2 + d2                                           # [1, DS, 1, U]
    ok = ((jj >= 0) & (jj < n2) & (kk < n2)
          & (u - tt >= 1) & (u - tt <= n2 - 1) & (u + 2 <= n2 - 1))
    DPM = torch.where(ok, B[d1 - 1, d2 - 1, jj.clamp(0, n2 - 1),
                            kk.clamp(max=n2 - 1)], INF)
    return {"W4PL": W4PL, "W4PR": W4PR, "DPM": DPM}


def init_big_state4(n, device, batch: int = 1):
    """Big state beyond the 22 families: C-skews + PK diagonals, each with
    a leading batch axis of ``batch``."""
    n2, T, S, U = dims(n)
    st = {}
    for m in C_MATS:
        st["C_" + m] = torch.full((batch, T, S, n2, n2), SAT16, dtype=I16,
                                  device=device)
    st["PKD"] = torch.full((batch, T, S, n2, n2), SAT16, dtype=I16, device=device)
    st["PKE"] = torch.full((batch, T, S + T + 2, n2, n2), SAT16, dtype=I16,
                           device=device)
    return st


def pk_dests(st, s, n):
    """The PK diagonal skews' destinations of span s (:class:`StoreDest`,
    skewed): PKD[:, :, s] and PKE[:, tt, s - tt] for tt <= min(s, T - 1),
    each (tt, i, a) taking PK[tt, i, i + a] (``update_pk_skews4`` of the
    JAX module; rows tt > s write back their own value in its scatter and
    are left alone).  A row shard of dist/wavefront.py passes its own
    arrays, whose row 0 is its i0."""
    T = dims(n)[1]
    PKE = st["PKE"]
    b0, t1, u1, r1, j1 = PKE.stride()
    diag = PKE.as_strided((PKE.shape[0], min(s, T - 1) + 1, *PKE.shape[3:]),
                          (b0, t1 - u1, r1, j1), PKE.storage_offset() + s * u1)
    return [StoreDest("PK", st["PKD"][:, :, s], skew=True), StoreDest("PK", diag, skew=True)]


# The span's 16 history scans (the l-shrink RL and i-shrink RI reductions
# that span_families reads), as data: (output key, mode, family, weight
# table, g1).  Scans with one (mode, family, g1) share a window, read once:
# 12 windows, four of them (RL and RI POmloop00, RL PRmloop00, RI
# PLmloop00) serving two scans.  RL reads the family itself, RI its C skew.
HISTORY_TABLES = ("WBt", "WBPg", "WPt")
HISTORY_SCANS = (
    # key            mode         family       table   g1
    ("POm00_ri",     cuda_ops.RI, "POmloop00", "WBt",  0),
    ("POm00_rl",     cuda_ops.RL, "POmloop00", "WBt",  0),
    ("POm01",        cuda_ops.RL, "POmloop00", "WBPg", 0),
    ("POm10_ri",     cuda_ops.RI, "POmloop00", "WBPg", 0),
    ("POm10_rl",     cuda_ops.RL, "POmloop10", "WBt",  1),
    ("PRm01",        cuda_ops.RL, "PRmloop00", "WBPg", 0),
    ("PfromO_ri",    cuda_ops.RI, "PfromO",    "WPt",  1),
    ("PfromO_rl",    cuda_ops.RL, "PfromO",    "WPt",  1),
    ("PLmloop00",    cuda_ops.RI, "PLmloop00", "WBt",  0),
    ("PLmloop10",    cuda_ops.RI, "PLmloop00", "WBPg", 0),
    ("PRmloop00",    cuda_ops.RL, "PRmloop00", "WBt",  0),
    ("PMmloop01",    cuda_ops.RL, "PMmloop00", "WBPg", 0),
    ("PMmloop10_ri", cuda_ops.RI, "PMmloop00", "WBPg", 0),
    ("PMmloop10_rl", cuda_ops.RL, "PMmloop10", "WBt",  1),
    ("PfromL",       cuda_ops.RI, "PfromL",    "WPt",  1),
    ("PfromR",       cuda_ops.RL, "PfromR",    "WPt",  1),
)


def history_groups(mode=None):
    """:data:`HISTORY_SCANS` by window, in order of first appearance (only
    ``mode``'s where given): [(mode, family, g1, [(table index, key)])]."""
    groups = {}
    for key, m, fam, tab, g1 in HISTORY_SCANS:
        if mode is None or m == mode:
            groups.setdefault((m, fam, g1), []).append((HISTORY_TABLES.index(tab), key))
    return [(m, fam, g1, outs) for (m, fam, g1), outs in groups.items()]


def history_launch(groups, windows, W, s, i0, TB, R):
    """One ``cuda_ops.history_min`` over the windows of ``groups``
    (:func:`history_groups`), each window's parts from ``windows(mode,
    family)`` ([(int16 view, d0)] whose row 0 is i = i0); ``W`` maps each
    of :data:`HISTORY_TABLES` to its [B, n2, n2] table.  Returns (keys,
    int32 [K, B, TB, R, n2]), plane k holding scan ``keys[k]``."""
    wins, keys = [], []
    for mode, fam, g1, outs in groups:
        wins.append((mode, g1, windows(mode, fam),
                     [(t, len(keys) + q) for q, (t, _key) in enumerate(outs)]))
        keys += [key for _t, key in outs]
    return keys, cuda_ops.history_min(wins, [W[t] for t in HISTORY_TABLES], s=s, i0=i0,
                                      TB=TB, R=R)


class SpanReads(NamedTuple):
    """How one storage layout serves span s's cross-span reads to
    :func:`span_families` (built per span by :func:`dense_reads` and
    ``gapped5.packed_reads``):

    * ``parts(name, c, b, di)``: the plane name[tt+c, s-b, i+di, j] of the
      rows i in [i0, i0 + IB), read in place by ``cuda_ops.span_assemble``:
      a list of at most ``cuda_ops.PLANE_MAX_PARTS`` (int16 view [B, TTv,
      Rv, n2], t0, r0) parts, plane row r and tt at view row r + r0 and
      tt + t0 (``cuda_ops.plane_slab``); a cell no part holds reads unset;
    * ``history(W)``: the span's 16 history scans (:data:`HISTORY_SCANS`)
      for all tt, a dict of int32 [B, TB, IB, n2] by key, with the weight
      tables ``W`` (``{"WBt": .., "WBPg": .., "WPt": ..}``, [B, n2, n2]):
      one ``cuda_ops.history_min`` launch (a row shard: one for its RL
      windows and one per owner of its RI windows' C rows);
    * ``window(name, halo)``: the PL / PR stencil window of family
      ``name``, read in place: a list of at most
      ``cuda_ops.STENCIL_MAX_PARTS`` (view, u0) pairs, each view an int16
      strided view [B, TTw, Uw, Rw, n2] into the state whose span u row
      holds span u0 + u and whose row 0 is i = i0, together holding the
      spans in [s - DS, s) the layout stores; rows [i0, i0 + IB + halo)
      are what the stencil reads.  A span no view holds (below 0), a tt
      row past a view's and a row past it read as unset.

    Every read is of rows i in [i0, i0 + IB): the whole state has i0 = 0;
    a row shard of dist/wavefront.py has its own.
    """
    parts: Callable
    history: Callable
    window: Callable


class SpanResult(NamedTuple):
    """:func:`span_families`' result for the layout's write-back
    (:func:`store_span`): the tt loop's 14 families (``loops``, int32
    [B, TB, IB, n2] by name) and the 8 packed cross-span families (``xs``,
    ``cuda_ops.span_assemble``'s int16 [8, B, TB, IB, n2]) of span ``s``,
    rows [i0, i0 + IB)."""
    loops: dict
    xs: torch.Tensor
    n: int
    s: int
    i0: int
    TB: int
    IB: int


def store_span(res: SpanResult, dests):
    """Write ``res`` into the layout's destinations (``cuda_ops.StoreDest``
    views into the state): one ``cuda_ops.span_store``."""
    cuda_ops.span_store(dests, res.loops, res.xs, s=res.s, n=res.n, i0=res.i0, TB=res.TB,
                        IB=res.IB)


def dense_rl(st, s, TB, IB):
    """The dense layout's RL windows over the first IB rows of ``st``'s
    families: ``family -> [(view, d0)]``, the TB spans below s.  Row-local,
    so a row shard of dist/wavefront.py (its arrays' row 0 is its i0) uses
    it as it is."""
    sp0 = max(s - TB, 0)
    return lambda fam: [(st[fam][:, :TB, sp0:sp0 + TB, :IB], s - sp0)]


def dense_reads(st, n, s, TB, IB):
    """:class:`SpanReads` of the dense layout ([T, S, n2, n2] families and
    C skews), rows from i = 0."""
    n2, T, S, U = dims(n)

    def parts(name, c, b, di):
        """The family's slot at span max(s - b, 0) (a read at a span below
        0 is masked by the assembly): tt rows from c, rows from di; rows
        past n2 and tt rows past T read unset."""
        return [(st[name][:, :, max(s - b, 0)], c, di)]

    def history(W):
        """Every scan in one launch: RL over the family's TB spans below s,
        RI over its C skew's rows l = i + s (rows with l >= n2 have none)."""
        sp0, rows = max(s - TB, 0), min(IB, n2 - s)
        rl = dense_rl(st, s, TB, IB)

        def windows(mode, fam):
            if mode == cuda_ops.RL:
                return rl(fam)
            return [(st["C_" + fam][:, :TB, sp0:sp0 + TB, s:s + rows], s - sp0)]

        return dict(zip(*history_launch(history_groups(), windows, W, s, 0, TB, IB)))

    def window(name, halo=DS):
        """The stencil window (see :class:`SpanReads`): one view of the
        spans max(s - DS, 0) .. s - 1, every row, whatever ``halo``."""
        lo = max(s - DS, 0)
        return [(st[name][:, :, lo:s], lo)]

    return SpanReads(parts, history, window)


def dense_dests(st, n, s, TB):
    """The dense layout's write-back of span s (``cuda_ops.StoreDest`` s):
    each family's slot at span s (its rows from IB unset), each C skew's
    rows l = i + s of it (the rows l < s unset), PKD and PKE
    (:func:`pk_dests`)."""
    return ([StoreDest(name, st[name][:, :TB, s]) for name in M4_NAMES]
            + [StoreDest(name, st["C_" + name][:, :TB, s], -s) for name in C_MATS]
            + pk_dests(st, s, n))


def pl_stencil(reads: SpanReads, SC4, s, n, TB, IB, i0=0):
    """PL's interior-loop stencil for every tt of the span, int32
    [B, TB, IB, n2]: pl_int[tt, i, j] = min over d1, d2 of
    PL(tt+d2, s-d1, i+d1, j-d2) + W4PL[d1, d2, i, j] (pseudo_loop.cc:682-703),
    INF where no term is admissible and off the span's valid cells: one
    ``cuda_ops.stencil_pl`` over the layout's in-place window (a DS-row
    halo below the rows)."""
    return cuda_ops.stencil_pl(reads.window("PL", DS), SC4["W4PL"], s=s, n=n, i0=i0,
                               TB=TB, R=IB)


def pr_stencil(reads: SpanReads, SC4, s, n, TB, IB, i0=0):
    """PR's interior-loop stencil for every tt of the span, int32
    [B, TB, IB, n2]: pr_int[tt, i, j] = min over d1, d2 of
    PR(tt+d1, s-d2, i, j) + W4PR[d1, d2, k, l] (pseudo_loop.cc:717-738),
    k = j + tt + 2, l = i + s, INF where no term is admissible and off the
    span's valid cells: one ``cuda_ops.stencil_pr`` over the layout's
    in-place window (the rows themselves, no halo)."""
    return cuda_ops.stencil_pr(reads.window("PR", 0), SC4["W4PR"], s=s, n=n, i0=i0,
                               TB=TB, R=IB)


def span_families(C, SC4, st, s, TB, IB, reads: SpanReads, i0: int = 0):
    """All 22 gapped families for span s, read from the state through
    ``reads`` (its layout's :class:`SpanReads`), as a :class:`SpanResult`
    for the layout's write-back (:func:`store_span`).  Writes nothing, so
    the caller's write-back into ``st`` follows every read of the span.

    Per span: the weight tables (the fill's kept ones, ``gapped.WX`` in
    ``C``, which a caller outside a fill puts there: ``gapped._wx_tables``
    of the state), the PL / PR stencils, the 16 history scans,
    one ``cuda_ops.span_assemble`` (the fixed-offset plane reads in place,
    the PL / PR / PO assembly and the cross-span-only families for every
    tt) and the serial tt loop (one ``tt_span``).  The slabs' rows are i in
    [i0, i0 + IB).  TB >= s-1 covers tt; the whole state (i0 = 0) takes
    IB >= n-s+2, a row shard of dist/wavefront.py its rows with i <= n - s
    (caller guarantees; padded rows are never valid)."""
    n = C["n"]
    n2 = n + 2
    WBt, WPt, WBPg, _ = C[WX]
    pl_int = pl_stencil(reads, SC4, s, n, TB, IB, i0)
    pr_int = pr_stencil(reads, SC4, s, n, TB, IB, i0)
    H = reads.history({"WBt": WBt, "WBPg": WBPg, "WPt": WPt})
    A = cuda_ops.span_assemble(
        [reads.parts(name, c, b, di) for name, c, b, di, _dj in cuda_ops.ASSEMBLE_READS],
        pl_int, pr_int, [H[k] for k in cuda_ops.ASSEMBLE_HISTORY],
        (C["can_pair"], C["ptype"], C["ESTP"]), s=s, n=n, i0=i0, TB=TB, IB=IB,
        ap=C["ap"], bp=C["bp"], cp=C["cp"], PB=C["PB"])
    bases = {"PLmloop00": H["PLmloop00"], "PLmloop10": H["PLmloop10"],
             "PRmloop00": H["PRmloop00"], "PMmloop01": H["PMmloop01"],
             "PMmloop10": A.pmm10, "PfromL": H["PfromL"], "PfromR": H["PfromR"]}

    # ---- serial loop over tt (descending): one tt_span per span ----------
    valid4 = cuda_ops.span_valid(n, s, i0, TB, IB, n2, A.xs.device)
    cur = run_tt_loop(C, SC4, WBt, WPt, WBPg, bases, A.PLs, A.PRs, A.POs, A.mdp0,
                      valid4, s, TB, IB, i0)
    return SpanResult({name: cur[name] for name in LOOP_MATS}, A.xs, n, s, i0, TB, IB)


def span_gapped4(C, SC4, st, s, TB, IB):
    """All 22 gapped families for span s; updates the dense big state in
    place and returns it.

    TB, IB are bucket sizes with TB >= s-1 and IB >= n-s+2 (caller
    guarantees; padded rows are never valid and never written back).
    """
    n = C["n"]
    store_span(span_families(C, SC4, st, s, TB, IB, dense_reads(st, n, s, TB, IB)),
               dense_dests(st, n, s, TB))
    return st
