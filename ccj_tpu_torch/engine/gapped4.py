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
  s, the packed layout's two segments, a row shard's halo);
* the serial tt loop (engine/ttloop.py) for the self-referential families,
  on INF-encoded int32 span slabs.

Energy-model quirks (mloop00 read-before-write, dead PO interior branch,
int16 store saturation) are reproduced exactly.  :func:`span_families`
assembles the recurrences once for both storage layouts: the dense one
here (:func:`dense_reads`, :func:`span_gapped4`) and the segment-packed
one of engine/gapped5.py; each layout supplies its reads and its
write-back.  The span steps update the big state IN PLACE: every read of
the span's inputs happens before the write-back at its end, as in the JAX
data flow.

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
from .common import (I16, I32, INF, MAXLOOP, SAT16, TURN, dynamic_slice,
                     dynamic_update_slice, mmin, pad_axis)
from .gapped import C_MATS, DS, M4_NAMES, _wx_tables, dims
from .skew import unskew_right
from .ttloop import diag_il, plane_ij, plane_kl, run_tt_loop

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


def update_pk_skews4(st, pk16, s, n, i0=0):
    """Refresh PKD / PKE from span s's packed PK slab [B, TB, IB, n2]
    int16, in place: PKD[tt, s, i, a] = PK[tt, s, i, i+a] and
    PKE[tt, s - tt, i, a] = PKD[tt, s, i, a] for tt <= s.  The slab's rows
    i in [i0, i0 + IB) are the arrays' first IB rows (a row shard of
    dist/wavefront.py holds rows from its i0)."""
    n2, T, S, U = dims(n)
    TBp, IBp = pk16.shape[-3], pk16.shape[-2]
    rows = st["PKD"].shape[-2]           # n2, or a row shard's R (dist/wavefront.py)
    if i0:   # a = j - i: slab row r (i = i0 + r) reads column i0 + r + a
        pk16 = pad_axis(pk16[..., i0:], -1, 0, i0, SAT16)
    slab = unskew_right(pk16, SAT16, n2)                 # [B, TBp, i, a]
    slab = torch.nn.functional.pad(slab, (0, 0, 0, rows - IBp, 0, T - TBp),
                                   value=SAT16)
    dynamic_update_slice(st["PKD"], slab[:, :, None], (0, s, 0, 0))
    # rows tt > s write back their own value in the JAX scatter: skip them
    tt_idx = torch.arange(min(s, T - 1) + 1, device=pk16.device)
    st["PKE"][:, tt_idx, s - tt_idx] = slab[:, tt_idx]
    return st


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

    * ``plane(name, c, b, di)``: int16 [B, TB, IB, n2] slab
      name[tt+c, s-b, i+di, j], unset where the layout holds nothing;
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
    plane: Callable
    history: Callable
    window: Callable


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

    def plane(name, c, b, di):
        sl = dynamic_slice(st[name], (0, max(s - b, 0), 0, 0),
                           (T, 1, n2, n2))[:, :, 0]
        sl = pad_axis(sl, -3, 0, max(c + TB - T, 0), SAT16)
        sl = dynamic_slice(sl, (c, 0, 0), (TB, n2, n2))
        return pad_axis(sl, -2, 0, 1, SAT16)[..., di: di + IB, :]

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

    return SpanReads(plane, history, window)


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
    ``reads`` (its layout's :class:`SpanReads`): a dict of int16
    [B, TB, IB, n2] slabs, unset on invalid cells.  Writes nothing, so the
    caller's write-back into ``st`` follows every read of the span.

    The slabs' rows are i in [i0, i0 + IB).  TB >= s-1 covers tt; the
    whole state (i0 = 0) takes IB >= n-s+2, a row shard of
    dist/wavefront.py its rows with i <= n - s (caller guarantees; padded
    rows are never valid)."""
    n = C["n"]
    n2, T, S, U = dims(n)
    bp, cp, ap, PB = C["bp"], C["cp"], C["ap"], C["PB"]
    canp, pt, ESTP = C["can_pair"], C["ptype"], C["ESTP"]
    dev = st["PKD"].device

    tv = torch.arange(TB, device=dev)[:, None, None]      # tt
    iv = torch.arange(i0, i0 + IB, device=dev)[None, :, None]  # i
    jv = torch.arange(n2, device=dev)[None, None, :]      # j
    kv = jv + tv + 2
    lv = iv + s
    valid4 = cuda_ops.span_valid(n, s, i0, TB, IB, n2, dev)

    WBt, WPt, WBPg, WPPg = _wx_tables(C, st)

    # gather-free pair/energy planes (ttloop.py)
    ESTP_ij = plane_ij(ESTP, TB, IB, i0=i0)
    canp_ij = plane_ij(canp, TB, IB, i0=i0)
    pt_ij = plane_ij(pt, TB, IB, i0=i0)
    canp_kl = plane_kl(canp, s, TB, IB, n2, i0=i0)
    pt_kl = plane_kl(pt, s, TB, IB, n2, i0=i0)
    ESTP_klp = plane_kl(ESTP, s, TB, IB, n2, i0=i0)
    canp_il = diag_il(canp, s, TB, IB, n2, i0=i0)
    pt_il = diag_il(pt, s, TB, IB, n2, i0=i0)
    ESTP_il = diag_il(ESTP, s, TB, IB, n2, i0=i0)

    def enc(v, vmask):
        """Store-encode a plane: int16-clamped value on valid cells
        (matrices.hh:188-191), INF on invalid ones (matrices.hh:177-182)."""
        return torch.where(vmask, v.clamp(-32768, SAT16), INF)

    # ---- batched plane reads (all tt at once) -----------------------------
    def rplane(name, c, b, di, dj):
        """value[tt, i, j] = read4(name, n, tt+c, s-b, i+di, j+dj)."""
        sl = reads.plane(name, c, b, di)
        if dj == -1:
            sl = torch.nn.functional.pad(sl, (1, 0), value=SAT16)[..., :n2]
        elif dj == 1:
            sl = torch.nn.functional.pad(sl, (0, 1), value=SAT16)[..., 1:]
        i2, j2 = iv + di, jv + dj
        k2 = j2 + (tv + c) + 2
        l2 = i2 + (s - b)
        ok = ((i2 >= 1) & (i2 <= j2) & (k2 <= l2) & (l2 <= n)
              & (s - b >= 0))
        return torch.where(ok, sl.to(I32), INF)

    # ---- PL: interior stencil + assembly (batched over tt) ---------------
    pl_int = pl_stencil(reads, SC4, s, n, TB, IB, i0)
    pl_stack = torch.where(
        iv + TURN + 2 < jv,
        rplane("PL", 1, 1, 1, -1) + ESTP_ij,
        INF)
    PLiloop = torch.where(canp_ij > 0, torch.minimum(pl_stack, pl_int), INF)
    PLmloop_v = torch.minimum(
        rplane("PLmloop10", 1, 1, 1, -1),
        rplane("PLmloop01", 1, 1, 1, -1)) + ap + bp
    PL_b3 = torch.where(jv >= iv + TURN + 1,
                        rplane("PfromL", 1, 1, 1, -1), INF)
    PLv = torch.where(pt_ij > 0, mmin(PLiloop, PLmloop_v + bp, PL_b3), INF)
    PLs = enc(PLv, valid4)

    # ---- PR: interior stencil + assembly (batched, u-coordinates) --------
    pr_int = pr_stencil(reads, SC4, s, n, TB, IB, i0)
    pr_stack = torch.where(
        kv + TURN + 2 < lv,
        rplane("PR", 1, 1, 0, 0) + ESTP_klp,
        INF)
    PRiloop = torch.where(canp_kl > 0, torch.minimum(pr_stack, pr_int), INF)
    PRmloop_v = torch.minimum(
        rplane("PRmloop10", 1, 1, 0, 0),
        rplane("PRmloop01", 1, 1, 0, 0)) + ap + bp
    PR_b3 = torch.where(lv >= kv + TURN + 1,
                        rplane("PfromR", 1, 1, 0, 0), INF)
    PRv = torch.where(pt_kl > 0, mmin(PRiloop, PRmloop_v + bp, PR_b3), INF)
    PRs = enc(PRv, valid4)

    # ---- PO (generic interior branch is dead code; see gapped.py) --------
    po_stack = torch.where(
        (iv < jv) & (kv < lv),
        rplane("PO", 0, 2, 1, 0) + ESTP_il,
        INF)
    POiloop = torch.where(canp_il > 0, po_stack, INF)
    POmloop_v = torch.minimum(
        rplane("POmloop10", 0, 2, 1, 0),
        rplane("POmloop01", 0, 2, 1, 0)) + ap + bp
    PO_b3 = torch.where(lv >= iv + TURN + 1,
                        rplane("PfromO", 0, 2, 1, 0), INF)
    POv = torch.where(pt_il > 0, mmin(POiloop, POmloop_v + bp, PO_b3), INF)
    POs = enc(POv, valid4)

    # ---- remaining cross-span-only families + reduction bases ------------
    H = reads.history({"WBt": WBt, "WBPg": WBPg, "WPt": WPt})
    POm00 = mmin(SAT16 + bp, H["POm00_ri"], H["POm00_rl"])
    POm01 = H["POm01"]
    POm10 = torch.minimum(H["POm10_ri"], H["POm10_rl"])
    PRm01 = torch.minimum(rplane("PRmloop01", 0, 1, 0, 0) + cp, H["PRm01"])
    PfromO = mmin(H["PfromO_ri"], H["PfromO_rl"], PLs + PB, PRs + PB)

    bases = {
        "PLmloop00": H["PLmloop00"],
        "PLmloop10": H["PLmloop10"],
        "PRmloop00": H["PRmloop00"],
        "PMmloop01": H["PMmloop01"],
        "PMmloop10": torch.minimum(H["PMmloop10_ri"], H["PMmloop10_rl"]),
        "PfromL": H["PfromL"],
        "PfromR": H["PfromR"],
    }

    # ---- serial loop over tt (descending): one tt_span per span ----------
    mdp0 = torch.minimum(PLs, PRs) + PB       # PfromMdoubleprime base
    cur = run_tt_loop(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0,
                      valid4, s, TB, IB, i0)

    def pack(slab32):
        v = slab32[:, :TB].clamp(-32768, SAT16)
        return torch.where(valid4, v, SAT16).to(I16)

    packed = {name: pack(cur[name]) for name in LOOP_MATS}
    for name, v in (("PL", PLv), ("PR", PRv), ("PO", POv),
                    ("PRmloop01", PRm01), ("POmloop00", POm00),
                    ("POmloop01", POm01), ("POmloop10", POm10),
                    ("PfromO", PfromO)):
        packed[name] = pack(v)
    return packed


def span_gapped4(C, SC4, st, s, TB, IB):
    """All 22 gapped families for span s; updates the dense big state in
    place and returns it.

    TB, IB are bucket sizes with TB >= s-1 and IB >= n-s+2 (caller
    guarantees; padded rows are never valid and never written back).
    """
    n = C["n"]
    n2 = n + 2
    packed = span_families(C, SC4, st, s, TB, IB,
                           dense_reads(st, n, s, TB, IB))
    for name in M4_NAMES:
        sl = packed[name]
        if IB < n2:
            sl = pad_axis(sl, -2, 0, n2 - IB, SAT16)
        dynamic_update_slice(st[name], sl[:, :, None], (0, s, 0, 0))
    for name in C_MATS:
        # C layout: row l = i + s holds the (i, j) plane row i
        slp = pad_axis(packed[name], -2, n2, 0, SAT16)    # [TB, n2+IB, n2]
        cs = dynamic_slice(slp, (0, n2 - s, 0), (TB, n2, n2))
        dynamic_update_slice(st["C_" + name], cs[:, :, None], (0, s, 0, 0))
    return update_pk_skews4(st, packed["PK"], s, n)
