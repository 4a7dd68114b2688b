"""Gapped-region DP: span-bucketed step with a batched cross-span phase
(PyTorch).

Counterpart of ``ccj_tpu/engine/gapped4.py`` (the dense engine's span step;
that module's docstring explains the design).  Per span s:

* bucketed shapes — static (TB, IB) with TB >= s-1 covering the tt axis and
  IB >= n-s+2 covering the i axis;
* batched cross-span phase — every family with no same-span reads (PL, PR,
  PO, PRmloop01, POmloop00/01/10, PfromO) and every cross-span reduction
  base (the l-shrink / i-shrink history scans) for ALL tt of the span at
  once; the PL/PR interior-loop stencils read the big PL/PR arrays through
  diagonal re-skews (engine/skew.py);
* the serial tt loop (engine/ttloop.py) for the self-referential families,
  on INF-encoded int32 span slabs.

Energy-model quirks (mloop00 read-before-write, dead PO interior branch,
int16 store saturation) are reproduced exactly.  :func:`span_gapped4`
updates the big state IN PLACE: every read of the span's inputs happens
before the write-back at its end, as in the JAX data flow.
"""

from __future__ import annotations

import torch

from .common import (I16, I32, INF, MAXLOOP, SAT16, TURN, dynamic_slice,
                     dynamic_update_slice, mmin, pad_axis)
from .gapped import C_MATS, DS, M4_NAMES, _wx_tables, dims
from .skew import skew_right, unskew_right
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


def init_big_state4(n, device):
    """Big state beyond the 22 families: C-skews + PK diagonals."""
    n2, T, S, U = dims(n)
    st = {}
    for m in C_MATS:
        st["C_" + m] = torch.full((T, S, n2, n2), SAT16, dtype=I16, device=device)
    st["PKD"] = torch.full((T, S, n2, n2), SAT16, dtype=I16, device=device)
    st["PKE"] = torch.full((T, S + T + 2, n2, n2), SAT16, dtype=I16, device=device)
    return st


def update_pk_skews4(st, pk16, s, n):
    """Refresh PKD / PKE from span s's packed PK slab [TB, IB, n2] int16,
    in place: PKD[tt, s, i, a] = PK[tt, s, i, i+a] and
    PKE[tt, s - tt, i, a] = PKD[tt, s, i, a] for tt <= s."""
    n2, T, S, U = dims(n)
    TBp, IBp = pk16.shape[0], pk16.shape[1]
    slab = unskew_right(pk16, SAT16, n2)                 # [TBp, i, a]
    slab = torch.nn.functional.pad(slab, (0, 0, 0, n2 - IBp, 0, T - TBp),
                                   value=SAT16)
    dynamic_update_slice(st["PKD"], slab[:, None], (0, s, 0, 0))
    # rows tt > s write back their own value in the JAX scatter: skip them
    tt_idx = torch.arange(min(s, T - 1) + 1, device=pk16.device)
    st["PKE"][tt_idx, s - tt_idx] = slab[tt_idx]
    return st


def span_gapped4(C, SC4, st, s, TB, IB):
    """All 22 gapped families for span s; updates the big state in place
    and returns it.

    TB, IB are bucket sizes with TB >= s-1 and IB >= n-s+2 (caller
    guarantees; padded rows are never valid and never written back).
    """
    n = C["n"]
    n2, T, S, U = dims(n)
    UB = n2 + TB
    bp, cp, ap, PB = C["bp"], C["cp"], C["ap"], C["PB"]
    canp, pt, ESTP = C["can_pair"], C["ptype"], C["ESTP"]
    dev = st["PK"].device

    tv = torch.arange(TB, device=dev)[:, None, None]      # tt
    iv = torch.arange(IB, device=dev)[None, :, None]      # i
    jv = torch.arange(n2, device=dev)[None, None, :]      # j
    kv = jv + tv + 2
    lv = iv + s
    Gv = lv - kv
    valid4 = (iv >= 1) & (jv >= iv) & (kv <= lv) & (lv <= n)

    WBt, WPt, WBPg, WPPg = _wx_tables(C, st)

    # gather-free pair/energy planes (ttloop.py)
    ESTP_ij = plane_ij(ESTP, TB, IB)
    canp_ij = plane_ij(canp, TB, IB)
    pt_ij = plane_ij(pt, TB, IB)
    canp_kl = plane_kl(canp, s, TB, IB, n2)
    pt_kl = plane_kl(pt, s, TB, IB, n2)
    ESTP_klp = plane_kl(ESTP, s, TB, IB, n2)
    canp_il = diag_il(canp, s, TB, IB, n2)
    pt_il = diag_il(pt, s, TB, IB, n2)
    ESTP_il = diag_il(ESTP, s, TB, IB, n2)

    def g2(X, a, b):
        ok = (a >= 0) & (a < n2) & (b >= 0) & (b < n2)
        return torch.where(ok, X[a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)], INF)

    def enc(v, vmask):
        """Store-encode a plane: int16-clamped value on valid cells
        (matrices.hh:188-191), INF on invalid ones (matrices.hh:177-182)."""
        return torch.where(vmask, v.clamp(-32768, SAT16), INF)

    # ---- batched plane reads from the big arrays (all tt at once) --------
    def rplane_big_all(name, c, b, di, dj):
        """value[tt, i, j] = read4(big[name], n, tt+c, s-b, i+di, j+dj)."""
        sl = dynamic_slice(st[name], (0, max(s - b, 0), 0, 0),
                           (T, 1, n2, n2))[:, 0]
        sl = pad_axis(sl, 0, 0, max(c + TB - T, 0), SAT16)
        sl = dynamic_slice(sl, (c, 0, 0), (TB, n2, n2))
        sl = pad_axis(sl, 1, 0, 1, SAT16)[:, di: di + IB, :]
        if dj == -1:
            sl = torch.nn.functional.pad(sl, (1, 0), value=SAT16)[:, :, :n2]
        elif dj == 1:
            sl = torch.nn.functional.pad(sl, (0, 1), value=SAT16)[:, :, 1:]
        i2, j2 = iv + di, jv + dj
        k2 = j2 + (tv + c) + 2
        l2 = i2 + (s - b)
        ok = ((i2 >= 1) & (i2 <= j2) & (k2 <= l2) & (l2 <= n)
              & (s - b >= 0))
        return torch.where(ok, sl.to(I32), INF)

    # ---- batched cross-span reductions (l-shrink / i-shrink histories) ---
    sp0 = max(s - TB, 0)
    spv = sp0 + torch.arange(TB, device=dev)            # window sp values
    d_rl = (s - spv)[None, :, None, None]               # d = s - sp
    i1 = torch.arange(IB, device=dev)

    def RL(name, X, g1):
        """min over d in [1, G-g1] of big[name][tt, s-d, i, j] + X(l-d+1, l)
        for all tt (pseudo_loop's l-shrink candidate scans)."""
        win = dynamic_slice(st[name], (0, sp0, 0, 0),
                            (TB, TB, n2, n2))[:, :, :IB, :].to(I32)
        wl = g2(X, i1[None, :] + spv[:, None] + 1,
                (i1[None, :] + s).expand(TB, IB))           # [sp, i]
        ok = (d_rl >= 1) & (d_rl <= (Gv - g1)[:, None])
        return torch.where(ok, win + wl[None, :, :, None], INF).amin(dim=1)

    def RI(name, X, g1):
        """min over d in [1, sj-g1] of C_[name][tt, s-d, l, j] + X(i, i+d-1)
        for all tt (i-shrink scans; l = i + s is the C-layout row)."""
        loff = min(s, n2 - IB)
        win = dynamic_slice(st["C_" + name], (0, sp0, loff, 0),
                            (TB, TB, IB, n2)).to(I32)
        l_val = loff + i1                                # actual l per row
        i_val = l_val - s                                # i = l - s
        wi = g2(X, i_val[None, :].expand(TB, IB),
                l_val[None, :] - spv[:, None] - 1)       # [sp, lr]
        sj_lr = jv[0] - i_val[:, None]                   # [IB(lr), n2]
        ok = ((d_rl >= 1) & (d_rl <= (sj_lr - g1)[None, None])
              & (i_val >= 1)[None, None, :, None])
        red = torch.where(ok, win + wi[None, :, :, None], INF).amin(dim=1)
        sh = s - loff                                    # row i at lr=i+sh
        return dynamic_slice(pad_axis(red, 1, 0, IB, INF), (0, sh, 0),
                             (TB, IB, n2))

    # ---- PL: interior stencil + assembly (batched over tt) ---------------
    # pl_int[tt,i,j] = min over d1,d2 of PL(tt+d2, s-d1, i+d1, j-d2)
    #                  + W4PL[d1, d2, i, j]          (pseudo_loop.cc:682-703)
    def span_window(name, rows):
        """[rows(tt'), DS, n2, n2] window with row r of axis1 = span s-DS+r;
        rows for spans < 0 (and spans beyond a short S axis) read as unset,
        alignment preserved for any s."""
        DSs = min(DS, S)
        rs = max(s - DSs, 0)
        raw = dynamic_slice(st[name], (0, rs, 0, 0), (T, DSs, n2, n2))
        padded = pad_axis(raw, 1, DS, 0, SAT16)
        # padded row p holds span rs + p - DS; window row q needs span
        # s - DS + q, i.e. p = q + (s - rs)
        win = dynamic_slice(padded, (0, s - rs, 0, 0), (T, DS, n2, n2))
        win = pad_axis(win, 0, 0, max(rows - T, 0), SAT16)
        return win[:rows]

    plw = span_window("PL", TB + DS)
    plw = torch.flip(plw, dims=(1,))                 # row d1-1 = span s-d1
    plw = pad_axis(plw, 2, 0, max(IB + DS - n2, 0) + DS, SAT16)
    # d1-diagonal over (span-row, i): V1[tt', d1-1, i, j] = plw[tt', d1-1,
    # i+d1, j]  (l = i + s is invariant across the d1 shift)
    V1 = torch.stack([plw[:, d1 - 1, d1: d1 + IB, :]
                      for d1 in range(1, DS + 1)], dim=1)  # [tt', d1, i, j]
    W4PL = SC4["W4PL"][:, :, :IB, :]                       # [d1, d2, i, j]
    pl_int = torch.full((TB, IB, n2), INF, dtype=I32, device=dev)
    for d2 in range(1, DS + 1):
        sub = V1[d2: d2 + TB]                              # rows tt + d2
        sub = torch.nn.functional.pad(sub, (d2, 0), value=SAT16)[..., :n2]
        vals = sub.to(I32) + W4PL[None, :, d2 - 1]
        pl_int = torch.minimum(pl_int, vals.amin(dim=1))

    pl_stack = torch.where(
        iv + TURN + 2 < jv,
        rplane_big_all("PL", 1, 1, 1, -1) + ESTP_ij,
        INF)
    PLiloop = torch.where(canp_ij > 0, torch.minimum(pl_stack, pl_int), INF)
    PLmloop_v = torch.minimum(
        rplane_big_all("PLmloop10", 1, 1, 1, -1),
        rplane_big_all("PLmloop01", 1, 1, 1, -1)) + ap + bp
    PL_b3 = torch.where(jv >= iv + TURN + 1,
                        rplane_big_all("PfromL", 1, 1, 1, -1), INF)
    PLv = torch.where(pt_ij > 0, mmin(PLiloop, PLmloop_v + bp, PL_b3), INF)
    PLs = enc(PLv, valid4)

    # ---- PR: interior stencil + assembly (batched, u-coordinates) --------
    # pr_int[tt,i,j] = min over d1,d2 of PR(tt+d1, s-d2, i, j)
    #                  + W4PR[d1, d2, k, l]          (pseudo_loop.cc:717-738)
    # k = j + tt + 2 = u + 2 is tt-free in u = j + tt coordinates; the
    # (tt+d1, u+d1) diagonal is walked with d1-shifted slices.
    prw = span_window("PR", TB + DS)[:, :, :IB, :]
    prw = torch.flip(prw, dims=(1,))                 # row d2-1 = span s-d2
    prm = prw.movedim(0, -2)                         # [d2, i, tt', j]
    pru = skew_right(prm, SAT16)                     # [d2, i, tt', u]
    wpr = dynamic_slice(SC4["W4PR"], (0, 0, 2, s), (DS, DS, UB, IB))
    wpr = wpr.permute(0, 1, 3, 2)                    # [d1, d2, i, u]
    pr_acc = torch.full((IB, TB, UB), INF, dtype=I32, device=dev)
    for d1 in range(1, DS + 1):
        sub = pru[:, :, d1: d1 + TB, d1: d1 + UB]    # [d2, i, tt, u]
        vals = sub.to(I32) + wpr[d1 - 1][:, :, None, :]
        pr_acc = torch.minimum(pr_acc, vals.amin(dim=0))
    pr_int = unskew_right(pr_acc, INF, n2).movedim(0, 1)   # [tt, i, j]

    pr_stack = torch.where(
        kv + TURN + 2 < lv,
        rplane_big_all("PR", 1, 1, 0, 0) + ESTP_klp,
        INF)
    PRiloop = torch.where(canp_kl > 0, torch.minimum(pr_stack, pr_int), INF)
    PRmloop_v = torch.minimum(
        rplane_big_all("PRmloop10", 1, 1, 0, 0),
        rplane_big_all("PRmloop01", 1, 1, 0, 0)) + ap + bp
    PR_b3 = torch.where(lv >= kv + TURN + 1,
                        rplane_big_all("PfromR", 1, 1, 0, 0), INF)
    PRv = torch.where(pt_kl > 0, mmin(PRiloop, PRmloop_v + bp, PR_b3), INF)
    PRs = enc(PRv, valid4)

    # ---- PO (generic interior branch is dead code; see gapped.py) --------
    po_stack = torch.where(
        (iv < jv) & (kv < lv),
        rplane_big_all("PO", 0, 2, 1, 0) + ESTP_il,
        INF)
    POiloop = torch.where(canp_il > 0, po_stack, INF)
    POmloop_v = torch.minimum(
        rplane_big_all("POmloop10", 0, 2, 1, 0),
        rplane_big_all("POmloop01", 0, 2, 1, 0)) + ap + bp
    PO_b3 = torch.where(lv >= iv + TURN + 1,
                        rplane_big_all("PfromO", 0, 2, 1, 0), INF)
    POv = torch.where(pt_il > 0, mmin(POiloop, POmloop_v + bp, PO_b3), INF)
    POs = enc(POv, valid4)

    # ---- remaining cross-span-only families + reduction bases ------------
    POm00 = mmin(SAT16 + bp, RI("POmloop00", WBt, 0), RL("POmloop00", WBt, 0))
    POm01 = RL("POmloop00", WBPg, 0)
    POm10 = torch.minimum(RI("POmloop00", WBPg, 0), RL("POmloop10", WBt, 1))
    PRm01 = torch.minimum(rplane_big_all("PRmloop01", 0, 1, 0, 0) + cp,
                          RL("PRmloop00", WBPg, 0))
    PfromO = mmin(RI("PfromO", WPt, 1), RL("PfromO", WPt, 1),
                  PLs + PB, PRs + PB)

    bases = {
        "PLmloop00": RI("PLmloop00", WBt, 0),
        "PLmloop10": RI("PLmloop00", WBPg, 0),
        "PRmloop00": RL("PRmloop00", WBt, 0),
        "PMmloop01": RL("PMmloop00", WBPg, 0),
        "PMmloop10": torch.minimum(RI("PMmloop00", WBPg, 0),
                                   RL("PMmloop10", WBt, 1)),
        "PfromL": RI("PfromL", WPt, 1),
        "PfromR": RL("PfromR", WPt, 1),
    }

    # ---- serial loop over tt (descending) ---------------------------------
    mdp0 = torch.minimum(PLs, PRs) + PB       # PfromMdoubleprime base
    cur = run_tt_loop(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0,
                      valid4, s, TB, IB)

    # ---- write-back (in place: every read of st above is done) -----------
    def pack(slab32):
        v = slab32[:TB].clamp(-32768, SAT16)
        return torch.where(valid4, v, SAT16).to(I16)

    packed = {name: pack(cur[name]) for name in LOOP_MATS}
    for name, v in (("PL", PLv), ("PR", PRv), ("PO", POv),
                    ("PRmloop01", PRm01), ("POmloop00", POm00),
                    ("POmloop01", POm01), ("POmloop10", POm10),
                    ("PfromO", PfromO)):
        packed[name] = pack(v)

    for name in M4_NAMES:
        sl = packed[name]
        if IB < n2:
            sl = pad_axis(sl, 1, 0, n2 - IB, SAT16)
        dynamic_update_slice(st[name], sl[:, None], (0, s, 0, 0))
    for name in C_MATS:
        # C layout: row l = i + s holds the (i, j) plane row i
        slp = pad_axis(packed[name], 1, n2, 0, SAT16)     # [TB, n2+IB, n2]
        cs = dynamic_slice(slp, (0, n2 - s, 0), (TB, n2, n2))
        dynamic_update_slice(st["C_" + name], cs[:, None], (0, s, 0, 0))
    return update_pk_skews4(st, packed["PK"], s, n)
