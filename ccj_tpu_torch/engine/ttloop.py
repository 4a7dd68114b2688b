"""The serial tt-descending loop of the dense span step (PyTorch).

Counterpart of ``ccj_tpu/engine/ttloop.py``: the gather-free table
builders and ``run_tt_loop_unstacked`` (ported here as :func:`run_tt_loop`;
the parked stacked experiment of the JAX module is not ported).  For each
span s the loop runs s-1 sequential steps, each updating the 14
same-span-dependent families from the previous tt rows.  Every step's 13
k-shrink / j-shrink min-plus reductions go through
:func:`cuda_ops.minplus_window`, the port's hand-written Hopper kernel.

Recurrences and tie-breaking order are unchanged (reference:
src/pseudo_loop.cc:181-679; per-branch citations in
``ccj_tpu/engine/gapped.py``).
"""

from __future__ import annotations

import torch

from . import cuda_ops
from .common import I32, INF, SAT16, dynamic_slice, mmin, pad_axis
from .gapped import DS, PADT
from .skew import skew_right, unskew_right


# ---------------------------------------------------------------------------
# Gather-free table reads: every index pattern the span phase uses is a
# diagonal or a per-row shift of a 2-D table, built from pad-reshape skews
# and slices.
# ---------------------------------------------------------------------------

def diag_cols(X32, fill, W):
    """Z[r, c] = X[r, r + c] for c in [0, W), out-of-range -> fill."""
    return unskew_right(X32, fill, W)


def wk_table(X, TB, UK, n2, fill=INF):
    """WKX[q, a] = X[a, a+q] masked to a, a+q in [0, n2) — the k-shrink
    weight table."""
    X32 = X.to(I32)
    Xp = torch.cat([X32, torch.full((UK - n2, n2), fill, dtype=I32,
                                    device=X.device)], dim=0)
    return diag_cols(Xp, fill, TB).T                 # [TB(q), UK(a)]


def wj_table(X, TB, n2, fill=INF):
    """WJX[q, j] = X[j-q, j] masked to j-q >= 0 — the j-shrink weight
    table."""
    X32 = X.to(I32)
    Xt_f = torch.flip(X32.T, dims=(1,))              # [j, c] = X[n2-1-c, j]
    Sk = skew_right(Xt_f, fill)                      # [j, u] = X[n2-1-u+j, j]
    return Sk[:, n2 - 1: n2 - 1 + TB].T


def jk_table(X, TB, n2, c0: int, row_shift: int, fill=INF):
    """T[tt, j] = X[j - row_shift, (j - row_shift) + tt + c0] — the per-tt
    diagonal rows of a pair table (CJK/PJK/EJK)."""
    X32 = X.to(I32)
    M = diag_cols(X32, fill, TB + c0)[:, c0: c0 + TB]      # [r, tt]
    if row_shift:
        M = torch.cat([torch.full((row_shift, TB), fill, dtype=I32,
                                  device=X.device), M], dim=0)[:n2]
    return M.T                                              # [tt, j]


def plane_ij(X, TB, IB, fill=INF):
    """out[tt, i, j] = X[i, j] broadcast over tt (a view)."""
    X32 = X.to(I32)
    return X32[None, :IB, :].expand(TB, IB, X.shape[1])


def plane_kl(X, s, TB, IB, n2, fill=INF):
    """out[tt, i, j] = X[j + tt + 2, i + s] masked to k, l in [0, n2)."""
    X32 = X.to(I32)
    dev = X.device
    Xp = torch.cat([X32, torch.full((n2, IB), fill, dtype=I32, device=dev)],
                   dim=1)
    Xs = dynamic_slice(Xp, (0, s), (n2, IB))              # [k, i], l = i+s
    Xs = torch.cat([Xs, torch.full((TB + 3, IB), fill, dtype=I32, device=dev)],
                   dim=0)
    Xt = Xs.T                                             # [i, k]
    y = Xt[:, None, 2:].expand(IB, TB, Xt.shape[1] - 2)
    A = unskew_right(y, fill, n2)                 # [i, tt, j] = Xt[i, j+tt+2]
    return A.movedim(0, 1)


def diag_il(X, s, TB, IB, n2, fill=INF):
    """out[tt, i, j] = X[i, i + s] masked to i+s < n2 (a broadcast view)."""
    Z = diag_cols(X.to(I32), fill, n2)            # [i, c] = X[i, i+c]
    d = dynamic_slice(Z, (0, s), (IB, 1))[:, 0]   # [IB]
    return d[None, :, None].expand(TB, IB, n2)


LOOP_MATS_ALL = ("PLmloop00", "PLmloop01", "PLmloop10", "PRmloop00",
                 "PRmloop10", "PMmloop00", "PMmloop01", "PMmloop10",
                 "PM", "PfromL", "PfromR", "PfromM", "PfromMprime", "PK")
# families that also keep a u-skewed (B) slab for the j-shrink reductions
B4_MATS_ALL = ("PK", "PLmloop00", "PLmloop10", "PMmloop00", "PfromL",
               "PfromMprime")


def _enc(v, vmask):
    """Store-encode a plane: int16-clamped value on valid cells, INF on
    invalid ones."""
    return torch.where(vmask, v.clamp(-32768, SAT16), INF)


def _pm_stencil(STM, DPM, s, tt, TB, IB, UB):
    """The PM interior-loop stencil over the same-span STM slab, in u
    coordinates: pm_acc[i, u] = min(INF, min over d1, d2 in [1, DS] of
    STM[tt + d1 + d2, i, u + d2] + DPM[d1, d2, tt, u]) under the
    d1 <= (u - tt) - i - 1 and d2 <= (i + s - u - 2) - 1 bounds.

    The JAX loop over d2 becomes one strided view X[d2, d1, i, u] of the
    column-padded slab: row tt + 2 + (d1 - 1) + (d2 - 1), column u + d2.
    """
    dev = STM.device
    slPM = dynamic_slice(STM, (tt + 2, 0, 0), (2 * DS, IB, UB))
    slPM = torch.nn.functional.pad(slPM, (0, DS), value=INF)   # cols u + d2
    W = UB + DS
    sR = IB * W
    X = slPM.as_strided((DS, DS, IB, UB), (sR + 1, sR, W, 1),
                        slPM.storage_offset() + 1)
    dpm = dynamic_slice(DPM, (0, 0, tt, 0), (DS, DS, 1, UB))[:, :, 0]
    d = torch.arange(1, DS + 1, device=dev)
    i = torch.arange(IB, device=dev)[:, None]
    u = torch.arange(UB, device=dev)[None, :]
    mask = ((d[None, :, None, None] <= (u - tt) - i - 1)
            & (d[:, None, None, None] <= (i + s - u - 2) - 1))
    vals = torch.where(mask, X + dpm.permute(1, 0, 2)[:, :, None, :], INF)
    return vals.amin(dim=(0, 1)).clamp(max=INF)


def run_tt_loop(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0,
                valid4, s, TB: int, IB: int):
    """Run the serial tt loop for span ``s``; returns the final families.

    ``bases``: the 7 span-constant cross-span reduction bases by name.
    ``mdp0``: the PfromMdoubleprime base min(PL,PR)+PB [TB, IB, n2].
    Returns {name: [TB, IB, n2] int32} for every LOOP_MATS family.  The
    span slabs it carries are updated in place, one tt row per step, after
    every read of the step.
    """
    n = C["n"]
    n2 = n + 2
    UB = n2 + TB
    UK = n2 + TB + 1
    bp, cp, ap, PB = C["bp"], C["cp"], C["ap"], C["PB"]
    canp, pt, ESTP = C["can_pair"], C["ptype"], C["ESTP"]
    dev = valid4.device
    minplus = cuda_ops.minplus_window

    # gather-free per-span weight / pair tables
    WKX = {nm: wk_table(X, TB, UK, n2)
           for nm, X in (("WP", WPt), ("WB", WBt), ("WBP", WBPg))}
    WJX = {nm: wj_table(X, TB, n2).contiguous()
           for nm, X in (("WP", WPt), ("WB", WBt), ("WBP", WBPg))}
    CJK = jk_table(canp, TB, n2, 2, 0)
    PJK = jk_table(pt, TB, n2, 2, 0)
    EJK = jk_table(ESTP, TB, n2, 4, 1)

    # A-layout / B-layout slabs carry TB pad rows beyond the live range so
    # the q-window [tt+1, tt+1+TB) never leaves them; pad rows hold INF and
    # can only lose (INF + weight <= 2e7 << int32 max, and every consumer
    # clamps through _enc() exactly as the reference's int16 store).
    validp = pad_axis(valid4, 0, 0, TB + 2, False)
    PLpad = pad_axis(PLs, 0, 0, 2, INF)
    PRpad = pad_axis(PRs, 0, 0, 2, INF)
    mdp = pad_axis(mdp0, 0, 0, TB + 2, INF)               # PfromMdoubleprime

    cur = {name: torch.where(validp, SAT16, INF).to(I32)
           for name in LOOP_MATS_ALL}
    for name in B4_MATS_ALL:
        cur["B_" + name] = torch.full((2 * TB + 2, IB, UB), INF, dtype=I32,
                                      device=dev)
    STM = torch.full((TB + 2 * PADT, IB, UB), INF, dtype=I32, device=dev)
    DPM = SC4["DPM"]

    jr = torch.arange(n2, device=dev)[None, :]
    ir = torch.arange(IB, device=dev)[:, None]
    b4_eye = (ir == jr)

    for tt in range(s - 2, -1, -1):
        wk = {nm: dynamic_slice(W, (0, tt + 2), (TB, n2))
              for nm, W in WKX.items()}

        def red_k(slab, w, k1):
            # d <= G - 1, i.e. q <= s - 4 - tt - (j - i)
            return minplus(slab, w, tt + 1, 0, 0, 1 if k1 else 0, s - 4 - tt)

        def red_j(slabB, w, j1):
            # d <= (j - i) - 1, i.e. q <= j - i - 2
            return minplus(slabB, w, tt + 1, tt, 0, 2 if j1 else 0, 2)

        def plane_cur(slab, c, dj):
            sl = slab[tt + c]
            if dj == -1:
                sl = torch.nn.functional.pad(sl, (1, 0), value=INF)[:, :n2]
            return sl

        def base_at(name):
            return bases[name][tt]

        out = {}
        out["PLmloop00"] = mmin(SAT16 + bp, base_at("PLmloop00"),
                                red_j(cur["B_PLmloop00"], WJX["WB"], False))
        out["PLmloop01"] = red_j(cur["B_PLmloop00"], WJX["WBP"], False)
        out["PLmloop10"] = torch.minimum(
            base_at("PLmloop10"), red_j(cur["B_PLmloop10"], WJX["WB"], True))
        out["PRmloop00"] = mmin(SAT16 + bp, base_at("PRmloop00"),
                                red_k(cur["PRmloop00"], wk["WB"], False))
        out["PRmloop10"] = torch.minimum(
            plane_cur(cur["PRmloop10"], 1, 0) + cp,
            red_k(cur["PRmloop00"], wk["WBP"], False))
        out["PMmloop00"] = mmin(
            SAT16 + bp,
            red_j(cur["B_PMmloop00"], WJX["WB"], False),
            red_k(cur["PMmloop00"], wk["WB"], False))
        out["PMmloop01"] = torch.minimum(
            plane_cur(cur["PMmloop01"], 1, 0) + cp, base_at("PMmloop01"))
        out["PMmloop10"] = torch.minimum(
            plane_cur(cur["PMmloop10"], 1, -1) + cp, base_at("PMmloop10"))

        # PM interior stencil over the same-span STM slab (u-coordinates)
        pm_acc = _pm_stencil(STM, DPM, s, tt, TB, IB, UB)
        pm_int = pm_acc[:, tt: tt + n2]

        canp_jk = CJK[tt: tt + 1]
        pt_jk = PJK[tt: tt + 1]
        estp_jk = EJK[tt: tt + 1]
        pm_stack = plane_cur(cur["PM"], 2, -1) + estp_jk
        PMiloop = torch.where(canp_jk > 0, torch.minimum(pm_stack, pm_int), INF)
        PMmloop_v = torch.minimum(plane_cur(cur["PMmloop10"], 2, -1),
                                  plane_cur(cur["PMmloop01"], 2, -1)) + ap + bp
        PM_b3 = plane_cur(cur["PfromM"], 2, -1)  # k >= j+TURN-1 always holds
        PM_b4 = torch.where(b4_eye & (ir + s == jr + tt + 2), 0, INF)
        PMv = torch.where(pt_jk > 0,
                          mmin(PMiloop, PMmloop_v + bp, PM_b3, PM_b4), INF)
        out["PM"] = PMv

        vmask = valid4[tt]
        PMs_t = _enc(PMv, vmask)
        PLs_t = PLpad[tt]
        PRs_t = PRpad[tt]
        POs_t = POs[tt]

        out["PfromL"] = mmin(
            base_at("PfromL"),
            red_j(cur["B_PfromL"], WJX["WP"], True),
            PRs_t + PB, PMs_t + PB, POs_t + PB)
        out["PfromR"] = mmin(
            base_at("PfromR"),
            red_k(cur["PfromR"], wk["WP"], True),
            PMs_t + PB, POs_t + PB)
        out["PfromM"] = red_j(cur["B_PfromMprime"], WJX["WP"], True)
        out["PfromMprime"] = red_k(mdp, wk["WP"], True)
        out["PK"] = mmin(
            red_j(cur["B_PK"], WJX["WP"], True),
            red_k(cur["PK"], wk["WP"], True),
            PLs_t + PB, PMs_t + PB, PRs_t + PB, POs_t + PB)

        # write-back of row tt (the B slabs store it at columns u = j + tt)
        for name in LOOP_MATS_ALL:
            encp = PMs_t if name == "PM" else _enc(out[name], vmask)
            cur[name][tt] = encp
            if name in B4_MATS_ALL:
                cur["B_" + name][tt, :, tt: tt + n2] = encp
        STM[tt, :, tt: tt + n2] = PMs_t

    return {nm: cur[nm][:TB] for nm in LOOP_MATS_ALL}
