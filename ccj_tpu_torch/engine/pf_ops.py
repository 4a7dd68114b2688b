"""Hand-written Hopper kernels of the partition function's span fill
(``pf4d.pf_span_step``), with their plain PyTorch twins.

The JAX package runs a span of its sum-product fill as one jitted XLA
program (``ccj_tpu/engine/pf4d.py:652-660``); it reaches no Pallas kernel,
but its serial tt loop (``:470-579``) computes, in the (+, x) semiring,
exactly the function of the repo's one TPU kernel ``_minplus_kernel``
(``ccj_tpu/engine/pallas_ops.py:38``): ``red_k`` / ``red_j`` are the suffix
sums ``out[i, j] = sum_{tp > tt} slab[tp, i, j] * w[tp, j]``.  Four kernels
(``csrc/pfspan.cu``, one float32 and one float64 instantiation each) take
the heavy parts of the span:

* :func:`pf_tt_span`, the span's whole tt loop (14 families, 6 k-shrink and
  7 j-shrink sums and the PM interior stencil a step), one launch a span;
* :func:`pf_history`, the 16 RL / RI weighted sums over the earlier spans;
* :func:`pf_stencil`, the PL, PR and PO interior-loop sums over
  d1, d2 in [1, DS];
* :func:`pf_p_split`, P2's span-s diagonal over the PKE / PKD skews.

Each kernel computes the span's valid cells only (tt <= s - 2, i >= 1,
j >= i, j + tt + 2 <= i + s, i + s <= n: ``cuda_ops.span_valid``) and
leaves every other cell of its zero-initialised output 0; every use of
the outputs in ``pf4d`` is masked to those cells, so the fill is the same.
A span without a valid cell (s < 2 or s >= n; the P split: s < 3)
launches nothing and returns zeros.

Dispatch rule, as in ``cuda_ops``: a wrapper runs its plain version
(``*_ref``: the code ``pf4d`` ran inline before, moved here unchanged but
for the final mask) only for CPU tensors; for CUDA tensors it launches its
kernel or raises, and never falls back.  The kernels live in
``cuda_ops``' library (built from ``csrc/*.cu`` at first use).
``PF_TT_SPAN_LAUNCHES``, ``PF_HISTORY_LAUNCHES``, ``PF_STENCIL_LAUNCHES``
and ``PF_PSPLIT_LAUNCHES`` count their launches; nothing else moves them.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import cuda_ops
from .common import dynamic_slice
from .common import pad_axis as _pad
from .gapped import DS, dims
from .gapped import PADT as PADT4
from .gapped4 import LOOP_MATS
from .skew import skew_right, unskew_right

PF_TT_SPAN_LAUNCHES = 0   # pf_tt_span kernel launches (CUDA only)
PF_HISTORY_LAUNCHES = 0   # pf_history kernel launches (CUDA only)
PF_STENCIL_LAUNCHES = 0   # pf_stencil kernel launches (CUDA only)
PF_PSPLIT_LAUNCHES = 0    # pf_p_split kernel launches (CUDA only)

# the tt loop's families that keep a u-skewed (B) slab in the plain loop,
# and its 7 span-constant bases, in csrc/pfspan.cu's order
B4_MATS = cuda_ops.STEP_B_SLABS
PF_BASES = cuda_ops.STEP_BASES
PF_TABLES = ("WP", "WB", "WBPg")

# The span's 16 history sums, in the kernel's (and the output's) order:
# (mode, family, weight table, g1).  RL reads st[family][tt, sp, i, j]
# with the weight X[i + sp + 1, i + s]; RI reads the C-layout copy
# st["C_" + family][tt, sp, i + s, j] with X[i, i + s - sp - 1]; g1 adds
# the strict bound of the span difference d = s - sp.
PF_HISTORY = (
    ("RI", "POmloop00", "WB", 0),     # POm00
    ("RL", "POmloop00", "WB", 0),     # POm00
    ("RL", "POmloop00", "WBPg", 0),   # POm01
    ("RI", "POmloop00", "WBPg", 0),   # POm10
    ("RL", "POmloop10", "WB", 1),     # POm10
    ("RL", "PRmloop00", "WBPg", 0),   # PRm01
    ("RI", "PfromO", "WP", 1),        # PfromO
    ("RL", "PfromO", "WP", 1),        # PfromO
    ("RI", "PLmloop00", "WB", 0),     # base PLmloop00
    ("RI", "PLmloop00", "WBPg", 0),   # base PLmloop10
    ("RL", "PRmloop00", "WB", 0),     # base PRmloop00
    ("RL", "PMmloop00", "WBPg", 0),   # base PMmloop01
    ("RI", "PMmloop00", "WBPg", 0),   # base PMmloop10
    ("RL", "PMmloop10", "WB", 1),     # base PMmloop10
    ("RI", "PfromL", "WP", 1),        # base PfromL
    ("RL", "PfromR", "WP", 1),        # base PfromR
)
PF_STENCILS = ("PL", "PR", "PO")
PF_KERNELS = ("pf_tt_span", "pf_history", "pf_stencil", "pf_p_split")

_FLOATS = (torch.float32, torch.float64)


def pf_live_rows(n, s, IB):
    """The span's live rows [lo, hi]: i >= 1, i + s <= n, i < IB (empty
    where lo > hi)."""
    return 1, min(n - s, IB - 1)


def _has_cells(n, s, IB):
    """Whether span s has a valid cell: a live row and a tt step."""
    lo, hi = pf_live_rows(n, s, IB)
    return s >= 2 and hi >= lo


def g2s(a, b, *tables):
    """X[a, b] of each square [n2, n2] table X, 0 where (a, b) lies off it
    (one bounds mask for all of them)."""
    n2 = tables[0].shape[-1]
    ok = (a >= 0) & (a < n2) & (b >= 0) & (b < n2)
    ac, bc = a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)
    return [torch.where(ok, X[ac, bc], 0.0) for X in tables]


# ---------------------------------------------------------------------------
# plain versions (the span fill's code before the kernels, unchanged)
# ---------------------------------------------------------------------------

def _pm_stencil(STM, DPM, s, tt, IB, UB):
    """The PM interior-loop stencil over the same-span STM slab, in u
    coordinates: pm_acc[i, u] = sum over d1, d2 in [1, DS] of
    STM[tt + d1 + d2, i, u + d2] * DPM[d1, d2, tt, u] under the
    d1 <= (u - tt) - i - 1 and d2 <= (i + s - u - 2) - 1 bounds.

    The JAX loop over d2 becomes one strided view X[d2, d1, i, u] of the
    column-padded slab: row tt + 2 + (d1 - 1) + (d2 - 1), column u + d2
    (as ``cuda_ops.pm_stencil`` does for the MFE fill).
    """
    dev = STM.device
    slPM = dynamic_slice(STM, (tt + 2, 0, 0), (2 * DS, IB, UB))
    slPM = F.pad(slPM, (0, DS))                 # columns u + d2 past UB read 0
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
    return torch.where(mask, X * dpm.permute(1, 0, 2)[:, :, None, :],
                       0.0).sum(dim=(0, 1))


def pf_tt_span_ref(C, WB, WP, WBPg, PLs, PRs, POs, bases, n, s, TB, IB):
    """Plain version of :func:`pf_tt_span`: the serial tt-descending loop
    (the JAX ``fori_loop`` body ``t_body``).  Each step reads the rows above
    tt and writes row tt after its last read."""
    n2 = n + 2
    UB = n2 + TB
    dev = PLs.device
    dtype = PLs.dtype
    canp, pt = C["can_pair"], C["ptype"]
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)

    tp1 = torch.arange(TB, device=dev)[:, None, None]
    uu3 = torch.arange(UB, device=dev)[None, None, :]
    iv = torch.arange(IB, device=dev)[None, :, None]
    jv = torch.arange(n2, device=dev)[None, None, :]
    Mj1 = tp1 <= uu3 - iv - 1
    Mk1 = (tp1 + jv) - iv <= s - 3

    PLpad = _pad(PLs, 0, 0, 2, 0.0)
    PRpad = _pad(PRs, 0, 0, 2, 0.0)
    mdp = (PLs + PRs) * C["expPB"]

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cur = {name: z(TB + 2, IB, n2) for name in LOOP_MATS}
    for name in B4_MATS:
        cur["B_" + name] = z(TB + 2, IB, UB)
    STM = z(TB + 2 * PADT4, IB, UB)

    jr = jv[0]
    ir = iv[0]
    uu2 = torch.arange(UB, device=dev)[None, :]
    q2 = tp1[:, :, 0]
    kk2 = jr
    M_b4 = ir == jr

    for tt in range(s - 2, -1, -1):
        kk = kk2 + tt + 2
        wk = dict(zip(("WPk", "WBk", "WBPk"),
                      g2s(kk.expand(TB, n2), kk + (q2 - tt) - 1, WP, WB, WBPg)))
        wj = dict(zip(("WPj", "WBj", "WBPj"),
                      g2s(uu2 - q2 + 1, (uu2 - tt).expand(TB, UB), WP, WB, WBPg)))
        row_ok = tp1 > tt

        def red_k(slab, w, k1):
            mask = row_ok & Mk1 if k1 else row_ok
            return torch.where(mask, slab[:TB] * w[:, None, :], 0.0).sum(dim=0)

        def red_j(slabB, w, j1):
            mask = row_ok & Mj1 if j1 else row_ok
            r_u = torch.where(mask, slabB[:TB] * w[:, None, :], 0.0).sum(dim=0)
            return r_u[:, tt: tt + n2]

        def plane_cur(slab, c, dj):
            sl = slab[tt + c]
            if dj == -1:
                sl = F.pad(sl, (1, 0))[:, :n2]
            return sl

        def base_at(name):
            return bases[name][tt]

        # PM (before its mloops: the PF grammar uses the PX base cases)
        pm_int = _pm_stencil(STM, C["DPM"], s, tt, IB, UB)[:, tt: tt + n2]

        canp_jk, pt_jk = (x[0] for x in g2s(jr[None], jr[None] + tt + 2, canp, pt))
        estp_jk = g2s(jr[None] - 1, jr[None] + tt + 3, C["expESTP"])[0][0]
        pm_stack = plane_cur(cur["PM"], 2, -1) * estp_jk
        PMiloop = torch.where(canp_jk > 0, pm_stack + pm_int, 0.0)
        PMml = (plane_cur(cur["PMmloop10"], 2, -1)
                + plane_cur(cur["PMmloop01"], 2, -1)) \
            * C["expap"] * C["expbp"] * C["expbp"]
        PM_b3 = plane_cur(cur["PfromM"], 2, -1)
        PM_b4 = torch.where(M_b4 & (ir + s == jr + tt + 2), 1.0, 0.0)
        PMv = torch.where(pt_jk > 0, PMiloop + PMml + PM_b3 + PM_b4, 0.0)

        vmask = valid4[tt]
        PMs_t = torch.where(vmask, PMv, 0.0)
        PLs_t = PLpad[tt]
        PRs_t = PRpad[tt]
        POs_t = POs[tt]

        out = {"PM": PMv}
        out["PLmloop00"] = (PLs_t * C["expbp"] + base_at("PLmloop00")
                            + red_j(cur["B_PLmloop00"], wj["WBj"], False))
        out["PLmloop01"] = red_j(cur["B_PLmloop00"], wj["WBPj"], False)
        out["PLmloop10"] = base_at("PLmloop10") \
            + red_j(cur["B_PLmloop10"], wj["WBj"], True)
        out["PRmloop00"] = (PRs_t * C["expbp"] + base_at("PRmloop00")
                            + red_k(cur["PRmloop00"], wk["WBk"], False))
        out["PRmloop10"] = plane_cur(cur["PRmloop10"], 1, 0) * C["expcp"][1] \
            + red_k(cur["PRmloop00"], wk["WBPk"], False)
        out["PMmloop00"] = (PMs_t * C["expbp"]
                            + red_j(cur["B_PMmloop00"], wj["WBj"], False)
                            + red_k(cur["PMmloop00"], wk["WBk"], False))
        out["PMmloop01"] = plane_cur(cur["PMmloop01"], 1, 0) * C["expcp"][1] \
            + base_at("PMmloop01")
        out["PMmloop10"] = plane_cur(cur["PMmloop10"], 1, -1) * C["expcp"][1] \
            + base_at("PMmloop10")
        out["PfromL"] = (base_at("PfromL")
                         + red_j(cur["B_PfromL"], wj["WPj"], True)
                         + (PRs_t + PMs_t + POs_t) * C["expPB"])
        out["PfromR"] = (base_at("PfromR")
                         + red_k(cur["PfromR"], wk["WPk"], True)
                         + (PMs_t + POs_t) * C["expPB"])
        out["PfromM"] = red_j(cur["B_PfromMprime"], wj["WPj"], True)
        out["PfromMprime"] = red_k(mdp, wk["WPk"], True)
        out["PK"] = (red_j(cur["B_PK"], wj["WPj"], True)
                     + red_k(cur["PK"], wk["WPk"], True)
                     + (PLs_t + PMs_t + PRs_t + POs_t) * C["expPB"])

        # write-back of row tt (the B slabs hold it at columns u = j + tt;
        # their row tt is still all 0 outside that window)
        for name in LOOP_MATS:
            encp = torch.where(vmask, out[name], 0.0)
            cur[name][tt] = encp
            if name in B4_MATS:
                cur["B_" + name][tt, :, tt: tt + n2] = encp
        STM[tt, :, tt: tt + n2] = PMs_t
    return torch.stack([cur[name] for name in LOOP_MATS])


def pf_history_ref(st, WB, WP, WBPg, n, s, TB, IB):
    """Plain version of :func:`pf_history`: the 16 sums of
    :data:`PF_HISTORY`, [16, TB, IB, n2], masked to the span's valid
    cells."""
    n2, T, S, U = dims(n)
    dev = WB.device
    tables = {"WB": WB, "WP": WP, "WBPg": WBPg}
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)

    def ar(m):
        return torch.arange(m, device=dev)

    tv = ar(TB)[:, None, None]
    iv = ar(IB)[None, :, None]
    jv = ar(n2)[None, None, :]
    Gv = (iv + s) - (jv + tv + 2)
    sp0 = max(s - TB, 0)
    spv = sp0 + ar(TB)
    d_rl = (s - spv)[None, :, None, None]
    i1 = ar(IB)

    def RL(name, X, g1):
        win = dynamic_slice(st[name], (0, sp0, 0, 0), (TB, TB, n2, n2))[:, :, :IB, :]
        wl, = g2s(i1[None, :] + spv[:, None] + 1, (i1[None, :] + s).expand(TB, IB), X)
        ok = d_rl >= 1
        if g1:
            ok = ok & (d_rl <= (Gv - 1)[:, None])
        return torch.where(ok, win * wl[None, :, :, None], 0.0).sum(dim=1)

    def RI(name, X, g1):
        loff = min(s, n2 - IB)
        win = dynamic_slice(st["C_" + name], (0, sp0, loff, 0), (TB, TB, IB, n2))
        l_val = loff + i1
        i_val = l_val - s
        wi, = g2s(i_val[None, :].expand(TB, IB), l_val[None, :] - spv[:, None] - 1, X)
        ok = (d_rl >= 1) & (i_val >= 1)[None, None, :, None]
        if g1:
            sj_lr = jv[0] - i_val[:, None]
            ok = ok & (d_rl <= (sj_lr - 1)[None, None])
        red = torch.where(ok, win * wi[None, :, :, None], 0.0).sum(dim=1)
        return dynamic_slice(_pad(red, 1, 0, IB, 0.0), (0, s - loff, 0),
                             (TB, IB, n2))

    out = [(RL if mode == "RL" else RI)(name, tables[tab], g1)
           for mode, name, tab, g1 in PF_HISTORY]
    return torch.where(valid4, torch.stack(out), 0.0)


def pf_stencil_ref(st, W4PL, W4PR, W4POD, n, s, TB, IB):
    """Plain version of :func:`pf_stencil`: the PL, PR and PO interior-loop
    sums, [3, TB, IB, n2], masked to the span's valid cells."""
    n2, T, S, U = dims(n)
    UB = n2 + TB
    dev = W4PL.device
    dtype = W4PL.dtype
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)
    tv = torch.arange(TB, device=dev)[:, None, None]
    iv = torch.arange(IB, device=dev)[None, :, None]
    jv = torch.arange(n2, device=dev)[None, None, :]
    Gv = (iv + s) - (jv + tv + 2)
    sjv = jv - iv

    def span_window(name, rows, back):
        """[rows, DS, n2, n2]; row r of axis1 = span s - back - DS + r.
        Negative spans read 0; if back > s the whole window is garbage, but
        every lane that could use it is masked (d-range bounds)."""
        DSs = min(DS, S)
        rs = max(s - back - DSs, 0)
        raw = dynamic_slice(st[name], (0, rs, 0, 0), (T, DSs, n2, n2))
        padded = _pad(raw, 1, DS, 0, 0.0)
        win = dynamic_slice(padded, (0, min(max(s - back - rs, 0), DSs), 0, 0),
                            (T, DS, n2, n2))
        win = _pad(win, 0, 0, max(rows - T, 0), 0.0)
        return win[:rows]

    # ---- PL ----
    plw = span_window("PL", TB + DS, 0)
    plw = torch.flip(plw, dims=(1,))
    plw = _pad(plw, 2, 0, max(IB + DS - n2, 0) + DS, 0.0)
    V1 = torch.stack([plw[:, d1 - 1, d1: d1 + IB, :]
                      for d1 in range(1, DS + 1)], dim=1)
    W4PLi = W4PL[:, :, :IB, :]
    pl_acc = torch.zeros((TB, IB, n2), dtype=dtype, device=dev)
    for d2 in range(1, DS + 1):
        sub = dynamic_slice(V1, (d2, 0, 0, 0), (TB, DS, IB, n2))
        sub = F.pad(sub, (d2, 0))[..., :n2]
        pl_acc = pl_acc + (sub * W4PLi[None, :, d2 - 1]).sum(dim=1)

    # ---- PR (u = j + tt coordinates) ----
    prw = span_window("PR", TB + DS, 0)[:, :, :IB, :]
    prw = torch.flip(prw, dims=(1,))
    prm = prw.movedim(0, -2)
    pru = skew_right(prm, 0.0)
    wpr = dynamic_slice(W4PR, (0, 0, 2, s), (DS, DS, UB, IB))
    wpr = wpr.permute(0, 1, 3, 2)
    pr_acc = torch.zeros((IB, TB, UB), dtype=dtype, device=dev)
    for d1 in range(1, DS + 1):
        sub = pru[:, :, d1: d1 + TB, d1: d1 + UB]
        pr_acc = pr_acc + (sub * wpr[d1 - 1][:, :, None, :]).sum(dim=0)
    pr_int = unskew_right(pr_acc, 0.0, n2).movedim(0, 1)

    # ---- PO (the interior scan the reference's MFE path dead-codes) ----
    po_acc = torch.zeros((TB, IB, n2), dtype=dtype, device=dev)
    d2v3 = torch.arange(1, DS + 1, device=dev)[None, :, None, None]
    for d1 in range(1, DS + 1):
        wnd = span_window("PO", TB, d1)            # row d2-1 = span s-d1-d2
        wnd = torch.flip(wnd, dims=(1,))
        wnd = _pad(wnd, 2, 0, max(IB + DS - n2, 0) + DS, 0.0)
        wnd = wnd[:, :, d1: d1 + IB, :]            # i + d1
        w = dynamic_slice(W4POD, (d1 - 1, 0, 0, s), (1, DS, IB, 1))[0, :, :, 0]
        okO = (d1 <= sjv - 1)[:, None] & (d2v3 <= (Gv - 1)[:, None])
        po_acc = po_acc + torch.where(okO, wnd * w[None, :, :, None], 0.0).sum(dim=1)
    return torch.where(valid4, torch.stack([pl_acc, pr_int, po_acc]), 0.0)


def pf_p_split_ref(PKE, PKD, n, s):
    """Plain version of :func:`pf_p_split`: P2(i, i + s) for every row i
    (0 where i is not live), [n2]."""
    n2, T, S, U = dims(n)
    dev = PKE.device
    bb = torch.arange(T, device=dev)[:, None, None]
    ccp = torch.arange(T, device=dev)[None, :, None]
    ivp = torch.arange(n2, device=dev)[None, None, :]
    p_new = torch.zeros(n2, dtype=PKE.dtype, device=dev)
    zpad = torch.zeros((T, n2, n2), dtype=PKE.dtype, device=dev)
    for a in range(max(s - 1, 0)):           # lanes a <= s - 2
        F1 = dynamic_slice(PKE, (0, a + 2, 0, a), (T, T, n2, 1))[..., 0]
        sl2 = dynamic_slice(PKD, (0, min(max(s - a - 1, 0), S - 1), 0, 0),
                            (T, 1, n2, n2))[:, 0]
        sl2 = torch.cat([sl2, zpad], dim=1)
        F2 = dynamic_slice(sl2, (0, a + 1, 0), (T, n2, T)).permute(2, 0, 1)
        ok = (bb + ccp + 2 <= s - 1 - a) & (ivp >= 1) & (ivp + s <= n)
        p_new = p_new + torch.where(ok, F1 * F2, 0.0).sum(dim=(0, 1))
    return p_new


# ---------------------------------------------------------------------------
# the kernels' launch tables (csrc/pfspan.cu's structs, field for field)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class PfTtTable(ctypes.Structure):
    """csrc/pfspan.cu ``struct PfTtTable``: one :func:`pf_tt_span` launch."""
    _fields_ = [("wx", _P * 3), ("pls", _P), ("prs", _P), ("pos", _P),
                ("base", _P * len(PF_BASES)), ("dpm", _P), ("canp", _P),
                ("ptype", _P), ("estp", _P), ("expbp", _P), ("expap", _P),
                ("expcp", _P), ("exppb", _P), ("out", _P),
                *((nm, ctypes.c_int) for nm in (
                    "n", "s", "TB", "IB", "T", "lo", "nlive", "f64"))]


class PfHistTable(ctypes.Structure):
    """csrc/pfspan.cu ``struct PfHistTable``: one :func:`pf_history` launch."""
    _fields_ = [("src", _P * len(PF_HISTORY)), ("wx", _P * 3), ("out", _P),
                ("mode", ctypes.c_int * len(PF_HISTORY)),
                ("g1", ctypes.c_int * len(PF_HISTORY)),
                ("table", ctypes.c_int * len(PF_HISTORY)),
                *((nm, ctypes.c_int) for nm in (
                    "n", "s", "TB", "IB", "T", "S", "lo", "nlive", "f64"))]


class PfStencilTable(ctypes.Structure):
    """csrc/pfspan.cu ``struct PfStencilTable``: one :func:`pf_stencil`
    launch."""
    _fields_ = [("src", _P * 3), ("w", _P * 3), ("out", _P),
                *((nm, ctypes.c_int) for nm in (
                    "n", "s", "TB", "IB", "T", "S", "lo", "nlive", "f64"))]


class PfPSplitTable(ctypes.Structure):
    """csrc/pfspan.cu ``struct PfPSplitTable``: one :func:`pf_p_split`
    launch."""
    _fields_ = [("pke", _P), ("pkd", _P), ("out", _P),
                *((nm, ctypes.c_int) for nm in (
                    "n", "s", "T", "S", "lo", "nlive", "f64"))]


_TABLES = (PfTtTable, PfHistTable, PfStencilTable, PfPSplitTable)
_ENTRY = ("ccj_pf_tt_span", "ccj_pf_history", "ccj_pf_stencil", "ccj_pf_p_split")
_ready = False
_lock = threading.Lock()


def _pf_lib():
    """The kernel library with the four PF entry points bound, their
    tables checked against csrc/pfspan.cu."""
    global _ready
    lib = cuda_ops._library()
    if not _ready:
        with _lock:
            if not _ready:
                for k, table in enumerate(_TABLES):
                    got = lib.ccj_pf_table_bytes(k)
                    if got != ctypes.sizeof(table):
                        raise RuntimeError(
                            f"pf_ops.{table.__name__} ({ctypes.sizeof(table)} B) does "
                            f"not mirror csrc/pfspan.cu ({got} B)")
                if lib.ccj_pf_ds() != DS:
                    raise RuntimeError("gapped.DS does not match csrc/pfspan.cu kDS")
                for name in _ENTRY:
                    fn = getattr(lib, name)
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                _ready = True
    return lib


def _check(what, tensors, shapes, dtype):
    """Raise unless every tensor has its shape and ``dtype`` (one of the two
    float types), and all lie on the CPU or all on one CUDA device whole and
    contiguous; returns whether they lie on the CPU."""
    if dtype not in _FLOATS:
        raise TypeError(f"{what}: float32 or float64 operands, got {dtype}")
    for name, x in tensors.items():
        want = shapes[name]
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, want {tuple(want)}")
        if name not in ("can_pair", "ptype") and x.dtype != dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}, want {dtype}")
    xs = list(tensors.values())
    if all(x.device.type == "cpu" for x in xs):
        return True
    cuda_ops._check_devices(xs)
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on CUDA")
    return False


def _launch(entry, table, dev):
    cuda_ops._launch(getattr(_pf_lib(), entry), dev, entry, ctypes.addressof(table),
                     torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def pf_tt_span(C, WB, WP, WBPg, PLs, PRs, POs, bases, *, n, s, TB, IB):
    """The span's tt loop: the 14 :data:`~gapped4.LOOP_MATS` slabs
    [14, TB + 2, IB, n2] (in that order), every tt step from s - 2 down to
    0.  ``WB`` / ``WP`` / ``WBPg``: the [n2, n2] weight tables
    (``pf4d._wx_pf``); ``PLs`` / ``PRs`` / ``POs``: [TB, IB, n2], 0 off the
    span's valid cells; ``bases``: the 7 :data:`PF_BASES` by name, each
    [TB, IB, n2], 0 off the valid cells; ``C``: the fill's constants
    (``DPM``, ``can_pair``, ``ptype``, ``expESTP``, ``expbp``, ``expap``,
    ``expcp``, ``expPB``).  One launch on CUDA (none for a span without a
    valid cell), the plain version for CPU tensors."""
    global PF_TT_SPAN_LAUNCHES
    n2, T, S, U = dims(n)
    ops = {"WB": WB, "WP": WP, "WBPg": WBPg, "PLs": PLs, "PRs": PRs, "POs": POs,
           **{"base_" + k: bases[k] for k in PF_BASES},
           "DPM": C["DPM"], "can_pair": C["can_pair"], "ptype": C["ptype"],
           "expESTP": C["expESTP"], "expbp": C["expbp"], "expap": C["expap"],
           "expcp": C["expcp"], "expPB": C["expPB"]}
    slab = (TB, IB, n2)
    shapes = {"WB": (n2, n2), "WP": (n2, n2), "WBPg": (n2, n2), "PLs": slab,
              "PRs": slab, "POs": slab, **{"base_" + k: slab for k in PF_BASES},
              "DPM": (DS, DS, T, U), "can_pair": (n2, n2), "ptype": (n2, n2),
              "expESTP": (n2, n2), "expbp": (), "expap": (), "expcp": (n2,),
              "expPB": ()}
    dtype = PLs.dtype
    if _check("pf_tt_span", ops, shapes, dtype):
        return pf_tt_span_ref(C, WB, WP, WBPg, PLs, PRs, POs, bases, n, s, TB, IB)
    if C["can_pair"].dtype != torch.bool or C["ptype"].dtype != torch.int32:
        raise TypeError("pf_tt_span: can_pair must be bool and ptype int32")
    _pf_lib()
    dev = PLs.device
    out = torch.zeros((len(LOOP_MATS), TB + 2, IB, n2), dtype=dtype, device=dev)
    if not _has_cells(n, s, IB):
        return out
    lo, hi = pf_live_rows(n, s, IB)
    t = PfTtTable(wx=(_P * 3)(WP.data_ptr(), WB.data_ptr(), WBPg.data_ptr()),
                  pls=PLs.data_ptr(), prs=PRs.data_ptr(), pos=POs.data_ptr(),
                  base=(_P * len(PF_BASES))(*(bases[k].data_ptr() for k in PF_BASES)),
                  dpm=C["DPM"].data_ptr(), canp=C["can_pair"].data_ptr(),
                  ptype=C["ptype"].data_ptr(), estp=C["expESTP"].data_ptr(),
                  expbp=C["expbp"].data_ptr(), expap=C["expap"].data_ptr(),
                  expcp=C["expcp"].data_ptr(), exppb=C["expPB"].data_ptr(),
                  out=out.data_ptr(), n=n, s=s, TB=TB, IB=IB, T=T, lo=lo,
                  nlive=hi - lo + 1, f64=int(dtype == torch.float64))
    _launch("ccj_pf_tt_span", t, dev)
    PF_TT_SPAN_LAUNCHES += 1
    return out


def pf_history(st, WB, WP, WBPg, *, n, s, TB, IB):
    """The span's 16 RL / RI weighted sums of :data:`PF_HISTORY`,
    [16, TB, IB, n2], computed on the span's valid cells (0 elsewhere),
    each window read in place from the state ``st`` (its families
    [T, S, n2, n2] and their C-layout copies) with its weights taken from
    the [n2, n2] tables in the kernel.  One launch on CUDA (none for a span
    without a valid cell), the plain version for CPU tensors."""
    global PF_HISTORY_LAUNCHES
    n2, T, S, U = dims(n)
    srcs = {}
    for mode, name, _, _ in PF_HISTORY:
        key = name if mode == "RL" else "C_" + name
        srcs[key] = st[key]
    ops = {"WB": WB, "WP": WP, "WBPg": WBPg, **srcs}
    shapes = {"WB": (n2, n2), "WP": (n2, n2), "WBPg": (n2, n2),
              **{k: (T, S, n2, n2) for k in srcs}}
    dtype = WB.dtype
    if _check("pf_history", ops, shapes, dtype):
        return pf_history_ref(st, WB, WP, WBPg, n, s, TB, IB)
    _pf_lib()
    dev = WB.device
    out = torch.zeros((len(PF_HISTORY), TB, IB, n2), dtype=dtype, device=dev)
    if not _has_cells(n, s, IB):
        return out
    lo, hi = pf_live_rows(n, s, IB)
    K = len(PF_HISTORY)
    t = PfHistTable(
        src=(_P * K)(*(st[name if mode == "RL" else "C_" + name].data_ptr()
                       for mode, name, _, _ in PF_HISTORY)),
        wx=(_P * 3)(WP.data_ptr(), WB.data_ptr(), WBPg.data_ptr()), out=out.data_ptr(),
        mode=(ctypes.c_int * K)(*(int(m == "RI") for m, _, _, _ in PF_HISTORY)),
        g1=(ctypes.c_int * K)(*(g for _, _, _, g in PF_HISTORY)),
        table=(ctypes.c_int * K)(*(PF_TABLES.index(tab) for _, _, tab, _ in PF_HISTORY)),
        n=n, s=s, TB=TB, IB=IB, T=T, S=S, lo=lo, nlive=hi - lo + 1,
        f64=int(dtype == torch.float64))
    _launch("ccj_pf_history", t, dev)
    PF_HISTORY_LAUNCHES += 1
    return out


def pf_stencil(st, W4PL, W4PR, W4POD, *, n, s, TB, IB):
    """The span's PL, PR and PO interior-loop sums, [3, TB, IB, n2] in
    :data:`PF_STENCILS` order, on the span's valid cells (0 elsewhere):

      PL[tt, i, j] = sum PL[tt + d2, s - d1, i + d1, j - d2] * W4PL[d1, d2, i, j]
      PR[tt, i, j] = sum PR[tt + d1, s - d2, i, j] * W4PR[d1, d2, j + tt + 2, s + i]
      PO[tt, i, j] = sum PO[tt, s - d1 - d2, i + d1, j] * W4POD[d1, d2, i, s]

    over d1, d2 in [1, DS] (PO: d1 <= j - i - 1, d2 <= i + s - j - tt - 3),
    cells off the state reading 0; the state's PL / PR / PO and the weights
    read in place.  One launch on CUDA (none for a span without a valid
    cell), the plain version for CPU tensors."""
    global PF_STENCIL_LAUNCHES
    n2, T, S, U = dims(n)
    ops = {"PL": st["PL"], "PR": st["PR"], "PO": st["PO"], "W4PL": W4PL,
           "W4PR": W4PR, "W4POD": W4POD}
    shapes = {"PL": (T, S, n2, n2), "PR": (T, S, n2, n2), "PO": (T, S, n2, n2),
              "W4PL": (DS, DS, n2, n2), "W4PR": (DS, DS, n2 + T + 2, 2 * n2),
              "W4POD": (DS, DS, n2, n2)}
    dtype = W4PL.dtype
    if _check("pf_stencil", ops, shapes, dtype):
        return pf_stencil_ref(st, W4PL, W4PR, W4POD, n, s, TB, IB)
    _pf_lib()
    dev = W4PL.device
    out = torch.zeros((len(PF_STENCILS), TB, IB, n2), dtype=dtype, device=dev)
    if not _has_cells(n, s, IB):
        return out
    lo, hi = pf_live_rows(n, s, IB)
    t = PfStencilTable(src=(_P * 3)(*(st[k].data_ptr() for k in PF_STENCILS)),
                       w=(_P * 3)(W4PL.data_ptr(), W4PR.data_ptr(), W4POD.data_ptr()),
                       out=out.data_ptr(), n=n, s=s, TB=TB, IB=IB, T=T, S=S, lo=lo,
                       nlive=hi - lo + 1, f64=int(dtype == torch.float64))
    _launch("ccj_pf_stencil", t, dev)
    PF_STENCIL_LAUNCHES += 1
    return out


def pf_p_split(PKE, PKD, *, n, s):
    """P2(i, i + s) for every row i, [n2] (0 where i is not live):

      sum over a >= 0, b, c >= 0 with a + b + c <= s - 3 of
      PKE[b, a + c + 2, i, a] * PKD[c, s - a - 1, i + a + 1, b]

    with PKE [T, S + T + 2, n2, n2] and PKD [T, S, n2, n2] read in place.
    One launch on CUDA (none for s < 3 or a span without a live row), the
    plain version for CPU tensors."""
    global PF_PSPLIT_LAUNCHES
    n2, T, S, U = dims(n)
    dtype = PKE.dtype
    if _check("pf_p_split", {"PKE": PKE, "PKD": PKD},
              {"PKE": (T, S + T + 2, n2, n2), "PKD": (T, S, n2, n2)}, dtype):
        return pf_p_split_ref(PKE, PKD, n, s)
    _pf_lib()
    dev = PKE.device
    out = torch.zeros(n2, dtype=dtype, device=dev)
    lo, hi = pf_live_rows(n, s, n2)
    if s < 3 or hi < lo:
        return out
    t = PfPSplitTable(pke=PKE.data_ptr(), pkd=PKD.data_ptr(), out=out.data_ptr(),
                      n=n, s=s, T=T, S=S, lo=lo, nlive=hi - lo + 1,
                      f64=int(dtype == torch.float64))
    _launch("ccj_pf_p_split", t, dev)
    PF_PSPLIT_LAUNCHES += 1
    return out
