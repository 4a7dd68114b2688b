"""Hand-written Hopper kernels of the partition function's span fill
(``pf4d.pf_span_step``), with their plain PyTorch twins.

The JAX package runs a span of its sum-product fill as one jitted XLA
program (``ccj_tpu/engine/pf4d.py:652-660``); it reaches no Pallas kernel,
but its serial tt loop (``:470-579``) computes, in the (+, x) semiring,
exactly the function of the repo's one TPU kernel ``_minplus_kernel``
(``ccj_tpu/engine/pallas_ops.py:38``): ``red_k`` / ``red_j`` are the suffix
sums ``out[i, j] = sum_{tp > tt} slab[tp, i, j] * w[tp, j]``.  Seven
kernels, one float32 and one float64 instantiation each, make the whole
span; in the order the span calls them:

* :func:`pf_p_split`, P2's span-s diagonal over the PKE / PKD skews;
* :func:`pf_span2d`, the 2-D recurrences (V, P2, WBP / WPP, the kept weight
  tables' span-s cells, WMv / WMp / WM), in place, a block a row;
* :func:`pf_history`, the 16 RL / RI weighted sums over the earlier spans;
* :func:`pf_stencil`, the PL, PR and PO interior-loop sums over
  d1, d2 in [1, DS];
* :func:`pf_assemble`, the 13 plane reads and the PL / PR / PO assembly,
  the cross-span-only families and the PMmloop10 base;
* :func:`pf_tt_span`, the span's whole tt loop (14 families, 6 k-shrink and
  7 j-shrink sums and the PM interior stencil a step), one launch a span;
* :func:`pf_store`, the write-back of the 22 families, 5 C skews, PKD and
  PKE, in place, after every read of the state.

``pf_tt_span``, ``pf_history``, ``pf_stencil`` and ``pf_p_split`` live in
``csrc/pfspan.cu``, the other three in ``csrc/pfbody.cu``.

The span kernels compute the span's valid cells only (tt <= s - 2, i >= 1,
j >= i, j + tt + 2 <= i + s, i + s <= n: ``cuda_ops.span_valid``); the four
of ``pfspan.cu`` leave every other cell of their zero-initialised output 0,
``pf_assemble`` writes 0 there and ``pf_store`` reads its slabs only there.
A span without a valid cell (s < 2 or s >= n; the P split: s < 3) launches
none of ``pf_tt_span``, ``pf_history``, ``pf_stencil``, ``pf_assemble`` and
returns zeros; ``pf_span2d`` and ``pf_store`` launch at every span.

Dispatch rule, as in ``cuda_ops``: a wrapper runs its plain version
(``*_ref``: the code ``pf4d`` ran inline before, moved here unchanged but
for the final mask) only for CPU tensors; for CUDA tensors it launches its
kernel or raises, and never falls back.  The kernels live in
``cuda_ops``' library (built from ``csrc/*.cu`` at first use).  Each
kernel's ``PF_*_LAUNCHES`` counter (:data:`PF_COUNTERS`) counts its
launches; nothing else moves them.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import cuda_ops
from .common import dynamic_slice, dynamic_update_slice
from .common import pad_axis as _pad
from ..params.io_par import MAXLOOP, TURN
from .gapped import C_MATS, DS, M4_NAMES, dims
from .gapped import PADT as PADT4
from .gapped4 import LOOP_MATS
from .skew import skew_right, unskew_right

ML = MAXLOOP

PF_TT_SPAN_LAUNCHES = 0   # pf_tt_span kernel launches (CUDA only)
PF_HISTORY_LAUNCHES = 0   # pf_history kernel launches (CUDA only)
PF_STENCIL_LAUNCHES = 0   # pf_stencil kernel launches (CUDA only)
PF_PSPLIT_LAUNCHES = 0    # pf_p_split kernel launches (CUDA only)
PF_SPAN2D_LAUNCHES = 0    # pf_span2d kernel launches (CUDA only)
PF_ASSEMBLE_LAUNCHES = 0  # pf_assemble kernel launches (CUDA only)
PF_STORE_LAUNCHES = 0     # pf_store kernel launches (CUDA only)

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

# The 2-D state the span's pf_span2d updates, and the scalars it reads in
# csrc/pfbody.cu's order.
PF_2D = ("V", "VD", "P2", "PD", "WBP", "WPP", "WM", "WMv", "WMp")
PF_SPAN2D_SCALARS = ("scale2", "expbp", "expPPS", "expPSM", "expPSP", "expb")

# The 13 fixed-offset plane reads of the assembly, (family, c, b, di, dj):
# value[tt, i, j] = st[family][tt + c, s - b, i + di, j + dj], 0 off the
# array or where s < b (csrc/pfbody.cu's read_offsets, in its order).
PF_PLANE_READS = (
    ("PL", 1, 1, 1, -1), ("PLmloop10", 1, 1, 1, -1), ("PLmloop01", 1, 1, 1, -1),
    ("PfromL", 1, 1, 1, -1),
    ("PR", 1, 1, 0, 0), ("PRmloop10", 1, 1, 0, 0), ("PRmloop01", 1, 1, 0, 0),
    ("PfromR", 1, 1, 0, 0),
    ("PO", 0, 2, 1, 0), ("POmloop10", 0, 2, 1, 0), ("POmloop01", 0, 2, 1, 0),
    ("PfromO", 0, 2, 1, 0),
    ("PRmloop01", 0, 1, 0, 0))
# pf_assemble's outputs in order: the seven families it computes (0 off the
# valid cells), then the tt loop's PMmloop10 base
PF_ASSEMBLED = ("PL", "PR", "PO", "POmloop00", "POmloop10", "PRmloop01", "PfromO")
# the tt loop's bases that are pf_history's sums as they are, by index
PF_HISTORY_BASES = {"PLmloop00": 8, "PLmloop10": 9, "PRmloop00": 10, "PMmloop01": 11,
                    "PfromL": 14, "PfromR": 15}
# the families the write-back takes from outside the tt loop: the
# assembly's seven and POmloop01, pf_history's sum (index 2)
PF_STORED = PF_ASSEMBLED + ("POmloop01",)

PF_KERNELS = ("pf_tt_span", "pf_history", "pf_stencil", "pf_p_split", "pf_span2d",
              "pf_assemble", "pf_store")
PF_COUNTERS = {"pf_tt_span": "PF_TT_SPAN_LAUNCHES", "pf_history": "PF_HISTORY_LAUNCHES",
               "pf_stencil": "PF_STENCIL_LAUNCHES", "pf_p_split": "PF_PSPLIT_LAUNCHES",
               "pf_span2d": "PF_SPAN2D_LAUNCHES", "pf_assemble": "PF_ASSEMBLE_LAUNCHES",
               "pf_store": "PF_STORE_LAUNCHES"}

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


def pf_span2d_ref(C, st, p_new, wx, n, s):
    """Plain version of :func:`pf_span2d`: V, P2, WBP / WPP for every
    (i, l = i + s), the kept tables' span-s cells, then WMv / WMp / WM
    (host pf.py's per-cell blocks, vectorized over i); updates ``st`` and
    ``wx`` in place."""
    n2, T, S, U = dims(n)
    dev = st["V"].device
    ii = torch.arange(n2, device=dev)
    ll = (ii + s).clamp(0, n2 - 1)
    row_ok = (ii >= 1) & (ii + s <= n)

    # ---- V(i, i+s) --------------------------------------------------------
    hair = dynamic_slice(C["HD"], (0, s), (n2, 1))[:, 0]
    dk = torch.arange(ML + 2, device=dev)[:, None, None]
    dl = torch.arange(ML + 2, device=dev)[None, :, None]
    eintd = dynamic_slice(C["EINTD"], (0, 0, 0, s), (ML + 2, ML + 2, n2, 1))[..., 0]
    # V[i+dk, i+s-dl] = VD[s-dk-dl, i+dk]
    spw = (s - dk - dl).clamp(0, S)
    iw = (ii[None, None, :] + dk).clamp(0, n2 - 1)
    vrd = st["VD"][spw, iw]
    okint = ((dk >= 1) & (dl >= 1)
             & (dk <= min(s - TURN - 1, ML))
             & (dl <= torch.minimum(s - TURN - 1 - dk, ML + 2 - dk))
             & (ii[None, None, :] + dk <= n2 - 1))
    interior = torch.where(okint, eintd * vrd, 0.0).sum(dim=(0, 1))

    cc = torch.arange(n2, device=dev)[:, None]           # c (multiloop split)
    iv2 = ii[None, :]
    okc = (cc >= iv2 + 1) & (cc <= iv2 + s - TURN - 1) & row_ok[None, :]
    ccl = cc.clamp(0, n2 - 1)
    jm1 = (iv2 + s - 1).clamp(0, n2 - 1)
    wm_l = st["WM"][(iv2 + 1).clamp(0, n2 - 1), (cc - 1).clamp(0, n2 - 1)]
    wmv_r = st["WMv"][ccl, jm1]
    wmp_r = st["WMp"][ccl, jm1]
    mlb = C["expMLbase"][(cc - iv2 - 1).clamp(0, n2 - 1)]
    vm = torch.where(okc, wm_l * (wmv_r + wmp_r) + mlb * wmp_r, 0.0).sum(dim=0)
    mb = C["expMB"][ii, ll]
    vnew = hair + interior + vm * mb * C["scale2"]
    st["V"][ii, ll] = torch.where(row_ok, vnew, st["V"][ii, ll])
    st["VD"][min(s, S)] = torch.where(row_ok, vnew, 0.0)

    # ---- P2(i, i+s): the P split's diagonal --------------------------------
    st["P2"][ii, ll] = torch.where(row_ok, p_new, st["P2"][ii, ll])
    st["PD"][min(s, S)] = torch.where(row_ok, p_new, 0.0)

    # ---- WBP / WPP (their weights from the kept tables) --------------------
    WB, WP = wx["WB"], wx["WP"]
    gg = torch.arange(n2, device=dev)[:, None]           # g = dd - i
    dd = iv2 + gg
    okd = (gg >= 0) & (gg <= s - 1) & row_ok[None, :]
    ddc = dd.clamp(0, n2 - 1)
    lv = (iv2 + s).clamp(0, n2 - 1)
    vdl = st["V"][ddc, lv]
    pdl = st["P2"][ddc, lv]
    ivc = iv2.clamp(0, n2 - 1)
    dm1 = (dd - 1).clamp(0, n2 - 1)
    wb_prev = torch.where(dd - 1 >= 0, WB[ivc, dm1], 0.0)
    wp_prev = torch.where(dd - 1 >= 0, WP[ivc, dm1], 0.0)
    lm1 = (ll - 1).clamp(0, n2 - 1)
    b1 = torch.where(okd, wb_prev * vdl, 0.0).sum(dim=0) \
        * C["expbp"] * C["expPPS"]
    b2 = torch.where(okd, wb_prev * pdl, 0.0).sum(dim=0) \
        * C["expPSM"] * C["expPPS"]
    b3 = torch.where(ii <= ll - 1, st["WBP"][ii, lm1], 0.0) * C["expcp"][1]
    c1 = torch.where(okd, wp_prev * vdl, 0.0).sum(dim=0) * C["expPPS"]
    c2 = torch.where(okd, wp_prev * pdl, 0.0).sum(dim=0) \
        * C["expPSP"] * C["expPPS"]
    c3 = torch.where(ii <= ll - 1, st["WPP"][ii, lm1], 0.0) * C["expPUP"][1]
    st["WBP"][ii, ll] = torch.where(row_ok, b1 + b2 + b3, st["WBP"][ii, ll])
    st["WPP"][ii, ll] = torch.where(row_ok, c1 + c2 + c3, st["WPP"][ii, ll])

    # ---- the kept tables' span-s cells (pf4d.pf_wx_tables' rule) -----------
    unit = min(s + 1, n2 - 1)
    for name, raw, u in (("WB", "WBP", C["expcp"][unit]), ("WP", "WPP", C["expPUP"][unit]),
                         ("WBPg", "WBP", None)):
        new = st[raw][ii, ll] if u is None else u + st[raw][ii, ll]
        wx[name][ii, ll] = torch.where(row_ok, new, wx[name][ii, ll])

    # ---- WMv / WMp / WM ----------------------------------------------------
    row_ok = row_ok & (s >= 3)
    stem = st["V"][ii, ll] * C["expML"][ii, ll]
    wmv = stem + st["WMv"][ii, jm1[0]] * C["expMLbase"][1]
    wmp = (st["P2"][ii, ll] * C["expPSM"] * C["expb"]
           + st["WMp"][ii, jm1[0]] * C["expMLbase"][1])
    kk = torch.arange(n2, device=dev)[:, None]
    okk = (kk >= iv2) & (kk <= iv2 + s - TURN - 1) & row_ok[None, :]
    kcl = kk.clamp(0, n2 - 1)
    qbt = (st["V"][kcl, lv] * C["expML"][kcl, lv]
           + st["P2"][kcl, lv] * C["expPSM"] * C["expb"])
    pre = C["expMLbase"][(kk - iv2).clamp(0, n2 - 1)] \
        + torch.where(kk - 1 >= iv2, st["WM"][ivc, (kk - 1).clamp(0, n2 - 1)], 0.0)
    tot = torch.where(okk, pre * qbt, 0.0).sum(dim=0) \
        + st["WM"][ii, jm1[0]] * C["expMLbase"][1]
    st["WMv"][ii, ll] = torch.where(row_ok, wmv, st["WMv"][ii, ll])
    st["WMp"][ii, ll] = torch.where(row_ok, wmp, st["WMp"][ii, ll])
    st["WM"][ii, ll] = torch.where(row_ok, tot, st["WM"][ii, ll])


def _assembled(out, hist):
    """(families, bases) of :func:`pf_assemble` from its output
    ``out`` [8, TB, IB, n2] and pf_history's ``hist`` (views only): the
    :data:`PF_STORED` slabs the write-back takes, and the tt loop's seven
    bases by name."""
    slabs = out.unbind(0)
    fams = dict(zip(PF_ASSEMBLED, slabs))
    fams["POmloop01"] = hist[2]
    bases = {k: hist[q] for k, q in PF_HISTORY_BASES.items()}
    bases["PMmloop10"] = slabs[len(PF_ASSEMBLED)]
    return fams, bases


def pf_assemble_ref(C, st, hist, stn, n, s, TB, IB):
    """Plain version of :func:`pf_assemble`: the plane reads, PL / PR / PO,
    the cross-span-only families and the PMmloop10 base, masked to the
    span's valid cells."""
    n2, T, S, U = dims(n)
    dev = hist.device
    dtype = hist.dtype

    def ar(m):
        return torch.arange(m, device=dev)

    tv = ar(TB)[:, None, None]
    iv = ar(IB)[None, :, None]
    jv = ar(n2)[None, None, :]
    kv = jv + tv + 2
    lv = iv + s
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)
    canp, pt = C["can_pair"], C["ptype"]

    def rplane_big_all(name, c, b, di, dj):
        """value[tt, i, j] = big[name][tt+c, s-b, i+di, j+dj] (0 outside):
        one zero pad of the span's plane, then a view."""
        if s - b < 0:
            return torch.zeros((TB, IB, n2), dtype=dtype, device=dev)
        lj = max(-dj, 0)
        sl = F.pad(st[name][:, s - b], (lj, max(dj, 0), 0, max(di + IB - n2, 0),
                                        0, max(c + TB - T, 0)))
        return sl[c: c + TB, di: di + IB, dj + lj: dj + lj + n2]

    (ri_POm00, rl_POm00, POm01, ri_POm10, rl_POm10, rl_PRm01, ri_PfromO, rl_PfromO,
     basePLm00, basePLm10, basePRm00, basePMm01, ri_PMm10, rl_PMm10, basePfromL,
     basePfromR) = hist
    pl_acc, pr_int, po_acc = stn

    # ---- PL ---------------------------------------------------------------
    estp, canp_, pt_ = g2s(iv, jv, C["expESTP"], canp, pt)
    pl_stack = rplane_big_all("PL", 1, 1, 1, -1) * estp
    PLiloop = torch.where(canp_ > 0, pl_stack + pl_acc, 0.0)
    PLml = (rplane_big_all("PLmloop10", 1, 1, 1, -1)
            + rplane_big_all("PLmloop01", 1, 1, 1, -1)) \
        * C["expap"] * C["expbp"] * C["expbp"]
    PL_b3 = torch.where(jv >= iv + TURN + 1,
                        rplane_big_all("PfromL", 1, 1, 1, -1), 0.0)
    PLv = torch.where(pt_ > 0, PLiloop + PLml + PL_b3, 0.0)
    PLs = torch.where(valid4, PLv, 0.0)

    # ---- PR -----------------------------------------------------------------
    estp, canp_, pt_ = g2s(kv, lv, C["expESTP"], canp, pt)
    pr_stack = rplane_big_all("PR", 1, 1, 0, 0) * estp
    PRiloop = torch.where(canp_ > 0, pr_stack + pr_int, 0.0)
    PRml = (rplane_big_all("PRmloop10", 1, 1, 0, 0)
            + rplane_big_all("PRmloop01", 1, 1, 0, 0)) \
        * C["expap"] * C["expbp"] * C["expbp"]
    PR_b3 = torch.where(lv >= kv + TURN + 1,
                        rplane_big_all("PfromR", 1, 1, 0, 0), 0.0)
    PRv = torch.where(pt_ > 0, PRiloop + PRml + PR_b3, 0.0)
    PRs = torch.where(valid4, PRv, 0.0)

    # ---- PO (with the interior scan the reference's MFE path dead-codes) --
    estp, canp_, pt_ = g2s(iv, lv, C["expESTP"], canp, pt)
    po_stack = rplane_big_all("PO", 0, 2, 1, 0) * estp
    POiloop = torch.where(canp_ > 0, po_stack + po_acc, 0.0)
    POml = (rplane_big_all("POmloop10", 0, 2, 1, 0)
            + rplane_big_all("POmloop01", 0, 2, 1, 0)) \
        * C["expap"] * C["expbp"] * C["expbp"]
    PO_b3 = torch.where(lv >= iv + TURN + 1,
                        rplane_big_all("PfromO", 0, 2, 1, 0), 0.0)
    POv = torch.where(pt_ > 0, POiloop + POml + PO_b3, 0.0)
    POs = torch.where(valid4, POv, 0.0)

    # ---- cross-span-only families + the PMmloop10 base ---------------------
    POm00 = POs * C["expbp"] + ri_POm00 + rl_POm00
    POm10 = ri_POm10 + rl_POm10
    PRm01 = rplane_big_all("PRmloop01", 0, 1, 0, 0) * C["expcp"][1] + rl_PRm01
    PfromO = ri_PfromO + rl_PfromO + (PLs + PRs) * C["expPB"]
    basePMm10 = ri_PMm10 + rl_PMm10
    out = torch.where(valid4, torch.stack([PLs, PRs, POs, POm00, POm10, PRm01, PfromO,
                                           basePMm10]), 0.0)
    return _assembled(out, hist)


def pf_store_ref(st, loops, fams, n, s, TB, IB):
    """Plain version of :func:`pf_store`: the span's write-back into
    ``st``, in place; every slab read on the span's valid cells only."""
    n2, T, S, U = dims(n)
    dev = loops.device
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)
    packed = {name: slab[:TB] for name, slab in zip(LOOP_MATS, loops)}
    packed.update(fams)
    packed = {name: torch.where(valid4, v, 0.0) for name, v in packed.items()}

    for name in M4_NAMES:
        sl = packed[name]
        if IB < n2:
            sl = F.pad(sl, (0, 0, 0, n2 - IB))                # rows i >= IB: 0
        dynamic_update_slice(st[name], sl[:, None], (0, s, 0, 0))
    for name in C_MATS:
        slp = F.pad(packed[name], (0, 0, n2, 0))
        cs = dynamic_slice(slp, (0, n2 - s, 0), (TB, n2, n2))
        dynamic_update_slice(st["C_" + name], cs[:, None], (0, s, 0, 0))

    # PK diagonal skews (0-filled): PKD[tt, s] and PKE[tt, s - tt] for
    # tt <= s (the JAX scatter writes rows tt > s back unchanged)
    slab = unskew_right(F.pad(packed["PK"], (0, 0, 0, n2 - IB)), 0.0, n2)
    slab = F.pad(slab, (0, 0, 0, 0, 0, T - TB))
    dynamic_update_slice(st["PKD"], slab[:, None], (0, s, 0, 0))
    tt_idx = torch.arange(min(s, T - 1) + 1, device=dev)
    st["PKE"][tt_idx, s - tt_idx] = slab[tt_idx]


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


class PfSpan2dTable(ctypes.Structure):
    """csrc/pfbody.cu ``struct PfSpan2dTable``: one :func:`pf_span2d`
    launch."""
    _fields_ = [*((nm, _P) for nm in PF_2D), ("wx", _P * 3),
                *((nm, _P) for nm in ("pnew", "hd", "eintd", "expmb", "expml", "expmlbase",
                                      "expcp", "exppup")),
                ("scalar", _P * len(PF_SPAN2D_SCALARS)),
                *((nm, ctypes.c_int) for nm in ("n", "s", "S", "f64"))]


class PfAssembleTable(ctypes.Structure):
    """csrc/pfbody.cu ``struct PfAssembleTable``: one :func:`pf_assemble`
    launch."""
    _fields_ = [("plane", _P * len(PF_PLANE_READS)),
                *((nm, _P) for nm in ("hist", "stn", "estp", "canp", "ptype", "expap",
                                      "expbp", "expcp", "exppb", "out")),
                *((nm, ctypes.c_int) for nm in ("n", "s", "TB", "IB", "T", "S", "f64"))]


class PfStoreTable(ctypes.Structure):
    """csrc/pfbody.cu ``struct PfStoreTable``: one :func:`pf_store`
    launch."""
    _fields_ = [("src", _P * len(M4_NAMES)), ("dst", _P * len(M4_NAMES)),
                ("cdst", _P * len(C_MATS)), ("csrc", ctypes.c_int * len(C_MATS)),
                ("pkd", _P), ("pke", _P),
                *((nm, ctypes.c_int) for nm in ("pk", "n", "s", "TB", "IB", "T", "S", "f64"))]


# (the library's table-size entry, its tables in order) of each source
_SOURCES = (("ccj_pf_table_bytes", (PfTtTable, PfHistTable, PfStencilTable, PfPSplitTable)),
            ("ccj_pfbody_table_bytes", (PfSpan2dTable, PfAssembleTable, PfStoreTable)))
_ENTRY = ("ccj_pf_tt_span", "ccj_pf_history", "ccj_pf_stencil", "ccj_pf_p_split",
          "ccj_pf_span2d", "ccj_pf_assemble", "ccj_pf_store")
_ready = False
_lock = threading.Lock()


def _pf_lib():
    """The kernel library with the seven PF entry points bound, their
    tables checked against csrc/pfspan.cu and csrc/pfbody.cu."""
    global _ready
    lib = cuda_ops._library()
    if not _ready:
        with _lock:
            if not _ready:
                for size_of, tables in _SOURCES:
                    for k, table in enumerate(tables):
                        got = getattr(lib, size_of)(k)
                        if got != ctypes.sizeof(table):
                            raise RuntimeError(
                                f"pf_ops.{table.__name__} ({ctypes.sizeof(table)} B) does "
                                f"not mirror its csrc struct ({got} B)")
                if lib.ccj_pf_ds() != DS:
                    raise RuntimeError("gapped.DS does not match csrc/pfspan.cu kDS")
                if (lib.ccj_pfbody_const(0), lib.ccj_pfbody_const(1)) != (ML, TURN):
                    raise RuntimeError("MAXLOOP / TURN do not match csrc/pfbody.cu")
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


def pf_span2d(C, st, p_new, wx, *, n, s):
    """The span's 2-D recurrences, in place: for every live row i
    (i >= 1, i + s <= n; every other row's cells keep their values)
    V(i, i + s) and VD[s, i], P2(i, i + s) and PD[s, i] from ``p_new``
    (:func:`pf_p_split`'s [n2] diagonal), WBP / WPP(i, i + s) and the kept
    tables ``wx`` ({"WB", "WP", "WBPg"}, [n2, n2] each) at (i, i + s), then
    for s >= 3 WMv / WMp / WM(i, i + s); VD[s] and PD[s] are 0 off the live
    rows.  ``C``: the fill's constants (``HD``, ``EINTD``, ``expMB``,
    ``expML``, ``expMLbase``, ``expcp``, ``expPUP`` and the scalars of
    :data:`PF_SPAN2D_SCALARS`).  One launch on CUDA at every span, the
    plain version for CPU tensors."""
    global PF_SPAN2D_LAUNCHES
    n2, T, S, U = dims(n)
    ops = {**{k: st[k] for k in PF_2D}, "p_new": p_new, **{k: wx[k] for k in PF_TABLES},
           **{k: C[k] for k in ("HD", "EINTD", "expMB", "expML", "expMLbase", "expcp",
                                "expPUP", *PF_SPAN2D_SCALARS)}}
    shapes = {**dict.fromkeys(ops, (n2, n2)), "VD": (S + 1, n2), "PD": (S + 1, n2),
              "p_new": (n2,), "EINTD": (ML + 2, ML + 2, n2, n2), "expMLbase": (n2,),
              "expcp": (n2,), "expPUP": (n2,), **dict.fromkeys(PF_SPAN2D_SCALARS, ())}
    dtype = st["V"].dtype
    if _check("pf_span2d", ops, shapes, dtype):
        return pf_span2d_ref(C, st, p_new, wx, n, s)
    _pf_lib()
    if not 0 <= s <= n - 1:
        raise ValueError(f"pf_span2d: span {s} outside [0, {n - 1}]")
    t = PfSpan2dTable(**{k: st[k].data_ptr() for k in PF_2D},
                      wx=(_P * 3)(*(wx[k].data_ptr() for k in PF_TABLES)),
                      pnew=p_new.data_ptr(), hd=C["HD"].data_ptr(),
                      eintd=C["EINTD"].data_ptr(), expmb=C["expMB"].data_ptr(),
                      expml=C["expML"].data_ptr(), expmlbase=C["expMLbase"].data_ptr(),
                      expcp=C["expcp"].data_ptr(), exppup=C["expPUP"].data_ptr(),
                      scalar=(_P * len(PF_SPAN2D_SCALARS))(
                          *(C[k].data_ptr() for k in PF_SPAN2D_SCALARS)),
                      n=n, s=s, S=S, f64=int(dtype == torch.float64))
    _launch("ccj_pf_span2d", t, st["V"].device)
    PF_SPAN2D_LAUNCHES += 1


def pf_assemble(C, st, hist, stn, *, n, s, TB, IB):
    """The span's assembly: from the 13 :data:`PF_PLANE_READS` of the state
    ``st`` (read in place), :func:`pf_history`'s 16 sums ``hist`` and
    :func:`pf_stencil`'s 3 ``stn`` ([16 | 3, TB, IB, n2]), the tables
    ``expESTP`` / ``can_pair`` / ``ptype`` at (i, j), (k, l) and (i, l) and
    the scalars of ``C``, the seven :data:`PF_ASSEMBLED` families and the
    PMmloop10 base, 0 off the span's valid cells.  Returns (families,
    bases): the :data:`PF_STORED` slabs :func:`pf_store` writes back
    (POmloop01 is ``hist[2]``) and the tt loop's seven bases by name
    (six of them ``hist``'s), each [TB, IB, n2].  One launch on CUDA
    (none for a span without a valid cell), the plain version for CPU
    tensors."""
    global PF_ASSEMBLE_LAUNCHES
    n2, T, S, U = dims(n)
    reads = list(dict.fromkeys(name for name, *_ in PF_PLANE_READS))
    ops = {**{k: st[k] for k in reads}, "hist": hist, "stn": stn,
           **{k: C[k] for k in ("expESTP", "can_pair", "ptype", "expap", "expbp", "expcp",
                                "expPB")}}
    shapes = {**dict.fromkeys(reads, (T, S, n2, n2)), "hist": (len(PF_HISTORY), TB, IB, n2),
              "stn": (len(PF_STENCILS), TB, IB, n2), "expESTP": (n2, n2),
              "can_pair": (n2, n2), "ptype": (n2, n2), "expap": (), "expbp": (),
              "expcp": (n2,), "expPB": ()}
    dtype = hist.dtype
    if _check("pf_assemble", ops, shapes, dtype):
        return pf_assemble_ref(C, st, hist, stn, n, s, TB, IB)
    if C["can_pair"].dtype != torch.bool or C["ptype"].dtype != torch.int32:
        raise TypeError("pf_assemble: can_pair must be bool and ptype int32")
    _pf_lib()
    dev = hist.device
    if not _has_cells(n, s, IB):
        return _assembled(torch.zeros((len(PF_ASSEMBLED) + 1, TB, IB, n2), dtype=dtype,
                                      device=dev), hist)
    out = torch.empty((len(PF_ASSEMBLED) + 1, TB, IB, n2), dtype=dtype, device=dev)
    t = PfAssembleTable(plane=(_P * len(PF_PLANE_READS))(
                            *(st[name].data_ptr() for name, *_ in PF_PLANE_READS)),
                        hist=hist.data_ptr(), stn=stn.data_ptr(),
                        estp=C["expESTP"].data_ptr(), canp=C["can_pair"].data_ptr(),
                        ptype=C["ptype"].data_ptr(), expap=C["expap"].data_ptr(),
                        expbp=C["expbp"].data_ptr(), expcp=C["expcp"].data_ptr(),
                        exppb=C["expPB"].data_ptr(), out=out.data_ptr(), n=n, s=s, TB=TB,
                        IB=IB, T=T, S=S, f64=int(dtype == torch.float64))
    _launch("ccj_pf_assemble", t, dev)
    PF_ASSEMBLE_LAUNCHES += 1
    return _assembled(out, hist)


def pf_store(st, loops, fams, *, n, s, TB, IB):
    """The span's write-back into the state ``st``, in place, every element
    the plain write-back writes (zeros included): each of the 22 families'
    plane ``[:TB, s]`` from its slab (the tt loop's ``loops``
    [14, TB + 2, IB, n2] rows [:TB], or ``fams[name]`` [TB, IB, n2] for the
    :data:`PF_STORED` ones), rows i >= IB 0; the 5 C skews' plane
    ``[:TB, s]``, C[tt, s, r, j] = slab[tt, r - s, j] for s <= r < s + IB,
    0 elsewhere; PKD's plane ``[:, s]``, the unskewed PK (0 past TB); PKE's
    planes ``[tt, s - tt]`` for tt <= min(s, T - 1), the same.  Every slab
    is read on the span's valid cells only.  Needs IB >= n2 - s (the C
    skews' rows past the slab are 0: ``gapped4.bucket_dims`` gives it).
    One launch on CUDA at every span, the plain version for CPU tensors."""
    global PF_STORE_LAUNCHES
    n2, T, S, U = dims(n)
    if set(fams) != set(PF_STORED):
        raise ValueError(f"pf_store: fams must hold {PF_STORED}, got {tuple(fams)}")
    if not (IB >= n2 - s and s - 1 <= TB <= T and IB <= n2):
        raise ValueError(f"pf_store: span {s} needs s - 1 <= TB <= {T} and "
                         f"{n2 - s} <= IB <= {n2}, got TB={TB}, IB={IB}")
    dests = [*M4_NAMES, *("C_" + k for k in C_MATS), "PKD", "PKE"]
    ops = {**{k: st[k] for k in dests}, "loops": loops,
           **{"slab " + k: v for k, v in fams.items()}}
    shapes = {**dict.fromkeys(dests, (T, S, n2, n2)), "PKE": (T, S + T + 2, n2, n2),
              "loops": (len(LOOP_MATS), TB + 2, IB, n2),
              **{"slab " + k: (TB, IB, n2) for k in fams}}
    dtype = loops.dtype
    if _check("pf_store", ops, shapes, dtype):
        return pf_store_ref(st, loops, fams, n, s, TB, IB)
    _pf_lib()
    fam = loops.stride(0) * loops.element_size()
    src = [fams[k].data_ptr() if k in fams else loops.data_ptr() + LOOP_MATS.index(k) * fam
           for k in M4_NAMES]
    t = PfStoreTable(src=(_P * len(M4_NAMES))(*src),
                     dst=(_P * len(M4_NAMES))(*(st[k].data_ptr() for k in M4_NAMES)),
                     cdst=(_P * len(C_MATS))(*(st["C_" + k].data_ptr() for k in C_MATS)),
                     csrc=(ctypes.c_int * len(C_MATS))(*(M4_NAMES.index(k) for k in C_MATS)),
                     pkd=st["PKD"].data_ptr(), pke=st["PKE"].data_ptr(),
                     pk=M4_NAMES.index("PK"), n=n, s=s, TB=TB, IB=IB, T=T, S=S,
                     f64=int(dtype == torch.float64))
    _launch("ccj_pf_store", t, loops.device)
    PF_STORE_LAUNCHES += 1
