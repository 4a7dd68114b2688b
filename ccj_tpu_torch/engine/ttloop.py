"""The serial tt-descending loop of the dense span step (PyTorch).

Counterpart of ``ccj_tpu/engine/ttloop.py``: the gather-free table
builders and ``run_tt_loop_unstacked`` (ported here as :func:`run_tt_loop`;
the parked stacked experiment of the JAX module is not ported).  For each
span s the loop runs s-1 sequential steps, each updating the 14
same-span-dependent families from the previous tt rows, in two launches
of the port's hand-written Hopper kernels: the step's 13 k-shrink /
j-shrink min-plus reductions as one :func:`cuda_ops.minplus_group`, then
the rest of the step (the assembly, the PM interior stencil and the
write-back of row tt) as one :func:`cuda_ops.tt_step`, each from a table
built once per span (:func:`reduction_table`, :class:`cuda_ops.StepTable`).

Recurrences and tie-breaking order are unchanged (reference:
src/pseudo_loop.cc:181-679; per-branch citations in
``ccj_tpu/engine/gapped.py``).  The span's slabs and tables carry a leading
batch axis, and one launch per step reduces the windows of every element
of the batch; the table builders take any leading axes.
"""

from __future__ import annotations

import torch

from . import cuda_ops
from .common import I32, INF, SAT16, dynamic_slice, pad_axis
from .gapped import DS, PADT
from .skew import skew_right, unskew_right


# ---------------------------------------------------------------------------
# Gather-free table reads: every index pattern the span phase uses is a
# diagonal or a per-row shift of a 2-D table (the last two axes; leading
# batch axes pass through), built from pad-reshape skews and slices.
# ---------------------------------------------------------------------------

def diag_cols(X32, fill, W):
    """Z[r, c] = X[r, r + c] for c in [0, W), out-of-range -> fill."""
    return unskew_right(X32, fill, W)


def wk_table(X, TB, UK, n2, fill=INF):
    """WKX[q, a] = X[a, a+q] masked to a, a+q in [0, n2) — the k-shrink
    weight table."""
    Xp = pad_axis(X.to(I32), -2, 0, UK - n2, fill)
    return diag_cols(Xp, fill, TB).transpose(-1, -2)  # [TB(q), UK(a)]


def wj_table(X, TB, n2, fill=INF):
    """WJX[q, j] = X[j-q, j] masked to j-q >= 0 — the j-shrink weight
    table."""
    X32 = X.to(I32)
    Xt_f = torch.flip(X32.transpose(-1, -2), dims=(-1,))  # [j, c] = X[n2-1-c, j]
    Sk = skew_right(Xt_f, fill)                      # [j, u] = X[n2-1-u+j, j]
    return Sk[..., n2 - 1: n2 - 1 + TB].transpose(-1, -2)


def jk_table(X, TB, n2, c0: int, row_shift: int, fill=INF):
    """T[tt, j] = X[j - row_shift, (j - row_shift) + tt + c0] — the per-tt
    diagonal rows of a pair table (CJK/PJK/EJK)."""
    X32 = X.to(I32)
    M = diag_cols(X32, fill, TB + c0)[..., c0: c0 + TB]    # [r, tt]
    if row_shift:
        M = pad_axis(M, -2, row_shift, 0, fill)[..., :n2, :]
    return M.transpose(-1, -2)                              # [tt, j]


def plane_ij(X, TB, IB, fill=INF, i0=0):
    """out[tt, i, j] = X[i0 + i, j] broadcast over tt (a view)."""
    X32 = X.to(I32)
    return X32[..., None, i0:i0 + IB, :].expand(*X.shape[:-2], TB, IB, X.shape[-1])


def plane_kl(X, s, TB, IB, n2, fill=INF, i0=0):
    """out[tt, i, j] = X[j + tt + 2, i0 + i + s] masked to k, l in [0, n2)."""
    Xp = pad_axis(X.to(I32), -1, 0, IB, fill)
    Xs = dynamic_slice(Xp, (0, s + i0), (n2, IB))         # [k, i], l = i+s
    Xs = pad_axis(Xs, -2, 0, TB + 3, fill)
    Xt = Xs.transpose(-1, -2)                             # [i, k]
    y = Xt[..., :, None, 2:].expand(*Xt.shape[:-1], TB, Xt.shape[-1] - 2)
    A = unskew_right(y, fill, n2)                 # [i, tt, j] = Xt[i, j+tt+2]
    return A.movedim(-3, -2)


def diag_il(X, s, TB, IB, n2, fill=INF, i0=0):
    """out[tt, i, j] = X[i0 + i, i0 + i + s] masked to i+s < n2 (a
    broadcast view)."""
    Z = diag_cols(X.to(I32), fill, n2)            # [i, c] = X[i, i+c]
    d = dynamic_slice(Z, (i0, s), (IB, 1))[..., 0]  # [IB]
    return d[..., None, :, None].expand(*d.shape[:-1], TB, IB, n2)


LOOP_MATS_ALL = cuda_ops.STEP_FAMILIES
# families that also keep a u-skewed (B) slab for the j-shrink reductions
B4_MATS_ALL = cuda_ops.STEP_B_SLABS


# The step's 13 k-shrink / j-shrink reductions, in the order the step reads
# them: (slab, weight table, kind, masked).  Kind "k" is red_k: rows
# tt+1.. of an A slab, weights WKX[:, tt+2: tt+2+n2], mask mode 1
# (d <= G - 1, i.e. q <= s - 4 - tt - (j - i)).  Kind "j" is red_j: rows
# tt+1.. and columns tt.. of a u-skewed B slab, weights WJX, mask mode 2
# (d <= (j - i) - 1, i.e. q <= j - i - 2).
REDUCTIONS = (
    ("B_PLmloop00", "WB", "j", False),       # PLmloop00
    ("B_PLmloop00", "WBP", "j", False),      # PLmloop01
    ("B_PLmloop10", "WB", "j", True),        # PLmloop10
    ("PRmloop00", "WB", "k", False),         # PRmloop00
    ("PRmloop00", "WBP", "k", False),        # PRmloop10
    ("B_PMmloop00", "WB", "j", False),       # PMmloop00
    ("PMmloop00", "WB", "k", False),         # PMmloop00
    ("B_PfromL", "WP", "j", True),           # PfromL
    ("PfromR", "WP", "k", True),             # PfromR
    ("B_PfromMprime", "WP", "j", True),      # PfromM
    ("mdp", "WP", "k", True),                # PfromMprime
    ("B_PK", "WP", "j", True),               # PK
    ("PK", "WP", "k", True),                 # PK
)


def reduction_table(slabs, WKX, WJX, s, n2, i0=0):
    """The descriptor table of one span's :data:`REDUCTIONS`, valid for
    every tt in [0, s - 2]; ``slabs`` maps the slab names to the span's
    A / B slabs (and ``mdp``), ``WKX`` / ``WJX`` the weight names to their
    tables, all with or all without a leading batch axis.  Slab row r is
    i = i0 + r: both masks read i - c, so the row offset moves into c."""
    wins = []
    for slab, wn, kind, masked in REDUCTIONS:
        if kind == "k":
            wins.append(cuda_ops.WindowSpec(
                slabs[slab], WKX[wn], row0=(1, 1), wcol=(2, 1),
                mode=1 if masked else 0, c=(s - 4 + i0, -1)))
        else:
            wins.append(cuda_ops.WindowSpec(
                slabs[slab], WJX[wn], row0=(1, 1), col0=(0, 1),
                mode=2 if masked else 0, c=(2 + i0, 0)))
    return cuda_ops.WindowTable(wins, n2, (0, s - 2))


def run_tt_loop(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0,
                valid4, s, TB: int, IB: int, i0: int = 0):
    """Run the serial tt loop for span ``s`` over rows i in
    [i0, i0 + IB); returns the final families.

    ``bases``: the 7 span-constant cross-span reduction bases by name.
    ``mdp0``: the PfromMdoubleprime base min(PL,PR)+PB [B, TB, IB, n2].
    Returns {name: [B, TB, IB, n2] int32} for every LOOP_MATS family.  The
    span slabs it carries are updated in place, one tt row per step, after
    every read of the step.  ``valid4`` ([TB, IB, n2]) is shared by the
    batch; every other operand has the leading batch axis.  Each step is
    two launches: :func:`cuda_ops.minplus_group` (the 13 reductions) and
    :func:`cuda_ops.tt_step` (the rest), from tables built once here.
    """
    n = C["n"]
    n2 = n + 2
    UB = n2 + TB
    UK = n2 + TB + 1
    canp, pt, ESTP = C["can_pair"], C["ptype"], C["ESTP"]
    dev = valid4.device
    B = PLs.shape[0]

    # gather-free per-span weight / pair tables
    WKX = {nm: wk_table(X, TB, UK, n2).contiguous()
           for nm, X in (("WP", WPt), ("WB", WBt), ("WBP", WBPg))}
    WJX = {nm: wj_table(X, TB, n2).contiguous()
           for nm, X in (("WP", WPt), ("WB", WBt), ("WBP", WBPg))}
    CJK = jk_table(canp, TB, n2, 2, 0)
    PJK = jk_table(pt, TB, n2, 2, 0)
    EJK = jk_table(ESTP, TB, n2, 4, 1)

    # A-layout / B-layout slabs carry TB pad rows beyond the live range so
    # the q-window [tt+1, tt+1+TB) never leaves them; pad rows hold INF and
    # can only lose (INF + weight <= 2e7 << int32 max, and every consumer
    # clamps through the step's store encoding exactly as the reference's
    # int16 store).  The step reads PL/PR/PO at row tt <= s - 2 < TB only.
    validp = pad_axis(valid4, 0, 0, TB + 2, False)
    mdp = pad_axis(mdp0, -3, 0, TB + 2, INF)              # PfromMdoubleprime

    init = torch.where(validp, SAT16, INF).to(I32)
    cur = {name: init.repeat(B, 1, 1, 1) for name in LOOP_MATS_ALL}
    for name in B4_MATS_ALL:
        cur["B_" + name] = torch.full((B, 2 * TB + 2, IB, UB), INF, dtype=I32,
                                      device=dev)
    # the same-span PM slab, with the DS INF columns its stencil reads past
    # u = UB - 1 (rows tt + 2 .. tt + 2 * DS stay inside TB + 2 * PADT)
    STM = torch.full((B, TB + 2 * PADT, IB, UB + DS), INF, dtype=I32, device=dev)

    if s >= 2:
        table = reduction_table({**cur, "mdp": mdp}, WKX, WJX, s, n2, i0)
        red_out = torch.empty(table.shape, dtype=I32, device=dev)
        step = cuda_ops.StepTable(red_out, bases, cur, STM, SC4["DPM"],
                                  (CJK, PJK, EJK), valid4, PLs, PRs, POs, s=s,
                                  i0=i0, bp=C["bp"], cp=C["cp"], ap=C["ap"],
                                  PB=C["PB"])

    # Each step's reductions land in red_out, which the same step's tt_step
    # reads; the next step's minplus_group overwrites it only after, in
    # stream order.  tt_step reads rows > tt of the slabs and writes row tt.
    for tt in range(s - 2, -1, -1):
        cuda_ops.minplus_group(table, tt, red_out)
        cuda_ops.tt_step(step, tt)

    return {nm: cur[nm][:, :TB] for nm in LOOP_MATS_ALL}
