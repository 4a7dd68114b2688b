"""The serial tt-descending loop of the dense span step (PyTorch).

Counterpart of ``ccj_tpu/engine/ttloop.py``: the gather-free table
builders and ``run_tt_loop_unstacked`` (ported here as :func:`run_tt_loop`;
the parked stacked experiment of the JAX module is not ported).  For each
span s the loop runs s-1 sequential steps, each updating the 14
same-span-dependent families from the previous tt rows: the step's 13
k-shrink / j-shrink min-plus reductions (:data:`REDUCTIONS`), then the
assembly, the PM interior stencil and the write-back of row tt.  The whole
loop is one launch of the port's hand-written Hopper kernel
:func:`cuda_ops.tt_span`, from a :class:`cuda_ops.SpanTable` built once per
span, as the JAX package runs it as one device program per span
(``jax.lax.fori_loop``).  :func:`run_tt_loop_steps` is the same loop two
launches a step (:func:`cuda_ops.minplus_group`, :func:`cuda_ops.tt_step`),
kept as the kernel's comparator on the card.

Recurrences and tie-breaking order are unchanged (reference:
src/pseudo_loop.cc:181-679; per-branch citations in
``ccj_tpu/engine/gapped.py``).  The span's slabs and tables carry a leading
batch axis, and one launch runs the loop of every element of the batch;
the table builders take any leading axes.
"""

from __future__ import annotations

import torch

from . import cuda_ops
from .common import I32, INF, SAT16, dynamic_slice, pad_axis
from .cuda_ops import REDUCTIONS, reduction_table  # noqa: F401  (the loop's reductions)
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


def _run_span(loop, C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0, valid4,
              s, TB, IB, i0):
    """``loop`` (:func:`cuda_ops.tt_span` or :func:`cuda_ops.tt_span_steps`)
    on the span's :class:`cuda_ops.SpanTable`, over fresh A slabs holding
    the loop's initial values (SAT16 on the valid cells, INF elsewhere, as
    the kernel requires); returns the final families.  ``valid4`` is
    :func:`cuda_ops.span_valid` of ``C["n"]``, from which the table derives
    the same cells."""
    n2 = C["n"] + 2
    UK = n2 + TB + 1
    canp, pt, ESTP = C["can_pair"], C["ptype"], C["ESTP"]
    B = PLs.shape[0]
    if s < 2:                                 # no tt step: the initial values
        init = torch.where(valid4, SAT16, INF).to(I32)
        return {nm: init.repeat(B, 1, 1, 1) for nm in LOOP_MATS_ALL}

    # gather-free per-span weight / pair tables
    WKX = {nm: wk_table(X, TB, UK, n2).contiguous()
           for nm, X in (("WP", WPt), ("WB", WBt), ("WBP", WBPg))}
    WJX = {nm: wj_table(X, TB, n2).contiguous()
           for nm, X in (("WP", WPt), ("WB", WBt), ("WBP", WBPg))}
    jk = (jk_table(canp, TB, n2, 2, 0), jk_table(pt, TB, n2, 2, 0),
          jk_table(ESTP, TB, n2, 4, 1))

    # A-layout slabs carry TB pad rows beyond the live range so the
    # q-window [tt+1, tt+1+TB) never leaves them; pad rows hold INF and
    # can only lose (INF + weight <= 2e7 << int32 max, and every consumer
    # clamps through the step's store encoding exactly as the reference's
    # int16 store).  The step reads PL/PR/PO at row tt <= s - 2 < TB only.
    validp = pad_axis(valid4, 0, 0, TB + 2, False)
    mdp = pad_axis(mdp0, -3, 0, TB + 2, INF)              # PfromMdoubleprime
    init = torch.where(validp, SAT16, INF).to(I32)
    cur = {name: init.repeat(B, 1, 1, 1) for name in LOOP_MATS_ALL}
    loop(cuda_ops.SpanTable(cur, mdp, WKX, WJX, bases, SC4["DPM"], jk, PLs, PRs, POs,
                            n=C["n"], s=s, i0=i0, bp=C["bp"], cp=C["cp"], ap=C["ap"],
                            PB=C["PB"]))
    return {nm: cur[nm][:, :TB] for nm in LOOP_MATS_ALL}


def run_tt_loop(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0,
                valid4, s, TB: int, IB: int, i0: int = 0):
    """Run the serial tt loop for span ``s`` over rows i in
    [i0, i0 + IB); returns the final families.

    ``bases``: the 7 span-constant cross-span reduction bases by name.
    ``mdp0``: the PfromMdoubleprime base min(PL,PR)+PB [B, TB, IB, n2].
    Returns {name: [B, TB, IB, n2] int32} for every LOOP_MATS family.
    ``valid4`` ([TB, IB, n2]) is shared by the batch; every other operand
    has the leading batch axis.  The whole loop, every step of the span, is
    one :func:`cuda_ops.tt_span` from a table built here.
    """
    return _run_span(cuda_ops.tt_span, C, SC4, WBt, WPt, WBPg, bases, PLs, PRs,
                     POs, mdp0, valid4, s, TB, IB, i0)


def run_tt_loop_steps(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0,
                      valid4, s, TB: int, IB: int, i0: int = 0):
    """:func:`run_tt_loop` one step at a time, as the port ran it before
    :func:`cuda_ops.tt_span`: per tt step one :func:`cuda_ops.minplus_group`
    (the 13 reductions) and one :func:`cuda_ops.tt_step` (the rest), over
    the B slabs and STM that the span kernel does without
    (:func:`cuda_ops.tt_span_steps`).  The card-side comparator of
    :func:`run_tt_loop`; no fill reaches it."""
    return _run_span(cuda_ops.tt_span_steps, C, SC4, WBt, WPt, WBPg, bases, PLs,
                     PRs, POs, mdp0, valid4, s, TB, IB, i0)
