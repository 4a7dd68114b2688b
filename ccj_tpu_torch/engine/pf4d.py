"""Device partition function: the CCJ grammar in the sum-product semiring
(PyTorch).

Counterpart of ``ccj_tpu/engine/pf4d.py``, function for function.  Same
span engine as the MFE fill (engine/gapped4.py) with (min, +) replaced by
(+, *): slab reductions become weighted sums, the neutral element INF
becomes 0 (Matrix4DPF's unset/out-of-range value, reference
matrices.hh:258-263), and the integer energy tables become the
Boltzmann-factor tables of engine/pf.py's PFTables.  The grammar is the
*intended* one implemented by the host engine engine/pf.py (the reference's
part_func.cc is compiled out and visibly unfinished — see pf.py's module
docstring for the documented divergences), so device results are validated
against pf.py, not the reference binary.

Matches the host engine exactly in structure:
* PX families are computed before the band-spanning multiloop families, so
  PXmloop00's base case contributes,
* the PO interior-loop scan exists (dead code in the reference MFE path),
* per-length scale vectors ride along exactly as in PFTables.

dtype: float32 by default (a documented divergence from the reference's
double; see ``api.partition`` for its envelope), ``torch.float64`` on
request.  The JAX package runs a span as one XLA program, with no Pallas
kernel.  Here four hand-written kernels take its heavy parts
(``engine/pf_ops.py``, ``csrc/pfspan.cu``): the P split
(``pf_p_split``), the 16 history sums (``pf_history``), the PL / PR / PO
interior stencils (``pf_stencil``) and the serial tt loop
(``pf_tt_span``), each one launch a span on CUDA and its plain version
on the CPU; the rest of the span (``_wx_pf``, V, WBP / WPP, WM, the plane
reads, the assembly and the write-back) is plain PyTorch.  Each span
updates the state in place, every write after the last read of what it
overwrites.

Reference recurrences: src/part_func.cc:152-178 and pseudo_loop.cc; the
branch-by-branch citations live in ``ccj_tpu/engine/gapped.py`` / pf.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..params.io_par import MAXLOOP, TURN
from . import cuda_ops, pf_ops
from .common import dynamic_slice, dynamic_update_slice
from .gapped import C_MATS, DS, M4_NAMES, dims
from .gapped4 import LOOP_MATS, bucket_dims
from .pf import PFTables
from .pf_ops import g2s
from .skew import unskew_right

ML = MAXLOOP

# constant keys kept in their own integer / bool dtype (the rest are
# Boltzmann weights in the fill's float dtype)
_INDEX_KEYS = ("ptype", "can_pair")


def pfc_numpy(tabs, P, pk, pf_scale: float = 1.0):
    """Host (float64 numpy) constants of the fill: Boltzmann tables + folded
    stencil weights, the arrays ``ccj_tpu.engine.pf4d.build_pfc`` builds
    before it casts them.  Returns (C_np, PFTables)."""
    pf = PFTables(tabs, P, pk, pf_scale)
    n = tabs.n
    n2, T, S, U = dims(n)
    canp = np.asarray(tabs.can_pair)

    d1 = np.arange(1, DS + 1)[:, None, None, None]
    d2 = np.arange(1, DS + 1)[None, :, None, None]
    iv = np.arange(n2)[None, None, :, None]
    jv = np.arange(n2)[None, None, None, :]
    sj = jv - iv

    okL = ((d1 <= np.minimum(sj, ML) - 1) & (d2 <= ML - 1)
           & (d1 + d2 <= sj - TURN - 1)
           & (iv + d1 <= n2 - 1) & (jv - d2 >= 0)
           & canp[np.clip(iv + d1, 0, n2 - 1), np.clip(jv - d2, 0, n2 - 1)])
    W4PL = np.where(okL, pf.expEINTP[1:DS + 1, 1:DS + 1], 0.0)

    KP = n2 + T + 2
    LP = 2 * n2
    kv = np.arange(KP)[None, None, :, None]
    lv = np.arange(LP)[None, None, None, :]
    G = lv - kv
    okR = ((d1 <= np.minimum(G, ML) - 1) & (d2 <= ML - 1)
           & (d1 + d2 <= G - TURN - 1)
           & (kv + d1 <= n) & (lv - d2 >= 1) & (lv <= n)
           & canp[np.clip(kv + d1, 0, n2 - 1), np.clip(lv - d2, 0, n2 - 1)])
    eR = pf.expEINTP[np.broadcast_to(d1, okR.shape),
                     np.broadcast_to(d2, okR.shape),
                     np.clip(kv, 0, n2 - 1), np.clip(lv, 0, n2 - 1)]
    W4PR = np.where(okR, eR, 0.0)

    # PO interior weight in diagonal form: W4POD[d1, d2, i, a] = masked
    # expEINTP[d1, d2, i, l=i+a] with inner pair (i+d1, l-d2)
    # (host pf.py:246-250)
    ivl = np.arange(n2)[None, None, :, None]
    av = np.arange(n2)[None, None, None, :]
    lpo = ivl + av
    okO = ((d1 <= ML - 1) & (d2 <= ML - 1)
           & (ivl + d1 <= n2 - 1) & (lpo - d2 >= 0) & (lpo <= n)
           & canp[np.clip(ivl + d1, 0, n2 - 1), np.clip(lpo - d2, 0, n2 - 1)])
    eO = pf.expEINTP[np.broadcast_to(d1, okO.shape),
                     np.broadcast_to(d2, okO.shape),
                     np.clip(ivl, 0, n2 - 1), np.clip(lpo, 0, n2 - 1)]
    W4POD = np.where(okO, eO, 0.0)

    # PM stencil weight (u = j + tt coordinates, like the MFE fill's DPM)
    ttv = np.arange(T)[None, None, :, None]
    uv = np.arange(U)[None, None, None, :]
    jpm = uv - ttv
    kpm = uv + 2
    okM = ((jpm - d1 >= 1) & (jpm >= 1) & (jpm <= n2 - 1)
           & (kpm + d2 <= n) & (kpm <= n2 - 1))
    jc = np.clip(jpm - d1, 0, n2 - 1)
    kc = np.clip(kpm + d2, 0, n2 - 1)
    DPM = np.where(okM & canp[jc, kc],
                   pf.expEINTP[np.broadcast_to(d1, okM.shape),
                               np.broadcast_to(d2, okM.shape), jc, kc], 0.0)

    # nested-V diagonals: EINTD[dk, dl, i, a] = expEINT[dk, dl, i, i+a]
    EINTD = unskew_right(torch.from_numpy(pf.expEINT), 0.0, n2).numpy()
    HD = unskew_right(torch.from_numpy(pf.expH), 0.0, n2).numpy()

    expML = pf.expML2 if P.dangles in (1, 2) else pf.expML0
    expMB = pf.expMB2 if P.dangles in (1, 2) else pf.expMB0

    C = {"W4PL": W4PL, "W4PR": W4PR, "W4POD": W4POD, "DPM": DPM,
         "EINTD": EINTD, "HD": HD, "expESTP": pf.expESTP, "expML": expML,
         "expMB": expMB, "expMLbase": pf.expMLbase, "expcp": pf.expcp,
         "expPUP": pf.expPUP, "scale2": pf.scale[2]}
    for name in ("PS", "PSM", "PSP", "PB", "PPS", "b", "bp", "ap"):
        C["exp" + name] = getattr(pf, "exp" + name)
    C["ptype"] = tabs.ptype
    C["can_pair"] = tabs.can_pair
    return C, pf


def pfc_from_numpy(C_np, device, dtype=torch.float32):
    """Carry a constant dict across to the port: ``C_np`` maps the keys of
    ``ccj_tpu.engine.pf4d.build_pfc``'s dict (or :func:`pfc_numpy`'s) to
    numpy arrays; returns them as tensors on ``device``, the weights in
    ``dtype``, ``ptype`` / ``can_pair`` in their own dtype.  Fed the same
    arrays, both packages fill from identical constants."""
    C = {}
    for k, v in C_np.items():
        v = np.array(v)
        C[k] = torch.as_tensor(v, device=device, dtype=None if k in _INDEX_KEYS
                               else dtype)
    return C


def pf_state_from_numpy(st_np, device, dtype=torch.float64):
    """Carry a fill state across to the port: ``st_np`` maps the keys of
    :func:`init_pf_state` (as ``ccj_tpu.engine.pf4d.init_pf_state`` names
    them) to numpy arrays; returns contiguous tensors on ``device`` in
    ``dtype``, which :func:`pf_span_step` updates in place."""
    return {k: torch.as_tensor(np.array(v), device=device, dtype=dtype).contiguous()
            for k, v in st_np.items()}


def build_pfc(tabs, P, pk, pf_scale: float = 1.0, dtype=torch.float32,
              device="cuda"):
    """Device constants: Boltzmann tables + folded stencil weights.
    Returns (C, PFTables, dtype)."""
    C_np, pf = pfc_numpy(tabs, P, pk, pf_scale)
    return pfc_from_numpy(C_np, device, dtype), pf, dtype


def init_pf_state(n, dtype, device):
    n2, T, S, U = dims(n)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    st = {k: z(n2, n2) for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP")}
    st["VD"] = z(S + 1, n2)    # VD[sp, i] = V[i, i+sp]
    st["PD"] = z(S + 1, n2)    # PD[sp, i] = P2[i, i+sp]
    for name in M4_NAMES:
        st[name] = z(T, S, n2, n2)
    for name in C_MATS:
        st["C_" + name] = z(T, S, n2, n2)
    st["PKD"] = z(T, S, n2, n2)
    st["PKE"] = z(T, S + T + 2, n2, n2)
    return st


def _wx_pf(C, st):
    """WB / WP / raw-WBP / raw-WPP lookup tables (host pf.py WB()/WP())."""
    n = C["n"]
    n2 = n + 2
    dev = st["WBP"].device
    a = torch.arange(n2, device=dev)[:, None]
    b = torch.arange(n2, device=dev)[None, :]
    inb = (a >= 1) & (b >= 1) & (a <= n) & (b <= n)

    def wx(raw, unit):
        base = unit[(b - a + 1).clamp(0, n2 - 1)] + raw
        return torch.where(inb, torch.where(a > b, 1.0, base), 0.0)

    WB = wx(st["WBP"], C["expcp"])
    WP = wx(st["WPP"], C["expPUP"])
    WBPg = torch.where(inb & (a <= b), st["WBP"], 0.0)
    WPPg = torch.where(inb & (a <= b), st["WPP"], 0.0)
    return WB, WP, WBPg, WPPg


def pf_span_nested(C, st, s, kernels=None):
    """V, P2, WBP, WPP for every (i, l=i+s) (host pf.py's per-cell blocks,
    vectorized over i); updates ``st`` in place.  ``kernels``: as in
    :func:`pf_span_step`."""
    kernels = pf_ops if kernels is None else kernels
    n = C["n"]
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

    # ---- P2(i, i+s) via the PK diagonal skews (sum-product compute_P) -----
    p_new = kernels.pf_p_split(st["PKE"], st["PKD"], n=n, s=s)
    st["P2"][ii, ll] = torch.where(row_ok, p_new, st["P2"][ii, ll])
    st["PD"][min(s, S)] = torch.where(row_ok, p_new, 0.0)

    # ---- WBP / WPP --------------------------------------------------------
    WB, WP, WBPg, WPPg = _wx_pf(C, st)
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
    return st


def pf_span_gapped(C, st, s, TB, IB, kernels=None):
    """All 22 gapped families for span s in the sum-product semiring;
    updates the big state in place.

    Mirrors engine/gapped4.span_gapped4 phase for phase; 0 is both the
    unset and the out-of-range value (Matrix4DPF), so only the strict
    d-range bounds (the g1=1 cases) need runtime masks — everything else
    contributes 0 automatically.  The history sums, the three interior
    stencils and the tt loop run through ``pf_ops``' kernels (their plain
    versions on the CPU; ``kernels``: as in :func:`pf_span_step`); the
    plane reads, the assembly and the write-back here.
    """
    kernels = pf_ops if kernels is None else kernels
    n = C["n"]
    n2, T, S, U = dims(n)
    dev = st["PK"].device
    dtype = st["PK"].dtype

    def ar(m):
        return torch.arange(m, device=dev)

    tv = ar(TB)[:, None, None]
    iv = ar(IB)[None, :, None]
    jv = ar(n2)[None, None, :]
    kv = jv + tv + 2
    lv = iv + s
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)

    WB, WP, WBPg, WPPg = _wx_pf(C, st)
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

    # ---- the 16 RL / RI history sums and the three interior stencils ------
    (ri_POm00, rl_POm00, POm01, ri_POm10, rl_POm10, rl_PRm01, ri_PfromO, rl_PfromO,
     basePLm00, basePLm10, basePRm00, basePMm01, ri_PMm10, rl_PMm10, basePfromL,
     basePfromR) = kernels.pf_history(st, WB, WP, WBPg, n=n, s=s, TB=TB, IB=IB)
    pl_acc, pr_int, po_acc = kernels.pf_stencil(st, C["W4PL"], C["W4PR"], C["W4POD"],
                                                n=n, s=s, TB=TB, IB=IB)

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

    # ---- cross-span-only families + bases ----------------------------------
    POm00 = POs * C["expbp"] + ri_POm00 + rl_POm00
    POm10 = ri_POm10 + rl_POm10
    PRm01 = rplane_big_all("PRmloop01", 0, 1, 0, 0) * C["expcp"][1] + rl_PRm01
    PfromO = ri_PfromO + rl_PfromO + (PLs + PRs) * C["expPB"]
    basePMm10 = ri_PMm10 + rl_PMm10

    # ---- serial loop -------------------------------------------------------
    loops = kernels.pf_tt_span(C, WB, WP, WBPg, PLs, PRs, POs, {
        "PLmloop00": basePLm00, "PLmloop10": basePLm10,
        "PRmloop00": basePRm00, "PMmloop01": basePMm01,
        "PMmloop10": basePMm10, "PfromL": basePfromL,
        "PfromR": basePfromR}, n=n, s=s, TB=TB, IB=IB)

    # ---- write-back (in place: every read of st above is done) -----------
    # (the loop's slabs are 0 off the span's valid cells already)
    packed = {name: slab[:TB] for name, slab in zip(LOOP_MATS, loops)}
    for name, v in (("PL", PLv), ("PR", PRv), ("PO", POv),
                    ("PRmloop01", PRm01), ("POmloop00", POm00),
                    ("POmloop01", POm01), ("POmloop10", POm10),
                    ("PfromO", PfromO)):
        packed[name] = torch.where(valid4, v, 0.0)

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
    return st


def pf_span_wm(C, st, s):
    """WMv / WMp / WM for all (i, j=i+s) (host pf.py's trailing block);
    updates ``st`` in place."""
    n = C["n"]
    n2 = n + 2
    dev = st["V"].device
    ii = torch.arange(n2, device=dev)
    ll = (ii + s).clamp(0, n2 - 1)
    row_ok = (ii >= 1) & (ii + s <= n) & (s >= 3)
    jm1 = (ii + s - 1).clamp(0, n2 - 1)
    stem = st["V"][ii, ll] * C["expML"][ii, ll]
    wmv = stem + st["WMv"][ii, jm1] * C["expMLbase"][1]
    wmp = (st["P2"][ii, ll] * C["expPSM"] * C["expb"]
           + st["WMp"][ii, jm1] * C["expMLbase"][1])
    kk = torch.arange(n2, device=dev)[:, None]
    iv2 = ii[None, :]
    okk = (kk >= iv2) & (kk <= iv2 + s - TURN - 1) & row_ok[None, :]
    kcl = kk.clamp(0, n2 - 1)
    jcl = (iv2 + s).clamp(0, n2 - 1)
    qbt = (st["V"][kcl, jcl] * C["expML"][kcl, jcl]
           + st["P2"][kcl, jcl] * C["expPSM"] * C["expb"])
    pre = C["expMLbase"][(kk - iv2).clamp(0, n2 - 1)] \
        + torch.where(kk - 1 >= iv2,
                      st["WM"][iv2.clamp(0, n2 - 1), (kk - 1).clamp(0, n2 - 1)],
                      0.0)
    tot = torch.where(okk, pre * qbt, 0.0).sum(dim=0) \
        + st["WM"][ii, jm1] * C["expMLbase"][1]
    st["WMv"][ii, ll] = torch.where(row_ok, wmv, st["WMv"][ii, ll])
    st["WMp"][ii, ll] = torch.where(row_ok, wmp, st["WMp"][ii, ll])
    st["WM"][ii, ll] = torch.where(row_ok, tot, st["WM"][ii, ll])
    return st


def pf_span_step(C, st, s, n: int, TB: int, IB: int, kernels=None):
    """One whole span of the device PF fill, in place.  ``kernels``: what
    the span calls its four kernel wrappers through, by their names in
    ``pf_ops`` (``pf_p_split``, ``pf_history``, ``pf_stencil``,
    ``pf_tt_span``); ``pf_ops`` itself when None."""
    C = {**C, "n": n}
    pf_span_nested(C, st, s, kernels)
    pf_span_gapped(C, st, s, TB, IB, kernels)
    return pf_span_wm(C, st, s)


class _ArrView:
    """dict-of-tuples view over a [tt, s, i, j] device-PF array, matching
    engine/pf.py's M4 access protocol (used by engine/sample.py)."""

    def __init__(self, arr, n):
        self.arr = arr
        self.n = n

    def get(self, key, default=0.0):
        i, j, k, l = key
        if not (1 <= i <= j and j < k - 1 and k <= l <= self.n):
            return default
        return float(self.arr[k - j - 2, l - i, i, j])


@torch.inference_mode()
def pf_fill_device(tabs, P, pk, pf_scale: float = 1.0, dtype=torch.float32,
                   *, device, C=None, times=None):
    """Device sum-product fill on ``device``; returns the same result dict
    shape as the host pf_fill (W computed host-side from the device V / P2
    planes).

    ``C``: the constants as :func:`pfc_from_numpy` gives them (their weight
    dtype is the fill's); built here by :func:`build_pfc` when None.
    Validated against the host engine and the JAX package's device fill at
    small n (tests/test_torch_pf.py); float32 by default — a documented
    precision divergence from the reference's double (pass
    ``dtype=torch.float64`` for float64).

    ``times``: a dict that, when given, receives the seconds of the fill's
    four parts in one run, each ended by draining the device's queue:
    ``constants_s`` (the constants built and uploaded), ``span_loop_s``,
    ``copy_out_s`` (the state's arrays to host float64) and
    ``exterior_s`` (W on the host).
    """
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        if times is not None:
            dev = C["expMLbase"].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            times[key], t0 = t1 - t0, t1

    if C is None:
        C, pf, dtype = build_pfc(tabs, P, pk, pf_scale, dtype, device)
    else:
        pf = PFTables(tabs, P, pk, pf_scale)
        dtype = C["expMLbase"].dtype
    n = tabs.n
    lap("constants_s")
    st = init_pf_state(n, dtype, C["expMLbase"].device)
    for s in range(n):
        TB, IB = bucket_dims(n, s)
        pf_span_step(C, st, s, n=n, TB=TB, IB=IB)
    lap("span_loop_s")

    res = {k: st[k].cpu().numpy().astype(np.float64, copy=False)
           for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP")}
    res["M4"] = {name: _ArrView(st[name].cpu().numpy().astype(np.float64, copy=False), n)
                 for name in M4_NAMES}
    res["pf"] = pf
    lap("copy_out_s")

    # exterior W on host (mirrors engine/pf.py / part_func.cc:152-178)
    V, P2 = res["V"], res["P2"]
    expEXT = (pf.expEXT2 if P.dangles in (1, 2) else pf.expEXT0)
    W = np.zeros(n + 1)
    W[0] = 1.0
    for j in range(1, n + 1):
        if j <= TURN:
            W[j] = W[j - 1] * pf.scale[1] if j > 1 else pf.scale[1]
            continue
        tot = W[j - 1] * pf.scale[1]
        for k in range(1, j - TURN):
            acc = W[k - 1] if k > 1 else 1.0
            tot += acc * V[k, j] * expEXT[k, j]
            tot += acc * P2[k, j] * pf.expPS
        W[j] = tot
    res["W"] = W
    lap("exterior_s")
    return res
