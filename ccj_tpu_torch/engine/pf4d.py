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
request.  The whole fill is plain PyTorch on the device: the JAX package
runs it as XLA, with no Pallas kernel.  Each span updates the state in
place, every write after the last read of what it overwrites.

Reference recurrences: src/part_func.cc:152-178 and pseudo_loop.cc; the
branch-by-branch citations live in ``ccj_tpu/engine/gapped.py`` / pf.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..params.io_par import MAXLOOP, TURN
from . import cuda_ops
from .common import dynamic_slice, dynamic_update_slice
from .common import pad_axis as _pad
from .gapped import C_MATS, DS, M4_NAMES, dims
from .gapped import PADT as PADT4
from .gapped4 import LOOP_MATS, bucket_dims
from .pf import PFTables
from .skew import skew_right, unskew_right
from .ttloop import B4_MATS_ALL as B4_MATS

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


def pf_span_nested(C, st, s):
    """V, P2, WBP, WPP for every (i, l=i+s) (host pf.py's per-cell blocks,
    vectorized over i); updates ``st`` in place."""
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
    PKD, PKE = st["PKD"], st["PKE"]
    bb = torch.arange(T, device=dev)[:, None, None]
    ccp = torch.arange(T, device=dev)[None, :, None]
    ivp = torch.arange(n2, device=dev)[None, None, :]
    p_new = torch.zeros(n2, dtype=vnew.dtype, device=dev)
    zpad = torch.zeros((T, n2, n2), dtype=vnew.dtype, device=dev)
    for a in range(max(s - 1, 0)):           # lanes a <= s - 2
        F1 = dynamic_slice(PKE, (0, a + 2, 0, a), (T, T, n2, 1))[..., 0]
        sl2 = dynamic_slice(PKD, (0, min(max(s - a - 1, 0), S - 1), 0, 0),
                            (T, 1, n2, n2))[:, 0]
        sl2 = torch.cat([sl2, zpad], dim=1)
        F2 = dynamic_slice(sl2, (0, a + 1, 0), (T, n2, T)).permute(2, 0, 1)
        ok = (bb + ccp + 2 <= s - 1 - a) & (ivp >= 1) & (ivp + s <= n)
        p_new = p_new + torch.where(ok, F1 * F2, 0.0).sum(dim=(0, 1))
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


def pf_span_gapped(C, st, s, TB, IB):
    """All 22 gapped families for span s in the sum-product semiring;
    updates the big state in place.

    Mirrors engine/gapped4.span_gapped4 phase for phase; 0 is both the
    unset and the out-of-range value (Matrix4DPF), so only the strict
    d-range bounds (the g1=1 cases) need runtime masks — everything else
    contributes 0 automatically.
    """
    n = C["n"]
    n2, T, S, U = dims(n)
    UB = n2 + TB
    dev = st["PK"].device
    dtype = st["PK"].dtype

    def ar(m):
        return torch.arange(m, device=dev)

    tv = ar(TB)[:, None, None]
    iv = ar(IB)[None, :, None]
    jv = ar(n2)[None, None, :]
    kv = jv + tv + 2
    lv = iv + s
    Gv = lv - kv
    sjv = jv - iv
    valid4 = cuda_ops.span_valid(n, s, 0, TB, IB, n2, dev)

    WB, WP, WBPg, WPPg = _wx_pf(C, st)
    canp, pt = C["can_pair"], C["ptype"]

    def g2(X, a, b):
        ok = (a >= 0) & (a < n2) & (b >= 0) & (b < n2)
        v = X[a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)]
        return torch.where(ok, v, 0.0)

    def rplane_big_all(name, c, b, di, dj):
        """value[tt, i, j] = big[name][tt+c, s-b, i+di, j+dj] (0 outside)."""
        if s - b < 0:
            return torch.zeros((TB, IB, n2), dtype=dtype, device=dev)
        sl = dynamic_slice(st[name], (0, s - b, 0, 0), (T, 1, n2, n2))[:, 0]
        sl = _pad(sl, 0, 0, max(c + TB - T, 0), 0.0)
        sl = dynamic_slice(sl, (c, 0, 0), (TB, n2, n2))
        sl = _pad(sl, 1, 0, 1, 0.0)[:, di: di + IB, :]
        if dj == -1:
            sl = F.pad(sl, (1, 0))[:, :, :n2]
        elif dj == 1:
            sl = F.pad(sl, (0, 1))[:, :, 1:]
        return sl

    sp0 = max(s - TB, 0)
    spv = sp0 + ar(TB)
    d_rl = (s - spv)[None, :, None, None]
    i1 = ar(IB)

    def RL(name, X, g1):
        win = dynamic_slice(st[name], (0, sp0, 0, 0), (TB, TB, n2, n2))[:, :, :IB, :]
        wl = g2(X, i1[None, :] + spv[:, None] + 1,
                (i1[None, :] + s).expand(TB, IB))
        ok = d_rl >= 1
        if g1:
            ok = ok & (d_rl <= (Gv - 1)[:, None])
        return torch.where(ok, win * wl[None, :, :, None], 0.0).sum(dim=1)

    def RI(name, X, g1):
        loff = min(s, n2 - IB)
        win = dynamic_slice(st["C_" + name], (0, sp0, loff, 0), (TB, TB, IB, n2))
        l_val = loff + i1
        i_val = l_val - s
        wi = g2(X, i_val[None, :].expand(TB, IB), l_val[None, :] - spv[:, None] - 1)
        ok = (d_rl >= 1) & (i_val >= 1)[None, None, :, None]
        if g1:
            sj_lr = jv[0] - i_val[:, None]
            ok = ok & (d_rl <= (sj_lr - 1)[None, None])
        red = torch.where(ok, win * wi[None, :, :, None], 0.0).sum(dim=1)
        return dynamic_slice(_pad(red, 1, 0, IB, 0.0), (0, s - loff, 0),
                             (TB, IB, n2))

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

    # ---- PL ---------------------------------------------------------------
    plw = span_window("PL", TB + DS, 0)
    plw = torch.flip(plw, dims=(1,))
    plw = _pad(plw, 2, 0, max(IB + DS - n2, 0) + DS, 0.0)
    V1 = torch.stack([plw[:, d1 - 1, d1: d1 + IB, :]
                      for d1 in range(1, DS + 1)], dim=1)
    W4PL = C["W4PL"][:, :, :IB, :]
    pl_acc = torch.zeros((TB, IB, n2), dtype=dtype, device=dev)
    for d2 in range(1, DS + 1):
        sub = dynamic_slice(V1, (d2, 0, 0, 0), (TB, DS, IB, n2))
        sub = F.pad(sub, (d2, 0))[..., :n2]
        pl_acc = pl_acc + (sub * W4PL[None, :, d2 - 1]).sum(dim=1)
    pl_stack = rplane_big_all("PL", 1, 1, 1, -1) * g2(C["expESTP"], iv, jv)
    PLiloop = torch.where(g2(canp, iv, jv) > 0, pl_stack + pl_acc, 0.0)
    PLml = (rplane_big_all("PLmloop10", 1, 1, 1, -1)
            + rplane_big_all("PLmloop01", 1, 1, 1, -1)) \
        * C["expap"] * C["expbp"] * C["expbp"]
    PL_b3 = torch.where(jv >= iv + TURN + 1,
                        rplane_big_all("PfromL", 1, 1, 1, -1), 0.0)
    PLv = torch.where(g2(pt, iv, jv) > 0, PLiloop + PLml + PL_b3, 0.0)
    PLs = torch.where(valid4, PLv, 0.0)

    # ---- PR (u = j + tt coordinates for the interior stencil) -------------
    prw = span_window("PR", TB + DS, 0)[:, :, :IB, :]
    prw = torch.flip(prw, dims=(1,))
    prm = prw.movedim(0, -2)
    pru = skew_right(prm, 0.0)
    wpr = dynamic_slice(C["W4PR"], (0, 0, 2, s), (DS, DS, UB, IB))
    wpr = wpr.permute(0, 1, 3, 2)
    pr_acc = torch.zeros((IB, TB, UB), dtype=dtype, device=dev)
    for d1 in range(1, DS + 1):
        sub = pru[:, :, d1: d1 + TB, d1: d1 + UB]
        pr_acc = pr_acc + (sub * wpr[d1 - 1][:, :, None, :]).sum(dim=0)
    pr_int = unskew_right(pr_acc, 0.0, n2).movedim(0, 1)
    pr_stack = rplane_big_all("PR", 1, 1, 0, 0) * g2(C["expESTP"], kv, lv)
    PRiloop = torch.where(g2(canp, kv, lv) > 0, pr_stack + pr_int, 0.0)
    PRml = (rplane_big_all("PRmloop10", 1, 1, 0, 0)
            + rplane_big_all("PRmloop01", 1, 1, 0, 0)) \
        * C["expap"] * C["expbp"] * C["expbp"]
    PR_b3 = torch.where(lv >= kv + TURN + 1,
                        rplane_big_all("PfromR", 1, 1, 0, 0), 0.0)
    PRv = torch.where(g2(pt, kv, lv) > 0, PRiloop + PRml + PR_b3, 0.0)
    PRs = torch.where(valid4, PRv, 0.0)

    # ---- PO (with the interior scan the reference's MFE path dead-codes) --
    po_acc = torch.zeros((TB, IB, n2), dtype=dtype, device=dev)
    d2v3 = torch.arange(1, DS + 1, device=dev)[None, :, None, None]
    for d1 in range(1, DS + 1):
        wnd = span_window("PO", TB, d1)            # row d2-1 = span s-d1-d2
        wnd = torch.flip(wnd, dims=(1,))
        wnd = _pad(wnd, 2, 0, max(IB + DS - n2, 0) + DS, 0.0)
        wnd = wnd[:, :, d1: d1 + IB, :]            # i + d1
        w = dynamic_slice(C["W4POD"], (d1 - 1, 0, 0, s), (1, DS, IB, 1))[0, :, :, 0]
        okO = (d1 <= sjv - 1)[:, None] & (d2v3 <= (Gv - 1)[:, None])
        po_acc = po_acc + torch.where(okO, wnd * w[None, :, :, None], 0.0).sum(dim=1)
    po_stack = rplane_big_all("PO", 0, 2, 1, 0) * g2(C["expESTP"], iv, lv)
    POiloop = torch.where(g2(canp, iv, lv) > 0, po_stack + po_acc, 0.0)
    POml = (rplane_big_all("POmloop10", 0, 2, 1, 0)
            + rplane_big_all("POmloop01", 0, 2, 1, 0)) \
        * C["expap"] * C["expbp"] * C["expbp"]
    PO_b3 = torch.where(lv >= iv + TURN + 1,
                        rplane_big_all("PfromO", 0, 2, 1, 0), 0.0)
    POv = torch.where(g2(pt, iv, lv) > 0, POiloop + POml + PO_b3, 0.0)
    POs = torch.where(valid4, POv, 0.0)

    # ---- cross-span-only families + bases ----------------------------------
    POm00 = POs * C["expbp"] + RI("POmloop00", WB, 0) + RL("POmloop00", WB, 0)
    POm01 = RL("POmloop00", WBPg, 0)
    POm10 = RI("POmloop00", WBPg, 0) + RL("POmloop10", WB, 1)
    PRm01 = rplane_big_all("PRmloop01", 0, 1, 0, 0) * C["expcp"][1] \
        + RL("PRmloop00", WBPg, 0)
    PfromO = (RI("PfromO", WP, 1) + RL("PfromO", WP, 1)
              + (PLs + PRs) * C["expPB"])

    basePLm00 = RI("PLmloop00", WB, 0)
    basePLm10 = RI("PLmloop00", WBPg, 0)
    basePRm00 = RL("PRmloop00", WB, 0)
    basePMm01 = RL("PMmloop00", WBPg, 0)
    basePMm10 = RI("PMmloop00", WBPg, 0) + RL("PMmloop10", WB, 1)
    basePfromL = RI("PfromL", WP, 1)
    basePfromR = RL("PfromR", WP, 1)

    # ---- serial loop -------------------------------------------------------
    cur = _pf_tt_loop(C, WB, WP, WBPg, PLs, PRs, POs, valid4, s, TB, IB, {
        "PLmloop00": basePLm00, "PLmloop10": basePLm10,
        "PRmloop00": basePRm00, "PMmloop01": basePMm01,
        "PMmloop10": basePMm10, "PfromL": basePfromL,
        "PfromR": basePfromR})

    # ---- write-back (in place: every read of st above is done) -----------
    packed = {name: torch.where(valid4, cur[name][:TB], 0.0)
              for name in LOOP_MATS}
    for name, v in (("PL", PLv), ("PR", PRv), ("PO", POv),
                    ("PRmloop01", PRm01), ("POmloop00", POm00),
                    ("POmloop01", POm01), ("POmloop10", POm10),
                    ("PfromO", PfromO)):
        packed[name] = torch.where(valid4, v, 0.0)

    for name in M4_NAMES:
        sl = packed[name]
        if IB < n2:
            sl = _pad(sl, 1, 0, n2 - IB, 0.0)
        dynamic_update_slice(st[name], sl[:, None], (0, s, 0, 0))
    for name in C_MATS:
        slp = _pad(packed[name], 1, n2, 0, 0.0)
        cs = dynamic_slice(slp, (0, n2 - s, 0), (TB, n2, n2))
        dynamic_update_slice(st["C_" + name], cs[:, None], (0, s, 0, 0))

    # PK diagonal skews (0-filled): PKD[tt, s] and PKE[tt, s - tt] for
    # tt <= s (the JAX scatter writes rows tt > s back unchanged)
    pk = packed["PK"]
    if IB < n2:
        pk = _pad(pk, 1, 0, n2 - IB, 0.0)
    slab = unskew_right(pk, 0.0, n2)
    slab = _pad(slab, 0, 0, T - TB, 0.0)
    dynamic_update_slice(st["PKD"], slab[:, None], (0, s, 0, 0))
    tt_idx = torch.arange(min(s, T - 1) + 1, device=dev)
    st["PKE"][tt_idx, s - tt_idx] = slab[tt_idx]
    return st


def _pf_tt_loop(C, WB, WP, WBPg, PLs, PRs, POs, valid4, s, TB, IB, bases):
    """The serial tt-descending loop of :func:`pf_span_gapped` (the JAX
    ``fori_loop`` body ``t_body``); returns the span slabs by name, each
    [TB + 2, IB, n2].  Each step reads the rows above tt and writes row tt
    after its last read."""
    n = C["n"]
    n2 = n + 2
    UB = n2 + TB
    dev = valid4.device
    dtype = PLs.dtype
    canp, pt = C["can_pair"], C["ptype"]

    def g2(X, a, b):
        ok = (a >= 0) & (a < n2) & (b >= 0) & (b < n2)
        v = X[a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)]
        return torch.where(ok, v, 0.0)

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
        wk = {nm: g2(X, kk.expand(TB, n2), kk + (q2 - tt) - 1)
              for nm, X in (("WPk", WP), ("WBk", WB), ("WBPk", WBPg))}
        wj = {nm: g2(X, uu2 - q2 + 1, (uu2 - tt).expand(TB, UB))
              for nm, X in (("WPj", WP), ("WBj", WB), ("WBPj", WBPg))}
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

        canp_jk = g2(canp, jr[None], jr[None] + tt + 2)[0]
        pt_jk = g2(pt, jr[None], jr[None] + tt + 2)[0]
        estp_jk = g2(C["expESTP"], jr[None] - 1, jr[None] + tt + 3)[0]
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
    return cur


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


def pf_span_step(C, st, s, n: int, TB: int, IB: int):
    """One whole span of the device PF fill, in place."""
    C = {**C, "n": n}
    pf_span_nested(C, st, s)
    pf_span_gapped(C, st, s, TB, IB)
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
                   *, device, C=None):
    """Device sum-product fill on ``device``; returns the same result dict
    shape as the host pf_fill (W computed host-side from the device V / P2
    planes).

    ``C``: the constants as :func:`pfc_from_numpy` gives them (their weight
    dtype is the fill's); built here by :func:`build_pfc` when None.
    Validated against the host engine and the JAX package's device fill at
    small n (tests/test_torch_pf.py); float32 by default — a documented
    precision divergence from the reference's double (pass
    ``dtype=torch.float64`` for float64).
    """
    if C is None:
        C, pf, dtype = build_pfc(tabs, P, pk, pf_scale, dtype, device)
    else:
        pf = PFTables(tabs, P, pk, pf_scale)
        dtype = C["expMLbase"].dtype
    n = tabs.n
    st = init_pf_state(n, dtype, C["expMLbase"].device)
    for s in range(n):
        TB, IB = bucket_dims(n, s)
        pf_span_step(C, st, s, n=n, TB=TB, IB=IB)

    res = {k: st[k].cpu().numpy().astype(np.float64)
           for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP")}
    res["M4"] = {name: _ArrView(st[name].cpu().numpy().astype(np.float64), n)
                 for name in M4_NAMES}
    res["pf"] = pf

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
    return res
