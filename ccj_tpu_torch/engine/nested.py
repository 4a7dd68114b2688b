"""Nested (pseudoknot-free) DP: V / WM / WMv / WMp span updates (PyTorch).

Counterpart of ``ccj_tpu/engine/nested.py``: an exact port of
s_energy_matrix (reference: src/s_energy_matrix.cc) in span-wavefront form,
all cells (i, j=i+s) of one span updated in parallel.  The span functions
update the state dict IN PLACE (each reads every cell it needs before its
write, as the JAX data flow does) and return it.  State arrays and tables
carry a leading batch axis ([B, n2, n2]; fill.fill6 is a batch of one);
index vectors do not, and broadcast over it.
"""

from __future__ import annotations

import torch

from .common import INF, MAXLOOP, TURN, V_UNSET, guarded_add, mmin, v_get


def _diag_idx(n2, s, device):
    """Row index vector i (0..n2-1) and the diagonal column j = i + s."""
    ii = torch.arange(n2, device=device)
    return ii, ii + s


def e_mlstem_diag(C, st, ii, jj, dangles):
    """E_MLStem(V(i,j), V(i+1,j), V(i,j-1), V(i+1,j-1))
    (s_energy_matrix.cc:54-112) for index tensors (ii, jj)."""
    V = st["V"]
    n2 = V.shape[-1]
    iic = ii.clamp(0, n2 - 1)
    jjc = jj.clamp(0, n2 - 1)
    vij = v_get(V, iic, jjc)
    e = guarded_add(vij, (C["ML2"] if dangles == 2 else C["ML0"])[:, iic, jjc])
    if dangles == 1:
        MLbase = C["MLbase"]
        ip1 = (ii + 1).clamp(0, n2 - 1)
        jm1 = (jj - 1).clamp(0, n2 - 1)
        vi1j = torch.where(jj - ii - 1 > TURN, v_get(V, ip1, jjc), INF)
        e = torch.minimum(e, guarded_add(vi1j, MLbase + C["ML_ip1"][:, iic, jjc]))
        vij1 = torch.where(jj - 1 - ii > TURN,
                           v_get(V, iic, (jjc - 1).clamp(0, n2 - 1)), INF)
        e = torch.minimum(e, guarded_add(vij1, MLbase + C["ML_jm1"][:, iic, jjc]))
        vi1j1 = torch.where(jj - 1 - ii - 1 > TURN, v_get(V, ip1, jm1), INF)
        e = torch.minimum(
            e, guarded_add(vi1j1, 2 * MLbase + C["ML_both"][:, iic, jjc]))
    return e


def compute_V_span(C, st, s, dangles):
    """V(i, i+s) for all i (s_energy_matrix.cc:315-358); in place."""
    n = C["n"]
    n2 = n + 2
    V = st["V"]
    dev = V.device
    ii, jj = _diag_idx(n2, s, dev)
    jjc = jj.clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (jj <= n)

    # --- hairpin (H already INF where unpairable) --------------------------
    e_h = C["H"][:, ii, jjc]

    # --- interior loops (s_energy_matrix.cc:287-299) -----------------------
    # k=i+di, l=j-dj; bounds: di>=1, dj>=1, di <= MAXLOOP+1,
    # l >= k+TURN+1  <=>  di+dj <= s-TURN-1;  n1+n2 <= MAXLOOP  <=>
    # di+dj <= MAXLOOP+2;  k <= j-TURN-2  <=>  di <= s-TURN-2 (implied)
    di = torch.arange(MAXLOOP + 2, device=dev)[:, None, None]
    dj = torch.arange(MAXLOOP + 2, device=dev)[None, :, None]
    iv = ii[None, None, :]
    jv = jj[None, None, :]
    ok = ((di >= 1) & (dj >= 1)
          & (di <= MAXLOOP + 1)
          & (di + dj <= MAXLOOP + 2)
          & (di + dj <= s - TURN - 1)
          & (iv >= 1) & (jv <= n))
    eint = C["EINT"][:, di, dj, iv, jv.clamp(0, n2 - 1)]
    vin = v_get(V, (iv + di).clamp(0, n2 - 1), (jv - dj).clamp(0, n2 - 1))
    e_i = torch.where(ok, eint + vin, INF).amin(dim=(-3, -2))

    # --- multiloop (compute_energy_VM, s_energy_matrix.cc:243-268) ---------
    # split point c = i + g, g in [1, s-3]
    WM, WMv, WMp = st["WM"], st["WMv"], st["WMp"]
    gg = torch.arange(n2, device=dev)[:, None]
    iv2 = ii[None, :]
    cc = iv2 + gg
    ok2 = (gg >= 1) & (gg <= s - 3) & (iv2 >= 1) & (iv2 + s <= n)
    MLbase = C["MLbase"]

    def getter(M):
        def g(a, b):  # get_energy_WM / WMv / WMp: INF for a >= b
            return torch.where(a >= b, INF,
                               M[:, a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)])
        return g

    wm_g, wmv_g, wmp_g = getter(WM), getter(WMv), getter(WMp)
    gm1 = ((gg - 1) * MLbase).to(torch.int32)
    gm2 = ((gg - 2) * MLbase).to(torch.int32)

    jm1v = iv2 + s - 1
    wm2_ij = mmin(
        wm_g(iv2 + 1, cc - 1) + wmv_g(cc, jm1v),
        wm_g(iv2 + 1, cc - 1) + wmp_g(cc, jm1v),
        gm1 + wmp_g(cc, jm1v),
    )
    if dangles == 2:
        e_c = guarded_add(wm2_ij, C["MB2"][:, None, ii, jjc])
    elif dangles == 0:
        e_c = guarded_add(wm2_ij, C["MB0"][:, None, ii, jjc])
    else:  # dangles == 1 (s_energy_matrix.cc:142-195)
        jm2v = iv2 + s - 2
        e_c = guarded_add(wm2_ij, C["MB0"][:, None, ii, jjc])
        wm2_ip1j = mmin(
            wm_g(iv2 + 2, cc - 1) + wmv_g(cc, jm1v),
            # quirk preserved: WMp(k-1, j-1) (s_energy_matrix.cc:254)
            wm_g(iv2 + 2, cc - 1) + wmp_g(cc - 1, jm1v),
            gm2 + wmp_g(cc, jm1v),
        )
        e_c = torch.minimum(e_c, guarded_add(wm2_ip1j, C["MB_5"][:, None, ii, jjc]))
        wm2_ijm1 = mmin(
            wm_g(iv2 + 1, cc - 1) + wmv_g(cc, jm2v),
            wm_g(iv2 + 1, cc - 1) + wmp_g(cc, jm2v),
            gm1 + wmp_g(cc, jm2v),
        )
        e_c = torch.minimum(e_c, guarded_add(wm2_ijm1, C["MB_3"][:, None, ii, jjc]))
        wm2_ip1jm1 = mmin(
            wm_g(iv2 + 2, cc - 1) + wmv_g(cc, jm2v),
            wm_g(iv2 + 2, cc - 1) + wmp_g(cc, jm2v),
            gm2 + wmp_g(cc, jm2v),
        )
        e_c = torch.minimum(e_c, guarded_add(wm2_ip1jm1, C["MB_53"][:, None, ii, jjc]))
    e_m = torch.where(ok2, e_c, INF).amin(dim=-2)

    # --- select & store (compute_energy min_rank; first-minimum wins) ------
    branches = torch.stack([e_h, e_i, e_m])
    vmin = branches.amin(dim=0)
    rank = torch.argmin(branches, dim=0)  # first minimum, as jnp.argmin
    is_set = vmin < INF // 2
    newV = torch.where(is_set, vmin, V_UNSET)
    newT = torch.where(is_set, rank + 1, 0).to(torch.int8)  # 1=H,2=I,3=M, 0=N

    Vt = st["Vtype"]
    write = row_valid & (jj > ii)
    V[:, ii, jjc] = torch.where(write, newV, V[:, ii, jjc])
    Vt[:, ii, jjc] = torch.where(write, newT, Vt[:, ii, jjc])
    return st


def compute_WMv_WMp_WM_span(C, st, s, dangles):
    """compute_WMv_WMp + compute_energy_WM for span s
    (s_energy_matrix.cc:206-241); no-op when span < 3 (j-i+1 < 4); in place."""
    n = C["n"]
    n2 = n + 2
    WM, WMv, WMp, P2 = st["WM"], st["WMv"], st["WMp"], st["P2"]
    dev = WM.device
    ii, jj = _diag_idx(n2, s, dev)
    jjc = jj.clamp(0, n2 - 1)
    jm1 = (jj - 1).clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (jj <= n) & (s >= 3)

    MLbase = C["MLbase"]
    psm_b = C["PSM"] + C["b"]

    stem = e_mlstem_diag(C, st, ii, jj, dangles)
    wmv_new = torch.minimum(stem, WMv[:, ii, jm1] + MLbase)
    # WMB argument is P.get(i,j) (W_final.cc:64): i<=j -> raw cell
    wmp_new = torch.minimum(P2[:, ii, jjc] + psm_b, WMp[:, ii, jm1] + MLbase)

    WMv[:, ii, jjc] = torch.where(row_valid, wmv_new, WMv[:, ii, jjc])
    WMp[:, ii, jjc] = torch.where(row_valid, wmp_new, WMp[:, ii, jjc])

    # ---- WM (compute_energy_WM, s_energy_matrix.cc:219-241) --------------
    # k = j-TURN-1 .. i  ->  g = k-i in [0, s-TURN-1]
    gg = torch.arange(n2, device=dev)[:, None]
    iv = ii[None, :]
    kk = iv + gg
    ok = (gg >= 0) & (gg <= s - TURN - 1) & (iv >= 1) & (iv + s <= n)
    kkc = kk.clamp(0, n2 - 1)
    jv = (iv + s).clamp(0, n2 - 1)
    gml = (gg * MLbase).to(torch.int32)
    wm_kj = e_mlstem_diag(C, st, kk, iv + s, dangles)
    wmb_kj = P2[:, kkc, jv] + psm_b
    wm_ikm1 = torch.where(iv >= kk - 1, INF,
                          WM[:, iv.clamp(0, n2 - 1), (kk - 1).clamp(0, n2 - 1)])
    m1 = torch.where(ok, gml + wm_kj, INF).amin(dim=-2)
    m2 = torch.where(ok, gml + wmb_kj, INF).amin(dim=-2)
    m3 = torch.where(ok, wm_ikm1 + wm_kj, INF).amin(dim=-2)
    m4 = torch.where(ok, wm_ikm1 + wmb_kj, INF).amin(dim=-2)
    m5 = WM[:, ii, jm1] + MLbase
    wm_new = mmin(m1, m2, m3, m4, m5)
    WM[:, ii, jjc] = torch.where(row_valid, wm_new, WM[:, ii, jjc])
    return st
