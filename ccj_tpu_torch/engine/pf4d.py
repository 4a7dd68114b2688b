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
kernel.  Here a span is seven hand-written kernels (``engine/pf_ops.py``;
``csrc/pfspan.cu``, ``csrc/pfbody.cu``), each at most one launch a span on
CUDA and its plain version on the CPU: the P split (``pf_p_split``), the
2-D recurrences V, P2, WBP / WPP and WM with the kept weight tables'
span-s cells (``pf_span2d``), the 16 history sums (``pf_history``), the
PL / PR / PO interior stencils (``pf_stencil``), the plane reads and the
assembly (``pf_assemble``), the serial tt loop (``pf_tt_span``) and the
write-back (``pf_store``).  The weight tables WB / WP / WBPg are built
once a fill (:func:`pf_wx_tables`) and kept.  Each span updates the state
in place, every write after the last read of what it overwrites.

Reference recurrences: src/part_func.cc:152-178 and pseudo_loop.cc; the
branch-by-branch citations live in ``ccj_tpu/engine/gapped.py`` / pf.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..params.io_par import MAXLOOP, TURN
from . import pf_ops
from .gapped import C_MATS, DS, M4_NAMES, dims
from .gapped4 import bucket_dims
from .pf import PFTables
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


def pf_wx_tables(C, st, n):
    """The gapped step's WB / WP / raw-WBP lookup tables (host pf.py
    WB()/WP()) from the state's WBP / WPP: {"WB", "WP", "WBPg"}, each
    [n2, n2].  A fill builds them once and keeps them; ``pf_span2d``
    writes their span-s cells (i, i + s) by the same rule.  (The JAX
    ``_wx_pf``'s raw-WPP table has no reader and is not built.)"""
    n2 = n + 2
    dev = st["WBP"].device
    a = torch.arange(n2, device=dev)[:, None]
    b = torch.arange(n2, device=dev)[None, :]
    inb = (a >= 1) & (b >= 1) & (a <= n) & (b <= n)

    def wx(raw, unit):
        base = unit[(b - a + 1).clamp(0, n2 - 1)] + raw
        return torch.where(inb, torch.where(a > b, 1.0, base), 0.0)

    return {"WB": wx(st["WBP"], C["expcp"]), "WP": wx(st["WPP"], C["expPUP"]),
            "WBPg": torch.where(inb & (a <= b), st["WBP"], 0.0)}


def pf_span_step(C, st, s, n: int, TB: int, IB: int, kernels=None, wx=None):
    """One whole span of the device PF fill, in place: seven kernel
    wrappers of ``pf_ops`` and their output allocations, nothing else.
    ``wx``: the kept weight tables (:func:`pf_wx_tables`), whose span-s
    cells the span writes; built here from ``st`` when None.  ``kernels``:
    what the span calls its kernel wrappers through, by their names in
    ``pf_ops`` (:data:`pf_ops.PF_KERNELS`); ``pf_ops`` itself when None.

    The 2-D recurrences (``pf_span2d``: V, P2, WBP / WPP, the tables, WM)
    run before the gapped step, which reads none of V, VD, P2, PD, WM,
    WMv, WMp; the write-back (``pf_store``) runs after the last read of
    the state."""
    kernels = pf_ops if kernels is None else kernels
    if wx is None:
        wx = pf_wx_tables(C, st, n)
    kw = {"n": n, "s": s, "TB": TB, "IB": IB}
    p_new = kernels.pf_p_split(st["PKE"], st["PKD"], n=n, s=s)
    kernels.pf_span2d(C, st, p_new, wx, n=n, s=s)
    hist = kernels.pf_history(st, wx["WB"], wx["WP"], wx["WBPg"], **kw)
    stn = kernels.pf_stencil(st, C["W4PL"], C["W4PR"], C["W4POD"], **kw)
    fams, bases = kernels.pf_assemble(C, st, hist, stn, **kw)
    loops = kernels.pf_tt_span(C, wx["WB"], wx["WP"], wx["WBPg"], fams["PL"], fams["PR"],
                               fams["PO"], bases, **kw)
    kernels.pf_store(st, loops, fams, **kw)
    return st


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
    wx = pf_wx_tables(C, st, n)
    for s in range(n):
        TB, IB = bucket_dims(n, s)
        pf_span_step(C, st, s, n=n, TB=TB, IB=IB, wx=wx)
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
