"""Fold driver: the dense span-wavefront fill producing all DP matrices
(PyTorch).

Counterpart of the dense path of ``ccj_tpu/engine/fold.py`` (``fill6``):
mirrors W_final::ccj's fill loop (reference: src/W_final.cc:58-77) in span
order as a Python loop over spans on one device; the exterior W pass and
traceback run on the host (engine/traceback.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params.pk import PKPenalties
from ..params.scaling import ScaledParams
from ..precompute import SeqTables
from .common import INF, SAT16, TRI_UNSET, V_UNSET
from .gapped import M4_NAMES, compute_WBP_WPP_span
from .gapped3 import compute_P_span3
from .gapped4 import bucket_dims, build_sc4, init_big_state4, span_gapped4
from .nested import compute_V_span, compute_WMv_WMp_WM_span

# Largest n the dense engine folds.  The dense state (22 families, 5 C-skews
# and PKD as [T, S, n2, n2] int16, plus PKE [T, S+T+2, n2, n2]) is 16.5 GB at
# n = 128 by arithmetic, which one 80 GB H100 holds with room for the span
# phase's temporaries.  Longer sequences need packed storage (ROADMAP).
DENSE_MAX_N = 128

# scalar constants of the fill: Python ints on the port's side
SCALAR_KEYS = ("n", "MLbase", "PSM", "PSP", "PB", "PUP", "PPS",
               "b", "bp", "cp", "ap")
# host-side state keys the traceback reads (engine/traceback.py)
TRACEBACK_KEYS = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP",
                  *M4_NAMES)


def build_consts(tabs: SeqTables, P: ScaledParams, pk: PKPenalties):
    """Host (numpy) constant dict of the fill: the same keys and values as
    ``ccj_tpu.engine.fold.build_consts(..., device=False)``."""
    C = {
        "n": tabs.n,
        "ptype": tabs.ptype,
        "can_pair": tabs.can_pair,
        "H": tabs.H,
        "EINT": tabs.EINT,
        "EINTP": tabs.EINTP,
        "ESTP": tabs.ESTP,
        "MLbase": P.MLbase,
        "PSM": pk.PSM,
        "PSP": pk.PSP,
        "PB": pk.PB,
        "PUP": pk.PUP,
        "PPS": pk.PPS,
        "b": pk.b,
        "bp": pk.bp,
        "cp": pk.cp,
        "ap": pk.ap,
    }
    for name in ("ML0", "ML2", "ML_ip1", "ML_jm1", "ML_both",
                 "MB0", "MB2", "MB_5", "MB_3", "MB_53"):
        C[name] = getattr(tabs, name)
    return C


def consts_from_numpy(C_np, device, sc4_np=None):
    """Carry a host constant dict across to the port: returns (C, SC4).

    ``C_np`` is the dict ``build_consts`` returns here or in the JAX package
    (``ccj_tpu.engine.fold.build_consts(..., device=False)``; its arrays
    are copied with ``np.array``).  Scalars become Python ints and tables
    tensors on ``device``.  ``sc4_np`` (the arrays of the JAX package's
    ``gapped4.build_sc4``) gives the stencil weight tables; without it they
    are built on ``device`` by this package's ``gapped4.build_sc4``.  Fed
    the same host dicts, both packages fill from identical tables.
    """
    C = {}
    for k, v in C_np.items():
        if k in SCALAR_KEYS:
            C[k] = int(v)
        else:
            C[k] = torch.as_tensor(np.array(v), device=device)
    if sc4_np is None:
        SC4 = build_sc4(C["EINTP"], C["can_pair"], C["n"])
    else:
        SC4 = {k: torch.as_tensor(np.array(v), device=device)
               for k, v in sc4_np.items()}
    return C, SC4


def init_state_2d(n: int, device):
    """The 2-D triangle matrices (int32; V with its getter semantics baked
    in: INF on i>=j, nodes default elsewhere)."""
    n2 = n + 2
    ii = torch.arange(n2, device=device)[:, None]
    jj = torch.arange(n2, device=device)[None, :]

    def tri():
        return torch.full((n2, n2), TRI_UNSET, dtype=torch.int32, device=device)

    return {
        "V": torch.where(ii < jj, V_UNSET, INF).to(torch.int32),
        "Vtype": torch.zeros((n2, n2), dtype=torch.int8, device=device),
        "WM": tri(), "WMv": tri(), "WMp": tri(),
        "P2": tri(), "WBP": tri(), "WPP": tri(),
    }


def init_state(n: int, device):
    st = init_state_2d(n, device)
    n2 = n + 2
    T = max(n - 1, 1)
    S = max(n, 1)
    for name in M4_NAMES:
        st[name] = torch.full((T, S, n2, n2), SAT16, dtype=torch.int16,
                              device=device)
    return st


def bucket_segments(n: int):
    """Consecutive span ranges sharing one (TB, IB) bucket."""
    segs = []
    for s in range(n):
        b = bucket_dims(n, s)
        if segs and segs[-1][0] == b:
            segs[-1] = (b, segs[-1][1], s + 1)
        else:
            segs.append((b, s, s + 1))
    return segs


@torch.inference_mode()
def fill6(C, SC4, n: int, dangles: int):
    """The whole dense fill on the device of ``C``'s tables: the
    ``fill6_whole`` loop of the JAX package as a Python loop over spans,
    each span updating the state in place.  Returns the state dict."""
    device = C["H"].device
    C = {**C, "n": n}
    st = init_state(n, device)
    st.update(init_big_state4(n, device))
    for (TB, IB), lo, hi in bucket_segments(n):
        for s in range(lo, hi):
            compute_V_span(C, st, s, dangles)
            compute_P_span3(C, st, s)
            compute_WBP_WPP_span(C, st, s)
            span_gapped4(C, SC4, st, s, TB, IB)
            compute_WMv_WMp_WM_span(C, st, s, dangles)
    return st


def run_fill(tabs: SeqTables, P: ScaledParams, pk: PKPenalties, device):
    """Run the dense fill on ``device`` and return the arrays the traceback
    reads (``TRACEBACK_KEYS``) as host numpy arrays; :func:`fill6` gives the
    whole state, on the device."""
    C, SC4 = consts_from_numpy(build_consts(tabs, P, pk), device)
    st = fill6(C, SC4, tabs.n, P.dangles)
    return {k: st[k].cpu().numpy() for k in TRACEBACK_KEYS}
