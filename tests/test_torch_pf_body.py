"""The partition function's span body (``ccj_tpu_torch/engine/pf_ops.py``:
``pf_span2d``, ``pf_assemble``, ``pf_store``; ``csrc/pfbody.cu`` on the card,
their plain versions here) and the span as a whole:

* per kernel: each plain version against the kernel's walk, restated cell
  by cell (``pf_span2d``: a row at a time, V's interior and multiloop sums,
  WBP / WPP's splits with the row's own new V and P2, the kept tables'
  cells, WM's splits; ``pf_assemble``: a valid cell at a time, the 13 plane
  reads with their bounds; ``pf_store``: each destination element), at
  n = 13 on random float64 operands, rtol 1e-12, every other cell of the
  state unchanged;
* the kept weight tables equal ``pf4d.pf_wx_tables`` of the state after
  every span of an n = 36 float64 fill;
* ``pf_span_step`` runs no aten op outside its seven kernel wrappers (a
  ``TorchDispatchMode`` over the span, the wrappers through ``kernels=``
  spies), and reorders soundly: the gapped step's kernels run on a state
  without the 2-D arrays, the 2-D part on one without the 4-D ones, and
  give the span's result;
* ``pf_store`` refuses a span whose C skews would need rows past IB.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ccj_tpu_torch.engine import pf4d, pf_ops
from ccj_tpu_torch.engine.gapped import C_MATS, M4_NAMES, dims
from ccj_tpu_torch.engine.gapped4 import LOOP_MATS, bucket_dims
from ccj_tpu_torch.params import DEFAULT_PK

from test_pf_device import _setup
from test_torch_pf_kernels import _body_consts, _random_state, _tt_operands

torch.set_num_threads(1)

NK = 13
RTOL = 1e-12
TURN, ML = 3, pf_ops.ML


def _valid(n, s, tt, i, j):
    return i >= 1 and j >= i and j + tt + 2 <= i + s and i + s <= n


def _np(d):
    return {k: v.numpy().copy() for k, v in d.items()}


# ---------------------------------------------------------------------------
# pf_span2d
# ---------------------------------------------------------------------------

def _span2d_walk(C, st, p_new, wx, n, s):
    """csrc/pfbody.cu's pf_span2d in Python: a row at a time, each sum in
    the kernel's terms (the block's order aside)."""
    n2 = n + 2
    a = _np({k: st[k] for k in pf_ops.PF_2D})
    w = _np(wx)
    c = {k: v.numpy() for k, v in C.items()}
    sc = {k: float(C[k]) for k in pf_ops.PF_SPAN2D_SCALARS}
    V, VD, P2, PD = a["V"], a["VD"], a["P2"], a["PD"]
    mlb = c["expMLbase"]
    for i in range(n2):
        l = i + s
        if i < 1 or l > n:
            VD[s, i] = PD[s, i] = 0.0
            continue
        interior = sum(c["EINTD"][dk, dl, i, s] * VD[s - dk - dl, i + dk]
                       for dk in range(1, min(s - TURN - 1, ML) + 1)
                       for dl in range(1, min(s - TURN - 1, ML + 2) - dk + 1)
                       if i + dk <= n2 - 1)
        vm = sum(a["WM"][i + 1, cc - 1] * (a["WMv"][cc, l - 1] + a["WMp"][cc, l - 1])
                 + mlb[cc - i - 1] * a["WMp"][cc, l - 1] for cc in range(i + 1, l - TURN))
        V[i, l] = VD[s, i] = c["HD"][i, s] + interior + vm * c["expMB"][i, l] * sc["scale2"]
        P2[i, l] = PD[s, i] = p_new[i]
        sums = np.zeros(4)
        for g in range(s):
            dd = i + g
            wb, wp = w["WB"][i, dd - 1], w["WP"][i, dd - 1]
            sums += (wb * V[dd, l], wb * P2[dd, l], wp * V[dd, l], wp * P2[dd, l])
        b3 = a["WBP"][i, l - 1] * c["expcp"][1] if s >= 1 else 0.0
        c3 = a["WPP"][i, l - 1] * c["expPUP"][1] if s >= 1 else 0.0
        a["WBP"][i, l] = (sums[0] * sc["expbp"] * sc["expPPS"]
                          + sums[1] * sc["expPSM"] * sc["expPPS"] + b3)
        a["WPP"][i, l] = sums[2] * sc["expPPS"] + sums[3] * sc["expPSP"] * sc["expPPS"] + c3
        u = min(s + 1, n2 - 1)
        w["WB"][i, l] = c["expcp"][u] + a["WBP"][i, l]
        w["WP"][i, l] = c["expPUP"][u] + a["WPP"][i, l]
        w["WBPg"][i, l] = a["WBP"][i, l]
        if s < 3:
            continue
        tot = sum((mlb[k - i] + (a["WM"][i, k - 1] if k - 1 >= i else 0.0))
                  * (V[k, l] * c["expML"][k, l] + P2[k, l] * sc["expPSM"] * sc["expb"])
                  for k in range(i, l - TURN))
        a["WMv"][i, l] = V[i, l] * c["expML"][i, l] + a["WMv"][i, l - 1] * mlb[1]
        a["WMp"][i, l] = P2[i, l] * sc["expPSM"] * sc["expb"] + a["WMp"][i, l - 1] * mlb[1]
        a["WM"][i, l] = tot + a["WM"][i, l - 1] * mlb[1]
    return a, w


@pytest.mark.parametrize("s", [0, 1, 2, 3, 5, 9, NK - 2, NK - 1])
def test_span2d_ref_matches_the_kernel_walk(s):
    rng = np.random.default_rng(400 + s)
    n2 = NK + 2
    st = pf4d.pf_state_from_numpy(_random_state(NK, 40 + s), "cpu")
    C = _body_consts(NK, rng)
    wx = {k: torch.from_numpy(rng.random((n2, n2))) for k in pf_ops.PF_TABLES}
    p_new = torch.from_numpy(rng.random(n2))
    want, want_wx = _span2d_walk(C, st, p_new.numpy(), wx, NK, s)
    before = _np(st)
    assert pf_ops.pf_span2d(C, st, p_new, wx, n=NK, s=s) is None
    for k in pf_ops.PF_2D:
        np.testing.assert_allclose(st[k].numpy(), want[k], rtol=RTOL, atol=0, err_msg=k)
    for k in pf_ops.PF_TABLES:
        np.testing.assert_allclose(wx[k].numpy(), want_wx[k], rtol=RTOL, atol=0, err_msg=k)
    for k, v in before.items():                   # the 4-D state is not touched
        if k not in pf_ops.PF_2D:
            np.testing.assert_array_equal(st[k].numpy(), v, err_msg=k)
    changed = (st["V"].numpy() != before["V"]).sum()
    assert changed == NK - s                      # one cell a live row


# ---------------------------------------------------------------------------
# pf_assemble
# ---------------------------------------------------------------------------

def _assemble_walk(C, st, hist, stn, n, s, TB, IB):
    """csrc/pfbody.cu's pf_assemble in Python: [8, TB, IB, n2], a valid
    cell at a time (0 elsewhere)."""
    n2, T, S, U = dims(n)
    a = {name: st[name].numpy() for name, *_ in pf_ops.PF_PLANE_READS}
    h, sn = hist.numpy(), stn.numpy()
    estp, canp, pt = C["expESTP"].numpy(), C["can_pair"].numpy(), C["ptype"].numpy()
    ap, bp, PB = float(C["expap"]), float(C["expbp"]), float(C["expPB"])
    cp1 = float(C["expcp"][1])
    reads = pf_ops.PF_PLANE_READS
    out = np.zeros((8, TB, IB, n2))

    def plane(q, tt, i, j):
        name, c, b, di, dj = reads[q]
        t, sp, r, col = tt + c, s - b, i + di, j + dj
        if t >= T or sp < 0 or r >= n2 or col < 0 or col >= n2:
            return 0.0
        return a[name][t, sp, r, col]

    def family(q0, x, y, acc, tt, i, j, b3_ok):
        if pt[x, y] <= 0:
            return 0.0
        iloop = plane(q0, tt, i, j) * estp[x, y] + acc if canp[x, y] else 0.0
        ml = (plane(q0 + 1, tt, i, j) + plane(q0 + 2, tt, i, j)) * ap * bp * bp
        return iloop + ml + (plane(q0 + 3, tt, i, j) if b3_ok else 0.0)

    for tt in range(TB):
        for i in range(IB):
            for j in range(n2):
                if not _valid(n, s, tt, i, j):
                    continue
                k, l = j + tt + 2, i + s
                PL = family(0, i, j, sn[0, tt, i, j], tt, i, j, j >= i + TURN + 1)
                PR = family(4, k, l, sn[1, tt, i, j], tt, i, j, l >= k + TURN + 1)
                PO = family(8, i, l, sn[2, tt, i, j], tt, i, j, l >= i + TURN + 1)
                hv = h[:, tt, i, j]
                out[:, tt, i, j] = (PL, PR, PO, PO * bp + hv[0] + hv[1], hv[3] + hv[4],
                                    plane(12, tt, i, j) * cp1 + hv[5],
                                    hv[6] + hv[7] + (PL + PR) * PB, hv[12] + hv[13])
    return out


@pytest.mark.parametrize("s", [0, 1, 2, 4, 8, NK - 1])
def test_assemble_ref_matches_the_kernel_walk(s):
    rng = np.random.default_rng(500 + s)
    n2 = NK + 2
    TB, IB = bucket_dims(NK, s)
    st = pf4d.pf_state_from_numpy(_random_state(NK, 50 + s), "cpu")
    C, *_ = _tt_operands(NK, s, rng)
    hist = torch.from_numpy(rng.random((len(pf_ops.PF_HISTORY), TB, IB, n2)))
    stn = torch.from_numpy(rng.random((len(pf_ops.PF_STENCILS), TB, IB, n2)))
    fams, bases = pf_ops.pf_assemble(C, st, hist, stn, n=NK, s=s, TB=TB, IB=IB)
    want = _assemble_walk(C, st, hist, stn, NK, s, TB, IB)
    assert set(fams) == set(pf_ops.PF_STORED)
    assert set(bases) == set(pf_ops.PF_BASES)
    for q, k in enumerate(pf_ops.PF_ASSEMBLED):
        np.testing.assert_allclose(fams[k].numpy(), want[q], rtol=RTOL, atol=0, err_msg=k)
    np.testing.assert_allclose(bases["PMmloop10"].numpy(), want[7], rtol=RTOL, atol=0)
    assert torch.equal(fams["POmloop01"], hist[2])
    for k, q in pf_ops.PF_HISTORY_BASES.items():
        assert torch.equal(bases[k], hist[q]), k
    assert (want != 0).any() == (s >= 2)


# ---------------------------------------------------------------------------
# pf_store
# ---------------------------------------------------------------------------

def _store_walk(st, loops, fams, n, s, TB, IB):
    """csrc/pfbody.cu's pf_store in Python: every destination element from
    its source cell (the slab's valid cells; 0 elsewhere)."""
    n2, T, S, U = dims(n)
    out = _np(st)
    src = {k: loops[LOOP_MATS.index(k)].numpy() if k in LOOP_MATS else fams[k].numpy()
           for k in M4_NAMES}

    def val(name, tt, i, j):
        ok = tt < TB and 0 <= i < IB and j < n2 and _valid(n, s, tt, i, j)
        return src[name][tt, i, j] if ok else 0.0

    for tt in range(T):
        for r in range(n2):
            for c in range(n2):
                if tt < TB:
                    for name in M4_NAMES:
                        out[name][tt, s, r, c] = val(name, tt, r, c)
                    for name in C_MATS:
                        out["C_" + name][tt, s, r, c] = val(name, tt, r - s, c)
                out["PKD"][tt, s, r, c] = val("PK", tt, r, r + c)
                if tt <= s:
                    out["PKE"][tt, s - tt, r, c] = out["PKD"][tt, s, r, c]
    return out


@pytest.mark.parametrize("s", [0, 1, 2, 5, NK - 2, NK - 1])
def test_store_ref_matches_the_kernel_walk(s):
    rng = np.random.default_rng(600 + s)
    n2 = NK + 2
    TB, IB = bucket_dims(NK, s)
    st = pf4d.pf_state_from_numpy(_random_state(NK, 60 + s), "cpu")
    loops = torch.from_numpy(rng.random((len(LOOP_MATS), TB + 2, IB, n2)))
    fams = {k: torch.from_numpy(rng.random((TB, IB, n2))) for k in pf_ops.PF_STORED}
    want = _store_walk(st, loops, fams, NK, s, TB, IB)
    assert pf_ops.pf_store(st, loops, fams, n=NK, s=s, TB=TB, IB=IB) is None
    for k, v in want.items():                     # every other cell unchanged
        np.testing.assert_array_equal(st[k].numpy(), v, err_msg=k)


def test_store_refuses_a_span_past_its_rows():
    n, s = NK, 5
    n2 = n + 2
    TB, IB = bucket_dims(n, s)
    st = pf4d.pf_state_from_numpy(_random_state(n, 1), "cpu")
    loops = torch.zeros((len(LOOP_MATS), TB + 2, n2 - s - 1, n2), dtype=torch.float64)
    fams = {k: torch.zeros((TB, n2 - s - 1, n2), dtype=torch.float64) for k in pf_ops.PF_STORED}
    with pytest.raises(ValueError, match="IB"):            # C skews' rows past the slab
        pf_ops.pf_store(st, loops, fams, n=n, s=s, TB=TB, IB=n2 - s - 1)
    fams = {k: torch.zeros((TB, IB, n2), dtype=torch.float64) for k in pf_ops.PF_STORED}
    with pytest.raises(ValueError, match="fams"):
        pf_ops.pf_store(st, loops, {k: v for k, v in fams.items() if k != "PL"},
                        n=n, s=s, TB=TB, IB=IB)


# ---------------------------------------------------------------------------
# the span as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def consts13():
    sp, tabs = _setup("GGGAAACGGGCGA")
    return pf4d.pfc_from_numpy(pf4d.pfc_numpy(tabs, sp, DEFAULT_PK)[0], "cpu", torch.float64)


def test_kept_tables_match_wx_after_every_span():
    """A float64 fill at n = 36 keeps WB / WP / WBPg across spans (built once,
    their span-s cells written by ``pf_span2d``): after every span they equal
    ``pf_wx_tables`` of the state, bit for bit."""
    seq = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUU"
    n = len(seq)
    sp, tabs = _setup(seq)
    C = pf4d.pfc_from_numpy(pf4d.pfc_numpy(tabs, sp, DEFAULT_PK)[0], "cpu", torch.float64)
    st = pf4d.init_pf_state(n, torch.float64, "cpu")
    wx = pf4d.pf_wx_tables(C, st, n)
    for s in range(n):
        TB, IB = bucket_dims(n, s)
        pf4d.pf_span_step(C, st, s, n=n, TB=TB, IB=IB, wx=wx)
        fresh = pf4d.pf_wx_tables(C, st, n)
        for k in pf_ops.PF_TABLES:
            assert torch.equal(wx[k], fresh[k]), (s, k)
    assert float(st["WBP"].max()) > 0 and float(st["V"].max()) > 0


class _OpCount(TorchDispatchMode):
    """Records every aten op, as run inside a kernel wrapper or outside."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.inside = 0
        self.outside = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth:
            self.inside += 1
        else:
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("s", [0, 1, 7, NK - 1])
def test_span_runs_only_its_kernel_wrappers(consts13, s):
    """Outside its seven kernel wrappers a span of ``pf_span_step`` (with
    the fill's kept tables) runs no aten op, not even an allocation: each
    wrapper allocates its own outputs.  Each is called once, through the
    ``kernels=`` spies."""
    from types import SimpleNamespace

    TB, IB = bucket_dims(NK, s)
    st = pf4d.pf_state_from_numpy(_random_state(NK, 70 + s), "cpu")
    wx = pf4d.pf_wx_tables(consts13, st, NK)
    mode, seen = _OpCount(), []

    def spy(name):
        def call(*args, **kw):
            seen.append(name)
            mode.depth += 1
            try:
                return getattr(pf_ops, name)(*args, **kw)
            finally:
                mode.depth -= 1
        return call
    kernels = SimpleNamespace(**{k: spy(k) for k in pf_ops.PF_KERNELS})
    with mode:
        pf4d.pf_span_step(consts13, st, s, n=NK, TB=TB, IB=IB, kernels=kernels, wx=wx)
    assert sorted(seen) == sorted(pf_ops.PF_KERNELS)
    assert mode.inside > 0
    assert mode.outside == []


@pytest.mark.parametrize("s", [2, 7, NK - 1])
def test_span_reorders_soundly(consts13, s):
    """The 2-D part (``pf_span2d``, with WM) runs before the gapped step:
    the step's kernels run on a state without V, VD, P2, PD, WM, WMv, WMp,
    the P split and the 2-D part on one without the other arrays, and the
    span's result is the same."""
    TB, IB = bucket_dims(NK, s)
    kw = {"n": NK, "s": s, "TB": TB, "IB": IB}
    st_np = _random_state(NK, 80 + s)
    want = pf4d.pf_state_from_numpy(st_np, "cpu")
    pf4d.pf_span_step(consts13, want, s, n=NK, TB=TB, IB=IB)

    st = pf4d.pf_state_from_numpy(st_np, "cpu")
    C = consts13
    wx = pf4d.pf_wx_tables(C, st, NK)
    two_d = {k: st[k] for k in pf_ops.PF_2D}
    gapped = {k: v for k, v in st.items() if k not in pf_ops.PF_2D}
    p_new = pf_ops.pf_p_split(gapped["PKE"], gapped["PKD"], n=NK, s=s)
    pf_ops.pf_span2d(C, two_d, p_new, wx, n=NK, s=s)
    hist = pf_ops.pf_history(gapped, wx["WB"], wx["WP"], wx["WBPg"], **kw)
    stn = pf_ops.pf_stencil(gapped, C["W4PL"], C["W4PR"], C["W4POD"], **kw)
    fams, bases = pf_ops.pf_assemble(C, gapped, hist, stn, **kw)
    loops = pf_ops.pf_tt_span(C, wx["WB"], wx["WP"], wx["WBPg"], fams["PL"], fams["PR"],
                              fams["PO"], bases, **kw)
    pf_ops.pf_store(gapped, loops, fams, **kw)
    for k, v in want.items():
        assert torch.equal(st[k], v), k
