"""The min-plus window reduction's plain PyTorch version equals the Pallas
kernel it replaces (interpret mode) and a numpy restatement of the tt
loop's red_k / red_j; exact (integer data, tolerance zero).  So does the
grouped form the tt loop launches once per step (one descriptor table per
span, evaluated at tt).  The CUDA kernel itself is held against this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccj_tpu.engine.pallas_ops import minplus_suffix as pallas_minplus_suffix
from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine.common import INF
from ccj_tpu_torch.engine.ttloop import REDUCTIONS, reduction_table


def _inputs(shape, seed=0):
    """The random slab / weights of tests/test_pallas_ops.py."""
    rng = np.random.default_rng(seed)
    T, I, J = shape
    slab = rng.integers(-30000, 32767, size=shape).astype(np.int32)
    slab[rng.random(shape) < 0.3] = INF          # INF-encoded invalid cells
    w = rng.integers(-5000, 5000, size=(T, J)).astype(np.int32)
    w[rng.random((T, J)) < 0.3] = INF            # folded masks
    return slab, w


@pytest.mark.parametrize("shape", [(7, 5, 9), (16, 8, 128), (23, 13, 150)])
@pytest.mark.parametrize("lo", [-1, 0, 5])
def test_minplus_suffix_ref_matches_pallas(shape, lo):
    slab, w = _inputs(shape)
    want = np.asarray(pallas_minplus_suffix(jnp.asarray(slab), jnp.asarray(w),
                                            jnp.int32(lo), interpret=True))
    got = cuda_ops.minplus_suffix_ref(torch.from_numpy(slab),
                                      torch.from_numpy(w), lo)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = cuda_ops.LAUNCHES
    got2 = cuda_ops.minplus_suffix(torch.from_numpy(slab), torch.from_numpy(w), lo)
    np.testing.assert_array_equal(got2.numpy(), want)
    assert cuda_ops.LAUNCHES == before


def _np_red(slab, w, row0, col0, mode, c):
    """numpy restatement of ttloop.run_tt_loop_unstacked's red_k (row0 =
    tt+1, col0 = 0, mode 1: q <= c - j + i) and red_j (row0 = tt+1,
    col0 = tt, mode 2: q <= j - i - c), capped at INF: every consumer
    clamps through enc(), so a value above INF and INF store alike."""
    Q, J = w.shape
    I = slab.shape[1]
    rows = slab[row0:row0 + Q, :, col0:col0 + J].astype(np.int64)
    vals = rows + w[:, None, :]
    q = np.arange(Q)[:, None, None]
    i = np.arange(I)[None, :, None]
    j = np.arange(J)[None, None, :]
    if mode == 1:
        vals = np.where(q <= c - j + i, vals, INF)
    elif mode == 2:
        vals = np.where(q <= j - i - c, vals, INF)
    return np.minimum(vals.min(axis=0), INF)


# (TB, IB, n2, s, tt): bucketed span shapes of a fill, several tt per span
WINDOWS = [(16, 16, 18, 12, 10), (16, 16, 18, 12, 0), (32, 32, 34, 20, 7),
           (32, 64, 50, 30, 28), (64, 16, 66, 60, 3)]


@pytest.mark.parametrize("TB,IB,n2,s,tt", WINDOWS)
@pytest.mark.parametrize("masked", [False, True])
def test_window_ref_matches_red_k(TB, IB, n2, s, tt, masked):
    slab, _ = _inputs((2 * TB + 2, IB, n2), seed=tt)
    _, wk_full = _inputs((TB, 1, n2 + TB + 1), seed=s)
    wk = wk_full[:, tt + 2: tt + 2 + n2]          # the per-step view
    c = s - 4 - tt
    mode = 1 if masked else 0
    got = cuda_ops.minplus_window_ref(torch.from_numpy(slab),
                                      torch.from_numpy(wk_full)[:, tt + 2: tt + 2 + n2],
                                      tt + 1, 0, 0, mode, c)
    np.testing.assert_array_equal(got.numpy(), _np_red(slab, wk, tt + 1, 0, mode, c))


@pytest.mark.parametrize("TB,IB,n2,s,tt", WINDOWS)
@pytest.mark.parametrize("masked", [False, True])
def test_window_ref_matches_red_j(TB, IB, n2, s, tt, masked):
    slabB, wj = _inputs((2 * TB + 2, IB, n2 + TB), seed=tt + 100)
    wj = wj[:TB, :n2]
    mode = 2 if masked else 0
    got = cuda_ops.minplus_window_ref(torch.from_numpy(slabB),
                                      torch.from_numpy(wj), tt + 1, tt, 0, mode, 2)
    np.testing.assert_array_equal(got.numpy(), _np_red(slabB, wj, tt + 1, tt, mode, 2))


def test_window_ref_q_lo_and_empty():
    slab, w = _inputs((9, 4, 6))
    ts, tw = torch.from_numpy(slab), torch.from_numpy(w)
    got = cuda_ops.minplus_window_ref(ts, tw, 0, 0, q_lo=4)
    want = np.minimum((slab[4:].astype(np.int64) + w[4:, None, :]).min(axis=0), INF)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (cuda_ops.minplus_window_ref(ts, tw, 0, 0, q_lo=9) == INF).all()


@pytest.mark.parametrize("row0,col0", [(-1, 0), (1, 0), (0, 1), (0, -1)])
def test_window_leaving_the_slab_raises(row0, col0):
    slab = torch.zeros((8, 3, 5), dtype=torch.int32)
    w = torch.zeros((8, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_ops.minplus_window(slab, w, row0, col0)


def test_window_rejects_non_int32():
    with pytest.raises(TypeError):
        cuda_ops.minplus_window(torch.zeros((4, 2, 3), dtype=torch.int16),
                                torch.zeros((4, 3), dtype=torch.int32), 0)


# ---------------------------------------------------------------------------
# The grouped form: one descriptor table per span, one launch per tt step.
# ---------------------------------------------------------------------------

def _span_operands(TB, IB, n2, seed, rows=None, colsB=None, colsK=None):
    """Random slabs and weight tables in the shapes run_tt_loop gives the
    step's REDUCTIONS (A slabs [2TB+2, IB, n2], B slabs [2TB+2, IB, n2+TB],
    WKX [TB, n2+TB+1], WJX [TB, n2]); ``rows`` / ``colsB`` / ``colsK``
    override the slab rows, the B slabs' columns and WKX's columns."""
    rows = 2 * TB + 2 if rows is None else rows
    colsB = n2 + TB if colsB is None else colsB
    colsK = n2 + TB + 1 if colsK is None else colsK
    slabs = {}
    for k, (name, *_) in enumerate(REDUCTIONS):
        if name not in slabs:
            cols = colsB if name.startswith("B_") else n2
            slabs[name] = _inputs((rows, IB, cols), seed=seed + k)[0]
    WKX = {nm: _inputs((TB, 1, colsK), seed=seed + 50 + k)[1]
           for k, nm in enumerate(("WP", "WB", "WBP"))}
    WJX = {nm: _inputs((TB, 1, n2), seed=seed + 60 + k)[1]
           for k, nm in enumerate(("WP", "WB", "WBP"))}
    return slabs, WKX, WJX


def _torch_all(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("TB,IB,n2,s,tt", WINDOWS)
def test_group_ref_matches_red_k_and_red_j(TB, IB, n2, s, tt):
    slabs, WKX, WJX = _span_operands(TB, IB, n2, seed=s)
    table = reduction_table(_torch_all(slabs), _torch_all(WKX), _torch_all(WJX),
                            s, n2)
    assert table.shape == (13, IB, n2) and table.Q == TB
    assert sum(m for *_, m in REDUCTIONS) == 7           # masked windows
    for t in sorted({0, tt, s - 2}):
        got = cuda_ops.minplus_group_ref(table, t).numpy()
        for g, (name, wn, kind, masked) in enumerate(REDUCTIONS):
            if kind == "k":
                want = _np_red(slabs[name], WKX[wn][:, t + 2: t + 2 + n2],
                               t + 1, 0, 1 if masked else 0, s - 4 - t)
            else:
                want = _np_red(slabs[name], WJX[wn], t + 1, t,
                               2 if masked else 0, 2)
            np.testing.assert_array_equal(got[g], want, err_msg=f"window {g} tt={t}")
        # the wrapper takes the plain version for CPU tensors, in place
        before = (cuda_ops.LAUNCHES, cuda_ops.WINDOWS)
        out = torch.empty(table.shape, dtype=torch.int32)
        assert cuda_ops.minplus_group(table, t, out) is out
        np.testing.assert_array_equal(out.numpy(), got)
        assert (cuda_ops.LAUNCHES, cuda_ops.WINDOWS) == before


def test_group_of_suffix_windows_matches_pallas():
    """Suffix windows (Pallas minplus_suffix's function) grouped in one
    table, and the unmasked red_k / red_j windows of a real span group,
    each equal the Pallas kernel in interpret mode on its window."""
    def pallas(slab, w, lo):
        return np.asarray(pallas_minplus_suffix(jnp.asarray(np.ascontiguousarray(slab)),
                                                jnp.asarray(np.ascontiguousarray(w)),
                                                jnp.int32(lo), interpret=True))

    los = (-1, 0, 5)
    ins = [_inputs((16, 8, 128), seed=k) for k in range(len(los))]
    table = cuda_ops.WindowTable(
        [cuda_ops.WindowSpec(torch.from_numpy(sl), torch.from_numpy(w), (0, 0),
                             q_lo=max(lo + 1, 0)) for (sl, w), lo in zip(ins, los)],
        128, (0, 0))
    got = cuda_ops.minplus_group_ref(table, 0).numpy()
    for g, ((sl, w), lo) in enumerate(zip(ins, los)):
        np.testing.assert_array_equal(got[g], pallas(sl, w, lo))

    TB, IB, n2, s, tt = WINDOWS[0]
    slabs, WKX, WJX = _span_operands(TB, IB, n2, seed=7)
    table = reduction_table(_torch_all(slabs), _torch_all(WKX), _torch_all(WJX),
                            s, n2)
    got = cuda_ops.minplus_group_ref(table, tt).numpy()
    for g, (name, wn, kind, masked) in enumerate(REDUCTIONS):
        if masked:
            continue
        if kind == "k":
            sl = slabs[name][tt + 1: tt + 1 + TB]
            w = WKX[wn][:, tt + 2: tt + 2 + n2]
        else:
            sl = slabs[name][tt + 1: tt + 1 + TB, :, tt: tt + n2]
            w = WJX[wn]
        np.testing.assert_array_equal(got[g], pallas(sl, w, -1), err_msg=f"window {g}")


# (TB, IB, n2, s) and an operand too small for the last step tt = s - 2
@pytest.mark.parametrize("field", ["rows", "colsB", "colsK"])
def test_table_leaving_its_slab_at_the_last_step_raises(field):
    TB, IB, n2, s = 16, 8, 18, 12
    short = {"rows": TB + s - 2, "colsB": n2 + s - 3, "colsK": n2 + s - 1}
    ok = {"rows": TB + s - 1, "colsB": n2 + s - 2, "colsK": n2 + s}
    for sizes, raises in ((ok, False), ({**ok, field: short[field]}, True)):
        slabs, WKX, WJX = _span_operands(TB, IB, n2, seed=1, **sizes)
        args = (_torch_all(slabs), _torch_all(WKX), _torch_all(WJX), s, n2)
        if raises:
            with pytest.raises(ValueError, match="leave"):
                reduction_table(*args)
        else:
            reduction_table(*args)


@pytest.mark.parametrize("spec", [
    dict(col0=(-1, 1)),                  # slab column -1 at tt = 0
    dict(row0=(-1, 1)),                  # slab row -1 at tt = 0
    dict(wcol=(-1, 1)),                  # weight column -1 at tt = 0
])
def test_table_leaving_its_slab_at_the_first_step_raises(spec):
    slab = torch.zeros((40, 3, 30), dtype=torch.int32)
    w = torch.zeros((8, 30), dtype=torch.int32)
    win = {"slab": slab, "w": w, "row0": (0, 1), **spec}
    cuda_ops.WindowTable([cuda_ops.WindowSpec(**{**win, **{k: (0, 1) for k in spec}})],
                         16, (0, 5))
    with pytest.raises(ValueError, match="leave"):
        cuda_ops.WindowTable([cuda_ops.WindowSpec(**win)], 16, (0, 5))


def test_group_checks_tt_out_and_size():
    slab = torch.zeros((20, 3, 10), dtype=torch.int32)
    w = torch.zeros((8, 10), dtype=torch.int32)
    table = cuda_ops.WindowTable([cuda_ops.WindowSpec(slab, w, (1, 1))] * 2, 10, (0, 4))
    out = torch.empty(table.shape, dtype=torch.int32)
    for tt in (-1, 5):
        with pytest.raises(ValueError, match="range"):
            cuda_ops.minplus_group(table, tt, out)
    for bad in (torch.empty((1, 3, 10), dtype=torch.int32),
                torch.empty((2, 3, 10), dtype=torch.int64),
                torch.empty((2, 10, 3), dtype=torch.int32).transpose(1, 2)):
        with pytest.raises(ValueError, match="out"):
            cuda_ops.minplus_group(table, 0, bad)
    with pytest.raises(ValueError, match="windows"):
        cuda_ops.WindowTable([cuda_ops.WindowSpec(slab, w, (1, 1))] * 17, 10, (0, 4))
    with pytest.raises(ValueError, match="share"):
        cuda_ops.WindowTable([cuda_ops.WindowSpec(slab, w, (1, 1)),
                              cuda_ops.WindowSpec(slab, w[:4], (1, 1))], 10, (0, 4))
    # the ctypes descriptor mirrors csrc/minplus.cu's struct Window (128 B)
    assert ctypes.sizeof(cuda_ops.Window) == 128


def test_reduction_table_pairs_windows_that_share_a_slab_window():
    """The two windows on B_PLmloop00 and the two on PRmloop00 read the same
    slab terms with different weights: one descriptor each, so the kernel
    reads those terms once; every other window has its own."""
    TB, IB, n2, s, _ = WINDOWS[2]
    slabs, WKX, WJX = _span_operands(TB, IB, n2, seed=3)
    table = reduction_table(_torch_all(slabs), _torch_all(WKX), _torch_all(WJX),
                            s, n2)
    assert table.jobs == [(0, 1), (2,), (3, 4)] + [(g,) for g in range(5, 13)]
    for a, b in (job for job in table.jobs if len(job) == 2):
        assert REDUCTIONS[a][0] == REDUCTIONS[b][0] and REDUCTIONS[a][1] != REDUCTIONS[b][1]


@pytest.mark.parametrize("change", [
    None,                                 # the same slab window: paired
    dict(row0=(2, 1)), dict(col0=(1, 1)), dict(wcol=(1, 0)), dict(q_lo=1),
    dict(mode=1), dict(c=(3, 0)), dict(slab="other"),
])
def test_pair_windows_needs_the_same_slab_window(change):
    slab = torch.zeros((40, 3, 30), dtype=torch.int32)
    w = torch.zeros((8, 30), dtype=torch.int32)
    base = dict(slab=slab, w=w, row0=(1, 1), col0=(0, 1), mode=2, c=(2, 0))
    other = {**base, "w": w.clone(), **(change or {})}
    if other["slab"] == "other":
        other["slab"] = slab.clone()
    wins = [cuda_ops.WindowSpec(**base), cuda_ops.WindowSpec(**other),
            cuda_ops.WindowSpec(**base)]
    # a window pairs with the first open one of its slab window, once
    want = [(0, 1), (2,)] if change is None else [(0, 2), (1,)]
    assert cuda_ops.pair_windows(wins) == want
