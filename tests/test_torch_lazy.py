"""The port's lazy device-backed traceback (``ccj_tpu_torch/engine/lazy.py``):
the same structures and energies as the eager traceback and the reference
goldens, a bounded host-ward transfer, and a P-split argmin equal to the
JAX package's ``LazyMats.case_p_argmin`` (first minimum on ties)."""

import numpy as np
import pytest
import torch

from ccj_tpu.engine.fold import best_fill
from ccj_tpu.engine.lazy import LazyMats as JaxLazyMats
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch import fold
from ccj_tpu_torch.api import bucket_for
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.fold import fill_state
from ccj_tpu_torch.engine.lazy import LazyMats
from ccj_tpu_torch.engine.traceback import Traceback
from ccj_tpu_torch.params import parse_par as t_parse_par
from ccj_tpu_torch.params import scale_parameters as t_scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables as t_build_seq_tables
from ccj_tpu_torch.precompute import pad_seq_tables as t_pad_seq_tables

from oracle_util import REPO
from test_lazy import CASES

# one intra-op thread per worker process (see test_torch_fill.py)
torch.set_num_threads(1)

PK_SEQ, PK_PAR = "AACCACUCUGACUGGC", "ccj_tpu/params/rna_Turner04.par"


@pytest.mark.parametrize("seq,par,want", CASES, ids=["nested", "pseudoknot"])
def test_lazy_fold_matches_eager_and_golden(seq, par, want):
    eager = fold(seq, param_file=par, device="cpu", lazy=False)
    lazy = fold(seq, param_file=par, device="cpu", lazy=True)
    assert lazy.structure == eager.structure == want
    assert lazy.energy_dcal == eager.energy_dcal


def test_lazy_transfer_is_slab_bounded():
    """The lazy traceback moves slabs, not the whole O(n^4) state."""
    sp = t_scale_parameters(t_parse_par(REPO / PK_PAR))
    tabs = t_build_seq_tables(PK_SEQ, sp, DEFAULT_PK)
    tabs_fill = t_pad_seq_tables(tabs, bucket_for(len(PK_SEQ)), sp, DEFAULT_PK)
    st = fill_state(tabs_fill, sp, DEFAULT_PK, "cpu")
    total = sum(v.nbytes for v in st.values())
    mats = LazyMats(st, tabs_fill.n)
    e_dcal, structure = Traceback(tabs, sp, DEFAULT_PK, mats).run()
    assert structure == CASES[1][2]
    assert mats.bytes_fetched < total / 10, (mats.bytes_fetched, total)
    assert mats.slab_fetches > 0


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's fill of the pseudoknot case at n=16, as numpy."""
    sp = scale_parameters(parse_par(REPO / PK_PAR))
    tabs = build_seq_tables(PK_SEQ, sp, DEFAULT_PK)
    st = best_fill(tabs, sp, DEFAULT_PK)()
    return st, {k: np.array(v) for k, v in st.items()}


def test_case_p_argmin_matches_jax(jax_state):
    """Every (i, l) with l - i >= 3 on one state: the JAX fill, carried
    across as numpy."""
    st, st_np = jax_state
    n = len(PK_SEQ)
    want = JaxLazyMats(st, n)
    got = LazyMats({k: torch.from_numpy(v) for k, v in st_np.items()}, n)
    finite = 0
    for i in range(1, n + 1):
        for l in range(i + 3, n + 1):
            w = tuple(int(x) for x in want.case_p_argmin(i, l))
            assert got.case_p_argmin(i, l) == w, (i, l)
            finite += w[3] < INF
    assert finite > 0


def _numpy_case_p(PKD, n, i, l):
    """The P-split cube in plain numpy, read through the PK diagonal
    layout; np.argmin keeps the first minimum in C order.  Returns the
    answer and how many cells hold the minimum."""
    T, S, N2, A = PKD.shape
    m = l - i
    o = np.arange(m)
    jj, dd, kk = i + o[:, None, None], i + o[None, :, None], i + o[None, None, :]

    def g4v(i_, j_, k_, l_):
        i_, j_, k_, l_ = np.broadcast_arrays(i_, j_, k_, l_)
        valid = (i_ <= j_) & (j_ < k_ - 1) & (k_ <= l_)
        v = PKD[np.clip(k_ - j_ - 2, 0, T - 1), np.clip(l_ - i_, 0, S - 1),
                np.clip(i_, 0, N2 - 1), np.clip(j_ - i_, 0, A - 1)].astype(np.int64)
        return np.where(valid, v, INF)

    vals = g4v(i, jj, dd + 1, kk) + g4v(jj + 1, dd, kk + 1, l)
    vals = np.where((dd >= jj + 1) & (kk >= dd + 1), vals, 4 * INF).ravel()
    flat = int(np.argmin(vals))
    v = int(vals[flat])
    at_min = int((vals == v).sum())
    if v >= INF:
        return (0, 0, 0, v), at_min
    oj, rem = divmod(flat, m * m)
    od, ok = divmod(rem, m)
    return (i + oj, i + od, i + ok, v), at_min


def test_case_p_argmin_takes_first_minimum_on_ties():
    """A PKD of three values only, so nearly every cube has many equal
    minima: the answer is numpy's first minimum."""
    n = 16
    T, S, n2 = n - 1, n, n + 2
    rng = np.random.default_rng(7)
    PKD = rng.choice(np.array([-5, 0, SAT16], dtype=np.int16), size=(T, S, n2, n2))
    mats = LazyMats({"PKD": torch.from_numpy(PKD),
                     **{k: torch.zeros((n2, n2), dtype=torch.int32)
                        for k in ("V", "Vtype", "WM", "WMv", "WMp", "P2",
                                  "WBP", "WPP")}}, n)
    ties = 0
    for i in range(1, n + 1):
        for l in range(i + 3, n + 1):
            want, at_min = _numpy_case_p(PKD, n, i, l)
            assert mats.case_p_argmin(i, l) == want, (i, l)
            ties += want[3] < INF and at_min > 1
    assert ties > 50
