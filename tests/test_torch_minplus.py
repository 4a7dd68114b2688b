"""The min-plus window reduction's plain PyTorch version equals the Pallas
kernel it replaces (interpret mode) and a numpy restatement of the tt
loop's red_k / red_j; exact (integer data, tolerance zero).  The CUDA
kernel itself is held against this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccj_tpu.engine.pallas_ops import minplus_suffix as pallas_minplus_suffix
from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine.common import INF


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
