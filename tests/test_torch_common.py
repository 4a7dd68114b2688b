"""The port's tensor helpers keep JAX's semantics: XLA's clamped
dynamic_slice / dynamic_update_slice, the diagonal skews, the gather-free
table builders of the tt loop and the stencil windows (exact)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccj_tpu.engine import common as jcommon
from ccj_tpu.engine import gapped4 as jg4
from ccj_tpu.engine import skew as jskew
from ccj_tpu.engine import ttloop as jtt
from ccj_tpu_torch.engine import common as tcommon
from ccj_tpu_torch.engine import gapped4 as tg4
from ccj_tpu_torch.engine import skew as tskew
from ccj_tpu_torch.engine import ttloop as ttt


def _rand(shape, seed=0, dtype=np.int32):
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, size=shape).astype(dtype)


@pytest.mark.parametrize("starts", [(0, 0, 0), (-3, 2, 9), (5, -1, 100),
                                    (2, 4, 1)])
def test_dynamic_slice_clamps_like_xla(starts):
    x = _rand((6, 7, 8))
    sizes = (3, 5, 4)
    want = np.asarray(jax.lax.dynamic_slice(jnp.asarray(x), starts, sizes))
    got = tcommon.dynamic_slice(torch.from_numpy(x), starts, sizes)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("starts", [(0, 0), (-2, 3), (4, 99)])
def test_dynamic_update_slice_clamps_like_xla(starts):
    x, upd = _rand((5, 6)), _rand((3, 2), seed=1)
    want = np.asarray(jax.lax.dynamic_update_slice(jnp.asarray(x), jnp.asarray(upd),
                                                   starts))
    got = tcommon.dynamic_update_slice(torch.from_numpy(x.copy()),
                                       torch.from_numpy(upd), starts)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5, 7), (2, 3, 4, 6)])
def test_skews_match(shape):
    x = _rand(shape, dtype=np.int16)
    np.testing.assert_array_equal(
        tskew.skew_right(torch.from_numpy(x), 32767).numpy(),
        np.asarray(jskew.skew_right(jnp.asarray(x), 32767)))
    for W in (3, shape[-1], shape[-1] + 2):
        np.testing.assert_array_equal(
            tskew.unskew_right(torch.from_numpy(x), 32767, W).numpy(),
            np.asarray(jskew.unskew_right(jnp.asarray(x), 32767, W)))


def test_common_getters_match():
    n, n2 = 9, 11
    M = _rand((8, 9, n2, n2), dtype=np.int16)
    rng = np.random.default_rng(3)
    idx = [rng.integers(-2, n2 + 2, size=40) for _ in range(4)]
    want = np.asarray(jcommon.read4(jnp.asarray(M), n, *map(jnp.asarray, idx)))
    got = tcommon.read4(torch.from_numpy(M), n, *map(torch.from_numpy, idx))
    np.testing.assert_array_equal(got.numpy(), want)
    W = _rand((n2, n2))
    a, b = rng.integers(0, n2, size=30), rng.integers(0, n2, size=30)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((jcommon.tri_get, tcommon.tri_get),
                   (jcommon.v_get, tcommon.v_get)):
        np.testing.assert_array_equal(tf(torch.from_numpy(W), ta, tb).numpy(),
                                      np.asarray(jf(jnp.asarray(W), ja, jb)))
    np.testing.assert_array_equal(
        tcommon.wx_get(torch.from_numpy(W), n, ta, tb, 6).numpy(),
        np.asarray(jcommon.wx_get(jnp.asarray(W), n, ja, jb, 6)))
    valid = rng.random((n2, n2)) < 0.5
    plane = rng.integers(-40000, 40000, size=(n2, n2)).astype(np.int32)
    np.testing.assert_array_equal(
        tcommon.pack16(torch.from_numpy(plane), torch.from_numpy(valid)).numpy(),
        np.asarray(jcommon.pack16(jnp.asarray(plane), jnp.asarray(valid))))


@pytest.mark.parametrize("n,s,TB,IB", [(16, 5, 16, 16), (30, 17, 16, 16),
                                       (30, 3, 16, 32)])
def test_tt_loop_table_builders_match(n, s, TB, IB):
    n2 = n + 2
    X = _rand((n2, n2), seed=s)
    jX, tX = jnp.asarray(X), torch.from_numpy(X)
    UK = n2 + TB + 1
    pairs = [
        (jtt.wk_table(jX, TB, UK, n2), ttt.wk_table(tX, TB, UK, n2)),
        (jtt.wj_table(jX, TB, n2), ttt.wj_table(tX, TB, n2)),
        (jtt.jk_table(jX, TB, n2, 4, 1), ttt.jk_table(tX, TB, n2, 4, 1)),
        (jtt.jk_table(jX, TB, n2, 2, 0), ttt.jk_table(tX, TB, n2, 2, 0)),
        (jtt.plane_ij(jX, TB, IB), ttt.plane_ij(tX, TB, IB)),
        (jtt.plane_kl(jX, s, TB, IB, n2), ttt.plane_kl(tX, s, TB, IB, n2)),
        (jtt.diag_il(jX, s, TB, IB, n2), ttt.diag_il(tX, s, TB, IB, n2)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("signs", [(+1, -1), (-1, +1)])
def test_shift_window_matches(signs):
    x = np.random.default_rng(5).random((12, 14)) < 0.5
    want = np.asarray(jg4._shift_window(jnp.asarray(x), 29, *signs, False))
    got = tg4._shift_window(torch.from_numpy(x), 29, *signs, False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [16, 40, 99, 100, 126])
def test_bucket_dims_match(n):
    assert [tg4.bucket_dims(n, s) for s in range(n)] == \
        [jg4.bucket_dims(n, s) for s in range(n)]
