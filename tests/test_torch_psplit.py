"""The P split, ``cuda_ops.p_split`` (``csrc/psplit.cu`` on the card, its
plain version ``p_split_ref`` here), bit for bit (tolerance zero: integer
data):

* the port's ``gapped3.compute_P_span3`` (PKD read in place through the
  kernel's affine map) against the JAX package's ``compute_P_span3`` on
  the same random PKD / PKE (SAT16 cells among them) at spans with one,
  several and no term a row, and a row slice i0 > 0 (PKE's rows from
  i0) against the same rows of the JAX split; a batch of two against
  each element alone;
* the row shards' operand (the PKD rows each a needs, stacked, as
  ``dist.wavefront`` fetches them) against PKD read in place;
* the kernel's tile walk restated in PyTorch (per live row and m = a + c + 1,
  the rectangle b - 1 <= s - 1 - m, a <= m - 2 in 32 x 32 tiles, and in
  4 x 4 ones; PKE along a, the factor-2 operand along b - 1 and added
  transposed; factor-2 rows past the operand reading SAT16; the triangle
  b - 1 + m > s - 1 never visited, each admissible term once) against the
  plain version, on random operands in both forms;
* refusals of operands that do not fit; no launch counted on the CPU;
  CUDA operands without the kernel library raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccj_tpu.engine.gapped3 import compute_P_span3 as jax_compute_P_span3
from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine.common import INF, SAT16, TRI_UNSET
from ccj_tpu_torch.engine.gapped3 import compute_P_span3

torch.set_num_threads(1)

N = 14                           # n2 = 16, T = 13, S = 14


def _pk(rng, B, n=N):
    """Random PKD [B, T, S, n2, n2] and PKE [B, T, S + T + 2, n2, n2]
    int16: energies, 30 % SAT16 (unset cells take part as values)."""
    n2, T, S = n + 2, n - 1, n

    def one(shape):
        x = rng.integers(-3000, 3000, shape).astype(np.int16)
        x[rng.random(shape) < 0.3] = SAT16
        return x
    return one((B, T, S, n2, n2)), one((B, T, S + T + 2, n2, n2))


def _jax_P(pkd, pke, s, n=N):
    """The JAX package's P split of span s on one element's PKD / PKE: the
    span-s diagonal of P2 (P2 starts unset)."""
    n2 = n + 2
    st = {"PKD": jnp.asarray(pkd), "PKE": jnp.asarray(pke),
          "P2": jnp.full((n2, n2), TRI_UNSET, dtype=jnp.int32)}
    P2 = np.asarray(jax_compute_P_span3({"n": n}, st, s)["P2"])
    i = np.arange(n2)
    return P2[i, np.clip(i + s, 0, n2 - 1)]


def _port_P(pkd, pke, s, n=N):
    n2 = n + 2
    st = {"PKD": torch.from_numpy(pkd), "PKE": torch.from_numpy(pke),
          "P2": torch.full((pkd.shape[0], n2, n2), TRI_UNSET, dtype=torch.int32)}
    P2 = compute_P_span3({"n": n}, st, s)["P2"].numpy()
    i = np.arange(n2)
    return P2[:, i, np.clip(i + s, 0, n2 - 1)]


@pytest.mark.parametrize("s", [2, 3, 7, N - 1])
def test_compute_P_span3_matches_jax(s):
    pkd, pke = _pk(np.random.default_rng(s), 1)
    got, want = _port_P(pkd, pke, s), _jax_P(pkd[0], pke[0], s)
    assert np.array_equal(got[0], want)
    live = np.arange(N + 2)
    live = (live >= 1) & (live + s <= N)
    assert (got[0][live] < INF // 2).all() == (s >= 3)     # a term a live row


def test_compute_P_span3_batch_of_two():
    pkd, pke = _pk(np.random.default_rng(5), 2)
    got = _port_P(pkd, pke, 6)
    for b in range(2):
        assert np.array_equal(got[b], _port_P(pkd[b:b + 1], pke[b:b + 1], 6)[0])
        assert np.array_equal(got[b], _jax_P(pkd[b], pke[b], 6))


@pytest.mark.parametrize("s,i0,rows", [(7, 3, 4), (5, 6, 5)])
def test_row_slice_matches_jax(s, i0, rows):
    """The split over rows [i0, i0 + rows): PKE's rows from i0, PKD in
    place with the rows' offset (a row shard's PKE, the unsharded PKD)."""
    pkd, pke = _pk(np.random.default_rng(11 + s), 1)
    got = cuda_ops.p_split(torch.from_numpy(pke[..., i0:i0 + rows, :]),
                           torch.from_numpy(pkd).transpose(1, 2), s=s, n=N, i0=i0,
                           R=rows, sp=(s - 1, -1), ro=(i0 + 1, 1))
    want = _jax_P(pkd[0], pke[0], s)[i0:i0 + rows]
    live = (np.arange(i0, i0 + rows) >= 1) & (np.arange(i0, i0 + rows) + s <= N)
    assert np.array_equal(got[0].numpy()[live], want[live])
    assert (got[0].numpy()[~live] == INF).all()


def _stacked(pkd, s, i0, rows, n=N):
    """The row shards' factor-2 operand: for each a, PKD[:, :, s - a - 1]'s
    rows [i0 + a + 1, i0 + a + 1 + rows), SAT16 past the last
    (``dist.wavefront._fill_sharded``)."""
    B, T, _S, n2, _ = pkd.shape
    out = np.full((B, max(s - 1, 1), T, rows, n2), SAT16, dtype=np.int16)
    for a in range(s - 1):
        r0 = i0 + a + 1
        got = pkd[:, :, s - a - 1, r0:r0 + rows]
        out[:, a, :, :got.shape[2]] = got
    return torch.from_numpy(out)


@pytest.mark.parametrize("s,i0,rows", [(9, 0, 16), (8, 4, 3), (12, 1, 2)])
def test_stacked_rows_equal_pkd_in_place(s, i0, rows):
    pkd, pke = _pk(np.random.default_rng(s + i0), 2)
    pke_t = torch.from_numpy(pke[..., i0:i0 + rows, :])
    got = cuda_ops.p_split(pke_t, _stacked(pkd, s, i0, rows), s=s, n=N, i0=i0, R=rows,
                           sp=(0, 1), ro=(0, 0))
    want = cuda_ops.p_split(pke_t, torch.from_numpy(pkd).transpose(1, 2), s=s, n=N,
                            i0=i0, R=rows, sp=(s - 1, -1), ro=(i0 + 1, 1))
    assert torch.equal(got, want)


def _kernel_walk(pke, pkd, s, n, i0, R, sp, ro, tile):
    """csrc/psplit.cu's walk restated: per live (b, i) row and m = a + c + 1
    in [2, s - 1] (a block each), the rectangle b - 1 in [0, s - 1 - m],
    a in [0, m - 2] in tile x tile tiles (the triangle b - 1 + m > s - 1
    never visited); per tile A[b - 1][a] = PKE[b - 1, m, r, a] (INF outside
    the rectangle) and B[a][b - 1] = X[sp(a), m - 2 - a, ro(a) + r, b - 1]
    (SAT16 past X's rows and outside), the minimum of A + B transposed; the
    block's minimum joins its row's where it is below INF.  Returns the
    output and the terms visited per live row."""
    B, T, A, NR = pke.shape[0], pke.shape[1], pkd.shape[1], pkd.shape[3]
    out = torch.full((B, R), INF, dtype=torch.int32)
    lo, hi = cuda_ops.p_split_live(n, s, i0, R)
    visits = []
    for b in range(B):
        for r in range(lo - i0, hi - i0 + 1):
            seen = 0
            for m in range(2, s):
                nbb, na = s - m, m - 1
                blk = INF
                for a0 in range(0, na, tile):
                    for bb0 in range(0, nbb, tile):
                        a = torch.arange(a0, a0 + tile)
                        bb = torch.arange(bb0, bb0 + tile)
                        inside = (bb[:, None] < nbb) & (a[None, :] < na)   # [b - 1, a]
                        seen += int(inside.sum())
                        Av = pke[b, bb.clamp(max=T - 1)[:, None], m, r,
                                 a.clamp(max=pke.shape[4] - 1)[None, :]].to(torch.int32)
                        Av = torch.where(inside, Av, INF)
                        row = r + ro[0] + ro[1] * a
                        x = (sp[0] + sp[1] * a).clamp(0, A - 1)
                        ok = (row >= 0) & (row < NR)
                        Bv = pkd[b, x[:, None], (m - 2 - a).clamp(0, T - 1)[:, None],
                                 row.clamp(0, NR - 1)[:, None],
                                 bb.clamp(max=pkd.shape[4] - 1)[None, :]].to(torch.int32)
                        Bv = torch.where(ok[:, None] & inside.T, Bv, SAT16)   # [a, b - 1]
                        blk = min(blk, int((Av + Bv.T).min()))
                if blk < INF:
                    out[b, r] = min(int(out[b, r]), blk)
            visits.append(seen)
    return out, visits


@pytest.mark.parametrize("tile", [32, 4])
@pytest.mark.parametrize("s,i0,R,form", [(6, 0, 16, "pkd"), (9, 2, 5, "pkd"),
                                         (13, 0, 3, "pkd"), (8, 3, 4, "stacked"),
                                         (10, 5, 6, "stacked")])
def test_kernel_enumeration_equals_plain(s, i0, R, form, tile):
    """The tile walk (the kernel's 32 x 32 tiles, and 4 x 4 ones so that a
    rectangle spans several) equals the plain version, and visits each
    admissible term of a live row once: C(s, 3) of them (the last case
    has no live row)."""
    pkd, pke = _pk(np.random.default_rng(40 + s), 2)
    pke_t = torch.from_numpy(pke[..., i0:i0 + R, :])
    if form == "pkd":
        X, sp, ro = torch.from_numpy(pkd).transpose(1, 2), (s - 1, -1), (i0 + 1, 1)
    else:   # short rows: factor-2 rows past the operand read SAT16
        X, sp, ro = _stacked(pkd, s, i0, R)[..., :max(R - 2, 1), :], (0, 1), (0, 0)
    want = cuda_ops.p_split_ref(pke_t, X, s, N, i0, R, sp, ro)
    got, visits = _kernel_walk(pke_t, X, s, N, i0, R, sp, ro, tile)
    assert torch.equal(got, want)
    assert all(v == s * (s - 1) * (s - 2) // 6 for v in visits)
    assert torch.equal(cuda_ops.p_split(pke_t, X, s=s, n=N, i0=i0, R=R, sp=sp, ro=ro),
                       want)


def test_p_split_refuses_operands_that_do_not_fit():
    pkd, pke = _pk(np.random.default_rng(1), 1)
    pkd_t, pke_t = torch.from_numpy(pkd).transpose(1, 2), torch.from_numpy(pke)
    kw = dict(s=7, n=N, i0=0, R=N + 2, sp=(6, -1), ro=(1, 1))
    for bad in (dict(kw, R=N + 3), dict(kw, sp=(N, -1)), dict(kw, sp=(4, -1)),
                dict(kw, ro=(-1, 1))):
        with pytest.raises(ValueError):
            cuda_ops.p_split(pke_t, pkd_t, **bad)
    with pytest.raises(ValueError):
        cuda_ops.p_split(pke_t.to(torch.int32), pkd_t, **kw)
    with pytest.raises(ValueError):
        cuda_ops.p_split(pke_t[..., :3], pkd_t, **kw)


def test_p_split_on_cpu_counts_no_launch():
    pkd, pke = _pk(np.random.default_rng(2), 1)
    before = cuda_ops.PSPLIT_LAUNCHES
    out = cuda_ops.p_split(torch.from_numpy(pke), torch.from_numpy(pkd).transpose(1, 2),
                           s=8, n=N, i0=0, R=N + 2, sp=(7, -1), ro=(1, 1))
    assert cuda_ops.PSPLIT_LAUNCHES == before
    assert out.dtype == torch.int32 and tuple(out.shape) == (1, N + 2)


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    wrapper inspects before it needs the kernel library."""

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


def test_p_split_on_cuda_raises_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernel: without nvcc the wrapper raises (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    pkd, pke = _pk(np.random.default_rng(3), 1)
    fake_pke = _CudaTyped(torch.from_numpy(pke))
    fake_pkd = _CudaTyped(torch.from_numpy(pkd).transpose(1, 2))
    before = cuda_ops.PSPLIT_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.p_split(fake_pke, fake_pkd, s=8, n=N, i0=0, R=N + 2, sp=(7, -1),
                         ro=(1, 1))
    assert cuda_ops.PSPLIT_LAUNCHES == before
