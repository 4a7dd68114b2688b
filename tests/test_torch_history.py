"""The gapped step's history scans, ``cuda_ops.history_min``
(``csrc/history.cu`` on the card, its plain version ``history_min_ref``
here), bit for bit (tolerance zero: integer data):

* the port's RL / RI (``gapped4.dense_rl`` and ``dense_reads``' RI;
  ``gapped5.packed_rl`` and ``packed_reads``' RI) against the JAX
  package's RL / RI closures inside its span step, through the seven
  reduction bases the JAX step hands its tt loop (taken by a spy on
  ``ccj_tpu.engine.ttloop.tt_loop``; they cover both scans, both g1 and
  the three weight tables):
  - dense: the state of an n=24 ``fill6`` before span 12, for B=1, B=2
    (two sequences' states stacked) and a row slice i0 > 0 (the row
    shards' form: RL on the shard's own rows, RI on the C rows l = i + s);
  - packed: a random n=37 state in four segments of 12 spans (the scans
    read every prior segment; the earlier segments' tt rows, fewer than
    the span's, read SAT16), at a span of the third segment and the
    fourth's only span, and a row slice;
* the kernel's loop restated in PyTorch (per (b, tt, r, j) the span range
  [max(0, d0 - bound), min(U, d0)), the part's rows and tt rows) against
  the plain version on random operands, both modes;
* refusals; no launch counted on the CPU; CUDA operands without the kernel
  library raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine import gapped4 as jg4
from ccj_tpu.engine import gapped5 as jg5
from ccj_tpu.engine import ttloop as jttloop
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.engine import cuda_ops, gapped4, gapped5
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.gapped import C_MATS, _wx_tables

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
SEQS = ("GGGAAACGGGCGAUCCUUCCCGAA", "GCGCAAUUGCGCGGCGCUUGCGCC")   # n = 24
SEQ37 = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
SPAN = 12
BASES = ("PLmloop00", "PLmloop10", "PRmloop00", "PMmloop01", "PMmloop10",
         "PfromL", "PfromR")


class _Stop(Exception):
    pass


def _jax_bases(step, st):
    """The reduction bases the JAX span step ``step(st)`` hands its tt
    loop, from one jit of the step traced up to the loop (a spy stops it
    there)."""
    def run(st):
        got = {}

        def spy(C, SC4, WBt, WPt, WBPg, bases, *rest):
            got.update(bases)
            raise _Stop

        mp = pytest.MonkeyPatch()
        mp.setattr(jttloop, "tt_loop", spy)
        try:
            step(st)
        except _Stop:
            pass
        finally:
            mp.undo()
        return got

    got = {k: np.asarray(v) for k, v in jax.jit(run)(st).items()}
    assert set(got) == set(BASES)
    return got


def _port_bases(reads, W):
    """span_families' bases, from the layout's RL / RI."""
    WBt, WPt, WBPg = W
    RL, RI = reads.RL, reads.RI
    return {"PLmloop00": RI("PLmloop00", WBt, 0),
            "PLmloop10": RI("PLmloop00", WBPg, 0),
            "PRmloop00": RL("PRmloop00", WBt, 0),
            "PMmloop01": RL("PMmloop00", WBPg, 0),
            "PMmloop10": torch.minimum(RI("PMmloop00", WBPg, 0),
                                       RL("PMmloop10", WBt, 1)),
            "PfromL": RI("PfromL", WPt, 1),
            "PfromR": RL("PfromR", WPt, 1)}


def _consts(seq):
    """Both packages' tables from one host dict; the stencil weights are
    the port's (the scans do not read them; ``tests/test_torch_fill.py``
    holds them equal to the JAX package's)."""
    sp = scale_parameters(parse_par(PAR))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C_np = {**jfold.build_consts(tabs, sp, DEFAULT_PK, device=False), "n": tabs.n}
    C, SC4 = tfold.consts_from_numpy(C_np, "cpu")
    return sp, tabs, C_np, SC4, {**C, "n": tabs.n}


# ---------------------------------------------------------------------------
# dense: the n=24 fill's state before span 12
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """Per sequence: (C_np, the port's C, its fill6 state before span
    SPAN with the batch axis, the JAX bases of that span)."""
    out = []
    for seq in SEQS:
        sp, tabs, C_np, SC4, C = _consts(seq)
        seen = {}
        real = tfold.span_gapped4

        def spy(C_, SC4_, st, s, TB, IB):
            if s == SPAN:
                seen.update({k: v.clone() for k, v in st.items()}, TB=TB, IB=IB)
                raise _Stop
            return real(C_, SC4_, st, s, TB, IB)

        mp = pytest.MonkeyPatch()
        mp.setattr(tfold, "span_gapped4", spy)
        try:
            tfold.fill6(C, SC4, tabs.n, sp.dangles)
        except _Stop:
            pass
        finally:
            mp.undo()
        TB, IB = seen.pop("TB"), seen.pop("IB")
        assert (TB, IB) == jg4.bucket_dims(tabs.n, SPAN)
        st_j = {k: jnp.asarray(v[0].numpy()) for k, v in seen.items()}
        sc4_np = {k: v.numpy() for k, v in SC4.items()}
        want = _jax_bases(lambda st: jg4.span_gapped4(C_np, sc4_np, st, SPAN, TB, IB),
                          st_j)
        out.append((C, seen, TB, IB, want))
    return out


def _dense_port(C, st, TB, IB):
    reads = gapped4.dense_reads(st, C["n"], SPAN, TB, IB)
    return _port_bases(reads, _wx_tables(C, st)[:3])


@pytest.mark.parametrize("b", [0, 1])
def test_dense_scans_match_jax(dense, b):
    C, st, TB, IB, want = dense[b]
    got = _dense_port(C, st, TB, IB)
    for name in BASES:
        assert np.array_equal(got[name][0].numpy(), want[name]), name
    assert (want["PfromR"] < INF).any() and (want["PLmloop00"] < INF).any()


def test_dense_scans_batch_of_two(dense):
    (C, st0, TB, IB, want0), (_, st1, _, _, want1) = dense
    st = {k: torch.cat([st0[k], st1[k]]) for k in st0}
    got = _dense_port(C, st, TB, IB)
    for name in BASES:
        for b, want in ((0, want0), (1, want1)):
            assert np.array_equal(got[name][b].numpy(), want[name]), (name, b)


def _dense_ri_rows(st, name, X, g1, s, TB, i0, rows):
    """A row shard's RI: rows i in [i0, i0 + rows) read C rows l = i + s
    (``dist.wavefront.sharded_reads``' call, on one device)."""
    n2 = st["PKD"].shape[-1]
    sp0 = max(s - TB, 0)
    spv = sp0 + torch.arange(TB)
    iv = torch.arange(i0, i0 + rows)
    win = st["C_" + name][:, :TB, sp0:sp0 + TB, i0 + s:min(i0 + s + rows, n2)]
    w = gapped4.g2(X, iv[None, :].expand(TB, rows), iv[None, :] + s - spv[:, None] - 1)
    acc = torch.full((st["PKD"].shape[0], TB, rows, n2), INF, dtype=torch.int32)
    return cuda_ops.history_min(acc, [(win, w, s - sp0)], cuda_ops.RI, s, g1, i0)


@pytest.mark.parametrize("i0,rows", [(3, 5), (7, 6)])
def test_dense_scans_row_slice_match_jax(dense, i0, rows):
    C, st, TB, IB, want = dense[0]
    WBt, WPt, WBPg = _wx_tables(C, st)[:3]
    cut = {k: v[..., i0:i0 + rows, :] for k, v in st.items() if v.dim() == 5}
    RL = gapped4.dense_rl(cut, C["n"], SPAN, TB, rows, i0)
    for name, got in (("PRmloop00", RL("PRmloop00", WBt, 0)),
                      ("PfromR", RL("PfromR", WPt, 1)),
                      ("PLmloop10", _dense_ri_rows(st, "PLmloop00", WBPg, 0, SPAN, TB,
                                                   i0, rows)),
                      ("PfromL", _dense_ri_rows(st, "PfromL", WPt, 1, SPAN, TB, i0,
                                                rows))):
        assert np.array_equal(got[0].numpy(), want[name][:, i0:i0 + rows]), name


# ---------------------------------------------------------------------------
# packed: a random n=37 state in four segments
# ---------------------------------------------------------------------------

def _segments(n, width):
    """``gapped5.segments7``'s schedule without its MIN_SEG floor: the
    history scans read every prior segment whatever its width."""
    return tuple((lo, min(lo + width, n), max(min(lo + width, n) - 2, 1), n - lo + 2,
                  (n + 2 - lo) + (min(lo + width, n) - lo - 1))
                 for lo in range(0, n, width))


@pytest.fixture(scope="module")
def packed():
    n = len(SEQ37)
    SEGS = _segments(n, 12)
    sp, tabs, C_np, SC4, C = _consts(SEQ37)
    sc4_np = {k: v.numpy() for k, v in SC4.items()}
    rng = np.random.default_rng(37)
    st = {k: v for k, v in tfold.init_state_2d(n, "cpu").items()}
    for k in ("WBP", "WPP"):
        x = rng.integers(-600, 600, st[k].shape).astype(np.int32)
        x[rng.random(x.shape) < 0.2] = INF + 1
        st[k] = torch.from_numpy(x)

    def block(shape):
        x = rng.integers(-2000, 2000, shape).astype(np.int16)
        x[rng.random(shape) < 0.3] = SAT16
        return torch.from_numpy(x)

    for g, (lo, hi, TB, IB, Lc) in enumerate(SEGS):
        for m in gapped5.M4_STORED:
            st[f"{m}@{g}"] = block((1, TB, hi - lo, IB, n + 2))
        for m in C_MATS:
            st[f"C_{m}@{g}"] = block((1, TB, hi - lo, Lc, n + 2))
    st["PKD"] = torch.zeros((1, 1, 1, 1, n + 2), dtype=torch.int16)   # not read
    st_j = {k: jnp.asarray(v[0].numpy()) for k, v in st.items()}
    want = {}
    for s, gi in ((30, 2), (36, 3)):
        want[s] = _jax_bases(lambda st, s=s, gi=gi: jg5.span_gapped7(
            C_np, sc4_np, st, s, gi, SEGS), st_j)
    return C, st, SEGS, want


@pytest.mark.parametrize("s,gi", [(30, 2), (36, 3)])
def test_packed_scans_match_jax(packed, s, gi):
    C, st, SEGS, want = packed
    reads = gapped5.packed_reads(st, C["n"], s, gi, SEGS)
    got = _port_bases(reads, _wx_tables(C, st)[:3])
    lo, hi, TB, IB, _ = SEGS[gi]
    assert SEGS[0][2] < TB                         # earlier segments: fewer tt rows
    for name in BASES:
        assert tuple(got[name].shape) == (1, TB, IB, C["n"] + 2), name
        assert np.array_equal(got[name][0].numpy(), want[s][name]), name


def test_packed_scans_row_slice_match_jax(packed):
    C, st, SEGS, want = packed
    s, gi, i0, rows = 30, 2, 2, 6
    n2 = C["n"] + 2
    lo, hi, TB, IB, _ = SEGS[gi]
    WBt, WPt, WBPg = _wx_tables(C, st)[:3]
    cut = {k: v[..., i0:i0 + rows, :] if "@" in k and not k.startswith("C_") else v
           for k, v in st.items()}
    RL = gapped5.packed_rl(cut, C["n"], s, gi, SEGS, TB, rows, i0)
    assert np.array_equal(RL("PfromR", WPt, 1)[0].numpy(),
                          want[s]["PfromR"][:, i0:i0 + rows])
    # RI: the rows' C rows l = i + s of every prior segment's skew
    iv = torch.arange(i0, i0 + rows)
    parts = []
    for h in range(gi + 1):
        loh = SEGS[h][0]
        nsh = gapped5.prior_spans(SEGS, h, s)
        u = loh + torch.arange(nsh)
        w = gapped4.g2(WPt, iv[None, :].expand(nsh, rows), iv[None, :] + s - u[:, None] - 1)
        off = i0 + s - loh - 1
        parts.append((st[f"C_PfromL@{h}"][:, :, :nsh, off:off + rows], w, s - loh))
    acc = torch.full((1, TB, rows, n2), INF, dtype=torch.int32)
    got = cuda_ops.history_min(acc, parts, cuda_ops.RI, s, 1, i0)
    assert np.array_equal(got[0].numpy(), want[s]["PfromL"][:, i0:i0 + rows])


# ---------------------------------------------------------------------------
# the kernel's loop, restated, on random operands
# ---------------------------------------------------------------------------

def _kernel_loop(acc, parts, mode, s, g1, i0):
    """csrc/history.cu restated: per (b, tt, r, j) the admissible distance
    bound, then per part the spans u in [max(0, d0 - bound), min(U, d0))
    of its rows r < Rw, a tt row past its TBw reading SAT16; acc's cell
    clamped to INF first."""
    out = acc.clone()
    B, TB, R, n2 = acc.shape
    for b in range(B):
        for tt in range(TB):
            for r in range(R):
                i = i0 + r
                for j in range(n2):
                    if mode == cuda_ops.RL:
                        bound = (i + s) - (j + tt + 2) - g1
                    else:
                        bound = (j - i) - g1 if i >= 1 else 0
                    best = min(int(acc[b, tt, r, j]), INF)
                    if bound >= 1:
                        for win, w, d0 in parts:
                            TBw, U, Rw = win.shape[1:4]
                            if r >= Rw:
                                continue
                            for u in range(max(0, d0 - bound), min(U, d0)):
                                v = int(win[b, tt, u, r, j]) if tt < TBw else SAT16
                                best = min(best, v + int(w[b, u, r]))
                    out[b, tt, r, j] = best
    return out


def _random_parts(rng, B, TB, R, n2):
    parts = []
    for TBw, U, Rw, d0 in ((TB, 5, R, 7), (TB - 3, 4, R - 2, 4), (2, 3, R, 2),
                           (TB, 2, R, 0)):
        x = rng.integers(-3000, 3000, (B, TBw, U, Rw, n2)).astype(np.int16)
        x[rng.random(x.shape) < 0.3] = SAT16
        w = rng.integers(-400, 400, (B, U, R + 1)).astype(np.int32)
        w[rng.random(w.shape) < 0.3] = INF
        parts.append((torch.from_numpy(x), torch.from_numpy(w), d0))
    return parts


@pytest.mark.parametrize("mode,g1,i0", [(cuda_ops.RL, 0, 0), (cuda_ops.RL, 1, 3),
                                        (cuda_ops.RI, 0, 0), (cuda_ops.RI, 1, 2)])
def test_kernel_loop_equals_plain(mode, g1, i0):
    rng = np.random.default_rng(7 + mode * 10 + i0)
    B, TB, R, n2, s = 2, 6, 5, 9, 8
    parts = _random_parts(rng, B, TB, R, n2)
    acc = torch.from_numpy(rng.integers(-500, 500, (B, TB, R, n2)).astype(np.int32))
    acc[torch.from_numpy(rng.random(acc.shape) < 0.5)] = INF
    acc[0, 0, 0, 0] = INF + 5                            # clamped to INF
    want = _kernel_loop(acc, parts, mode, s, g1, i0)
    got = cuda_ops.history_min(acc.clone(), parts, mode, s, g1, i0)
    assert torch.equal(got, want)
    assert bool((got < acc.clamp(max=INF)).any())        # terms were taken


def test_history_min_refuses_operands_that_do_not_fit():
    rng = np.random.default_rng(1)
    parts = _random_parts(rng, 1, 4, 3, 6)
    acc = torch.full((1, 4, 3, 6), INF, dtype=torch.int32)
    win, w, d0 = parts[0]
    for bad in ([(win[..., :5], w, d0)], [(win.to(torch.int32), w, d0)],
                [(win, w[:, :, :2], d0)], [(win, w.to(torch.int64), d0)],
                [(torch.cat([win, win], dim=3), w, d0)]):
        with pytest.raises(ValueError):
            cuda_ops.history_min(acc, bad, cuda_ops.RL, 5, 0)
    with pytest.raises(ValueError):                      # past the kernel's table
        cuda_ops.history_min(acc, [parts[0]] * (cuda_ops.HISTORY_MAX_PARTS + 1),
                             cuda_ops.RL, 5, 0)
    with pytest.raises(ValueError):
        cuda_ops.history_min(acc, parts, 2, 5, 0)
    with pytest.raises(ValueError):
        cuda_ops.history_min(acc.to(torch.int64), parts, cuda_ops.RL, 5, 0)


def test_history_min_on_cpu_counts_no_launch():
    rng = np.random.default_rng(2)
    parts = _random_parts(rng, 1, 4, 3, 6)
    before = cuda_ops.HISTORY_LAUNCHES
    acc = torch.full((1, 4, 3, 6), INF, dtype=torch.int32)
    assert cuda_ops.history_min(acc, parts, cuda_ops.RI, 5, 0) is acc
    assert cuda_ops.HISTORY_LAUNCHES == before


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    wrapper inspects before it needs the kernel library."""

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


def test_history_min_on_cuda_raises_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernel: without nvcc the wrapper raises (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    rng = np.random.default_rng(3)
    parts = [(_CudaTyped(x), _CudaTyped(w), d0) for x, w, d0 in _random_parts(rng, 1, 4, 3, 6)]
    acc = _CudaTyped(torch.full((1, 4, 3, 6), INF, dtype=torch.int32))
    before = cuda_ops.HISTORY_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.history_min(acc, parts, cuda_ops.RL, 5, 0)
    assert cuda_ops.HISTORY_LAUNCHES == before
