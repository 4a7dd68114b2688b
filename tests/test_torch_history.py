"""The gapped step's history scans, ``cuda_ops.history_min``
(``csrc/history.cu`` on the card, its plain version ``history_min_ref``
here), bit for bit (tolerance zero: integer data).  One call computes
every scan of a span (``gapped4.HISTORY_SCANS``: 9 RL and 7 RI over 12
windows), its weights taken from the ``[B, n2, n2]`` tables inside the
call:

* the port's scans (``SpanReads.history`` of ``gapped4.dense_reads`` and
  ``gapped5.packed_reads``) against the JAX package's RL / RI closures
  inside its span step, through the seven reduction bases the JAX step
  hands its tt loop (taken by a spy on ``ccj_tpu.engine.ttloop.tt_loop``;
  they cover both scans, both g1 and the three weight tables):
  - dense: the state of an n=24 ``fill6`` before span 12, for B=1, B=2
    (two sequences' states stacked) and a row slice i0 > 0 (the row
    shards' form: one launch for the RL windows on the shard's own rows,
    one for the RI windows on the C rows l = i + s);
  - packed: a random n=37 state in four segments of 12 spans (the scans
    read every prior segment; the earlier segments' tt rows, fewer than
    the span's, read SAT16), at a span of the third segment and the
    fourth's only span, and a row slice;
* the kernel's walk restated in PyTorch (per block of a run of cells of
  the flattened (r, j) plane and two tt rows: the run's rows' weights
  staged by d from the tables, then per window, part and cell the span
  range [max(0, d0 - bound), U), one load a window element shared by the
  window's scans, every cell written once) against
  the plain version on random operands: windows shared by two scans,
  tables with INF entries and indices off the table, three packed
  segments with fewer tt rows, spans and rows;
* the scan list as data; refusals; no launch counted on the CPU; CUDA
  operands without the kernel library raise.
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
RL, RI = cuda_ops.RL, cuda_ops.RI


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


def _port_bases(H):
    """span_families' bases, from the span's scans by key."""
    return {"PLmloop00": H["PLmloop00"], "PLmloop10": H["PLmloop10"],
            "PRmloop00": H["PRmloop00"], "PMmloop01": H["PMmloop01"],
            "PMmloop10": torch.minimum(H["PMmloop10_ri"], H["PMmloop10_rl"]),
            "PfromL": H["PfromL"], "PfromR": H["PfromR"]}


def _tables(C, st):
    WBt, WPt, WBPg, _ = _wx_tables(C, st)
    return {"WBt": WBt, "WBPg": WBPg, "WPt": WPt}


def _launch(mode, windows, W, s, i0, TB, R):
    """The scans of one mode over ``windows(family)`` (a row shard's RL or
    RI launch), as a dict by key."""
    return dict(zip(*gapped4.history_launch(gapped4.history_groups(mode),
                                            lambda m, f: windows(f), W, s, i0, TB, R)))


def _consts(seq):
    """Both packages' tables from one host dict; the stencil weights are
    the port's (the scans do not read them; ``tests/test_torch_fill.py``
    holds them equal to the JAX package's)."""
    sp = scale_parameters(parse_par(PAR))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C_np = {**jfold.build_consts(tabs, sp, DEFAULT_PK, device=False), "n": tabs.n}
    C, SC4 = tfold.consts_from_numpy(C_np, "cpu")
    return sp, tabs, C_np, SC4, {**C, "n": tabs.n}


def test_history_scans_are_data():
    """16 scans, 9 RL and 7 RI, over 12 windows; the four shared windows
    serve two scans each with one g1; every key once."""
    keys = [k for k, *_ in gapped4.HISTORY_SCANS]
    assert len(keys) == len(set(keys)) == 16
    groups = gapped4.history_groups()
    assert len(groups) == 12
    assert sorted(len(outs) for *_, outs in groups) == [1] * 8 + [2] * 4
    assert {(m, f) for m, f, _g, outs in groups if len(outs) == 2} == {
        (RL, "POmloop00"), (RI, "POmloop00"), (RL, "PRmloop00"), (RI, "PLmloop00")}
    assert len(gapped4.history_groups(RL)) == 7 and len(gapped4.history_groups(RI)) == 5
    assert sum(len(o) for *_, o in gapped4.history_groups(RL)) == 9
    assert {f for m, f, *_ in groups if m == RI} <= set(C_MATS)


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
    H = gapped4.dense_reads(st, C["n"], SPAN, TB, IB).history(_tables(C, st))
    assert set(H) == {k for k, *_ in gapped4.HISTORY_SCANS}
    return _port_bases(H)


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


@pytest.mark.parametrize("i0,rows", [(3, 5), (7, 6)])
def test_dense_scans_row_slice_match_jax(dense, i0, rows):
    """A row shard's two launches (``dist.wavefront._sharded_history``, on
    one device): RL over the shard's own rows, RI over the C rows
    l = i + s of rows [i0, i0 + rows)."""
    C, st, TB, IB, want = dense[0]
    W = _tables(C, st)
    n2, s, sp0 = C["n"] + 2, SPAN, max(SPAN - TB, 0)
    cut = {k: v[..., i0:i0 + rows, :] for k, v in st.items() if v.dim() == 5}
    H = _launch(RL, gapped4.dense_rl(cut, s, TB, rows), W, s, i0, TB, rows)
    H.update(_launch(RI, lambda f: [(st["C_" + f][:, :TB, sp0:sp0 + TB,
                                                  i0 + s:min(i0 + s + rows, n2)], s - sp0)],
                     W, s, i0, TB, rows))
    got = _port_bases(H)
    for name in BASES:
        assert np.array_equal(got[name][0].numpy(), want[name][:, i0:i0 + rows]), name


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
    H = gapped5.packed_reads(st, C["n"], s, gi, SEGS).history(_tables(C, st))
    got = _port_bases(H)
    lo, hi, TB, IB, _ = SEGS[gi]
    assert SEGS[0][2] < TB                         # earlier segments: fewer tt rows
    assert len(gapped5.prior_segments(SEGS, gi, s)) == 3   # three parts a window
    for name in BASES:
        assert tuple(got[name].shape) == (1, TB, IB, C["n"] + 2), name
        assert np.array_equal(got[name][0].numpy(), want[s][name]), name


def test_packed_scans_row_slice_match_jax(packed):
    C, st, SEGS, want = packed
    s, gi, i0, rows = 30, 2, 2, 6
    lo, hi, TB, IB, _ = SEGS[gi]
    W = _tables(C, st)
    cut = {k: v[..., i0:i0 + rows, :] if "@" in k and not k.startswith("C_") else v
           for k, v in st.items()}
    H = _launch(RL, gapped5.packed_rl(cut, s, gi, SEGS, rows), W, s, i0, TB, rows)
    # RI: the rows' C rows l = i + s of every prior segment's skew
    hist = gapped5.prior_segments(SEGS, gi, s)
    H.update(_launch(RI, lambda f: [(st[f"C_{f}@{h}"][:, :, :nsh, i0 + s - loh - 1:
                                                      i0 + s - loh - 1 + rows], s - loh)
                                    for h, loh, nsh in hist], W, s, i0, TB, rows))
    got = _port_bases(H)
    for name in BASES:
        assert np.array_equal(got[name][0].numpy(), want[s][name][:, i0:i0 + rows]), name


# ---------------------------------------------------------------------------
# the kernel's walk, restated, on random operands
# ---------------------------------------------------------------------------

def _kernel_walk(windows, tables, s, i0, TB, R, loads, run=8):
    """csrc/history.cu restated: per block (b, a run of ``run`` cells of the
    flattened (r, j) plane, which may straddle rows, two tt rows) the
    weights of the run's rows staged by d in [1, s] for each (mode, table)
    (RL column l = i + s of X, RI row i, INF off the table); per window,
    part and cell (tt, r, j) the spans u in [max(0, d0 - bound), U) when
    bound >= 1 and r < Rw, one load a window element (a tt row past the
    part's reads SAT16 and loads nothing) shared by the window's one or two
    scans; every cell of every plane written once.  ``loads`` counts each
    element loaded."""
    B, n2 = tables[0].shape[0], tables[0].shape[-1]
    K = sum(len(w.outs) for w in windows)
    out = torch.full((K, B, TB, R, n2), -1, dtype=torch.int32)
    written = torch.zeros(out.shape, dtype=torch.int32)
    for b in range(B):
        for e0 in range(0, R * n2, run):
            cells = [divmod(e, n2) for e in range(e0, min(e0 + run, R * n2))]
            wsm = {}
            for r in sorted({r for r, _j in cells}):
                i = i0 + r
                for mode in (RL, RI):
                    for t, X in enumerate(tables):
                        col = []
                        for d in range(s + 1):
                            ra, cb = (i + s - d + 1, i + s) if mode == RL else (i, i + d - 1)
                            ok = d >= 1 and 0 <= ra < n2 and 0 <= cb < n2
                            col.append(int(X[b, ra, cb]) if ok else INF)
                        wsm[r, mode, t] = col
            for tt0 in range(0, TB, 2):
                for mode, g1, parts, outs in windows:
                    for tt in range(tt0, min(tt0 + 2, TB)):
                        for r, j in cells:
                            i = i0 + r
                            bound = ((i + s) - (j + tt + 2) - g1 if mode == RL
                                     else ((j - i) - g1 if i >= 1 else 0))
                            best = [INF] * len(outs)
                            for win, d0 in parts:
                                TBw, U, Rw = win.shape[1:4]
                                if r >= Rw or bound < 1:
                                    continue
                                for u in range(max(0, d0 - bound), U):
                                    if tt < TBw:
                                        v = int(win[b, tt, u, r, j])
                                        key = (id(win), b, tt, u, r, j)
                                        loads[key] = loads.get(key, 0) + 1
                                    else:
                                        v = SAT16
                                    for q, (t, _k) in enumerate(outs):
                                        best[q] = min(best[q], v + wsm[r, mode, t][d0 - u])
                            for q, (_t, k) in enumerate(outs):
                                out[k, b, tt, r, j] = best[q]
                                written[k, b, tt, r, j] += 1
    assert bool((written == 1).all())
    return out


def _random_tables(rng, B, n2):
    """Three [B, n2, n2] tables: small energies, a fifth INF."""
    out = []
    for _ in range(3):
        x = rng.integers(-400, 400, (B, n2, n2)).astype(np.int32)
        x[rng.random(x.shape) < 0.2] = INF
        out.append(torch.from_numpy(x))
    return out


def _random_windows(rng, B, TB, R, n2, s):
    """Four windows over three packed segments each (the first with the
    span's tt rows, the others fewer, with fewer rows and spans; the last
    segment's spans partly at d <= 0): RL shared by two tables, RL alone,
    RI shared, RI alone; planes in a shuffled order."""
    segs = ((TB, 5, R, s), (TB - 2, 4, R - 2, s - 5), (2, 4, R, 3))

    def part(TBw, U, Rw, d0):
        x = rng.integers(-3000, 3000, (B, TBw, U, Rw, n2)).astype(np.int16)
        x[rng.random(x.shape) < 0.3] = SAT16
        return torch.from_numpy(x), d0

    planes = [int(k) for k in rng.permutation(6)]
    outs = ([(0, planes[0]), (1, planes[1])], [(2, planes[2])],
            [(1, planes[3]), (2, planes[4])], [(0, planes[5])])
    return [cuda_ops.HistWindow(mode, g1, [part(*sg) for sg in segs], o)
            for (mode, g1), o in zip(((RL, 0), (RL, 1), (RI, 0), (RI, 1)), outs)]


@pytest.mark.parametrize("g1,i0", [(0, 0), (1, 3), (0, 2), (1, 6)])
def test_kernel_loop_equals_plain(g1, i0):
    rng = np.random.default_rng(7 + g1 * 10 + i0)
    B, TB, R, n2, s = 2, 6, 5, 9, 8
    windows = [w._replace(g1=w.g1 + g1) for w in _random_windows(rng, B, TB, R, n2, s)]
    tables = _random_tables(rng, B, n2)
    cut, K = cuda_ops.history_windows(windows, tables, R, s)
    assert K == 6 and all(len(w.parts) == 3 for w in cut)
    loads = {}
    want = _kernel_walk(cut, tables, s, i0, TB, R, loads)
    got = cuda_ops.history_min(windows, tables, s=s, i0=i0, TB=TB, R=R)
    assert torch.equal(got, want)
    assert set(loads.values()) == {1}                 # each element read once
    assert bool((got < INF).any()) and bool((got == INF).any())
    # off-table weights: RL's l = i + s >= n2 on the last rows
    assert i0 + R - 1 + s >= n2


def test_history_min_refuses_operands_that_do_not_fit():
    rng = np.random.default_rng(1)
    B, TB, R, n2, s = 1, 4, 3, 6, 5
    tables = _random_tables(rng, B, n2)
    (win, d0), *_ = _random_windows(rng, B, TB, R, n2, s)[1].parts
    kw = dict(s=s, i0=0, TB=TB, R=R)

    def one(parts, outs=((0, 0),), mode=RL, tabs=tables):
        return cuda_ops.history_min([(mode, 0, parts, list(outs))], tabs, **kw)

    assert one([(win, d0)]).shape == (1, B, TB, R, n2)
    for bad in ([(win[..., :5], d0)], [(win.to(torch.int32), d0)],
                [(torch.cat([win, win], dim=3), d0)], [(win, s + 1)]):
        with pytest.raises(ValueError):
            one(bad)
    with pytest.raises(ValueError):                      # past the kernel's parts
        one([(win, d0)] * (cuda_ops.HISTORY_MAX_PARTS + 1))
    with pytest.raises(ValueError):
        one([(win, d0)], mode=2)
    for outs in (((0, 1),), ((0, 0), (1, 0)), ((3, 0),), ((0, 0), (1, 1), (2, 2))):
        with pytest.raises(ValueError):
            one([(win, d0)], outs)
    for tabs in ([t.to(torch.int64) for t in tables], [t[..., :5] for t in tables],
                 tables * 2, []):
        with pytest.raises(ValueError):
            one([(win, d0)], tabs=tabs)
    with pytest.raises(ValueError):
        cuda_ops.history_min([(RL, 0, [(win, d0)], [(0, k)])
                              for k in range(cuda_ops.HISTORY_MAX_WINDOWS + 1)], tables, **kw)


def test_history_min_on_cpu_counts_no_launch():
    rng = np.random.default_rng(2)
    windows = _random_windows(rng, 1, 4, 3, 6, 5)
    before = cuda_ops.HISTORY_LAUNCHES
    out = cuda_ops.history_min(windows, _random_tables(rng, 1, 6), s=5, i0=0, TB=4, R=3)
    assert cuda_ops.HISTORY_LAUNCHES == before
    assert out.dtype == torch.int32 and tuple(out.shape) == (6, 1, 4, 3, 6)


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
    windows = [(m, g, [(_CudaTyped(x), d0) for x, d0 in parts], o)
               for m, g, parts, o in _random_windows(rng, 1, 4, 3, 6, 5)]
    tables = [_CudaTyped(t) for t in _random_tables(rng, 1, 6)]
    before = cuda_ops.HISTORY_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.history_min(windows, tables, s=5, i0=0, TB=4, R=3)
    assert cuda_ops.HISTORY_LAUNCHES == before
