"""The gapped step's cross-span assembly and write-back, ``cuda_ops.span_assemble``
and ``span_store`` (``csrc/assemble.cu`` / ``csrc/store.cu`` on the card,
their plain versions ``span_assemble_ref`` / ``span_store_ref`` here), bit
for bit (tolerance zero: integer data), against the JAX package's span step:

* the tt loop's operands the port's span step assembles (PLs, PRs, POs,
  mdp0 and the seven reduction bases: ``gapped4.run_tt_loop``'s arguments)
  against the JAX step's own (its ``ccj_tpu.engine.ttloop.tt_loop``'s,
  taken by a spy under the same jit that gives the state after the step):
  - dense: the state of an n=24 ``fill6`` before span 12, for B=1 (each
    of two sequences), B=2 (their states stacked) and the rows [9, 13) of
    a row shard (``dist.wavefront``'s span loop with P=3 CPU shards);
  - packed: a random n=37 state in ``segments7(37)``'s two segments at span
    33, whose reads reach both segments (segment 0's tt rows, fewer than
    the span's, and ``PfromL``'s C skew);
* the whole state after the step (every family, C skew, PKD and PKE)
  against the JAX step's: ``span_gapped4`` for B=1 and B=2,
  ``span_gapped7`` (the JAX PKE per segment against the port's dense one
  on each segment's extents) and the row-sharded write-back (every shard's
  ``span_store``, the C rows other shards own put through the transport);
* refusals; no launch counted on the CPU; CUDA operands without the kernel
  library raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccj_tpu.engine import gapped4 as jg4
from ccj_tpu.engine import gapped5 as jg5
from ccj_tpu.engine import ttloop as jttloop
from ccj_tpu.engine import fold as jfold
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.dist import wavefront
from ccj_tpu_torch.engine import cuda_ops, gapped4, gapped5
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.gapped import C_MATS, M4_NAMES, WX, step_tables

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
SEQS = ("GGGAAACGGGCGAUCCUUCCCGAA", "GCGCAAUUGCGCGGCGCUUGCGCC")   # n = 24
SEQ37 = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
SPAN = 12
LOOP_ARGS = ("PLs", "PRs", "POs", "mdp0")
BIG = (*M4_NAMES, *("C_" + m for m in C_MATS), "PKD", "PKE")


class _Stop(Exception):
    pass


def _consts(seq):
    sp = scale_parameters(parse_par(PAR))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C_np = {**jfold.build_consts(tabs, sp, DEFAULT_PK, device=False), "n": tabs.n}
    C, SC4 = tfold.consts_from_numpy(C_np, "cpu")
    return sp, tabs, C_np, SC4, {**C, "n": tabs.n}


def _jax_step(key, step, C_np, sc4_np, st):
    """(the state after ``step(C, SC4, st)``, the tt loop's arguments
    {PLs, PRs, POs, mdp0, bases}) of the JAX span step, from one jit whose
    array arguments are the tables and the state (the scalars are fixed),
    so sequences of one length share a compile (``key`` names the step)."""
    scalars = {k: v for k, v in C_np.items() if isinstance(v, (int, np.integer))}
    arrays = {k: v for k, v in C_np.items() if k not in scalars}
    mp = pytest.MonkeyPatch()
    real = jttloop.tt_loop

    def run(arrays, sc4, st):
        got = {}

        def grab(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0, *rest):
            got.update(bases=bases, PLs=PLs, PRs=PRs, POs=POs, mdp0=mdp0)
            return real(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0, *rest)

        mp.setattr(jttloop, "tt_loop", grab)
        try:
            return step({**arrays, **scalars}, sc4, st), got
        finally:
            mp.undo()

    key = (key, tuple(sorted(scalars.items())))
    fn = _JITS.setdefault(key, jax.jit(run))
    new, got = fn(arrays, sc4_np, st)
    return ({k: np.asarray(v) for k, v in new.items()},
            {k: (np.asarray(v) if k != "bases" else {b: np.asarray(x) for b, x in v.items()})
             for k, v in got.items()})


_JITS = {}


def _port_args(fn, keep=lambda kw: True):
    """Run ``fn()`` with a spy on ``gapped4.run_tt_loop`` that keeps the
    arguments of the calls ``keep`` accepts (by keyword) and runs the real
    loop; returns (fn's result, the kept calls' arguments)."""
    seen = []
    real = gapped4.run_tt_loop
    names = ("C", "SC4", "WBt", "WPt", "WBPg", "bases", *LOOP_ARGS, "valid4", "s", "TB",
             "IB", "i0")

    def spy(*args):
        kw = dict(zip(names, args))
        if keep(kw):
            seen.append({"bases": {k: v.clone() for k, v in kw["bases"].items()},
                         **{k: kw[k].clone() for k in LOOP_ARGS}, "i0": kw.get("i0", 0),
                         "IB": kw["IB"]})
        return real(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(gapped4, "run_tt_loop", spy)
    try:
        out = fn()
    finally:
        mp.undo()
    return out, seen


def _assert_args(got, want, b=0, rows=slice(None)):
    for k in LOOP_ARGS:
        assert np.array_equal(got[k][b].numpy(), want[k][:, rows]), k
    assert set(got["bases"]) == set(want["bases"])
    for k, v in want["bases"].items():
        assert np.array_equal(got["bases"][k][b].numpy(), v[:, rows]), f"base {k}"


def _assert_state(got, want, names, b=0):
    for k in names:
        assert np.array_equal(got[k][b].numpy(), want[k]), k


# ---------------------------------------------------------------------------
# dense: the n=24 fill's state before span 12
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """Per sequence: (the port's batched C and SC4, its fill6 state before
    span SPAN, TB, IB, the JAX state after the step and its tt loop's
    arguments, (C, SC4, sp, tabs))."""
    out = []
    for seq in SEQS:
        sp, tabs, C_np, SC4, C = _consts(seq)
        seen = {}
        real = tfold.span_gapped4

        def spy(C_, SC4_, st, s, TB, IB):
            if s == SPAN:
                # the tables without the fill's kept weight tables (derived
                # from the state: the cases below build their own states and
                # add their tables, step_tables)
                seen.update(st={k: v.clone() for k, v in st.items()},
                            C={k: v for k, v in C_.items() if k != WX}, SC4=SC4_,
                            TB=TB, IB=IB)
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
        st, TB, IB = seen["st"], seen["TB"], seen["IB"]
        st_j = {k: jnp.asarray(v[0].numpy()) for k, v in st.items()}
        sc4_np = {k: v.numpy() for k, v in SC4.items()}
        new, args = _jax_step(("dense", TB, IB),
                              lambda C, S4, st: jg4.span_gapped4(C, S4, st, SPAN, TB, IB),
                              C_np, sc4_np, st_j)
        out.append((seen["C"], seen["SC4"], st, TB, IB, new, args, (C, SC4, sp, tabs)))
    return out


@pytest.mark.parametrize("b", [0, 1])
def test_dense_assembly_and_state_match_jax(dense, b):
    C, SC4, st, TB, IB, new, args, _ = dense[b]
    st = {k: v.clone() for k, v in st.items()}
    _, seen = _port_args(lambda: gapped4.span_gapped4(step_tables(C, st), SC4, st, SPAN, TB,
                                                      IB))
    assert len(seen) == 1
    _assert_args(seen[0], args)
    assert (args["PLs"] < INF).any() and (args["POs"] < INF).any()
    _assert_state(st, new, BIG)
    # the step wrote span SPAN's slots: cells set below SAT16 in every kind
    assert all((new[k][:, SPAN] < SAT16).any() for k in ("PL", "PK", "C_PfromO", "PKD"))


def test_dense_batch_of_two(dense):
    (C0, S0, st0, TB, IB, new0, args0, _), (C1, S1, st1, _, _, new1, args1, _) = dense
    C = {k: torch.cat([v, C1[k]]) if isinstance(v, torch.Tensor) else v for k, v in C0.items()}
    SC4 = {k: torch.cat([v, S1[k]]) for k, v in S0.items()}
    st = {k: torch.cat([st0[k], st1[k]]) for k in st0}
    _, seen = _port_args(lambda: gapped4.span_gapped4(step_tables(C, st), SC4, st, SPAN, TB,
                                                      IB))
    for b, (new, args) in enumerate(((new0, args0), (new1, args1))):
        _assert_args(seen[0], args, b)
        _assert_state(st, new, BIG, b)


def test_row_shard_assembly_and_write_back_match_jax(dense):
    """P=3 row shards at span 12: shard 1's tt loop operands (rows [9, 13),
    its fixed-offset reads' halo row a piece of shard 2's) and the state
    after every shard's write-back (C rows put across shards) equal the
    JAX step's."""
    *_, new, args, (C, SC4, sp, tabs) = dense[0]
    n = tabs.n
    stop_at = wavefront.compute_WMv_WMp_WM_span

    def stop(C_, st_, s, dangles):
        if s == SPAN:
            raise _Stop
        return stop_at(C_, st_, s, dangles)

    st = wavefront.ShardedState(n, ["cpu"] * 3)
    mp = pytest.MonkeyPatch()
    mp.setattr(wavefront, "compute_WMv_WMp_WM_span", stop)

    def run():
        try:
            with torch.inference_mode():
                wavefront._fill_sharded(C, SC4, sp.dangles, st)
        except _Stop:
            pass

    try:
        _, seen = _port_args(run, keep=lambda kw: kw["s"] == SPAN)
    finally:
        mp.undo()
    assert [(a["i0"], a["IB"]) for a in seen] == [(0, 9), (9, 4)]
    for a in seen:
        _assert_args(a, args, rows=slice(a["i0"], a["i0"] + a["IB"]))
    got = st.gather()
    for k in BIG:
        assert np.array_equal(got[k].numpy(), new[k]), k


# ---------------------------------------------------------------------------
# packed: a random n=37 state in segments7(37)'s two segments
# ---------------------------------------------------------------------------

def _random_packed(n, SEGS, rng, st):
    """Random int16 blocks for every packed family, C skew, PKD and PKE (one
    in three SAT16), random WBP / WPP."""
    for k in ("WBP", "WPP"):
        x = rng.integers(-600, 600, st[k].shape).astype(np.int32)
        x[rng.random(x.shape) < 0.2] = INF + 1
        st[k] = torch.from_numpy(x)

    def block(shape):
        x = rng.integers(-2000, 2000, shape).astype(np.int16)
        x[rng.random(shape) < 0.3] = SAT16
        return torch.from_numpy(x)

    n2, T, S = n + 2, n - 1, n
    for g, (lo, hi, TB, IB, Lc) in enumerate(SEGS):
        for m in gapped5.M4_STORED:
            st[f"{m}@{g}"] = block((1, TB, hi - lo, IB, n2))
        for m in C_MATS:
            st[f"C_{m}@{g}"] = block((1, TB, hi - lo, Lc, n2))
    st["PKD"] = block((1, T, S, n2, n2))
    st["PKE"] = block((1, T, S + T + 2, n2, n2))
    return st


def _pke_segment(PKE, n, lo, hi):
    """The dense PKE on segment [lo, hi)'s extents: the JAX PKE@g layout."""
    T = n - 1
    return PKE[..., :max(min(n - lo, T), 1), lo:hi, :n - lo + 2, :]


def test_packed_assembly_and_state_match_jax():
    n, s, gi = len(SEQ37), 33, 1
    SEGS = gapped5.segments7(n)
    assert len(SEGS) == 2 and SEGS[1][0] == 31              # span 32 lies in segment 1,
    sp, tabs, C_np, SC4, C = _consts(SEQ37)                  # span 31's reads in 0
    st = _random_packed(n, SEGS, np.random.default_rng(37), tfold.init_state_2d(n, "cpu"))
    st_j = {k: jnp.asarray(v[0].numpy()) for k, v in st.items() if k != "PKE"}
    for g, (lo, hi, *_r) in enumerate(SEGS):
        st_j[f"PKE@{g}"] = jnp.asarray(_pke_segment(st["PKE"][0], n, lo, hi).numpy())
    sc4_np = {k: v.numpy() for k, v in SC4.items()}
    new, args = _jax_step("packed", lambda C, S4, st: jg5.span_gapped7(C, S4, st, s, gi, SEGS),
                          C_np, sc4_np, st_j)
    Cb, SC4b = tfold.add_batch(C), tfold.add_batch(SC4)
    _, seen = _port_args(lambda: gapped5.span_gapped7(step_tables(Cb, st), SC4b, st, s, gi,
                                                      SEGS))
    _assert_args(seen[0], args)
    assert (args["PLs"] < INF).any() and (args["PRs"] < INF).any()
    names = [k for k in st if "@" in k or k == "PKD"]
    _assert_state(st, new, names)
    for g, (lo, hi, *_r) in enumerate(SEGS):
        assert np.array_equal(_pke_segment(st["PKE"][0], n, lo, hi).numpy(),
                              new[f"PKE@{g}"]), g


# ---------------------------------------------------------------------------
# the plain versions' contract
# ---------------------------------------------------------------------------

def _small_operands(rng, B=1, n=10, s=6, TB=8, IB=6):
    """Random span_assemble / span_store operands of a small span."""
    n2 = n + 2
    i16 = lambda shape: torch.from_numpy(                           # noqa: E731
        rng.integers(-2000, 2000, shape).astype(np.int16))
    i32 = lambda shape: torch.from_numpy(                           # noqa: E731
        rng.integers(-2000, 2000, shape).astype(np.int32))
    view = i16((B, n - 1, n2, n2))
    planes = [[(view, c, di)] for _nm, c, _b, di, _dj in cuda_ops.ASSEMBLE_READS]
    hist = [i32((B, TB, IB, n2)) for _ in cuda_ops.ASSEMBLE_HISTORY]
    tables = (torch.from_numpy(rng.random((B, n2, n2)) < 0.5), i32((B, n2, n2)),
              i32((B, n2, n2)))
    akw = dict(s=s, n=n, i0=0, TB=TB, IB=IB, ap=341, bp=56, cp=12, PB=246)
    loops = {k: i32((B, TB, IB, n2)) for k in cuda_ops.STEP_FAMILIES}
    xs = i16((len(cuda_ops.ASSEMBLED), B, TB, IB, n2))
    dest = i16((B, TB, n2, n2))
    return (planes, i32((B, TB, IB, n2)), i32((B, TB, IB, n2)), hist, tables, akw,
            [cuda_ops.StoreDest("PL", dest)], loops, xs)


def test_span_functions_refuse_operands_that_do_not_fit():
    rng = np.random.default_rng(5)
    planes, pl, pr, hist, tables, akw, dests, loops, xs = _small_operands(rng)
    view = planes[0][0][0]
    cuda_ops.span_assemble(planes, pl, pr, hist, tables, **akw)            # fits
    bad_planes = (planes[:-1], [[(view.to(torch.int32), 1, 1)]] + planes[1:],
                  [[(view[..., :5], 1, 1)]] + planes[1:],
                  [[(view, 1, 1), (view, 1, 2)]] + planes[1:],            # rows overlap
                  [[(view[:, :, :2], 1, 0), (view[:, :, :2], 1, -2),
                    (view[:, :, :2], 1, -4)]] + planes[1:])               # three parts
    for bad in bad_planes:
        with pytest.raises((ValueError, TypeError)):
            cuda_ops.span_assemble(bad, pl, pr, hist, tables, **akw)
    for bad in ((pl[..., :5], pr, hist, tables), (pl, pr.to(torch.int64), hist, tables),
                (pl, pr, hist[:-1], tables), (pl, pr, hist, (tables[1],) + tables[1:]),
                (pl, pr, hist, tables[:2] + (tables[2][..., :5],))):
        with pytest.raises((ValueError, TypeError)):
            cuda_ops.span_assemble(planes, *bad, **akw)
    with pytest.raises(ValueError):
        cuda_ops.span_assemble(planes, pl, pr, hist, tables, **{**akw, "TB": 0})
    skw = dict(s=6, n=10, i0=0, TB=8, IB=6)
    cuda_ops.span_store(dests, loops, xs, **skw)                           # fits
    d = dests[0].view
    for bad in ([cuda_ops.StoreDest("P?", d)], [cuda_ops.StoreDest("PL", d.to(torch.int32))],
                [cuda_ops.StoreDest("PK", d, 1, True)],                   # skewed with r0
                [cuda_ops.StoreDest("PL", d[..., :5])],
                [cuda_ops.StoreDest("PL", d)] * (cuda_ops.STORE_MAX_DESTS + 1)):
        with pytest.raises((ValueError, TypeError)):
            cuda_ops.span_store(bad, loops, xs, **skw)
    with pytest.raises(ValueError):
        cuda_ops.span_store(dests, {k: v for k, v in loops.items() if k != "PK"}, xs, **skw)
    with pytest.raises(ValueError):
        cuda_ops.span_store(dests, loops, xs[:7], **skw)


def test_plane_parts_and_store_rows():
    """``plane_slab``'s rule (a part's rows and tt rows from its offsets,
    the rest SAT16) and ``span_store_ref``'s (slab row rd + r0 into row
    rd, SAT16 outside the slab and past its tt rows; skewed, column i0 +
    rd + a), against a loop over the cells."""
    rng = np.random.default_rng(8)
    B, TB, IB, n2 = 2, 5, 4, 9
    a = torch.from_numpy(rng.integers(-100, 100, (B, 3, 2, n2)).astype(np.int16))
    c = torch.from_numpy(rng.integers(-100, 100, (B, 7, 5, n2)).astype(np.int16))
    parts = [(a, 1, -1), (c, -2, -3)]                    # rows 1..2 from a, 3 from c
    got = cuda_ops.plane_slab(parts, B, TB, IB, n2, "cpu")
    for tt in range(TB):
        for r in range(IB):
            v, t0, r0 = (a, 1, -1) if r in (1, 2) else (c, -2, -3)
            ok = 0 <= tt + t0 < v.shape[1] and 0 <= r + r0 < v.shape[2]
            want = v[:, tt + t0, r + r0] if ok else torch.full((B, n2), SAT16)
            if r == 0:
                want = torch.full((B, n2), SAT16)       # no part holds row 0
            assert torch.equal(got[:, tt, r], want.to(torch.int16)), (tt, r)
    n, s, i0 = 9, 5, 2                                   # n2 = 11
    n2 = n + 2
    xs = torch.from_numpy(rng.integers(-100, 100, (8, B, TB, IB, n2)).astype(np.int16))
    loops = {k: torch.full((B, TB, IB, n2), 7, dtype=torch.int32)
             for k in cuda_ops.STEP_FAMILIES}
    dests = [cuda_ops.StoreDest("PO", torch.zeros((B, TB + 2, 7, n2), dtype=torch.int16), -2),
             cuda_ops.StoreDest("PR", torch.zeros((B, TB - 1, 2, n2), dtype=torch.int16), 3),
             cuda_ops.StoreDest("PK", torch.zeros((B, TB + 1, 6, n2), dtype=torch.int16),
                                skew=True)]
    cuda_ops.span_store(dests, loops, xs, s=s, n=n, i0=i0, TB=TB, IB=IB)
    valid = cuda_ops.span_valid(n, s, i0, TB, IB, n2)
    for fam, view, r0, skew in dests:
        for tt in range(view.shape[1]):
            for rd in range(view.shape[2]):
                for j in range(n2):
                    r = rd + r0
                    col = i0 + r + j if skew else j
                    want = SAT16
                    if tt < TB and 0 <= r < IB and col < n2:
                        if fam == "PK":
                            want = 7 if valid[tt, r, col] else SAT16
                        else:
                            want = int(xs[cuda_ops.ASSEMBLED.index(fam), 0, tt, r, col])
                    assert int(view[0, tt, rd, j]) == want, (fam, tt, rd, j)


def test_span_functions_on_cpu_count_no_launch(dense):
    C, SC4, st, TB, IB, *_ = dense[0]
    st = {k: v.clone() for k, v in st.items()}
    before = (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES)
    gapped4.span_gapped4(step_tables(C, st), SC4, st, SPAN, TB, IB)
    assert (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES) == before


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    wrapper inspects before it needs the kernel library."""

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


def test_span_functions_on_cuda_raise_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernels: without nvcc the wrappers raise (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    rng = np.random.default_rng(9)
    planes, pl, pr, hist, tables, akw, dests, loops, xs = _small_operands(rng)
    cu = _CudaTyped
    before = (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.span_assemble([[(cu(v), t0, r0) for v, t0, r0 in p] for p in planes],
                               cu(pl), cu(pr), [cu(h) for h in hist],
                               tuple(cu(x) for x in tables), **akw)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.span_store([cuda_ops.StoreDest(d.family, cu(d.view)) for d in dests],
                            {k: cu(v) for k, v in loops.items()}, cu(xs),
                            s=6, n=10, i0=0, TB=8, IB=6)
    assert (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES) == before


def test_assemble_history_keys_are_the_scans():
    assert set(cuda_ops.ASSEMBLE_HISTORY) == {k for k, *_ in gapped4.HISTORY_SCANS}
    assert len(cuda_ops.ASSEMBLE_HISTORY) == len(gapped4.HISTORY_SCANS)
    assert set(cuda_ops.STORE_SOURCES) == set(M4_NAMES)
