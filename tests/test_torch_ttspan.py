"""The fills' tt loop, ``ttloop.run_tt_loop`` (one ``cuda_ops.tt_span`` a
span on the card, its plain version ``tt_span_ref`` here), bit for bit
(tolerance zero: integer data):

* against the JAX package's ``ttloop.run_tt_loop_unstacked`` on the spans
  ``tests/test_torch_ttstep.py`` captures from an n=24 ``fill6``: B=1, B=2
  and a row slice from ``i0 > 0``; and against the step-by-step loop
  (``run_tt_loop_steps``, two launches a step on the card);
* the kernel's reads restated in PyTorch (only the live rows' valid band
  of the families and mdp, each reduction's in-band terms, red_j and the
  PM stencil through the band itself, no B slab and no STM) against
  ``tt_span_ref``: equal on the band, with every cell outside it left as
  it was (the plain loop leaves INF there, the caller's initial value);
* the design's premise: a row's loop reads only its own row, so random
  values in every other row's operands leave its results unchanged;
* the valid cells the kernel computes from ``n`` (``cuda_ops.span_valid``)
  are the fill's ``valid4``;
* ``SpanTable`` refuses operands of the wrong shape, type or device, a span
  past the kernel's limits and missing slabs; ``tt_span`` on CPU tensors
  counts no launch, and CUDA operands without the kernel library raise.
"""

import numpy as np
import pytest
import torch

from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.gapped import DS
from ccj_tpu_torch.engine.ttloop import (LOOP_MATS_ALL, REDUCTIONS, run_tt_loop,
                                         run_tt_loop_steps)

from test_torch_ttstep import _jax_loop, _port_loop, _stack, jax_loops, spans  # noqa: F401

torch.set_num_threads(1)

KW = dict(bp=-90, cp=-60, ap=340, PB=960)


# ---------------------------------------------------------------------------
# the captured n=24 spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [0, 1])
def test_tt_span_b1_matches_jax(spans, jax_loops, b):
    got = _port_loop(spans[b][2], loop=run_tt_loop)
    for name in LOOP_MATS_ALL:
        assert np.array_equal(got[name][0], jax_loops[b][name]), name


def test_tt_span_b2_matches_jax(spans, jax_loops):
    got = _port_loop(_stack(spans[0][2], spans[1][2]), loop=run_tt_loop)
    for name in LOOP_MATS_ALL:
        for b in (0, 1):
            assert np.array_equal(got[name][b], jax_loops[b][name]), (name, b)


@pytest.mark.parametrize("i0,rows", [(3, 5), (7, 6)])
def test_tt_span_row_slice_matches_jax(spans, jax_loops, i0, rows):
    got = _port_loop(spans[0][2], i0, rows, loop=run_tt_loop)
    for name in LOOP_MATS_ALL:
        assert np.array_equal(got[name][0], jax_loops[0][name][:, i0:i0 + rows]), name


@pytest.mark.parametrize("batch,i0,rows", [(1, 0, None), (2, 0, None), (1, 4, 7)])
def test_tt_span_equals_the_step_loop(spans, batch, i0, rows):
    a = spans[0][2] if batch == 1 else _stack(spans[0][2], spans[1][2])
    got = _port_loop(a, i0, rows, loop=run_tt_loop)
    want = _port_loop(a, i0, rows, loop=run_tt_loop_steps)
    for name in LOOP_MATS_ALL:
        assert np.array_equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# random operands
# ---------------------------------------------------------------------------

def _rand(shape, rng, lo=-30000, hi=32767):
    x = rng.integers(lo, hi, shape, dtype=np.int32)
    x[rng.random(shape) < 0.3] = INF
    return torch.from_numpy(x)


def _small(shape, rng):
    x = _rand(shape, rng)
    return torch.where(x == INF, INF, x.clamp(-400, 400))


def _operands(B, TB, IB, n2, rng, s, i0, n):
    """Random operands of one span's SpanTable for a batch of B, in the
    shapes and under the contract run_tt_loop gives them: A slabs with
    2 TB + 2 rows holding SAT16 on the valid cells of the fill's formula
    for n and i0 and INF elsewhere (``ttloop._run_span``); mdp, the bases,
    PL / PR / PO, the weights, DPM and jk random."""
    R = 2 * TB + 2
    validp = cuda_ops.span_valid(n, s, i0, R, IB, n2)
    init = torch.where(validp, SAT16, INF).to(torch.int32)
    cur = {k: init.repeat(B, 1, 1, 1) for k in cuda_ops.STEP_FAMILIES}
    return (cur, _rand((B, R, IB, n2), rng),
            {k: _rand((B, TB, n2 + TB + 1), rng) for k in cuda_ops.SPAN_WEIGHTS},
            {k: _rand((B, TB, n2), rng) for k in cuda_ops.SPAN_WEIGHTS},
            {k: _rand((B, TB, IB, n2), rng) for k in cuda_ops.STEP_BASES},
            _small((B, DS, DS, TB, n2 + TB), rng),
            (torch.from_numpy(rng.integers(0, 2, (B, TB, n2), dtype=np.int32)),
             torch.from_numpy(rng.integers(0, 2, (B, TB, n2), dtype=np.int32)),
             _small((B, TB, n2), rng)),
            *(_rand((B, TB, IB, n2), rng) for _ in range(3)))


def _span(B, TB, IB, n2, rng, s, i0):
    """(operands, SpanTable keywords) of a span of a fill of length n =
    n2 - 2, as the fills run it, raised to n2 + 1 (the longest the kernel
    takes) where that leaves the rows from i0 none live."""
    n = max(n2 - 2, min(n2 + 1, i0 + s))
    return _operands(B, TB, IB, n2, rng, s, i0, n), dict(n=n, s=s, i0=i0, **KW)


def _clone(ops):
    return tuple({k: v.clone() for k, v in x.items()} if isinstance(x, dict)
                 else tuple(v.clone() for v in x) if isinstance(x, tuple)
                 else x.clone() for x in ops)


def _kernel_reads(table):
    """csrc/ttspan.cu's loop restated in PyTorch, reading what the kernel
    reads and writing what it writes.  Before each step every cell outside
    the live rows' valid band (``span_valid`` over all the slab rows, so
    rows >= s - 1 too) is masked to INF in what the step reads, so no value
    there can matter.  Each job of ``cuda_ops.span_jobs()`` is reduced over
    its in-band terms only: red_k at column j for q <= s - 3 - tt - d (s - 4
    - tt - d masked), red_j at column j - 1 - q for q <= d - 1 (d - 2
    masked), d = j - i; the PM stencil over PM's own band rows (STM[tt + d1
    + d2, r, u + d2] = PM[tt + d1 + d2, r, j - d1]), no B slab and no STM.
    The assembly is the plain step's, fed those values, and only the valid
    cells of row tt are written back."""
    o = table.ops
    cur = o["cur"]
    B, IB, n2, s, i0 = table.B, table.IB, table.n2, table.s, table.i0
    band = cuda_ops.span_valid(table.n, s, i0, cur["PM"].shape[1], IB, n2)
    weights = [o["WKX"][k] for k in cuda_ops.SPAN_WEIGHTS] + \
              [o["WJX"][k] for k in cuda_ops.SPAN_WEIGHTS]
    work = {k: torch.full_like(cur[k], INF) for k in cuda_ops.STEP_FAMILIES}
    srcs = [work[k] for k in cuda_ops.STEP_FAMILIES] + [torch.where(band, o["mdp"], INF)]
    inner = cuda_ops.SpanTable(work, srcs[-1], o["WKX"], o["WJX"], o["bases"], o["dpm"],
                               o["jk"], o["pl"], o["pr"], o["po"], n=table.n, s=s, i0=i0,
                               bp=table.bp, cp=table.cp, ap=table.ap, PB=table.PB)
    _, step, red = cuda_ops.span_step_tables(inner)
    UB = step.ops["stm"].shape[-1] - DS
    d = torch.arange(n2)[None, :] - torch.arange(i0, i0 + IB)[:, None]
    for tt in range(s - 2, -1, -1):
        for k in cuda_ops.STEP_FAMILIES:
            work[k].copy_(torch.where(band, cur[k], INF))
        V = band[tt]
        red.fill_(INF)
        for job in cuda_ops.span_jobs():
            S = srcs[job.src]
            for w, out in ((job.w, job.out), (job.w2, job.out2)):
                if w < 0:
                    continue
                acc = red[:, out]
                for q in range(s - 2 - tt):
                    if job.kind == 0:
                        ok = V & (q <= s - 3 - tt - d - job.masked)
                        v = S[:, tt + 1 + q] + weights[w][:, q, None, tt + 2: tt + 2 + n2]
                    else:
                        ok = V & (q <= d - 1 - job.masked)
                        col = (d + torch.arange(i0, i0 + IB)[:, None] - 1 - q).clamp(min=0)
                        v = S[:, tt + 1 + q].gather(-1, col.expand(B, IB, n2)) + \
                            weights[w][:, q, None, :]
                    acc.copy_(torch.where(ok, torch.minimum(acc, v), acc))
        pm = torch.full((B, IB, UB), INF, dtype=torch.int32)
        for d1 in range(1, DS + 1):
            for d2 in range(1, min(DS, s - 3 - tt) + 1):
                ok = V & (d1 <= d - 1) & (d2 <= s - 3 - tt - d)
                if bool(ok.any()):
                    col = (d + torch.arange(i0, i0 + IB)[:, None] - d1).clamp(min=0)
                    v = work["PM"][:, tt + d1 + d2].gather(-1, col.expand(B, IB, n2)) + \
                        o["dpm"][:, d1 - 1, d2 - 1, tt, None, tt: tt + n2]
                    win = pm[..., tt: tt + n2]
                    win.copy_(torch.where(ok, torch.minimum(win, v), win))
        real = cuda_ops.pm_stencil
        cuda_ops.pm_stencil = lambda *_a, pm=pm: pm
        try:
            cuda_ops.tt_step_ref(step, tt)
        finally:
            cuda_ops.pm_stencil = real
        for k in cuda_ops.STEP_FAMILIES:
            cur[k][:, tt] = torch.where(V, work[k][:, tt], cur[k][:, tt])


@pytest.mark.parametrize("B,s,TB,IB,n2,i0", [(1, 12, 16, 9, 18, 0), (2, 20, 24, 8, 30, 3),
                                             (1, 40, 40, 6, 44, 5)])
def test_kernel_reads_match_the_plain_loop(B, s, TB, IB, n2, i0):
    """The facts the kernel rests on hold: the live rows' valid band, each
    reduction's in-band terms, red_j and the stencil through the band give
    the plain loop's slabs bit for bit there; every cell outside the band
    (dead rows, rows [0, s - 2] outside it, rows >= s - 1), here random, is
    neither read nor written, and the plain loop leaves INF there, the value
    the caller initialises it to."""
    rng = np.random.default_rng(s)
    ops, kw = _span(B, TB, IB, n2, rng, s, i0)
    want, got = _clone(ops), _clone(ops)
    band = cuda_ops.span_valid(kw["n"], s, i0, 2 * TB + 2, IB, n2)
    assert bool(band.any()) and not bool(band.all(dim=-1).all(dim=0).any())  # live and dead
    for name in cuda_ops.STEP_FAMILIES:
        got[0][name].copy_(torch.where(band, got[0][name], _rand(tuple(band.shape), rng)))
    poison = {k: v.clone() for k, v in got[0].items()}
    cuda_ops.tt_span_ref(cuda_ops.SpanTable(*want, **kw))
    _kernel_reads(cuda_ops.SpanTable(*got, **kw))
    for name in cuda_ops.STEP_FAMILIES:
        assert torch.equal(got[0][name][:, band], want[0][name][:, band]), name
        assert torch.equal(got[0][name][:, ~band], poison[name][:, ~band]), name
        assert bool((want[0][name][:, ~band] == INF).all()), name


def test_span_valid_is_the_fills_valid4(spans):
    """The cells the kernel computes from n are those the fill marks valid."""
    for _, _, a in spans:
        n2 = a["PLs"].shape[-1]
        got = cuda_ops.span_valid(a["C"]["n"], a["s"], a["i0"], a["TB"], a["IB"], n2)
        assert torch.equal(got, a["valid4"])


def _scramble_other_rows(ops, r, rng):
    """ops with every row-dependent operand (A slabs, mdp, bases, PL / PR /
    PO) random in every row but r."""
    def row_axis(x, axis):
        y = x.clone()
        fresh = _rand(tuple(x.shape), rng)
        keep = torch.zeros(x.shape[axis], dtype=torch.bool)
        keep[r] = True
        shape = [1] * x.dim()
        shape[axis] = -1
        return torch.where(keep.view(shape), y, fresh)

    cur, mdp, WKX, WJX, bases, dpm, jk, pl, pr, po = ops
    return ({k: row_axis(v, 2) for k, v in cur.items()}, row_axis(mdp, 2), WKX, WJX,
            {k: row_axis(v, 2) for k, v in bases.items()}, dpm, jk,
            row_axis(pl, 2), row_axis(pr, 2), row_axis(po, 2))


@pytest.mark.parametrize("B,r,i0", [(1, 0, 0), (1, 5, 0), (2, 3, 4), (1, 8, 2)])
def test_a_row_reads_only_its_own_row(B, r, i0):
    """One block per (b, i) row is the kernel's premise: row r's loop,
    every step of it, depends only on row r of the row-dependent operands."""
    s, TB, IB, n2 = 22, 24, 9, 28
    rng = np.random.default_rng(40 + r)
    ops, kw = _span(B, TB, IB, n2, rng, s, i0)
    other = _scramble_other_rows(_clone(ops), r, rng)
    cuda_ops.tt_span_ref(cuda_ops.SpanTable(*ops, **kw))
    cuda_ops.tt_span_ref(cuda_ops.SpanTable(*other, **kw))
    for name in cuda_ops.STEP_FAMILIES:
        assert torch.equal(ops[0][name][:, :, r], other[0][name][:, :, r]), name
    assert not torch.equal(ops[0]["PK"], other[0]["PK"])   # the other rows did move


def test_span_jobs_cover_every_reduction_once():
    seen = []
    for job in cuda_ops.span_jobs():
        for w, out in ((job.w, job.out), (job.w2, job.out2)):
            if out < 0:
                continue
            slab, wn, kind, masked = REDUCTIONS[out]
            fam = slab[2:] if slab.startswith("B_") else slab
            assert job.src == (cuda_ops.STEP_FAMILIES + ("mdp",)).index(fam)
            assert (job.kind, job.masked) == (int(kind == "j"), int(masked))
            assert w == cuda_ops.SPAN_WEIGHTS.index(wn) + (3 if kind == "j" else 0)
            seen.append(out)
    assert sorted(seen) == list(range(len(REDUCTIONS)))
    assert len(cuda_ops.span_jobs()) <= cuda_ops.MAX_SPAN_JOBS


def test_tt_span_on_cpu_counts_no_launch():
    rng = np.random.default_rng(3)
    ops, kw = _span(2, 16, 5, 18, rng, 10, 2)
    table = cuda_ops.SpanTable(*ops, **kw)
    before = (cuda_ops.TT_SPAN_LAUNCHES, cuda_ops.TT_STEP_LAUNCHES, cuda_ops.LAUNCHES)
    rows = {k: v[:, :9].clone() for k, v in ops[0].items()}
    cuda_ops.tt_span(table)
    assert (cuda_ops.TT_SPAN_LAUNCHES, cuda_ops.TT_STEP_LAUNCHES,
            cuda_ops.LAUNCHES) == before
    for name in cuda_ops.STEP_FAMILIES:            # rows 0 .. s - 2 written, encoded
        got = ops[0][name][:, :9]
        assert not torch.equal(got, rows[name]), name
        assert bool(((got == INF) | (got <= SAT16)).all()), name


def _bad(ops, which, how):
    """ops with operand ``which`` (a top-level index, or (index, key))
    made wrong: a row short, the wrong dtype or on another device."""
    ops = list(ops)
    k, key = which if isinstance(which, tuple) else (which, None)
    x = ops[k] if key is None else ops[k][key]
    if how == "shape":
        x = x[:, :0] if x.dim() > 1 else x[:0]
    elif how == "dtype":
        x = x.to(torch.int16) if x.dtype != torch.int16 else x.to(torch.int32)
    else:
        x = torch.empty_like(x, device="meta")
    if key is None:
        ops[k] = x
    elif isinstance(ops[k], dict):
        ops[k] = {**ops[k], key: x}
    else:
        ops[k] = tuple(x if j == key else y for j, y in enumerate(ops[k]))
    return ops


@pytest.mark.parametrize("how", ["shape", "dtype", "device"])
@pytest.mark.parametrize("which", [(0, "PK"), 1, (2, "WB"), (3, "WP"), (4, "PfromR"), 5,
                                   (6, 1), 7, 9])
def test_span_table_refuses_bad_operands(which, how):
    ops, kw = _span(1, 16, 5, 18, np.random.default_rng(5), 10, 0)
    cuda_ops.SpanTable(*ops, **kw)                            # the good one builds
    err = {"shape": ValueError, "dtype": TypeError, "device": ValueError}[how]
    with pytest.raises(err):
        cuda_ops.SpanTable(*_bad(ops, which, how), **kw)


def test_tt_span_phases_needs_the_card():
    """The timing-only entry (phases left out, wrong results) has no plain
    version: on CPU tensors it raises and counts nothing."""
    ops, kw = _span(1, 16, 5, 18, np.random.default_rng(4), 10, 0)
    table = cuda_ops.SpanTable(*ops, **kw)
    before = cuda_ops.TT_SPAN_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ops.tt_span_phases(table, 7)
    assert cuda_ops.TT_SPAN_LAUNCHES == before


def test_span_table_refuses_a_short_span_and_missing_operands():
    ops, kw = _span(1, 16, 5, 18, np.random.default_rng(6), 10, 0)
    kw = {k: v for k, v in kw.items() if k != "s"}
    with pytest.raises(ValueError, match="tt step"):
        cuda_ops.SpanTable(*ops, s=1, **kw)
    with pytest.raises(ValueError, match="least size"):       # weights' TB = 16 < s
        cuda_ops.SpanTable(*ops, s=20, **kw)
    with pytest.raises(ValueError, match="must lie in"):      # n past n2 + 1, or below s
        cuda_ops.SpanTable(*ops, s=10, **{**kw, "n": 20})
    with pytest.raises(ValueError, match="must lie in"):
        cuda_ops.SpanTable(*ops, s=10, **{**kw, "n": 9})
    few = [{k: v[:, :7] for k, v in ops[m].items()} for m in (2, 3)]   # q <= 6 < s - 3
    with pytest.raises(ValueError, match="do not reach"):
        cuda_ops.SpanTable(*ops[:2], *few, *ops[4:], s=10, **kw)
    cur = {k: v for k, v in ops[0].items() if k != "PfromL"}
    with pytest.raises(ValueError, match="PfromL"):
        cuda_ops.SpanTable(cur, *ops[1:], s=10, **kw)
    WKX = {k: v for k, v in ops[2].items() if k != "WBP"}
    with pytest.raises(ValueError, match="WKX"):
        cuda_ops.SpanTable(ops[0], ops[1], WKX, *ops[3:], s=10, **kw)
    bases = {k: v for k, v in ops[4].items() if k != "PLmloop10"}
    with pytest.raises(ValueError, match="bases"):
        cuda_ops.SpanTable(*ops[:4], bases, *ops[5:], s=10, **kw)


def test_span_table_refuses_a_span_past_the_kernels_limits():
    """n2 past MAX_SPAN_N2 (a block's shared memory) and a batch past the
    grid's y blocks raise and name the limit."""
    n2 = cuda_ops.MAX_SPAN_N2 + 2
    ops, kw = _span(1, 4, 1, n2, np.random.default_rng(7), 3, 0)
    with pytest.raises(ValueError, match="MAX_SPAN_N2"):
        cuda_ops.SpanTable(*ops, **kw)
    ops, kw = _span(1, 4, 1, 8, np.random.default_rng(8), 3, 0)
    B = cuda_ops.MAX_GRID_Y + 1
    wide = {k: v.expand(B, *v.shape[1:]) for k, v in ops[0].items()}
    with pytest.raises(ValueError, match=f"limit of {cuda_ops.MAX_GRID_Y}"):
        cuda_ops.SpanTable(wide, *ops[1:], **kw)


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    table inspects before it needs the kernel library."""

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


def test_span_table_on_cuda_raises_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernel: without nvcc the table raises (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    ops, kw = _span(1, 16, 5, 18, np.random.default_rng(9), 10, 0)
    fake = tuple({k: _CudaTyped(v) for k, v in x.items()} if isinstance(x, dict)
                 else tuple(map(_CudaTyped, x)) if isinstance(x, tuple)
                 else _CudaTyped(x) for x in ops)
    before = cuda_ops.TT_SPAN_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.SpanTable(*fake, **kw)
    assert cuda_ops.TT_SPAN_LAUNCHES == before
