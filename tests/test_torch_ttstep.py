"""The port's step-by-step tt loop (``ttloop.run_tt_loop_steps``, two
launches a step on the card) through its step's plain version
(``cuda_ops.tt_step_ref``) against the JAX package's
``ttloop.run_tt_loop_unstacked``, bit for bit (tolerance zero: integer
data); ``tests/test_torch_ttspan.py`` holds the fills' loop
(``ttloop.run_tt_loop``, one ``tt_span`` a span) the same way:

* on the operands of a span in the middle of an n=24 fill (dangles 2),
  taken from the port's ``fill6`` as it calls ``run_tt_loop`` (both
  packages fill from identical tables, ``consts_from_numpy``), for B=1,
  for B=2 (two sequences' spans stacked on the batch axis, each against
  its own JAX loop) and for a row slice from ``i0 > 0`` (against those
  rows of the JAX loop over every row);
* the PM stencil of the plain step against a numpy restatement of its
  index formula, on random data whose DPM is not symmetric in (d1, d2);
* ``StepTable`` refuses operands of the wrong shape, type or device, and
  CUDA operands when the kernel library cannot be built (no fallback);
  ``tt_step`` on CPU tensors counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine.gapped4 import build_sc4 as jax_build_sc4
from ccj_tpu.engine.ttloop import run_tt_loop_unstacked
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.engine import cuda_ops, gapped4
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.gapped import DS
from ccj_tpu_torch.engine.ttloop import LOOP_MATS_ALL, run_tt_loop, run_tt_loop_steps

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
SEQS = ("GGGAAACGGGCGAUCCUUCCCGAA", "GCGCAAUUGCGCGGCGCUUGCGCC")   # n = 24
SPAN = 12                       # the middle of the fill: spans 1 .. 24
ARG_NAMES = ("C", "SC4", "WBt", "WPt", "WBPg", "bases", "PLs", "PRs", "POs",
             "mdp0", "valid4", "s", "TB", "IB", "i0")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def spans():
    """Per sequence: its JAX host constants, JAX stencil tables and the
    arguments the port's fill6 passes to run_tt_loop at span SPAN."""
    sp = scale_parameters(parse_par(PAR))
    out = []
    for seq in SEQS:
        tabs = build_seq_tables(seq, sp, DEFAULT_PK)
        C_np = jfold.build_consts(tabs, sp, DEFAULT_PK, device=False)
        sc4_np = {k: np.asarray(v) for k, v in jax_build_sc4(tabs).items()}
        C, SC4 = tfold.consts_from_numpy(C_np, "cpu", sc4_np)
        seen = {}

        def spy(*args, **kw):
            if args[11] == SPAN:
                seen.update(zip(ARG_NAMES, _clone(args + tuple(kw.values()))))
            return run_tt_loop(*args, **kw)

        mp = pytest.MonkeyPatch()
        mp.setattr(gapped4, "run_tt_loop", spy)
        try:
            tfold.fill6(C, SC4, tabs.n, sp.dangles)
        finally:
            mp.undo()
        assert seen, "fill6 never reached the span"
        out.append((C_np, sc4_np, seen))
    return out


def _jax_loop(C_np, sc4_np, a, b=0):
    """The JAX tt loop on batch element b of the captured arguments a."""
    C = {**C_np, "n": a["C"]["n"]}
    el = lambda x: jnp.asarray(x[b].numpy())            # noqa: E731
    got = run_tt_loop_unstacked(
        C, sc4_np, el(a["WBt"]), el(a["WPt"]), el(a["WBPg"]),
        {k: el(v) for k, v in a["bases"].items()}, el(a["PLs"]), el(a["PRs"]),
        el(a["POs"]), el(a["mdp0"]), jnp.asarray(a["valid4"].numpy()),
        a["s"], a["TB"], a["IB"])
    return {k: np.asarray(v) for k, v in got.items()}


@pytest.fixture(scope="module")
def jax_loops(spans):
    return [_jax_loop(C_np, sc4_np, a) for C_np, sc4_np, a in spans]


def _port_loop(a, i0=0, rows=None, loop=run_tt_loop_steps):
    """The port's ``loop`` (the step-by-step one by default) on the
    captured arguments a (with rows [i0, i0 + rows) of the row planes where
    rows is given)."""
    IB = a["IB"] if rows is None else rows
    cut = (lambda x: x) if rows is None else (lambda x: x[..., i0:i0 + rows, :])
    got = loop(a["C"], a["SC4"], a["WBt"], a["WPt"], a["WBPg"],
                      {k: cut(v) for k, v in a["bases"].items()}, cut(a["PLs"]),
                      cut(a["PRs"]), cut(a["POs"]), cut(a["mdp0"]),
                      cut(a["valid4"]), a["s"], a["TB"], IB, i0)
    return {k: v.numpy() for k, v in got.items()}


def _stack(a, b):
    """Two captured argument sets as one batch of two."""
    cat = lambda x, y: torch.cat([x, y])                 # noqa: E731
    out = dict(a)
    for k in ("WBt", "WPt", "WBPg", "PLs", "PRs", "POs", "mdp0"):
        out[k] = cat(a[k], b[k])
    out["bases"] = {k: cat(v, b["bases"][k]) for k, v in a["bases"].items()}
    out["C"] = {k: cat(v, b["C"][k]) if isinstance(v, torch.Tensor) else v
                for k, v in a["C"].items()}
    out["SC4"] = {k: cat(v, b["SC4"][k]) for k, v in a["SC4"].items()}
    for k in ("s", "TB", "IB", "i0"):
        assert a[k] == b[k], k
    assert torch.equal(a["valid4"], b["valid4"])           # shared by the batch
    return out


def test_captured_span_is_mid_fill(spans):
    a = spans[0][2]
    assert a["s"] == SPAN and a["i0"] == 0 and a["TB"] >= SPAN - 1
    assert a["PLs"].shape[0] == 1                          # fill6: a batch of one
    assert bool((a["PLs"] < INF).any())                    # live cells, not pads


@pytest.mark.parametrize("b", [0, 1])
def test_tt_loop_b1_matches_jax(spans, jax_loops, b):
    got = _port_loop(spans[b][2])
    for name in LOOP_MATS_ALL:
        assert np.array_equal(got[name][0], jax_loops[b][name]), name


def test_tt_loop_b2_matches_jax(spans, jax_loops):
    got = _port_loop(_stack(spans[0][2], spans[1][2]))
    for name in LOOP_MATS_ALL:
        for b in (0, 1):
            assert np.array_equal(got[name][b], jax_loops[b][name]), (name, b)


@pytest.mark.parametrize("i0,rows", [(3, 5), (7, 6)])
def test_tt_loop_row_slice_matches_jax(spans, jax_loops, i0, rows):
    a = spans[0][2]
    assert i0 + rows <= a["IB"]
    got = _port_loop(a, i0, rows)
    for name in LOOP_MATS_ALL:
        want = jax_loops[0][name][:, i0:i0 + rows]
        assert np.array_equal(got[name][0], want), name


# ---------------------------------------------------------------------------
# the step on random operands
# ---------------------------------------------------------------------------

def _rand(shape, rng, lo=-30000, hi=32767):
    x = rng.integers(lo, hi, shape, dtype=np.int32)
    x[rng.random(shape) < 0.3] = INF
    return torch.from_numpy(x)


def _operands(B, s, TB, IB, n2, rng):
    """Random operands of one span's step for a batch of B, in the shapes
    run_tt_loop gives them."""
    UB = n2 + TB
    red = _rand((B, cuda_ops.STEP_REDUCTIONS, IB, n2), rng)
    bases = {k: _rand((B, TB, IB, n2), rng) for k in cuda_ops.STEP_BASES}
    cur = {k: _rand((B, 2 * TB + 2, IB, n2), rng) for k in cuda_ops.STEP_FAMILIES}
    cur.update({"B_" + k: _rand((B, 2 * TB + 2, IB, UB), rng)
                for k in cuda_ops.STEP_B_SLABS})
    stm = _rand((B, TB + 64, IB, UB + DS), rng)
    dpm = _rand((B, DS, DS, TB + 3, UB + 5), rng, -400, 400)
    jk = (torch.from_numpy(rng.integers(0, 2, (B, TB, n2), dtype=np.int32)),
          torch.from_numpy(rng.integers(0, 2, (B, TB, n2), dtype=np.int32)),
          _rand((B, TB, n2), rng, -400, 400))
    valid = torch.from_numpy(rng.random((TB, IB, n2)) < 0.8)
    pl, pr, po = (_rand((B, TB, IB, n2), rng) for _ in range(3))
    return red, bases, cur, stm, dpm, jk, valid, pl, pr, po


KW = dict(bp=-90, cp=-60, ap=340, PB=960)


def test_pm_stencil_index_formula():
    """cuda_ops.pm_stencil at every u against the formula written out:
    min(INF, min over admissible d1, d2 of STM[tt + d1 + d2, i, u + d2] +
    DPM[d1 - 1, d2 - 1, tt, u]), with i = i0 + r; DPM differs from its
    (d1, d2) transpose, so a swapped index shows."""
    rng = np.random.default_rng(7)
    B, s, TB, IB, n2, i0 = 2, 40, 40, 6, 44, 3
    UB = n2 + TB
    stm = _rand((B, TB + 64, IB, UB + DS), rng)
    stm[..., UB:] = INF
    dpm = _rand((B, DS, DS, TB, UB), rng, -400, 400)
    assert not torch.equal(dpm, dpm.transpose(1, 2))
    for tt in (0, 5, s - 2):
        got = cuda_ops.pm_stencil(stm, dpm, tt, cuda_ops.pm_bounds(s, IB, UB, "cpu", i0))
        S, D = stm.numpy().astype(np.int64), dpm.numpy().astype(np.int64)
        want = np.full((B, IB, UB), INF, np.int64)
        for r in range(IB):
            i = i0 + r
            for u in range(UB):
                for d1 in range(1, min(DS, u - i - 1 - tt) + 1):
                    for d2 in range(1, min(DS, i + s - u - 3) + 1):
                        want[:, r, u] = np.minimum(
                            want[:, r, u],
                            S[:, tt + d1 + d2, r, u + d2] + D[:, d1 - 1, d2 - 1, tt, u])
        assert np.array_equal(got.numpy(), want), tt


def test_tt_step_on_cpu_counts_no_launch():
    rng = np.random.default_rng(3)
    ops = _operands(2, 10, 16, 5, 18, rng)
    table = cuda_ops.StepTable(*ops, s=10, i0=2, **KW)
    before = (cuda_ops.TT_STEP_LAUNCHES, cuda_ops.LAUNCHES)
    cur = ops[2]
    row = {k: v[:, 4].clone() for k, v in cur.items()}
    cuda_ops.tt_step(table, 4)
    assert (cuda_ops.TT_STEP_LAUNCHES, cuda_ops.LAUNCHES) == before
    for name in cuda_ops.STEP_FAMILIES:           # row tt written, encoded
        got = cur[name][:, 4]
        assert not torch.equal(got, row[name]), name
        assert bool(((got == INF) | (got <= SAT16)).all()), name
    with pytest.raises(ValueError, match="tt=9"):
        cuda_ops.tt_step(table, 9)


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
@pytest.mark.parametrize("which", [0, (1, "PfromL"), (2, "PM"), (2, "B_PK"), 3, 4,
                                   (5, 2), 6, 9])
def test_step_table_refuses_bad_operands(which, how):
    rng = np.random.default_rng(5)
    ops = _operands(1, 10, 16, 5, 18, rng)
    cuda_ops.StepTable(*ops, s=10, i0=0, **KW)               # the good one builds
    err = {"shape": ValueError, "dtype": TypeError, "device": ValueError}[how]
    with pytest.raises(err):
        cuda_ops.StepTable(*_bad(ops, which, how), s=10, i0=0, **KW)


def test_step_table_refuses_a_short_span_and_missing_slabs():
    rng = np.random.default_rng(6)
    ops = _operands(1, 10, 16, 5, 18, rng)
    with pytest.raises(ValueError, match="tt step"):
        cuda_ops.StepTable(*ops, s=1, i0=0, **KW)
    with pytest.raises(ValueError, match="least size"):      # TB = 16 < s - 1
        cuda_ops.StepTable(*ops, s=18, i0=0, **KW)
    cur = {k: v for k, v in ops[2].items() if k != "B_PfromL"}
    with pytest.raises(ValueError, match="B_PfromL"):
        cuda_ops.StepTable(ops[0], ops[1], cur, *ops[3:], s=10, i0=0, **KW)


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    table inspects before it needs the kernel library."""

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def test_step_table_on_cuda_raises_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernel: without nvcc the table raises (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    rng = np.random.default_rng(8)
    ops = _operands(1, 10, 16, 5, 18, rng)
    fake = tuple({k: _CudaTyped(v) for k, v in x.items()} if isinstance(x, dict)
                 else tuple(map(_CudaTyped, x)) if isinstance(x, tuple)
                 else _CudaTyped(x) for x in ops)
    before = cuda_ops.TT_STEP_LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.StepTable(*fake, s=10, i0=0, **KW)
    assert cuda_ops.TT_STEP_LAUNCHES == before
