"""The port's segment-packed fill (``fold.fill7``, engine/gapped5.py) against
the JAX package's ``run_fill(version=7)``.

At the n=37 crossing-band anchor (``segments7(37)``: spans [0, 31) and
[31, 37)) both packages fill from the same host tables
(``consts_from_numpy``); their states must be bit-equal (tolerance zero:
integer data) on the 2-D matrices, PKD, every ``name@g`` and every
``C_name@g``, and each JAX ``PKE@g`` must equal the port's dense PKE on that
segment's extents (the port keeps PKE dense).  On the same two states the
packed ``LazyMats`` of both packages give the same slab for every family
and span, and the port's packed fold gives the corpus golden, the answer
``test_torch_golden.py`` holds the dense fold to."""

import types

import numpy as np
import pytest
import torch

import ccj_tpu_torch.api as tapi
from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine import gapped5 as jg5
from ccj_tpu.engine.gapped4 import build_sc4 as jax_build_sc4
from ccj_tpu.engine.lazy import LazyMats as JaxLazyMats
from ccj_tpu.engine.traceback import Traceback as JaxTraceback
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine import gapped5 as tg5
from ccj_tpu_torch.engine.gapped import C_MATS, M4_NAMES, dims
from ccj_tpu_torch.engine.lazy import LazyMats
from ccj_tpu_torch.engine.traceback import Traceback
from ccj_tpu_torch.params import parse_par as t_parse_par
from ccj_tpu_torch.params import scale_parameters as t_scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables as t_build_seq_tables

from oracle_util import REPO

# one intra-op thread per worker process (see test_torch_fill.py)
torch.set_num_threads(1)

SEQ = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
GOLDEN = ("(((([[[...[[[[[[[))))....]]]]]]].]]].", -994)
PAR = "ccj_tpu/params/rna_DirksPierce09.par"
KEYS_2D = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP")


def test_segments7_matches_jax():
    for n in range(33, 261):
        assert tg5.segments7(n) == jg5.segments7(n), n
    assert len(tg5.segments7(len(SEQ))) == 2
    assert (tg5.MIN_SEG, tg5.DROPPED, tg5.M4_STORED) == \
        (jg5.MIN_SEG, jg5.DROPPED, jg5.M4_STORED)


@pytest.fixture(scope="module")
def states():
    """(SEGS, JAX fill7 state as numpy, the port's fill7 state), one fill
    each (the JAX one compiles for about a minute on a CPU)."""
    sp = scale_parameters(parse_par(REPO / PAR))
    tabs = build_seq_tables(SEQ, sp, DEFAULT_PK)
    C_np = jfold.build_consts(tabs, sp, DEFAULT_PK, device=False)
    sc4_np = {k: np.asarray(v) for k, v in jax_build_sc4(tabs).items()}
    want = jfold.run_fill(tabs, sp, DEFAULT_PK, version=7)
    C, SC4 = tfold.consts_from_numpy(C_np, "cpu", sc4_np)
    SEGS = tg5.segments7(len(SEQ))
    got = tfold.fill7(C, SC4, len(SEQ), sp.dangles, SEGS)
    return SEGS, want, got


def _assert_equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.argwhere(got != want)
    assert len(bad) == 0, (f"{what}: {len(bad)} cells differ, first at "
                           f"{tuple(bad[0])}: port={got[tuple(bad[0])]} "
                           f"jax={want[tuple(bad[0])]}")


def _pke_segment(PKE, n, lo, hi):
    """The dense PKE on segment [lo, hi)'s extents: the JAX PKE@g layout
    (rows m - lo of the m axis, TBE tt rows, IBE i rows)."""
    n2, T, S, U = dims(n)
    TBE, IBE = max(min(n - lo, T), 1), n - lo + 2
    return PKE[:TBE, lo:hi, :IBE, :]


@pytest.mark.parametrize("group", ["2d", "PK skews", "families", "C skews"])
def test_fill7_state_matches_jax(states, group):
    SEGS, want, got = states
    n = len(SEQ)
    if group == "2d":
        for k in KEYS_2D:
            _assert_equal(got[k], want[k], k)
    elif group == "PK skews":
        _assert_equal(got["PKD"], want["PKD"], "PKD")
        for g, (lo, hi, *_r) in enumerate(SEGS):
            _assert_equal(_pke_segment(got["PKE"], n, lo, hi), want[f"PKE@{g}"],
                          f"PKE@{g}")
    else:
        names = tg5.M4_STORED if group == "families" else \
            tuple("C_" + m for m in C_MATS)
        for name in names:
            for g in range(len(SEGS)):
                _assert_equal(got[f"{name}@{g}"], want[f"{name}@{g}"],
                              f"{name}@{g}")
    # the port stores nothing the JAX state lacks, but its dense PKE
    assert set(got) - set(want) == {"PKE"}
    assert set(want) - set(got) == {f"PKE@{g}" for g in range(len(SEGS))}


@pytest.fixture(scope="module")
def lazy_pair(states):
    SEGS, want, got = states
    n = len(SEQ)
    return (LazyMats(got, n, segs=SEGS),
            JaxLazyMats(want, n, segs=jg5.segments7(n)))


@pytest.mark.parametrize("name", M4_NAMES)
def test_packed_lazy_slabs_match_jax(lazy_pair, name):
    """Every span of every family, the three ``DROPPED`` included (read
    through PKD and the C skews)."""
    mine, theirs = lazy_pair
    for ss in range(len(SEQ)):
        _assert_equal(mine._slab(name, ss), theirs._slab(name, ss),
                      f"{name} span {ss}")
    assert (name in mine) == (name in theirs)


def test_packed_fold_gives_golden(states, lazy_pair):
    """The packed state traced back through the port's LazyMats: the
    corpus golden, and the JAX package's traceback of its own packed
    state."""
    SEGS, want, got = states
    sp = t_scale_parameters(t_parse_par(REPO / PAR))
    tabs = t_build_seq_tables(SEQ, sp, DEFAULT_PK)
    mats = LazyMats(got, len(SEQ), segs=SEGS)
    e_dcal, structure = Traceback(tabs, sp, DEFAULT_PK, mats).run()
    assert (structure, e_dcal) == GOLDEN
    assert mats.slab_fetches > 0
    jsp = scale_parameters(parse_par(REPO / PAR))
    jtabs = build_seq_tables(SEQ, jsp, DEFAULT_PK)
    assert JaxTraceback(jtabs, jsp, DEFAULT_PK, lazy_pair[1]).run() == \
        (e_dcal, structure)


def test_fold_past_dense_runs_the_packed_fill_at_true_length(monkeypatch):
    """Past DENSE_MAX_N ``fold`` fills version 7 at the sequence's own
    length (no bucket padding) and reads it through LazyMats with the
    segment schedule (stubbed: no fill runs)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_fill(tabs, P, pk, device, version=None):
        seen.update(n=tabs.n, version=version)
        return {"PL@0": None}

    def fake_lazy(st, n, segs=None):
        seen["segs"] = segs
        raise Stop

    monkeypatch.setattr(tapi, "fill_state", fake_fill)
    monkeypatch.setattr(tapi, "LazyMats", fake_lazy)
    n = tfold.DENSE_MAX_N + 3
    with pytest.raises(Stop):
        tapi.fold("GC" * (n // 2) + "A" * (n % 2), device="cpu", lazy=False)
    assert seen == {"n": n, "version": 7, "segs": tg5.segments7(n)}
    assert tapi._fill_length(n) == n
    assert tapi._fill_length(100) == 100 and tapi._fill_length(101) == 110


def test_default_version_and_overrides(monkeypatch):
    monkeypatch.delenv("CCJ_ENGINE", raising=False)
    assert tfold.default_version(tfold.DENSE_MAX_N) == 6
    assert tfold.default_version(tfold.DENSE_MAX_N + 1) == 7
    for v in ("4", "6", "7"):
        monkeypatch.setenv("CCJ_ENGINE", v)
        assert tfold.default_version(tfold.DENSE_MAX_N) == int(v)
    assert tfold.default_version(200) == 7
    for v in ("1", "3", "8"):
        monkeypatch.setenv("CCJ_ENGINE", v)
        with pytest.raises(ValueError, match="Not to port"):
            tfold.default_version(16)
    monkeypatch.setenv("CCJ_ENGINE", "5")
    with pytest.raises(ValueError, match="unknown fill version"):
        tfold.default_version(16)


@pytest.mark.parametrize("version", [4, 6])
def test_dense_versions_refuse_past_dense_reach(monkeypatch, version):
    """The dense layouts (fill6, and fill4 with its snapshots) stop at
    DENSE_MAX_N: asked for beyond it, through ``CCJ_ENGINE``,
    ``fill_state`` or ``fold``, they raise before anything is allocated
    instead of running out of device memory."""
    n = tfold.DENSE_MAX_N + 1
    monkeypatch.delenv("CCJ_ENGINE", raising=False)
    with pytest.raises(ValueError, match="reaches n = 128"):
        tfold.fill_state(types.SimpleNamespace(n=n), None, None, "cpu", version)
    assert tfold.check_version(version, tfold.DENSE_MAX_N) == version
    monkeypatch.setenv("CCJ_ENGINE", str(version))
    with pytest.raises(ValueError, match="packed fill 7"):
        tfold.default_version(n)

    def no_fill(*a, **kw):
        raise AssertionError("a fill ran")

    monkeypatch.setattr(tapi, "fill_state", no_fill)
    with pytest.raises(ValueError, match="reaches n = 128"):
        tapi.fold("GC" * (n // 2) + "A" * (n % 2), device="cpu")
