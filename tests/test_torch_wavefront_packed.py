"""The port's row-sharded packed fill (``dist.wavefront.fill7_sharded``), with
P shards on CPU devices in one process:

* at n=34 (the seed-42 sequence of tests/test_wavefront_shard.py's
  ``_CHILD8``, 2 segments), P=2 (R = 18) and P=5 (R = 8, the rows padded
  to 40, so the 29-row stencil halo reaches up to four other shards)
  equal the JAX package's ``run_fill(.., version=7)`` on every array both
  hold: the 2-D matrices, PKD, every ``name@g`` and ``C_name@g``, and each
  JAX ``PKE@g`` against the port's dense PKE on that segment's extents;
  tolerance zero (integer data).  The JAX fill runs in a subprocess
  started with the module's first test, as tests/test_torch_wavefront.py
  runs its own;
* every shard's block holds the rows the partition gives it, and
  ``shard_bytes`` equals the arithmetic of that partition (checked on
  the meta device up to n=240);
* the transport counts bytes in each exchange class the fill uses, and
  rows an array does not store read as unset and are not written; at P=2
  the ``shift`` bytes are those of the fill that shipped each RI scan's
  weights to the owner of its C rows, less those weights, and no other
  class moved;
* ``LazyMats(.., segs=segments7(37))`` over a P=2 state folds the n=37
  anchor to its golden line, every slab equal to the unsharded
  ``fill7``'s, moving no more between shards than its slabs and P splits;
* the entry point defaults to CUDA and raises without it;
* with ``CCJ_SLOW`` set, n=64 (3 segments) with P=3 against the port's
  own ``fill7`` (several minutes on one CPU thread).

Both packages fill from identical tables: the JAX package's host constant
dict and stencil tables enter the port through ``consts_from_numpy``.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine.gapped4 import build_sc4 as jax_build_sc4
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.dist import wavefront
from ccj_tpu_torch.dist.wavefront import (CLASSES, RowTransport, ShardedState,
                                          fill7_sharded, row_partition, span_rows)
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import SAT16
from ccj_tpu_torch.engine.gapped import C_MATS, M4_NAMES, dims
from ccj_tpu_torch.engine.gapped5 import M4_STORED, prior_segments, segments7
from ccj_tpu_torch.engine.lazy import LazyMats
from ccj_tpu_torch.engine.traceback import Traceback

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
_rng = random.Random(42)
SEQ34 = "".join(_rng.choice("ACGU") for _ in range(34))   # test_wavefront_shard._CHILD8
ANCHOR = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
ANCHOR_LINE = (-994, "(((([[[...[[[[[[[))))....]]]]]]].]]].")
KEYS_2D = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP")

_CHILD = r"""
import sys
import numpy as np
from ccj_tpu.engine.fold import run_fill
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables

sp = scale_parameters(parse_par(sys.argv[1]))
tabs = build_seq_tables(sys.argv[2], sp, DEFAULT_PK)
np.savez(sys.argv[3], **run_fill(tabs, sp, DEFAULT_PK, version=7))
"""


def _tables(seq, jax_tables=False):
    """(tabs, sp, C, SC4) on the CPU: the JAX package's host constants and
    stencil tables where the fill is held against the JAX fill, else the
    port's own (which tests/test_torch_fill.py holds equal to them)."""
    sp = scale_parameters(parse_par(PAR))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C_np = jfold.build_consts(tabs, sp, DEFAULT_PK, device=False)
    sc4_np = ({k: np.asarray(v) for k, v in jax_build_sc4(tabs).items()}
              if jax_tables else None)
    C, SC4 = tfold.consts_from_numpy(C_np, "cpu", sc4_np)
    return tabs, sp, C, SC4


@pytest.fixture(scope="module", autouse=True)
def jax_fill7(tmp_path_factory):
    """The JAX package's fill 7 at n=34, computed in a subprocess started
    with the module's first test (the JAX comparisons come last, so the
    port's tests run meanwhile); the fixture returns a function that waits
    for it."""
    out = tmp_path_factory.mktemp("wavefront_packed") / "jax_fill7.npz"
    env = dict(os.environ, CCJ_TPU_PLATFORM="cpu", CCJ_COMPILE_CACHE="0",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(PAR), SEQ34, str(out)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    cache = {}

    def wait():
        if not cache:
            _, err = proc.communicate(timeout=1200)
            assert proc.returncode == 0, err.decode()[-3000:]
            with np.load(out) as data:
                cache.update({k: data[k] for k in data.files})
        return cache

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def n34():
    """The port's packed sharded fills at n=34, P=2 and P=5."""
    tabs, sp, C, SC4 = _tables(SEQ34, jax_tables=True)
    SEGS = segments7(tabs.n)
    return SEGS, {P: fill7_sharded(C, SC4, tabs.n, sp.dangles, SEGS, devices=["cpu"] * P)
                  for P in (2, 5)}


def _pke_segment(PKE, n, lo, hi):
    """The dense PKE on segment [lo, hi)'s extents: the JAX PKE@g layout
    (tests/test_torch_packed.py)."""
    n2, T, S, U = dims(n)
    TBE, IBE = max(min(n - lo, T), 1), n - lo + 2
    return PKE[:TBE, lo:hi, :IBE, :]


def _assert_equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.argwhere(got != want)
    assert len(bad) == 0, (f"{what}: {len(bad)} cells differ, first at "
                           f"{tuple(bad[0])}: port={got[tuple(bad[0])]} "
                           f"jax={want[tuple(bad[0])]}")


def _partition_rows(n, R, q, name, SEGS):
    """The global rows [a, b) shard q stores of ``name`` and the unsharded
    array's row of global row a: the partition of the module docstring,
    from the segment schedule."""
    n2 = n + 2
    if name in ("PKD", "PKE"):
        return q * R, (q + 1) * R, q * R
    base, g = name.rsplit("@", 1)
    lo, hi, TB, IB, Lc = SEGS[int(g)]
    if base.startswith("C_"):
        a, b = max(q * R, lo + 1), min((q + 1) * R, lo + 1 + Lc, n2)
        return a, max(a, b), a - lo - 1
    a, b = q * R, min((q + 1) * R, IB)
    return a, max(a, b), a


def test_sharded_state_layout_and_keys():
    """The packed state's keys are fill7's, in its order; the mapping
    reads as a packed state (``fold.state_segments``, ``LazyMats``)."""
    n, SEGS = 34, segments7(34)
    st = ShardedState(n, ["meta"] * 3, SEGS)
    plain = tfold.init_state_2d(n, "meta")
    for g, (lo, hi, *_r) in enumerate(SEGS):
        plain.update({f"{m}@{g}": None for m in M4_STORED})
        plain.update({f"C_{m}@{g}": None for m in C_MATS})
    plain.update(PKD=None, PKE=None)
    assert st.keys() == list(plain)
    assert tfold.state_segments(st, n) == SEGS
    assert "PL@0" in st and "PL" not in st and "V" in st
    assert st.layout["C_PLmloop00@1"] == wavefront.Rows(
        SEGS[1][0] + 1, SEGS[1][4], SEGS[1][0] + 1, n + 2)


@pytest.mark.parametrize("P", [2, 5])
def test_every_block_holds_its_partition_rows(n34, P):
    """Each shard's block of each array holds exactly the global rows the
    partition gives it, and they equal those rows of the gathered
    array."""
    SEGS, states = n34
    st = states[P]
    n = 34
    R, _ = row_partition(n, P)
    assert st.R == R == {2: 18, 5: 8}[P]
    whole = st.gather()
    for name in st.row_names:
        for q, sh in enumerate(st.shards):
            a, b, r0 = _partition_rows(n, R, q, name, SEGS)
            blk = sh[name][0]
            assert blk.shape[-2] == b - a, (name, q)
            real = max(0, min(b, n + 2) - a)             # PKD/PKE pad rows past n2
            assert torch.equal(blk[..., :real, :], whole[name][..., r0:r0 + real, :]), (name, q)
            assert bool((blk[..., real:, :] == SAT16).all()), (name, q)


def _shard_bytes_by_arithmetic(n, P, SEGS):
    n2, T, S, U = dims(n)
    R = -(-n2 // P)
    out = []
    for q in range(P):
        b = 2 * R * n2 * (T * S + T * (S + T + 2))       # PKD, PKE
        for lo, hi, TB, IB, Lc in SEGS:
            fam = max(0, min((q + 1) * R, IB) - q * R)
            crow = max(0, min((q + 1) * R, lo + 1 + Lc, n2) - max(q * R, lo + 1))
            b += 2 * TB * (hi - lo) * n2 * (len(M4_STORED) * fam + len(C_MATS) * crow)
        out.append(b)
    return out


@pytest.mark.parametrize("n,P,gb", [
    (34, 2, None), (34, 5, None),
    (134, 2, (4.07, 2.50)), (134, 4, (2.27, 1.80, 1.37, 1.14)),
    (200, 2, (18.69, 11.15)), (200, 4, (10.76, 8.04, 5.94, 5.19)),
    (240, 2, (38.69, 23.03))])
def test_shard_bytes_follow_the_partition(n, P, gb):
    """``shard_bytes`` equals the partition's arithmetic (on the meta
    device: nothing is allocated), shard 0 holding the most; the figures
    PERF.md quotes, in GB."""
    SEGS = segments7(n)
    st = ShardedState(n, ["meta"] * P, SEGS)
    got = [st.shard_bytes(q) for q in range(P)]
    assert got == _shard_bytes_by_arithmetic(n, P, SEGS)
    assert got == sorted(got, reverse=True)
    if gb is not None:
        assert all(abs(g / 1e9 - w) < 0.006 for g, w in zip(got, gb)), got


def test_transport_with_stored_rows():
    """An array storing only global rows [lo, hi): a shard's tensor starts
    at its first stored row; rows outside read as unset, are dropped on
    a put and count no bytes."""
    n2, R, P, lo, hi = 12, 4, 3, 3, 10
    full = torch.arange(2 * n2 * 5, dtype=torch.int16).reshape(2, n2, 5)
    arrs = [full[:, max(q * R, lo):min((q + 1) * R, hi)].clone() for q in range(P)]
    assert [a.shape[1] for a in arrs] == [1, 4, 2]
    tr = RowTransport([torch.device("cpu")] * P, R, n2)
    whole = lambda t: t                               # noqa: E731
    assert tr.owners(0, n2, (lo, hi)) == [(0, 3, 4), (1, 4, 8), (2, 8, 10)]
    own = tr.fetch(1, arrs, whole, 5, 8, "halo", rows=(lo, hi))
    assert own.data_ptr() == arrs[1][:, 1:4].data_ptr() and tr.bytes["halo"] == 0
    got = tr.fetch(1, arrs, whole, 1, 12, "halo", rows=(lo, hi))
    unset = lambda k: torch.full((2, k, 5), SAT16, dtype=torch.int16)  # noqa: E731
    assert torch.equal(got, torch.cat([unset(2), full[:, lo:hi], unset(2)], dim=1))
    assert tr.bytes["halo"] == 2 * (1 + 2) * 5 * 2       # rows 3 and 8-9
    tr.put(2, arrs, whole, 2, -torch.ones((2, 10, 5), dtype=torch.int16), "shift",
           rows=(lo, hi))
    assert all(bool((a == -1).all()) for a in arrs)
    assert tr.bytes["shift"] == 2 * (1 + 4) * 5 * 2       # shards 0 and 1 only


def test_exchange_classes_add_up(n34):
    """At P=5 (R = 8 < DS) the fill used every exchange class, and the
    per-span counts add up to the totals; the C skews' l rows moved
    (shift) and the PL window's halo reached past one neighbour."""
    SEGS, states = n34
    tr = states[5].transport
    for c in (c for c in CLASSES if c != "read"):
        per_span = sum(v[c] for v in tr.span_bytes.values())
        assert per_span > 0 and per_span == tr.bytes[c], c
    assert set(tr.span_bytes) <= set(range(34))
    assert tr.bytes["halo"] > states[2].transport.bytes["halo"]


# the n=34 P=2 fill's exchange bytes by class (the CPU fill of the tree
# whose RI scans shipped their weights to the owners: the same shapes)
SHIPPED_WEIGHTS_BYTES = {"halo": 19980072, "shift": 12753524, "gather": 5778432,
                         "allgather": 2516}


def test_shift_bytes_not_above_the_shipped_weights(n34, jax_fill7):
    """fill7_sharded n=34 P=2: bit-equal to the JAX fill on the 2-D
    matrices and every stored block, and its ``shift`` bytes the
    shipped-weights fill's less exactly those weights (U = the spans of
    every prior segment); every other class unchanged."""
    SEGS, states = n34
    st = states[2]
    want = jax_fill7()
    got = st.gather()
    for k in (*KEYS_2D, "PKD", *(f"{m}@{g}" for g in range(len(SEGS)) for m in M4_STORED),
              *(f"C_{m}@{g}" for g in range(len(SEGS)) for m in C_MATS)):
        _assert_equal(got[k], want[k], k)
    spans = [(s, sum(m for *_h, m in prior_segments(SEGS, gi, s)))
             for gi, (lo, hi, *_r) in enumerate(SEGS) for s in range(lo, hi)]
    R, _ = row_partition(34, 2)
    tr = RowTransport(["cpu"] * 2, R, 36)
    weights = sum(7 * 4 * U * (b - a)          # int32 [1, U, rows], seven scans a span
                  for s, U in spans for p, i0, IB in span_rows(34, R, 2, s)
                  for q, a, b in tr.owners(i0 + s, i0 + s + IB) if q != p)
    moved = {c: v for c, v in st.transport.bytes.items() if c != "read"}
    assert weights > 0
    assert moved == {**SHIPPED_WEIGHTS_BYTES,
                     "shift": SHIPPED_WEIGHTS_BYTES["shift"] - weights}


def test_fill7_sharded_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # before any table is read
        fill7_sharded({}, {}, 34, 2, segments7(34))
    with pytest.raises(RuntimeError, match="CUDA"):
        fill7_sharded({}, {}, 34, 2, segments7(34), devices=["cuda:0", "cuda:0"])


@pytest.fixture(scope="module")
def anchor():
    """The n=37 anchor's tables, its unsharded fill7 state and its P=2
    sharded state."""
    tabs, sp, C, SC4 = _tables(ANCHOR)
    SEGS = segments7(tabs.n)
    return (tabs, sp, SEGS, tfold.fill7(C, SC4, tabs.n, sp.dangles, SEGS),
            fill7_sharded(C, SC4, tabs.n, sp.dangles, SEGS, devices=["cpu"] * 2))


def test_lazy_traceback_over_packed_shards_folds_the_anchor(anchor):
    """LazyMats reads the P=2 packed state as it is: the golden line, the
    slabs a LazyMats over the unsharded fill7 state fetches, and no more
    bytes between shards than its 4-D slabs plus its P splits' bound."""
    tabs, sp, SEGS, plain_st, st = anchor
    tr = st.transport
    before, p_splits = tr.bytes["read"], []
    reads = st.p_split_reads
    st.p_split_reads = lambda i, l: p_splits.append(l - i) or reads(i, l)
    try:
        sharded = LazyMats(st, tabs.n, segs=SEGS)
        assert Traceback(tabs, sp, DEFAULT_PK, sharded).run() == ANCHOR_LINE
    finally:
        del st.p_split_reads
    moved = tr.bytes["read"] - before
    plain = LazyMats(plain_st, tabs.n, segs=SEGS)
    assert Traceback(tabs, sp, DEFAULT_PK, plain).run() == ANCHOR_LINE
    assert set(sharded._slabs) == set(plain._slabs) and p_splits
    for key, slab in plain._slabs.items():
        assert np.array_equal(sharded._slabs[key], slab), key
    assert sharded.bytes_fetched == plain.bytes_fetched
    _, T, _, _, A = st.shards[0]["PKD"].shape
    slab_bytes = sum(v.nbytes for v in sharded._slabs.values())
    assert 0 < moved <= slab_bytes + sum(2 * T * m * A * 2 for m in p_splits)


@pytest.mark.parametrize("family", ["stored", "dropped"])
def test_every_packed_slab_over_shards_equals_fill7s(anchor, family):
    """Every span of every family through LazyMats, the three ``DROPPED``
    ones (PK through PKD, PLmloop00 / PfromL through their C skews)
    included: the sharded state's slab equals the unsharded one's."""
    tabs, sp, SEGS, plain_st, st = anchor
    names = [m for m in M4_NAMES if (m in M4_STORED) == (family == "stored")]
    mine, theirs = LazyMats(st, tabs.n, segs=SEGS), LazyMats(plain_st, tabs.n, segs=SEGS)
    for name in names:
        assert (name in mine) == (name in theirs)
        for ss in range(tabs.n):
            assert np.array_equal(mine._slab(name, ss), theirs._slab(name, ss)), (name, ss)


def test_c_rows_past_n2_hold_the_unset_value(jax_fill7):
    """The JAX fill 7's C skews hold the unset value on every row l >= n2
    (written only from invalid i rows), which is why no shard stores
    them."""
    want = jax_fill7()
    n2 = 36
    for g, (lo, hi, TB, IB, Lc) in enumerate(segments7(34)):
        for m in C_MATS:
            c = want[f"C_{m}@{g}"]
            assert c.shape[-2] == Lc and lo + 1 + Lc > n2
            assert (c[..., n2 - lo - 1:, :] == SAT16).all(), (m, g)


@pytest.mark.parametrize("P", [2, 5])
@pytest.mark.parametrize("group", ["2d", "PK skews", "families", "C skews"])
def test_sharded_packed_fill_matches_jax_fill7(n34, jax_fill7, P, group):
    SEGS, states = n34
    want = jax_fill7()
    got = states[P].gather()
    n = 34
    if group == "2d":
        for k in KEYS_2D:
            _assert_equal(got[k], want[k], k)
    elif group == "PK skews":
        _assert_equal(got["PKD"], want["PKD"], "PKD")
        for g, (lo, hi, *_r) in enumerate(SEGS):
            _assert_equal(_pke_segment(got["PKE"], n, lo, hi), want[f"PKE@{g}"],
                          f"PKE@{g}")
    else:
        names = M4_STORED if group == "families" else tuple("C_" + m for m in C_MATS)
        for name in names:
            for g in range(len(SEGS)):
                _assert_equal(got[f"{name}@{g}"], want[f"{name}@{g}"], f"{name}@{g}")
    assert set(got) - set(want) == {"PKE"}
    assert set(want) - set(got) == {f"PKE@{g}" for g in range(len(SEGS))}


def test_three_segments_match_fill7_n64():
    """n=64 (3 segments: the middle one reads a predecessor and the last a
    full history across segments) with P=3 against the port's own
    ``fill7``; several minutes on one CPU thread, so ``CCJ_SLOW``-gated as
    tests/test_wavefront_shard.py gates its own three-segment case."""
    if not os.environ.get("CCJ_SLOW"):
        pytest.skip("set CCJ_SLOW=1 (several minutes on one CPU thread)")
    seq = "".join(random.Random(64).choice("ACGU") for _ in range(64))
    tabs, sp, C, SC4 = _tables(seq)
    SEGS = segments7(64)
    assert len(SEGS) == 3
    want = tfold.fill7(C, SC4, 64, sp.dangles, SEGS)
    got = fill7_sharded(C, SC4, 64, sp.dangles, SEGS, devices=["cpu"] * 3).gather()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and torch.equal(got[k], v), k
