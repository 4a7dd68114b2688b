"""The port's row-sharded dense fill (``dist.wavefront.fill6_sharded``), with
P shards on CPU devices in one process:

* at n=30 (tests/test_wavefront_shard.py's sequence), P=2 and P=4 equal
  the JAX package's ``best_fill(.., 4)`` on every array both hold (the 22
  families and the 2-D matrices), tolerance zero (integer data); the JAX
  fill runs in a subprocess, as that test runs its own, started with the
  module's first test so that it overlaps the port's fills;
* at n=21 with P=3 (n2 = 23 padded to 24 rows), ``gather()`` equals the
  port's own ``fill6`` on every array, C skews, PKD and PKE included;
* ``LazyMats`` over a P=2 state folds the n=37 pseudoknot anchor to its
  golden line, fetching the slabs the unsharded traceback fetches, and its
  P split moves only the PKD cells the cube reads;
* every shard holds R rows, and the transport counts bytes in each
  exchange class the fill uses; at P=4 the ``shift`` bytes are those of
  the fill that shipped each RI scan's [B, U, rows] weights to the owner
  of its C rows, less those weights (each owner now takes them from its
  own tables), and no other class moved;
* a row shard's min-plus descriptor table (rows from i0, the row offset
  in its masks' constant) gives the whole span's rows [i0, i0 + IB);
* the entry point defaults to CUDA and raises without it.

Both packages fill from identical tables: the JAX package's host constant
dict and stencil tables enter the port through ``consts_from_numpy``.
"""

import os
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
from ccj_tpu_torch.dist.wavefront import (CLASSES, ROW_NAMES, RowTransport,
                                          fill6_sharded, row_partition, span_rows)
from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.gapped import DS, M4_NAMES
from ccj_tpu_torch.engine.gapped4 import bucket_dims
from ccj_tpu_torch.engine.lazy import LazyMats, case_p_cube, case_p_device, p_split_reads
from ccj_tpu_torch.engine.traceback import Traceback
from ccj_tpu_torch.engine.ttloop import REDUCTIONS, reduction_table

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
SEQ30 = "GCGCAAUUGCGCGGCGCUUGCGCCACGUAC"   # tests/test_wavefront_shard.py
SEQ21 = "GGCAUCGAUGCAAGCUUCGCC"
ANCHOR = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
ANCHOR_LINE = (-994, "(((([[[...[[[[[[[))))....]]]]]]].]]].")
KEYS_2D = ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP")
GROUPS = {"families": tuple(M4_NAMES), "2d": KEYS_2D}

_CHILD = r"""
import sys
import numpy as np
from ccj_tpu.engine.fold import best_fill
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables

sp = scale_parameters(parse_par(sys.argv[1]))
tabs = build_seq_tables(sys.argv[2], sp, DEFAULT_PK)
ref = best_fill(tabs, sp, DEFAULT_PK, 4)()
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in ref.items()})
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
def jax_fill4(tmp_path_factory):
    """The JAX package's fill 4 at n=30, computed in a subprocess started
    with the module's first test (the JAX comparisons come last, so the
    port's tests run meanwhile); the fixture returns a function that waits
    for it."""
    out = tmp_path_factory.mktemp("wavefront") / "jax_fill4.npz"
    env = dict(os.environ, CCJ_TPU_PLATFORM="cpu", CCJ_COMPILE_CACHE="0",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(PAR), SEQ30, str(out)],
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
def n30():
    """The port's sharded fills at n=30, P=2 and P=4."""
    tabs, sp, C, SC4 = _tables(SEQ30, jax_tables=True)
    return {P: fill6_sharded(C, SC4, tabs.n, sp.dangles, devices=["cpu"] * P)
            for P in (2, 4)}


@pytest.fixture(scope="module")
def n21():
    tabs, sp, C, SC4 = _tables(SEQ21)
    want = tfold.fill6(C, SC4, tabs.n, sp.dangles)
    st = fill6_sharded(C, SC4, tabs.n, sp.dangles, devices=["cpu"] * 3)
    return want, st


def test_row_partition_and_span_rows():
    R, ranges = row_partition(21, 3)
    assert (R, ranges) == (8, [(0, 8), (8, 16), (16, 24)])
    assert row_partition(30, 4)[0] == 8 < DS       # the PL halo spans shards
    # span 0: every shard computes; span 14 leaves rows 1..7 to shard 0
    assert span_rows(21, 8, 3, 0) == [(0, 0, 8), (1, 8, 8), (2, 16, 6)]
    assert span_rows(21, 8, 3, 14) == [(0, 0, 8)]
    assert span_rows(21, 8, 3, 13) == [(0, 0, 8), (1, 8, 1)]


def test_transport_fetch_put_and_counts():
    """Row fetches across shards, unset rows past n2 and before 0, puts
    into the owners; bytes counted for other shards' rows only."""
    n2, R, P = 10, 4, 3
    full = torch.arange(2 * 12 * 5, dtype=torch.int16).reshape(2, 12, 5)
    full[:, n2:] = SAT16
    arrs = [full[:, p * R:(p + 1) * R].clone() for p in range(P)]
    tr = RowTransport([torch.device("cpu")] * P, R, n2)
    whole = lambda t: t                               # noqa: E731
    own = tr.fetch(1, arrs, whole, 5, 8, "halo")
    assert own.data_ptr() == arrs[1][:, 1:4].data_ptr()   # a view, nothing moved
    assert tr.bytes["halo"] == 0
    got = tr.fetch(1, arrs, whole, -2, 13, "halo")
    want = torch.cat([torch.full((2, 2, 5), SAT16, dtype=torch.int16), full[:, :n2],
                      torch.full((2, 3, 5), SAT16, dtype=torch.int16)], dim=1)
    assert torch.equal(got, want)
    assert tr.bytes["halo"] == 2 * (4 + 2) * 5 * 2     # rows 0-3 and 8-9
    slab = -torch.ones((2, 5, 5), dtype=torch.int16)
    tr.put(0, arrs, whole, 3, slab, "shift")
    back = torch.cat(arrs, dim=1)
    assert bool((back[:, 3:8] == -1).all()) and torch.equal(back[:, :3], full[:, :3])
    assert tr.bytes["shift"] == 2 * 4 * 5 * 2          # rows 4-7 are shard 1's


@pytest.mark.parametrize("TB,n2,s,i0,IB", [(16, 18, 12, 4, 5), (32, 34, 20, 8, 8),
                                            (32, 50, 30, 17, 16)])
def test_reduction_table_with_a_row_offset(TB, n2, s, i0, IB):
    """The tt loop's 13 windows over a row shard's slabs (rows i0 ..
    i0 + IB - 1, ``reduction_table(.., i0)``) equal those rows of the
    windows over the whole span's slabs, at the first, a middle and the
    last tt step: the masks' bounds read i, not the slab row."""
    rng = np.random.default_rng(s + i0)

    def rand(shape):
        x = rng.integers(-30000, 32767, shape, dtype=np.int32)
        x[rng.random(shape) < 0.3] = INF
        return torch.from_numpy(x)

    rows = i0 + IB + 3
    slabs = {name: rand((2 * TB + 2, rows, n2 + TB if name.startswith("B_") else n2))
             for name, *_ in REDUCTIONS}
    WKX = {nm: rand((TB, n2 + TB + 1)) for nm in ("WP", "WB", "WBP")}
    WJX = {nm: rand((TB, n2)) for nm in ("WP", "WB", "WBP")}
    whole = reduction_table(slabs, WKX, WJX, s, n2)
    shard = reduction_table({k: v[:, i0:i0 + IB] for k, v in slabs.items()},
                            WKX, WJX, s, n2, i0)
    for tt in (0, (s - 2) // 2, s - 2):
        want = cuda_ops.minplus_group_ref(whole, tt)[:, i0:i0 + IB]
        assert torch.equal(cuda_ops.minplus_group_ref(shard, tt), want), tt


@pytest.mark.parametrize("group", ["2d", "families", "skews"])
def test_sharded_fill_matches_fill6_p3(n21, group):
    want, st = n21
    got = st.gather()
    assert set(got) == set(want)
    keys = {"2d": ("Vtype", *KEYS_2D), "families": M4_NAMES,
            "skews": [k for k in ROW_NAMES if k not in M4_NAMES]}[group]
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def anchor():
    """The n=37 anchor's tables and its P=2 sharded state."""
    tabs, sp, C, SC4 = _tables(ANCHOR)
    return tabs, sp, fill6_sharded(C, SC4, tabs.n, sp.dangles, devices=["cpu"] * 2)


def test_lazy_traceback_over_shards_folds_the_anchor(anchor):
    """LazyMats reads the P=2 state as it is: the golden structure and
    energy, the same slabs as a LazyMats over the plain (gathered) state,
    and the P split through the state's own PKD reader."""
    tabs, sp, st = anchor
    calls = []
    reads = st.p_split_reads

    def spy(i, l):
        calls.append((i, l))
        return reads(i, l)

    st.p_split_reads = spy
    try:
        sharded = LazyMats(st, tabs.n)
        assert Traceback(tabs, sp, DEFAULT_PK, sharded).run() == ANCHOR_LINE
    finally:
        del st.p_split_reads
    assert calls
    plain = LazyMats(st.gather(), tabs.n)
    assert Traceback(tabs, sp, DEFAULT_PK, plain).run() == ANCHOR_LINE
    assert sharded.slab_fetches == plain.slab_fetches > 0
    assert sharded.bytes_fetched == plain.bytes_fetched


@pytest.mark.parametrize("i,l", [(1, 37), (1, 20), (10, 30), (18, 36), (20, 37)])
def test_p_split_reads_only_what_the_cube_reads(anchor, i, l):
    """The P split of (i, l) over shards gets row i at spans [0, l - i) and
    one span of each row in (i, l]: the same cells as the plain PKD gives,
    the same argmin, and no more "read" bytes than those cells (the
    outer case (1, n) would move the whole PKD if whole rows came)."""
    tabs, sp, st = anchor
    PKD = st.gather()["PKD"]
    T, A = PKD.shape[0], PKD.shape[-1]
    tr = st.transport
    before = tr.bytes["read"]
    got = st.p_split_reads(i, l)
    moved = tr.bytes["read"] - before
    want = p_split_reads(PKD, i, l)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (T, l - i, A) and torch.equal(g, w)
    cell = T * A * PKD.element_size()
    off_shard0 = sum(hi - lo for q, lo, hi in tr.owners(i + 1, l + 1) if q)
    assert moved == cell * ((l - i) * (i >= st.R) + off_shard0)
    assert moved <= 2 * cell * (l - i) < PKD.nbytes // 8
    assert case_p_cube(*got, i, l) == case_p_device(PKD, i, l, tabs.n)
    m = LazyMats(st, tabs.n)
    assert m.case_p_argmin(i, l) == LazyMats(st.gather(), tabs.n).case_p_argmin(i, l)


def test_shard_rows_and_exchange_classes(n30):
    """Each shard holds R rows of every sharded array; at P=4 (R = 8 < DS)
    the fill used every exchange class, and the per-span counts add up to
    the totals."""
    st = n30[4]
    assert st.R == 8 and st.P == 4
    for sh in st.shards:
        for k in ROW_NAMES:
            assert sh[k].shape[-2] == st.R and sh[k].shape[0] == 1, k
    tr = st.transport
    fill_classes = [c for c in CLASSES if c != "read"]
    for c in fill_classes:
        per_span = sum(v[c] for v in tr.span_bytes.values())
        assert per_span > 0 and per_span == tr.bytes[c], c
    # the 2-D replicas are shared by shards on one device
    assert len(st.replicas) == 1
    assert all(sh["V"] is st.replicas[st.devices[0]]["V"] for sh in st.shards)


# the n=30 P=4 fill's exchange bytes by class (the CPU fill of the tree
# whose RI scans shipped their weights to the owners: the same shapes)
SHIPPED_WEIGHTS_BYTES = {"halo": 29107648, "shift": 8601016, "gather": 5586560,
                         "allgather": 5940}


def ri_weight_bytes(n, P, spans):
    """The int32 RI weights [B, U, rows] (B = 1, seven scans a span) that a
    fill shipping them would move to each owner q != p of a shard p's C
    rows l = i + s: ``spans`` gives (s, U) in fill order."""
    R, _ = row_partition(n, P)
    tr = RowTransport(["cpu"] * P, R, n + 2)
    return sum(7 * 4 * U * (b - a)
               for s, U in spans for p, i0, IB in span_rows(n, R, P, s)
               for q, a, b in tr.owners(i0 + s, i0 + s + IB) if q != p)


def test_shift_bytes_not_above_the_shipped_weights(n30, jax_fill4):
    """fill6_sharded n=30 P=4: bit-equal to the JAX fill on every array it
    holds, and its ``shift`` bytes the shipped-weights fill's less exactly
    those weights; every other class unchanged."""
    st = n30[4]
    want = jax_fill4()
    got = st.gather()
    for k in (*M4_NAMES, *GROUPS["2d"]):
        assert np.array_equal(got[k].numpy(), want[k]), k
    n = 30
    weights = ri_weight_bytes(n, 4, [(s, bucket_dims(n, s)[0]) for s in range(n)])
    moved = {c: v for c, v in st.transport.bytes.items() if c != "read"}
    assert weights > 0
    assert moved == {**SHIPPED_WEIGHTS_BYTES,
                     "shift": SHIPPED_WEIGHTS_BYTES["shift"] - weights}


def test_fill6_sharded_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wavefront.resolve_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        wavefront.resolve_devices(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):   # before any table is read
        fill6_sharded({}, {}, 8, 2)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_sharded_fill_matches_jax_fill4(n30, jax_fill4, P, group):
    want = jax_fill4()
    got = n30[P].gather()
    for k in GROUPS[group]:
        g, w = got[k].numpy(), want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        bad = np.argwhere(g != w)
        assert len(bad) == 0, (f"P={P} {k}: {len(bad)} cells differ, first at "
                               f"{tuple(bad[0])}: port={g[tuple(bad[0])]} "
                               f"jax={w[tuple(bad[0])]}")
