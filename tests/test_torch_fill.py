"""The port's dense fill equals ``ccj_tpu.engine.fold.run_fill(version=6)``
on every state array, bit for bit (tolerance zero: all integer data), on
the tests/test_fill.py CASES (n=16; dangles 0, 1, 2; Turner04; noGU).
Both packages fill from identical tables: the JAX package's host constant
dict and stencil tables enter the port through ``consts_from_numpy``."""

import numpy as np
import pytest
import torch

from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine.gapped4 import build_sc4 as jax_build_sc4
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.gapped import C_MATS, M4_NAMES

from oracle_util import REPO
from test_fill import CASES

# The suite runs in several worker processes; torch's default of one
# intra-op thread per core oversubscribes the CPU and made these
# small-tensor fills about three times slower.
torch.set_num_threads(1)

KEYS_2D = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP")
KEY_GROUPS = {
    "2d": KEYS_2D,
    "families": tuple(M4_NAMES),
    "skews": tuple("C_" + m for m in C_MATS) + ("PKD", "PKE"),
}
CASE_IDS = [f"{seq}-d{d}-{par.rsplit('/', 1)[1][:-4]}-nogu{g}"
            for seq, d, par, g in CASES]


@pytest.fixture(scope="module")
def runs():
    """Per case: the JAX tables, the JAX fill state and the port's, each
    computed once (the JAX fill compiles once per (n, dangles))."""
    cache = {}

    def get(case):
        if case not in cache:
            seq, dangles, par, nogu = case
            sp = scale_parameters(parse_par(REPO / par), dangles=dangles)
            tabs = build_seq_tables(seq, sp, DEFAULT_PK, no_gu=bool(nogu))
            C_np = jfold.build_consts(tabs, sp, DEFAULT_PK, device=False)
            sc4_np = {k: np.asarray(v) for k, v in jax_build_sc4(tabs).items()}
            want = jfold.run_fill(tabs, sp, DEFAULT_PK, version=6)
            C, SC4 = tfold.consts_from_numpy(C_np, "cpu", sc4_np)
            got = {k: v.numpy() for k, v in
                   tfold.fill6(C, SC4, tabs.n, dangles).items()}
            cache[case] = (tabs, sp, C_np, sc4_np, want, got)
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("group", sorted(KEY_GROUPS))
def test_fill6_state_matches_jax(runs, case, group):
    *_, want, got = runs(case)
    assert set(got) == set(want)
    for k in KEY_GROUPS[group]:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        bad = np.argwhere(got[k] != want[k])
        assert len(bad) == 0, (f"{k}: {len(bad)} cells differ, first at "
                               f"{tuple(bad[0])}: port={got[k][tuple(bad[0])]} "
                               f"jax={want[k][tuple(bad[0])]}")


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_port_tables_match_jax(runs, case):
    """The port's own build_consts and build_sc4 (the fold's path) give the
    JAX package's tables."""
    tabs, sp, C_np, sc4_np, *_ = runs(case)
    mine = tfold.build_consts(tabs, sp, DEFAULT_PK)
    assert set(mine) == set(C_np)
    for k, v in C_np.items():
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(v), k)
    _, SC4 = tfold.consts_from_numpy(mine, "cpu")
    for k, v in sc4_np.items():
        assert SC4[k].dtype.itemsize == v.dtype.itemsize, k
        np.testing.assert_array_equal(SC4[k].numpy(), v, k)
