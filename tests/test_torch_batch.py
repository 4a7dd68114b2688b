"""The port's batched dense fill (``ccj_tpu_torch.dist.batch``) equals the
JAX package's ``ccj_tpu.dist.batch.batched_fill6`` on every array both
return, bit for bit (tolerance zero: all integer data), on a uniform batch
and on a mixed-length batch padded inside one bucket; each element equals
the port's own single-sequence ``fill6`` (the batch of one); and the
batched min-plus group's plain version equals the per-element one."""

import numpy as np
import pytest
import torch

from ccj_tpu.dist.batch import batched_fill6 as jax_batched_fill6
from ccj_tpu.params import DEFAULT_PK as JAX_PK
from ccj_tpu.params import parse_par as jax_parse_par
from ccj_tpu.params import scale_parameters as jax_scale_parameters
from ccj_tpu_torch.dist.batch import batched_fill6
from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF
from ccj_tpu_torch.engine.gapped import C_MATS
from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables, pad_seq_tables

from oracle_util import REPO
from test_batch import ALL_KEYS, SEQS

# The suite runs in several worker processes; one intra-op thread each
# (as tests/test_torch_fill.py).
torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
MIXED = ["GCGCAAUUGCGC", "GGCGCUUGCGCCGC", "AGCGAAACGCUUAGCG"]   # 12, 14, 16
BATCHES = {"uniform": SEQS, "mixed": MIXED}
# ALL_KEYS (the traceback's families) plus the span phase's own state
KEYS = ALL_KEYS + ["C_" + m for m in C_MATS] + ["PKD", "PKE"]


@pytest.fixture(scope="module")
def runs():
    """Per batch: the JAX batched state and the port's, each computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            seqs = BATCHES[name]
            jout, jn = jax_batched_fill6(
                seqs, jax_scale_parameters(jax_parse_par(PAR)), JAX_PK)
            tout, tn = batched_fill6(seqs, scale_parameters(parse_par(PAR)),
                                     DEFAULT_PK, device="cpu")
            cache[name] = ({k: np.asarray(v) for k, v in jout.items()}, jn,
                           {k: v.numpy() for k, v in tout.items()}, tn)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_fill6_matches_jax(runs, name):
    want, jn, got, tn = runs(name)
    assert tn == jn == 16
    shared = set(got) & set(want)
    assert set(KEYS) <= shared, sorted(set(KEYS) - shared)
    for k in sorted(shared):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert got[k].shape[0] == len(BATCHES[name]), k
        bad = np.argwhere(got[k] != want[k])
        assert len(bad) == 0, (f"{k}: {len(bad)} cells differ, first at "
                               f"{tuple(bad[0])}")


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_each_element_equals_its_own_fill6(runs, name):
    """The batch of one (``fill6``) and the batch agree element by element,
    padding included (the mixed batch pads 12 and 14 to 16)."""
    _, _, got, n_pad = runs(name)
    sp = scale_parameters(parse_par(PAR))
    for b, seq in enumerate(BATCHES[name]):
        tabs = pad_seq_tables(build_seq_tables(seq, sp, DEFAULT_PK), n_pad,
                              sp, DEFAULT_PK)
        C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK),
                                         "cpu")
        single = tfold.fill6(C, SC4, n_pad, sp.dangles)
        assert set(single) == set(got)
        for k, v in single.items():
            np.testing.assert_array_equal(got[k][b], v.numpy(), f"{seq}:{k}")


def test_batched_fill6_refuses_past_the_dense_reach():
    sp = scale_parameters(parse_par(PAR))
    with pytest.raises(ValueError, match="dense"):
        batched_fill6(["GCGCAAUUGCGC"], sp, DEFAULT_PK, device="cpu",
                      pad_to=tfold.DENSE_MAX_N + 1)


def _rand(shape, rng):
    x = rng.integers(-30000, 32767, size=shape).astype(np.int32)
    x[rng.random(shape) < 0.3] = INF
    return torch.from_numpy(x)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_batched_group_ref_equals_per_element(mode):
    """A table over [B, ...] operands gives [B, G, I, J]: element b of the
    batched plain version equals the unbatched table over element b."""
    B, TB, IB, n2, tt = 3, 16, 8, 18, 5
    rng = np.random.default_rng(mode)
    slab = _rand((B, 2 * TB + 2, IB, n2 + TB), rng)
    ws = [_rand((B, TB, n2 + TB + 1), rng) for _ in range(2)]

    def specs(sl, w1, w2):
        c = (5, -1) if mode == 1 else (2, 0)
        return [cuda_ops.WindowSpec(sl, w1, (1, 1), col0=(0, 1), wcol=(2, 1),
                                    mode=mode, c=c),
                cuda_ops.WindowSpec(sl, w2, (1, 1), col0=(0, 1), wcol=(2, 1),
                                    mode=mode, c=c),
                cuda_ops.WindowSpec(sl, w1, (2, 1), q_lo=3)]

    table = cuda_ops.WindowTable(specs(slab, *ws), n2, (0, 7))
    assert table.shape == (B, 3, IB, n2) and table.batch == B
    got = cuda_ops.minplus_group_ref(table, tt)
    out = torch.empty(table.shape, dtype=torch.int32)
    before = (cuda_ops.LAUNCHES, cuda_ops.WINDOWS)
    assert torch.equal(cuda_ops.minplus_group(table, tt, out), got)
    assert (cuda_ops.LAUNCHES, cuda_ops.WINDOWS) == before   # CPU: no launch
    for b in range(B):
        one = cuda_ops.WindowTable(specs(slab[b], ws[0][b], ws[1][b]), n2, (0, 7))
        assert one.shape == (3, IB, n2) and one.batch is None
        assert torch.equal(got[b], cuda_ops.minplus_group_ref(one, tt)), b


def test_window_table_refuses_mismatched_batches():
    slab = torch.zeros((2, 20, 3, 10), dtype=torch.int32)
    w = torch.zeros((2, 8, 10), dtype=torch.int32)
    ok = cuda_ops.WindowSpec(slab, w, (1, 1))
    cuda_ops.WindowTable([ok, ok], 10, (0, 4))
    bad = [cuda_ops.WindowSpec(slab[:1], w[:1], (1, 1)),               # B=1 vs 2
           cuda_ops.WindowSpec(slab[0], w[0], (1, 1))]                 # unbatched
    for other in bad:
        with pytest.raises(ValueError, match="batch"):
            cuda_ops.WindowTable([ok, other], 10, (0, 4))
    with pytest.raises(ValueError, match="batch"):                     # slab vs w
        cuda_ops.WindowTable([cuda_ops.WindowSpec(slab, w[:1], (1, 1))], 10, (0, 4))
    with pytest.raises(ValueError, match="batch"):                     # 4-D slab, 2-D w
        cuda_ops.WindowTable([cuda_ops.WindowSpec(slab, w[0], (1, 1))], 10, (0, 4))
