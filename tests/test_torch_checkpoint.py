"""Checkpoint/resume of the port's dense fill (``fold.fill4``), as
tests/test_checkpoint.py holds the JAX package's: a fill interrupted after
its span-8 snapshot resumes to the uninterrupted fill bit for bit, a
different fold's digest refuses the snapshot, and a completed fill removes
it.  The port's ``fold_digest`` equals the JAX package's on the same
sequence and parameters (n=24, on the CPU)."""

import numpy as np
import pytest
import torch

from ccj_tpu.engine.fold import fold_digest as jax_fold_digest
from ccj_tpu.params import DEFAULT_PK as JAX_PK
from ccj_tpu.params import parse_par as jax_parse_par
from ccj_tpu.params import scale_parameters as jax_scale_parameters
from ccj_tpu.precompute import build_seq_tables as jax_build_seq_tables
from ccj_tpu_torch import fold
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables

from oracle_util import REPO

# one intra-op thread per worker process (see test_torch_fill.py)
torch.set_num_threads(1)

SEQ = "GCGCAAUUGCGCGGCGCUUGCGCC"  # n=24
OTHER = "AUGCAAUUGCGCGGCGCUUGCGCC"
PAR = "ccj_tpu/params/rna_DirksPierce09.par"


class Stop(Exception):
    pass


@pytest.fixture(scope="module")
def setup():
    """Tables, constants and the uninterrupted fill6 state (numpy)."""
    sp = scale_parameters(parse_par(REPO / PAR))
    tabs = build_seq_tables(SEQ, sp, DEFAULT_PK)
    C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), "cpu")
    ref = {k: v.numpy() for k, v in tfold.fill6(C, SC4, tabs.n, sp.dangles).items()}
    return sp, tabs, C, SC4, ref


def _interrupted(setup, ckpt, at=11):
    """Run fill4 with snapshots every 8 spans until span ``at`` raises."""
    sp, tabs, C, SC4, _ = setup
    spans = []

    def bomb(s, dt):
        spans.append(s)
        assert dt >= 0
        if s == at:
            raise Stop

    with pytest.raises(Stop):
        tfold.fill4(C, SC4, tabs.n, sp.dangles, checkpoint_dir=ckpt,
                    checkpoint_every=8, on_span=bomb,
                    digest=tfold.fold_digest(tabs, sp, DEFAULT_PK))
    assert spans == list(range(at + 1))


def test_resume_from_mid_fill_checkpoint(setup, tmp_path):
    sp, tabs, C, SC4, ref = setup
    ckpt = tmp_path / "ck"
    _interrupted(setup, str(ckpt))
    with np.load(ckpt / tfold.CHECKPOINT_FILE) as data:
        assert int(data["__next_span"]) == 8
        assert int(data["__n"]) == tabs.n
    assert [p.name for p in ckpt.iterdir()] == [tfold.CHECKPOINT_FILE]

    resumed = []
    st = tfold.fill4(C, SC4, tabs.n, sp.dangles, checkpoint_dir=str(ckpt),
                     checkpoint_every=8, on_span=lambda s, dt: resumed.append(s),
                     digest=tfold.fold_digest(tabs, sp, DEFAULT_PK))
    assert resumed == list(range(8, tabs.n))
    assert set(st) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(st[k].numpy(), v, k)
    # a completed fill removes its snapshot: stale state must not leak into
    # the next fold of the same length
    assert not (ckpt / tfold.CHECKPOINT_FILE).exists()


def test_other_fold_refuses_snapshot(setup, tmp_path):
    sp, tabs, *_ = setup
    ckpt = str(tmp_path / "ck")
    _interrupted(setup, ckpt)
    dig = tfold.fold_digest(tabs, sp, DEFAULT_PK)
    other = tfold.fold_digest(build_seq_tables(OTHER, sp, DEFAULT_PK), sp, DEFAULT_PK)
    assert other != dig
    assert tfold._load_checkpoint(ckpt, tabs.n, other) == (0, None)
    assert tfold._load_checkpoint(ckpt, tabs.n + 1, dig) == (0, None)
    s0, st = tfold._load_checkpoint(ckpt, tabs.n, dig)
    assert s0 == 8 and st["V"].device.type == "cpu"


def test_fold_digest_matches_jax():
    sp = scale_parameters(parse_par(REPO / PAR))
    jsp = jax_scale_parameters(jax_parse_par(REPO / PAR))
    for seq in (SEQ, OTHER):
        mine = tfold.fold_digest(build_seq_tables(seq, sp, DEFAULT_PK), sp, DEFAULT_PK)
        theirs = jax_fold_digest(jax_build_seq_tables(seq, jsp, JAX_PK), jsp, JAX_PK)
        assert mine == theirs, seq


def test_engine_4_fold_matches_dense(setup, monkeypatch, tmp_path):
    """``CCJ_ENGINE=4`` with ``CCJ_CHECKPOINT_DIR``: ``fold`` runs fill4
    through ``fill_state`` and gives the dense fold's answer, leaving no
    snapshot behind."""
    want = fold(SEQ, device="cpu")
    calls = []
    real_fill4 = tfold.fill4

    def spy(*a, **kw):
        calls.append(kw)
        return real_fill4(*a, **kw)

    monkeypatch.setattr(tfold, "fill4", spy)
    monkeypatch.setenv("CCJ_ENGINE", "4")
    monkeypatch.setenv("CCJ_CHECKPOINT_DIR", str(tmp_path))
    got = fold(SEQ, device="cpu")
    assert (got.structure, got.energy_dcal) == (want.structure, want.energy_dcal)
    assert len(calls) == 1 and calls[0]["checkpoint_dir"] == str(tmp_path)
    assert calls[0]["digest"]
    assert list(tmp_path.iterdir()) == []
