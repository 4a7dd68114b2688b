"""The port's CLI and ``fold_many`` against the JAX package's.

``ccj_tpu_torch.cli.main([..., "--device", "cpu"])`` prints the same bytes
as ``ccj_tpu.cli.main`` on the probes of the verify recipe at n=16
(default, -d 0|1, --noGU, -P, stdin, -i file, an invalid character,
--noConv with T, and --pf with its PS dot plot, which at n=16 both take
from the host float64 engine, so the PS files are identical too)."""

import io
import sys

import pytest
import torch

import ccj_tpu.api as jax_api
import ccj_tpu.cli as jax_cli
import ccj_tpu_torch
import ccj_tpu_torch.api as tapi
import ccj_tpu_torch.cli as torch_cli
from ccj_tpu_torch.engine.fold import DENSE_MAX_N

from oracle_util import REPO

# one intra-op thread per worker process (see test_torch_fill.py)
torch.set_num_threads(1)

SEQ = "GCGCUUCGCCGCGCCA"
PROBES = {
    "default": [SEQ],
    "d0": [SEQ, "-d", "0"],
    "d1": [SEQ, "-d", "1"],
    "noGU": [SEQ, "--noGU"],
    "turner04": [SEQ, "-P", str(REPO / "ccj_tpu_torch/params/rna_Turner04.par")],
    "stdin": [],
    "input_file": ["-i", "{tmp}/seq.txt"],
    "invalid": ["GCGCUUCGXCGCGCCA"],
    "noConv_T": ["GCGCTTCGCCGCGCCA", "--noConv"],
    "pf": [SEQ, "--pf", "--samples", "10", "--PSplot", "{tmp}/{pkg}.ps"],
}


def _run(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO(SEQ + "\n"))
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_cli_bytes_match_jax(probe, capsys, monkeypatch, tmp_path):
    (tmp_path / "seq.txt").write_text(SEQ + "\n")

    def argv(pkg):
        return [a.format(tmp=tmp_path, pkg=pkg) for a in PROBES[probe]]

    want = _run(jax_cli.main, argv("jax"), capsys, monkeypatch)
    got = _run(torch_cli.main, argv("torch") + ["--device", "cpu"], capsys,
               monkeypatch)
    assert got == want
    assert want[0] == (1 if probe == "invalid" else 0)
    if probe == "pf":
        ps = (tmp_path / "torch.ps").read_bytes()
        assert ps.startswith(b"%!PS")
        assert ps == (tmp_path / "jax.ps").read_bytes()


# four sequences across the buckets of 16 and 24, in an order that mixes them
MANY = ["GGCGCUUGCGCCACGUAC", "GCGCAAUUGCGC", "AACCACUCUGACUGGCAGGU",
        "GCGCUUCGCCGCGCCA"]


def test_fold_many_matches_fold_and_jax():
    got = ccj_tpu_torch.fold_many(MANY, device="cpu")
    assert [r.seq for r in got] == MANY
    each = [ccj_tpu_torch.fold(s, device="cpu") for s in MANY]
    want = jax_api.fold_many(MANY)
    assert [(r.structure, r.energy_dcal) for r in got] == \
        [(r.structure, r.energy_dcal) for r in each] == \
        [(r.structure, r.energy_dcal) for r in want]


def test_fold_many_sends_long_sequences_through_fold(monkeypatch):
    """A sequence past ``DENSE_MAX_N`` goes through ``fold`` (stubbed here,
    so no packed fill runs) with fold_many's arguments; the rest go through
    their buckets; results keep input order."""
    real_fold = tapi.fold
    calls = []

    def fake_fold(seq, **kw):
        calls.append((seq, kw))
        return tapi.FoldResult(seq=seq, structure="<long>", energy=0.0,
                               energy_dcal=0)

    monkeypatch.setattr(tapi, "fold", fake_fold)
    long_seq = "GC" * ((DENSE_MAX_N + 2) // 2)
    seqs = ["GCGCAAUUGCGC", long_seq, "GCGCUUCGCCGCGCCA"]
    got = ccj_tpu_torch.fold_many(seqs, dangles=1, device="cpu")
    assert [r.seq for r in got] == seqs
    assert [(seq, kw["dangles"], kw["device"]) for seq, kw in calls] == \
        [(long_seq, 1, torch.device("cpu"))]
    assert got[1].structure == "<long>"
    for r in (got[0], got[2]):
        want = real_fold(r.seq, dangles=1, device="cpu")
        assert (r.structure, r.energy_dcal) == (want.structure, want.energy_dcal)
