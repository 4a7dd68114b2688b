"""The port's corpus driver (``ccj_tpu_torch.dist.corpus``): two processes
on a loopback ``TCPStore`` merge to the golden structures and energies in
corpus order; a bad sequence is recorded, with the JAX driver's error
text, instead of aborting; the single-process driver gives the merged
result."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from ccj_tpu.dist.corpus import fold_shard as jax_fold_shard
from ccj_tpu_torch.dist.corpus import fold_corpus, fold_shard

from oracle_util import REPO

torch.set_num_threads(1)

GOLDEN = [e for e in json.loads((REPO / "tests" / "golden" / "corpus.json").read_text())
          if not e["args"] and len(e["seq"]) <= 20]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """The merged JSON of two CPU processes of the CLI over GOLDEN."""
    tmp = tmp_path_factory.mktemp("corpus")
    corpus, out = tmp / "corpus.txt", tmp / "out.json"
    corpus.write_text("\n".join(e["seq"] for e in GOLDEN) + "\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ccj_tpu_torch.dist.corpus", str(corpus), str(out),
         "--coordinator", coord, "--num-processes", "2", "--process-id", str(pid),
         "--device", "cpu", "--merge-timeout-ms", "600000"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
        assert b"corpus-fold-seconds" in err
    return json.loads(out.read_text())


def test_two_process_corpus_equals_the_goldens(merged):
    assert len(GOLDEN) == 5
    assert [r["seq"] for r in merged] == [e["seq"] for e in GOLDEN]
    assert [r["index"] for r in merged] == list(range(len(GOLDEN)))
    for r, e in zip(merged, GOLDEN):
        assert r["error"] is None, r
        assert r["structure"] == e["structure"], r
        assert abs(r["energy"] - e["energy"]) < 1e-9, r


def test_single_process_corpus_equals_the_merge(merged):
    solo = fold_corpus([e["seq"] for e in GOLDEN], device="cpu")
    assert [(r.index, r.seq, r.structure, r.energy, r.error) for r in solo] == \
        [(r["index"], r["seq"], r["structure"], r["energy"], r["error"]) for r in merged]


def test_retry_records_failure_as_the_jax_driver_does():
    seqs = ["GCGCAAUUGCGC", "NOTANRNA"]
    got = fold_shard(seqs, [0, 1], retries=1, device="cpu")
    want = jax_fold_shard(seqs, [0, 1], retries=1)
    assert [r.index for r in got] == [0, 1]
    assert got[0].error is None and got[0].structure == want[0].structure
    assert got[0].energy == want[0].energy
    assert got[1].structure is None and got[1].energy is None
    assert got[1].error is not None and got[1].error == want[1].error


def test_corpus_needs_a_coordinator_and_a_valid_process_id():
    with pytest.raises(ValueError, match="coordinator"):
        fold_corpus(["GCGCAAUUGCGC"], num_processes=2, process_id=1, device="cpu")
    with pytest.raises(ValueError, match="process id"):
        fold_corpus(["GCGCAAUUGCGC"], num_processes=2, process_id=2, device="cpu")
