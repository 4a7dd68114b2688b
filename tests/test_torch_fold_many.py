"""The port's fill-ahead ``fold_many`` (the JAX package's ``ccj_tpu/api.py``
pipeline) on the CPU:

* at ``batch_limit`` 1, 2 and 8 it equals the port's per-sequence ``fold``
  and the JAX ``fold_many`` at the same ``batch_limit``, structure and
  integer energy, in input order (tolerance zero);
* spies on the fill (``api.fill_state``) and on ``Traceback.run`` show the
  order of dispatch: with ``depth = max(1, min(batch_limit, 2))`` = 2 the
  fill of sequence k+1 of a bucket is dispatched before the traceback of
  sequence k, with 1 each sequence is filled and traced back before the
  next fill; and never more than ``depth`` fill states are live (a weak
  reference on each state's ``V`` tells when it is freed).

Seven sequences over the buckets of 16 and 24, in an order that mixes
them: bucket 16 holds A, C, D, G and bucket 24 holds B, E, F.
"""

import weakref

import pytest
import torch

import ccj_tpu.api as jax_api
import ccj_tpu_torch
import ccj_tpu_torch.api as tapi
from ccj_tpu_torch.engine.traceback import Traceback

torch.set_num_threads(1)

SEQS = {"A": "GCGCAAUUGCGC", "B": "GGCGCUUGCGCCACGUAC", "C": "GCGCUUCGCCGCGCCA",
        "D": "GGGAAACGGGCGAUCC", "E": "AACCACUCUGACUGGCAGGU",
        "F": "GCGCAAUUGCGCGGCGCUUGCGCC", "G": "CCCUUUGGGAAACCC"}
ORDER = "ABCDEFG"
# the dispatch order each depth gives (f: fill, t: traceback), bucket 16 first
WANT_ORDER = {
    1: "fA tA fC tC fD tD fG tG fB tB fE tE fF tF",
    2: "fA fC tA fD tC fG tD tG fB fE tB fF tE tF",
}
LIMITS = [1, 2, 8]


@pytest.fixture(scope="module")
def runs():
    """Per batch_limit: the port's fold_many results with the events its
    spies saw and the most fill states live at once; computed once."""
    cache = {}

    def get(batch_limit):
        if batch_limit in cache:
            return cache[batch_limit]
        by_seq = {s: k for k, s in SEQS.items()}
        events, live, most = [], [0], [0]
        real_fill, real_run = tapi.fill_state, Traceback.run

        def freed():
            live[0] -= 1

        def fill_spy(tabs_fill, *args, **kw):
            st = real_fill(tabs_fill, *args, **kw)
            padded = tabs_fill.seq          # the sequence, then "A" to the bucket
            events.append("f" + "".join(
                k for s, k in by_seq.items()
                if padded == s + "A" * (len(padded) - len(s))))
            live[0] += 1
            most[0] = max(most[0], live[0])
            weakref.finalize(st["V"], freed)
            return st

        def run_spy(self):
            events.append("t" + by_seq[self.t.seq])
            return real_run(self)

        mp = pytest.MonkeyPatch()
        mp.setattr(tapi, "fill_state", fill_spy)
        mp.setattr(Traceback, "run", run_spy)
        try:
            got = ccj_tpu_torch.fold_many([SEQS[k] for k in ORDER],
                                          batch_limit=batch_limit, device="cpu")
        finally:
            mp.undo()
        cache[batch_limit] = (got, " ".join(events), most[0], live[0])
        return cache[batch_limit]

    return get


@pytest.fixture(scope="module")
def each():
    return [ccj_tpu_torch.fold(SEQS[k], device="cpu") for k in ORDER]


def _line(results):
    return [(r.seq, r.structure, r.energy_dcal) for r in results]


@pytest.mark.parametrize("batch_limit", LIMITS)
def test_fold_many_matches_fold_and_jax(runs, each, batch_limit):
    got, *_ = runs(batch_limit)
    want = jax_api.fold_many([SEQS[k] for k in ORDER], batch_limit=batch_limit)
    assert [r.seq for r in got] == [SEQS[k] for k in ORDER]
    assert _line(got) == _line(each) == _line(want)


@pytest.mark.parametrize("batch_limit", LIMITS)
def test_fold_many_dispatch_order(runs, batch_limit):
    """Fill k+1 before traceback k at depth 2, one sequence at a time at
    depth 1, buckets in ascending order."""
    _, order, *_ = runs(batch_limit)
    depth = max(1, min(batch_limit, 2))
    assert order == WANT_ORDER[depth]
    ev = order.split()
    for group in ("ACDG", "BEF"):
        for a, b in zip(group, group[1:]):
            before = ev.index("f" + b) < ev.index("t" + a)
            assert before == (depth == 2), (a, b)


@pytest.mark.parametrize("batch_limit", LIMITS)
def test_fold_many_holds_at_most_depth_states(runs, batch_limit):
    _, _, most, left = runs(batch_limit)
    depth = max(1, min(batch_limit, 2))
    assert most == depth          # the pipeline fills ahead, and no further
    assert left == 0              # every state was freed by the end
