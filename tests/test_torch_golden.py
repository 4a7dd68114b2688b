"""End to end: ``ccj_tpu_torch.fold(device="cpu")`` reproduces the reference
binary's goldens (tests/golden/corpus.json) on the entries
tests/test_golden.py selects with n <= 37, the n=37 crossing-band anchor
included.  Structure and energy must match exactly."""

import pytest
import torch

from ccj_tpu_torch import fold

from test_golden import _args_to_kwargs, _select

# one intra-op thread per worker process (see test_torch_fill.py)
torch.set_num_threads(1)

ENTRIES = [e for e in _select() if len(e["seq"]) <= 37]


@pytest.mark.parametrize(
    "entry", ENTRIES,
    ids=lambda e: f"n{len(e['seq'])}-{'_'.join(e['args']) or 'default'}")
def test_torch_golden(entry):
    res = fold(entry["seq"], device="cpu", **_args_to_kwargs(entry["args"]))
    assert res.structure == entry["structure"], (
        f"{entry['seq']} {entry['args']}: {res.structure} != {entry['structure']}")
    assert res.energy_dcal == round(entry["energy"] * 100)
    assert abs(res.energy - entry["energy"]) < 1e-9
