"""The port's partition function (``ccj_tpu_torch/engine/pf4d.py``, pf.py,
sample.py, ``api.partition``) against the JAX package's.

* float32: the port's device fill against ``ccj_tpu.engine.pf4d.
  pf_fill_device`` on tests/test_pf_device.py's SEQS, both fed identical
  constants (the JAX ``build_pfc`` arrays through ``pfc_from_numpy``):
  every 2-D matrix, every 4-D entry and W within rtol 2e-4, the JAX
  suite's own tolerance against pf.py;
* float64: the port's device fill against the host float64 engine within
  rtol 1e-9 (the JAX package's float64 device fill agrees with pf.py to a
  relative ~7e-16 on the CPU, so a miss here is a fault of the port);
* the port's sampler fed the JAX device result draws the same counts as
  the JAX sampler for a fixed seed;
* ``partition`` against ``ccj_tpu.partition``: ensemble energy within
  1e-3, Z within a relative 2e-4, on both engines.
"""

import numpy as np
import pytest
import torch

from ccj_tpu.api import partition as jax_partition
from ccj_tpu.engine import pf as jpf
from ccj_tpu.engine import pf4d as jpf4d
from ccj_tpu.engine.sample import sample_structures as jax_sample
from ccj_tpu.params import parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.api import partition
from ccj_tpu_torch.engine import pf as tpf
from ccj_tpu_torch.engine import pf4d as tpf4d
from ccj_tpu_torch.engine.sample import sample_structures
from ccj_tpu_torch.params import DEFAULT_PK
from ccj_tpu_torch.params import parse_par as t_parse_par
from ccj_tpu_torch.params import scale_parameters as t_scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables as t_build_seq_tables

from oracle_util import REPO
from test_pf_device import PAR, SEQS, _setup

# one intra-op thread per worker process (see test_torch_fill.py)
torch.set_num_threads(1)

KEYS_2D = ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP")


@pytest.fixture(scope="module")
def jax_runs():
    """Per sequence: the JAX tables, its float32 device fill and the port's
    float32 fill from the same constants."""
    cache = {}

    def get(seq):
        if seq not in cache:
            sp, tabs = _setup(seq)
            C, _, _ = jpf4d.build_pfc(tabs, sp, DEFAULT_PK)
            C_np = {k: np.asarray(v) for k, v in C.items()}
            want = jpf4d.pf_fill_device(tabs, sp, DEFAULT_PK)
            got = tpf4d.pf_fill_device(
                tabs, sp, DEFAULT_PK, device="cpu",
                C=tpf4d.pfc_from_numpy(C_np, "cpu"))
            cache[seq] = (sp, tabs, want, got)
        return cache[seq]

    return get


@pytest.mark.parametrize("seq", SEQS)
def test_float32_fill_matches_jax_device_fill(jax_runs, seq):
    *_, want, got = jax_runs(seq)
    for k in KEYS_2D:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-300,
                                   err_msg=k)
    for name, view in want["M4"].items():
        np.testing.assert_allclose(got["M4"][name].arr, view.arr, rtol=2e-4,
                                   atol=1e-300, err_msg=name)
    np.testing.assert_allclose(got["W"], want["W"], rtol=2e-4)
    assert abs(tpf.ensemble_energy(got) - jpf.ensemble_energy(want)) < 1e-3


@pytest.mark.parametrize("seq", SEQS)
def test_float64_fill_matches_host_engine(seq):
    sp = t_scale_parameters(t_parse_par(REPO / "ccj_tpu_torch" / "params"
                                        / "rna_DirksPierce09.par"))
    tabs = t_build_seq_tables(seq, sp, DEFAULT_PK)
    host = tpf.pf_fill(tabs, sp, DEFAULT_PK)
    dev = tpf4d.pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64,
                               device="cpu")
    for k in KEYS_2D:
        np.testing.assert_allclose(dev[k], host[k], rtol=1e-9, atol=1e-300,
                                   err_msg=k)
    stored = 0
    for name, d in host["M4"].items():
        for key, hv in d.items():
            dv = dev["M4"][name].get(key, 0.0)
            assert abs(hv - dv) <= 1e-9 * max(abs(hv), abs(dv)), (name, key, hv, dv)
            stored += 1
    assert stored > 0
    np.testing.assert_allclose(dev["W"], host["W"], rtol=1e-9)


def test_sampler_matches_jax_sampler(jax_runs):
    sp, tabs, want, _ = jax_runs(SEQS[0])
    c_jax, s_jax = jax_sample(tabs, sp, DEFAULT_PK, want, num_samples=50, seed=3)
    c_port, s_port = sample_structures(tabs, sp, DEFAULT_PK, want,
                                       num_samples=50, seed=3)
    np.testing.assert_array_equal(c_port, c_jax)
    assert len(s_port) == len(s_jax) == 50
    for a, b in zip(s_port, s_jax):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("on_device", [True, False], ids=["device", "host"])
def test_partition_matches_jax(on_device):
    seq = SEQS[0]
    got = partition(seq, num_samples=10, on_device=on_device, device="cpu")
    want = jax_partition(seq, num_samples=10, device=on_device)
    assert abs(got.ensemble_energy - want.ensemble_energy) < 1e-3
    assert abs(got.Z - want.Z) / want.Z < 2e-4
    assert got.pair_probs.shape == want.pair_probs.shape


def test_pfc_from_numpy_keeps_index_dtypes():
    sp, tabs = _setup(SEQS[0])
    C_np, _ = tpf4d.pfc_numpy(tabs, sp, DEFAULT_PK)
    C = tpf4d.pfc_from_numpy(C_np, "cpu", torch.float64)
    assert C["can_pair"].dtype == torch.bool
    assert C["W4PL"].dtype == C["scale2"].dtype == torch.float64
    np.testing.assert_array_equal(C["ptype"].numpy(), np.asarray(tabs.ptype))


@pytest.mark.parametrize("dangles", [0, 2])
def test_port_constants_match_jax(dangles):
    """The port's own constant path (``build_pfc``, the partition's) gives
    the JAX package's float32 constants exactly."""
    sp = scale_parameters(parse_par(PAR), dangles=dangles)
    tabs = build_seq_tables(SEQS[1], sp, DEFAULT_PK)
    want, _, _ = jpf4d.build_pfc(tabs, sp, DEFAULT_PK)
    got, _, _ = tpf4d.build_pfc(tabs, sp, DEFAULT_PK, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        assert got[k].dtype.itemsize == np.asarray(v).dtype.itemsize, k
