"""The port stands alone and never runs on the CPU unasked: no module of
``ccj_tpu_torch`` (nor ``chip_smoke.py``) imports JAX or ``ccj_tpu``; the
entry points (``fold``, ``fold_many``, ``partition``, the CLI) default to
CUDA and raise without it; the kernel wrapper launches or raises for
non-CPU tensors and never falls back."""

import subprocess
import sys

import pytest
import torch

import ccj_tpu_torch
from ccj_tpu_torch import cli
from ccj_tpu_torch.engine import cuda_ops

from oracle_util import REPO

_CHECK = """
import importlib, pkgutil, sys
import ccj_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ccj_tpu_torch.__path__, "ccj_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ccj_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_ccj_tpu():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 30   # every module was seen


def test_fold_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ccj_tpu_torch.fold("GGGAAACGGGCGAUCC")
    with pytest.raises(RuntimeError, match="CUDA"):
        ccj_tpu_torch.fold("GGGAAACGGGCGAUCC", device="cuda")


def test_fold_many_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ccj_tpu_torch.fold_many(["GGGAAACGGGCGAUCC", "GCGCAAUUGCGC"])


@pytest.mark.parametrize("on_device", [None, True, False])
def test_partition_defaults_to_cuda_and_raises_without_it(monkeypatch, on_device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ccj_tpu_torch.partition("GCGCAAUUGCGC", num_samples=1, on_device=on_device)


@pytest.mark.parametrize("extra", [[], ["--pf"], ["--device", "cuda"]])
def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, extra):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["GCGCAAUUGCGC", *extra])


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    wrapper inspects before it needs the kernel library."""

    def __init__(self, shape):
        self.shape = torch.Size(shape)
        self.dtype = torch.int32
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


def test_wrapper_refuses_cuda_call_without_library(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    before = cuda_ops.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_ops.minplus_window(_CudaTyped((8, 3, 5)), _CudaTyped((8, 5)), 0)
    assert cuda_ops.LAUNCHES == before


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    slab = torch.zeros((8, 3, 5), dtype=torch.int32, device="meta")
    w = torch.zeros((8, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ops.minplus_window(slab, w, 0)
    with pytest.raises(ValueError, match="CUDA"):   # mixed devices too
        cuda_ops.minplus_window(torch.zeros((8, 3, 5), dtype=torch.int32), w, 0)
