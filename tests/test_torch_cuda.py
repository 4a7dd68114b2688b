"""The CUDA kernel against its plain PyTorch version, on the card (exact:
integer data).  Marked ``gpu``; each test skips where no CUDA device is
present.  This file imports neither JAX nor ``ccj_tpu``, so on a machine
without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine.common import INF

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, gen, dev):
    x = torch.randint(-30000, 32767, shape, generator=gen, dtype=torch.int32)
    x[torch.rand(shape, generator=gen) < 0.3] = INF
    return x.to(dev)


@pytest.mark.parametrize("TB,IB,n2,s", [(16, 16, 18, 12), (64, 102, 102, 40),
                                        (99, 64, 102, 66), (127, 64, 130, 70)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_kernel_matches_plain(cuda, TB, IB, n2, s, mode):
    gen = torch.Generator().manual_seed(TB * 7 + mode)
    for tt in (0, (s - 2) // 2, s - 2):
        if mode == 2:
            slab = _rand((2 * TB + 2, IB, n2 + TB), gen, cuda)
            w = _rand((TB, n2), gen, cuda)
            args = (tt + 1, tt, 0, mode, 2)
        else:
            slab = _rand((2 * TB + 2, IB, n2), gen, cuda)
            w = _rand((TB, n2 + TB + 1), gen, cuda)[:, tt + 2: tt + 2 + n2]
            args = (tt + 1, 0, 0, mode, s - 4 - tt)
        before = cuda_ops.LAUNCHES
        got = cuda_ops.minplus_window(slab, w, *args)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES == before + 1
        assert torch.equal(got, cuda_ops.minplus_window_ref(slab, w, *args))


@pytest.mark.parametrize("lo", [-1, 0, 5, 40])
def test_suffix_kernel_matches_plain(cuda, lo):
    gen = torch.Generator().manual_seed(lo + 1)
    slab, w = _rand((23, 13, 150), gen, cuda), _rand((23, 150), gen, cuda)
    got = cuda_ops.minplus_suffix(slab, w, lo)
    assert torch.equal(got, cuda_ops.minplus_suffix_ref(slab, w, lo))


def test_fold_on_cuda_matches_cpu(cuda):
    from ccj_tpu_torch import fold

    seq = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
    before = cuda_ops.LAUNCHES
    res = fold(seq)
    assert cuda_ops.LAUNCHES > before
    assert (res.structure, res.energy) == ("(((([[[...[[[[[[[))))....]]]]]]].]]].", -9.94)
