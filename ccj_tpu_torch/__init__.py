"""ccj_tpu_torch — the CCJ pseudoknot MFE folder on PyTorch and CUDA.

The PyTorch port of ``ccj_tpu``: the same dense span-wavefront DP, bit for
bit, with the serial tt loop's min-plus reductions in a CUDA C++ kernel
written for Hopper (``csrc/minplus.cu``), and the sum-product partition
function.  It imports neither JAX nor ``ccj_tpu``; its entry points
(``fold``, ``fold_many``, ``partition``, ``python -m ccj_tpu_torch.cli``)
run on the GPU unless the caller passes ``device="cpu"``.
"""

from .api import FoldResult, PFResult, fold, fold_many, partition

__all__ = ["fold", "fold_many", "partition", "FoldResult", "PFResult"]
__version__ = "0.1.0"
