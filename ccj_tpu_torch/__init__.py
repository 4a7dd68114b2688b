"""ccj_tpu_torch — the CCJ pseudoknot MFE folder on PyTorch and CUDA.

The PyTorch port of ``ccj_tpu``: the same dense span-wavefront DP, bit for
bit, with the serial tt loop's min-plus reductions in a CUDA C++ kernel
written for Hopper (``csrc/minplus.cu``).  It imports neither JAX nor
``ccj_tpu``; its entry points run on the GPU unless the caller passes
``device="cpu"``.
"""

from .api import FoldResult, fold

__all__ = ["fold", "FoldResult"]
__version__ = "0.1.0"
