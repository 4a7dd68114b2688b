"""Split the history_min kernel's time into loads and adds
(``ccj_tpu_torch/csrc/history.cu``) on one CUDA card.

    python -m ccj_tpu_torch.history_variants

On the fills' own launches over a random state (``chip_smoke.py``'s phase
2d cases, ``history_launches``: the n=100 main span and the packed n=200
span 135), each variant's device ms per call (graph replay):

* ``kernel``: the library as the fills build it, checked against the
  plain version (``exact``);
* ``loads_only``: a build of the same source with ``-DHISTORY_SKIP_ADDS``
  (each loaded word folded into the output by an xor: every load stays,
  no term is added);
* ``adds_only``: a build with ``-DHISTORY_SKIP_LOADS`` (every term added
  from SAT16: no window load).

The two timing-only builds give wrong results and are built into
``build/`` apart from the library; nothing else loads them.  Prints the
card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def build_variant(flag):
    """``csrc/history.cu`` built with ``-D<flag>`` into its own library in
    ``build/``; returns its ``ccj_history_min``."""
    from ccj_tpu_torch.engine import cuda_ops

    out = cuda_ops.BUILD_DIR / f"libccj_history_{flag.lower()}.so"
    cuda_ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_ops.nvcc_path(), *cuda_ops.NVCC_FLAGS, f"-D{flag}", "-shared",
                    "-o", str(out), str(cuda_ops.CSRC / "history.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).ccj_history_min
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.gapped4 import bucket_dims

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    cuda_ops.build_library()
    lib = cuda_ops._library()
    builds = {"loads_only": build_variant("HISTORY_SKIP_ADDS"),
              "adds_only": build_variant("HISTORY_SKIP_LOADS")}
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = cs.history_psplit_cases(bucket_dims)
    for case in (cases[0], cases[2]):
        (_label, _call, (windows, tables, kw)), = cs.history_launches(cuda_ops, case, gen, "cuda")
        cut, _K = cuda_ops.history_windows(windows, tables, kw["R"], kw["s"])
        want = cuda_ops.history_min_ref(cut, tables, kw["s"], kw["i0"], kw["TB"], kw["R"])
        got = cuda_ops.history_min(windows, tables, **kw)
        row = {"case": case["label"], "exact": bool(torch.equal(got, want)),
               "kernel": cs.graph_ms(lambda: cuda_ops.history_min(windows, tables, **kw), 10, 3)}
        del got, want
        try:
            for name, fn in builds.items():
                cuda_ops._lib = type("Variant", (), {"ccj_history_min": fn})
                row[name] = cs.graph_ms(lambda: cuda_ops.history_min(windows, tables, **kw), 10, 3)
        finally:
            cuda_ops._lib = lib
        print(json.dumps(row), flush=True)
        del windows, tables, cut
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
