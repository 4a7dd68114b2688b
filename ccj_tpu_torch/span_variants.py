"""Time the span's write-back kernel (``csrc/store.cu``) as the fills
build it against a timing build without its source loads, on one CUDA
card: what the write stream alone costs.

    python -m ccj_tpu_torch.span_variants

On the fills' own calls over a random state (``chip_smoke.py``'s phase 2f
cases, ``span_kernel_calls``), each build's device ms a call (graph
replay, L2-hot) and whether it matches the plain version (``exact``):
``library``, the library as the fills build it; ``no_loads``, a build of
``store.cu`` with ``-DSTORE_SKIP_LOADS`` (every element written, each band
element its source offset instead of a load: wrong values, the writes'
floor).

The timing build is built into ``build/`` apart from the library; nothing
else loads it.  Prints the card's name and power limit, then one JSON line
per case; also appends them to ``chiprun_out/span_variants.jsonl``.
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
    """``csrc/store.cu`` built with ``-D<flag>`` into its own library in
    ``build/``; returns its launch function ``ccj_span_store``."""
    from ccj_tpu_torch.engine import cuda_ops

    out = cuda_ops.BUILD_DIR / f"libccj_store_{flag.lower()}.so"
    cuda_ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_ops.nvcc_path(), *cuda_ops.NVCC_FLAGS, f"-D{flag}", "-shared",
                    "-o", str(out), str(cuda_ops.CSRC / "store.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).ccj_span_store
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def store_variant(cuda_ops, fn, sa, skw):
    """``span_store`` through the launch function ``fn`` of a build: a
    callable making one launch."""
    def run():
        t, _blocks = cuda_ops.store_table(*sa, **skw)
        rc = fn(ctypes.addressof(t), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"span_store variant launch failed: cudaError {rc}")
    return run


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.params import parse_par, scale_parameters

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    lib = cuda_ops._library()
    stores = {"library": lib.ccj_span_store,
              "no_loads": build_variant("STORE_SKIP_LOADS")}
    sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params" / "rna_DirksPierce09.par"))
    gen = torch.Generator(device="cuda").manual_seed(6)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    for case in cs.span_cases(bucket_dims):
        row = {"case": case["label"], "card": card, "span_store": {}}
        with torch.inference_mode():
            (aa, _akw), (sa, skw), st = cs.span_kernel_calls(cuda_ops, case, sp, gen, "cuda")
            dests = sa[0]
            for d in dests:
                d.view.fill_(-7)
            cuda_ops.span_store_ref(*sa, **skw)
            want = [d.view.clone() for d in dests]
            for name, fn in stores.items():
                run = store_variant(cuda_ops, fn, sa, skw)
                for d in dests:
                    d.view.fill_(-7)
                run()
                torch.cuda.synchronize()
                exact = all(torch.equal(d.view, w) for d, w in zip(dests, want))
                row["span_store"][name] = {"ms": cs.graph_ms(run, reps=20, replays=5),
                                           "exact": exact}
            del want, aa, sa, st
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        with open(dest / "span_variants.jsonl", "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
