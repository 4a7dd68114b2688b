"""Time variants of the tt_span kernel (``ccj_tpu_torch/csrc/ttspan.cu``) on
one CUDA card: where its time goes, and what its design choices are worth.

    python -m ccj_tpu_torch.ttspan_variants

Each variant is a copy of the source with one or two constants or lines
replaced, built with ``nvcc`` into ``build/ttspan_variants/`` (all at once,
one process each) and called through its own ``ccj_tt_span`` on the same
random span operands as ``chip_smoke.py``'s phase 2c (``span_operands``):

* ``base``: the source as it is (its own choice of cluster and threads);
* ``threads512`` / ``threads1024``: one block per row of 512 / 1024 threads;
* ``cluster2``: two blocks per row (a thread-block cluster) of 1024 threads;
* ``no_reductions`` / ``no_stencil`` / ``neither``: the step without its 13
  reductions, without the PM stencil, or with only its barriers and
  assembly (wrong results: they split the time, nothing else);
* ``unroll8``: 8 slab loads in flight per lane instead of 4;
* ``slabs_l2`` / ``weights_l2`` / ``both_l2``: the slab loads, the weight
  loads (WKX, WJX, DPM) or both through L2 only (``__ldcg``), leaving L1
  to the other;
* ``qchunk16`` / ``qchunk64``: reduction tasks of 16 / 64 q values, not 32.

Prints one JSON line per span: each variant's device ms per call (CUDA
events around 5 calls, after one), and whether its slabs equal the plain
version's (``tt_span_ref``).  The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from .engine import cuda_ops

ROOT = Path(__file__).resolve().parents[1]

WIDE = "const bool wide = rows * cluster <= sms;"
NRED = "const int nred = t.njobs * njt * nqc;"
TASKS = "task < nred + njt * kDS; task += kRowWarps"
SLAB = "return *p;\n  }\n}"
WEIGHT = "return __ldg(p); }"
VARIANTS = {
    "base": [],
    "threads512": [(WIDE, "const bool wide = false; cluster = 1;")],
    "threads1024": [(WIDE, "const bool wide = true; cluster = 1;")],
    "cluster2": [(WIDE, "const bool wide = true; cluster = 2;")],
    "no_reductions": [(NRED, "const int nred = 0;")],
    "no_stencil": [(TASKS, "task < nred; task += kRowWarps")],
    "neither": [(NRED, "const int nred = 0;"), (TASKS, "task < nred; task += kRowWarps")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "slabs_l2": [(SLAB, "return __ldcg(p);\n  }\n}")],
    "weights_l2": [(WEIGHT, "return __ldcg(p); }")],
    "both_l2": [(SLAB, "return __ldcg(p);\n  }\n}"), (WEIGHT, "return __ldcg(p); }")],
    "qchunk16": [("constexpr int kQChunk = 32;", "constexpr int kQChunk = 16;")],
    "qchunk64": [("constexpr int kQChunk = 32;", "constexpr int kQChunk = 64;")],
}
# (n, s, TB, IB, batch, i0): the n=100 main span, the n=100 fill's heaviest,
# the packed n=200 one, a batch of 4 at n=100, a row shard of n=100
SPANS = [(100, 37, 64, 102, 1, 0), (100, 69, 99, 64, 1, 0), (200, 135, 134, 100, 1, 0),
         (100, 37, 64, 102, 4, 0), (100, 37, 64, 26, 1, 26)]


def build():
    src = (ROOT / "ccj_tpu_torch" / "csrc" / "ttspan.cu").read_text()
    out = ROOT / "build" / "ttspan_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in ttspan.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_ops.nvcc_path(), *cuda_ops.NVCC_FLAGS, "-shared", "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.ccj_tt_span.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke       # the span operands and timers of its phase 2c
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    libs = build()
    dev = torch.device("cuda")
    for n, s, TB, IB, B, i0 in SPANS:
        gen = torch.Generator().manual_seed(n + s + B + i0)
        ops = chip_smoke.span_operands(n, s, TB, IB, gen, dev, B)
        kw = dict(s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
        want = chip_smoke.clone_operands(ops)
        cuda_ops.tt_span_ref(cuda_ops.SpanTable(*want, **kw))
        row = {"span": {"n": n, "s": s, "TB": TB, "IB": IB, "batch": B, "i0": i0}}
        for name, lib in libs.items():
            got = chip_smoke.clone_operands(ops)
            table = cuda_ops.SpanTable(*got, **kw)
            plan = (ctypes.c_int * 2)()

            def call():
                rc = lib.ccj_tt_span(ctypes.addressof(table), 0,
                                     torch.cuda.current_stream().cuda_stream, plan)
                if rc:
                    raise SystemExit(f"variant {name}: cudaError {rc}")

            ms = chip_smoke.cuda_ms(call, 5)
            same = all(torch.equal(got[0][k], want[0][k]) for k in cuda_ops.STEP_FAMILIES)
            row[name] = {"ms": ms, "plan": list(plan), "equal": same}
            del got, table
        print(json.dumps(row), flush=True)
        del ops, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
