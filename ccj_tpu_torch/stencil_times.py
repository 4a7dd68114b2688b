"""Device times of the PL / PR stencil kernels (``stencil_pl``,
``stencil_pr``) of one checkout of the port at ``chip_smoke.py``'s phase 2e
shapes, so that two commits can be timed in turns within one run.

    python ccj_tpu_torch/stencil_times.py [--tree DIR]

The kernels come from ``--tree``'s package (default: the checkout this file
lies in), built from its ``csrc/`` into its ``build/``; an older commit
unpacked beside this one (``git archive <commit>`` into ``build/parent``)
is timed the same way.  The operands, the shapes and the timers are this
checkout's ``chip_smoke.py`` (``stencil_cases``, ``stencil_operands``,
``graph_ms``, ``flushed_ms``): the fills' own calls on a random state and
the bench sequences' weights, the same seed for every tree.  Each call is
checked against the plain version.  Prints one JSON line: the card's name
and power limit, the tree, the kernels' ``ptxas`` report where this run
built the library, and per case and kernel the L2-hot (graph replay) and
L2-cold ms a call; also appends it to ``chiprun_out/stencil_times.jsonl``
beside this file's checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("stencil_times_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.params import parse_par, scale_parameters

    dev = torch.device("cuda")
    _, log = cuda_ops.build_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    sp = scale_parameters(parse_par(HERE / "ccj_tpu_torch" / "params"
                                    / "rna_DirksPierce09.par"))
    gen = torch.Generator(device=dev).manual_seed(5)
    weights = smoke.stencil_weights(sp, dev)
    out = {"tree": str(tree), "card": card,
           "kind": torch.cuda.get_device_name(0),
           "ptxas": smoke.stencil_ptxas(log) if log else None, "cases": []}
    for case in smoke.stencil_cases(bucket_dims):
        n, B = case["n"], case["B"]
        ops, kw, _ = smoke.stencil_operands(cuda_ops, case, weights(case), gen, dev)
        row = {"case": case["label"]}
        for fam, kname in (("PL", "stencil_pl"), ("PR", "stencil_pr")):
            parts, w = ops[fam]
            fn = getattr(cuda_ops, kname)
            want = getattr(cuda_ops, kname + "_ref")(
                cuda_ops.stencil_parts(parts, B, n + 2, kw["s"]), w, kw["s"], n,
                kw["i0"], kw["TB"], kw["R"])
            if not torch.equal(fn(parts, w, **kw), want):
                sys.exit(f"{kname} {case['label']}: differs from the plain version")

            def kern(fn=fn, parts=parts, w=w):
                fn(parts, w, **kw)

            row[kname] = {"ms": smoke.graph_ms(kern, reps=20, replays=5),
                          "ms_l2cold": smoke.flushed_ms(kern, 20)}
        out["cases"].append(row)
        del ops
    line = json.dumps(out)
    print(line, flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "stencil_times.jsonl", "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
