"""Fold and fill walls of one checkout of the port on one CUDA device, so
that two commits can be timed in turns within one run.

    python ccj_tpu_torch/walls.py [--tree DIR] [--n 100 126 134 200] [--label L]

``ccj_tpu_torch`` is imported from ``--tree`` (default: the checkout this
file lies in), so the same script times an older commit unpacked beside
it.  Per length, one ``ccj_tpu_torch.fold`` end to end after a warm-up fold
of the first length: the bench sequence at n=100 (seed 42, as bench.py
draws it; V(1, 100) = -1528 checked) and the reference anchors
``tests/golden/long/seed42_n{126,134,200}.txt`` (structure and energy
checked against the golden line), with the fill inside the fold timed
apart (synchronised around ``api.fill_state``).  Prints one JSON line:
the card's name and power limit, the tree, and per length the fold and
fill walls; also appends it to ``chiprun_out/walls.jsonl`` beside this
file's checkout.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
BENCH_V100 = -1528          # bench.py BENCH_V[100]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--n", type=int, nargs="+", default=[100, 126, 134, 200])
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from ccj_tpu_torch import api, fold
    from ccj_tpu_torch.cli import _format_energy

    def case(n):
        if n == 100:
            rng = random.Random(42)
            return "".join(rng.choice("ACGU") for _ in range(n)), None
        seq, line = (HERE / "tests" / "golden" / "long" / f"seed42_n{n}.txt") \
            .read_text().splitlines()[:2]
        return seq, line

    real_fill_state = api.fill_state
    fills = []

    def timed_fill_state(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = real_fill_state(*a, **kw)
        torch.cuda.synchronize()
        fills.append((time.perf_counter() - t0, st))
        return st

    api.fill_state = timed_fill_state
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"tree": str(tree), "label": args.label, "card": card,
           "kind": torch.cuda.get_device_name(0), "walls": []}
    try:
        fold(case(args.n[0])[0])                  # warm-up: library, allocator
        for n in args.n:
            seq, line = case(n)
            fills.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fold(seq)
            fold_s = time.perf_counter() - t0
            fill_s, st = fills[0]
            if line is None:
                v = int(st["V"][1, n])
                if v != BENCH_V100:
                    sys.exit(f"V(1,{n}) = {v}, want {BENCH_V100}")
            elif f"{res.structure} ({_format_energy(res.energy)})" != line:
                sys.exit(f"n={n}: {res.structure} ({res.energy}) != {line}")
            fills.clear()
            del st
            out["walls"].append({"n": n, "fold_s": fold_s, "fill_s": fill_s})
            torch.cuda.empty_cache()
    finally:
        api.fill_state = real_fill_state
    print(json.dumps(out), flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "walls.jsonl", "a") as fh:
        fh.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
