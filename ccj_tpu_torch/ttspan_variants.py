"""Time the tt_span kernel's launch plans (``ccj_tpu_torch/csrc/ttspan.cu``)
on one CUDA card: where its time goes, and what its design choices are
worth.

    python -m ccj_tpu_torch.ttspan_variants

Every variant is a set of ``cuda_ops.SpanPlan`` knobs passed to
``cuda_ops.tt_span`` (the library is built as the fills build it), or, for
the phase splits, the kernel's own plan through the timing-only
``cuda_ops.tt_span_phases``, on the same random span operands as
``chip_smoke.py``'s phase 2c (``span_operands``, the fills' contract):

* ``base``: the kernel's own plan;
* ``cluster1`` / ``cluster2`` / ``cluster4``: blocks a row (a thread-block
  cluster, each block with the whole band and a share of the tasks);
* ``threads256`` / ``threads512`` / ``threads1024``: threads a block;
* ``ldg`` / ``staged``: the weights read through ``__ldg`` from L2, or
  staged into shared memory once per row (where they fit beside the band);
* ``rows_half`` / ``rows_quarter``: only half / a quarter of the band's
  rows on chip, the rest read back from device memory (the path of a band
  larger than a block's shared memory);
* ``no_reductions`` / ``no_stencil`` / ``assembly_only`` / ``empty``: the
  step without its 13 reductions, without the PM stencil, with neither, or
  with every phase left out, only its two barriers a step (wrong results:
  they split the time, nothing else).

The band sits on chip as int16 (stored values lie in [-32768, SAT16]); an
int32 band tied with it where both fit and cannot hold n=200's span
(PERF.md, PR 11), so the kernel has no int32 variant.  A cluster replicates the band, it does not split it: a band too large for
one block keeps its oldest rows in device memory (``rows_*`` time that
path).  Prints one JSON
line per span: each variant's device ms per call (graph replay, L2-hot),
the plan it launched and whether its slabs equal the plain version's
(``tt_span_ref``).  The card's name and power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from .engine import cuda_ops

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = {
    "base": {}, "cluster1": {"cluster": 1}, "cluster2": {"cluster": 2},
    "cluster4": {"cluster": 4}, "threads256": {"threads": 256}, "threads512": {"threads": 512},
    "threads1024": {"threads": 1024}, "ldg": {"stage": 0}, "staged": {"stage": 1},
    "rows_half": {"rows": 2}, "rows_quarter": {"rows": 4},
}
# the phases each split leaves out (tt_span_phases' skip)
PHASES = {"no_reductions": 1, "no_stencil": 2, "assembly_only": 3, "empty": 7}
# (n, s, TB, IB, batch, i0): chip_smoke.py phase 2c's five spans (the n=100
# main span, n=128's, the packed n=200 one, a row shard of n=100, the n=100
# fill's heaviest), the batched fills' main spans (100 x 4, 64 x 8), an n=100
# span with 29 live rows (4 blocks a row fit the card at once), and two
# packed n=200 spans whose band is too large for one block (s = 165: 35
# live rows; s = 199: one)
SPANS = [(100, 37, 64, 102, 1, 0), (128, 65, 64, 128, 1, 0), (200, 135, 134, 100, 1, 0),
         (100, 37, 64, 26, 1, 26), (100, 69, 99, 64, 1, 0), (100, 37, 64, 102, 4, 0),
         (64, 33, 32, 64, 8, 0), (100, 71, 99, 64, 1, 0), (200, 165, 168, 66, 1, 0),
         (200, 199, 198, 32, 1, 0)]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke       # the span operands and timers of its phase 2c
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    dev = torch.device("cuda")
    for n, s, TB, IB, B, i0 in SPANS:
        gen = torch.Generator().manual_seed(n + s + B + i0)
        ops = chip_smoke.span_operands(n, s, TB, IB, gen, dev, B, i0)
        kw = dict(n=n, s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
        want = chip_smoke.clone_operands(ops)
        cuda_ops.tt_span_ref(cuda_ops.SpanTable(*want, **kw))
        row = {"span": {"n": n, "s": s, "TB": TB, "IB": IB, "batch": B, "i0": i0}}
        for name, knobs in VARIANTS.items():
            plan = {k: (s - 1) // v if k == "rows" else v for k, v in knobs.items()}
            got = chip_smoke.clone_operands(ops)
            table = cuda_ops.SpanTable(*got, **kw)
            cuda_ops.tt_span(table, plan)
            torch.cuda.synchronize()
            same = all(torch.equal(got[0][k], want[0][k]) for k in cuda_ops.STEP_FAMILIES)
            ms = chip_smoke.graph_ms(lambda: cuda_ops.tt_span(table, plan), reps=5, replays=4)
            row[name] = {"ms": ms, "plan": table.plan, "equal": same}
            del got, table
        table = cuda_ops.SpanTable(*chip_smoke.clone_operands(ops), **kw)
        for name, skip in PHASES.items():
            ms = chip_smoke.graph_ms(lambda: cuda_ops.tt_span_phases(table, skip),
                                     reps=5, replays=4)
            row[name] = {"ms": ms, "plan": table.plan}
        del table
        row["empty_step_us"] = row["empty"]["ms"] * 1e3 / (s - 1)
        print(json.dumps(row), flush=True)
        del ops, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
