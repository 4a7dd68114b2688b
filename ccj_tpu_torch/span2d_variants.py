"""Time the options of ``span_v``'s design (``ccj_tpu_torch/csrc/span2d.cu``)
on one CUDA card:

    python -m ccj_tpu_torch.span2d_variants

At ``chip_smoke.py``'s phase 2g shapes (random 2-D states, the bench
sequences' tables), each variant's device ms per call (graph replay,
L2-hot) and L2-cold (``graph_cold_ms``), each checked against the plain
version (``exact``):

* ``kernel``: ``span_v`` as the fills call it (EINT cell-major:
  ``nested.cell_major_eint``);
* ``eint_as_uploaded``: the same on EINT as ``fold.consts_from_numpy``
  uploads it (``[B, 32, 32, n2, n2]`` in memory: a cell's terms n2^2 * 4 B
  apart);

and the ``span_wm`` -> ``span_v`` pair back to back (the fills' order from
one span to the next), 20 pairs in one CUDA graph, ms a pair:

* ``pair``: ``span_v`` a programmatic dependent launch, as the fills make
  it from their second span on (``span_wm`` triggers it at its start);
* ``pair_plain``: ``span_v`` launched plainly, the wrapper's default.

Prints the card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ccj_tpu_torch.engine import cuda_ops, fold
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.engine.nested import cell_major_eint
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cuda_ops.build_library()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    for case in cs.span2d_cases(bucket_dims):
        n, s, B, d = case["n"], case["s"], case["B"], case["dangles"]
        sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                        / "rna_DirksPierce09.par"), dangles=d)
        Cs = [fold.consts_from_numpy(fold.build_consts(build_seq_tables(
            cs.bench_seq(n, seed=42 + b), sp, DEFAULT_PK), sp, DEFAULT_PK), dev,
            sc4_np={})[0] for b in range(B)]
        uploaded = {**(fold.add_batch(Cs[0]) if B == 1 else fold.stack_consts(Cs)), "n": n}
        C = cell_major_eint(uploaded)
        st0 = cs.span2d_state(B, n, gen, dev)
        want = {k: v.clone() for k, v in st0.items()}
        cuda_ops.span_v_ref(C, want, s, d)
        row = {"case": case["label"], "card": card}
        for label, Cv in (("kernel", C), ("eint_as_uploaded", uploaded)):
            got = {k: v.clone() for k, v in st0.items()}

            def call(Cv=Cv, got=got):
                cuda_ops.span_v(Cv, got, s, d)

            call()
            torch.cuda.synchronize()
            row[label] = {"exact": all(torch.equal(got[k], want[k]) for k in st0),
                          "ms": cs.graph_ms(call, reps=20, replays=5),
                          "ms_l2cold": cs.graph_cold_ms(call)}
        # the span_wm -> span_v pair, as one span ends and the next begins
        pair_want = {k: v.clone() for k, v in st0.items()}
        cuda_ops.span_wm_ref(C, pair_want, s - 1, d)
        cuda_ops.span_v_ref(C, pair_want, s, d)
        for label, dependent in (("pair", True), ("pair_plain", False)):
            got = {k: v.clone() for k, v in st0.items()}

            def pair(got=got, dependent=dependent):
                cuda_ops.span_wm(C, got, s - 1, d)
                cuda_ops.span_v(C, got, s, d, dependent)

            pair()
            torch.cuda.synchronize()
            row[label] = {"exact": all(torch.equal(got[k], pair_want[k]) for k in st0),
                          "ms": cs.graph_ms(pair, reps=20, replays=5)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
