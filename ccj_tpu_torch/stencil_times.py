"""Device times of the port's redesigned span kernels of one checkout, so
that two commits can be timed in turns within one run: the PL / PR
stencils (``stencil_pl``, ``stencil_pr``) at ``chip_smoke.py``'s phase 2e
shapes, the span's assembly and write-back (``span_assemble``,
``span_store``) at its phase 2f shapes, or the 2-D recurrences ``span_v``,
``span_wbp``, ``span_wm`` and ``wx_tables`` at its phase 2g shapes
(``span_wbp`` as called apart and as the fills call it: the P split's
minima and the kept weight tables; and the ``span_store`` -> ``span_wm``
pair as the fills launch it).

    python ccj_tpu_torch/stencil_times.py [--tree DIR] [--kernels stencil|span|span2d]

The kernels come from ``--tree``'s package (default: the checkout this file
lies in), built from its ``csrc/`` into its ``build/``; an older commit
unpacked beside this one (``git archive <commit>`` into ``build/parent``)
is timed the same way where its wrappers take this file's calls, else
with its own copy of this file (``python
build/parent/ccj_tpu_torch/stencil_times.py``: each tree times itself).
The operands, the shapes and the timers are the ``chip_smoke.py`` of this
file's checkout (``stencil_cases`` / ``stencil_operands``,
``span_cases`` / ``span_kernel_calls``, ``span2d_cases`` /
``span2d_state``, ``graph_ms``, ``flushed_ms``, ``graph_cold_ms``,
``cuda_ms``): the fills' own calls on a random state and the bench
sequences' tables, the same seed for every tree.  Each call is checked
against the plain version (the store's views filled with -7 before the
plain version writes them).  Prints one JSON line: the card's name and
power limit, the tree, the kernels' ``ptxas`` report where this run built
the library, and per case and kernel the L2-hot (graph replay) and L2-cold
ms a call (``span``, ``span2d``: also the eager call's ms, the wrapper's
host work and launch); also appends it to
``chiprun_out/stencil_times.jsonl`` beside this file's checkout.
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
    ap.add_argument("--kernels", choices=("stencil", "span", "span2d"), default="stencil")
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
    out = {"tree": str(tree), "card": card, "kind": torch.cuda.get_device_name(0),
           "kernels": args.kernels}
    if args.kernels == "stencil":
        out["ptxas"] = smoke.stencil_ptxas(log) if log else None
        out["cases"] = stencil_rows(smoke, cuda_ops, bucket_dims, sp, dev)
    elif args.kernels == "span2d":
        out["ptxas"] = smoke.span2d_ptxas(log) if log else None
        out["cases"] = span2d_rows(smoke, cuda_ops, bucket_dims, sp, dev)
    else:
        out["ptxas"] = smoke.span_ptxas(log) if log else None
        out["cases"] = span_rows(smoke, cuda_ops, bucket_dims, sp, dev)
    line = json.dumps(out)
    print(line, flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "stencil_times.jsonl", "a") as f:
        f.write(line + "\n")


def stencil_rows(smoke, cuda_ops, bucket_dims, sp, dev):
    """Phase 2e's cases: per kernel its L2-hot and L2-cold ms a call."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    weights = smoke.stencil_weights(sp, dev)
    rows = []
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
        rows.append(row)
        del ops
    return rows


def host_ms(fn, calls=20, rounds=7):
    """The host's time for one eager call (its checks, table and launch,
    enqueued): ``calls`` calls on the host clock, the device synchronised
    after each round, outside the clock; the median of ``rounds`` rounds."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return sorted(out)[rounds // 2]


def span_rows(smoke, cuda_ops, bucket_dims, sp, dev):
    """Phase 2f's cases: per kernel its L2-hot, L2-cold (``graph_cold_ms``)
    and eager-call ms a call (``cuda_ms``, CUDA events around 10 calls; and
    ``host_ms``, the host clock's median)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for case in smoke.span_cases(bucket_dims):
        with torch.inference_mode():      # the state's tensors are inference tensors
            (aa, akw), (sa, skw), st = smoke.span_kernel_calls(cuda_ops, case, sp, gen, dev)
            got, want = cuda_ops.span_assemble(*aa, **akw), cuda_ops.span_assemble_ref(*aa, **akw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                sys.exit(f"span_assemble {case['label']}: differs from the plain version")
            dests = sa[0]
            cuda_ops.span_store(*sa, **skw)
            kernel_views = [d.view.clone() for d in dests]
            for d in dests:
                d.view.fill_(-7)
            cuda_ops.span_store_ref(*sa, **skw)
            if not all(torch.equal(d.view, k) for d, k in zip(dests, kernel_views)):
                sys.exit(f"span_store {case['label']}: differs from the plain version")
            del got, want, kernel_views
            row = {"case": case["label"]}
            for kname, fn, a, kw in (("span_assemble", cuda_ops.span_assemble, aa, akw),
                                     ("span_store", cuda_ops.span_store, sa, skw)):
                def kern(fn=fn, a=a, kw=kw):
                    fn(*a, **kw)

                row[kname] = {"ms": smoke.graph_ms(kern, reps=20, replays=5),
                              "ms_l2cold": smoke.graph_cold_ms(kern),
                              "call_ms": smoke.cuda_ms(kern, 10), "host_ms": host_ms(kern)}
            rows.append(row)
            del aa, sa, st
        torch.cuda.empty_cache()
    return rows


def span2d_rows(smoke, cuda_ops, bucket_dims, sp, dev):
    """Phase 2g's cases: ``span_v`` (on EINT cell-major, as the fills hand
    it), ``span_wbp`` (as called apart, and as the fills call it: the P
    split's minima and the kept tables), ``span_wm`` and ``wx_tables``,
    each checked against its plain version: L2-hot, L2-cold
    (``graph_cold_ms``) and eager-call ms a call; ``span_wm`` right after a
    ``span_store`` (phase 2f's n=100 main span's, on a random state), a
    programmatic dependent as the fills launch it, ms a pair
    (``store_wm_pair``); and the host ms of ``span_v``, ``span_wbp`` and
    ``span_wm`` called through a fill's launch tables
    (``cuda_ops.span2d_fill_tables``; ``fill_tables_host_ms``)."""
    import torch

    from ccj_tpu_torch.engine import fold, nested
    from ccj_tpu_torch.engine.gapped import WX
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    _a, (sa, skw), _st = smoke.span_kernel_calls(
        cuda_ops, smoke.span_cases(bucket_dims)[0], sp,
        torch.Generator(device=dev).manual_seed(8), dev)
    gen = torch.Generator().manual_seed(7)
    rows = []
    for case in smoke.span2d_cases(bucket_dims):
        n, s, B, d = case["n"], case["s"], case["B"], case["dangles"]
        sp = scale_parameters(parse_par(HERE / "ccj_tpu_torch" / "params"
                                        / "rna_DirksPierce09.par"), dangles=d)
        Cs = [fold.consts_from_numpy(fold.build_consts(build_seq_tables(
            smoke.bench_seq(n, seed=42 + b), sp, DEFAULT_PK), sp, DEFAULT_PK), dev,
            sc4_np={})[0] for b in range(B)]
        C = {**(fold.add_batch(Cs[0]) if B == 1 else fold.stack_consts(Cs)), "n": n}
        C = nested.cell_major_eint(C)                # as the fills hand it
        st0 = smoke.span2d_state(B, n, gen, dev)
        calls = [("span_v", (s, d), {}), ("span_wbp", (s,), {}), ("span_wm", (s, d), {}),
                 ("wx_tables", (), {}), ("span_wbp fills' call", (s,), {
                     "p_min": smoke.span2d_pmin(B, n, gen, dev),
                     "wx": cuda_ops.wx_tables_ref(
                         C, {k: v.cpu() for k, v in st0.items()}).to(dev)})]
        row = {"case": case["label"]}
        for label, args, kw in calls:
            name = label.split()[0]
            fn, plain = getattr(cuda_ops, name), getattr(cuda_ops, name + "_ref")
            got, want = ({k: v.clone() for k, v in st0.items()} for _ in range(2))
            kw_k, kw_p = ({k: v.clone() for k, v in kw.items()} for _ in range(2))
            out_k = fn(C, got, *args, **kw_k)
            out_p = plain(C, want, *args, **kw_p)
            if not all(torch.equal(got[k], want[k]) for k in st0) or not all(
                    torch.equal(kw_k[k], kw_p[k]) for k in kw) or (
                    name == "wx_tables" and not torch.equal(torch.stack(tuple(out_k)),
                                                            torch.stack(tuple(out_p)))):
                sys.exit(f"{label} {case['label']}: differs from the plain version")

            def kern(fn=fn, got=got, args=args, kw=kw_k):
                fn(C, got, *args, **kw)

            row[label] = {"ms": smoke.graph_ms(kern, reps=20, replays=5),
                          "ms_l2cold": smoke.graph_cold_ms(kern),
                          "call_ms": smoke.cuda_ms(kern, 20), "host_ms": host_ms(kern)}
        # the fills' launches: through launch tables packed once
        got = {k: v.clone() for k, v in st0.items()}
        Cf = {**C, WX: cuda_ops.wx_tables(C, got)}
        Cf[cuda_ops.SPAN2D_FILL] = cuda_ops.span2d_fill_tables(Cf, got, d)
        p_min = smoke.span2d_pmin(B, n, gen, dev)
        row["fill_tables_host_ms"] = {
            "span_v": host_ms(lambda: cuda_ops.span_v(Cf, got, s, d, True)),
            "span_wbp": host_ms(lambda: cuda_ops.span_wbp(Cf, got, s, p_min, Cf[WX])),
            "span_wm": host_ms(lambda: cuda_ops.span_wm(Cf, got, s, d, True))}
        got = {k: v.clone() for k, v in st0.items()}
        want = {k: v.clone() for k, v in st0.items()}
        cuda_ops.span_wm_ref(C, want, s, d)

        def pair(got=got):
            cuda_ops.span_store(*sa, **skw)
            cuda_ops.span_wm(C, got, s, d, True)

        pair()
        if not all(torch.equal(got[k], want[k]) for k in st0):
            sys.exit(f"span_store -> span_wm {case['label']}: differs from the plain version")
        row["store_wm_pair"] = {"ms": smoke.graph_ms(pair, reps=20, replays=5)}
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
