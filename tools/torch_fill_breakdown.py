#!/usr/bin/env python3
"""Where the dense fill's time goes on the GPU (ccj_tpu_torch).

    python3 tools/torch_fill_breakdown.py [--n 100] [--profile-spans 50:53]

Folds the bench sequence of length n (bench.py, seed 42) three ways on one
CUDA device and prints one JSON object (also written to
chiprun_out/fill_breakdown_n<n>.json):

* ``fill_s``: the plain fill wall (synchronised at the end only);
* ``parts_s``: the same fill with a device synchronise around each span
  function, so each part's wall is summed apart (V, P split, WBP/WPP, the
  cross-span phase of span_gapped4, its serial tt loop, WM/WMv/WMp);
* ``profile``: a torch.profiler trace over a window of spans: device
  kernel time over the window's wall without the profiler (the device's
  busy share), the kernels that take the most device time, and the
  PyTorch ops whose kernels take the most.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ccj_tpu_torch.engine import cuda_ops, fold, gapped4  # noqa: E402
from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters  # noqa: E402
from ccj_tpu_torch.precompute import build_seq_tables  # noqa: E402


def timed(fn, acc, key):
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        return out
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--profile-spans", default="50:53")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    n = args.n
    rng = random.Random(42)
    seq = "".join(rng.choice("ACGU") for _ in range(n))
    sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                    / "rna_DirksPierce09.par"))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C, SC4 = fold.consts_from_numpy(fold.build_consts(tabs, sp, DEFAULT_PK), "cuda")
    out = {"n": n, "card": torch.cuda.get_device_name(0)}

    fold.fill6(C, SC4, n, sp.dangles)          # warm-up (allocator, caches)
    torch.cuda.synchronize()
    cuda_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    st = fold.fill6(C, SC4, n, sp.dangles)
    torch.cuda.synchronize()
    out["fill_s"] = time.perf_counter() - t0
    out["launches"] = cuda_ops.LAUNCHES
    out["V_1_n"] = int(st["V"][1, n])
    del st

    # per-part walls: wrap the span functions where fill6 / span_gapped4
    # look them up, run one fill, restore
    acc = defaultdict(float)
    names = {"compute_V_span": fold, "compute_P_span3": fold,
             "compute_WBP_WPP_span": fold, "span_gapped4": fold,
             "compute_WMv_WMp_WM_span": fold, "run_tt_loop": gapped4}
    saved = {k: getattr(m, k) for k, m in names.items()}
    try:
        for k, m in names.items():
            setattr(m, k, timed(saved[k], acc, k))
        t0 = time.perf_counter()
        fold.fill6(C, SC4, n, sp.dangles)
        torch.cuda.synchronize()
        out["fill_synced_s"] = time.perf_counter() - t0
    finally:
        for k, m in names.items():
            setattr(m, k, saved[k])
    acc["span_gapped4 (cross-span phase)"] = acc.pop("span_gapped4") - acc["run_tt_loop"]
    out["parts_s"] = dict(sorted(acc.items(), key=lambda kv: -kv[1]))

    # device busy share over a window of spans
    lo, hi = (int(x) for x in args.profile_spans.split(":"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    orig = fold.bucket_segments
    st_box = {}

    def window_fill():
        # spans [0, lo) unprofiled, then [lo, hi) under the profiler
        fold.bucket_segments = lambda m: [(b, max(a, 0), min(z, lo))
                                          for b, a, z in orig(m) if a < lo]
        st_box["st"] = fold.fill6(C, SC4, n, sp.dangles)

    try:
        window_fill()
    finally:
        fold.bucket_segments = orig
    st = st_box.pop("st")
    Cn = {**C, "n": n}

    def window():
        # re-running spans whose inputs are final rewrites the same values
        with torch.inference_mode():    # fill6's state is inference tensors
            for s in range(lo, hi):
                TB, IB = gapped4.bucket_dims(n, s)
                fold.compute_V_span(Cn, st, s, sp.dangles)
                fold.compute_P_span3(Cn, st, s)
                fold.compute_WBP_WPP_span(Cn, st, s)
                fold.span_gapped4(Cn, SC4, st, s, TB, IB)
                fold.compute_WMv_WMp_WM_span(Cn, st, s, sp.dangles)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    wall = time.perf_counter() - t0           # the window without the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    # Device kernels are the CUDA-typed entries; a CPU op's entry repeats
    # the device time of the kernels it launched (as the profiler's own
    # table totals it), so it names where that time came from instead.
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)

    def top(events):
        return [{"name": e.key[:80], "count": e.count,
                 "device_s": e.self_device_time_total / 1e6}
                for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]]

    out["profile"] = {
        "spans": [lo, hi], "wall_s": wall,
        "device_busy_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall,
        "top_kernels": top(kernels),
        "top_ops": top(ops),
    }
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"fill_breakdown_n{n}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
