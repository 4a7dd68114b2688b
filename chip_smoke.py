#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ccj_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. the card's name and power limit; build the CUDA kernel library from
   ``ccj_tpu_torch/csrc/`` and report the build time;
2. ``minplus_window`` against its plain PyTorch version on the card,
   exactly (tolerance zero: integer data), in all three mask modes, at the
   CPU tests' shapes and at the main path's largest shapes for n=100 and
   n=128, with the kernel's, the plain version's and the byte bound's time
   per shape (no single PyTorch call computes this function, so there is
   no library yardstick).  ``ms`` / ``plain_ms`` are device times per call
   (CUDA-graph replay); ``call_ms`` / ``plain_call_ms`` are eager calls back
   to back, the host's launch path included;
3. fold the corpus entries at n=16, 37 and 60 (default arguments) and
   compare with ``tests/golden/corpus.json``;
4. the main path: ``ccj_tpu_torch.fold`` of the n=100 bench sequence
   (bench.py, seed 42) with the kernel's launch count reset just before and
   read just after (it must equal 13 per tt step); then the fill alone
   (V(1, 100) must be -1528, bench.py's golden), the host copy and the
   traceback, timed apart, and cells/s as bench.py counts them;
5. fold ``tests/golden/long/seed42_n126.txt`` (the bucket of 128, dense)
   and match structure and energy byte for byte; peak device memory.

Prints one JSON line per phase, the kernels line, the card line, and last
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor-core float32 peak; int32
#                             add/min have no tensor-core form and run no
#                             faster, so ops / this rate is a floor
BENCH_V100 = -1528          # bench.py BENCH_V[100]
REPLACES = "ccj_tpu/engine/pallas_ops.py:38"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_seq(n, seed=42):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGU") for _ in range(n))


def cells4d(n):
    return 22 * n * (n + 1) * (n + 2) * (n + 3) // 24


def cuda_ms(fn, reps):
    """Mean time of one eager call, back to back, on the card's clock (CUDA
    events), warm.  Where the host launches slower than the card runs, this
    is the host's launch path."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=50, replays=10):
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's launch
    path is out of the timing.  The inputs stay in L2 across calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def rand_i32(shape, gen, dev):
    """INF-encoded int32 test data, made on the host from ``gen``."""
    from ccj_tpu_torch.engine.common import INF

    x = torch.randint(-30000, 32767, shape, generator=gen, dtype=torch.int32)
    x[torch.rand(shape, generator=gen) < 0.3] = INF
    return x.to(dev)


def phase_kernel(cuda_ops, bucket_dims):
    """Phase 2: kernel vs plain version; returns (rows, main-path row)."""
    from ccj_tpu_torch.engine.common import INF

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = []
    for T, I, J in ((7, 5, 9), (16, 8, 128), (23, 13, 150)):
        for lo in (-1, 0, 5):
            slab, w = rand_i32((T, I, J), gen, dev), rand_i32((T, J), gen, dev)
            cases.append((f"suffix {T}x{I}x{J} lo={lo}", slab, w,
                          (0, 0, max(lo + 1, 0), 0, 0)))
    main_case = None
    for n in (100, 128):
        # the span whose window TB x IB x n2 is largest on this length
        n2 = n + 2
        s = max(range(2, n), key=lambda s: (bucket_dims(n, s)[0]
                                            * bucket_dims(n, s)[1], s))
        TB, IB = bucket_dims(n, s)
        tt = (s - 2) // 2
        slab = rand_i32((2 * TB + 2, IB, n2), gen, dev)
        wk = rand_i32((TB, n2 + TB + 1), gen, dev)[:, tt + 2: tt + 2 + n2]
        slabB = rand_i32((2 * TB + 2, IB, n2 + TB), gen, dev)
        wj = rand_i32((TB, n2), gen, dev)
        tag = f"n={n} s={s} tt={tt} TB={TB} IB={IB}"
        cases += [(f"red_k mode0 {tag}", slab, wk, (tt + 1, 0, 0, 0, 0)),
                  (f"red_k mode1 {tag}", slab, wk, (tt + 1, 0, 0, 1, s - 4 - tt)),
                  (f"red_j mode0 {tag}", slabB, wj, (tt + 1, tt, 0, 0, 2)),
                  (f"red_j mode2 {tag}", slabB, wj, (tt + 1, tt, 0, 2, 2))]
        if n == 100:
            main_case = cases[-1][0]

    emit({"phase": "kernel", "library": "none: no single PyTorch call computes "
          "a masked min-plus window, so library_ms is null"})
    rows = []
    for name, slab, w, (row0, col0, q_lo, mode, c) in cases:
        def kern():
            return cuda_ops.minplus_window(slab, w, row0, col0, q_lo, mode, c)

        def plain():
            return cuda_ops.minplus_window_ref(slab, w, row0, col0, q_lo, mode, c)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"minplus_window != plain on {name}: max |err| = {err}")
        check(int(got.max()) <= INF, f"minplus_window above INF on {name}")
        # work this call's data needs: admissible (q, i, j) terms
        Q, J = w.shape
        I = slab.shape[1]
        q = torch.arange(Q, device=dev)[:, None, None]
        i = torch.arange(I, device=dev)[None, :, None]
        j = torch.arange(J, device=dev)[None, None, :]
        keep = (q >= q_lo) & (i >= 0) & (j >= 0)
        if mode == 1:
            keep &= q <= c - j + i
        elif mode == 2:
            keep &= q <= j - i - c
        terms = int(keep.sum())
        w_used = int(keep.any(dim=1).sum())
        nbytes = 4 * (terms + w_used + I * J)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * terms / FP32_OPS_PER_S * 1e3
        rows.append({
            "case": name, "Q": Q, "I": I, "J": J, "mode": mode,
            "terms": terms, "bytes": nbytes, "max_abs_err": err,
            "ms": graph_ms(kern), "plain_ms": graph_ms(plain),
            "call_ms": cuda_ms(kern, 200), "plain_call_ms": cuda_ms(plain, 20),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        emit({"phase": "kernel", **rows[-1]})
    return rows, next(r for r in rows if r["case"] == main_case)


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    from ccj_tpu_torch import fold
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.fold import (TRACEBACK_KEYS, build_consts,
                                           consts_from_numpy, fill6)
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.engine.traceback import Traceback
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    report = {}
    # ---- 1: card, build -------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    check(card, "nvidia-smi gave no card line")
    t0 = time.perf_counter()
    lib, log = cuda_ops.build_library(force=True)   # from the sources, always
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    report["build"] = {"seconds": build_s, "library": str(lib.relative_to(ROOT)),
                       "ptxas": ptxas, "card": card}
    emit({"phase": "build", **report["build"],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0)})

    # ---- 2: kernel vs plain ----------------------------------------------
    rows, main_row = phase_kernel(cuda_ops, bucket_dims)
    report["kernel"] = rows

    # ---- 3: corpus goldens -----------------------------------------------
    corpus = json.loads((ROOT / "tests" / "golden" / "corpus.json").read_text())
    report["corpus"] = []
    for n in (16, 37, 60):
        e = next(e for e in corpus if len(e["seq"]) == n and not e["args"])
        t0 = time.perf_counter()
        res = fold(e["seq"])
        wall = time.perf_counter() - t0
        check(res.structure == e["structure"] and abs(res.energy - e["energy"]) < 1e-9,
              f"n={n}: {res.structure} ({res.energy}) != {e['structure']} ({e['energy']})")
        report["corpus"].append({"n": n, "fold_s": wall, "energy": res.energy})
        emit({"phase": "corpus", **report["corpus"][-1]})

    # ---- 4: the main path at n=100 -----------------------------------------
    n = 100
    seq = bench_seq(n)
    expect = 13 * sum(max(s - 1, 0) for s in range(n))
    cuda_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    res = fold(seq)
    fold_s = time.perf_counter() - t0
    launches = cuda_ops.LAUNCHES
    check(launches > 0, "the main path launched minplus_window no time")
    check(launches == expect, f"launches {launches} != 13 per tt step ({expect})")

    sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                    / "rna_DirksPierce09.par"))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C, SC4 = consts_from_numpy(build_consts(tabs, sp, DEFAULT_PK), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fill6(C, SC4, n, sp.dangles)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    v = int(st["V"][1, n])
    check(v == BENCH_V100, f"V(1,{n}) = {v}, want {BENCH_V100}")
    t0 = time.perf_counter()
    mats = {k: st[k].cpu().numpy() for k in TRACEBACK_KEYS}
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_dcal, structure = Traceback(tabs, sp, DEFAULT_PK, mats).run()
    tb_s = time.perf_counter() - t0
    check((e_dcal, structure) == (res.energy_dcal, res.structure),
          "fill + traceback disagrees with fold()")
    report["n100"] = {"fold_s": fold_s, "fill_s": fill_s, "copy_s": copy_s,
                      "traceback_s": tb_s, "cells_per_s": cells4d(n) / fill_s,
                      "launches": launches, "V_1_n": v, "energy": res.energy,
                      "structure": res.structure}
    emit({"phase": "main_path_n100", **report["n100"]})
    del st, mats, C, SC4
    torch.cuda.empty_cache()

    # ---- 5: the n=126 reference anchor ------------------------------------
    seq, line = (ROOT / "tests" / "golden" / "long" / "seed42_n126.txt") \
        .read_text().splitlines()[:2]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fold(seq)
    fold_s = time.perf_counter() - t0
    got = f"{res.structure} ({res.energy:.2f})"
    check(got == line, f"n=126: {got!r} != {line!r}")
    report["n126"] = {"fold_s": fold_s,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "energy": res.energy}
    emit({"phase": "anchor_n126", **report["n126"]})

    kernels = [{
        "name": "minplus_window", "route": "cuda",
        "source": "ccj_tpu_torch/csrc/minplus.cu", "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "matches_plain": True, "shape": main_row["case"],
    }]
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
