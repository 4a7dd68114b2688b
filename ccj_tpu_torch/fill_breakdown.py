"""Where a fill's time goes on the GPU, for the dense and the packed engine
alike.

    python ccj_tpu_torch/fill_breakdown.py [--tree DIR] [--n 100] [--engine 6|7]
                                           [--profile-spans 50:52] [--sharded P]

(or ``python -m ccj_tpu_torch.fill_breakdown`` without ``--tree``).
``ccj_tpu_torch`` is imported from ``--tree`` (default: the checkout this
file lies in), so the same script splits an older commit unpacked beside
it, as ``walls.py`` does.  Fills the bench sequence of length n (seed 42,
as bench.py draws it) on one CUDA device with ``fold.fill6``
(``--engine 6``, the default) or ``fold.fill7`` (``--engine 7``, segments
``gapped5.segments7(n)``) and prints one JSON object, also written to
chiprun_out/fill_breakdown_n<n>_e<engine>[_<label>].json.  Every figure is
taken the same way for both engines, in this order:

* ``fill_s_first``, ``fill_s``: two plain fills in a row, each synchronised
  at its end only (the first also warms the allocator and caches);
  ``max_memory_allocated`` over the two;
* ``parts_s``: a third fill with a device synchronise around each span
  function, so each part's wall is summed apart (V, P split, WBP/WPP, the
  cross-span phase of the gapped step, its serial tt loop, WM/WMv/WMp),
  and the cross-span phase split in three: the l-shrink / i-shrink
  history scans (``SpanReads.history``, the span's 16 RL / RI scans in
  one ``history_min`` kernel, the weight tables' making excluded), the
  PL / PR interior-loop stencils
  (``gapped4.pl_stencil`` / ``pr_stencil``: one ``stencil_pl`` /
  ``stencil_pr`` kernel each over the layout's in-place window of int16
  views, the views' making included) and the rest, the plane reads,
  the assembly and the write-back (one ``span_assemble`` and one
  ``span_store`` a span, with the weight tables and the views);
* ``tt_loop_turns``: that fill and two more taken the same way, in turns:
  the tt loop as the fills run it (one ``tt_span`` a span), as the
  two-launch loop it replaced (``ttloop.run_tt_loop_steps``), and as the
  fills run it again; each one's synced wall and its tt loop's;
* ``tt_loop_split``: one more such fill with each ``tt_span`` call also
  synchronised before and after and timed by CUDA events: the tt loop's
  synced wall split into the kernel calls' walls (``tt_span_call_s``),
  their device time (``tt_span_device_s``) and the rest, the per-span
  table build (``wk_table`` / ``wj_table`` / ``jk_table``, the initial
  slabs, ``SpanTable``'s checks, ``ttloop._run_span``), as
  ``tables_s``;
* ``profile``: a fill stopped before span lo, then spans [lo, hi) run
  twice (re-running spans whose inputs are final rewrites the same
  values): once for the wall, once under torch.profiler.  Device kernel
  time over that wall is the device's busy share; the kernels and PyTorch
  ops that take the most device time and the port's own kernels
  (``tt_span``, ``history_min``, ``p_split``, ``stencil_pl`` /
  ``stencil_pr``, ``span_assemble`` / ``span_store``; ``minplus_group``
  and ``tt_step`` where anything runs them) are listed;
* ``host_views``: one more fill, not synchronised, with host clocks
  around the layout's view building outside the kernels' wrappers (the
  write-back's destinations, ``gapped4.dense_dests`` /
  ``gapped5.packed_dests``, and the plane reads' parts, ``SpanReads.parts``)
  and around the two span wrappers' calls (``span_assemble``,
  ``span_store``: their checks, table and launch, as enqueued) and the 2-D
  recurrences' (:data:`RECURRENCES`, as enqueued: the eager ops of a tree
  without their kernels, the wrappers' work of one with them); with
  ``--sharded P``, the same over a row-sharded fill of P shards on the one
  card (``dist.wavefront``), where ``_write_back`` builds the
  destinations (its time up to its ``store_span`` call) and the sharded
  reads the parts;
* ``eager_ops``: last, one more fill under a ``TorchDispatchMode`` that
  counts the non-view aten ops the host dispatches (on the card each is
  an eager call, most of them a launch), a span of the gapped step's
  cross-span phase: those outside the named kernels' wrappers
  (``history_min``, ``stencil_pl``, ``stencil_pr``, ``span_assemble``,
  ``span_store``, where the tree has them), those inside them, and the tt
  loop's (``run_tt_loop``, its table build); and the 2-D recurrences' by
  function (V, WBP/WPP with P's diagonal and the kept weight tables,
  WM/WMv/WMp), per span and in total.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the kernels whose wrappers' own ops eager_ops counts apart (a tree may lack some)
NAMED_KERNELS = ("history_min", "stencil_pl", "stencil_pr", "span_assemble", "span_store")
# the 2-D kernels' launch counts (a tree may lack them)
SPAN2D_COUNTS = ("SPAN_V_LAUNCHES", "SPAN_WBP_LAUNCHES", "SPAN_WM_LAUNCHES", "WX_LAUNCHES")
# the span body's 2-D recurrences eager_ops and host_views count by function,
# key -> its name in fold (WBP/WPP also writes P's diagonal and the kept
# weight tables' span-s cells)
RECURRENCES = {"V": "compute_V_span", "WBP/WPP": "compute_WBP_WPP_span",
               "WM/WMv/WMp": "compute_WMv_WMp_WM_span"}


def _timed(fn, acc, key):
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        return out
    return run


def _top(events):
    return [{"name": e.key[:80], "count": e.count,
             "device_s": e.self_device_time_total / 1e6}
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]]


def eager_ops(fold, gapped4, cuda_ops, run_fill, step, n):
    """One fill under a TorchDispatchMode counting the non-view aten ops the
    span body dispatches, by where they come from: in the gapped step
    (``step``: the fill's span step in ``fold``), inside a named kernel's
    wrapper (:data:`NAMED_KERNELS`), inside ``run_tt_loop`` (the tt loop's
    table build and its kernel's wrapper), or the rest of the cross-span
    phase (``outside``: views, plane reads, assembly and write-back); and
    the 2-D recurrences by function (:data:`RECURRENCES`: V, WBP/WPP with
    P's diagonal and the kept weight tables, WM/WMv/WMp), everything
    inside each counted.  Returns the totals and the per-span means over the
    fill's n spans."""
    from torch.utils._python_dispatch import TorchDispatchMode

    where = []                       # the innermost region of the current call
    counts = defaultdict(int)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if where and not func.is_view:
                counts[where[-1]] += 1
            return func(*args, **(kwargs or {}))

    def region(fn, name):
        def run(*a, **kw):
            where.append(name)
            try:
                return fn(*a, **kw)
            finally:
                where.pop()
        return run

    patches = [(fold, step, "outside"), (gapped4, "run_tt_loop", "tt_loop"),
               *((cuda_ops, k, k) for k in NAMED_KERNELS if hasattr(cuda_ops, k)),
               *((fold, k, key) for key, k in RECURRENCES.items())]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    try:
        for m, k, name in patches:
            setattr(m, k, region(getattr(m, k), name))
        with Count():
            run_fill()
        torch.cuda.synchronize()
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
    kernels = {k: counts[k] for k in NAMED_KERNELS if hasattr(cuda_ops, k)}
    recs = {k: counts[k] for k in RECURRENCES}
    return {"spans": n, "outside": counts["outside"], "in_kernel_wrappers": kernels,
            "tt_loop": counts["tt_loop"], "recurrences": recs,
            "per_span": {"outside": counts["outside"] / n,
                         "in_kernel_wrappers": sum(kernels.values()) / n,
                         "tt_loop": counts["tt_loop"] / n,
                         "recurrences": {k: v / n for k, v in recs.items()},
                         "recurrences_total": sum(recs.values()) / n}}


def host_views(run_fill, patches, spans):
    """``run_fill()`` once, each (module, name, key) of ``patches`` timed by
    the host clock (no synchronise: the host's own work and its enqueues);
    a name ending in ``_reads`` is a ``SpanReads`` builder, whose ``parts``
    is timed instead.  Returns the seconds by key, in total and a span."""
    acc, saved = defaultdict(float), []

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return run

    def reads(fn, key):
        def run(*a, **kw):
            r = fn(*a, **kw)
            return r._replace(parts=timed(r.parts, key))
        return run

    try:
        for m, name, key in patches:
            real = getattr(m, name)
            saved.append((m, name, real))
            setattr(m, name, (reads if name.endswith("_reads") else timed)(real, key))
        run_fill()
        torch.cuda.synchronize()
    finally:
        for m, name, real in saved:
            setattr(m, name, real)
    return {"spans": spans, "total_s": dict(acc),
            "per_span_ms": {k: v / spans * 1e3 for k, v in acc.items()}}


def write_back_views(wavefront, run_fill, spans):
    """A row-sharded fill with ``_write_back``'s time up to its
    ``store_span`` call (the shard's destination views and staging slabs)
    and the sharded reads' ``parts`` timed by the host clock."""
    acc, entered = defaultdict(float), []
    real_wb, real_store = wavefront._write_back, wavefront.store_span

    def write_back(*a, **kw):
        entered.append(time.perf_counter())
        return real_wb(*a, **kw)

    def store(*a, **kw):
        acc["write_back_dests"] += time.perf_counter() - entered.pop()
        return real_store(*a, **kw)

    wavefront._write_back, wavefront.store_span = write_back, store
    try:
        out = host_views(run_fill, [(wavefront, "sharded_reads", "sharded_parts"),
                                    (wavefront, "sharded_packed_reads", "sharded_parts")],
                         spans)
    finally:
        wavefront._write_back, wavefront.store_span = real_wb, real_store
    out["total_s"].update(acc)
    out["per_span_ms"].update({k: v / spans * 1e3 for k, v in acc.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--engine", type=int, choices=(6, 7), default=6)
    ap.add_argument("--profile-spans", default="50:52")
    ap.add_argument("--sharded", type=int, default=0,
                    help="also time a row-sharded fill's view building, P shards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    tree = Path(args.tree).resolve()
    loaded = sys.modules.get("ccj_tpu_torch")
    if loaded is not None and Path(loaded.__file__).resolve().parents[1] != tree:
        sys.exit(f"ccj_tpu_torch is already imported from {loaded.__file__}: run this "
                 "file as a script to split another tree")
    sys.path.insert(0, str(tree))
    from ccj_tpu_torch.engine import cuda_ops, fold, gapped4, gapped5, ttloop
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    n, packed = args.n, args.engine == 7
    rng = random.Random(42)
    seq = "".join(rng.choice("ACGU") for _ in range(n))
    sp = scale_parameters(parse_par(tree / "ccj_tpu_torch" / "params"
                                    / "rna_DirksPierce09.par"))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C, SC4 = fold.consts_from_numpy(fold.build_consts(tabs, sp, DEFAULT_PK), "cuda")
    dev = C["H"].device
    SEGS = gapped5.segments7(n)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"n": n, "engine": args.engine, "tree": str(tree), "label": args.label,
           "card": card, "kind": torch.cuda.get_device_name(0)}
    if packed:
        out["segments"] = len(SEGS)

    def run_fill():
        if packed:
            return fold.fill7(C, SC4, n, sp.dangles, SEGS)
        return fold.fill6(C, SC4, n, sp.dangles)

    def steps():
        return fold._packed_steps(SEGS) if packed else fold._dense_steps(n)

    # ---- plain fills ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    for key in ("fill_s_first", "fill_s"):
        torch.cuda.synchronize()
        cuda_ops.LAUNCHES = cuda_ops.WINDOWS = cuda_ops.TT_STEP_LAUNCHES = 0
        cuda_ops.TT_SPAN_LAUNCHES = cuda_ops.STENCIL_LAUNCHES = 0
        for k in ("ASSEMBLE_LAUNCHES", "STORE_LAUNCHES", *SPAN2D_COUNTS):
            if hasattr(cuda_ops, k):
                setattr(cuda_ops, k, 0)
        t0 = time.perf_counter()
        st = run_fill()
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        out["V_1_n"] = int(st["V"][1, n])
        del st
    out["launches"] = cuda_ops.TT_SPAN_LAUNCHES
    out["minplus_launches"] = cuda_ops.LAUNCHES
    out["tt_step_launches"] = cuda_ops.TT_STEP_LAUNCHES
    out["stencil_launches"] = cuda_ops.STENCIL_LAUNCHES
    out["assemble_launches"] = getattr(cuda_ops, "ASSEMBLE_LAUNCHES", None)
    out["store_launches"] = getattr(cuda_ops, "STORE_LAUNCHES", None)
    out["span2d_launches"] = {k: getattr(cuda_ops, k, None) for k in SPAN2D_COUNTS}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # ---- per-part walls: wrap the span functions where the fill and the
    # gapped step look them up, run one fill, restore.  The tt loop runs as
    # the fills run it (one tt_span a span), then, in turns, as the
    # two-launch loop it replaced (ttloop.run_tt_loop_steps) ----------------
    step = "span_gapped7" if packed else "span_gapped4"

    def parts(loop, split=False):
        acc = defaultdict(float)
        names = {"compute_V_span": fold, "p_split_minima": fold,
                 "compute_WBP_WPP_span": fold, step: fold,
                 "compute_WMv_WMp_WM_span": fold, "run_tt_loop": gapped4,
                 "pl_stencil": gapped4, "pr_stencil": gapped4}
        saved = {k: getattr(m, k) for k, m in names.items()}
        real_span, events = cuda_ops.tt_span, []
        real_families = gapped4.span_families

        def families(C, SC4, st, s, TB, IB, reads, i0=0):
            reads = reads._replace(history=_timed(reads.history, acc, "history"))
            return real_families(C, SC4, st, s, TB, IB, reads, i0)

        def span_split(table, plan=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            real_span(table, plan)
            b.record()
            b.synchronize()
            acc["tt_span_call_s"] += time.perf_counter() - t0
            events.append((a, b))

        try:
            for k, m in names.items():
                setattr(m, k, _timed(loop if k == "run_tt_loop" else saved[k], acc, k))
            gapped4.span_families = gapped5.span_families = families
            if split:
                cuda_ops.tt_span = span_split
            t0 = time.perf_counter()
            run_fill()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for k, m in names.items():
                setattr(m, k, saved[k])
            cuda_ops.tt_span = real_span
            gapped4.span_families = gapped5.span_families = real_families
        cross = acc.pop(step) - acc["run_tt_loop"]
        acc[f"{step} (cross-span phase)"] = cross
        acc["cross: history scans (RL/RI)"] = acc.pop("history")
        acc["cross: PL/PR stencils"] = acc.pop("pl_stencil") + acc.pop("pr_stencil")
        acc["cross: plane reads + assembly"] = (
            cross - acc["cross: history scans (RL/RI)"] - acc["cross: PL/PR stencils"])
        if split:
            acc["tt_span_device_s"] = sum(a.elapsed_time(b) for a, b in events) / 1e3
            acc["tables_s"] = acc["run_tt_loop"] - acc["tt_span_call_s"]
            acc["tt_span_launches"] = len(events)
        return wall, dict(sorted(acc.items(), key=lambda kv: -kv[1]))

    turns = []
    for name, loop in (("tt_span", gapped4.run_tt_loop),
                       ("two-launch", ttloop.run_tt_loop_steps),
                       ("tt_span", gapped4.run_tt_loop)):
        wall, acc = parts(loop)
        if not turns:
            out["fill_synced_s"], out["parts_s"] = wall, acc
        turns.append({"loop": name, "fill_synced_s": wall, "tt_loop_s": acc["run_tt_loop"]})
    out["tt_loop_turns"] = turns
    wall, acc = parts(gapped4.run_tt_loop, split=True)
    out["tt_loop_split"] = {"fill_synced_s": wall, **{k: acc[k] for k in (
        "run_tt_loop", "tt_span_call_s", "tt_span_device_s", "tables_s", "tt_span_launches")}}

    # ---- device busy share over spans [lo, hi) of a fill stopped at lo ----
    # (the span loop runs batches: this fill is a batch of one)
    lo, hi = (int(x) for x in args.profile_spans.split(":"))
    Cb, SC4b = fold.add_batch(C), fold.add_batch(SC4)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():      # the fills' state is inference tensors
        if packed:
            st = fold.init_state_2d(n, dev)
            st.update(gapped5.init_big_state7(n, SEGS, dev))
        else:
            st = fold._init_dense(n, dev)
        for _ in fold._run_spans(Cb, SC4b, n, sp.dangles, st,
                                 (x for x in steps() if x[0] < lo)):
            pass

    def window():
        with torch.inference_mode():
            for _ in fold._run_spans(Cb, SC4b, n, sp.dangles, st,
                                     (x for x in steps() if lo <= x[0] < hi)):
                pass
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    wall = time.perf_counter() - t0           # the window without the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    del st
    # Device kernels are the CUDA-typed entries; a CPU op's entry repeats
    # the device time of the kernels it launched (as the profiler's own
    # table totals it), so it names where that time came from instead.
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    out["profile"] = {
        "spans": [lo, hi], "wall_s": wall,
        "device_busy_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall,
        "top_kernels": _top(kernels),
        "top_ops": _top(ops),
        # the port's own kernels (csrc/), wherever they rank
        "port_kernels": _top([e for e in kernels
                              if any(k in e.key for k in ("minplus", "tt_step", "tt_span",
                                                          "history", "p_split",
                                                          "stencil", "assemble",
                                                          "store", "span_v", "span_wbp",
                                                          "span_wm", "wx_kernel"))]),
    }
    out["host_views"] = host_views(run_fill, [
        (gapped5, "packed_dests", "dests") if packed else (gapped4, "dense_dests", "dests"),
        (gapped5, "packed_reads", "parts") if packed else (gapped4, "dense_reads", "parts"),
        (cuda_ops, "span_assemble", "span_assemble_call"),
        (cuda_ops, "span_store", "span_store_call"),
        *((fold, k, f"{key}_call") for key, k in RECURRENCES.items())], n)
    if args.sharded:
        from ccj_tpu_torch.dist import wavefront

        devs = ["cuda:0"] * args.sharded
        out["host_views_sharded"] = {"shards": args.sharded, **write_back_views(
            wavefront, lambda: (wavefront.fill7_sharded(C, SC4, n, sp.dangles, SEGS, devs)
                                if packed else
                                wavefront.fill6_sharded(C, SC4, n, sp.dangles, devs)), n)}
    out["eager_ops"] = eager_ops(fold, gapped4, cuda_ops, run_fill, step, n)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    tag = f"_{args.label}" if args.label else ""
    (dest / f"fill_breakdown_n{n}_e{args.engine}{tag}.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
