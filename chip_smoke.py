#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``ccj_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. the card's name and power limit; build the CUDA kernel library from
   ``ccj_tpu_torch/csrc/`` (the seventeen kernels, one ``nvcc`` per
   source, the ten sources run together) and report the build time;
2. the min-plus kernel against its plain PyTorch version on the card,
   exactly (tolerance zero: integer data): single windows
   (``minplus_window``, a group of one) in all three mask modes, at the CPU
   tests' shapes and at the main path's largest shapes for n=100 and
   n=128; then the full 13-window group of the main n=100 and n=128 tt
   steps (``minplus_group``) and of the packed fill's largest step at
   n=200 (segment 3: span 135, TB 134, IB 100), whose descriptor table
   comes from the tt loop's own ``ttloop.reduction_table`` on random slabs,
   checked at tt = 0, the main step and s - 2; then the same group with a
   leading batch axis, one launch for the whole batch, at the batched
   fills' main steps (n=100 for B=4, bucket 64 for B=8; their bound is B
   times one element's); then the group of a row shard's step (n=100,
   shard 1 of 4: 26 rows from i0 = 26, the row offset in its masks), and
   of a packed row shard's (n=200, segment 3's widest step on a shard
   with a row offset: P=4, shard 1, 48 rows from i0 = 51 at span 102).
   Each row has the kernel's, the plain version's and the byte bound's
   time (no single PyTorch call computes this function, so there is no
   library yardstick).  ``ms`` / ``plain_ms``
   are device times per call (CUDA-graph replay, inputs L2-hot);
   ``call_ms`` / ``plain_call_ms`` are eager calls back to back, the
   host's launch path included.  A group row's bound counts each slab and
   weight element the group needs once, and the row adds ``ms_l2cold``:
   graph replay cycling through copies of the operands that together
   overflow L2, so the reads come from HBM as the bound assumes; it also
   gives its times per window; then (2b) ``tt_step``, the rest of the tt
   step, against its plain version (``tt_step_ref``) exactly, on random
   operands at the same seven steps (dense n=100 and n=128, packed n=200,
   batched 100 x 4 and 64 x 8, the dense and the packed row shard) and at
   the n=100 fill's step with the most stencil terms (span 69, tt 0), each at
   tt = s - 2, the main step and 0 with every slab compared after each:
   L2-hot (graph replay) and L2-cold (a 100 MB buffer zeroed before each
   call, the call between CUDA events) device times, eager call times, the
   plain version's, and the byte bound (every element the step needs read
   once, the STM and DPM elements its admissible stencil terms use counted
   once; no library yardstick); then (2c) ``tt_span``, a span's whole tt
   loop in one launch (the kernel every fill runs), against its plain
   version ``tt_span_ref`` and the two-launch loop it replaces
   (``tt_span_steps``: ``minplus_group`` + ``tt_step`` a step) exactly, on
   random operands under the fills' contract (the family slabs SAT16 on the
   span's valid cells, INF elsewhere) at the n=100 main span (37), n=128's
   (65), the packed n=200 one (135), a row shard (n=100, 26 rows from i0 =
   26) and the n=100 fill's heaviest span (69), at the kernel's own plan
   and every plan of :data:`SPAN_PLANS` (blocks a row, threads, weights
   staged or not, half the band's rows in device memory): L2-hot, L2-cold
   and eager times, at 1, 2 and 4 blocks a row, with the weights staged and
   through __ldg, the empty steps' time (every phase left out, through the
   timing-only ``tt_span_phases``), the live rows, the valid cells, the
   kernel's add-min terms against the needed ones (and those of a kernel
   over the whole grid, :func:`span_terms`), the two-launch loop's device
   (graph) and eager times on the same operands, the plain version's, and two bounds:
   the span's loop as one function (:func:`span_bound`) and, the two-launch
   loop's yardstick, the sum over the span's steps of the two kernels'
   bounds (:func:`two_kernel_bound`); then (2d) ``history_min`` (all the
   gapped step's RL / RI history scans of a span in one launch, its
   weights computed in the kernel) and ``p_split`` (the P split) against
   their plain versions exactly, at the fills' own launches on a random
   state (:func:`history_psplit_cases`: the n=100 main span, n=128's, the
   packed n=200 span 135 over all four prior segments, bucket 100 x 4, a
   dense row shard of 26 rows from i0 = 26 and a packed one of 48 rows
   from i0 = 51, a row shard's RL and RI launches apart), each with its
   L2-hot and L2-cold device times, the fills' eager call's, the plain
   version's on the card and its byte bound (:func:`history_bound`,
   :func:`psplit_bound`; no library yardstick);
   then (2e) ``stencil_pl`` and ``stencil_pr`` (the PL / PR interior-loop
   stencils, read in place from the state) against their plain versions
   exactly, at the fills' own calls on a random PL / PR state with the
   bench sequence's stencil weights (:func:`stencil_cases`: the n=100 main
   span, n=128's, the packed n=200 span 135 and span 110, whose window
   straddles two segments, bucket 100 x 4, a dense row shard of 26 rows
   from i0 = 26 and a packed one of 48 rows from i0 = 51, a batch of two
   sequences' weights, the n=100 span 8 and the odd-n2 n=37 span 20), each
   with its L2-hot and L2-cold device times, the fills' eager call's, the
   terms its warps walk, the plain version's on the card and its bound
   (:func:`stencil_bound`: the admissible terms at one int32 add-min a
   lane and cycle against the bytes they need; no library yardstick);
   then (2f) ``span_assemble`` (the span's plane reads, in place, and its
   PL / PR / PO assembly) and ``span_store`` (its write-back into the
   layout's slots) against their plain versions exactly, at the fills'
   own calls on a random state (:func:`span_cases`: the n=100 main span,
   n=128's, the packed n=200 spans 135 and 103, bucket 100 x 4, a dense
   and a packed row shard, the odd-n2 n=37 span 20), each with its
   L2-hot and L2-cold device times, the eager call's, the plain version's
   on the card, its byte bound (:func:`assemble_bound`,
   :func:`store_bound`; no library yardstick) and its ``ptxas`` report;
   then (2g) ``span_v``, ``span_wbp``, ``span_wm`` and ``wx_tables`` (the
   span's 2-D recurrences and the gapped step's weight tables) against
   their plain versions exactly on random 2-D states with INF, TRI_UNSET
   and V_UNSET cells (:func:`span2d_cases`: the n=100 main span, n=128's,
   n=200 span 135, bucket 100 x 4, dangles 0 and 1 at n=100, the odd-n2
   n=37 span 20; ``span_wbp`` also as the fills call it, with P-split
   minima and the kept weight tables), the whole 2-D state after each,
   each with its L2-hot
   and L2-cold device times, the eager call's, the plain version's on
   the card, its byte bound (:func:`span2d_bound`, well under a
   microsecond: these kernels are launch- and host-bound) and its
   ``ptxas`` report; at each shape ``span_wm`` right after a
   ``span_store`` (the n=100 main span's, as a fill's step ends), launched
   as its programmatic dependent and plainly, the device time of each pair
   (:func:`span2d_store_pair`: a timing of the overlap; the two share no
   memory, so the fills' results in phases 4-10 are what hold the
   dependent launch's condition); then the kept weight tables
   of the n=100 fill, the packed n=134 fill and a P=2 row-sharded fill
   against a from-scratch ``wx_tables`` after every span
   (:func:`kept_tables_check`);
3. fold the corpus entries at n=16, 37 and 60 (default arguments) and
   compare with ``tests/golden/corpus.json``;
4. the main path: ``ccj_tpu_torch.fold`` of the n=100 bench sequence
   (bench.py, seed 42; the lazy traceback, the default on CUDA) with the
   kernels' launch counts reset just before and read just after: one
   ``tt_span`` per span with a tt step (98), one ``history_min`` a span
   s >= 1 (all 16 RL / RI scans, 99), one ``p_split`` per span with a term (97),
   one ``stencil_pl`` and one ``stencil_pr`` per span with a tt step (98
   each, ``STENCIL_LAUNCHES`` 196), one ``span_assemble``, one
   ``span_store`` and one ``span_wbp`` a span (100 each), one ``span_v`` a
   span s >= 1 (99), one ``span_wm`` a span s >= 3 (97), one
   ``wx_tables`` a fill (1: the weight tables kept by ``span_wbp``), no
   ``minplus_group`` and no ``tt_step``; every later path (the
   checkpoint's resumed fill too) is checked the
   same way (:func:`fill_counts`; per span and row shard with a span-s
   row, :func:`sharded_counts`); then
   the fill alone (V(1, 100) must be -1528, bench.py's golden) and, on
   that one fill, the lazy traceback (``LazyMats`` + ``Traceback.run``,
   with its bytes and slabs fetched) against the eager host copy plus
   traceback, each timed apart and each giving ``fold``'s structure and
   energy; cells/s as bench.py counts them; then (4b) the packed ``fill7``
   of the same sequence (4 segments) against that dense state, bit for bit
   on every array (each ``name@g`` against the dense family's segment
   extents, each ``C_name@g`` row by row, PKD, PKE, the 2-D matrices),
   with both fill walls; then (4c) ``dist.batch.batched_fill6`` of four
   sequences at bucket 100 (lengths 100, 97, 90, 83; the first the bench
   sequence) in one span loop: 98 launches for the whole batch, element
   0 bit-equal to 4's fill, elements 1-3 to the fill inside their own
   ``fold``, each element's ``LazyMats`` traceback equal to ``fold``; its
   wall against 4's single fill and its peak memory; then (4d) ``dist.wavefront.fill6_sharded`` of the same sequence with
   P=2 and P=4 row shards on cuda:0: launches one per span and shard
   with a span-s row (``sharded_tt_spans``), every array of ``gather()``
   bit-equal to 4's fill, ``LazyMats`` over the sharded state giving
   ``fold``'s structure and energy; the wall against 4's fill, the peak
   memory, the state bytes per shard and the bytes exchanged per class
   (halo, shift, gather, all-gather), in total and at the widest span;
5. fold the reference anchors ``tests/golden/long/seed42_n{126,134,200}.txt``
   (n=126: dense at the bucket of 128; n=134, the first length past
   ``DENSE_MAX_N``, and n=200: the packed fill, 5 and 6 segments; all
   through the lazy traceback) and match structure and energy byte for
   byte; each one's launches (one per span: 126, 132 and 198),
   fold and fill walls, peak device memory, bytes and slabs fetched; at
   n=200 cells/s beside the reference binary's 1467.2 s; then (5b) the
   n=126 anchor filled by ``fill6_sharded`` with P=2 at the bucket of 128
   and traced back through ``LazyMats`` over the sharded state, byte for
   byte, its wall against the n=126 fold's fill; then (5c,
   ``wavefront_packed``) ``fill7_sharded`` on cuda:0: the n=134 anchor
   with P=2 and P=4, every array bit-equal to its ``fill7`` state (filled
   in the phase, one array at a time) and the anchor byte for byte through
   ``LazyMats(.., segs)``; the n=200 anchor with P=2, byte for byte (no
   whole-state comparison: two copies come too close to 80 GB); each with
   4d's figures (launches against ``sharded_tt_spans``; the wall against
   the unsharded fill's; peak above what was
   held; bytes per shard and exchanged per class; the traceback's bytes
   between shards);
6. ``fold_many`` of the corpus entries at n=37, 60 and 16 in one call
   (buckets 48, 64 and 16, in that order), each checked against
   ``tests/golden/corpus.json``, with its own launch count;
7. the CLI in a subprocess, ``python -m ccj_tpu_torch.cli`` on the n=37
   crossing-band anchor; its second line must be the reference's;
8. checkpoint / resume at n=48: ``fill4`` with a snapshot every 16 spans,
   interrupted from ``on_span`` at span 20, then resumed; the resumed state
   equals an uninterrupted ``fill6`` on every array and the snapshot is
   gone; the snapshot's bytes and its save and load walls;
9. ``batched_fill6`` of eight seed-made sequences of lengths 49-64 at
   bucket 64: 62 launches, every element bit-equal on every array to its
   own ``fill6``; the batched wall against the eight single walls (tables
   built inside both) and the peak memory; then (9b) ``fold_many`` of those
   eight and phase 4c's four bucket-100 sequences with ``batch_limit=1``
   and with the default (fill k+1 before traceback k), in turns 1,
   default, default, 1: equal results, both walls and peaks;
10. ``python -m ccj_tpu_torch.dist.corpus`` over the 15 default-argument
   entries of ``tests/golden/corpus.json``: two processes merging through a
   loopback ``TCPStore`` (one per card where there are two, else both on
   cuda:0), then one process alone; both outputs equal the goldens in order
   with no ``error``; each process's wall, fold wall and the tt-loop
   kernels' launches (the CLI prints them);
11. the partition function and its seven span kernels
   (``engine/pf_ops.py``; ``csrc/pfspan.cu``: ``pf_tt_span``,
   ``pf_history``, ``pf_stencil``, ``pf_p_split``; ``csrc/pfbody.cu``:
   ``pf_span2d``, ``pf_assemble``, ``pf_store``) against their plain
   versions on the card, on the n=64 fill's own operands at spans 20, 40
   and 62 (``pf_span2d`` and ``pf_store`` also 0 and 1) in float32 and
   float64 (:func:`pf_kernel_calls`, :func:`pf_pair`; relative error
   within 2e-6, 1e-5 for the three of ``pfbody.cu``, / 1e-13), each with
   its L2-hot and L2-cold device times, its eager call's, the plain
   version's eager call's and its bound (:func:`pf_bound`: the distinct
   elements it needs against its multiply-adds at the float32 / float64
   rate; no library yardstick);
   the float64 fill on the card against the host float64 engine at n=16
   (rtol 1e-9) and against the CPU's fill (the plain versions) at n=40
   (rtol 1e-9); the n=64 float32 and float64 fills' walls, peak device
   memory and parts timed inside the same run (constants, span loop,
   copy-out, exterior W: :func:`pf_fill_split`), float32's Z against
   float64's (within 1e-5); the float64 fill of the n=100 bench
   sequence, its wall, parts and peak, a finite Z and an ensemble energy
   at or below the MFE; the n=64 float32 fill's device launches
   (kernels, copies and memsets; at most :data:`PF_DEVICE_OPS_CEILING`),
   their summed device time and each PF kernel's from a profiler run
   apart, beside the all-eager fill's 797,597 launches and 2.77 s (an
   earlier run's, under a key of their own); ``partition`` at n=64 with
   1000 samples end to end, its PF launches reset just before and held
   to :func:`pf_counts` (62 / 62 / 62 / 61 / 64 / 62 / 64) after, its
   ensemble energy at or below the MFE; it launches no MFE kernel
   (checked);
12. the device's busy share of the batched fills: spans 40-41 of phase
   9's batch (a batched fill stopped at span 40) and spans 70-71 of phase
   4c's (the window PERF.md gives for the single n=100 fill), their
   kernels', copies' and memsets' device time under the profiler over
   their wall without it.
   The phases that use the profiler (11 and 12) run last: once it has
   run, the process's later dispatch is slower (a bucket-64 fill, 30-40 %
   in one call), which would spoil the walls of any phase after them.

Prints one JSON line per phase, the kernels line, the card line, and last
``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50e6             # H100 SXM L2 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor-core float32 peak; int32
#                             add/min have no tensor-core form and run no
#                             faster, so ops / this rate is a floor
BENCH_V100 = -1528          # bench.py BENCH_V[100]
REF_SECONDS_200 = 1467.2    # bench.py REF_SECONDS[200]: the reference binary
#                             at n=200 on one CPU core (BASELINE.md)
REPLACES = "ccj_tpu/engine/pallas_ops.py:38"
STEP_REPLACES = "ccj_tpu/engine/ttloop.py:436"   # an XLA fusion, no Pallas kernel
CLI_SEQ = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
CLI_LINE = "(((([[[...[[[[[[[))))....]]]]]]].]]]. (-9.94)"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase line also gets the seconds since the
    script started, so the lines give the run's timeline."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def bench_seq(n, seed=42):
    rng = random.Random(seed)
    return "".join(rng.choice("ACGU") for _ in range(n))


def cells4d(n):
    return 22 * n * (n + 1) * (n + 2) * (n + 3) // 24


def tt_spans(n_fill):
    """Spans with a tt step (one ``tt_span`` launch each) of a fill of
    length n_fill (dense or packed)."""
    return sum(1 for s in range(n_fill) if s >= 2)


def reset_counts(cuda_ops):
    """Set every kernel's launch count to 0, just before a path is driven."""
    cuda_ops.LAUNCHES = cuda_ops.WINDOWS = cuda_ops.TT_STEP_LAUNCHES = 0
    cuda_ops.TT_SPAN_LAUNCHES = cuda_ops.HISTORY_LAUNCHES = cuda_ops.PSPLIT_LAUNCHES = 0
    cuda_ops.STENCIL_LAUNCHES = cuda_ops.STENCIL_PL_LAUNCHES = cuda_ops.STENCIL_PR_LAUNCHES = 0
    cuda_ops.ASSEMBLE_LAUNCHES = cuda_ops.STORE_LAUNCHES = 0
    cuda_ops.SPAN_V_LAUNCHES = cuda_ops.SPAN_WBP_LAUNCHES = cuda_ops.SPAN_WM_LAUNCHES = 0
    cuda_ops.WX_LAUNCHES = 0


def span_launches(spans):
    """The launches of an unsharded fill's spans ``spans`` (dense or
    packed; a batch counts once; every span s <= n - 1 has a live row),
    one count each of :data:`FILL_KERNELS`.  Every span with a tt step
    (s >= 2) launches one ``tt_span``, one ``stencil_pl`` and one
    ``stencil_pr`` (spans 0 and 1 have no valid cell), every span s >= 1
    one ``history_min`` (all 16 RL / RI scans; the packed layout's prior
    segments in the same launch), every span with a term (s >= 3) one
    ``p_split``, every span one ``span_assemble``, one ``span_store`` and
    one ``span_wbp`` (which writes P's diagonal and the kept weight
    tables' span-s cells); every span s >= 1 one ``span_v`` (span 0's
    cells j = i are never written) and every span s >= 3 one ``span_wm``
    (no cell of a shorter span is written); one ``wx_tables`` a run of the
    span loop (the weight tables, made once and kept)."""
    out = [0] * len(FILL_KERNELS)
    for s in spans:
        for k, on in enumerate((s >= 2, s >= 1, s >= 3, s >= 2, s >= 2, True, True,
                                s >= 1, True, s >= 3, False)):
            out[k] += on
    out[-1] = 1 if out[5] else 0
    return tuple(out)


def fill_counts(*lengths):
    """:func:`span_launches` of whole fills of these lengths."""
    return tuple(map(sum, zip(*(span_launches(range(m)) for m in lengths))))


# launches of each path's fills since :func:`reset_counts`, by path: one
# count each of FILL_KERNELS, filled in by :func:`loop_launches`
PATH_COUNTS = {}
FILL_KERNELS = ("tt_span", "history_min", "p_split", "stencil_pl", "stencil_pr",
                "span_assemble", "span_store", "span_v", "span_wbp", "span_wm", "wx_tables")


def loop_launches(cuda_ops, want, what):
    """The fill kernels' launches since :func:`reset_counts`, checked
    against ``want`` (one count each of :data:`FILL_KERNELS`; see
    :func:`fill_counts`, :func:`sharded_counts`), ``STENCIL_LAUNCHES``
    against the two stencils' sum; ``minplus_group`` and ``tt_step`` never
    (no fill runs the step-by-step loop).  Records them in
    :data:`PATH_COUNTS` and returns ``tt_span``'s count."""
    got = (cuda_ops.TT_SPAN_LAUNCHES, cuda_ops.HISTORY_LAUNCHES, cuda_ops.PSPLIT_LAUNCHES,
           cuda_ops.STENCIL_PL_LAUNCHES, cuda_ops.STENCIL_PR_LAUNCHES,
           cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES,
           cuda_ops.SPAN_V_LAUNCHES, cuda_ops.SPAN_WBP_LAUNCHES, cuda_ops.SPAN_WM_LAUNCHES,
           cuda_ops.WX_LAUNCHES, cuda_ops.LAUNCHES, cuda_ops.TT_STEP_LAUNCHES)
    check(got == (*want, 0, 0), f"{what}: {' / '.join(FILL_KERNELS)} / minplus_group / "
          f"tt_step launches {got} != {(*want, 0, 0)}")
    check(cuda_ops.STENCIL_LAUNCHES == want[3] + want[4],
          f"{what}: STENCIL_LAUNCHES {cuda_ops.STENCIL_LAUNCHES} != {want[3] + want[4]}")
    PATH_COUNTS[what] = tuple(want)
    return want[0]


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
    path is out of the timing.  Inputs that ``fn`` reuses stay in L2
    across calls."""
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


def graph_cold_ms(fn, reps=20, replays=3):
    """Device time of one call with L2 cold: ``reps`` calls, each after a
    buffer of twice the L2 is zeroed, captured in one CUDA graph and
    replayed between CUDA events, less the same graph of the zeroings
    alone.  Unlike :func:`flushed_ms` the host's work (a wrapper's checks
    and launch) is out of the timing."""
    buf = torch.empty(int(2 * L2_BYTES) // 4, dtype=torch.int32, device="cuda")

    def calls():
        for _ in range(reps):
            buf.zero_()
            fn()

    def flushes():
        for _ in range(reps):
            buf.zero_()

    return (graph_ms(calls, reps=1, replays=replays)
            - graph_ms(flushes, reps=1, replays=replays)) / reps


def rand_i32(shape, gen, dev):
    """INF-encoded int32 test data, made on the host from ``gen``."""
    from ccj_tpu_torch.engine.common import INF

    x = torch.randint(-30000, 32767, shape, generator=gen, dtype=torch.int32)
    x[torch.rand(shape, generator=gen) < 0.3] = INF
    return x.to(dev)


def admissible(Q, I, J, q_lo, mode, c, dev):
    """[Q, I, J] bool: the (q, i, j) terms one window's mask admits."""
    q = torch.arange(Q, device=dev)[:, None, None]
    i = torch.arange(I, device=dev)[None, :, None]
    j = torch.arange(J, device=dev)[None, None, :]
    keep = (q >= q_lo) & (i >= 0) & (j >= 0)
    if mode == 1:
        keep &= q <= c - j + i
    elif mode == 2:
        keep &= q <= j - i - c
    return keep


def bound(Q, I, J, q_lo, mode, c, dev):
    """The least time of one window on this card: the bytes its data needs
    (admissible (q, i, j) slab terms, the weights they use, the output)
    over the memory rate, against its adds and mins over the float32
    rate.  Returns (terms, bytes, t_bytes ms, t_ops ms)."""
    keep = admissible(Q, I, J, q_lo, mode, c, dev)
    terms = int(keep.sum())
    w_used = int(keep.any(dim=1).sum())
    nbytes = 4 * (terms + w_used + I * J)
    return (terms, nbytes, nbytes / HBM_BYTES_PER_S * 1e3,
            2 * terms / FP32_OPS_PER_S * 1e3)


def group_bound(table, tt, dev):
    """:func:`bound` of a whole group at ``tt``: each slab and weight
    element that some window's admissible terms use is counted once,
    however many windows read it (the union over each tensor), plus every
    window's output; a batched table counts every element of its batch (B
    times one element's bound).  Returns (terms, bytes, t_bytes ms,
    t_ops ms)."""
    Q, I, J = table.Q, table.I, table.J
    B = table.batch or 1
    need = {}                   # (data_ptr, shape, strides) -> bool mask
    terms = 0

    def mask_of(x):
        key = (x.data_ptr(), tuple(x.shape), x.stride())
        return need.setdefault(key, torch.zeros(x.shape, dtype=torch.bool, device=dev))

    for win in table.windows:
        row0, col0, wcol, c = win.at(tt)
        keep = admissible(Q, I, J, win.q_lo, win.mode, c, dev)
        terms += B * int(keep.sum())
        mask_of(win.slab)[..., row0:row0 + Q, :, col0:col0 + J] |= keep
        mask_of(win.w)[..., :, wcol:wcol + J] |= keep.any(dim=1)
    nbytes = 4 * (sum(int(m.sum()) for m in need.values())
                  + B * len(table.windows) * I * J)
    return (terms, nbytes, nbytes / HBM_BYTES_PER_S * 1e3,
            2 * terms / FP32_OPS_PER_S * 1e3)


def main_span(n, bucket_dims):
    """The span whose window TB x IB x n2 is largest on length n, its
    (TB, IB) and its middle tt step."""
    s = max(range(2, n), key=lambda s: (bucket_dims(n, s)[0]
                                        * bucket_dims(n, s)[1], s))
    TB, IB = bucket_dims(n, s)
    return s, TB, IB, (s - 2) // 2


def packed_main_span(n, segments7):
    """The packed fill's largest tt step on length n: the last span of the
    segment whose slabs [2TB+2, IB, n2+TB] are largest, its (TB, IB), its
    middle tt step and the segment's index."""
    segs = segments7(n)
    g = max(range(len(segs)), key=lambda g: segs[g][2] * segs[g][3] * (n + 2 + segs[g][2]))
    lo, hi, TB, IB, _ = segs[g]
    s = hi - 1
    return s, TB, IB, (s - 2) // 2, g


def phase_kernel(cuda_ops, bucket_dims, dev):
    """Phase 2: kernel vs plain version; returns (rows, main-path row)."""
    from ccj_tpu_torch.engine.common import INF
    from ccj_tpu_torch.engine.ttloop import REDUCTIONS, reduction_table

    gen = torch.Generator().manual_seed(0)
    cases = []
    for T, I, J in ((7, 5, 9), (16, 8, 128), (23, 13, 150)):
        for lo in (-1, 0, 5):
            slab, w = rand_i32((T, I, J), gen, dev), rand_i32((T, J), gen, dev)
            cases.append((f"suffix {T}x{I}x{J} lo={lo}", slab, w,
                          (0, 0, max(lo + 1, 0), 0, 0)))
    for n in (100, 128):
        n2 = n + 2
        s, TB, IB, tt = main_span(n, bucket_dims)
        slab = rand_i32((2 * TB + 2, IB, n2), gen, dev)
        wk = rand_i32((TB, n2 + TB + 1), gen, dev)[:, tt + 2: tt + 2 + n2]
        slabB = rand_i32((2 * TB + 2, IB, n2 + TB), gen, dev)
        wj = rand_i32((TB, n2), gen, dev)
        tag = f"n={n} s={s} tt={tt} TB={TB} IB={IB}"
        cases += [(f"red_k mode0 {tag}", slab, wk, (tt + 1, 0, 0, 0, 0)),
                  (f"red_k mode1 {tag}", slab, wk, (tt + 1, 0, 0, 1, s - 4 - tt)),
                  (f"red_j mode0 {tag}", slabB, wj, (tt + 1, tt, 0, 0, 2)),
                  (f"red_j mode2 {tag}", slabB, wj, (tt + 1, tt, 0, 2, 2))]

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
        Q, J = w.shape
        terms, nbytes, t_bytes, t_ops = bound(Q, slab.shape[1], J, q_lo, mode, c, dev)
        rows.append({
            "case": name, "Q": Q, "I": slab.shape[1], "J": J, "mode": mode,
            "terms": terms, "bytes": nbytes, "max_abs_err": err,
            "ms": graph_ms(kern), "plain_ms": graph_ms(plain),
            "call_ms": cuda_ms(kern, 200), "plain_call_ms": cuda_ms(plain, 20),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        emit({"phase": "kernel", **rows[-1]})

    # the full 13-window group of the main tt steps, one launch each: the
    # dense fill's at n=100 and n=128, the packed fill's at n=200; then the
    # batched groups of the batched fills' main steps (n=100 for a batch of
    # 4, bucket 64 for a batch of 8), one launch for the whole batch
    from ccj_tpu_torch.engine.gapped5 import segments7

    group_cases = [(n, *main_span(n, bucket_dims), "", None) for n in (100, 128)]
    s, TB, IB, tt, g = packed_main_span(200, segments7)
    group_cases.append((200, s, TB, IB, tt, f" packed segment {g}", None))
    group_cases += [(n, *main_span(n, bucket_dims), f" batch of {B}", B)
                    for n, B in ((100, 4), (64, 8))]
    main_row = packed_row = None
    batched_rows = []
    for n, s, TB, IB, tt, label, B in group_cases:
        row = group_row(cuda_ops, REDUCTIONS, reduction_table, INF, gen, dev,
                        n, s, TB, IB, tt, label, B)
        rows.append(row)
        emit({"phase": "kernel", **row})
        if n == 100 and B is None:
            main_row = row
        if B is not None:
            batched_rows.append(row)
        elif label:
            packed_row = row
    # a row shard's step (dist/wavefront.py): shard 1 of 4 at n=100's main
    # span, IB = R = 26 rows from i0 = 26, which the masks' c absorbs
    s, TB, _, tt = main_span(100, bucket_dims)
    R = -(-102 // 4)
    shard_row = group_row(cuda_ops, REDUCTIONS, reduction_table, INF, gen, dev,
                          100, s, TB, R, tt, f" row shard 1 of 4, i0={R}", i0=R)
    rows.append(shard_row)
    emit({"phase": "kernel", **shard_row})
    # a packed row shard's step (fill7_sharded): the widest step of n=200's
    # segment 3 on a shard with a row offset, which at P=2 has none there
    # (R = 101 > n - s), so P=4
    s, TB, IB, tt, p, i0 = widest_packed_shard_step(200, 4, 3, segments7)
    packed_shard_row = group_row(
        cuda_ops, REDUCTIONS, reduction_table, INF, gen, dev, 200, s, TB, IB, tt,
        f" packed segment 3, row shard {p} of 4, i0={i0}", i0=i0)
    rows.append(packed_shard_row)
    emit({"phase": "kernel", **packed_shard_row})
    return rows, main_row, packed_row, batched_rows, shard_row, packed_shard_row


def widest_packed_shard_step(n, P, g, segments7):
    """The step of segment g of the packed fill of length n with P row
    shards whose shard slab is widest among shards with a row offset
    (i0 > 0): its span, TB, rows, middle tt step, shard and i0."""
    from ccj_tpu_torch.dist.wavefront import row_partition, span_rows

    lo, hi, TB, *_r = segments7(n)[g]
    R, _ = row_partition(n, P)
    IB, s, p, i0 = max((IB, s, p, i0) for s in range(lo, hi)
                       for p, i0, IB in span_rows(n, R, P, s) if i0 > 0)
    return s, TB, IB, (s - 2) // 2, p, i0


def group_row(cuda_ops, REDUCTIONS, reduction_table, INF, gen, dev, n, s, TB, IB,
              tt, label, B=None, i0=0):
    """One 13-window group at the tt step ``tt`` of span ``s`` (random
    slabs of that step's shapes, with a leading batch axis of ``B`` where
    given, rows i from ``i0``), checked against the plain version at
    tt = 0, ``tt`` and s - 2 and timed L2-hot and L2-cold; returns its
    row."""
    n2 = n + 2
    lead = () if B is None else (B,)
    slabs = {}
    for name, *_ in REDUCTIONS:
        cols = n2 + TB if name.startswith("B_") else n2
        if name not in slabs:
            slabs[name] = rand_i32((*lead, 2 * TB + 2, IB, cols), gen, dev)
    WKX = {nm: rand_i32((*lead, TB, n2 + TB + 1), gen, dev) for nm in ("WP", "WB", "WBP")}
    WJX = {nm: rand_i32((*lead, TB, n2), gen, dev) for nm in ("WP", "WB", "WBP")}
    table = reduction_table(slabs, WKX, WJX, s, n2, i0)
    G = table.shape[-3]
    terms, nbytes, t_bytes, t_ops = group_bound(table, tt, dev)
    # copies of the operands in fresh memory, enough that cycling
    # through them overflows L2, so the kernel's reads come from HBM
    copies = [table] + [
        reduction_table(*({k: v.clone() for k, v in d.items()}
                          for d in (slabs, WKX, WJX)), s, n2, i0)
        for _ in range(math.ceil(3 * L2_BYTES / nbytes))]
    cycle = itertools.cycle(copies)
    out = torch.empty(table.shape, dtype=torch.int32, device=dev)
    err = 0
    for t in (0, tt, s - 2):
        before = cuda_ops.LAUNCHES
        cuda_ops.minplus_group(table, t, out)
        want = cuda_ops.minplus_group_ref(table, t)
        torch.cuda.synchronize()
        check(cuda_ops.LAUNCHES == before + 1, "a group made more than one launch")
        err = max(err, int((out.long() - want.long()).abs().max()))
        check(int(out.max()) <= INF, f"minplus_group above INF at n={n} tt={t}")
    name = f"group of {G} n={n} s={s} tt={tt} TB={TB} IB={IB}{label}"
    check(err == 0, f"minplus_group != plain on {name}: max |err| = {err}")

    def kern():
        return cuda_ops.minplus_group(table, tt, out)

    def kern_cold():
        return cuda_ops.minplus_group(next(cycle), tt, out)

    def plain():
        return cuda_ops.minplus_group_ref(table, tt)

    row = {
        "case": name, "windows": G, "descriptors": len(table.jobs),
        "batch": B or 1, "Q": TB, "I": IB, "J": n2,
        "masked_windows": sum(w.mode != 0 for w in table.windows),
        "terms": terms, "bytes": nbytes, "max_abs_err": err,
        "ms": graph_ms(kern), "ms_l2cold": graph_ms(kern_cold),
        "l2cold_copies": len(copies), "plain_ms": graph_ms(plain, reps=10),
        "call_ms": cuda_ms(kern, 200), "plain_call_ms": cuda_ms(plain, 10),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    row.update({f"{k}_per_window": row[k] / (G * (B or 1))
                for k in ("ms", "ms_l2cold", "call_ms", "bound_ms")})
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
    return row


def flushed_ms(fn, reps=50):
    """Device time of one call with L2 flushed before it: a buffer of twice
    the L2 is zeroed, then the call runs between two CUDA events; the mean
    over ``reps`` calls.  The step's operands are too large to cycle
    through copies of them, as :func:`group_row` does."""
    buf = torch.empty(int(2 * L2_BYTES) // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for a, b in evs:
        buf.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def step_operands(n, s, TB, IB, gen, dev, B=1):
    """Random operands of one span's ``tt_step`` in the shapes
    ``ttloop.run_tt_loop`` gives them, for a batch of B (DPM cut to the
    rows and columns the span reads)."""
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.common import INF
    from ccj_tpu_torch.engine.gapped import DS, PADT

    def small(shape):           # weights: small energies, or INF
        x = rand_i32(shape, gen, dev)
        return torch.where(x == INF, INF, x.clamp(-400, 400))

    n2 = n + 2
    UB = n2 + TB
    plane = lambda: rand_i32((B, TB, IB, n2), gen, dev)          # noqa: E731
    red = rand_i32((B, cuda_ops.STEP_REDUCTIONS, IB, n2), gen, dev)
    bases = {k: plane() for k in cuda_ops.STEP_BASES}
    cur = {k: rand_i32((B, 2 * TB + 2, IB, n2), gen, dev) for k in cuda_ops.STEP_FAMILIES}
    cur.update({"B_" + k: rand_i32((B, 2 * TB + 2, IB, UB), gen, dev)
                for k in cuda_ops.STEP_B_SLABS})
    stm = rand_i32((B, TB + 2 * PADT, IB, UB + DS), gen, dev)
    dpm = small((B, DS, DS, TB, UB))
    bits = lambda: torch.randint(0, 2, (B, TB, n2), generator=gen, dtype=torch.int32).to(dev)  # noqa: E731
    jk = (bits(), bits(), small((B, TB, n2)))
    valid = (torch.rand((TB, IB, n2), generator=gen) < 0.8).to(dev)
    return red, bases, cur, stm, dpm, jk, valid, plane(), plane(), plane()


def clone_operands(ops):
    def cl(x):
        if isinstance(x, dict):
            return {k: v.clone() for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(v.clone() for v in x)
        return x.clone()
    return tuple(cl(x) for x in ops)


def step_bound(table, tt, dev):
    """The least time of one ``tt_step`` at ``tt`` on this card: the bytes
    it must move (each input element it needs read once: the 13 reduction
    planes, 7 base planes, 7 slab rows, the PL / PR / PO planes, 3 jk rows,
    the valid plane, and the STM and DPM elements that some admissible
    stencil term uses, counted once each; 21 planes written) against its
    operations (an add and a min per admissible term, and 70 per cell for
    the assembly and the store encoding) over the int32 rate.  Returns
    (terms, bytes, t_bytes ms, t_ops ms)."""
    from ccj_tpu_torch.engine.gapped import DS

    B, IB, n2, s, i0 = table.B, table.IB, table.n2, table.s, table.i0
    ar = lambda m: torch.arange(m, device=dev)                     # noqa: E731
    r = ar(IB)[:, None, None, None]
    j = ar(n2)[None, :, None, None]
    d1 = ar(DS)[None, None, :, None] + 1
    d2 = ar(DS)[None, None, None, :] + 1
    i = i0 + r
    keep = (d1 <= j - i - 1) & (d2 <= i + s - j - tt - 3)        # [IB, n2, DS, DS]
    terms = int(keep.sum())
    W = n2 + tt + 2 * DS + 1
    stm_lin = ((tt + d1 + d2) * IB + r) * W + (j + tt + d2)
    dpm_lin = ((d1 - 1) * DS + (d2 - 1)) * W + (j + tt) + 0 * r
    stm_used = int(torch.unique(stm_lin.expand_as(keep)[keep]).numel())
    dpm_used = int(torch.unique(dpm_lin.expand_as(keep)[keep]).numel())
    plane = IB * n2
    nbytes = (B * 4 * ((13 + 7 + 7 + 3) * plane + 3 * n2 + stm_used + dpm_used)
              + plane + B * 4 * 21 * plane)
    ops = B * (2 * terms + 70 * plane)
    return (B * terms, nbytes, nbytes / HBM_BYTES_PER_S * 1e3,
            ops / FP32_OPS_PER_S * 1e3)


def step_row(cuda_ops, gen, dev, n, s, TB, IB, tt, label, B=1, i0=0):
    """One ``tt_step`` at the tt step ``tt`` of span ``s`` on random
    operands (batch B, rows from ``i0``): the kernel on one copy of them and
    the plain version on another, at tt = s - 2, ``tt`` and 0 in that
    order, every slab compared after each; then timed L2-hot (graph
    replay), L2-cold (:func:`flushed_ms`) and eagerly; returns its row."""
    ops_k = step_operands(n, s, TB, IB, gen, dev, B)
    ops_p = clone_operands(ops_k)
    kw = dict(s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
    tk = cuda_ops.StepTable(*ops_k, **kw)
    tp = cuda_ops.StepTable(*ops_p, **kw)
    err = 0
    for t in sorted({s - 2, tt, 0}, reverse=True):
        before = cuda_ops.TT_STEP_LAUNCHES
        cuda_ops.tt_step(tk, t)
        cuda_ops.tt_step_ref(tp, t)
        torch.cuda.synchronize()
        check(cuda_ops.TT_STEP_LAUNCHES == before + 1, "a tt_step made more than one launch")
        for name, x in (*ops_k[2].items(), ("STM", ops_k[3])):
            y = ops_p[2][name] if name != "STM" else ops_p[3]
            err = max(err, int((x.long() - y.long()).abs().max()))
    name = f"tt_step n={n} s={s} tt={tt} TB={TB} IB={IB}{label}"
    check(err == 0, f"tt_step != plain on {name}: max |err| = {err}")
    terms, nbytes, t_bytes, t_ops = step_bound(tk, tt, dev)

    def kern():
        cuda_ops.tt_step(tk, tt)

    def plain():
        cuda_ops.tt_step_ref(tp, tt)

    row = {
        "case": name, "batch": B, "i0": i0, "cells": B * IB * (n + 2),
        "stencil_terms": terms, "bytes": nbytes, "max_abs_err": err,
        "ms": graph_ms(kern), "ms_l2cold": flushed_ms(kern),
        "plain_ms": graph_ms(plain, reps=10),
        "call_ms": cuda_ms(kern, 200), "plain_call_ms": cuda_ms(plain, 10),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
    del ops_k, ops_p, tk, tp
    torch.cuda.empty_cache()
    return row


def heaviest_step(n, bucket_dims):
    """The (span, tt) of a dense fill of length n whose PM stencil has the
    most admissible (cell, d1, d2) terms: d1 <= j - i - 1 and
    d2 <= i + s - j - tt - 3, both in [1, DS]."""
    from ccj_tpu_torch.engine.gapped import DS

    def terms(s, tt):
        IB = bucket_dims(n, s)[1]
        k = torch.arange(n + 2)[None, :] - torch.arange(IB)[:, None]     # j - i
        a = (k - 1).clamp(0, DS)
        b = (s - tt - 3 - k).clamp(0, DS)
        return int((a * b).sum())

    return max(((s, tt) for s in range(3, n) for tt in range(s - 1)),
               key=lambda st: (terms(*st), st))


def phase_tt_step(cuda_ops, bucket_dims, dev):
    """Phase 2b: ``tt_step`` against its plain version at the main path's
    shapes; returns (rows, the dense n=100 row)."""
    from ccj_tpu_torch.engine.gapped5 import segments7

    gen = torch.Generator().manual_seed(1)
    emit({"phase": "tt_step", "library": "none: no single PyTorch call computes "
          "the step's assembly and stencil, so library_ms is null"})
    cases = [(n, *main_span(n, bucket_dims), "", 1, 0) for n in (100, 128)]
    s, TB, IB, tt, g = packed_main_span(200, segments7)
    cases.append((200, s, TB, IB, tt, f" packed segment {g}", 1, 0))
    cases += [(n, *main_span(n, bucket_dims), f" batch of {B}", B, 0)
              for n, B in ((100, 4), (64, 8))]
    s, TB, _, tt = main_span(100, bucket_dims)
    R = -(-102 // 4)
    cases.append((100, s, TB, R, tt, f" row shard 1 of 4, i0={R}", 1, R))
    s, TB, IB, tt, p, i0 = widest_packed_shard_step(200, 4, 3, segments7)
    cases.append((200, s, TB, IB, tt, f" packed segment 3, row shard {p} of 4, i0={i0}",
                  1, i0))
    # the n=100 fill's step with the most stencil terms (1,831,698; the main
    # step's has 63,240): a thread walks its cell's terms one after another
    s, tt = heaviest_step(100, bucket_dims)
    TB, IB = bucket_dims(100, s)
    cases.append((100, s, TB, IB, tt, " the most stencil terms", 1, 0))
    rows = []
    for n, s, TB, IB, tt, label, B, i0 in cases:
        rows.append(step_row(cuda_ops, gen, dev, n, s, TB, IB, tt, label, B, i0))
        emit({"phase": "tt_step", **rows[-1]})
    return rows, rows[0]


def span_operands(n, s, TB, IB, gen, dev, B=1, i0=0):
    """Random operands of one span's ``tt_span`` in the shapes
    ``ttloop.run_tt_loop`` gives them (A slabs and mdp with 2 TB + 2 rows,
    DPM cut to the rows and columns the span reads) and under its contract:
    the family slabs hold SAT16 on the span's valid cells
    (``cuda_ops.span_valid`` of n and i0) and INF elsewhere, as
    ``ttloop._run_span`` initialises them; mdp, the bases, PL / PR / PO,
    the weights, DPM and jk are random."""
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.common import INF, SAT16
    from ccj_tpu_torch.engine.gapped import DS

    def small(shape):           # weights: small energies, or INF
        x = rand_i32(shape, gen, dev)
        return torch.where(x == INF, INF, x.clamp(-400, 400))

    n2 = n + 2
    R = 2 * TB + 2
    validp = cuda_ops.span_valid(n, s, i0, R, IB, n2, dev)
    init = torch.where(validp, SAT16, INF).to(torch.int32)
    plane = lambda: rand_i32((B, TB, IB, n2), gen, dev)          # noqa: E731
    bits = lambda: torch.randint(0, 2, (B, TB, n2), generator=gen, dtype=torch.int32).to(dev)  # noqa: E731
    cur = {k: init.repeat(B, 1, 1, 1) for k in cuda_ops.STEP_FAMILIES}
    return (cur, rand_i32((B, R, IB, n2), gen, dev),
            {k: rand_i32((B, TB, n2 + TB + 1), gen, dev) for k in cuda_ops.SPAN_WEIGHTS},
            {k: rand_i32((B, TB, n2), gen, dev) for k in cuda_ops.SPAN_WEIGHTS},
            {k: plane() for k in cuda_ops.STEP_BASES}, small((B, DS, DS, TB, n2 + TB)),
            (bits(), bits(), small((B, TB, n2))), plane(), plane(), plane())


def span_terms(cuda_ops, table, dev):
    """The span's add-min terms, counted from its shapes and this run's
    jk: the kernel's (the 13 reductions' in-band terms and the PM stencil's
    at the valid cells of the live rows), the needed ones (the same, the
    stencil only where canp and ptype admit PM, as :func:`span_bound`
    counts) and those of a kernel over the whole grid, as ttspan.cu was
    at commit ddd5516 (every row and column, red_k up to q = Q - 1, red_j
    down to column 0).  Returns (live rows, valid cells, kernel terms,
    needed terms, whole-grid terms), each over the batch."""
    from ccj_tpu_torch.engine.gapped import DS

    o = table.ops
    B, IB, n2, s, Q, i0 = table.B, table.IB, table.n2, table.s, table.Q, table.i0
    i = torch.arange(i0, i0 + IB, device=dev)[:, None]
    j = torch.arange(n2, device=dev)[None, :]
    d = j - i
    lo, hi = table.live_rows()
    valid = cuda_ops.span_valid(table.n, s, i0, s - 1, IB, n2, dev)
    kern = need = old = cells = 0
    for tt in range(s - 1):
        V = valid[tt]
        k_u, k_m = s - 2 - tt - d, (s - 3 - tt - d).clamp(min=0)
        red = 3 * k_u + 3 * k_m + 3 * d + 4 * (d - 1).clamp(min=0)   # by REDUCTIONS' kinds
        st = (d - 1).clamp(0, DS) * (s - 3 - tt - d).clamp(0, DS)
        G = V & (o["jk"][0][:, tt, None, :] > 0) & (o["jk"][1][:, tt, None, :] > 0)
        cells += B * int(V.sum())
        kern += B * int((red + st)[V].sum())
        need += B * int(red[V].sum()) + int(st.expand_as(G)[G].sum())
        # the whole grid's bounds: ttspan.cu at ddd5516, reduce_task and stencil_task
        ok_m = (s - 4 - tt - j + i + 1).clamp(0, Q)
        rj_u = torch.minimum(j - 1, torch.full_like(j, s - 3 - tt)).clamp(min=-1) + 1
        rj_m = torch.minimum(rj_u - 1, (j - i - 2).clamp(min=-1)) + 1
        old_st = torch.where((j - i - 1 >= 1), (j - i - 1).clamp(0, DS), 0) * \
            (i + s - j - tt - 3).clamp(0, DS)
        old += B * int((3 * Q + 3 * ok_m + 3 * rj_u + 4 * rj_m.clamp(min=0) + old_st).sum())
    return B * max(0, hi - lo + 1), cells, kern, need, old


def span_bound(cuda_ops, table, dev):
    """The least time of a span's whole loop on this card, as one function
    of its inputs under the kernel's contract (the families hold INF
    outside the valid band and keep it): each input element that an
    in-band term or a valid cell needs read once and each valid cell of the
    14 families written once, over the memory rate, against an add and a
    min per needed term and 70 operations per valid cell (the assembly and
    the store encoding) over the int32 rate.

    Needed is what this run's data needs: the valid cells of the live rows
    (``span_valid`` of the span's n); a reduction's terms whose source cell
    lies in the band (red_k q <= s - 3 - tt - d, red_j q <= d - 1, one less
    where masked; d = j - i), and a stencil term only where canp and ptype
    admit PM.  The inputs: mdp at the masked red_k's terms; the weight
    elements those terms use; DPM at the stencil terms (the same for every
    row); the bases and PL / PR / PO at the valid cells; canp and ptype at
    the columns with a valid cell, ESTP where PM is admitted.  The family
    cells the loop reads are its own outputs (rows >= s - 1 lie outside the
    band and are never read): they count once, as written.  Returns
    (bytes, t_bytes ms, t_ops ms)."""
    from ccj_tpu_torch.engine.gapped import DS

    o = table.ops
    B, IB, n2, s, Q, i0 = table.B, table.IB, table.n2, table.s, table.Q, table.i0
    nf = len(cuda_ops.STEP_FAMILIES)
    wts = [o["WKX"][nm] for nm in cuda_ops.SPAN_WEIGHTS] + [
        o["WJX"][nm] for nm in cuda_ops.SPAN_WEIGHTS]
    valid = cuda_ops.span_valid(table.n, s, i0, s - 1, IB, n2, dev)
    ar = lambda m: torch.arange(m, device=dev)                     # noqa: E731
    q = ar(Q)[:, None, None]
    i = (i0 + ar(IB))[:, None]
    j = ar(n2)[None, :]
    d = j - i
    d1 = ar(DS)[:, None, None] + 1
    elems = terms = cells = 0
    for b in range(B):
        mdp = torch.zeros(o["mdp"].shape[1:], dtype=torch.bool, device=dev)
        wmask = [torch.zeros(w.shape[1:], dtype=torch.bool, device=dev) for w in wts]
        for tt in range(s - 2, -1, -1):
            V = valid[tt]                                          # [IB, n2]
            canp, pt, _ = (x[b, tt] > 0 for x in o["jk"])           # [n2]
            for job in cuda_ops.span_jobs():
                if job.kind == 0:         # red_k: family row tt + 1 + q, column j
                    keep = V & (q <= s - 3 - tt - d - job.masked)
                    if job.src == nf:
                        mdp[tt + 1:tt + 1 + Q] |= keep
                    col = slice(tt + 2, tt + 2 + n2)
                else:                     # red_j: family row tt + 1 + q, column j - 1 - q
                    keep = V & (q <= d - 1 - job.masked)
                    col = slice(0, n2)
                used = keep.any(dim=1)
                ws = [job.w] + ([job.w2] if job.w2 >= 0 else [])
                for w in ws:
                    wmask[w][:, col] |= used
                terms = terms + len(ws) * keep.sum()
            # the PM stencil: terms d1 <= d - 1, d2 <= s - 3 - tt - d
            G = V & canp & pt
            a = torch.where(G, (d - 1).clamp(0, DS), 0)
            c = (s - 3 - tt - d).clamp(0, DS)
            terms = terms + (a * c).sum()
            elems = elems + torch.where(a[None] >= d1, c[None], 0).amax(dim=1).sum()
            # the assembly: 7 bases, PL / PR / PO; canp, ptype and ESTP
            nv = V.sum()
            cells = cells + nv
            elems = elems + 10 * nv + 2 * V.any(dim=0).sum() + G.any(dim=0).sum()
        elems = elems + mdp.sum() + sum(m.sum() for m in wmask)
    nbytes = 4 * int(elems) + 4 * nf * int(cells)
    ops = 2 * int(terms) + 70 * int(cells)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def two_kernel_bound(cuda_ops, table, dev):
    """The span's loop as the two kernels it replaced are held: the sum over
    its steps of :func:`group_bound` and :func:`step_bound` (each step's
    every needed element read once per step, its outputs, the reductions,
    the B slab rows and STM included, written once per step).  The
    yardstick of the two-launch loop, above :func:`span_bound`.  Returns
    (bytes, t_bytes ms, t_ops ms)."""
    wins, step, _ = cuda_ops.span_step_tables(table)
    nbytes = t_bytes = t_ops = 0
    for tt in range(table.s - 2, -1, -1):
        for _, b, tb, to in (group_bound(wins, tt, dev), step_bound(step, tt, dev)):
            nbytes, t_bytes, t_ops = nbytes + b, t_bytes + tb, t_ops + to
    return nbytes, t_bytes, t_ops


# Launch plans phase 2c checks against the plain version, beside the
# kernel's own: blocks a row, threads a block, the weights staged or
# through __ldg, half of the band's rows read back from device memory.
SPAN_PLANS = ({"cluster": 1}, {"cluster": 2}, {"cluster": 4}, {"threads": 256},
              {"threads": 512}, {"threads": 1024}, {"stage": 0}, {"stage": 1},
              {"rows": "half"}, {"rows": "half", "threads": 512, "cluster": 2})


def span_row(cuda_ops, gen, dev, n, s, TB, IB, label, B=1, i0=0):
    """One span's loop on random operands (batch B, rows from ``i0``):
    ``tt_span`` (one launch, at its own plan and at every plan of
    :data:`SPAN_PLANS`, each on a fresh copy), its plain version
    ``tt_span_ref`` and the two-launch loop ``tt_span_steps`` it replaces,
    every slab compared; then timed L2-hot (graph replay), L2-cold
    (:func:`flushed_ms`) and eagerly, with the weights staged and through
    __ldg, and with every phase left out (the empty steps), beside the
    two-launch loop's device and eager times and the plain version's;
    returns its row."""
    ops = span_operands(n, s, TB, IB, gen, dev, B, i0)
    kw = dict(n=n, s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
    plans = [{k: (s - 1) // 2 if v == "half" else v for k, v in p.items()}
             for p in SPAN_PLANS]
    copies = {k: clone_operands(ops) for k in ("plain", "steps", "auto")}
    tables = {k: cuda_ops.SpanTable(*v, **kw) for k, v in copies.items()}
    cuda_ops.tt_span_ref(tables["plain"])
    before = (cuda_ops.LAUNCHES, cuda_ops.TT_STEP_LAUNCHES)
    cuda_ops.tt_span_steps(tables["steps"])
    torch.cuda.synchronize()
    check((cuda_ops.LAUNCHES - before[0], cuda_ops.TT_STEP_LAUNCHES - before[1])
          == (s - 1, s - 1), "the two-launch loop made other than two launches a step")
    want = copies["plain"][0]

    def err_of(got):
        return max(int((x.long() - want[name].long()).abs().max()) for name, x in got.items())

    err = err_of(copies["steps"][0])
    before = cuda_ops.TT_SPAN_LAUNCHES
    cuda_ops.tt_span(tables["auto"])
    torch.cuda.synchronize()
    check(cuda_ops.TT_SPAN_LAUNCHES == before + 1, "a tt_span made other than one launch")
    err = max(err, err_of(copies["auto"][0]))
    launched = []
    for plan in plans:
        cp = clone_operands(ops)
        table = cuda_ops.SpanTable(*cp, **kw)
        cuda_ops.tt_span(table, plan)
        torch.cuda.synchronize()
        launched.append({"asked": plan, "launched": table.plan, "max_abs_err": err_of(cp[0])})
        err = max(err, launched[-1]["max_abs_err"])
        del cp, table
    name = f"tt_span n={n} s={s} TB={TB} IB={IB}{label}"
    check(err == 0, f"tt_span or the two-launch loop != plain on {name}: max |err| = {err}")
    nbytes, t_bytes, t_ops = span_bound(cuda_ops, tables["plain"], dev)
    nbytes2, t_bytes2, t_ops2 = two_kernel_bound(cuda_ops, tables["plain"], dev)
    live, cells, kern_terms, need_terms, old_terms = span_terms(cuda_ops, tables["plain"], dev)
    wins, step, red = cuda_ops.span_step_tables(tables["steps"])

    def kern(plan=None):
        cuda_ops.tt_span(tables["auto"], plan)

    def steps():
        for tt in range(s - 2, -1, -1):
            cuda_ops.minplus_group(wins, tt, red)
            cuda_ops.tt_step(step, tt)

    kern()
    auto_plan = dict(tables["auto"].plan)
    row = {
        "case": name, "batch": B, "i0": i0, "steps": s - 1, "cells": B * IB * (n + 2),
        "live_rows": live, "valid_cells": cells, "kernel_terms": kern_terms,
        "needed_terms": need_terms, "kernel_terms_over_needed": kern_terms / need_terms,
        "whole_grid_terms": old_terms, "bytes": nbytes, "max_abs_err": err,
        "plan": auto_plan, "plans_checked": launched,
        "ms": graph_ms(kern, reps=5, replays=4), "ms_l2cold": flushed_ms(kern, reps=10),
        "call_ms": cuda_ms(kern, 10),
        "cluster_ms": {c: graph_ms(lambda c=c: kern({"cluster": c}), reps=5, replays=4)
                       for c in (1, 2, 4)},
        "weights_ldg_ms": graph_ms(lambda: kern({"stage": 0}), reps=5, replays=4),
        "weights_staged_ms": graph_ms(lambda: kern({"stage": 1}), reps=5, replays=4),
        "empty_ms": graph_ms(lambda: cuda_ops.tt_span_phases(tables["auto"], 7),
                             reps=5, replays=4),
        "steps_ms": graph_ms(steps, reps=2, replays=3), "steps_call_ms": cuda_ms(steps, 3),
        "plain_ms": cuda_ms(lambda: cuda_ops.tt_span_ref(tables["plain"]), 2),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "two_kernel_bytes": nbytes2, "two_kernel_bound_ms": max(t_bytes2, t_ops2),
        "library_ms": None,
    }
    kern({"stage": 1})
    row["weights_staged_launched"] = bool(tables["auto"].plan["stage"])
    row["empty_step_us"] = row["empty_ms"] * 1e3 / (s - 1)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
    row["steps_share_of_two_kernel_bound"] = row["two_kernel_bound_ms"] / row["steps_ms"]
    row["steps_ms_over_ms"] = row["steps_ms"] / row["ms"]
    del ops, copies, tables, wins, step, red
    torch.cuda.empty_cache()
    return row


def phase_tt_span(cuda_ops, bucket_dims, dev):
    """Phase 2c: ``tt_span`` against its plain version and the two-launch
    loop at the main path's spans; returns (rows, the dense n=100 row)."""
    from ccj_tpu_torch.engine.gapped5 import segments7

    gen = torch.Generator().manual_seed(2)
    emit({"phase": "tt_span", "library": "none: no single PyTorch call computes "
          "the tt loop of a span, so library_ms is null"})
    cases = [(n, *main_span(n, bucket_dims)[:3], "") for n in (100, 128)]
    s, TB, IB, _, g = packed_main_span(200, segments7)
    cases.append((200, s, TB, IB, f" packed segment {g}"))
    s, TB, _, _ = main_span(100, bucket_dims)
    R = -(-102 // 4)
    cases.append((100, s, TB, R, f" row shard 1 of 4, i0={R}", R))
    s, _ = heaviest_step(100, bucket_dims)
    cases.append((100, s, *bucket_dims(100, s), " the most stencil terms"))
    rows = []
    for n, s, TB, IB, label, *i0 in cases:
        rows.append(span_row(cuda_ops, gen, dev, n, s, TB, IB, label, i0=i0[0] if i0 else 0))
        emit({"phase": "tt_span", **rows[-1]})
    return rows, rows[0]


# ---------------------------------------------------------------------------
# 2d: history_min and p_split, the fill's history scans and P split
# ---------------------------------------------------------------------------

HISTORY_REPLACES = "ccj_tpu/engine/gapped4.py:306"   # XLA fusions of RL / RI
PSPLIT_REPLACES = "ccj_tpu/engine/gapped3.py:69"     # XLA fusion of compute_P_span3


def rand_i16(shape, gen, dev):
    """int16 state cells made on the card from ``gen``: energies in
    [-3000, 3000), one in seven SAT16 (unset cells take part as values)."""
    from ccj_tpu_torch.engine.common import SAT16

    x = torch.randint(-3000, 4000, shape, generator=gen, dtype=torch.int16, device=dev)
    return x.masked_fill_(x >= 3000, SAT16)


def rand_weights(B, n2, gen, dev):
    """[B, n2, n2] int32 weight tables: small energies, one in eleven INF."""
    from ccj_tpu_torch.engine.common import INF

    x = torch.randint(-500, 600, (B, n2, n2), generator=gen, dtype=torch.int32, device=dev)
    return x.masked_fill_(x >= 500, INF)


def history_launches(cuda_ops, case, gen, dev):
    """The production ``history_min`` launches of one case on a random
    state (every window of ``gapped4.HISTORY_SCANS`` random), each as (the
    launch's label, the fills' call that makes it, its arguments taken as
    it ran: windows, tables, keywords): the dense or packed reader's one
    launch (``SpanReads.history`` of ``gapped4.dense_reads`` /
    ``gapped5.packed_reads``, 16 planes) on the whole state, or a row
    shard's two (``dist.wavefront``'s: the row-local RL windows on the
    shard's rows, 9 planes, and the RI windows on the C rows l = i + s
    that one owner holds, 7 planes).  On the meta device nothing runs
    (the spy returns an empty output): the arguments alone, for
    :func:`history_bound`."""
    from ccj_tpu_torch.engine import gapped4, gapped5
    from ccj_tpu_torch.engine.gapped import dims

    n, s, B, i0, rows = case["n"], case["s"], case["B"], case["i0"], case["rows"]
    n2, T, S, _ = dims(n)
    meta = torch.device(dev).type == "meta"

    def rand16(shape):
        return (torch.empty(shape, dtype=torch.int16, device=dev) if meta
                else rand_i16(shape, gen, dev))

    W = {k: (torch.empty((B, n2, n2), dtype=torch.int32, device=dev) if meta
             else rand_weights(B, n2, gen, dev)) for k in gapped4.HISTORY_TABLES}
    fams = {(m, f) for _k, m, f, _t, _g in gapped4.HISTORY_SCANS}
    st = {}
    if case["packed"]:
        segs = gapped5.segments7(n)
        gi = next(g for g, (lo, hi, *_r) in enumerate(segs) if lo <= s < hi)
        TB = segs[gi][2]
        for h in range(gi + 1):
            lo, hi, TBh, IBh, Lc = segs[h]
            for m, f in fams:
                key, nr = (f"{f}@{h}", IBh) if m == cuda_ops.RL else (f"C_{f}@{h}", Lc)
                st[key] = rand16((B, TBh, hi - lo, nr, n2))
        hist = gapped5.prior_segments(segs, gi, s)

        def reads():
            return gapped5.packed_reads(st, n, s, gi, segs)

        def rl(cut):
            return gapped5.packed_rl(cut, s, gi, segs, rows)

        def ri(f):
            off, nr = i0 + s, min(rows, n2 - i0 - s)
            return [(st[f"C_{f}@{h}"][:, :, :nsh, off - lo - 1:off - lo - 1 + nr], s - lo)
                    for h, lo, nsh in hist]
    else:
        TB = gapped4.bucket_dims(n, s)[0]
        for m, f in fams:
            st[f if m == cuda_ops.RL else "C_" + f] = rand16((B, T, S, n2, n2))
        sp0 = max(s - TB, 0)

        def reads():
            return gapped4.dense_reads(st, n, s, TB, gapped4.bucket_dims(n, s)[1])

        def rl(cut):
            return gapped4.dense_rl(cut, s, TB, rows)

        def ri(f):
            return [(st["C_" + f][:, :TB, sp0:sp0 + TB, i0 + s:min(i0 + s + rows, n2)],
                     s - sp0)]

    if rows is None:
        calls = [("", lambda: reads().history(W))]
    else:
        cut = {k: v[..., i0:i0 + rows, :] for k, v in st.items() if not k.startswith("C_")}
        calls = [(f"{'RL' if mode == cuda_ops.RL else 'RI'} ",
                  lambda mode=mode, fam=fam: gapped4.history_launch(
                      gapped4.history_groups(mode), lambda m, f: fam(f), W, s, i0, TB, rows))
                 for mode, fam in ((cuda_ops.RL, rl(cut)), (cuda_ops.RI, ri))]
    out = []
    real = cuda_ops.history_min
    for label, fn in calls:
        seen = []

        def spy(windows, tables, **kw):
            seen.append((windows, tables, kw))
            if meta:
                K = sum(len(w[3]) for w in windows)
                return torch.empty((K, B, kw["TB"], kw["R"], n2), dtype=torch.int32,
                                   device=dev)
            return real(windows, tables, **kw)

        cuda_ops.history_min = spy
        try:
            fn()
        finally:
            cuda_ops.history_min = real
        check(len(seen) == 1, f"{case['label']} {label}: {len(seen)} history_min launches")
        out.append((label, fn, seen[0]))
    return out


def history_bound(cuda_ops, windows, tables, kw):
    """(terms, bytes, ms by bytes, ms by operations) of one ``history_min``
    launch on its data (``windows`` as ``cuda_ops.history_windows`` cuts
    them): each window element an admissible term reads, once however many
    scans the window serves (tt rows past a part's read SAT16 and no
    memory); the X elements the rows' weights take (per row and (mode,
    table), the distances up to the largest admissible one, on the table);
    4 bytes written per output cell and plane, nothing read of it; two
    int32 operations a term.  Shapes only: the operands may lie on the
    meta device."""
    s, i0, TB, R = kw["s"], kw["i0"], kw["TB"], kw["R"]
    B, n2 = tables[0].shape[0], tables[0].shape[-1]
    tv = torch.arange(TB)[:, None, None]
    iv = torch.arange(i0, i0 + R)[None, :, None]
    jv = torch.arange(n2)[None, None, :]
    terms = win_elems = planes = 0
    dmax = {}                                   # (mode, table) -> [R] largest d used
    for mode, g1, parts, outs in windows:
        planes += len(outs)
        if mode == cuda_ops.RL:
            bound = (iv + s) - (jv + tv + 2) - g1
        else:
            bound = torch.where(iv >= 1, (jv - iv) - g1, 0)
        bound = bound.long().clamp(min=0).expand(TB, R, n2)
        used = torch.zeros(R, dtype=torch.long)
        for win, d0 in parts:
            TBw, U, Rw = win.shape[1:4]
            rows_ok = torch.arange(R) < Rw
            cnt = (min(U, d0) - (d0 - bound).clamp(min=0)).clamp(min=0)
            cnt = cnt * rows_ok[None, :, None]
            terms += B * len(outs) * int(cnt.sum())
            win_elems += B * int(cnt[:TBw].sum())
            reach = torch.minimum(bound.amax(dim=(0, 2)), torch.tensor(d0))
            used = torch.maximum(used, torch.where(cnt.amax(dim=(0, 2)) > 0, reach, 0))
        for t, _k in outs:
            key = (mode, t)
            dmax[key] = torch.maximum(dmax.get(key, used), used)
    x_elems = 0
    i1 = torch.arange(i0, i0 + R)
    for (mode, _t), used in dmax.items():
        d = torch.arange(1, s + 1)[None, :]
        live = d <= used[:, None]
        if mode == cuda_ops.RL:                 # X(l - d + 1, l), l = i + s
            on = (i1[:, None] + s < n2) & (i1[:, None] + s - d + 1 >= 0)
        else:                                   # X(i, i + d - 1)
            on = (i1[:, None] < n2) & (i1[:, None] + d - 1 < n2)
        x_elems += B * int((live & on).sum())
    nbytes = 2 * win_elems + 4 * x_elems + 4 * planes * B * TB * R * n2
    return terms, nbytes, nbytes / HBM_BYTES_PER_S * 1e3, 2 * terms / FP32_OPS_PER_S * 1e3


def psplit_operands(case, gen, dev):
    """A case's P-split operands as the fills pass them: the whole PKE and
    PKD read in place (``gapped3.compute_P_span3``) or, for a row shard,
    its rows of PKE and the PKD rows each a needs stacked
    (``dist.wavefront._fill_sharded``); returns (pke, pkd, keywords)."""
    from ccj_tpu_torch.engine.common import SAT16
    from ccj_tpu_torch.engine.gapped import dims

    n, s, B, i0, rows = case["n"], case["s"], case["B"], case["i0"], case["rows"]
    n2, T, S, _ = dims(n)
    PKD = rand_i16((B, T, S, n2, n2), gen, dev)
    PKE = rand_i16((B, T, S + T + 2, n2, n2), gen, dev)
    if rows is None:
        return PKE, PKD.transpose(1, 2), dict(s=s, n=n, i0=0, R=n2, sp=(s - 1, -1),
                                              ro=(1, 1))
    G = torch.full((B, s - 1, T, rows, n2), SAT16, dtype=torch.int16, device=dev)
    for a in range(s - 1):
        r0 = i0 + a + 1
        got = PKD[:, :, s - a - 1, r0:r0 + rows]
        G[:, a, :, :got.shape[2]] = got
    del PKD
    return PKE[..., i0:i0 + rows, :], G, dict(s=s, n=n, i0=i0, R=rows, sp=(0, 1), ro=(0, 0))


def psplit_bound(cuda_ops, B, kw):
    """(terms, bytes, ms by bytes, ms by operations) of one P split: every
    admissible (a, b, c) term of a live row reads one PKE and one PKD
    element no other term reads (the factor-2 rows of a live row lie within
    the operand), and one int32 a row is written."""
    s = kw["s"]
    lo, hi = cuda_ops.p_split_live(kw["n"], s, kw["i0"], kw["R"])
    terms = B * max(hi - lo + 1, 0) * (s * (s - 1) * (s - 2) // 6)
    nbytes = 4 * terms + 4 * B * kw["R"]
    return terms, nbytes, nbytes / HBM_BYTES_PER_S * 1e3, 2 * terms / FP32_OPS_PER_S * 1e3


def history_psplit_cases(bucket_dims):
    """Phase 2d's shapes: the n=100 main span, n=128's, the packed n=200
    span 135 (segment 3, over all four prior segments), a batch of four at
    bucket 100, a dense row shard (n=100, shard 1 of 4: 26 rows from i0 =
    26) and a packed one (n=200, shard 1 of 4: 48 rows from i0 = 51 at span
    102, the first of segment 3)."""
    s100 = main_span(100, bucket_dims)[0]
    base = dict(B=1, i0=0, rows=None, packed=False)
    return [dict(base, label=f"n=100 s={s100}", n=100, s=s100),
            dict(base, label=f"n=128 s={main_span(128, bucket_dims)[0]}", n=128,
                 s=main_span(128, bucket_dims)[0]),
            dict(base, label="n=200 packed s=135 (segment 3)", n=200, s=135, packed=True),
            dict(base, label=f"bucket 100 x 4 s={s100}", n=100, s=s100, B=4),
            dict(base, label=f"n=100 row shard 1 of 4 (26 rows from i0=26) s={s100}",
                 n=100, s=s100, i0=26, rows=26),
            dict(base, label="n=200 packed row shard 1 of 4 (48 rows from i0=51) s=102",
                 n=200, s=102, i0=51, rows=48, packed=True)]


def phase_history_psplit(cuda_ops, bucket_dims, dev):
    """Phase 2d: ``history_min`` (both scans) and ``p_split`` against their
    plain versions on the card, exactly, at :func:`history_psplit_cases`;
    each row with the kernel's L2-hot (graph replay) and L2-cold
    (:func:`flushed_ms`) device times, the eager call's (the fills' own
    call: the RL / RI closure with its weight gather, or ``p_split``),
    the plain version's on the card and the bound.  Returns (history rows,
    p_split rows)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    emit({"phase": "history_psplit", "library": "none: no single PyTorch call takes a "
          "min over a masked sum of two operands without materialising the sum, so "
          "library_ms is null for both kernels"})
    hist_rows, ps_rows = [], []
    for case in history_psplit_cases(bucket_dims):
        for label, call, (windows, tables, kw) in history_launches(cuda_ops, case, gen, dev):
            cut, K = cuda_ops.history_windows(windows, tables, kw["R"], kw["s"])
            want = cuda_ops.history_min_ref(cut, tables, kw["s"], kw["i0"], kw["TB"], kw["R"])
            name = f"history_min {label}{case['label']}"
            before = cuda_ops.HISTORY_LAUNCHES
            got = cuda_ops.history_min(windows, tables, **kw)
            torch.cuda.synchronize()
            check(cuda_ops.HISTORY_LAUNCHES == before + 1,
                  "a history_min call made other than one launch")
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"{name} != plain: max |err| = {err}")
            check(bool((got < 10_000_000).any()), f"{name}: no cell had a term")
            del got, want
            terms, nbytes, t_bytes, t_ops = history_bound(cuda_ops, cut, tables, kw)

            def kern():
                cuda_ops.history_min(windows, tables, **kw)

            row = {"case": name, "batch": case["B"], "i0": kw["i0"], "planes": K,
                   "windows": len(cut), "parts": max(len(w.parts) for w in cut),
                   "out_shape": [K, case["B"], kw["TB"], kw["R"], tables[0].shape[-1]],
                   "terms": terms, "bytes": nbytes, "max_abs_err": err,
                   "ms": graph_ms(kern, reps=20, replays=5), "ms_l2cold": flushed_ms(kern, 20),
                   "call_ms": cuda_ms(call, 10),
                   "plain_ms": cuda_ms(lambda: cuda_ops.history_min_ref(
                       cut, tables, kw["s"], kw["i0"], kw["TB"], kw["R"]), 2),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
            hist_rows.append(row)
            emit({"phase": "history_psplit", **row})
        torch.cuda.empty_cache()
        pke, pkd, kw = psplit_operands(case, gen, dev)
        want = cuda_ops.p_split_ref(pke, pkd, kw["s"], kw["n"], kw["i0"], kw["R"],
                                    kw["sp"], kw["ro"])
        name = f"p_split {case['label']}"
        before = cuda_ops.PSPLIT_LAUNCHES
        got = cuda_ops.p_split(pke, pkd, **kw)
        torch.cuda.synchronize()
        check(cuda_ops.PSPLIT_LAUNCHES == before + 1, "a p_split made other than one launch")
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"{name} != plain: max |err| = {err}")
        check(bool((want < 10_000_000).any()), f"{name}: no live row had a term")
        terms, nbytes, t_bytes, t_ops = psplit_bound(cuda_ops, case["B"], kw)

        def kern():
            cuda_ops.p_split(pke, pkd, **kw)


        lo, hi = cuda_ops.p_split_live(kw["n"], kw["s"], kw["i0"], kw["R"])
        row = {"case": name, "batch": case["B"], "i0": kw["i0"], "rows": kw["R"],
               "live_rows": max(hi - lo + 1, 0),
               "operand": "PKD in place" if case["rows"] is None else "PKD rows stacked",
               "terms": terms, "bytes": nbytes, "max_abs_err": err,
               "ms": graph_ms(kern, reps=20, replays=5), "ms_l2cold": flushed_ms(kern, 20),
               "call_ms": cuda_ms(kern, 10),
               "plain_ms": cuda_ms(lambda: cuda_ops.p_split_ref(
                   pke, pkd, kw["s"], kw["n"], kw["i0"], kw["R"], kw["sp"], kw["ro"]), 2),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
        ps_rows.append(row)
        emit({"phase": "history_psplit", **row})
        del pke, pkd, want, got
        torch.cuda.empty_cache()
    return hist_rows, ps_rows


# ---------------------------------------------------------------------------
# phase 2e: the PL / PR interior-loop stencils
# ---------------------------------------------------------------------------

STENCIL_REPLACES = {"stencil_pl": "ccj_tpu/engine/gapped4.py:340",   # XLA fusions,
                    "stencil_pr": "ccj_tpu/engine/gapped4.py:392"}   # no Pallas kernel
INT32_LANES = 132 * 64      # H100 SXM: 132 SMs x 64 INT32 lanes (Hopper white paper)


def sm_clock_hz():
    """The card's largest SM clock as ``nvidia-smi`` reports it, in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def stencil_cases(bucket_dims):
    """Phase 2e's shapes: the n=100 main span, n=128's, the packed n=200
    span 135 (segment 3, one segment) and span 110 (its window straddles
    segments 2 and 3), a batch of four at bucket 100, a dense row shard
    (n=100, shard 1 of 4: 26 rows from i0 = 26), a packed one (n=200,
    shard 1 of 4: 48 rows from i0 = 51 at span 102), a batch of two
    different sequences at bucket 100 (each element its own weights, so
    the kernel's masks differ per element), the n=100 span 8, whose
    columns hold 1-7 valid tt rows, and the n=37 span 20, whose n2 and tt
    stride are odd (the staged rows' word parity alternates row by row).  ``mixed``: element b takes the
    weights of ``bench_seq(n, 42 + b)``, else every element those of seed
    42."""
    s100 = main_span(100, bucket_dims)[0]
    s128 = main_span(128, bucket_dims)[0]
    base = dict(B=1, i0=0, rows=None, packed=False, mixed=False)
    return [dict(base, label=f"n=100 s={s100}", n=100, s=s100),
            dict(base, label=f"n=128 s={s128}", n=128, s=s128),
            dict(base, label="n=200 packed s=135 (segment 3)", n=200, s=135, packed=True),
            dict(base, label="n=200 packed s=110 (window over segments 2 and 3)", n=200,
                 s=110, packed=True),
            dict(base, label=f"bucket 100 x 4 s={s100}", n=100, s=s100, B=4),
            dict(base, label=f"n=100 row shard 1 of 4 (26 rows from i0=26) s={s100}",
                 n=100, s=s100, i0=26, rows=26),
            dict(base, label="n=200 packed row shard 1 of 4 (48 rows from i0=51) s=102",
                 n=200, s=102, i0=51, rows=48, packed=True),
            dict(base, label=f"bucket 100 x 2, two sequences' weights, s={s100}", n=100,
                 s=s100, B=2, mixed=True),
            dict(base, label="n=100 s=8 (small span)", n=100, s=8),
            dict(base, label="n=37 s=20 (odd n2 and tt stride)", n=37, s=20)]


def stencil_weights(sp, dev):
    """A function of a :func:`stencil_cases` case: the batch's stencil
    weights {"W4PL", "W4PR"}, [B, ...] each, element b those of
    ``bench_seq(n, 42 + b)`` where the case is ``mixed``, else seed 42's
    for every element.  A sequence's weights are built once and kept until
    a case of another length."""
    from ccj_tpu_torch.engine.fold import build_consts, consts_from_numpy
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables

    cache = {}

    def one(n, seed):
        if (n, seed) not in cache:
            if any(k[0] != n for k in cache):
                cache.clear()
                torch.cuda.empty_cache()
            tabs = build_seq_tables(bench_seq(n, seed), sp, DEFAULT_PK)
            SC4 = consts_from_numpy(build_consts(tabs, sp, DEFAULT_PK), dev)[1]
            cache[n, seed] = {k: SC4[k] for k in ("W4PL", "W4PR")}
        return cache[n, seed]

    def of(case):
        n, B = case["n"], case["B"]
        if case["mixed"]:
            per = [one(n, 42 + b) for b in range(B)]
            return {k: torch.stack([p[k] for p in per]) for k in per[0]}
        return {k: v[None].expand(B, *v.shape) for k, v in one(n, 42).items()}

    return of


def stencil_operands(cuda_ops, case, SC4b, gen, dev):
    """A case's stencil calls as the fills make them, on a random PL / PR
    state and the batch's stencil weights ``SC4b`` ([B, ...] each): {"PL":
    (parts, W4PL), "PR": (parts, W4PR)}, the keywords, and the fills' own
    call of each (``gapped4.pl_stencil`` / ``pr_stencil`` over the layout's
    reads; a row shard's window is the rows the transport fetches, here a
    view of the state's)."""
    from ccj_tpu_torch.engine import gapped4, gapped5
    from ccj_tpu_torch.engine.gapped import DS, dims

    n, s, B, i0, rows = case["n"], case["s"], case["B"], case["i0"], case["rows"]
    n2, T, S, _ = dims(n)
    st = {"PKD": torch.zeros((B, 1, 1, 1, n2), dtype=torch.int16, device=dev)}
    if case["packed"]:
        segs = gapped5.segments7(n)
        gi = next(g for g, (lo, hi, *_r) in enumerate(segs) if lo <= s < hi)
        TB, IB = segs[gi][2], segs[gi][3]
        for name in ("PL", "PR"):
            for h in range(gi + 1):
                lo, hi, TBh, IBh, _ = segs[h]
                st[f"{name}@{h}"] = rand_i16((B, TBh, hi - lo, IBh, n2), gen, dev)
        reads = gapped5.packed_reads(st, n, s, gi, segs)
    else:
        TB, IB = gapped4.bucket_dims(n, s)
        for name in ("PL", "PR"):
            st[name] = rand_i16((B, T, S, n2, n2), gen, dev)
        reads = gapped4.dense_reads(st, n, s, TB, IB)
    R = IB if rows is None else rows
    ops = {}
    for name, halo, w in (("PL", DS, SC4b["W4PL"]), ("PR", 0, SC4b["W4PR"])):
        parts = reads.window(name, halo)
        if rows is not None:       # the shard's rows and halo
            parts = [(v[..., i0:i0 + rows + halo, :], u0) for v, u0 in parts]
        ops[name] = (parts, w)
    kw = dict(s=s, n=n, i0=i0, TB=TB, R=R)
    if rows is None:
        calls = {"PL": lambda: gapped4.pl_stencil(reads, SC4b, s, n, TB, IB),
                 "PR": lambda: gapped4.pr_stencil(reads, SC4b, s, n, TB, IB)}
    else:
        calls = {"PL": lambda: cuda_ops.stencil_pl(*ops["PL"], **kw),
                 "PR": lambda: cuda_ops.stencil_pr(*ops["PR"], **kw)}
    return ops, kw, calls


def stencil_bound(name, parts, w, s, n, i0, TB, R, clock_hz):
    """(terms, bytes, ms by bytes, ms by operations) of one stencil on its
    data: every admissible term (a valid cell of a live row and a (d1, d2)
    whose weight is below INF) is one fused add-min on one of the card's
    132 x 64 int32 lanes at ``clock_hz``; the bytes are each window element
    an admissible term reads once (a span, tt row or row no view holds
    reads SAT16 and no memory), each finite weight those terms use once and
    each valid output cell's int32 once."""
    from ccj_tpu_torch.engine.common import INF
    from ccj_tpu_torch.engine.cuda_ops import span_valid, stencil_parts
    from ccj_tpu_torch.engine.gapped import DS

    B, n2, dev = w.shape[0], n + 2, w.device
    parts = stencil_parts(parts, B, n2, s)
    valid = span_valid(n, s, i0, TB, R, n2, dev)                   # [TB, R, n2]
    terms = win_elems = w_elems = 0
    live_cols = valid.any(dim=0)                                    # [R, n2]
    for b in range(B):         # each element its own weights
        for d_out in range(1, DS + 1):
            span = s - d_out
            view = next((v for v, u0 in parts if u0 <= span < u0 + v.shape[2]), None)
            used = torch.zeros((TB + DS, R + DS, n2), dtype=torch.bool, device=dev)
            for d_in in range(1, DS + 1):
                d1, d2 = (d_out, d_in) if name == "PL" else (d_in, d_out)
                if name == "PL":       # W4PL[d1, d2, i, j], tt-free
                    fin = w[b, d1 - 1, d2 - 1, i0:i0 + R, :] < INF        # [R, n2]
                    cells = valid & fin
                    w_elems += int((fin & live_cols).sum())
                    # reads PL[tt + d2, s - d1, i + d1, j - d2]
                    if d2 < n2:
                        used[d2:d2 + TB, d1:d1 + R, :n2 - d2] |= cells[:, :, d2:]
                else:                  # W4PR[d1, d2, u + 2, i + s], u = j + tt
                    k = (torch.arange(TB, device=dev)[:, None, None]
                         + torch.arange(n2, device=dev)[None, None, :] + 2)
                    l = torch.arange(i0, i0 + R, device=dev)[None, :, None] + s
                    ok = (k < w.shape[3]) & (l < w.shape[4])
                    fin = ok & (w[b, d1 - 1, d2 - 1][k.clamp(max=w.shape[3] - 1),
                                                     l.clamp(max=w.shape[4] - 1)] < INF)
                    cells = valid & fin
                    uk = torch.zeros((n2 + TB + 2, R), dtype=torch.bool, device=dev)
                    uk[k.expand_as(cells)[cells],
                       (l - s - i0).expand_as(cells)[cells]] = True
                    w_elems += int(uk.sum())
                    # reads PR[tt + d1, s - d2, i, j]
                    used[d1:d1 + TB, :R] |= cells
                terms += int(cells.sum())
            if view is not None:
                TTw, Rw = view.shape[1], view.shape[3]
                win_elems += int(used[:TTw, :Rw].sum())
    nbytes = 2 * win_elems + 4 * w_elems + 4 * B * int(valid.sum())
    return (terms, nbytes, nbytes / HBM_BYTES_PER_S * 1e3,
            terms / (INT32_LANES * clock_hz) * 1e3)


# csrc/stencil.cu: columns a tile, tt rows a tile by kind (Tile<KIND>::kRows)
STENCIL_TILE_X, STENCIL_TILE_T, WARP = 32, {"PL": 128, "PR": 64}, 32


def stencil_walked(name, w, s, n, i0, TB, R):
    """The terms the stencil kernel's warps walk (``csrc/stencil.cu``), each
    lane's add-min counted, the lanes past a column's last valid tt row
    too: per live row, tile of 128 (PL) or 64 (PR) tt rows x 32 columns
    (x = j - i for PL, u - i for PR) with a valid cell, outer offset
    d <= min(DS, G - 5) at the tile's largest loop bound G, and column with
    a valid cell in the tile, 32 lanes x the column's chunks of 32 tt rows
    holding one x the inner offsets whose weight is below INF."""
    from ccj_tpu_torch.engine.common import INF, TURN
    from ccj_tpu_torch.engine.cuda_ops import PL_KIND, PR_KIND, p_split_live
    from ccj_tpu_torch.engine.gapped import DS

    kind = {"PL": PL_KIND, "PR": PR_KIND}.get(name, name)
    tile_t = STENCIL_TILE_T["PL" if kind == PL_KIND else "PR"]
    n2, dev = n + 2, w.device
    lo, hi = p_split_live(n, s, i0, R)
    cols, last_tt = s - 1, min(TB, s - 1) - 1
    if hi < lo or cols < 1:
        return 0
    ntx = -(-cols // STENCIL_TILE_X)
    nty = -(-min(TB, cols) // tile_t)
    ii = torch.arange(lo, hi + 1, device=dev)[:, None]
    x = torch.arange(ntx * STENCIL_TILE_X, device=dev)[None, :]
    # cnt[b, d - 1, row, x]: the inner offsets of outer offset d with W < INF
    if kind == PL_KIND:        # W4PL[b, d1, d2, i, j], j = i + x
        j = ii + x
        cnt = (w[:, :, :, ii, j.clamp(max=n2 - 1)] < INF).sum(dim=2) * (j < n2)
        last = torch.clamp(s - 2 - x, max=last_tt)[0]
    else:                      # W4PR[b, d1, d2, u + 2, i + s], u = i + x
        k, l = ii + x + 2, ii + s
        ok = (k < w.shape[3]) & (l < w.shape[4])
        cnt = (w[:, :, :, k.clamp(max=w.shape[3] - 1), l.clamp(max=w.shape[4] - 1)]
               < INF).sum(dim=1) * ok
        last = torch.where(x > s - 2, -1, torch.clamp(x, max=last_tt))[0]
    csum = torch.cumsum(cnt.sum(dim=(0, 2)), dim=0)          # [DS, x]: d' <= d
    walked = 0
    for ty in range(nty):
        t0 = ty * tile_t
        for tx in range(ntx):
            x0 = tx * STENCIL_TILE_X
            if kind == PL_KIND:
                if t0 + x0 > s - 2:
                    continue
                gmax = min(x0 + STENCIL_TILE_X - 1, s - 2 - t0)
            else:
                if t0 > min(x0 + STENCIL_TILE_X - 1, s - 2):
                    continue
                gmax = s - 2 - max(x0, t0)
            dmax = min(DS, gmax - TURN - 2)
            if dmax < 1:
                continue
            span = slice(x0, x0 + STENCIL_TILE_X)
            nk = ((last[span] - t0) // WARP + 1).clamp(0, tile_t // WARP)
            walked += WARP * int((nk * csum[dmax - 1, span]).sum())
    return walked


def ptxas_usage(log):
    """``-Xptxas -v``'s report per kernel entry of a build log: {mangled
    name: {"registers", "spill_stores", "spill_loads", "smem"}} (bytes)."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def stencil_ptxas(log):
    """``ptxas_usage`` of the two stencil kernels: {"stencil_pl": ...,
    "stencil_pr": ...} (``stencil_kernel<0>`` and ``<1>``)."""
    usage = ptxas_usage(log)
    return {kname: next((v for k, v in usage.items() if f"stencil_kernelILi{kind}E" in k),
                        None)
            for kname, kind in (("stencil_pl", 0), ("stencil_pr", 1))}


def span_ptxas(log):
    """``ptxas_usage`` of the two span kernels: {"span_assemble": ...,
    "span_store": ...} (``assemble_kernel`` and ``store_kernel``)."""
    usage = ptxas_usage(log)
    return {kname: next((v for k, v in usage.items() if entry in k), None)
            for kname, entry in (("span_assemble", "assemble_kernel"),
                                 ("span_store", "store_kernel"))}


def phase_stencil(cuda_ops, sp, dev, ptxas=None):
    """Phase 2e: ``stencil_pl`` and ``stencil_pr`` against their plain
    versions on the card, exactly, at :func:`stencil_cases` (the fills'
    own calls on a random PL / PR state, the stencil weights of the bench
    sequence of that length, or of one sequence a batch element); each
    row with the kernel's L2-hot (graph replay) and L2-cold
    (:func:`flushed_ms`) device times (the output's INF fill included),
    the fills' eager call's, the plain version's on the card,
    :func:`stencil_bound`, the lane terms the kernel walks
    (:func:`stencil_walked`) against the admissible ones and the kernel's
    ``ptxas`` registers and spill (``ptxas``: :func:`stencil_ptxas` of this
    run's build).  Returns the rows by kernel."""
    from ccj_tpu_torch.engine.common import INF
    from ccj_tpu_torch.engine.gapped4 import bucket_dims

    gen = torch.Generator(device=dev).manual_seed(5)
    clock = sm_clock_hz()
    emit({"phase": "stencil", "sm_clock_hz": clock,
          "library": "none: no single PyTorch call takes a masked min over sums without "
                     "materialising them, so library_ms is null for both kernels"})
    rows = {"stencil_pl": [], "stencil_pr": []}
    weights = stencil_weights(sp, dev)
    for case in stencil_cases(bucket_dims):
        n = case["n"]
        ops, kw, calls = stencil_operands(cuda_ops, case, weights(case), gen, dev)
        for fam, kname in (("PL", "stencil_pl"), ("PR", "stencil_pr")):
            parts, w = ops[fam]
            fn = getattr(cuda_ops, kname)
            ref = getattr(cuda_ops, kname + "_ref")
            want = ref(cuda_ops.stencil_parts(parts, w.shape[0], n + 2, kw["s"]), w,
                       kw["s"], n, kw["i0"], kw["TB"], kw["R"])
            before = (cuda_ops.STENCIL_LAUNCHES, getattr(cuda_ops, f"STENCIL_{fam}_LAUNCHES"))
            got = fn(parts, w, **kw)
            torch.cuda.synchronize()
            check((cuda_ops.STENCIL_LAUNCHES, getattr(cuda_ops, f"STENCIL_{fam}_LAUNCHES"))
                  == (before[0] + 1, before[1] + 1), f"a {kname} made other than one launch")
            err = int((got.long() - want.long()).abs().max())
            label = f"{kname} {case['label']}"
            check(err == 0, f"{label} != plain: max |err| = {err}")
            check(bool((want < INF).any()), f"{label}: no cell had a term")
            terms, nbytes, t_bytes, t_ops = stencil_bound(fam, parts, w, clock_hz=clock, **kw)
            walked = stencil_walked(fam, w, **kw)

            def kern(fn=fn, parts=parts, w=w):
                fn(parts, w, **kw)

            row = {"case": label, "batch": case["B"], "i0": kw["i0"], "rows": kw["R"],
                   "TB": kw["TB"], "views": len(cuda_ops.stencil_parts(
                       parts, w.shape[0], n + 2, kw["s"])),
                   "out_shape": list(got.shape), "terms": terms, "walked": walked,
                   "walked_over_terms": walked / max(terms, 1), "bytes": nbytes,
                   "max_abs_err": err,
                   "ms": graph_ms(kern, reps=20, replays=5), "ms_l2cold": flushed_ms(kern, 20),
                   "ptxas": (ptxas or {}).get(kname),
                   "call_ms": cuda_ms(calls[fam], 10),
                   "plain_ms": cuda_ms(lambda: ref(cuda_ops.stencil_parts(
                       parts, w.shape[0], n + 2, kw["s"]), w, kw["s"], n, kw["i0"],
                       kw["TB"], kw["R"]), 2),
                   "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "ops_ms": t_ops,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": None}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
            rows[kname].append(row)
            emit({"phase": "stencil", **row})
            del want, got
        del ops, calls
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2f: span_assemble and span_store, the span's assembly and write-back
# ---------------------------------------------------------------------------

SPAN_REPLACES = {"span_assemble": "ccj_tpu/engine/gapped4.py:257",   # XLA fusions of the
                 "span_store": "ccj_tpu/engine/gapped4.py:472"}      # span body, no Pallas


def span_cases(bucket_dims):
    """Phase 2f's shapes: the n=100 main span, n=128's, the packed n=200
    span 135 (segment 3) and span 103 (its fixed-offset reads in segments 2
    and 3), a batch of four at bucket 100, a dense row shard (n=100, shard
    1 of 4: 26 rows from i0 = 26), a packed one (n=200, shard 1 of 4: 48
    rows from i0 = 51 at span 102, its reads in segment 2) and the n=37
    span 20 (odd n2)."""
    s100 = main_span(100, bucket_dims)[0]
    s128 = main_span(128, bucket_dims)[0]
    base = dict(B=1, i0=0, rows=None, packed=False)
    return [dict(base, label=f"n=100 s={s100}", n=100, s=s100),
            dict(base, label=f"n=128 s={s128}", n=128, s=s128),
            dict(base, label="n=200 packed s=135 (segment 3)", n=200, s=135, packed=True),
            dict(base, label="n=200 packed s=103 (reads in segments 2 and 3)", n=200,
                 s=103, packed=True),
            dict(base, label=f"bucket 100 x 4 s={s100}", n=100, s=s100, B=4),
            dict(base, label=f"n=100 row shard 1 of 4 (26 rows from i0=26) s={s100}",
                 n=100, s=s100, i0=26, rows=26),
            dict(base, label="n=200 packed row shard 1 of 4 (48 rows from i0=51) s=102",
                 n=200, s=102, i0=51, rows=48, packed=True),
            dict(base, label="n=37 s=20 (odd n2)", n=37, s=20)]


def fill_rand16_(x, gen):
    """Random int16 state cells in place (as :func:`rand_i16` makes them)."""
    from ccj_tpu_torch.engine.common import SAT16

    x.random_(-3000, 4000, generator=gen)
    return x.masked_fill_(x >= 3000, SAT16)


def span_kernel_calls(cuda_ops, case, sp, gen, dev):
    """The fills' own ``span_assemble`` and ``span_store`` calls of one case,
    taken by spies as the layout's span step runs once on a random state
    (every 4-D array random; the bench sequence's tables, one copy an
    element of a batch): ``gapped4.span_gapped4``, ``gapped5.span_gapped7``
    or, for a row shard, ``dist.wavefront``'s reads, ``span_families`` and
    write-back of the shard on P=4 shards of one device.  Returns
    ((args, keywords) of span_assemble, those of span_store, the state)."""
    from ccj_tpu_torch.dist import wavefront
    from ccj_tpu_torch.engine import fold, gapped, gapped4, gapped5
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables

    n, s, B, i0, rows = case["n"], case["s"], case["B"], case["i0"], case["rows"]
    tabs = build_seq_tables(bench_seq(n), sp, DEFAULT_PK)
    C, SC4 = fold.consts_from_numpy(fold.build_consts(tabs, sp, DEFAULT_PK), dev)
    Cb, SC4b = fold.stack_consts([C] * B), fold.stack_consts([SC4] * B)
    segs = gapped5.segments7(n) if case["packed"] else None
    gi = (next(g for g, (lo, hi, *_r) in enumerate(segs) if lo <= s < hi)
          if segs else None)
    TB, IB = (segs[gi][2], segs[gi][3]) if segs else gapped4.bucket_dims(n, s)
    seen = {}
    real = cuda_ops.span_assemble, cuda_ops.span_store

    def spy(k):
        def run(*a, **kw):
            seen[k] = (a, kw)
            return real[k](*a, **kw)
        return run

    cuda_ops.span_assemble, cuda_ops.span_store = spy(0), spy(1)
    try:
        with torch.inference_mode():
            if rows is None:
                if segs:
                    st = fold.init_state_2d(n, dev)
                    st.update(gapped5.init_big_state7(n, segs, dev))
                else:
                    st = fold._init_dense(n, dev, B)
                for v in st.values():
                    if v.dim() == 5:
                        fill_rand16_(v, gen)
                Cw = gapped.step_tables(Cb, st)
                if segs:
                    gapped5.span_gapped7(Cw, SC4b, st, s, gi, segs)
                else:
                    gapped4.span_gapped4(Cw, SC4b, st, s, TB, IB)
            else:
                st = wavefront.ShardedState(n, [dev] * 4, segs)
                for sh in st.shards:
                    for k in st.row_names:
                        fill_rand16_(sh[k], gen)
                p = i0 // st.R
                check((p, i0, rows) in wavefront.span_rows(n, st.R, 4, s),
                      f"{case['label']}: not a shard's rows")
                reads = (wavefront.sharded_packed_reads(st, p, s, gi, segs, rows) if segs
                         else wavefront.sharded_reads(st, p, s, TB, rows))
                Cw = gapped.step_tables(Cb, st.replicas[st.devices[p]])
                res = gapped4.span_families(Cw, SC4b, st.shards[p], s, TB, rows, reads, i0)
                wavefront._write_back(st, p, s, res, gi)
        torch.cuda.synchronize()
    finally:
        cuda_ops.span_assemble, cuda_ops.span_store = real
    check(set(seen) == {0, 1}, f"{case['label']}: the step made no span_assemble or "
          "span_store call")
    return seen[0], seen[1], st


def assemble_bound(cuda_ops, args, kw):
    """(bytes, ms by bytes) of one ``span_assemble`` on its data: each state
    element a valid cell's taken branches read once (a read its own bounds
    admit, behind the gates pt > 0, can_pair > 0 and its term's bound; a
    cell no part holds reads SAT16 and no memory; two reads of one family
    and span counted once), pl_int / pr_int where the interior branch is
    taken, the eight history planes the valid cells read and the two of the
    PMmloop10 base on every cell (4 B each), the table entries those
    branches take, and every output cell written once (5 int32 and 8 int16
    a cell).  No arithmetic is worth counting: a few adds and mins a cell."""
    from ccj_tpu_torch.engine.common import TURN

    planes, pl_int, pr_int, hist, (canp, pt, ESTP) = args
    s, n, i0, TB, IB = (kw[k] for k in ("s", "n", "i0", "TB", "IB"))
    B, n2, dev = pl_int.shape[0], n + 2, pl_int.device
    tv = torch.arange(TB, device=dev)[:, None, None]
    iv = torch.arange(i0, i0 + IB, device=dev)[None, :, None]
    jv = torch.arange(n2, device=dev)[None, None, :]
    kv, lv = jv + tv + 2, iv + s
    valid = cuda_ops.span_valid(n, s, i0, TB, IB, n2, dev)[None]

    def at(X, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return X[:, a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)]

    pij, pkl, pil = (at(pt, a, b) > 0 for a, b in ((iv, jv), (kv, lv), (iv, lv)))
    cij, ckl, cil = (at(canp, a, b) for a, b in ((iv, jv), (kv, lv), (iv, lv)))
    gates = [pij & cij & (iv + TURN + 2 < jv), pij, pij, pij & (jv >= iv + TURN + 1),
             pkl & ckl & (kv + TURN + 2 < lv), pkl, pkl, pkl & (lv >= kv + TURN + 1),
             pil & cil & (iv < jv) & (kv < lv), pil, pil, pil & (lv >= iv + TURN + 1),
             torch.ones_like(pij)]
    used = {}
    for q, (name, c, b, di, dj) in enumerate(cuda_ops.ASSEMBLE_READS):
        i2, j2 = iv + di, jv + dj
        ok = ((i2 >= 1) & (i2 <= j2) & (j2 + tv + c + 2 <= i2 + s - b)
              & (i2 + s - b <= n) & (s - b >= 0))
        need = valid & ok & gates[q]
        held = torch.zeros((TB, IB, 1), dtype=torch.bool, device=dev)
        for view, t0, r0 in planes[q]:
            held |= (((tv + t0 >= 0) & (tv + t0 < view.shape[1]))
                     & ((iv - i0 + r0 >= 0) & (iv - i0 + r0 < view.shape[2])))
        need = (need & held).expand(B, TB, IB, n2)
        # element (tt + c, r + di, j + dj) of the family at span s - b
        u = used.setdefault((name, b), torch.zeros((B, TB + 2, IB + 2, n2 + 1),
                                                   dtype=torch.bool, device=dev))
        u[:, c:c + TB, di:di + IB, 1 + dj:1 + dj + n2] |= need
    state_elems = sum(int(u.sum()) for u in used.values())
    vcells = B * int(valid.sum())
    cells = B * TB * IB * n2

    def entries(*pairs):
        m = torch.zeros((B, n2, n2), dtype=torch.bool, device=dev)
        for a, b, mask in pairs:
            a, b, mask = torch.broadcast_tensors(a, b, (mask & valid).expand(B, TB, IB, n2))
            bi = torch.arange(B, device=dev)[:, None, None, None].expand_as(a)
            m[bi[mask], a[mask], b[mask]] = True
        return int(m.sum())

    true = torch.ones_like(valid)
    pt_e = entries((iv, jv, true), (kv, lv, true), (iv, lv, true))
    can_e = entries((iv, jv, pij), (kv, lv, pkl), (iv, lv, pil))
    est_e = entries((iv, jv, gates[0]), (kv, lv, gates[4]), (iv, lv, gates[8]))
    nbytes = (2 * state_elems
              + 4 * B * int((valid & pij & cij).sum()) + 4 * B * int((valid & pkl & ckl).sum())
              + 4 * 8 * vcells + 4 * 2 * cells
              + 4 * pt_e + can_e + 4 * est_e
              + (5 * 4 + 8 * 2) * cells)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def store_bound(cuda_ops, args, kw):
    """(bytes, ms by bytes) of one ``span_store`` on its data: every
    destination element written once (2 B), and each source element of a
    valid cell read once (the 14 loop families' int32, the 8 assembled
    families' int16: 72 B a valid cell; every family has a destination
    that covers its valid rows)."""
    dests, loops, xs = args
    s, n, i0, TB, IB = (kw[k] for k in ("s", "n", "i0", "TB", "IB"))
    vcells = xs.shape[1] * int(cuda_ops.span_valid(n, s, i0, TB, IB, n + 2, xs.device).sum())
    nbytes = 2 * sum(d.view.numel() for d in dests) + (4 * len(loops) + 2 * len(xs)) * vcells
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def phase_span(cuda_ops, sp, bucket_dims, dev, ptxas=None):
    """Phase 2f: ``span_assemble`` and ``span_store`` against their plain
    versions on the card, exactly, at :func:`span_cases` (the fills' own
    calls, :func:`span_kernel_calls`); each row with the kernel's L2-hot
    (graph replay) and L2-cold (:func:`graph_cold_ms`) device times, the
    eager call's (the wrapper's host work and launch), the plain version's
    on the card, the bound (:func:`assemble_bound`, :func:`store_bound`)
    and the kernel's ``ptxas`` registers, spill and shared memory
    (``ptxas``: :func:`span_ptxas` of this run's build).  The store's
    result is its destination views after the kernel, against the same
    views filled with -7 and written by the plain version.  Returns the
    rows by kernel."""
    gen = torch.Generator(device=dev).manual_seed(6)
    emit({"phase": "span", "library": "none: no single PyTorch call assembles the "
          "recurrences' branches or writes a span into its slots, so library_ms is null "
          "for both kernels"})
    rows = {"span_assemble": [], "span_store": []}
    for case in span_cases(bucket_dims):
        with torch.inference_mode():       # the state's tensors are inference tensors
            span_case(cuda_ops, case, sp, gen, dev, rows, ptxas or {})
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def span_case(cuda_ops, case, sp, gen, dev, rows, ptxas):
    """One case of :func:`phase_span`: appends its two rows to ``rows``."""
    from ccj_tpu_torch.engine.common import INF

    (aa, akw), (sa, skw), st = span_kernel_calls(cuda_ops, case, sp, gen, dev)
    base = {"batch": case["B"], "i0": akw["i0"], "rows": akw["IB"], "TB": akw["TB"]}
    # ---- span_assemble ---------------------------------------------------
    want = cuda_ops.span_assemble_ref(*aa, **akw)
    before = cuda_ops.ASSEMBLE_LAUNCHES
    got = cuda_ops.span_assemble(*aa, **akw)
    torch.cuda.synchronize()
    check(cuda_ops.ASSEMBLE_LAUNCHES == before + 1, "a span_assemble made other than "
          "one launch")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    label = f"span_assemble {case['label']}"
    check(err == 0, f"{label} != plain: max |err| = {err}")
    check(bool((want.PLs < INF).any()) and bool((want.xs[7] < 32767).any()),
          f"{label}: no valid cell had a value")
    del got, want
    nbytes, t_bytes = assemble_bound(cuda_ops, aa, akw)

    def kern_a():
        cuda_ops.span_assemble(*aa, **akw)

    row = {"case": label, **base, "parts": max(len(p) for p in aa[0]), "bytes": nbytes,
           "max_abs_err": err, "ms": graph_ms(kern_a, reps=20, replays=5),
           "ms_l2cold": graph_cold_ms(kern_a), "call_ms": cuda_ms(kern_a, 10),
           "plain_ms": cuda_ms(lambda: cuda_ops.span_assemble_ref(*aa, **akw), 2),
           "bound_ms": t_bytes, "bound_by": "bytes", "library_ms": None,
           "ptxas": ptxas.get("span_assemble")}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
    rows["span_assemble"].append(row)
    emit({"phase": "span", **row})
    # ---- span_store -------------------------------------------------------
    dests = sa[0]
    before = cuda_ops.STORE_LAUNCHES
    cuda_ops.span_store(*sa, **skw)
    torch.cuda.synchronize()
    check(cuda_ops.STORE_LAUNCHES == before + 1, "a span_store made other than one launch")
    kernel_views = [d.view.clone() for d in dests]
    for d in dests:
        d.view.fill_(-7)
    cuda_ops.span_store_ref(*sa, **skw)
    err = max(int((d.view.long() - k.long()).abs().max())
              for d, k in zip(dests, kernel_views))
    label = f"span_store {case['label']}"
    check(err == 0, f"{label} != plain: max |err| = {err}")
    del kernel_views
    nbytes, t_bytes = store_bound(cuda_ops, sa, skw)

    def kern_s():
        cuda_ops.span_store(*sa, **skw)

    row = {"case": label, **base, "destinations": len(dests), "bytes": nbytes,
           "max_abs_err": err, "ms": graph_ms(kern_s, reps=20, replays=5),
           "ms_l2cold": graph_cold_ms(kern_s), "call_ms": cuda_ms(kern_s, 10),
           "plain_ms": cuda_ms(lambda: cuda_ops.span_store_ref(*sa, **skw), 2),
           "bound_ms": t_bytes, "bound_by": "bytes", "library_ms": None,
           "ptxas": ptxas.get("span_store")}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
    rows["span_store"].append(row)
    emit({"phase": "span", **row})


# ---------------------------------------------------------------------------
# phase 2g: span_v, span_wbp, span_wm and wx_tables, the span's 2-D recurrences
# ---------------------------------------------------------------------------

SPAN2D_KERNELS = ("span_v", "span_wbp", "span_wm", "wx_tables")
SPAN2D_REPLACES = {"span_v": "ccj_tpu/engine/nested.py:54",      # XLA fusions of the
                   "span_wbp": "ccj_tpu/engine/gapped.py:119",   # fill's span body,
                   "span_wm": "ccj_tpu/engine/nested.py:155",    # no Pallas kernel
                   "wx_tables": "ccj_tpu/engine/gapped.py:42"}


def span2d_cases(bucket_dims):
    """Phase 2g's shapes: the n=100 main span, n=128's, n=200 span 135
    (the packed fill keeps the 2-D matrices dense), a batch of four at
    bucket 100, dangles 0 and 1 at n=100's main span and the n=37 span 20
    (odd n2)."""
    s100 = main_span(100, bucket_dims)[0]
    s128 = main_span(128, bucket_dims)[0]
    base = dict(B=1, dangles=2)
    return [dict(base, label=f"n=100 s={s100}", n=100, s=s100),
            dict(base, label=f"n=128 s={s128}", n=128, s=s128),
            dict(base, label="n=200 s=135 (the packed fill's dense 2-D matrices)", n=200,
                 s=135),
            dict(base, label=f"bucket 100 x 4 s={s100}", n=100, s=s100, B=4),
            dict(base, label=f"n=100 s={s100} dangles 0", n=100, s=s100, dangles=0),
            dict(base, label=f"n=100 s={s100} dangles 1", n=100, s=s100, dangles=1),
            dict(base, label="n=37 s=20 (odd n2)", n=37, s=20)]


def span2d_state(B, n, gen, dev):
    """A random 2-D state [B, n2, n2], made on the host from ``gen``:
    energies in [-3000, 3000) with 10 % INF, 10 % TRI_UNSET and 5 % V_UNSET
    cells; Vtype in 0..3."""
    from ccj_tpu_torch.engine.common import INF, TRI_UNSET, V_UNSET

    n2 = n + 2
    st = {}
    for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP"):
        x = torch.randint(-3000, 3000, (B, n2, n2), generator=gen, dtype=torch.int32)
        u = torch.rand((B, n2, n2), generator=gen)
        x[u < 0.1] = INF
        x[(u >= 0.1) & (u < 0.2)] = TRI_UNSET
        x[(u >= 0.2) & (u < 0.25)] = V_UNSET
        st[k] = x.to(dev)
    st["Vtype"] = torch.randint(0, 4, (B, n2, n2), generator=gen, dtype=torch.int8).to(dev)
    return st


def span2d_bound(name, n, s, B, dangles, fill_call=False):
    """(bytes, ms by bytes) of one call of ``name`` at span s: each
    element of the state and the tables its live rows need read once (the
    union of their cells, array by array; the interior terms' EINT
    entries, which no two rows share) and each output written once
    (span_v: V and Vtype, 5 B a row; span_wbp: WBP and WPP, and with
    ``fill_call`` (the fills' call: the P-split minima and the kept
    tables) also a minimum read, P's cell written and the four tables'
    cells, the row's span-s WBP / WPP read for them; span_wm: WMv, WMp and
    WM; wx_tables: two [B, n2, n2] tables read and four written).  No
    arithmetic is worth counting: a few adds and mins a term."""
    from ccj_tpu_torch.engine.common import MAXLOOP, TURN

    n2 = n + 2
    if name == "wx_tables":
        nbytes = B * n2 * n2 * 4 * (2 + 4)
        return nbytes, nbytes / HBM_BYTES_PER_S * 1e3
    marks = {}

    def mark(key, a, c, ok=None):
        a, c = torch.broadcast_tensors(a, c)
        idx = a * n2 + c
        if ok is not None:
            idx = idx[torch.broadcast_to(ok, idx.shape)]
        marks.setdefault(key, torch.zeros(n2 * n2, dtype=torch.bool))[idx.reshape(-1)] = True

    i = torch.arange(1, n - s + 1)[:, None]          # the live rows
    j = i + s
    terms = 0
    if name == "span_v":
        for key in ("H", *{0: ("MB0",), 1: ("MB0", "MB_5", "MB_3", "MB_53"),
                           2: ("MB2",)}[dangles]):
            mark(key, i, j)
        L = min(MAXLOOP + 2, s - TURN - 1)
        if L >= 2:
            di = torch.arange(1, L)[None, :, None]
            dj = torch.arange(1, L)[None, None, :]
            ok = di + dj <= L
            mark("V", i[:, :, None] + di, j[:, :, None] - dj, ok)
            terms = (n - s) * int(ok.sum())
        if s >= 4:
            c = i + torch.arange(1, s - 2)[None, :]
            mark("WM", i + 1, c - 1, i + 1 < c - 1)
            mark("WMv", c, j - 1)
            mark("WMp", c, j - 1)
            if dangles == 1:
                mark("WM", i + 2, c - 1, i + 2 < c - 1)
                mark("WMp", c - 1, j - 1)
                mark("WMv", c, j - 2)
                mark("WMp", c, j - 2)
        writes = 5
    elif name == "span_wbp":
        g = torch.arange(s)[None, :]
        d = i + g
        for key in ("V", "P2"):
            mark(key, d, j)
        for key in ("WBP", "WPP"):
            mark(key, i, d - 1, (d - 1 >= 1) & (g > 0))
            if s >= 1:
                mark(key, i, j - 1)
            if fill_call:
                mark(key, i, j)
        writes = 8 + (4 + 4 + 16 if fill_call else 0)     # p_min read, P and tables
    else:
        if s < 3:
            return 0, 0.0
        k = i + torch.arange(s - TURN)[None, :]
        mark("V", k, j)
        for key in (("ML2",) if dangles == 2 else ("ML0",)) + (
                ("ML_ip1", "ML_jm1", "ML_both") if dangles == 1 else ()):
            mark(key, k, j)
        if dangles == 1:
            mark("V", k + 1, j, j - k - 1 > TURN)
            mark("V", k, j - 1, j - 1 - k > TURN)
            mark("V", k + 1, j - 1, j - k - 2 > TURN)
        mark("P2", k, j)
        mark("WM", i, k - 1, i < k - 1)
        for key in ("WM", "WMv", "WMp"):
            mark(key, i, j - 1)
        writes = 12
    nbytes = B * (4 * sum(int(m.sum()) for m in marks.values()) + 4 * terms
                  + writes * (n - s))
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def span2d_ptxas(log):
    """``ptxas_usage`` of the four 2-D kernels: {name: usage}, span_v and
    span_wm by dangles variant."""
    usage = ptxas_usage(log)

    def entry(key):
        return next((v for k, v in usage.items() if key in k), None)
    return {"span_v": {f"dangles{d}": entry(f"span_v_kernelILi{d}E") for d in (0, 1, 2)},
            "span_wbp": entry("span_wbp_kernel"),
            "span_wm": {f"dangles{d}": entry(f"span_wm_kernelILi{d}E") for d in (0, 1, 2)},
            "wx_tables": entry("wx_kernel")}


def span2d_pmin(B, n, gen, dev):
    """Random P-split minima [B, n2] as ``p_split`` gives them: energies
    in [-3000, 3000) with 30 % INF (no candidate)."""
    from ccj_tpu_torch.engine.common import INF

    x = torch.randint(-3000, 3000, (B, n + 2), generator=gen, dtype=torch.int32)
    x[torch.rand((B, n + 2), generator=gen) < 0.3] = INF
    return x.to(dev)


def span2d_calls(cuda_ops, C, st0, case, gen, dev):
    """Phase 2g's calls at one case: (kernel, positional arguments after
    C and the state, keyword arguments) per call -- span_v, span_wbp as the
    fills call it (random P-split minima, the kept weight tables made from
    ``st0``) and plain (P's diagonal written already, no tables),
    span_wm, wx_tables."""
    s, d, B, n = case["s"], case["dangles"], case["B"], case["n"]
    wx0 = cuda_ops.wx_tables_ref(C, {k: v.cpu() for k, v in st0.items()}).to(dev)
    return [("span_v", (s, d), {}),
            ("span_wbp", (s,), {"p_min": span2d_pmin(B, n, gen, dev), "wx": wx0}),
            ("span_wbp", (s,), {}),
            ("span_wm", (s, d), {}),
            ("wx_tables", (), {})]


def phase_span2d(cuda_ops, bucket_dims, dev, ptxas=None):
    """Phase 2g: ``span_v``, ``span_wbp``, ``span_wm`` and ``wx_tables``
    against their plain versions on the card, exactly, at
    :func:`span2d_cases`, each on a random state (:func:`span2d_state`)
    with the bench sequences' tables (one sequence an element of a batch):
    the whole 2-D state after the kernel against the same state after the
    plain version (``wx_tables``: its four tables), one launch a call;
    ``span_wbp`` twice, as the fills call it (random P-split minima, the
    kept weight tables written; :func:`span2d_calls`) and without them;
    each row with the kernel's L2-hot (graph replay) and L2-cold
    (:func:`graph_cold_ms`) device times, the eager call's (the wrapper's
    checks, table and launch), the plain version's on the card, the bound
    (:func:`span2d_bound`) and the ``ptxas`` report; each case's
    ``span_wm`` -> ``span_v`` pair back to back (:func:`span2d_pair`) and
    its ``span_store`` -> ``span_wm`` pair, ``span_wm`` dependent and plain
    (:func:`span2d_store_pair`; the primary is the n=100 main span's
    ``span_store`` on a random state, :func:`span_kernel_calls`).  The
    tables are the fills': EINT cell-major.  Then the kept tables of three
    fills against a from-scratch ``wx_tables`` after every span
    (:func:`kept_tables_check`).  Returns the rows by kernel, the
    ``span_v`` pairs, the ``span_wm`` pairs and the fills' check."""
    from ccj_tpu_torch.engine import fold
    from ccj_tpu_torch.engine.nested import cell_major_eint
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    gen = torch.Generator().manual_seed(7)
    emit({"phase": "span2d", "library": "none: no single PyTorch call computes a span of "
          "these recurrences, so library_ms is null for the four kernels"})
    store_case = span_cases(bucket_dims)[0]
    _assemble, store, store_state = span_kernel_calls(
        cuda_ops, store_case, scale_parameters(parse_par(
            ROOT / "ccj_tpu_torch" / "params" / "rna_DirksPierce09.par")),
        torch.Generator(device=dev).manual_seed(8), dev)
    pair_rows, store_pair_rows = [], []
    rows = {k: [] for k in SPAN2D_KERNELS}
    counters = {"span_v": "SPAN_V_LAUNCHES", "span_wbp": "SPAN_WBP_LAUNCHES",
                "span_wm": "SPAN_WM_LAUNCHES", "wx_tables": "WX_LAUNCHES"}
    for case in span2d_cases(bucket_dims):
        n, s, B, d = case["n"], case["s"], case["B"], case["dangles"]
        sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                        / "rna_DirksPierce09.par"), dangles=d)
        Cs = []
        for b in range(B):
            tabs = build_seq_tables(bench_seq(n, seed=42 + b), sp, DEFAULT_PK)
            Cs.append(fold.consts_from_numpy(fold.build_consts(tabs, sp, DEFAULT_PK), dev,
                                             sc4_np={})[0])
        # a batch of one as the fills hold it: a view of the tables, some of
        # them column-major as numpy gives them, EINT cell-major
        C = cell_major_eint({**(fold.add_batch(Cs[0]) if B == 1 else fold.stack_consts(Cs)),
                             "n": n})
        st0 = span2d_state(B, n, gen, dev)
        pair_rows.append(span2d_pair(cuda_ops, C, st0, case))
        store_pair_rows.append(span2d_store_pair(cuda_ops, C, st0, case, store))
        for name, args, kw in span2d_calls(cuda_ops, C, st0, case, gen, dev):
            kern, plain = getattr(cuda_ops, name), getattr(cuda_ops, f"{name}_ref")
            fills_call = bool(kw)
            got = {k: v.clone() for k, v in st0.items()}
            want = {k: v.clone() for k, v in st0.items()}
            kw_k = {k: v.clone() for k, v in kw.items()}
            kw_p = {k: v.clone() for k, v in kw.items()}
            before = getattr(cuda_ops, counters[name])
            out_k = kern(C, got, *args, **kw_k)
            torch.cuda.synchronize()
            check(getattr(cuda_ops, counters[name]) == before + 1,
                  f"a {name} call made other than one launch")
            out_p = plain(C, want, *args, **kw_p)
            label = f"{name} {case['label']}" + (
                " (the fills' call: P-split minima, kept tables)" if fills_call else "")
            if name == "wx_tables":
                pairs = list(zip(out_k, out_p))
            else:
                pairs = [(got[k], want[k]) for k in st0] + [(kw_k[k], kw_p[k]) for k in kw]
                check(any(not torch.equal(want[k], st0[k]) for k in st0),
                      f"{label}: the plain version wrote nothing")
            if fills_call:
                check(not torch.equal(kw_p["wx"], kw["wx"]),
                      f"{label}: the plain version wrote no table cell")
            err = max(int((g.long() - w.long()).abs().max()) for g, w in pairs)
            check(err == 0, f"{label} != plain: max |err| = {err}")
            nbytes, t_bytes = span2d_bound(name, n, s, B, d, fill_call=fills_call)

            def call(kern=kern, got=got, args=args, kw=kw_k):
                kern(C, got, *args, **kw)

            row = {"case": label, "batch": B, "n": n, "s": s, "dangles": d,
                   "fills_call": fills_call, "bytes": nbytes, "max_abs_err": err,
                   "ms": graph_ms(call, reps=20, replays=5),
                   "ms_l2cold": graph_cold_ms(call), "call_ms": cuda_ms(call, 20),
                   "plain_ms": cuda_ms(lambda: plain(C, want, *args, **kw_p), 3),
                   "bound_ms": t_bytes, "bound_by": "bytes", "library_ms": None,
                   "ptxas": (ptxas or {}).get(name)}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["share_of_bound_l2cold"] = row["bound_ms"] / row["ms_l2cold"]
            rows[name].append(row)
            emit({"phase": "span2d", **row})
    del _assemble, store, store_state
    torch.cuda.empty_cache()
    kept = kept_tables_check(cuda_ops, dev)
    emit({"phase": "span2d_kept_tables", **kept})
    return rows, pair_rows, store_pair_rows, kept


def span2d_pair(cuda_ops, C, st0, case):
    """``span_wm`` of span s - 1, then ``span_v`` of span s, back to back
    (the fills' order from one span to the next; ``span_v`` a programmatic
    dependent launch of ``span_wm``, as the fills make it from their second
    span on), exactly against the plain pair; its device ms a pair (20
    pairs in one CUDA graph)."""
    s, d = case["s"], case["dangles"]
    got = {k: v.clone() for k, v in st0.items()}
    want = {k: v.clone() for k, v in st0.items()}

    def pair():
        cuda_ops.span_wm(C, got, s - 1, d)
        cuda_ops.span_v(C, got, s, d, dependent=True)

    pair()
    torch.cuda.synchronize()
    cuda_ops.span_wm_ref(C, want, s - 1, d)
    cuda_ops.span_v_ref(C, want, s, d)
    err = max(int((got[k].long() - want[k].long()).abs().max()) for k in st0)
    check(err == 0, f"span_wm -> span_v pair {case['label']} != plain: max |err| = {err}")
    row = {"case": case["label"], "max_abs_err": err,
           "pair_ms": graph_ms(pair, reps=20, replays=5)}
    emit({"phase": "span2d_pair", **row})
    return row


def span2d_store_pair(cuda_ops, C, st0, case, store):
    """``span_store`` (``store``: the (args, keywords) of the n=100 main
    span's, whose destinations are the views of a random 4-D state), then
    ``span_wm`` of the case's span on its 2-D state, as a fill's span ends
    (``fold._run_spans``): ``span_wm`` launched as a programmatic dependent
    of ``span_store``, as the fills launch it, and plainly.  A timing of
    the overlap: the device ms of each pair (20 pairs in one CUDA graph)
    and what the dependent launch saves.  Each ``span_wm`` is checked
    exactly against the plain version, which shows its dependent launch
    computes its cells; the two kernels share no memory here, so no race
    could show.  What holds the dependent launch's condition (the kernel
    before it writes none of its operands) are the fills' results, which
    run with it (phases 4-10), and the CPU test of the fills' dispatch
    order and storage (``tests/test_torch_nested.py``)."""
    sa, skw = store
    s, d = case["s"], case["dangles"]
    want = {k: v.clone() for k, v in st0.items()}
    cuda_ops.span_wm_ref(C, want, s, d)
    row = {"case": case["label"], "primary": f"span_store n={skw['n']} s={skw['s']}"}
    for label, dependent in (("dependent", True), ("plain", False)):
        got = {k: v.clone() for k, v in st0.items()}

        def pair(got=got, dependent=dependent):
            cuda_ops.span_store(*sa, **skw)
            cuda_ops.span_wm(C, got, s, d, dependent)

        pair()
        torch.cuda.synchronize()
        err = max(int((got[k].long() - want[k].long()).abs().max()) for k in st0)
        check(err == 0, f"span_store -> span_wm ({label}) {case['label']} != plain: "
              f"max |err| = {err}")
        row[f"{label}_max_abs_err"] = err
        row[f"{label}_pair_ms"] = graph_ms(pair, reps=20, replays=5)
    row["saved_ms"] = row["plain_pair_ms"] - row["dependent_pair_ms"]
    emit({"phase": "span2d_store_pair", **row})
    return row


def kept_tables_check(cuda_ops, dev):
    """The fills' kept weight tables (``gapped.WX``, made once a fill,
    written by ``span_wbp``) against a from-scratch ``wx_tables`` of the
    state after every span's WBP/WPP update, on the card: the n=100 fill
    (V(1, 100) checked), the packed fill of the n=134 anchor and a P=2
    row-sharded fill at n=100 on one card (each device's replica with its
    own tables).  Raises on the first difference; returns the spans
    checked per fill."""
    from ccj_tpu_torch.dist import wavefront
    from ccj_tpu_torch.engine import fold, gapped
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                    / "rna_DirksPierce09.par"))
    out = {}
    for label, n, mod, run in (
            ("fill6 n=100", 100, fold, lambda C, SC4, n: fold.fill6(C, SC4, n, sp.dangles)),
            ("fill7 n=134", 134, fold,
             lambda C, SC4, n: fold.fill7(C, SC4, n, sp.dangles, segments7(n))),
            ("fill6_sharded n=100 P=2", 100, wavefront,
             lambda C, SC4, n: wavefront.fill6_sharded(C, SC4, n, sp.dangles,
                                                       [dev, dev]))):
        seq = bench_seq(n) if n == 100 else anchor_line(n)[0]
        tabs = build_seq_tables(seq, sp, DEFAULT_PK)
        C, SC4 = fold.consts_from_numpy(fold.build_consts(tabs, sp, DEFAULT_PK), dev)
        real, spans = mod.compute_WBP_WPP_span, []

        def checked(Cf, st, s, p_min=None, real=real, spans=spans, label=label):
            real(Cf, st, s, p_min)
            bare = {k: v for k, v in Cf.items() if k != gapped.WX}
            check(torch.equal(Cf[gapped.WX], gapped._wx_tables(bare, st)),
                  f"{label}: the kept weight tables differ from wx_tables after span {s}")
            spans.append(s)
            return st

        mod.compute_WBP_WPP_span = checked
        try:
            st = run(C, SC4, n)
        finally:
            mod.compute_WBP_WPP_span = real
        check(spans == list(range(n)), f"{label}: spans checked {spans[:3]}...")
        if n == 100 and mod is fold:
            check(int(st["V"][1, n]) == BENCH_V100, f"{label}: V(1, 100) != {BENCH_V100}")
        out[label] = len(spans)
        del st
        torch.cuda.empty_cache()
    return {"spans_checked": out, "all_equal": True}


def max_rel_err(got, want):
    """Largest |got - want| / max(|got|, |want|) over two arrays (0 where
    both are 0)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-300)
    return float((np.abs(got - want) / den).max())


# ---------------------------------------------------------------------------
# phase 11: the partition function and its seven span kernels
# ---------------------------------------------------------------------------

PF_KERNELS = ("pf_tt_span", "pf_history", "pf_stencil", "pf_p_split", "pf_span2d",
              "pf_assemble", "pf_store")
PF_COUNTERS = {"pf_tt_span": "PF_TT_SPAN_LAUNCHES", "pf_history": "PF_HISTORY_LAUNCHES",
               "pf_stencil": "PF_STENCIL_LAUNCHES", "pf_p_split": "PF_PSPLIT_LAUNCHES",
               "pf_span2d": "PF_SPAN2D_LAUNCHES", "pf_assemble": "PF_ASSEMBLE_LAUNCHES",
               "pf_store": "PF_STORE_LAUNCHES"}
PF_NEW = ("pf_span2d", "pf_assemble", "pf_store")   # csrc/pfbody.cu; the rest pfspan.cu
# relative error against the plain version (the four kernels of
# pfspan.cu; in float32 the three of pfbody.cu, which may sum up to 33 x 33
# terms a cell in another order than torch.sum's, within 1e-5: pf_rtol)
PF_RTOL = {torch.float64: 1e-13, torch.float32: 2e-6}
PF_SPANS = (20, 40, 62)      # phase 11's kernel checks at n=64
# the spans each kernel is checked at: pf_span2d and pf_store launch at
# every span, so s = 0 and 1 too
PF_CHECK_SPANS = {k: ((0, 1) if k in ("pf_span2d", "pf_store") else ()) + PF_SPANS
                  for k in PF_KERNELS}
PF_DEVICE_OPS_CEILING = 1500  # the n=64 float32 fill's device operations
PF_REPLACES = {"pf_tt_span": REPLACES,                       # _minplus_kernel's (+, x) form
               "pf_history": "ccj_tpu/engine/pf4d.py:312",   # XLA fusions of the JAX
               "pf_stencil": "ccj_tpu/engine/pf4d.py:359",   # PF span step, no Pallas
               "pf_p_split": "ccj_tpu/engine/pf4d.py:206",   # kernel
               "pf_span2d": "ccj_tpu/engine/pf4d.py:164",
               "pf_assemble": "ccj_tpu/engine/pf4d.py:297",
               "pf_store": "ccj_tpu/engine/pf4d.py:581"}
FP64_OPS_PER_S = 34e12      # H100 SXM non-tensor-core float64 peak (NVIDIA data sheet)
# the n=64 float32 fill with every piece eager, before the PF kernels: not
# measured in this run; printed under its own key as the yardstick
PF_EAGER = {"fill_s": 14.52, "device_launches": 797597, "device_busy_s": 2.77,
            "measured": "by this phase before the PF kernels, "
                        "on an NVIDIA H100 80GB HBM3 at 700 W"}


def pf_counts(n):
    """The PF kernels' launches in one fill of length n, from their
    bounds: a span has a valid cell where it has a tt step (s >= 2) and a
    live row (i >= 1, i + s <= n: s <= n - 1); the P split also needs a
    term (s >= 3); the 2-D part and the write-back run at every span."""
    cells = sum(1 for s in range(n) if 2 <= s <= n - 1)
    return {"pf_tt_span": cells, "pf_history": cells, "pf_stencil": cells,
            "pf_p_split": sum(1 for s in range(n) if 3 <= s <= n - 1),
            "pf_span2d": n, "pf_assemble": cells, "pf_store": n}


def pf_launches(pf_ops):
    return {k: getattr(pf_ops, c) for k, c in PF_COUNTERS.items()}


def pf_reset(pf_ops):
    for c in PF_COUNTERS.values():
        setattr(pf_ops, c, 0)


def pf_kernel_calls(n, spans, dtype, dev, visit, sp=None):
    """Fill the bench sequence's partition function at length n on
    ``dev`` span by span (``pf4d.pf_span_step``, as ``pf_fill_device``
    does); in each span of ``spans`` every call of a PF kernel's wrapper
    goes to ``visit(name, s, wrapper, plain, args, kw)`` instead, and the
    fill takes what it returns (the operands are the fill's own, read
    before the span writes the state), through ``pf_span_step``'s
    ``kernels``.  Returns the final state."""
    from types import SimpleNamespace

    from ccj_tpu_torch.engine import pf4d, pf_ops
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    if sp is None:
        sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                        / "rna_DirksPierce09.par"))
    tabs = build_seq_tables(bench_seq(n), sp, DEFAULT_PK)
    C, _, _ = pf4d.build_pfc(tabs, sp, DEFAULT_PK, dtype=dtype, device=dev)
    st = pf4d.init_pf_state(n, dtype, dev)
    wx = pf4d.pf_wx_tables(C, st, n)

    def spy(name, s):
        def call(*args, **kw):
            return visit(name, s, getattr(pf_ops, name), getattr(pf_ops, name + "_ref"),
                         args, kw)
        return call
    with torch.no_grad():
        for s in range(n):
            kernels = SimpleNamespace(**{k: spy(k, s) for k in PF_KERNELS}) \
                if s in spans else None
            TB, IB = bucket_dims(n, s)
            pf4d.pf_span_step(C, st, s, n=n, TB=TB, IB=IB, kernels=kernels, wx=wx)
    return st


def pf_store_views(st, n, s, TB):
    """The views of the state ``pf_store`` writes at span s: each family's
    and C skew's plane [:TB, s], PKD's [:, s] and PKE's planes [tt, s - tt]
    for tt <= min(s, T - 1) (one strided view)."""
    from ccj_tpu_torch.engine.gapped import C_MATS, M4_NAMES

    T, n2 = n - 1, n + 2
    pke = st["PKE"]
    return ([st[k][:TB, s] for k in M4_NAMES] + [st["C_" + k][:TB, s] for k in C_MATS]
            + [st["PKD"][:, s],
               pke.as_strided((min(s, T - 1) + 1, n2, n2),
                              (pke.stride(0) - pke.stride(1), n2, 1),
                              pke.storage_offset() + s * pke.stride(1))])


def pf_flat(x):
    """The tensors of a PF wrapper's result in a fixed order: the tensor
    itself, or ``pf_assemble``'s (families, bases) by name."""
    if isinstance(x, torch.Tensor):
        return [x]
    fams, bases = x
    return [fams[k] for k in sorted(fams)] + [bases[k] for k in sorted(bases)]


def pf_pair(name, fn, ref, args, kw):
    """A PF kernel's wrapper and its plain version on the same operands:
    (result, got, want, call, plain).  ``result`` is what the fill takes
    (the kernel's); ``got`` / ``want`` the tensors to compare; ``call`` /
    ``plain`` run the kernel / the plain version again on the same operands
    for timing.  The in-place kernels: ``pf_span2d`` against its plain
    version on a copy of the 2-D state and the kept tables (both read only
    cells neither writes, so a second run writes the same); ``pf_store``'s
    destination views set to NaN before each of the two runs, so an
    element the kernel leaves unwritten shows."""
    from ccj_tpu_torch.engine.pf_ops import PF_2D

    def call():
        return fn(*args, **kw)
    if name == "pf_span2d":
        C, st, p_new, wx = args
        st2 = {**st, **{k: st[k].clone() for k in PF_2D}}
        wx2 = {k: v.clone() for k, v in wx.items()}
        call()
        ref(C, st2, p_new, wx2, **kw)
        return (None, [st[k] for k in PF_2D] + [wx[k] for k in sorted(wx)],
                [st2[k] for k in PF_2D] + [wx2[k] for k in sorted(wx2)], call,
                lambda: ref(C, st2, p_new, wx2, **kw))
    if name == "pf_store":
        views = pf_store_views(args[0], kw["n"], kw["s"], kw["TB"])
        out = []
        for run in (call, lambda: ref(*args, **kw)):
            for v in views:
                v.fill_(float("nan"))
            run()
            out.append([v.clone() for v in views])
        return None, out[0], out[1], call, lambda: ref(*args, **kw)
    got = call()
    torch.cuda.synchronize()
    return got, pf_flat(got), pf_flat(ref(*args, **kw)), call, lambda: ref(*args, **kw)


def pf_rel_err(got, want):
    """Largest |got - want| / max(|got|, |want|) over two tensors on the
    card (0 where both are 0)."""
    den = torch.maximum(got.abs(), want.abs())
    return float(torch.where(den > 0, (got - want).abs() / den.clamp_min(1e-300), 0.0).max())


def pf_cells(n, s, IB):
    """The span's valid cells as arrays (tt, i, jr): live rows i, tt in
    [0, s - 2], j = i + jr in [i, i + s - tt - 2]."""
    import numpy as np

    tt, i, jr = [], [], []
    for r in range(1, min(n - s, IB - 1) + 1):
        for t in range(s - 1):
            m = s - t - 1
            tt.append(np.full(m, t))
            i.append(np.full(m, r))
            jr.append(np.arange(m))
    if not tt:
        return (np.zeros(0, int),) * 3
    return np.concatenate(tt), np.concatenate(i), np.concatenate(jr)


_PF_WORK = {}


def pf_work(name, n, s, TB, IB):
    """({operand: elements moved}, multiply-adds, extra bytes) of one PF
    kernel call at span s, as this run's shapes fix them.  Each input
    element the function needs is counted once (the distinct cells of each
    state array and weight table it reads, by the operand's name; ``cells``:
    the per-cell inputs and the outputs of the span's valid cells), and
    the terms are those of the sums the recurrences define.  The count is
    data-independent: any valid cell of the state or of a slab may be
    nonzero, so every weight that multiplies one is needed and every term
    that reads one.  Extra bytes: ``ptype`` at 4 and ``can_pair`` at 1 a
    cell."""
    import numpy as np

    key = (name, n, s)
    if key in _PF_WORK:
        return _PF_WORK[key]
    n2, T, S = n + 2, n - 1, n
    U = n2 + T
    DS_, ML_, TURN_ = 29, 30, 3
    tt, i, jr = pf_cells(n, s, IB)
    j = i + jr
    ncell = len(tt)

    def pos(x):
        return np.clip(x, 0, None)

    def distinct(shape, marks):
        m = np.zeros(int(np.prod(shape)), bool)
        for idx in marks:
            m[np.ravel_multi_index(idx, shape)] = True
        return int(m.sum())

    def line(a0, b0, da, db, cnt):
        """The cells (a0 + m da, b0 + m db), m in [0, cnt), of each entry."""
        cnt = pos(cnt)
        idx = np.repeat(np.arange(len(cnt)), cnt)
        m = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        return a0[idx] + da * m, b0[idx] + db * m

    def rect(d1m, d2m, summ=None):
        """(d1, d2, cell index) of every term d1 <= d1m, d2 <= d2m (and
        d1 + d2 <= summ)."""
        for d1 in range(1, DS_ + 1):
            for d2 in range(1, DS_ + 1):
                sel = (d1 <= d1m) & (d2 <= d2m)
                if summ is not None:
                    sel &= d1 + d2 <= summ
                if sel.any():
                    yield d1, d2, sel

    if name == "pf_tt_span":
        k = j + tt + 2
        d1m, d2m = np.minimum(DS_, jr - 1), np.minimum(DS_, s - tt - jr - 3)
        hi, hk, hj = s - 2, s - 3 - jr, jr + tt - 1

        # the shrinks' terms tp in (tt, h] whose source cell is a valid one:
        # a j-shrink's slab[tp, i, j + tt - tp] needs tp <= jr + tt, a
        # k-shrink's slab[tp, i, j] tp <= s - 2 - jr and its weight's
        # column k + tp - tt - 1 <= n2 - 1
        def tj(h):
            return pos(np.minimum(h, jr + tt) - tt)

        def tk(h):
            return pos(np.minimum(np.minimum(h, s - 2 - jr), n2 + tt - k) - tt)
        terms = (pos(d1m) * pos(d2m) + 3 * tj(hi) + 4 * tj(np.minimum(hi, hj))
                 + 3 * tk(hi) + 3 * tk(np.minimum(hi, hk)))
        dpm = distinct((DS_, DS_, T, U), ((np.full(sel.sum(), d1 - 1), np.full(sel.sum(), d2 - 1),
                                            tt[sel], (j + tt)[sel])
                                           for d1, d2, sel in rect(d1m, d2m)))
        # the weights: a j-shrink's X[j', j] for j' in (j - tj(h), j], a
        # k-shrink's X[k, k'] for k' in [k, k + tk(h)); WB and WBPg up to
        # s - 2 (WB's j1 sum is inside that), WP under the j1 / k1 bounds
        def shrinks(hj_, hk_):
            return (line(j, j, -1, 0, tj(hj_)), line(k, k, 0, 1, tk(hk_)))
        elems = {tab: distinct((n2, n2), shrinks(*h)) for tab, h in (
            ("WB", (hi, hi)), ("WBPg", (hi, hi)),
            ("WP", (np.minimum(hi, hj), np.minimum(hi, hk))))}
        pm = distinct((n2, n2), ((j, k),))                 # the PM step's (j, k) pairs
        x = (jr >= 1) & (jr <= s - tt - 3)                 # PM[tt + 2, i, j - 1] valid
        elems.update(cells=(10 + 14) * ncell, DPM=dpm, scalars=4,
                     expESTP=distinct((n2, n2), ((j[x] - 1, k[x] + 1),)))
        work = (elems, int(terms.sum()), 5 * pm)           # + ptype / can_pair bytes
    elif name == "pf_history":
        from ccj_tpu_torch.engine.pf_ops import PF_HISTORY

        sp0 = max(s - TB, 0)
        terms, lo_of, w_of = 0, {}, {"WB": [], "WP": [], "WBPg": []}
        for mode, fam, tab, g1 in PF_HISTORY:
            lo = np.full(ncell, sp0)
            if g1:
                lo = np.maximum(lo, s - jr + 1 if mode == "RI" else jr + tt + 3)
            terms += int(pos(s - lo).sum())
            src = fam if mode == "RL" else "C_" + fam
            lo_of[src] = lo if src not in lo_of else np.minimum(lo_of[src], lo)
            # a row's weights over sp in [lo, s - 1]: RL X[i + sp + 1, i + s],
            # RI X[i, i + s - sp - 1]
            rlo = np.full(n2, s)
            np.minimum.at(rlo, i, lo)
            r = np.unique(i)
            w_of[tab].append(
                line(r + rlo[r] + 1, r + s, 1, 0, s - rlo[r]) if mode == "RL"
                else line(r, r + s - rlo[r] - 1, 0, -1, s - rlo[r]))
        elems = {"cells": 16 * ncell, **{src: int(pos(s - lo).sum()) for src, lo in lo_of.items()},
                 **{tab: distinct((n2, n2), marks) for tab, marks in w_of.items()}}
        work = (elems, terms, 0)
    elif name == "pf_stencil":
        # each family's terms whose source cell is a valid one: PL's
        # PL[tt + d2, s - d1, i + d1, j - d2] needs d1 + d2 <= min(jr,
        # s - tt - 2), PR's PR[tt + d1, s - d2, i, j] d1 + d2 <= s - tt - jr
        # - 2; PO's bounds keep its sources valid
        st_shape = (T, S, n2, n2)
        pl = (np.minimum(np.minimum(DS_, s), n2 - 1 - i), np.minimum(np.minimum(DS_, T - 1 - tt), j),
              np.minimum(jr, s - tt - 2))
        pr = (np.minimum(DS_, T - 1 - tt), np.full(ncell, min(DS_, s)), s - tt - jr - 2)
        po = (np.minimum(DS_, jr - 1), np.minimum(DS_, s - tt - jr - 3))
        terms = sum(int(x.sum()) for b in (pl, pr, po) for _, _, x in rect(*b))

        def marks(bounds, idx, weight):
            """The cell of each term of the rectangle ``bounds``:
            ``idx(d1, d2)``'s index arrays over the span's cells, led by
            (d1 - 1, d2 - 1) in a weight table."""
            for d1, d2, x in rect(*bounds):
                lead = (np.full(x.sum(), d1 - 1), np.full(x.sum(), d2 - 1)) if weight else ()
                yield lead + tuple(np.broadcast_to(a, x.shape)[x] for a in idx(d1, d2))
        elems = {
            "cells": 3 * ncell,
            "PL": distinct(st_shape, marks(pl, lambda d1, d2: (tt + d2, s - d1, i + d1, j - d2),
                                           False)),
            "W4PL": distinct((DS_, DS_, n2, n2), marks(pl, lambda d1, d2: (i, j), True)),
            "PR": distinct(st_shape, marks(pr, lambda d1, d2: (tt + d1, s - d2, i, j), False)),
            "W4PR": distinct((DS_, DS_, n2 + T + 2, 2 * n2),
                             marks(pr, lambda d1, d2: (j + tt + 2, s + i), True)),
            "PO": distinct(st_shape, marks(po, lambda d1, d2: (tt, s - d1 - d2, i + d1, j),
                                           False)),
            "W4POD": distinct((DS_, DS_, n2, n2), marks(po, lambda d1, d2: (i, s), True))}
        work = (elems, terms, 0)
    elif name == "pf_span2d":
        # the live rows i (l = i + s): V's interior terms (dk, dl) and
        # multiloop splits c in [i + 1, l - 4], WBP / WPP's g in [0, s - 1],
        # WM's k in [i, l - 4] (s >= 3); the row's span-s cells written
        rows = np.arange(1, n - s + 1)
        nl, el = len(rows), rows + s
        wm = s >= 3
        g = max(s - TURN_ - 1, 0)
        vd, n_int = [], 0
        for dk in range(1, min(s - TURN_ - 1, ML_) + 1):
            for dl in range(1, min(s - TURN_ - 1, ML_ + 2) - dk + 1):
                r = rows[rows + dk <= n2 - 1]
                n_int += len(r)
                vd.append((np.full(len(r), s - dk - dl), r + dk))
        own = ((rows, el - 1),) if wm else ()
        full = np.full(nl, g)
        elems = {
            "cells": 2 * n2 + nl * (7 + 3 * wm), "p_new": nl, "HD": nl,
            "expMB": nl if g else 0, "EINTD": n_int, "VD": distinct((S + 1, n2), vd),
            "WM": distinct((n2, n2), (line(rows + 1, rows, 0, 1, full),
                                      line(rows, rows, 0, 1, full), *own)),
            **{k: distinct((n2, n2), (line(rows + 1, el - 1, 1, 0, full), *own))
               for k in ("WMv", "WMp")},
            **dict.fromkeys(("V", "P2"), nl * max(s - 1, 0)),
            **dict.fromkeys(("WBP", "WPP"), nl if s >= 1 else 0),
            **{k: distinct((n2, n2), (line(rows, rows - 1, 0, 1, np.full(nl, s)),))
               for k in ("WB", "WP")},
            "expML": distinct((n2, n2), (((rows, el),) if wm else ())
                              + (line(rows + 1, el, 1, 0, full),)),
            "expMLbase": len(set(range(g)) | (set(range(s - 3)) | {1} if wm else set())),
            **dict.fromkeys(("expcp", "expPUP"), len({min(s + 1, n2 - 1)} | ({1} if s else set()))),
            "scalars": 6}
        # interior, the splits' two products, WBP / WPP's four sums, WM's
        # three products a split
        work = (elems, n_int + nl * (2 * g + 4 * s + (3 * (g + 1) if wm else 0)), 0)
    elif name == "pf_assemble":
        from ccj_tpu_torch.engine.pf_ops import PF_PLANE_READS

        # each plane read's source cell where it is a valid state cell and
        # its branch reads it (the b3 reads under their bounds)
        k, el = j + tt + 2, i + s
        bounds = {"PfromL": jr >= TURN_ + 1, "PfromR": el >= k + TURN_ + 1,
                  "PfromO": el >= i + TURN_ + 1}
        marks, oks = {}, []
        for fam, c, b, di, dj in PF_PLANE_READS:
            a, sp, r, col = tt + c, s - b, i + di, j + dj
            ok = ((a < T) & (sp >= 0) & (r < n2) & (col >= 0) & (col < n2) & (a <= sp - 2)
                  & (r >= 1) & (col >= r) & (col + a + 2 <= r + sp) & (r + sp <= n)
                  & bounds.get(fam, True))
            marks.setdefault(fam, []).append((a[ok], np.full(ok.sum(), sp), r[ok], col[ok]))
            oks.append(ok)
        pairs = ((i, j), (k, el), (i, el))               # PL's, PR's and PO's tables
        elems = {"cells": 8 * TB * IB * n2, "hist": 9 * ncell, "stn": 3 * ncell, "scalars": 4,
                 **{fam: distinct((T, S, n2, n2), m) for fam, m in marks.items()},
                 "expESTP": distinct((n2, n2), ((a[oks[q]], b[oks[q]])
                                                for q, (a, b) in zip((0, 4, 8), pairs)))}
        # ~35 operations a valid cell; ptype at 4 B and can_pair at 1 B a pair
        work = (elems, 18 * ncell, 5 * distinct((n2, n2), pairs))
    elif name == "pf_store":
        # every destination element written once; the slabs' valid cells
        # read (the loop's 14 families, the 8 others)
        work = ({"cells": (27 * TB + T + min(s, T - 1) + 1) * n2 * n2, "loops": 14 * ncell,
                 "fams": 8 * ncell}, 0, 0)
    else:       # pf_p_split: C(s, 3) terms a live row, each reading its own two cells
        rows = max(0, n - s)
        terms = rows * math.comb(s, 3)
        work = ({"cells": rows, "PKE": terms, "PKD": terms}, terms, 0)
    _PF_WORK[key] = work
    return work


def pf_bound(name, n, s, TB, IB, dtype):
    """(bound_ms, bound_by, bytes, flops) of one call: the bytes over the
    card's memory rate against the multiply-adds (2 operations each) over
    its float32 / float64 rate."""
    elems, terms, extra = pf_work(name, n, s, TB, IB)
    size = torch.finfo(dtype).bits // 8
    nbytes, flops = sum(elems.values()) * size + extra, 2 * terms
    rate = FP64_OPS_PER_S if dtype == torch.float64 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def pf_rtol(name, dtype):
    """The relative error a PF kernel may show against its plain version."""
    return 1e-5 if dtype == torch.float32 and name in PF_NEW else PF_RTOL[dtype]


def pf_kernel_row(rows, n, dtype, timed, name, s, fn, ref, args, kw):
    """A :func:`pf_kernel_calls` visit: at the kernel's
    :data:`PF_CHECK_SPANS`, the kernel against its plain version on the
    fill's own operands (:func:`pf_pair`), within :func:`pf_rtol`; with
    ``timed`` its L2-hot and L2-cold device times, its eager call's, the
    plain version's eager call's and its bound.  Returns the kernel's
    result."""
    if s not in PF_CHECK_SPANS[name]:
        return fn(*args, **kw)
    result, got, want, call, plain = pf_pair(name, fn, ref, args, kw)
    torch.cuda.synchronize()
    tol = pf_rtol(name, dtype)
    label = f"{name} n={n} s={s} {str(dtype)[6:]}"
    check(len(got) == len(want) and all(
              g.shape == w.shape and bool(torch.isfinite(g).all()) for g, w in zip(got, want)),
          f"{label}: shapes {[tuple(g.shape) for g in got]} / "
          f"{[tuple(w.shape) for w in want]} or not finite")
    err = max(pf_rel_err(g, w) for g, w in zip(got, want))
    check(err <= tol, f"{label}: max rel err {err} > {tol}")
    row = {"kernel": name, "case": f"n={n} s={s}", "dtype": str(dtype)[6:],
           "max_rel_err": err, "rtol": tol,
           "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "nonzero": sum(int((g != 0).sum()) for g in got)}
    if timed:
        TB, IB = kw.get("TB", 0), kw.get("IB", n + 2)
        row.update(ms=graph_ms(call, reps=10, replays=5),
                   ms_l2cold=graph_cold_ms(call, reps=10, replays=2),
                   call_ms=cuda_ms(call, 10),
                   plain_ms=cuda_ms(plain, 2))
        bound_ms, by, nbytes, flops = pf_bound(name, n, s, TB, IB, dtype)
        row.update(bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=flops,
                   share_of_bound=bound_ms / row["ms"],
                   share_of_bound_l2cold=bound_ms / row["ms_l2cold"], library_ms=None)
    rows.append(row)
    emit({"phase": "pf_kernel", **row})
    return result


def pf_fill_err(got, want):
    """Largest relative difference of two PF fill results over every 2-D
    matrix, W and every 4-D array."""
    worst = max(max_rel_err(got[k], want[k])
                for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP", "W"))
    for name, view in want["M4"].items():
        worst = max(worst, max_rel_err(got["M4"][name].arr, view.arr))
    return worst


def pf_ptxas(log):
    """``ptxas_usage`` of the seven PF kernels' float and double
    instantiations: {"pf_tt_span<float>": usage, ...}."""
    usage = ptxas_usage(log)
    return {f"{k}<{t}>": next((v for name, v in usage.items() if f"{k}_kernelI{c}E" in name),
                              None)
            for k in PF_KERNELS for t, c in (("float", "f"), ("double", "d"))}


def pf_fill_split(key, out, tabs, sp, dtype, dev):
    """One PF fill on ``dev`` from a drained queue and empty caches: its
    wall, peak device memory and, from the same run, its parts
    (``pf_fill_device``'s ``times``: constants, span loop, copy-out,
    exterior W) into ``out`` under ``key``; returns the fill's result."""
    from ccj_tpu_torch.engine.pf4d import pf_fill_device
    from ccj_tpu_torch.params import DEFAULT_PK

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    parts = {}
    t0 = time.perf_counter()
    res = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=dtype, device=dev, times=parts)
    out[f"{key}_fill_s"] = time.perf_counter() - t0
    out[f"{key}_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out.update({f"{key}_{part}": v for part, v in parts.items()})
    return res


def phase_partition(sp, fold, dev="cuda", n=64, ptxas=None):
    """Phase 11: the sum-product fill on ``dev`` and its seven kernels;
    returns its report (keys name the lengths they run at; ``ptxas``, the
    kernels' :func:`pf_ptxas`, goes in as it is)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ccj_tpu_torch.api import partition
    from ccj_tpu_torch.engine import cuda_ops, pf_ops
    from ccj_tpu_torch.engine import pf as pfmod
    from ccj_tpu_torch.engine.pf4d import pf_fill_device
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables

    out = {"ptxas": ptxas}
    # each kernel against its plain version on the n=64 fill's own operands
    rows = []
    spans = sorted({s for v in PF_CHECK_SPANS.values() for s in v})
    for dtype in (torch.float32, torch.float64):
        pf_kernel_calls(n, spans, dtype, dev,
                        lambda *a, dtype=dtype: pf_kernel_row(rows, n, dtype, True, *a), sp=sp)
    check(sorted((r["kernel"], r["case"], r["dtype"]) for r in rows)
          == sorted((k, f"n={n} s={s}", d) for k in PF_KERNELS for s in PF_CHECK_SPANS[k]
                    for d in ("float32", "float64")),
          f"phase 11 checked {len(rows)} kernel calls, not each kernel at each of its spans")
    out["kernel_rows"] = rows

    # float64 on the card against the host float64 engine at n=16
    tabs = build_seq_tables("GCGCUUCGCCGCGCCA", sp, DEFAULT_PK)
    host = pfmod.pf_fill(tabs, sp, DEFAULT_PK)
    r16 = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device=dev)
    worst = max(max_rel_err(r16[k], host[k])
                for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP", "W"))
    for name, cells in host["M4"].items():
        keys = list(cells)
        worst = max(worst, max_rel_err([r16["M4"][name].get(k) for k in keys],
                                       [cells[k] for k in keys]) if keys else 0.0)
    check(worst <= 1e-9, f"float64 PF on the card vs host at n=16: rel err {worst}")
    out["n16_f64_vs_host_max_rel_err"] = worst

    # float64 at n=40: the card (kernels) against the CPU (plain versions)
    tabs = build_seq_tables(bench_seq(40), sp, DEFAULT_PK)
    t0 = time.perf_counter()
    r40 = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device=dev)
    out["n40_f64_fill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r40_cpu = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device="cpu")
    out["n40_f64_cpu_fill_s"] = time.perf_counter() - t0
    out["n40_f64_vs_cpu_max_rel_err"] = pf_fill_err(r40, r40_cpu)
    check(out["n40_f64_vs_cpu_max_rel_err"] <= 1e-9,
          f"float64 PF at n=40, card vs CPU: rel err {out['n40_f64_vs_cpu_max_rel_err']}")
    del r40, r40_cpu

    # n=64: float32 (the default) against float64, both on the card
    seq = bench_seq(n)
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    res = {}
    for key, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        res[key] = pf_fill_split(f"n{n}_{key}", out, tabs, sp, dtype, dev)
    z32, z64 = float(res["f32"]["W"][n]), float(res["f64"]["W"][n])
    rel = abs(z32 - z64) / abs(z64)
    check(math.isfinite(z32) and z64 > 0 and rel < 1e-5,
          f"n=64: float32 Z {z32!r} vs float64 Z {z64!r} (rel {rel})")
    out.update({"n64_Z_f32": z32, "n64_Z_f64": z64, "n64_Z_rel_err": rel})
    del res

    # float64 at n=100, the bench sequence: wall, peak, Z, ensemble energy
    seq100 = bench_seq(100)
    tabs100 = build_seq_tables(seq100, sp, DEFAULT_PK)
    r100 = pf_fill_split("n100_f64", out, tabs100, sp, torch.float64, dev)
    z100 = float(r100["W"][100])
    e100 = pfmod.ensemble_energy(r100)
    mfe100 = fold(seq100, device=dev).energy
    check(math.isfinite(z100) and z100 > 0, f"n=100 float64 Z = {z100!r}")
    check(e100 <= mfe100 + 1e-6, f"n=100 ensemble energy {e100} above the MFE {mfe100}")
    out.update({"n100_Z_f64": z100, "n100_ensemble_energy": e100, "n100_mfe": mfe100})
    del r100
    torch.cuda.empty_cache()

    # device work the float32 fill launches (a profiler run apart; its raw
    # events are read directly, key_averages over them would take minutes)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pf_fill_device(tabs, sp, DEFAULT_PK, device=dev)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    copies = [e for e in events if e.name().startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in events:
        if e.name().startswith("void (anonymous namespace)::pf_"):
            key = e.name().split("::")[1].split("_kernel")[0]
            by_name[key] = by_name.get(key, 0.0) + e.duration_ns() / 1e9
    out["n64_f32_device_launches"] = len(events)
    check(len(events) <= PF_DEVICE_OPS_CEILING,
          f"the n={n} float32 fill ran {len(events)} device operations, "
          f"over {PF_DEVICE_OPS_CEILING}")
    out["n64_f32_device_copies"] = len(copies)
    out["n64_f32_device_busy_s"] = sum(e.duration_ns() for e in events) / 1e9
    out["n64_f32_pf_kernel_busy_s"] = by_name
    out["n64_profile_s"] = time.perf_counter() - t0
    out["n64_f32_all_eager_not_this_run"] = PF_EAGER

    # partition end to end, and thermodynamic consistency with the MFE fold
    reset_counts(cuda_ops)
    pf_reset(pf_ops)
    t0 = time.perf_counter()
    pf = partition(seq, num_samples=1000, device=dev)
    out["n64_partition_s"] = time.perf_counter() - t0
    out["pf_launches"] = pf_launches(pf_ops)
    check(out["pf_launches"] == pf_counts(n),
          f"partition n={n}: PF kernel launches {out['pf_launches']} != {pf_counts(n)}")
    out["launches"] = loop_launches(cuda_ops, (0,) * len(FILL_KERNELS),
                                    "the partition function")
    mfe = fold(seq, device=dev)
    check(abs(pf.Z - z32) / z32 < 1e-5, f"partition Z {pf.Z!r} != fill Z {z32!r}")
    check(pf.ensemble_energy <= mfe.energy + 1e-6,
          f"ensemble energy {pf.ensemble_energy} above the MFE {mfe.energy}")
    check(pf.pair_probs.shape == (n + 1, n + 1) and pf.pair_probs.min() >= 0,
          f"partition gave pair probabilities of shape {pf.pair_probs.shape}")
    out.update({"n64_ensemble_energy": pf.ensemble_energy, "n64_mfe": mfe.energy,
                "n64_num_samples": pf.num_samples})
    return out


def phase_packed_vs_dense(fill7, C, SC4, n, dangles, dense, dense_fill_s):
    """Phase 4b: the packed fill7 of the length-n sequence against its dense
    fill6 state ``dense``, bit for bit on the card (the comparison of
    tests/test_fill.py's test_fill7_packed_matches_fill6)."""
    from ccj_tpu_torch.engine.common import SAT16
    from ccj_tpu_torch.engine.gapped import C_MATS
    from ccj_tpu_torch.engine.gapped5 import M4_STORED, segments7

    SEGS = segments7(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = fill7(C, SC4, n, dangles, SEGS)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    compared = 0

    def same(a, b, what):
        nonlocal compared
        check(a.shape == b.shape and torch.equal(a, b),
              f"n={n}: packed != dense on {what}")
        compared += 1

    for k in ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP", "PKD", "PKE"):
        same(packed[k], dense[k], k)
    for g, (lo, hi, TB, IB, Lc) in enumerate(SEGS):
        for name in M4_STORED:
            same(packed[f"{name}@{g}"], dense[name][:TB, lo:hi, :IB, :], f"{name}@{g}")
        for name in C_MATS:
            # packed C row r of span u holds dense row l = lo + 1 + r; rows
            # past the dense l axis (l > n + 1) were never valid: unset
            cp, cd = packed[f"C_{name}@{g}"], dense["C_" + name]
            lmax = min(lo + 1 + Lc, n + 2)
            same(cp[:, :, :lmax - lo - 1, :], cd[:TB, lo:hi, lo + 1:lmax, :], f"C_{name}@{g}")
            check(bool((cp[:, :, lmax - lo - 1:] == SAT16).all()),
                  f"n={n}: C_{name}@{g} rows past l = n + 1 were written")
    out = {"n": n, "segments": len(SEGS), "fill7_s": packed_s, "fill6_s": dense_fill_s,
           "arrays_compared": compared,
           "packed_state_bytes": sum(x.nbytes for x in packed.values()),
           "dense_state_bytes": sum(x.nbytes for x in dense.values())}
    del packed
    return out


def fold_anchor(api, fold, LazyMats, cuda_ops, n):
    """Fold ``tests/golden/long/seed42_n{n}.txt`` through ``fold`` and match
    it byte for byte; returns its walls (the fill's inside the fold timed
    apart), launches, peak device memory and the lazy traceback's bytes and
    slabs fetched."""
    from ccj_tpu_torch.cli import _format_energy

    seq, line = (ROOT / "tests" / "golden" / "long" / f"seed42_n{n}.txt") \
        .read_text().splitlines()[:2]
    seen, fills = [], []

    class RecordingLazyMats(LazyMats):
        """The fold's own LazyMats, kept to read its transfer counts."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen.append(self)

    real_fill_state = api.fill_state

    def timed_fill_state(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = real_fill_state(*args, **kw)
        torch.cuda.synchronize()
        fills.append(time.perf_counter() - t0)
        return st

    api.LazyMats, api.fill_state = RecordingLazyMats, timed_fill_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ops)
    try:
        t0 = time.perf_counter()
        res = fold(seq)
        fold_s = time.perf_counter() - t0
    finally:
        api.LazyMats, api.fill_state = LazyMats, real_fill_state
    got = f"{res.structure} ({_format_energy(res.energy)})"   # the CLI's line
    check(got == line, f"n={n}: {got!r} != {line!r}")
    check(len(seen) == 1 and len(fills) == 1, f"the n={n} fold did not take the lazy traceback")
    n_fill = api._fill_length(n)
    launches = loop_launches(cuda_ops, fill_counts(n_fill), f"fold n={n}")
    out = {"n": n, "n_fill": n_fill, "packed": seen[0]._segs is not None,
           "segments": len(seen[0]._segs or ()), "fold_s": fold_s, "fill_s": fills[0],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "bytes_fetched": seen[0].bytes_fetched, "slab_fetches": seen[0].slab_fetches,
           "launches": launches, "energy": res.energy,
           "cells_per_s": cells4d(n_fill) / fills[0]}
    seen.clear()     # the recording class, a reference cycle, holds the list
    torch.cuda.empty_cache()
    return out


def phase_checkpoint(sp, n=48, every=16, stop_at=20):
    """Phase 8: fill4 with a snapshot every ``every`` spans, interrupted
    from ``on_span`` at span ``stop_at``, then resumed; the resumed state
    must equal an uninterrupted fill6 on every array and the snapshot must
    be gone; the resumed fill's launches are those of the spans it runs
    (:func:`span_launches`).  The snapshot lives under ``build/`` (git
    ignores it)."""
    import shutil

    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine import fold as fmod
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables

    tabs = build_seq_tables(bench_seq(n), sp, DEFAULT_PK)
    C, SC4 = fmod.consts_from_numpy(fmod.build_consts(tabs, sp, DEFAULT_PK), "cuda")
    ref = fmod.fill6(C, SC4, n, sp.dangles)
    ckpt = ROOT / "build" / "checkpoint_smoke"
    shutil.rmtree(ckpt, ignore_errors=True)
    snap = ckpt / fmod.CHECKPOINT_FILE
    walls = {"save": [], "load": []}

    def timed(fn, key):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            walls[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    class Stop(Exception):
        pass

    def bomb(s, _dt):
        if s == stop_at:
            raise Stop

    real = fmod._save_checkpoint, fmod._load_checkpoint
    fmod._save_checkpoint = timed(real[0], "save")
    fmod._load_checkpoint = timed(real[1], "load")
    dig = fmod.fold_digest(tabs, sp, DEFAULT_PK)
    try:
        try:
            fmod.fill4(C, SC4, n, sp.dangles, checkpoint_dir=str(ckpt),
                       checkpoint_every=every, on_span=bomb, digest=dig)
        except Stop:
            pass
        else:
            raise SmokeFailure("fill4 ran past the interruption")
        check(snap.exists(), "fill4 left no snapshot")
        snapshot_bytes = snap.stat().st_size
        reset_counts(cuda_ops)
        t0 = time.perf_counter()
        st = fmod.fill4(C, SC4, n, sp.dangles, checkpoint_dir=str(ckpt),
                        checkpoint_every=every, digest=dig)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        # the resumed fill runs the spans from the last snapshot on
        launches = loop_launches(cuda_ops, span_launches(range(stop_at // every * every, n)),
                                 f"checkpoint resume n={n}")
    finally:
        fmod._save_checkpoint, fmod._load_checkpoint = real
    check(set(st) == set(ref), "the resumed state has other arrays than fill6's")
    for k in ref:
        check(torch.equal(st[k], ref[k]), f"resumed fill4 != fill6 on {k}")
    check(not snap.exists(), "the completed fill4 left its snapshot")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"n": n, "checkpoint_every": every, "interrupted_at_span": stop_at,
            "snapshot_bytes": snapshot_bytes, "save_s": walls["save"],
            "load_s": walls["load"], "resumed_fill_s": resume_s, "launches": launches,
            "arrays_compared": len(ref)}


def device_busy_s(fn):
    """Device time of the kernels, copies and memsets ``fn`` launches, from
    a profiler run of it (the raw events: key_averages over a whole fill's
    would take minutes); returns (seconds, events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in events) / 1e9, len(events)


def phase_batched_fill64(sp, cuda_ops, lengths=(64, 49, 52, 55, 57, 59, 61, 63)):
    """Phase 9: ``batched_fill6`` of eight seed-made sequences of lengths
    49-64 at bucket 64, with the launch counts reset just before and read
    just after (one launch per span for the whole batch: 62); every
    element bit-equal on every array to its own ``fill6``; the batched
    wall against the eight single walls (tables built inside both) and the
    peak memory.  Returns the report and the sequences."""
    from ccj_tpu_torch.api import bucket_for
    from ccj_tpu_torch.dist.batch import batched_fill6
    from ccj_tpu_torch.engine.fold import build_consts, consts_from_numpy, fill6
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables, pad_seq_tables

    seqs = [bench_seq(m, seed=100 + k) for k, m in enumerate(lengths)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ops)
    t0 = time.perf_counter()
    st, n_pad = batched_fill6(seqs, sp, DEFAULT_PK)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    B = len(seqs)
    check(n_pad == bucket_for(max(lengths)), f"the batch padded to {n_pad}")
    launches = loop_launches(cuda_ops, fill_counts(n_pad), f"batched fill x{B} bucket {n_pad}")
    singles, singles_fill = [], []
    for b, seq in enumerate(seqs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tabs = pad_seq_tables(build_seq_tables(seq, sp, DEFAULT_PK), n_pad, sp, DEFAULT_PK)
        C, SC4 = consts_from_numpy(build_consts(tabs, sp, DEFAULT_PK), "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = fill6(C, SC4, n_pad, sp.dangles)
        torch.cuda.synchronize()
        singles.append(time.perf_counter() - t0)
        singles_fill.append(time.perf_counter() - t1)
        check(set(one) == set(st), "batched and single states hold other arrays")
        for k, v in one.items():
            check(torch.equal(st[k][b], v), f"batched fill x{B} element {b} != its fill6 on {k}")
        del one, C, SC4
    arrays = len(st)
    del st
    torch.cuda.empty_cache()
    return {"n": list(lengths), "n_pad": n_pad, "batch": B, "batched_fill_s": batched_s,
            "single_fills_s": singles, "single_fills_sum_s": sum(singles),
            "single_fill_only_sum_s": sum(singles_fill),
            "speedup_vs_singles": sum(singles) / batched_s,
            "max_memory_allocated": peak, "memory_before": base,
            "launches": launches, "arrays_compared": arrays * B}, seqs


def phase_batched_busy(sp, seqs, lo, hi):
    """Phase 12: the device's busy share of a batched fill of ``seqs``:
    spans [lo, hi) of a batched fill stopped at span lo, run once for the
    wall and once under the profiler for the device time (as
    ``ccj_tpu_torch.fill_breakdown`` takes a single fill's)."""
    from ccj_tpu_torch.dist.batch import _stack_v4_consts
    from ccj_tpu_torch.engine import fold as fmod
    from ccj_tpu_torch.params import DEFAULT_PK

    Cb, SC4b, n_pad = _stack_v4_consts(seqs, sp, DEFAULT_PK, device="cuda")

    def spans(a, b):
        with torch.inference_mode():
            for _ in fmod._run_spans(Cb, SC4b, n_pad, sp.dangles, st,
                                     (x for x in fmod._dense_steps(n_pad)
                                      if a <= x[0] < b)):
                pass
        torch.cuda.synchronize()

    with torch.inference_mode():
        st = fmod._init_dense(n_pad, Cb["H"].device, len(seqs))
    spans(0, lo)
    t0 = time.perf_counter()
    spans(lo, hi)            # re-running spans whose inputs are final
    wall = time.perf_counter() - t0
    dev_s, events = device_busy_s(lambda: spans(lo, hi))
    del st
    torch.cuda.empty_cache()
    return {"n_pad": n_pad, "batch": len(seqs), "spans": [lo, hi], "wall_s": wall,
            "device_busy_s": dev_s, "device_events": events,
            "device_busy_share": dev_s / wall}


def phase_batched_fill100(sp, api, fold, cuda_ops, seq100, st100, res100, fill100_s,
                          lengths=(97, 90, 83)):
    """Phase 4c: ``batched_fill6`` at bucket 100 for a batch of four whose
    element 0 is the main path's n=100 sequence: launches 98 (one per span
    for the whole batch); element 0 bit-equal to the main path's
    ``fill6`` state ``st100``; elements 1-3 bit-equal to the ``fill6`` state
    inside their own ``fold``; each element's ``LazyMats`` traceback gives
    ``fold``'s structure and energy; the wall against the single fill's
    ``fill100_s`` and the peak memory above what was allocated before.
    Returns the report and the sequences."""
    from ccj_tpu_torch.dist.batch import batched_fill6
    from ccj_tpu_torch.engine.lazy import LazyMats
    from ccj_tpu_torch.engine.traceback import Traceback
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables

    seqs = [seq100] + [bench_seq(m, seed=200 + k) for k, m in enumerate(lengths)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ops)
    t0 = time.perf_counter()
    st, n_pad = batched_fill6(seqs, sp, DEFAULT_PK)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    B = len(seqs)
    check(n_pad == 100, f"the bucket-100 batch padded to {n_pad}")
    launches = loop_launches(cuda_ops, fill_counts(n_pad), f"batched fill x{B} bucket {n_pad}")
    check(int(st["V"][0, 1, 100]) == BENCH_V100, "batched element 0: V(1,100) != -1528")
    for k, v in st100.items():
        check(torch.equal(st[k][0], v), f"batched element 0 != the main path's fill6 on {k}")
    results, traceback_s = [], []
    for b, seq in enumerate(seqs):
        t0 = time.perf_counter()
        mats = LazyMats({k: v[b] for k, v in st.items()}, n_pad)
        e_dcal, structure = Traceback(build_seq_tables(seq, sp, DEFAULT_PK), sp,
                                      DEFAULT_PK, mats).run()
        traceback_s.append(time.perf_counter() - t0)
        if b == 0:
            want = res100
        else:       # fold it, keeping the fill6 state of the fold to compare
            own = []
            real = api.fill_state
            api.fill_state = lambda *a, **kw: own.append(real(*a, **kw)) or own[-1]
            try:
                want = fold(seq)
            finally:
                api.fill_state = real
            check(len(own) == 1 and set(own[0]) == set(st), f"fold of element {b}")
            for k, v in own[0].items():
                check(torch.equal(st[k][b], v), f"batched element {b} != its fill6 on {k}")
            del own
        check((e_dcal, structure) == (want.energy_dcal, want.structure),
              f"batched element {b}: {structure} ({e_dcal}) != fold's "
              f"{want.structure} ({want.energy_dcal})")
        results.append({"n": len(seq), "energy": e_dcal / 100.0})
    del st
    torch.cuda.empty_cache()
    return {"n": [len(s) for s in seqs], "n_pad": n_pad, "batch": B,
            "batched_fill_s": batched_s, "single_fill_n100_s": fill100_s,
            "wall_vs_single": batched_s / fill100_s,
            "per_sequence_throughput_vs_single": B * fill100_s / batched_s,
            "max_memory_allocated": peak, "memory_before": base,
            "peak_above_before": peak - base, "launches": launches,
            "lazy_traceback_s": traceback_s, "elements": results}, seqs


def sharded_counts(n, P):
    """The launches of a fill of length n split over P row shards (dense or
    packed), as :func:`fill_counts` gives them, per shard that owns a
    span-s row (1 <= i <= n - s; R = ceil((n + 2) / P) rows a shard):
    ``tt_span``, ``stencil_pl`` and ``stencil_pr`` each span with a tt
    step; ``history_min`` each span s >= 1 once for the RL scans and once
    per owner of the shard's C rows l = i + s (< n2) for the RI ones (each
    owner reduces its own rows); ``p_split`` each span with a term;
    ``span_assemble`` and ``span_store`` each span; the 2-D recurrences
    (``span_v``, ``span_wbp``, ``span_wm``) once a span on the one replica
    of the 2-D matrices (every shard on one card), as an unsharded fill
    runs them, and ``wx_tables`` once a fill for that replica's kept
    weight tables.  ``_history_tables`` adds no ``wx_tables``: its owners
    share the one device's tables."""
    from ccj_tpu_torch.dist.wavefront import row_partition, span_rows

    R, _ = row_partition(n, P)
    tt = hist = ps = spans = 0
    for s in range(n):
        for _p, i0, IB in span_rows(n, R, P, s):
            a, b = i0 + s, min(i0 + s + IB, n + 2)
            owners = len({r // R for r in range(a, b)})
            tt += s >= 2
            hist += (s >= 1) * (1 + owners)
            ps += s >= 3
            spans += 1
    return tt, hist, ps, tt, tt, spans, spans, n - 1, n, n - 3, 1


def phase_wavefront(cuda_ops, C, SC4, n, dangles, tabs, sp, P, want_line,
                    plain=None, plain_fill_s=None, segs=None):
    """Phases 4d, 5b (dense) and 5c (packed, ``segs`` its segment schedule):
    ``dist.wavefront.fill6_sharded`` / ``fill7_sharded`` with P row shards on
    cuda:0.  Launches equal :func:`sharded_tt_spans`; every array the state
    holds equals ``plain`` (the unsharded ``fill6`` / ``fill7`` state,
    where given), read one array at a time; ``LazyMats`` over the sharded
    state traces back to ``want_line`` (structure, energy in dcal).
    Reports the wall against ``plain_fill_s``, the peak memory above what
    was held before, the state bytes per shard and the bytes exchanged per
    class, in total and at the widest span, and the traceback's bytes
    between shards."""
    from ccj_tpu_torch.dist.wavefront import CLASSES, fill6_sharded, fill7_sharded
    from ccj_tpu_torch.engine.lazy import LazyMats
    from ccj_tpu_torch.engine.traceback import Traceback
    from ccj_tpu_torch.params import DEFAULT_PK

    unsharded = "fill6" if segs is None else "fill7"
    what = f"wavefront {'dense' if segs is None else 'packed'} P={P} n={n}"
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(cuda_ops)
    t0 = time.perf_counter()
    if segs is None:
        st = fill6_sharded(C, SC4, n, dangles, devices=["cuda:0"] * P)
    else:
        st = fill7_sharded(C, SC4, n, dangles, segs, devices=["cuda:0"] * P)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = loop_launches(cuda_ops, sharded_counts(n, P), what)
    compared = 0
    if plain is not None:
        check(set(st.keys()) == set(plain), f"{what}: keys differ")
        for k, v in plain.items():
            got = st.rows(k) if k in st.layout else st[k]
            check(got.shape == v.shape and torch.equal(got, v),
                  f"{what}: gather() != {unsharded} on {k}")
            compared += 1
            del got
    tr = st.transport
    read_before, p_splits = tr.bytes["read"], []
    reads = st.p_split_reads
    st.p_split_reads = lambda i, l: p_splits.append(l - i) or reads(i, l)
    t0 = time.perf_counter()
    try:
        mats = LazyMats(st, n, segs=segs)
        got_line = Traceback(tabs, sp, DEFAULT_PK, mats).run()
    finally:
        del st.p_split_reads        # the spy refers to st: leave no cycle
    traceback_s = time.perf_counter() - t0
    check(got_line == want_line, f"{what}: traceback {got_line} != {want_line}")
    # the traceback moves at most the rows of its host slabs and, per P
    # split of (i, l), row i at l - i spans and one span of each row in (i, l]
    traceback_read = tr.bytes["read"] - read_before
    _, T, _, _, A = st.shards[0]["PKD"].shape
    p_split_bound = sum(2 * T * m * A * 2 for m in p_splits)
    check(traceback_read <= mats.bytes_fetched + p_split_bound,
          f"{what}: the traceback moved {traceback_read} B between "
          f"shards, over {mats.bytes_fetched} B of slabs + {p_split_bound} B of P split")
    fill_classes = [c for c in CLASSES if c != "read"]
    widest = max(tr.span_bytes, key=lambda u: sum(tr.span_bytes[u][c] for c in fill_classes))
    out = {"n": n, "shards": P, "rows_per_shard": st.R,
           "segments": None if segs is None else len(segs), "fill_s": wall,
           f"{unsharded}_s": plain_fill_s,
           f"wall_vs_{unsharded}": None if plain_fill_s is None else wall / plain_fill_s,
           "launches": launches, "arrays_compared": compared,
           "lazy_traceback_s": traceback_s, "slab_fetches": mats.slab_fetches,
           "bytes_fetched": mats.bytes_fetched,
           "max_memory_allocated": peak, "memory_before": base,
           "peak_above_before": peak - base,
           "state_bytes_per_shard": [st.shard_bytes(p) for p in range(P)],
           "replica_bytes": st.replica_bytes(),
           "exchange_bytes": {c: tr.bytes[c] for c in fill_classes},
           "exchange_bytes_read": tr.bytes["read"],
           "traceback_exchange_bytes": traceback_read, "p_splits": len(p_splits),
           "p_split_bound_bytes": p_split_bound,
           "widest_span": widest,
           "widest_span_bytes": {c: tr.span_bytes[widest][c] for c in fill_classes},
           "energy_dcal": got_line[0]}
    del st, mats
    torch.cuda.empty_cache()
    return out


def anchor_line(n):
    """(sequence, the reference's line, (energy in dcal, structure)) of
    ``tests/golden/long/seed42_n{n}.txt``."""
    seq, line = (ROOT / "tests" / "golden" / "long" / f"seed42_n{n}.txt") \
        .read_text().splitlines()[:2]
    structure, energy = line.rsplit(" (", 1)
    return seq, line, (round(float(energy.rstrip(")")) * 100), structure)


def phase_wavefront_packed(cuda_ops, sp, report):
    """Phase 5c: ``fill7_sharded`` on the packed reference anchors: n=134
    with P=2 and P=4, every array bit-equal to its ``fill7`` state (filled
    here, its wall beside) and the anchor byte for byte; n=200 with P=2, the
    anchor byte for byte (no whole-state comparison: two copies of its
    state come too close to the card's 80 GB), its wall against the n=200
    fold's fill.  Returns the reports by key."""
    from ccj_tpu_torch.cli import _format_energy
    from ccj_tpu_torch.engine.fold import build_consts, consts_from_numpy, fill7
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK
    from ccj_tpu_torch.precompute import build_seq_tables

    out = {}
    for m, shard_counts in ((134, (2, 4)), (200, (2,))):
        seq, line, want = anchor_line(m)
        tabs = build_seq_tables(seq, sp, DEFAULT_PK)
        C, SC4 = consts_from_numpy(build_consts(tabs, sp, DEFAULT_PK), "cuda")
        segs = segments7(m)
        plain, plain_s = None, report[f"n{m}"]["fill_s"]
        if m == 134:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = fill7(C, SC4, m, sp.dangles, segs)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        for P in shard_counts:
            wf = phase_wavefront(cuda_ops, C, SC4, m, sp.dangles, tabs, sp, P, want,
                                 plain, plain_s, segs)
            got = f"{want[1]} ({_format_energy(wf['energy_dcal'] / 100.0)})"
            check(got == line, f"wavefront packed n={m} P={P}: {got!r} != {line!r}")
            wf["fold_fill_s"] = report[f"n{m}"]["fill_s"]
            out[f"wavefront_packed_P{P}_n{m}"] = wf
            emit({"phase": "wavefront_packed", **wf})
        del plain, C, SC4
        torch.cuda.empty_cache()
    return out


def phase_fold_many_pipeline(fold_many, cuda_ops, seqs64, seqs100, bucket_for,
                             order=(1, None, None, 1)):
    """Phase 9b: ``fold_many`` of phase 9's eight bucket-64 sequences and
    phase 4c's four bucket-100 ones, with ``batch_limit=1`` (one fill and
    its traceback at a time) and with the default (fill k+1 dispatched
    before traceback k), in the turns ``order`` gives (None: the default);
    every run's results equal the first's, one ``tt_span`` per span.
    Returns each mode's walls and peak memory."""
    seqs = [*seqs64, *seqs100]
    want = fill_counts(*(bucket_for(len(q)) for q in seqs))
    first, out = None, {"n": [len(q) for q in seqs], "order": [
        "batch_limit=1" if b == 1 else "default" for b in order]}
    for b in order:
        key = "batch_limit_1" if b == 1 else "default"
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(cuda_ops)
        t0 = time.perf_counter()
        res = fold_many(seqs) if b is None else fold_many(seqs, batch_limit=b)
        wall = time.perf_counter() - t0
        loop_launches(cuda_ops, want, f"fold_many pipeline ({key})")
        line = [(r.seq, r.structure, r.energy_dcal) for r in res]
        check([r.seq for r in res] == seqs, f"fold_many ({key}) lost the input order")
        if first is None:
            first = line
        check(line == first, f"fold_many ({key}) differs from the {out['order'][0]} run")
        out.setdefault(f"{key}_wall_s", []).append(wall)
        out.setdefault(f"{key}_peak_bytes", []).append(torch.cuda.max_memory_allocated())
    out["launches"] = want[0]
    out["energies_dcal"] = [e for *_, e in first]
    return out


def phase_corpus_processes(entries, nproc=2):
    """Phase 10: ``python -m ccj_tpu_torch.dist.corpus`` over ``entries``
    with ``nproc`` processes merging through a loopback TCPStore (one per
    card where there are enough, else all on cuda:0), then one process
    alone; both outputs must be the goldens in corpus order with no
    ``error``.  Returns each process's wall, its own fold wall and its
    tt_span, min-plus and tt_step launches (which the CLI prints), and the
    one-process ones."""
    import socket

    work = ROOT / "build" / "corpus_smoke"
    work.mkdir(parents=True, exist_ok=True)
    corpus = work / "corpus.txt"
    corpus.write_text("\n".join(e["seq"] for e in entries) + "\n")

    def run(n, extra):
        out = work / f"out_{n}.json"
        out.unlink(missing_ok=True)
        errs = [work / f"stderr_{n}_{pid}.txt" for pid in range(n)]
        t0 = time.perf_counter()
        procs = []
        for pid in range(n):
            with open(errs[pid], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ccj_tpu_torch.dist.corpus", str(corpus),
                     str(out), *extra, "--num-processes", str(n), "--process-id", str(pid)],
                    cwd=ROOT, stdout=subprocess.DEVNULL, stderr=fh))
        walls, reports = [None] * n, []
        try:
            pending = set(range(n))
            while pending:
                for pid in list(pending):
                    if procs[pid].poll() is not None:
                        walls[pid] = time.perf_counter() - t0
                        pending.discard(pid)
                time.sleep(0.05)
                check(time.perf_counter() - t0 < 600, "the corpus processes hung")
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for pid, p in enumerate(procs):
            err = errs[pid].read_text()
            check(p.returncode == 0, f"corpus process {pid} exited {p.returncode}: "
                  f"{err[-2000:]}")
            vals = dict(ln.split() for ln in err.splitlines()
                        if ln.startswith(("corpus-fold-seconds", "corpus-tt-span-launches",
                                          "corpus-minplus-launches",
                                          "corpus-tt-step-launches",
                                          "corpus-history-launches",
                                          "corpus-psplit-launches",
                                          "corpus-stencil-pl-launches",
                                          "corpus-stencil-pr-launches",
                                          "corpus-assemble-launches",
                                          "corpus-store-launches",
                                          "corpus-span-v-launches",
                                          "corpus-span-wbp-launches",
                                          "corpus-span-wm-launches",
                                          "corpus-wx-launches")))
            reports.append({"wall_s": walls[pid],
                            "fold_s": float(vals["corpus-fold-seconds"]),
                            "launches": int(vals["corpus-tt-span-launches"]),
                            "history_launches": int(vals["corpus-history-launches"]),
                            "psplit_launches": int(vals["corpus-psplit-launches"]),
                            "stencil_pl_launches": int(vals["corpus-stencil-pl-launches"]),
                            "stencil_pr_launches": int(vals["corpus-stencil-pr-launches"]),
                            "assemble_launches": int(vals["corpus-assemble-launches"]),
                            "store_launches": int(vals["corpus-store-launches"]),
                            "span_v_launches": int(vals["corpus-span-v-launches"]),
                            "span_wbp_launches": int(vals["corpus-span-wbp-launches"]),
                            "span_wm_launches": int(vals["corpus-span-wm-launches"]),
                            "wx_launches": int(vals["corpus-wx-launches"]),
                            "minplus_launches": int(vals["corpus-minplus-launches"]),
                            "tt_step_launches": int(vals["corpus-tt-step-launches"])})
        res = json.loads(out.read_text())
        check([r["seq"] for r in res] == [e["seq"] for e in entries],
              f"the {n}-process corpus is out of order")
        for r, e in zip(res, entries):
            check(r["error"] is None, f"corpus entry {r['index']}: {r['error']}")
            check(r["structure"] == e["structure"] and abs(r["energy"] - e["energy"]) < 1e-9,
                  f"corpus n={len(e['seq'])}: {r['structure']} ({r['energy']}) != "
                  f"{e['structure']} ({e['energy']})")
        return reports

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cards = torch.cuda.device_count()
    placement = ("one process per card" if cards >= nproc
                 else f"all {nproc} processes on cuda:0 ({cards} card)")
    multi = run(nproc, ["--coordinator", f"127.0.0.1:{port}"])
    solo = run(1, [])
    from ccj_tpu_torch.api import bucket_for

    want = fill_counts(*(bucket_for(len(e["seq"])) for e in entries))
    keys = ("launches", "history_launches", "psplit_launches", "stencil_pl_launches",
            "stencil_pr_launches", "assemble_launches", "store_launches", "span_v_launches",
            "span_wbp_launches", "span_wm_launches", "wx_launches", "minplus_launches",
            "tt_step_launches")
    for label, reps in (("two-process", multi), ("one-process", solo)):
        got = tuple(sum(r[k] for r in reps) for k in keys)
        check(got == (*want, 0, 0), f"{label} corpus {' / '.join(FILL_KERNELS)} / "
              f"minplus_group / tt_step launches {got} != {(*want, 0, 0)}")
    PATH_COUNTS["corpus"] = want
    return {"n": [len(e["seq"]) for e in entries], "processes": nproc,
            "placement": placement, "process_reports": multi,
            "launches": sum(r["launches"] for r in multi),
            "history_launches": want[1], "psplit_launches": want[2],
            "stencil_pl_launches": want[3], "stencil_pr_launches": want[4],
            "assemble_launches": want[5], "store_launches": want[6],
            "span_v_launches": want[7], "span_wbp_launches": want[8],
            "span_wm_launches": want[9], "wx_launches": want[10],
            "one_process": solo[0]}


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    from ccj_tpu_torch import api, fold, fold_many
    from ccj_tpu_torch.api import DENSE_MAX_N, bucket_for
    from ccj_tpu_torch.engine import cuda_ops
    from ccj_tpu_torch.engine.fold import (TRACEBACK_KEYS, build_consts,
                                           consts_from_numpy, fill6, fill7)
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.engine.lazy import LazyMats
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
    rows, main_row, packed_row, batched_rows, shard_row, packed_shard_row = phase_kernel(
        cuda_ops, bucket_dims, torch.device("cuda"))
    report["kernel"] = rows
    step_rows, step_main = phase_tt_step(cuda_ops, bucket_dims, torch.device("cuda"))
    report["tt_step"] = step_rows
    span_rows, span_main = phase_tt_span(cuda_ops, bucket_dims, torch.device("cuda"))
    report["tt_span"] = span_rows
    hist_rows, ps_rows = phase_history_psplit(cuda_ops, bucket_dims, torch.device("cuda"))
    report["history_min"], report["p_split"] = hist_rows, ps_rows
    sp = scale_parameters(parse_par(ROOT / "ccj_tpu_torch" / "params"
                                    / "rna_DirksPierce09.par"))
    stencil_rows = phase_stencil(cuda_ops, sp, torch.device("cuda"), stencil_ptxas(log))
    report.update(stencil_rows)
    span_k_rows = phase_span(cuda_ops, sp, bucket_dims, torch.device("cuda"), span_ptxas(log))
    report.update(span_k_rows)
    (span2d_rows, report["span2d_pairs"], report["span2d_store_pairs"],
     report["span2d_kept_tables"]) = phase_span2d(
        cuda_ops, bucket_dims, torch.device("cuda"), span2d_ptxas(log))
    report.update(span2d_rows)

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
    reset_counts(cuda_ops)
    t0 = time.perf_counter()
    res = fold(seq)
    fold_s = time.perf_counter() - t0
    check(cuda_ops.TT_SPAN_LAUNCHES > 0, "the main path launched tt_span no time")
    main_counts = {"minplus_launches": cuda_ops.LAUNCHES,
                   "tt_step_launches": cuda_ops.TT_STEP_LAUNCHES}
    launches = loop_launches(cuda_ops, fill_counts(n), "the main path")

    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C, SC4 = consts_from_numpy(build_consts(tabs, sp, DEFAULT_PK), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fill6(C, SC4, n, sp.dangles)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    v = int(st["V"][1, n])
    check(v == BENCH_V100, f"V(1,{n}) = {v}, want {BENCH_V100}")
    state_bytes = sum(x.nbytes for x in st.values())
    # the lazy traceback (fold's default on CUDA) on this fill ...
    t0 = time.perf_counter()
    lazy = LazyMats(st, n)
    lazy_out = Traceback(tabs, sp, DEFAULT_PK, lazy).run()
    lazy_s = time.perf_counter() - t0
    # ... and the eager host copy + traceback, from the same fill
    t0 = time.perf_counter()
    mats = {k: st[k].cpu().numpy() for k in TRACEBACK_KEYS}
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager_out = Traceback(tabs, sp, DEFAULT_PK, mats).run()
    tb_s = time.perf_counter() - t0
    for name, out in (("lazy", lazy_out), ("eager", eager_out)):
        check(out == (res.energy_dcal, res.structure),
              f"fill + {name} traceback disagrees with fold()")
    report["n100"] = {"fold_s": fold_s, "fill_s": fill_s,
                      "lazy_traceback_s": lazy_s, "bytes_fetched": lazy.bytes_fetched,
                      "slab_fetches": lazy.slab_fetches, "state_bytes": state_bytes,
                      "copy_s": copy_s, "copy_bytes": sum(x.nbytes for x in mats.values()),
                      "traceback_s": tb_s, "cells_per_s": cells4d(n) / fill_s,
                      "launches": launches, **main_counts, "V_1_n": v, "energy": res.energy,
                      "structure": res.structure}
    emit({"phase": "main_path_n100", **report["n100"]})

    # ---- 4b: the packed fill against the dense one, same sequence ---------
    del mats, lazy
    report["packed_vs_dense_n100"] = phase_packed_vs_dense(
        fill7, C, SC4, n, sp.dangles, st, fill_s)
    emit({"phase": "packed_vs_dense_n100", **report["packed_vs_dense_n100"]})

    # ---- 4c: the batched fill at bucket 100, the main path's sequence first
    report["batched_fill_n100_x4"], seqs100 = phase_batched_fill100(
        sp, api, fold, cuda_ops, seq, st, res, fill_s)
    emit({"phase": "batched_fill_n100_x4", **report["batched_fill_n100_x4"]})

    # ---- 4d: the row-sharded fill against the main path's fill ------------
    for P in (2, 4):
        report[f"wavefront_dense_P{P}_n100"] = phase_wavefront(
            cuda_ops, C, SC4, n, sp.dangles, tabs, sp, P,
            (res.energy_dcal, res.structure), st, fill_s)
        emit({"phase": "wavefront_dense", **report[f"wavefront_dense_P{P}_n100"]})
    del st, C, SC4
    torch.cuda.empty_cache()

    # ---- 5: the reference anchors through fold and the lazy traceback -----
    # n=126 (dense, bucket 128), n=134 (the first length past dense) and
    # n=200 (packed, 6 segments)
    for m in (126, 134, 200):
        report[f"n{m}"] = fold_anchor(api, fold, LazyMats, cuda_ops, m)
        check(report[f"n{m}"]["packed"] == (m > DENSE_MAX_N),
              f"n={m} took the {'packed' if m <= DENSE_MAX_N else 'dense'} fill")
        emit({"phase": f"anchor_n{m}", **report[f"n{m}"]})

    # ---- 5b: the n=126 anchor through the row-sharded fill (P=2) -------------
    from ccj_tpu_torch.cli import _format_energy
    from ccj_tpu_torch.precompute import pad_seq_tables
    seq126, line126, want126 = anchor_line(126)
    tabs126 = build_seq_tables(seq126, sp, DEFAULT_PK)
    n_fill = api._fill_length(126)
    C126, SC4126 = consts_from_numpy(build_consts(
        pad_seq_tables(tabs126, n_fill, sp, DEFAULT_PK), sp, DEFAULT_PK), "cuda")
    wf126 = phase_wavefront(cuda_ops, C126, SC4126, n_fill, sp.dangles, tabs126,
                            sp, 2, want126, plain_fill_s=report["n126"]["fill_s"])
    got126 = f"{want126[1]} ({_format_energy(wf126['energy_dcal'] / 100.0)})"
    check(got126 == line126, f"wavefront n=126: {got126!r} != {line126!r}")
    report["wavefront_dense_P2_n126"] = wf126
    emit({"phase": "wavefront_dense", **wf126})
    del C126, SC4126

    # ---- 5c: the packed anchors through the row-sharded packed fill --------
    report.update(phase_wavefront_packed(cuda_ops, sp, report))

    n200 = report["n200"]
    n200.update(ref_seconds=REF_SECONDS_200,
                ref_cells_per_s=cells4d(200) / REF_SECONDS_200,
                fold_speedup_vs_ref=REF_SECONDS_200 / n200["fold_s"])
    emit({"phase": "anchor_n200_vs_reference", **{
        k: n200[k] for k in ("fill_s", "fold_s", "cells_per_s", "ref_seconds",
                             "ref_cells_per_s", "fold_speedup_vs_ref")}})

    # ---- 6: fold_many -------------------------------------------------------
    entries = [next(e for e in corpus if len(e["seq"]) == m and not e["args"])
               for m in (37, 60, 16)]
    reset_counts(cuda_ops)
    t0 = time.perf_counter()
    many = fold_many([e["seq"] for e in entries])
    many_s = time.perf_counter() - t0
    for e, r in zip(entries, many):
        check((r.seq, r.structure) == (e["seq"], e["structure"])
              and abs(r.energy - e["energy"]) < 1e-9,
              f"fold_many n={len(e['seq'])}: {r.structure} ({r.energy}) != "
              f"{e['structure']} ({e['energy']})")
    many_launches = loop_launches(cuda_ops, fill_counts(*(bucket_for(len(e["seq"]))
                                                          for e in entries)), "fold_many")
    report["fold_many"] = {"n": [len(e["seq"]) for e in entries], "wall_s": many_s,
                           "launches": many_launches}
    emit({"phase": "fold_many", **report["fold_many"]})

    # ---- 7: the CLI ---------------------------------------------------------
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "ccj_tpu_torch.cli", CLI_SEQ],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.splitlines()
    check(cli.returncode == 0, f"the CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    check(lines[:2] == [CLI_SEQ, CLI_LINE], f"the CLI printed {lines!r}")
    report["cli"] = {"wall_s": cli_s, "stdout": lines}
    emit({"phase": "cli", **report["cli"]})

    # ---- 8: checkpoint / resume (fill4) --------------------------------------
    report["checkpoint"] = phase_checkpoint(sp)
    emit({"phase": "checkpoint", **report["checkpoint"]})

    # ---- 9: the batched fill at bucket 64, eight sequences of 49-64 -----------
    report["batched_fill_n64_x8"], seqs64 = phase_batched_fill64(sp, cuda_ops)
    emit({"phase": "batched_fill_n64_x8", **report["batched_fill_n64_x8"]})

    # ---- 9b: fold_many's fill-ahead pipeline against one fill at a time -------
    report["fold_many_pipeline"] = phase_fold_many_pipeline(
        fold_many, cuda_ops, seqs64, seqs100, bucket_for)
    emit({"phase": "fold_many_pipeline", **report["fold_many_pipeline"]})

    # ---- 10: the corpus driver, two processes, on the 15 default goldens ------
    report["corpus_processes"] = phase_corpus_processes(
        [e for e in corpus if not e["args"]])
    emit({"phase": "corpus_processes", **report["corpus_processes"]})

    # ---- 11: the partition function (the profiler from here on) ---------------
    report["partition"] = phase_partition(sp, fold, ptxas=pf_ptxas(log))
    emit({"phase": "partition", **{k: v for k, v in report["partition"].items()
                                   if k != "kernel_rows"}})

    # ---- 12: the batched fills' device busy share ----------------------------
    for key, seqs_b, lo in (("n64_x8", seqs64, 40), ("n100_x4", seqs100, 70)):
        report[f"batched_fill_{key}_busy"] = phase_batched_busy(sp, seqs_b, lo, lo + 2)
        emit({"phase": f"batched_fill_{key}_busy", **report[f"batched_fill_{key}_busy"]})

    launches_by_path = {
        "fold n=100": launches,
        **{f"fold n={m}": report[f"n{m}"]["launches"] for m in (126, 134, 200)},
        "fold_many n=37,60,16": report["fold_many"]["launches"],
        "fold_many bucket 64 x8 + 100 x4, per run": report["fold_many_pipeline"]["launches"],
        "batched fill bucket 64 x8": report["batched_fill_n64_x8"]["launches"],
        "batched fill bucket 100 x4": report["batched_fill_n100_x4"]["launches"],
        "corpus": report["corpus_processes"]["launches"],
        **{f"wavefront dense P{P} n{m}": report[f"wavefront_dense_P{P}_n{m}"]["launches"]
           for m, P in ((100, 2), (100, 4), (126, 2))},
        **{f"wavefront packed P{P} n{m}": report[f"wavefront_packed_P{P}_n{m}"]["launches"]
           for m, P in ((134, 2), (134, 4), (200, 2))},
        "partition n=16,64": report["partition"]["launches"]}
    off_path = ("0 on every path of tt_span's launches_by_path (checked on each): the "
                "fills run tt_span; this kernel is its step-by-step comparator")
    kernels = [{
        "name": "tt_span", "route": "cuda",
        "source": "ccj_tpu_torch/csrc/ttspan.cu", "replaces": REPLACES,
        "replaces_what": "on every MFE path, the tt loop's 13 red_k / red_j windows "
                         "(the function of pallas_ops.py:_minplus_kernel) and the XLA "
                         "fusion of the rest of run_tt_loop_unstacked.t_body "
                         "(ttloop.py:436-551), every step of a span in one launch",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in span_rows),
        "ms": span_main["ms"], "plain_ms": span_main["plain_ms"],
        "bound_ms": span_main["bound_ms"], "bound_by": span_main["bound_by"],
        "two_kernel_bound_ms": span_main["two_kernel_bound_ms"],
        "library_ms": None, "call_ms": span_main["call_ms"],
        "ms_l2cold": span_main["ms_l2cold"], "steps_ms": span_main["steps_ms"],
        "steps_call_ms": span_main["steps_call_ms"],
        "plan": span_main["plan"], "cluster_ms": span_main["cluster_ms"],
        "empty_step_us": span_main["empty_step_us"],
        "weights_ldg_ms": span_main["weights_ldg_ms"],
        "weights_staged_ms": span_main["weights_staged_ms"],
        "kernel_terms_over_needed": span_main["kernel_terms_over_needed"],
        "share_of_bound": span_main["share_of_bound"],
        "share_of_bound_l2cold": span_main["share_of_bound_l2cold"],
        "matches_plain": True, "shape": span_main["case"],
        "other_shapes": [{k: r[k] for k in (
            "case", "ms", "ms_l2cold", "plain_ms", "call_ms", "steps_ms", "steps_call_ms",
            "plan", "cluster_ms", "empty_step_us", "weights_ldg_ms", "weights_staged_ms",
            "kernel_terms_over_needed", "bound_ms", "bound_by", "two_kernel_bound_ms",
            "share_of_bound", "share_of_bound_l2cold",
            "max_abs_err")} for r in span_rows[1:]],
        "launches_by_path": launches_by_path,
    }, {
        "name": "minplus_group", "route": "cuda",
        "source": "ccj_tpu_torch/csrc/minplus.cu", "replaces": REPLACES,
        "launches": report["n100"]["minplus_launches"], "launches_by_path": off_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "call_ms": main_row["call_ms"],
        "ms_l2cold": main_row["ms_l2cold"],
        "ms_per_window": main_row["ms_per_window"],
        "share_of_bound": main_row["share_of_bound"],
        "share_of_bound_l2cold": main_row["share_of_bound_l2cold"],
        "matches_plain": True, "shape": main_row["case"],
        "packed_n200": {k: packed_row[k] for k in (
            "case", "ms", "ms_l2cold", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "share_of_bound_l2cold", "max_abs_err")},
        "batched": [{k: r[k] for k in (
            "case", "batch", "ms", "ms_l2cold", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "share_of_bound_l2cold", "ms_per_window",
            "max_abs_err")} for r in batched_rows],
        **{key: {k: r[k] for k in (
            "case", "ms", "ms_l2cold", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "share_of_bound_l2cold", "max_abs_err")}
           for key, r in (("row_shard_n100_P4", shard_row),
                          ("row_shard_packed_n200_P4", packed_shard_row))},
    }]
    step_keys = ("case", "ms", "ms_l2cold", "plain_ms", "call_ms", "bound_ms", "bound_by",
                 "share_of_bound", "share_of_bound_l2cold", "max_abs_err")
    kernels.append({
        "name": "tt_step", "route": "cuda",
        "source": "ccj_tpu_torch/csrc/ttstep.cu", "replaces": STEP_REPLACES,
        "replaces_what": "the XLA fusion of run_tt_loop_unstacked.t_body after its "
                         "reductions (ttloop.py:436-551); no Pallas kernel",
        "launches": report["n100"]["tt_step_launches"], "launches_by_path": off_path,
        "max_abs_err": max(r["max_abs_err"] for r in step_rows),
        "ms": step_main["ms"], "plain_ms": step_main["plain_ms"],
        "bound_ms": step_main["bound_ms"], "bound_by": step_main["bound_by"],
        "library_ms": None, "call_ms": step_main["call_ms"],
        "ms_l2cold": step_main["ms_l2cold"],
        "share_of_bound": step_main["share_of_bound"],
        "share_of_bound_l2cold": step_main["share_of_bound_l2cold"],
        "matches_plain": True, "shape": step_main["case"],
        "other_shapes": [{k: r[k] for k in step_keys} for r in step_rows[1:]],
    })
    new_keys = ("case", "ms", "ms_l2cold", "plain_ms", "call_ms", "bound_ms", "bound_by",
                "share_of_bound", "share_of_bound_l2cold", "terms", "bytes", "max_abs_err")
    for name, source, replaces, what, rows_k, idx in (
            ("history_min", "ccj_tpu_torch/csrc/history.cu", HISTORY_REPLACES,
             "the XLA fusions of the RL / RI history scans (gapped4.py:306-341, "
             "gapped5.py:313-365): the span's 16 scans in one launch (a row shard: "
             "one for its RL scans, one per owner of its RI rows)", hist_rows, 1),
            ("p_split", "ccj_tpu_torch/csrc/psplit.cu", PSPLIT_REPLACES,
             "the XLA fusion of compute_P_span3's split contraction (gapped3.py:69-123), "
             "one launch a span (and row shard)", ps_rows, 2)):
        main = rows_k[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "replaces_what": what, "launches": PATH_COUNTS["the main path"][idx],
            "launches_by_path": {k: v[idx] for k, v in PATH_COUNTS.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows_k),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "call_ms": main["call_ms"],
            "ms_l2cold": main["ms_l2cold"], "share_of_bound": main["share_of_bound"],
            "share_of_bound_l2cold": main["share_of_bound_l2cold"],
            "matches_plain": True, "shape": main["case"],
            "other_shapes": [{k: r[k] for k in new_keys} for r in rows_k[1:]]})
    stencil_keys = ("case", "views", "ms", "ms_l2cold", "plain_ms", "call_ms",
                    "bound_ms", "bound_by", "bytes_ms", "ops_ms", "share_of_bound",
                    "share_of_bound_l2cold", "terms", "walked", "walked_over_terms", "bytes",
                    "max_abs_err")
    for name, idx, what in (
            ("stencil_pl", 3, "the XLA fusion of the PL interior-loop stencil "
             "(gapped4.py:340-375, its packed window gapped5.py:369-420), one launch a span "
             "(and row shard) with a tt step"),
            ("stencil_pr", 4, "the XLA fusion of the PR interior-loop stencil "
             "(gapped4.py:392-414, gapped5.py:435-452), one launch a span (and row shard) "
             "with a tt step")):
        rows_k = stencil_rows[name]
        main = rows_k[0]
        kernels.append({
            "name": name, "route": "cuda", "source": "ccj_tpu_torch/csrc/stencil.cu",
            "replaces": STENCIL_REPLACES[name], "replaces_what": what,
            "launches": PATH_COUNTS["the main path"][idx],
            "launches_by_path": {k: v[idx] for k, v in PATH_COUNTS.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows_k),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "call_ms": main["call_ms"],
            "ms_l2cold": main["ms_l2cold"], "share_of_bound": main["share_of_bound"],
            "share_of_bound_l2cold": main["share_of_bound_l2cold"],
            "walked_over_terms": main["walked_over_terms"],
            "ptxas": main["ptxas"], "matches_plain": True, "shape": main["case"],
            "other_shapes": [{k: r[k] for k in stencil_keys} for r in rows_k[1:]]})
    span_keys = ("case", "ms", "ms_l2cold", "plain_ms", "call_ms", "bound_ms", "bound_by",
                 "share_of_bound", "share_of_bound_l2cold", "bytes", "max_abs_err")
    for name, idx, what in (
            ("span_assemble", 5, "the XLA fusion of the span body around its reductions: the "
             "13 fixed-offset plane reads, the PL / PR / PO assembly and the cross-span-only "
             "families (gapped4.py:257-466, the packed reads of gapped5.span_gapped7), one "
             "launch a span (and row shard)"),
            ("span_store", 6, "the XLA fusion of the span's pack and write-back of 22 "
             "families, 5 C skews, PKD and PKE (gapped4.py:472-495, update_pk_skews4 "
             ":210-229), one launch a span (and row shard)")):
        rows_k = span_k_rows[name]
        main = rows_k[0]
        kernels.append({
            "name": name, "route": "cuda", "source": f"ccj_tpu_torch/csrc/"
            f"{'assemble' if idx == 5 else 'store'}.cu",
            "replaces": SPAN_REPLACES[name], "replaces_what": what,
            "launches": PATH_COUNTS["the main path"][idx],
            "launches_by_path": {k: v[idx] for k, v in PATH_COUNTS.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows_k),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "call_ms": main["call_ms"],
            "ms_l2cold": main["ms_l2cold"], "share_of_bound": main["share_of_bound"],
            "share_of_bound_l2cold": main["share_of_bound_l2cold"],
            "ptxas": main["ptxas"], "matches_plain": True, "shape": main["case"],
            "other_shapes": [{k: r[k] for k in span_keys} for r in rows_k[1:]]})
    span2d_keys = ("case", "ms", "ms_l2cold", "plain_ms", "call_ms", "bound_ms", "bound_by",
                   "share_of_bound", "share_of_bound_l2cold", "bytes", "max_abs_err")
    for name, what in (
            ("span_v", "the XLA fusion of compute_V_span (nested.py:54-152): hairpin, "
             "interior loops and multiloop of every live row of a span, one launch a span "
             "s >= 1 (and replica)"),
            ("span_wbp", "the XLA fusion of compute_WBP_WPP_span (gapped.py:119-160), its "
             "WB / WP weights computed inline, with _set_P_diag (gapped.py:108-118) and the "
             "kept weight tables' span-s cells, one launch a span (and replica)"),
            ("span_wm", "the XLA fusion of compute_WMv_WMp_WM_span (nested.py:155-196), one "
             "launch a span s >= 3 (and replica)"),
            ("wx_tables", "the XLA fusion of _wx_tables (gapped.py:42-59), the gapped step's "
             "four weight tables, one launch a fill (and device), kept by span_wbp")):
        idx = FILL_KERNELS.index(name)
        rows_k = span2d_rows[name]
        main = rows_k[0]
        kernels.append({
            "name": name, "route": "cuda", "source": "ccj_tpu_torch/csrc/span2d.cu",
            "replaces": SPAN2D_REPLACES[name], "replaces_what": what,
            "launches": PATH_COUNTS["the main path"][idx],
            "launches_by_path": {k: v[idx] for k, v in PATH_COUNTS.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows_k),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "call_ms": main["call_ms"],
            "ms_l2cold": main["ms_l2cold"], "share_of_bound": main["share_of_bound"],
            "share_of_bound_l2cold": main["share_of_bound_l2cold"],
            "ptxas": main["ptxas"], "matches_plain": True, "shape": main["case"],
            "other_shapes": [{k: r[k] for k in span2d_keys} for r in rows_k[1:]],
            **({"after_span_wm_pairs": report["span2d_pairs"]} if name == "span_v" else {}),
            **({"after_span_store_pairs": report["span2d_store_pairs"]}
               if name == "span_wm" else {})})
    pf_keys = ("case", "dtype", "ms", "ms_l2cold", "plain_ms", "call_ms", "bound_ms",
               "bound_by", "share_of_bound", "share_of_bound_l2cold", "bytes", "flops",
               "max_rel_err", "rtol", "max_abs_err")
    for name, what in (
            ("pf_tt_span", "on the partition function's path, the (+, x) form of "
             "pallas_ops.py:_minplus_kernel (the PF tt loop's 6 red_k / 7 red_j suffix sums) "
             "with the rest of the XLA fusion of pf4d.py:470-579 (t_body: the PM stencil, "
             "the 14 families), every step of a span in one launch"),
            ("pf_history", "the XLA fusion of the PF span's 16 RL / RI weighted sums "
             "(pf4d.py:312-344, :428-443), one launch a span"),
            ("pf_stencil", "the XLA fusion of the PF span's PL / PR / PO interior-loop "
             "stencils (pf4d.py:359-427), one launch a span"),
            ("pf_p_split", "the XLA fusion of P2's span-s diagonal over PKE / PKD "
             "(pf4d.py:206-233), one launch a span"),
            ("pf_span2d", "the XLA fusions of the PF span's 2-D recurrences: V, P2's "
             "diagonal, WBP / WPP (pf4d.py:164-265, less the P split) and WMv / WMp / WM "
             "(pf4d.py:618-651), with the kept weight tables' span-s cells (_wx_pf, "
             ":144-161, once a fill), one launch a span"),
            ("pf_assemble", "the XLA fusion of the PF span's 13 plane reads (rplane_big_all, "
             "pf4d.py:297-310) and the PL / PR / PO assembly, cross-span-only families and "
             "bases around the stencils (pf4d.py:371-443), one launch a span"),
            ("pf_store", "the XLA fusion of the PF span's write-back of 22 families, 5 C "
             "skews, PKD and PKE (pf4d.py:581-615), one launch a span")):
        rows_k = [r for r in report["partition"]["kernel_rows"] if r["kernel"] == name]
        main = next(r for r in rows_k if r["case"] == "n=64 s=40" and r["dtype"] == "float32")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ccj_tpu_torch/csrc/{'pfbody' if name in PF_NEW else 'pfspan'}.cu",
            "replaces": PF_REPLACES[name], "replaces_what": what,
            "launches": report["partition"]["pf_launches"][name],
            "launches_by_path": {"partition n=64 (float32 fill)":
                                 report["partition"]["pf_launches"][name]},
            "max_abs_err": max(r["max_abs_err"] for r in rows_k),
            "max_rel_err": max(r["max_rel_err"] for r in rows_k),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "call_ms": main["call_ms"],
            "ms_l2cold": main["ms_l2cold"], "share_of_bound": main["share_of_bound"],
            "share_of_bound_l2cold": main["share_of_bound_l2cold"],
            "matches_plain": True, "shape": f"{main['case']} {main['dtype']}",
            "other_shapes": [{k: r[k] for k in pf_keys} for r in rows_k if r is not main]})
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
