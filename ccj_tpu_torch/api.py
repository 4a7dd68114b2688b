"""High-level folding API: sequence in, MFE structure + energy out (PyTorch).

Counterpart of ``ccj_tpu/api.py``.  Mirrors the
reference CLI pipeline (reference: src/CCJ.cc:58-108): validate, T->U
unless noConv, select parameter set (DirksPierce09 default; embedded DNA
Mathews2004 when the unconverted sequence contains T), fill on the device,
traceback on the host.

Every entry point takes ``device`` (default: CUDA, raising when there is
none; ``device="cpu"`` runs the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

from .engine.fold import (DENSE_MAX_N, default_version, fill_state, run_fill,
                          state_segments)
from .engine.lazy import LazyMats
from .engine.traceback import Traceback
from .params import (
    DEFAULT_PK,
    PKPenalties,
    RawTables,
    dna_mathews2004_tables,
    parse_par,
    scale_parameters,
)
from .precompute import build_seq_tables, pad_seq_tables
from .seq import seq_to_rna, validate_sequence

PARAMS_DIR = Path(__file__).resolve().parent / "params"
DEFAULT_PARAM_FILE = PARAMS_DIR / "rna_DirksPierce09.par"

# Length buckets (from ccj_tpu/dist/batch.py): a fill padded to a bucket
# gives the same true-length window as an unpadded one
# (precompute.pad_seq_tables), so the bucket shapes are the JAX package's.
BUCKETS = (16, 24, 32, 48, 64, 80, 100, 110, 128, 160, 200, 256, 320)


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return n


@dataclasses.dataclass
class FoldResult:
    seq: str
    structure: str
    energy: float          # kcal/mol
    energy_dcal: int       # exact integer energy (dcal/mol)


@functools.lru_cache(maxsize=8)
def _load_tables(param_file: str | None, dna: bool) -> RawTables:
    if dna:
        return dna_mathews2004_tables()
    if param_file is None:
        return parse_par(DEFAULT_PARAM_FILE)
    return parse_par(param_file)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that raises (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ccj_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def _prepare(seq: str, no_conv: bool) -> str:
    seq = seq.upper()
    if not no_conv:
        seq = seq_to_rna(seq)
    validate_sequence(seq)
    return seq


def _fill_length(n: int, bucket: bool = True) -> int:
    """The length the fill runs at: the bucket of ``n`` where that is within
    ``DENSE_MAX_N``, else ``n``.  Padding past ``DENSE_MAX_N`` would switch
    to the packed fill7 at an inflated length (and grow the O(n^4) state by
    (bucket/n)^4), so a longer sequence fills at its true length."""
    b = bucket_for(n) if bucket else n
    return b if b <= DENSE_MAX_N else n


def fold(
    seq: str,
    dangles: int = 2,
    param_file: str | None = None,
    no_gu: bool = False,
    no_conv: bool = False,
    pk: PKPenalties = DEFAULT_PK,
    temperature: float = 37.0,
    bucket: bool = True,
    lazy: bool | None = None,
    device=None,
) -> FoldResult:
    """Predict the MFE pseudoknotted secondary structure of one sequence.

    ``device`` is where the fill runs (default: CUDA, raising when there is
    none).  ``lazy`` keeps the DP state on the device and lets the
    traceback fetch per-span slabs on demand (default: on for CUDA, off on
    the CPU where host copies are free; always on for the packed fill, whose
    state only ``LazyMats`` reads).  ``bucket`` pads the fill to a length
    bucket (``BUCKETS``) within ``DENSE_MAX_N``; the padded tables'
    true-length window is bit-identical to an unpadded fill, and the host
    traceback only visits regions inside [1, n].  Up to ``DENSE_MAX_N`` the
    dense fill6 runs, past it the segment-packed fill7 at the true length
    (``fold.default_version``; ``CCJ_ENGINE`` overrides it).
    """
    dev = resolve_device(device)
    seq = _prepare(seq, no_conv)

    # DNA auto-selection (embedded Mathews2004 tables + forced noGU) happens
    # ONLY when no -P file is given (reference: src/CCJ.cc:80-98)
    dna = no_conv and "T" in seq and param_file is None
    if dna:
        no_gu = True
    tables = _load_tables(param_file, dna)
    sp = scale_parameters(tables, temperature=temperature, dangles=dangles)
    tabs = build_seq_tables(seq, sp, pk, no_gu=no_gu)
    n_fill = _fill_length(len(seq), bucket)
    tabs_fill = pad_seq_tables(tabs, n_fill, sp, pk, no_gu=no_gu)
    version = default_version(tabs_fill.n)
    if lazy is None:
        lazy = dev.type != "cpu"
    if version == 7:
        lazy = True
    if lazy:
        # keep the O(n^4) state on the device; the traceback fetches
        # per-span slabs on demand (engine/lazy.py) instead of copying it all
        st = fill_state(tabs_fill, sp, pk, dev, version)
        mats = LazyMats(st, tabs_fill.n, segs=state_segments(st, tabs_fill.n))
    else:
        mats = run_fill(tabs_fill, sp, pk, dev, version)
    e_dcal, structure = Traceback(tabs, sp, pk, mats).run()
    if lazy and os.environ.get("CCJ_TRANSFER_STATS"):
        print(f"[ccj] traceback host-ward transfer: "
              f"{mats.bytes_fetched / 1e6:.1f} MB in "
              f"{mats.slab_fetches} slab fetches", file=sys.stderr)
    return FoldResult(
        seq=seq, structure=structure, energy=e_dcal / 100.0, energy_dcal=e_dcal
    )


class _FillPipeline:
    """Fills on a side stream, tracebacks on a reading stream (CUDA), so
    the card runs fill k+1 while the host walks traceback k.

    ``LazyMats`` reads with blocking copies on the current stream.  With
    fill k+1 queued on that same stream, traceback k's first read would
    wait for fill k+1 to finish.  So each fill is queued on ``fills`` and
    followed by an event, and traceback k reads on ``reads``, which waits
    on fill k's event only.  The caching allocator: a fill's state is
    allocated on ``fills`` and read on ``reads``; it is freed only after
    its traceback returns and after ``fills`` has been made to wait for
    ``reads``, so a later fill that reuses its memory runs after every
    read of it.  On the CPU the same calls run in order, with no streams."""

    def __init__(self, dev):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.fills = torch.cuda.Stream(dev)
            self.reads = torch.cuda.Stream(dev)
            self.fills.wait_stream(torch.cuda.current_stream(dev))

    def _on(self, stream_name):
        if self.cuda:
            return torch.cuda.stream(getattr(self, stream_name))
        return contextlib.nullcontext()

    def fill(self, tabs_fill, sp, pk):
        """Queue the fill of ``tabs_fill``; returns (state, its event or
        None on the CPU)."""
        with self._on("fills"):
            st = fill_state(tabs_fill, sp, pk, self.dev)
        if not self.cuda:
            return st, None
        done = torch.cuda.Event()
        done.record(self.fills)
        return st, done

    def traceback(self, tabs, sp, pk, n_fill, st, done):
        """Trace back the fill (``st``, ``done``) through ``LazyMats``;
        returns (energy in dcal/mol, structure).  The caller frees ``st``
        after this returns."""
        if self.cuda:
            self.reads.wait_event(done)
        with self._on("reads"):
            mats = LazyMats(st, n_fill, segs=state_segments(st, n_fill))
            out = Traceback(tabs, sp, pk, mats).run()
        if self.cuda:
            self.fills.wait_stream(self.reads)
        return out

    def close(self):
        """Order the caller's stream after every fill and read."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_stream(self.fills)
            cur.wait_stream(self.reads)


def fold_many(
    seqs,
    dangles: int = 2,
    param_file: str | None = None,
    no_gu: bool = False,
    no_conv: bool = False,
    pk: PKPenalties = DEFAULT_PK,
    temperature: float = 37.0,
    batch_limit: int = 8,
    device=None,
):
    """Fold a list of sequences, the fills of one on the device while the
    host traces back the one before; results keep input order.

    Sequences past ``DENSE_MAX_N`` fold one at a time through :func:`fold`
    (the packed fill at their true length); the rest are grouped by length
    bucket and each is filled at its bucket's length and traced back
    through ``LazyMats``.  Within a group, as in the JAX package, the fill
    of sequence k+1 is dispatched before the traceback of sequence k, with
    at most ``depth = max(1, min(batch_limit, 2))`` fill states live at
    once: ``batch_limit=1`` fills and traces back one sequence after the
    other.  (The JAX loop traces back only once depth + 1 fills are
    pending; here the state traced back counts among the depth, so
    ``batch_limit`` caps the states live, as its docstring says.)  On CUDA
    the fills run on a side stream (:class:`_FillPipeline`).  As there, the
    parameter set is ``param_file`` (or the default) for every sequence,
    with no DNA auto-selection for the bucketed ones.
    """
    dev = resolve_device(device)
    prepped = [_prepare(seq, no_conv) for seq in seqs]
    groups: dict[int, list] = {}
    long_items = []
    for idx, seq in enumerate(prepped):
        if len(seq) > DENSE_MAX_N:
            long_items.append((idx, seq))
        else:
            groups.setdefault(_fill_length(len(seq)), []).append((idx, seq))

    results = [None] * len(prepped)
    for idx, seq in long_items:
        results[idx] = fold(seq, dangles=dangles, param_file=param_file,
                            no_gu=no_gu, no_conv=no_conv, pk=pk,
                            temperature=temperature, device=dev)

    tables = _load_tables(param_file, False)
    sp = scale_parameters(tables, temperature=temperature, dangles=dangles)
    depth = max(1, min(batch_limit, 2))     # fill states live at once
    pipe = _FillPipeline(dev)

    def finish(b, pending):
        idx, seq, tabs, (st, done) = pending.popleft()
        e_dcal, structure = pipe.traceback(tabs, sp, pk, b, st, done)
        results[idx] = FoldResult(seq=seq, structure=structure,
                                  energy=e_dcal / 100.0, energy_dcal=e_dcal)

    for b in sorted(groups):
        pending = collections.deque()       # (idx, seq, tabs, (state, event))
        for idx, seq in groups[b]:
            if len(pending) == depth:
                finish(b, pending)          # frees its state before the next fill
            tabs = build_seq_tables(seq, sp, pk, no_gu=no_gu)
            tabs_fill = pad_seq_tables(tabs, b, sp, pk, no_gu=no_gu)
            pending.append((idx, seq, tabs, pipe.fill(tabs_fill, sp, pk)))
        while pending:
            finish(b, pending)
    pipe.close()
    return results


@dataclasses.dataclass
class PFResult:
    seq: str
    ensemble_energy: float     # -kT ln Z, kcal/mol
    Z: float
    pair_probs: "object"       # sampled base-pair probability estimates
    num_samples: int


def partition(
    seq: str,
    dangles: int = 2,
    param_file: str | None = None,
    no_gu: bool = False,
    no_conv: bool = False,
    pk: PKPenalties = DEFAULT_PK,
    temperature: float = 37.0,
    num_samples: int = 1000,
    seed: int = 0,
    ps_path: str | None = None,
    on_device: bool | None = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> PFResult:
    """Partition function + Boltzmann sampling (+ optional PS dot plot).

    Implements the capability the reference ships disabled
    (reference: src/CCJ.cc:51-56, src/part_func.cc, src/stoch_backtrack.cc)
    with corrected recurrences and a completed pseudoknot sampler; see
    engine/pf.py for the documented divergences.

    ``on_device`` selects the engine: True = the sum-product span fill on
    ``device`` (engine/pf4d.py, in ``dtype``), False = the host float64
    engine (engine/pf.py, O(n^5) Python — fine to n~20), None = the device
    fill for n >= 24.  ``device`` is the torch device (default: CUDA,
    raising when there is none), which also runs the MFE fold of the dot
    plot.
    """
    from .engine.pf import ensemble_energy, pf_fill
    from .engine.sample import sample_structures, write_dot_plot

    dev = resolve_device(device)
    seq = _prepare(seq, no_conv)
    # same -P/auto-DNA branch order as fold() (reference: src/CCJ.cc:80-98)
    dna = no_conv and "T" in seq and param_file is None
    if dna:
        no_gu = True
    tables = _load_tables(param_file, dna)
    sp = scale_parameters(tables, temperature=temperature, dangles=dangles)
    tabs = build_seq_tables(seq, sp, pk, no_gu=no_gu)
    if on_device is None:
        on_device = tabs.n >= 24
    if on_device:
        from .engine.pf4d import pf_fill_device

        res = pf_fill_device(tabs, sp, pk, dtype=dtype, device=dev)
    else:
        res = pf_fill(tabs, sp, pk)

    z = float(res["W"][tabs.n])
    if not math.isfinite(z) or z <= 0.0:
        # the reference's own pf stack NaNs silently on long sequences
        # (src/CCJ.cc:105, src/part_func.cc:107); fail loudly instead.
        # The float32 envelope below was measured on a CPU by the JAX
        # package (tools/pf_envelope.py, random seqs at 37C): float32 vs
        # float64 rel. error ~2e-7 at n=32/48, ~8e-7 at n=64; Z grows
        # ~10^0.57 per nt and OVERFLOWS float32 (3.4e38) near n ~ 80-85
        # (NaN at n=96, Z64 = 2.05e43).
        raise FloatingPointError(
            f"partition function overflow/underflow: Z = {z!r} at n = "
            f"{tabs.n} (float32 device pf is accurate to ~1e-6 up to "
            "n~64 and overflows near n~80-85 — measured, tools/"
            "pf_envelope.py; pass dtype=torch.float64 for a float64 device "
            "fill, or on_device=False for the float64 host engine)")
    counts, _ = sample_structures(tabs, sp, pk, res, num_samples=num_samples,
                                  seed=seed)
    probs = counts.astype(np.float64) / max(num_samples, 1)
    if ps_path:
        mfe = fold(seq, dangles=dangles, param_file=param_file, no_gu=no_gu,
                   no_conv=no_conv, pk=pk, temperature=temperature,
                   device=dev)
        mfe_pairs = _pairs_from_structure(mfe.structure)
        write_dot_plot(ps_path, seq, counts, num_samples, mfe_pairs)
    return PFResult(
        seq=seq,
        ensemble_energy=ensemble_energy(res),
        Z=z,
        pair_probs=probs,
        num_samples=num_samples,
    )


def _pairs_from_structure(structure: str):
    openers = {"(": ")", "[": "]", "{": "}", "<": ">"}
    closers = {v: k for k, v in openers.items()}
    stacks = {o: [] for o in openers}
    pairs = np.full(len(structure) + 2, -1, dtype=np.int64)
    for idx, ch in enumerate(structure, start=1):
        if ch in openers:
            stacks[ch].append(idx)
        elif ch in closers:
            a = stacks[closers[ch]].pop()
            pairs[a] = idx
            pairs[idx] = a
    return pairs
