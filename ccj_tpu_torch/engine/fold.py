"""Fold driver: the span-wavefront fills producing all DP matrices
(PyTorch).

Counterpart of ``ccj_tpu/engine/fold.py``'s one-card engines, each a Python
loop over spans on one device mirroring W_final::ccj's fill loop
(reference: src/W_final.cc:58-77); the exterior W pass and traceback run on
the host (engine/traceback.py):

* ``fill6`` — the dense fill (n <= ``DENSE_MAX_N``);
* ``fill4`` — the same dense span body, checkpointable (``checkpoint_dir``
  snapshots, ``on_span`` per-span timing);
* ``fill7`` — the segment-packed fill past the dense reach
  (engine/gapped5.py).

``default_version`` picks one by length (``CCJ_ENGINE`` overrides it) and
``fill_state`` runs it.  The JAX package's oracle engines (1, 3) and its
lane-tile layout (8) are not ported (ROADMAP, "Not to port").

Every span function runs a batch: state arrays and per-sequence tables
carry a leading batch axis (``stack_consts``).  :func:`fill6_batched` fills
a bucket's batch in one span loop (``dist.batch.batched_fill6``); the
single-sequence fills are a batch of one, take and return arrays without
the axis, and so hand ``LazyMats`` and every caller the arrays they had.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..params.pk import PKPenalties
from ..params.scaling import ScaledParams
from ..precompute import SeqTables
from . import cuda_ops
from .common import INF, SAT16, TRI_UNSET, V_UNSET
from .gapped import M4_NAMES, WX, _wx_tables, compute_WBP_WPP_span
from .gapped3 import p_split_minima
from .gapped4 import bucket_dims, build_sc4, init_big_state4, span_gapped4
from .gapped5 import init_big_state7, segments7, span_gapped7
from .nested import cell_major_eint, compute_V_span, compute_WMv_WMp_WM_span

# Largest n the dense engine folds.  The dense state (22 families, 5 C-skews
# and PKD as [T, S, n2, n2] int16, plus PKE [T, S+T+2, n2, n2]) is 16.5 GB at
# n = 128 by arithmetic, which one 80 GB H100 holds with room for the span
# phase's temporaries.  Longer sequences take the packed fill7 (31.4 GB of
# state at n = 200 by arithmetic).
DENSE_MAX_N = 128

# scalar constants of the fill: Python ints on the port's side
SCALAR_KEYS = ("n", "MLbase", "PSM", "PSP", "PB", "PUP", "PPS",
               "b", "bp", "cp", "ap")
# host-side state keys the traceback reads (engine/traceback.py)
TRACEBACK_KEYS = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP",
                  *M4_NAMES)


def build_consts(tabs: SeqTables, P: ScaledParams, pk: PKPenalties):
    """Host (numpy) constant dict of the fill: the same keys and values as
    ``ccj_tpu.engine.fold.build_consts(..., device=False)``."""
    C = {
        "n": tabs.n,
        "ptype": tabs.ptype,
        "can_pair": tabs.can_pair,
        "H": tabs.H,
        "EINT": tabs.EINT,
        "EINTP": tabs.EINTP,
        "ESTP": tabs.ESTP,
        "MLbase": P.MLbase,
        "PSM": pk.PSM,
        "PSP": pk.PSP,
        "PB": pk.PB,
        "PUP": pk.PUP,
        "PPS": pk.PPS,
        "b": pk.b,
        "bp": pk.bp,
        "cp": pk.cp,
        "ap": pk.ap,
    }
    for name in ("ML0", "ML2", "ML_ip1", "ML_jm1", "ML_both",
                 "MB0", "MB2", "MB_5", "MB_3", "MB_53"):
        C[name] = getattr(tabs, name)
    return C


def consts_from_numpy(C_np, device, sc4_np=None):
    """Carry a host constant dict across to the port: returns (C, SC4).

    ``C_np`` is the dict ``build_consts`` returns here or in the JAX package
    (``ccj_tpu.engine.fold.build_consts(..., device=False)``; its arrays
    are copied with ``np.array``).  Scalars become Python ints and tables
    tensors on ``device``.  ``sc4_np`` (the arrays of the JAX package's
    ``gapped4.build_sc4``) gives the stencil weight tables; without it they
    are built on ``device`` by this package's ``gapped4.build_sc4``.  Fed
    the same host dicts, both packages fill from identical tables.
    """
    C = {}
    for k, v in C_np.items():
        if k in SCALAR_KEYS:
            C[k] = int(v)
        else:
            C[k] = torch.as_tensor(np.array(v), device=device)
    if sc4_np is None:
        SC4 = build_sc4(C["EINTP"], C["can_pair"], C["n"])
    else:
        SC4 = {k: torch.as_tensor(np.array(v), device=device)
               for k, v in sc4_np.items()}
    return C, SC4


def add_batch(tables):
    """A table dict as a batch of one: a leading axis on every tensor (a
    view), Python scalars as they are."""
    return {k: v[None] if isinstance(v, torch.Tensor) else v
            for k, v in tables.items()}


def stack_consts(dicts):
    """Stack per-sequence table dicts (``consts_from_numpy``'s C or SC4, all
    of one padded length) along a new leading batch axis; scalars are
    shared Python ints and must agree."""
    out = {}
    for k, v in dicts[0].items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.stack([d[k] for d in dicts])
        elif any(d[k] != v for d in dicts):
            raise ValueError(f"scalar {k!r} differs within the batch")
        else:
            out[k] = v
    return out


def drop_batch(st):
    """Element 0 of a batch-of-one state, as views."""
    return {k: v[0] for k, v in st.items()}


def init_state_2d(n: int, device, batch: int = 1):
    """The 2-D triangle matrices (int32; V with its getter semantics baked
    in: INF on i>=j, nodes default elsewhere), [batch, n2, n2] each."""
    n2 = n + 2
    ii = torch.arange(n2, device=device)[:, None]
    jj = torch.arange(n2, device=device)[None, :]

    def tri():
        return torch.full((batch, n2, n2), TRI_UNSET, dtype=torch.int32,
                          device=device)

    return {
        "V": torch.where(ii < jj, V_UNSET, INF).to(torch.int32).repeat(batch, 1, 1),
        "Vtype": torch.zeros((batch, n2, n2), dtype=torch.int8, device=device),
        "WM": tri(), "WMv": tri(), "WMp": tri(),
        "P2": tri(), "WBP": tri(), "WPP": tri(),
    }


def init_state(n: int, device, batch: int = 1):
    st = init_state_2d(n, device, batch)
    n2 = n + 2
    T = max(n - 1, 1)
    S = max(n, 1)
    for name in M4_NAMES:
        st[name] = torch.full((batch, T, S, n2, n2), SAT16, dtype=torch.int16,
                              device=device)
    return st


def bucket_segments(n: int):
    """Consecutive span ranges sharing one (TB, IB) bucket."""
    segs = []
    for s in range(n):
        b = bucket_dims(n, s)
        if segs and segs[-1][0] == b:
            segs[-1] = (b, segs[-1][1], s + 1)
        else:
            segs.append((b, s, s + 1))
    return segs


def _dense_steps(n: int):
    """The dense fill's schedule: (span, gapped step, its bucket args)."""
    for (TB, IB), lo, hi in bucket_segments(n):
        for s in range(lo, hi):
            yield s, span_gapped4, (TB, IB)


def _packed_steps(SEGS):
    """The packed fill's schedule: (span, gapped step, its segment args)."""
    for gi, (lo, hi, *_r) in enumerate(SEGS):
        for s in range(lo, hi):
            yield s, span_gapped7, (gi, SEGS)


def _run_spans(C, SC4, n: int, dangles: int, st, steps, s0: int = 0):
    """Run the spans of ``steps`` from s0 on ``st`` in place, yielding each
    span after its update: the one span body of every fill (nested
    recurrences, P split, WBP/WPP, the layout's gapped step, WM).  ``C``,
    ``SC4`` and ``st`` carry the batch axis (:func:`add_batch`,
    :func:`stack_consts`).  This run's ``C`` holds EINT cell-major
    (``nested.cell_major_eint``) and the gapped step's weight tables, made
    once from ``st`` as it is (a resumed fill's too) and kept under
    ``gapped.WX``: each span's WBP/WPP update writes their span-s cells,
    with P's diagonal from the P split's minima, in one launch.  It also
    holds the 2-D kernels' launch tables on ``st``, packed once
    (``cuda_ops.span2d_fill_tables`` under ``cuda_ops.SPAN2D_FILL``): the
    loop updates ``st`` in place and swaps none of its tensors.  From the
    run's second span on ``span_v`` is a programmatic dependent launch
    (nothing in the loop writes EINT, H or the MB tables), and ``span_wm``
    is one at every span: the step's last kernel is its ``span_store``,
    which writes none of V, P2, WM, WMv, WMp and the ML tables."""
    C = cell_major_eint({**C, "n": n})
    C[WX] = _wx_tables(C, st)
    C[cuda_ops.SPAN2D_FILL] = cuda_ops.span2d_fill_tables(C, st, dangles)
    first = True
    for s, step, args in steps:
        if s < s0:
            continue
        compute_V_span(C, st, s, dangles, dependent=not first)
        first = False
        compute_WBP_WPP_span(C, st, s, p_split_minima(C, st, s))
        step(C, SC4, st, s, *args)
        compute_WMv_WMp_WM_span(C, st, s, dangles, dependent=True)
        yield s


def _init_dense(n: int, device, batch: int = 1):
    st = init_state(n, device, batch)
    st.update(init_big_state4(n, device, batch))
    return st


@torch.inference_mode()
def fill6_batched(Cb, SC4b, n: int, dangles: int):
    """The dense fill of a batch: ``Cb`` / ``SC4b`` carry a leading batch
    axis on every table (:func:`stack_consts`), all padded to length ``n``.
    One span loop fills every element, one ``tt_span`` launch per span for
    the whole batch.  Returns the state dict, every array
    ``[B, ...]``; element b equals :func:`fill6` of sequence b."""
    st = _init_dense(n, Cb["H"].device, Cb["H"].shape[0])
    for _ in _run_spans(Cb, SC4b, n, dangles, st, _dense_steps(n)):
        pass
    return st


@torch.inference_mode()
def fill6(C, SC4, n: int, dangles: int):
    """The whole dense fill on the device of ``C``'s tables: the
    ``fill6_whole`` loop of the JAX package as a Python loop over spans,
    each span updating the state in place (:func:`fill6_batched` on a batch
    of one).  Returns the state dict."""
    return drop_batch(fill6_batched(add_batch(C), add_batch(SC4), n, dangles))


@torch.inference_mode()
def fill7(C, SC4, n: int, dangles: int, SEGS):
    """The segment-packed fill (engine/gapped5.py), the long-sequence
    engine: the families and C skews are stored per span segment with exact
    extents (``SEGS`` is ``gapped5.segments7(n)``), PKD/PKE and the 2-D
    matrices densely.  Per segment, per span: the dense fill's span body
    with ``span_gapped7`` in place of ``span_gapped4`` (the JAX package's
    ``_fill7_inner``).  Returns the packed state dict."""
    device = C["H"].device
    st = init_state_2d(n, device)
    st.update(init_big_state7(n, SEGS, device))
    for _ in _run_spans(add_batch(C), add_batch(SC4), n, dangles, st,
                        _packed_steps(SEGS)):
        pass
    return drop_batch(st)


def fold_digest(tabs: SeqTables, P: ScaledParams, pk: PKPenalties) -> str:
    """Fingerprint of everything that determines the DP state: sequence,
    parameter tables (via the sequence-specific energy planes, which fold in
    param set, temperature and noGU), dangle model and PK penalties.  Guards
    checkpoint resume against mixing state from a different fold; equal to
    ``ccj_tpu.engine.fold.fold_digest`` on the same tables."""
    h = hashlib.sha256()
    h.update(tabs.seq.encode())
    h.update(str(P.dangles).encode())
    h.update(repr(dataclasses.astuple(pk)).encode())
    h.update(np.ascontiguousarray(tabs.H).tobytes())
    h.update(np.ascontiguousarray(tabs.ESTP).tobytes())
    h.update(str(int(P.MLbase)).encode())
    return h.hexdigest()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def fill4(C, SC4, n: int, dangles: int, checkpoint_dir: str | None = None,
          checkpoint_every: int = 32, on_span=None, digest: str = ""):
    """The dense fill, checkpointable: ``fill6``'s span body.

    ``checkpoint_dir`` snapshots the whole state every ``checkpoint_every``
    spans and resumes from the newest snapshot on the next call, if it is a
    snapshot of the same fold (same n and ``digest``, see
    :func:`fold_digest`); a completed fill removes it.  Long fills survive
    preemption this way (the reference restarts from scratch).
    ``on_span(s, seconds)`` gets each span's wall time, the device waited
    for (``CCJ_PROFILE=1`` prints it); without it the host never waits
    for the device but to copy a snapshot.  Returns the state dict, the
    keys and layouts of ``fill6``.
    """
    device = C["H"].device
    s0, st = 0, None
    if checkpoint_dir:
        s0, st = _load_checkpoint(checkpoint_dir, n, digest, device)
    if st is None:
        s0, st = 0, _init_dense(n, device)
    t0 = time.perf_counter()
    for s in _run_spans(add_batch(C), add_batch(SC4), n, dangles, st,
                        _dense_steps(n), s0):
        if on_span is not None:
            _sync(device)
            on_span(s, time.perf_counter() - t0)
        if checkpoint_dir and (s + 1) % checkpoint_every == 0 and s + 1 < n:
            _save_checkpoint(checkpoint_dir, n, s + 1, st, digest)
        t0 = time.perf_counter()
    if checkpoint_dir:
        _clear_checkpoint(checkpoint_dir)
    return drop_batch(st)


CHECKPOINT_FILE = "wavefront.npz"


def _save_checkpoint(path, n, next_span, st, digest=""):
    """Atomic snapshot of the wavefront state after span ``next_span``-1
    (a batch of one, saved without its batch axis): written to a temporary
    file in ``path``, then renamed over the last."""
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __n=n, __next_span=next_span, __digest=digest,
                     **{k: v[0].cpu().numpy() for k, v in st.items()})
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    except BaseException:
        os.remove(tmp)
        raise


def _load_checkpoint(path, n, digest="", device="cpu"):
    """(next span, state on ``device`` as a batch of one) of the snapshot in
    ``path``, or (0, None).  Resume only from a snapshot of the SAME fold:
    the n key
    alone is not enough (a different sequence / param set / dangle model of
    equal length would silently resume into wrong structures)."""
    f = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.exists(f):
        return 0, None
    with np.load(f) as data:
        if int(data["__n"]) != n or str(data["__digest"]) != digest:
            return 0, None
        st = {k: torch.from_numpy(data[k]).to(device)[None]
              for k in data.files if not k.startswith("__")}
        return int(data["__next_span"]), st


def _clear_checkpoint(path):
    try:
        os.remove(os.path.join(path, CHECKPOINT_FILE))
    except FileNotFoundError:
        pass


# fill versions of the JAX package's best_fill this package runs
VERSIONS = (4, 6, 7)


def check_version(version: int, n: int | None = None) -> int:
    """``version`` if this package runs it (at length ``n``, where given);
    else a ValueError."""
    if version in (4, 6) and n is not None and n > DENSE_MAX_N:
        raise ValueError(
            f"fill version {version} is the dense layout, which reaches "
            f"n = {DENSE_MAX_N}; n = {n} takes the packed fill 7, which has "
            "no checkpointing yet")
    if version in VERSIONS:
        return version
    if version in (1, 3, 8):
        raise ValueError(
            f"fill version {version} is not ported: the oracle engines 1 and "
            "3 and the TPU lane-tile layout 8 are on ROADMAP's 'Not to port' "
            f"list (this package runs {', '.join(map(str, VERSIONS))})")
    raise ValueError(f"unknown fill version {version!r} (expected 4, 6 or 7)")


def default_version(n: int | None = None) -> int:
    """Engine selection: ``CCJ_ENGINE`` overrides (4, 6 or 7; 4 and 6 only
    up to ``DENSE_MAX_N``); else the dense fill6 up to ``DENSE_MAX_N`` and
    the packed fill7 beyond."""
    v = os.environ.get("CCJ_ENGINE")
    if v is not None:
        return check_version(int(v), n)
    return 6 if n is None or n <= DENSE_MAX_N else 7


def state_segments(st, n: int):
    """The segment schedule of a packed (fill7) state, None for a dense one:
    what ``lazy.LazyMats`` takes as ``segs``."""
    return segments7(n) if "PL@0" in st else None


def fill_state(tabs: SeqTables, P: ScaledParams, pk: PKPenalties, device,
               version: int | None = None):
    """Run fill ``version`` (default: :func:`default_version` of the length)
    on ``device`` and return its whole state, left on the device (what
    ``lazy.LazyMats`` reads).  Version 4 takes ``CCJ_CHECKPOINT_DIR`` (the
    snapshot directory) and ``CCJ_PROFILE`` (print each span's wall to
    stderr) from the environment, as the JAX package's ``best_fill`` does.
    The dense versions 4 and 6 past ``DENSE_MAX_N`` raise a ValueError
    before anything is allocated."""
    n = tabs.n
    version = (default_version(n) if version is None
               else check_version(version, n))
    C, SC4 = consts_from_numpy(build_consts(tabs, P, pk), device)
    if version == 7:
        return fill7(C, SC4, n, P.dangles, segments7(n))
    if version == 6:
        return fill6(C, SC4, n, P.dangles)
    on_span = None
    if os.environ.get("CCJ_PROFILE"):
        def on_span(s, dt):
            print(f"[ccj-profile] span {s}: {dt * 1e3:.2f} ms", file=sys.stderr)
    ckpt = os.environ.get("CCJ_CHECKPOINT_DIR") or None
    dig = fold_digest(tabs, P, pk) if ckpt else ""
    return fill4(C, SC4, n, P.dangles, checkpoint_dir=ckpt, on_span=on_span,
                 digest=dig)


def run_fill(tabs: SeqTables, P: ScaledParams, pk: PKPenalties, device,
             version: int | None = None):
    """Run a dense fill (version 4 or 6) on ``device`` and return the arrays
    the traceback reads (``TRACEBACK_KEYS``) as host numpy arrays; the
    packed state of version 7 is read through ``lazy.LazyMats`` only."""
    version = default_version(tabs.n) if version is None else version
    if version == 7:
        raise ValueError("the packed fill7 state is read through "
                         "lazy.LazyMats only; there is no host copy of it")
    st = fill_state(tabs, P, pk, device, version)
    return {k: st[k].cpu().numpy() for k in TRACEBACK_KEYS}
