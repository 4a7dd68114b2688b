"""Hand-written Hopper kernels of the port, with their plain PyTorch twins.

Three kernels of the serial tt loop.  :func:`tt_span` runs a span's whole
loop, every tt step, in one launch; it is what every fill runs
(``ttloop.run_tt_loop``).  :func:`minplus_group`, the step's 13 min-plus
reductions, and :func:`tt_step`, the rest of the step, are the same loop
one step and two launches at a time: the card-side comparator of
:func:`tt_span` (:func:`tt_span_steps`, ``ttloop.run_tt_loop_steps``), and
the pieces of its plain version.

Counterpart of ``ccj_tpu/engine/pallas_ops.py``.  Its one TPU kernel,
``_minplus_kernel`` (launched by ``minplus_suffix``), is a masked min-plus
suffix reduction; the same function is the serial tt loop's k-shrink and
j-shrink reductions ``red_k`` / ``red_j`` (``ccj_tpu/engine/ttloop.py:442-455``),
13 windows per tt step (:data:`REDUCTIONS`).  :func:`minplus_group`
(``csrc/minplus.cu``, whose header notes its bound and design) reduces a
*group* of windows in one launch from a :class:`WindowTable`, built once
per span (:func:`reduction_table`), and the step's ``tt``.
:func:`minplus_window` is a group of one through the same kernel.  A table
over slabs and weights with a leading batch axis reduces every element of
the batch in the same launch (output ``[B, G, I, J]``).

:func:`tt_step` (``csrc/ttstep.cu``) is the counterpart of the XLA fusion
of the JAX loop body after its reductions (``ccj_tpu/engine/ttloop.py:457-551``,
no Pallas kernel): from the step's reductions and the span's operands it
assembles the 14 families' row tt, with the PM interior stencil at the
columns the step keeps, and writes it back into the span's slabs.  Its
operands travel in a :class:`StepTable`, built and checked once per span;
:func:`tt_step_ref` is its plain version, the loop body as it was.

:func:`tt_span` (``csrc/ttspan.cu``) computes both for every tt step of a
span, one block (or a cluster of 2 or 4) per live (b, i) row holding the
row's valid band in shared memory, from a :class:`SpanTable` built and
checked once per span; its plain version :func:`tt_span_ref` is the loop of
:func:`minplus_group_ref` and :func:`tt_step_ref`.

Six kernels of the rest of the span, each the counterpart of an XLA
fusion of the JAX fills (no Pallas kernel): :func:`history_min`
(``csrc/history.cu``), every l-shrink / i-shrink history scan RL / RI of a
span in one launch, each family's window read once over int16 views of
the state and its weights taken from the ``[B, n2, n2]`` tables in the
kernel (``ccj_tpu/engine/gapped4.py:306-341``, ``gapped5.py:313-365``);
:func:`p_split` (``csrc/psplit.cu``), the P
split contraction over PKE / PKD (``ccj_tpu/engine/gapped3.py:69-123``);
:func:`stencil_pl` and :func:`stencil_pr` (``csrc/stencil.cu``), the PL
and PR MAXLOOP^2 interior-loop stencils (``ccj_tpu/engine/gapped4.py:340-375``
and ``:392-414``), which read the family in place through a short list of
int16 views into the state (the span layout's window, ``gapped4.SpanReads``)
and walk only the terms whose weight is below INF; :func:`span_assemble`
(``csrc/assemble.cu``), the span body around those reductions
(``ccj_tpu/engine/gapped4.py:257-466``): the 13 fixed-offset plane reads
read in place through the layout's views, the PL / PR / PO assembly and
the cross-span-only families, for every tt of the span; and
:func:`span_store` (``csrc/store.cu``), the span's pack and write-back into
the layout's destination views (``gapped4.py:472-495``).  Their plain
versions are :func:`history_min_ref`, :func:`p_split_ref`,
:func:`stencil_pl_ref`, :func:`stencil_pr_ref`, :func:`span_assemble_ref`
and :func:`span_store_ref`.

Four kernels of the span's 2-D recurrences (``csrc/span2d.cu``), each the
counterpart of an XLA fusion of the JAX fill's span body (no Pallas
kernel): :func:`span_v` (V and Vtype, ``ccj_tpu/engine/nested.py:54-152``),
:func:`span_wbp` (WBP and WPP, ``ccj_tpu/engine/gapped.py:119-160``, with
P's span-s diagonal from the P split's minima, ``_set_P_diag``, and the
kept weight tables' span-s cells) and :func:`span_wm` (WMv, WMp and WM,
``nested.py:155-196``), each one launch a span for the whole batch, and
:func:`wx_tables` (the gapped step's four weight tables,
``gapped.py:42-59``), one launch a fill, whose tables :func:`span_wbp`
keeps current; their plain versions, the bodies the fills ran before, are
:func:`span_v_ref`, :func:`span_wbp_ref`, :func:`span_wm_ref` and
:func:`wx_tables_ref`.  A fill packs the launch tables of the first three
once (:func:`span2d_fill_tables`, kept in its tables' dict under
:data:`SPAN2D_FILL`); each span then writes only the span, the launch
flag and ``span_wbp``'s P-split minima into them.

Dispatch rule: a wrapper runs its plain PyTorch version only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises; it never falls
back.  The library is built with ``nvcc`` (one process per source, then one
link) into ``build/`` beside the package at first use and loaded with
``ctypes``.  ``LAUNCHES`` counts ``minplus_group`` launches and ``WINDOWS``
the windows those launches reduced (a batch of B counts each window B
times); ``TT_STEP_LAUNCHES`` counts ``tt_step`` launches,
``TT_SPAN_LAUNCHES`` ``tt_span`` launches, ``HISTORY_LAUNCHES``
``history_min`` launches, ``PSPLIT_LAUNCHES`` ``p_split`` launches and
``STENCIL_LAUNCHES`` the two stencils' (``STENCIL_PL_LAUNCHES`` and
``STENCIL_PR_LAUNCHES`` each kernel's), ``ASSEMBLE_LAUNCHES``
``span_assemble`` launches, ``STORE_LAUNCHES`` ``span_store`` launches,
and ``SPAN_V_LAUNCHES``, ``SPAN_WBP_LAUNCHES``, ``SPAN_WM_LAUNCHES`` and
``WX_LAUNCHES`` those of the four 2-D kernels;
nothing else moves them, so a run can show that its main path went
through the kernels.  The partition fill's seven kernels
(``csrc/pfspan.cu``, ``csrc/pfbody.cu``) are built into the same library;
their wrappers and counters are in ``engine/pf_ops.py``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch

from .common import INF, MAXLOOP, SAT16, TURN, V_UNSET, guarded_add, mmin, pad_axis, v_get
from .gapped import DS, WX
from .skew import skew_right, unskew_right

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "libccj_minplus.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_WINDOWS = 16        # csrc/minplus.cu kMaxWindows

LAUNCHES = 0            # minplus kernel launches (CUDA only)
WINDOWS = 0             # windows reduced by those launches (B per batched window)
TT_STEP_LAUNCHES = 0    # tt_step kernel launches (CUDA only)
TT_SPAN_LAUNCHES = 0    # tt_span kernel launches (CUDA only)
HISTORY_LAUNCHES = 0    # history_min kernel launches (CUDA only)
PSPLIT_LAUNCHES = 0     # p_split kernel launches (CUDA only)
STENCIL_LAUNCHES = 0    # stencil_pl and stencil_pr kernel launches together (CUDA only)
STENCIL_PL_LAUNCHES = 0   # of which stencil_pl's
STENCIL_PR_LAUNCHES = 0   # of which stencil_pr's
MAX_GRID_Z = 65535      # CUDA's grid.z limit: descriptors x batch

_lib = None
_lib_lock = threading.Lock()


class Window(ctypes.Structure):
    """One kernel descriptor as a function of tt: csrc/minplus.cu's
    ``struct Window``, field for field.  Strides are in elements; each
    ``*_b`` / ``*_s`` pair is a base and a per-tt step.  ``w2`` (null when
    unused) is a second weight table on the same slab window, reduced into
    output plane ``out2``."""
    _fields_ = [("slab", ctypes.c_void_p), ("ss0", ctypes.c_longlong),
                ("ss1", ctypes.c_longlong), ("ss2", ctypes.c_longlong),
                ("w", ctypes.c_void_p), ("ws0", ctypes.c_longlong),
                ("ws1", ctypes.c_longlong),
                ("w2", ctypes.c_void_p), ("w2s0", ctypes.c_longlong),
                ("w2s1", ctypes.c_longlong),
                ("row0_b", ctypes.c_int), ("row0_s", ctypes.c_int),
                ("scol_b", ctypes.c_int), ("scol_s", ctypes.c_int),
                ("wcol_b", ctypes.c_int), ("wcol_s", ctypes.c_int),
                ("q_lo", ctypes.c_int), ("mode", ctypes.c_int),
                ("c_b", ctypes.c_int), ("c_s", ctypes.c_int),
                ("out", ctypes.c_int), ("out2", ctypes.c_int)]


class BatchStrides(ctypes.Structure):
    """A descriptor's batch strides in elements (slab, w, w2): csrc/minplus.cu's
    ``struct BatchStrides``; all zero for an unbatched table."""
    _fields_ = [("slab", ctypes.c_longlong), ("w", ctypes.c_longlong),
                ("w2", ctypes.c_longlong)]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found (set CUDA_HOME); "
            "the plain PyTorch versions run only for CPU tensors")
    return found


def build_library(force: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into ``build/libccj_minplus.so`` unless the
    library is newer than every source (``force`` builds regardless): one
    ``nvcc -c`` per source, all started together, then one link.
    Returns (path, compiler log); the log holds ``-Xptxas -v``'s register
    and spill report of a fresh build."""
    out = BUILD_DIR / LIB_NAME
    srcs = sorted(CSRC.glob("*.cu"))
    if not force and out.exists() and all(
            out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        tmp = Path(tmpdir) / LIB_NAME
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out, "".join(logs) + link.stdout + link.stderr


def _library():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            if lib.ccj_minplus_window_bytes() != ctypes.sizeof(Window):
                raise RuntimeError(
                    f"cuda_ops.Window ({ctypes.sizeof(Window)} B) does not "
                    f"mirror csrc/minplus.cu ({lib.ccj_minplus_window_bytes()} B)")
            if lib.ccj_minplus_batch_strides_bytes() != ctypes.sizeof(BatchStrides):
                raise RuntimeError("cuda_ops.BatchStrides does not mirror "
                                   "csrc/minplus.cu")
            if lib.ccj_minplus_max_windows() != MAX_WINDOWS:
                raise RuntimeError("MAX_WINDOWS does not match csrc/minplus.cu")
            fn = lib.ccj_minplus_group
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            if lib.ccj_tt_step_table_bytes() != ctypes.sizeof(StepTable):
                raise RuntimeError(
                    f"cuda_ops.StepTable ({ctypes.sizeof(StepTable)} B) does not "
                    f"mirror csrc/ttstep.cu ({lib.ccj_tt_step_table_bytes()} B)")
            if lib.ccj_tt_step_ds() != DS:
                raise RuntimeError("gapped.DS does not match csrc/ttstep.cu kDS")
            lib.ccj_tt_step.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.ccj_tt_step.restype = ctypes.c_int
            if lib.ccj_tt_span_table_bytes() != ctypes.sizeof(SpanTable):
                raise RuntimeError(
                    f"cuda_ops.SpanTable ({ctypes.sizeof(SpanTable)} B) does not "
                    f"mirror csrc/ttspan.cu ({lib.ccj_tt_span_table_bytes()} B)")
            if (lib.ccj_tt_span_max_n2() != MAX_SPAN_N2
                    or lib.ccj_tt_span_max_jobs() != MAX_SPAN_JOBS):
                raise RuntimeError("MAX_SPAN_N2 / MAX_SPAN_JOBS do not match csrc/ttspan.cu")
            if lib.ccj_tt_span_plan_bytes() != ctypes.sizeof(SpanPlan):
                raise RuntimeError("cuda_ops.SpanPlan does not mirror csrc/ttspan.cu")
            lib.ccj_tt_span.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p]
            lib.ccj_tt_span.restype = ctypes.c_int
            lib.ccj_tt_span_phases.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p, ctypes.c_void_p]
            lib.ccj_tt_span_phases.restype = ctypes.c_int
            if lib.ccj_history_table_bytes() != ctypes.sizeof(HistTable):
                raise RuntimeError(
                    f"cuda_ops.HistTable ({ctypes.sizeof(HistTable)} B) does not "
                    f"mirror csrc/history.cu ({lib.ccj_history_table_bytes()} B)")
            lim = (ctypes.c_int * 4)()
            lib.ccj_history_limits(lim)
            if tuple(lim) != (HISTORY_MAX_WINDOWS, HISTORY_MAX_PARTS, HISTORY_MAX_SEGS,
                              HISTORY_MAX_TABLES):
                raise RuntimeError("HISTORY_MAX_* do not match csrc/history.cu")
            lib.ccj_history_min.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.ccj_history_min.restype = ctypes.c_int
            if lib.ccj_p_split_table_bytes() != ctypes.sizeof(PSplitTable):
                raise RuntimeError(
                    f"cuda_ops.PSplitTable ({ctypes.sizeof(PSplitTable)} B) does not "
                    f"mirror csrc/psplit.cu ({lib.ccj_p_split_table_bytes()} B)")
            lib.ccj_p_split.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.ccj_p_split.restype = ctypes.c_int
            if lib.ccj_stencil_table_bytes() != ctypes.sizeof(StencilTable):
                raise RuntimeError(
                    f"cuda_ops.StencilTable ({ctypes.sizeof(StencilTable)} B) does not "
                    f"mirror csrc/stencil.cu ({lib.ccj_stencil_table_bytes()} B)")
            if lib.ccj_stencil_max_parts() != STENCIL_MAX_PARTS:
                raise RuntimeError("STENCIL_MAX_PARTS does not match csrc/stencil.cu")
            if lib.ccj_stencil_ds() != DS:
                raise RuntimeError("gapped.DS does not match csrc/stencil.cu kDS")
            lib.ccj_stencil.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.ccj_stencil.restype = ctypes.c_int
            for fn, struct, src in (("ccj_assemble_table_bytes", AssembleTable, "assemble"),
                                    ("ccj_store_table_bytes", StoreTable, "store")):
                if getattr(lib, fn)() != ctypes.sizeof(struct):
                    raise RuntimeError(
                        f"cuda_ops.{struct.__name__} ({ctypes.sizeof(struct)} B) does not "
                        f"mirror csrc/{src}.cu ({getattr(lib, fn)()} B)")
            lim = (ctypes.c_int * 3)()
            lib.ccj_assemble_limits(lim)
            if tuple(lim) != (len(ASSEMBLE_READS), PLANE_MAX_PARTS, len(ASSEMBLE_HISTORY)):
                raise RuntimeError("ASSEMBLE_READS / PLANE_MAX_PARTS / ASSEMBLE_HISTORY do "
                                   "not match csrc/assemble.cu")
            reads = (ctypes.c_int * (4 * len(ASSEMBLE_READS)))()
            lib.ccj_assemble_reads(reads)
            if [tuple(reads[4 * q:4 * q + 4]) for q in range(len(ASSEMBLE_READS))] != [
                    tuple(r[1:]) for r in ASSEMBLE_READS]:
                raise RuntimeError("ASSEMBLE_READS' (c, b, di, dj) do not match "
                                   "csrc/assemble.cu")
            lib.ccj_store_limits(lim)
            if tuple(lim[:2]) != (STORE_MAX_DESTS, STORE_BLOCK_VECS):
                raise RuntimeError("STORE_MAX_DESTS / STORE_BLOCK_VECS do not match "
                                   "csrc/store.cu")
            if lib.ccj_span2d_table_bytes() != ctypes.sizeof(Span2dTable):
                raise RuntimeError(
                    f"cuda_ops.Span2dTable ({ctypes.sizeof(Span2dTable)} B) does not "
                    f"mirror csrc/span2d.cu ({lib.ccj_span2d_table_bytes()} B)")
            lib.ccj_span2d_limits(lim)
            if tuple(lim) != (len(SPAN2D_OPERANDS), MAXLOOP + 2, len(SPAN2D_KINDS)):
                raise RuntimeError("SPAN2D_OPERANDS / MAXLOOP / SPAN2D_KINDS do not match "
                                   "csrc/span2d.cu")
            for fn in (lib.ccj_span_assemble, lib.ccj_span_store, lib.ccj_span2d):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def batch_of(slab, w):
    """The batch size of a window's operands: None for a [R, I, C] slab with
    [Q, J] weights, B for a [B, R, I, C] slab with [B, Q, J] weights; raises
    on any other pairing."""
    if slab.dim() == 3 and w.dim() == 2:
        return None
    if slab.dim() == 4 and w.dim() == 3:
        if slab.shape[0] != w.shape[0]:
            raise ValueError(f"slab batch {slab.shape[0]} != w batch {w.shape[0]}")
        return slab.shape[0]
    raise ValueError(f"slab must be [R, I, C] and w [Q, J], or both with a "
                     f"leading batch axis; got {tuple(slab.shape)}, {tuple(w.shape)}")


def _check_window(slab, w, row0, col0, q_lo, mode, J=None, wcol=0):
    """Raise unless rows [row0, row0 + Q) x columns [col0, col0 + J) lie in
    ``slab`` and columns [wcol, wcol + J) in ``w`` (Q = w's rows; J
    defaults to w's columns), in every element of a batch."""
    batch_of(slab, w)
    if slab.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"slab and w must be int32, got {slab.dtype}, {w.dtype}")
    Q, WC = w.shape[-2:]
    J = WC if J is None else J
    R, _, C = slab.shape[-3:]
    if not (0 <= row0 and row0 + Q <= R and 0 <= col0 and col0 + J <= C):
        raise ValueError(f"window rows [{row0}, {row0 + Q}) x cols "
                         f"[{col0}, {col0 + J}) leaves slab {tuple(slab.shape)}")
    if not (0 <= wcol and wcol + J <= WC):
        raise ValueError(f"weight cols [{wcol}, {wcol + J}) leave w {tuple(w.shape)}")
    if q_lo < 0 or mode not in (0, 1, 2):
        raise ValueError(f"bad q_lo={q_lo} or mode={mode}")


def _check_devices(tensors):
    """The one CUDA device all ``tensors`` lie on; raises otherwise."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("a kernel needs every operand on one CUDA device "
                         f"(or all on the CPU), got {[str(t.device) for t in tensors]}")
    return dev


def _launch(fn, dev, what, *args):
    """``fn(*args)`` on ``dev``'s stream; raises on a failed launch."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:   # a launch goes to the stream's own device only
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


@dataclass(frozen=True)
class WindowSpec:
    """One min-plus window as a function of the step ``tt``.

    ``row0`` (slab row of q = 0), ``col0`` (slab column of j = 0), ``wcol``
    (weight column of j = 0) and ``c`` (the mask's constant) are
    ``(base, step)`` pairs: the value at ``tt`` is ``base + step * tt``.
    The window reads weight rows [0, Q) with Q = ``w.shape[-2]``.  ``slab``
    [R, I, C] and ``w`` [Q, J], or both with a leading batch axis.
    """
    slab: torch.Tensor
    w: torch.Tensor
    row0: tuple[int, int]
    col0: tuple[int, int] = (0, 0)
    wcol: tuple[int, int] = (0, 0)
    q_lo: int = 0
    mode: int = 0
    c: tuple[int, int] = (0, 0)

    def at(self, tt: int):
        """(row0, col0, wcol, c) at ``tt``."""
        return tuple(b + s * tt for b, s in (self.row0, self.col0, self.wcol, self.c))

    def check(self, tt: int, J: int):
        row0, col0, wcol, _ = self.at(tt)
        _check_window(self.slab, self.w, row0, col0, self.q_lo, self.mode, J, wcol)

    def slab_window(self):
        """What fixes the slab terms this window reads at every tt: two
        windows with equal keys differ only in their weights."""
        return (self.slab.data_ptr(), tuple(self.slab.shape), self.slab.stride(),
                self.row0, self.col0, self.wcol, self.q_lo, self.mode, self.c)


def pair_windows(windows):
    """The kernel's descriptors for ``windows``: tuples of one window index,
    or of two whose slab window is the same (:meth:`WindowSpec.slab_window`),
    so the kernel reads those slab terms once for both."""
    jobs, open_ = [], {}
    for g, win in enumerate(windows):
        k = open_.pop(win.slab_window(), None)
        if k is None:
            open_[win.slab_window()] = len(jobs)
            jobs.append((g,))
        else:
            jobs[k] += (g,)
    return jobs


class WindowTable:
    """A group of windows that share Q (weight rows), I (slab rows' width)
    and J (output columns), validated once for every tt in ``tt_range`` =
    (lo, hi): each offset is affine in tt, so a window inside its slab at
    both ends is inside at every step between.  On CUDA it also holds the
    kernel's descriptor array (``jobs``: windows that share a slab window
    share a descriptor) and their batch strides, and the tensors it points
    into stay alive with it.  The output of a step is ``[G, I, J]`` int32,
    or ``[B, G, I, J]`` when every window's operands carry a leading batch
    axis of B (``shape``; ``batch`` is None or B)."""

    def __init__(self, windows, J: int, tt_range: tuple[int, int]):
        self.windows = tuple(windows)
        self.tt_lo, self.tt_hi = tt_range
        if not 1 <= len(self.windows) <= MAX_WINDOWS:
            raise ValueError(f"a group holds 1..{MAX_WINDOWS} windows, "
                             f"got {len(self.windows)}")
        if self.tt_lo > self.tt_hi:
            raise ValueError(f"empty tt range {tt_range}")
        first = self.windows[0]
        self.Q, self.I, self.J = first.w.shape[-2], first.slab.shape[-2], J
        self.batch = batch_of(first.slab, first.w)
        for win in self.windows:
            for tt in tt_range:
                win.check(tt, J)
            if win.w.shape[-2] != self.Q or win.slab.shape[-2] != self.I:
                raise ValueError("the windows of a group must share Q and I")
            if batch_of(win.slab, win.w) != self.batch:
                raise ValueError("the windows of a group must share their "
                                 "batch size (or all have none)")
        G = len(self.windows)
        self.shape = ((G, self.I, self.J) if self.batch is None
                      else (self.batch, G, self.I, self.J))
        tensors = [t for win in self.windows for t in (win.slab, win.w)]
        if all(t.device.type == "cpu" for t in tensors):
            self.device = torch.device("cpu")
            self.jobs = pair_windows(self.windows)
            return
        self.device = _check_devices(tensors)
        self._fn = _library().ccj_minplus_group
        self.jobs = pair_windows(self.windows)
        if len(self.jobs) * (self.batch or 1) > MAX_GRID_Z:
            raise ValueError(f"{len(self.jobs)} descriptors x batch {self.batch} "
                             f"exceed the grid's {MAX_GRID_Z} z blocks")
        for win in self.windows:   # the kernel's offsets within an element are int32
            span = sum((n - 1) * st for n, st in zip(win.slab.shape[-3:],
                                                     win.slab.stride()[-3:]))
            if span >= 2 ** 31:
                raise ValueError(f"slab {tuple(win.slab.shape)} spans 2^31 "
                                 "elements or more per batch element")
        lead = 0 if self.batch is None else 1
        descs = (Window * len(self.jobs))()
        strides = (BatchStrides * len(self.jobs))()
        for d, bs, job in zip(descs, strides, self.jobs):
            win = self.windows[job[0]]
            d.slab, (d.ss0, d.ss1, d.ss2) = win.slab.data_ptr(), win.slab.stride()[lead:]
            d.w, (d.ws0, d.ws1) = win.w.data_ptr(), win.w.stride()[lead:]
            if lead:
                bs.slab, bs.w = win.slab.stride(0), win.w.stride(0)
            d.row0_b, d.row0_s = win.row0
            d.scol_b, d.scol_s = win.col0
            d.wcol_b, d.wcol_s = win.wcol
            d.q_lo, d.mode = win.q_lo, win.mode
            d.c_b, d.c_s = win.c
            d.out = d.out2 = job[0]
            if len(job) == 2:
                w2 = self.windows[job[1]].w
                d.w2, (d.w2s0, d.w2s1), d.out2 = w2.data_ptr(), w2.stride()[lead:], job[1]
                if lead:
                    bs.w2 = w2.stride(0)
        self._descs, self._strides = descs, strides

    def check_tt(self, tt: int):
        if not self.tt_lo <= tt <= self.tt_hi:
            raise ValueError(f"tt={tt} outside the table's range "
                             f"[{self.tt_lo}, {self.tt_hi}]")


# The tt step's 13 k-shrink / j-shrink reductions, in the order the step
# reads them: (slab, weight table, kind, masked).  Kind "k" is red_k: rows
# tt+1.. of an A slab, weights WKX[:, tt+2: tt+2+n2], mask mode 1
# (d <= G - 1, i.e. q <= s - 4 - tt - (j - i)).  Kind "j" is red_j: rows
# tt+1.. and columns tt.. of a u-skewed B slab ("B_" + family), weights
# WJX, mask mode 2 (d <= (j - i) - 1, i.e. q <= j - i - 2).
REDUCTIONS = (
    ("B_PLmloop00", "WB", "j", False),       # PLmloop00
    ("B_PLmloop00", "WBP", "j", False),      # PLmloop01
    ("B_PLmloop10", "WB", "j", True),        # PLmloop10
    ("PRmloop00", "WB", "k", False),         # PRmloop00
    ("PRmloop00", "WBP", "k", False),        # PRmloop10
    ("B_PMmloop00", "WB", "j", False),       # PMmloop00
    ("PMmloop00", "WB", "k", False),         # PMmloop00
    ("B_PfromL", "WP", "j", True),           # PfromL
    ("PfromR", "WP", "k", True),             # PfromR
    ("B_PfromMprime", "WP", "j", True),      # PfromM
    ("mdp", "WP", "k", True),                # PfromMprime
    ("B_PK", "WP", "j", True),               # PK
    ("PK", "WP", "k", True),                 # PK
)


def reduction_table(slabs, WKX, WJX, s, n2, i0=0):
    """The descriptor table of one span's :data:`REDUCTIONS`, valid for
    every tt in [0, s - 2]; ``slabs`` maps the slab names to the span's
    A / B slabs (and ``mdp``), ``WKX`` / ``WJX`` the weight names to their
    tables, all with or all without a leading batch axis.  Slab row r is
    i = i0 + r: both masks read i - c, so the row offset moves into c."""
    wins = []
    for slab, wn, kind, masked in REDUCTIONS:
        if kind == "k":
            wins.append(WindowSpec(
                slabs[slab], WKX[wn], row0=(1, 1), wcol=(2, 1),
                mode=1 if masked else 0, c=(s - 4 + i0, -1)))
        else:
            wins.append(WindowSpec(
                slabs[slab], WJX[wn], row0=(1, 1), col0=(0, 1),
                mode=2 if masked else 0, c=(2 + i0, 0)))
    return WindowTable(wins, n2, (0, s - 2))


def minplus_window_ref(slab, w, row0, col0=0, q_lo=0, mode=0, c=0):
    """Plain PyTorch version of :func:`minplus_window` (same arguments;
    ``slab`` and ``w`` may carry a leading batch axis, which the result
    keeps)."""
    Q, J = w.shape[-2:]
    I = slab.shape[-2]
    if q_lo >= Q:
        return torch.full((*slab.shape[:-3], I, J), INF, dtype=torch.int32,
                          device=slab.device)
    dev = slab.device
    q = torch.arange(Q, device=dev)[:, None, None]
    i = torch.arange(I, device=dev)[None, :, None]
    j = torch.arange(J, device=dev)[None, None, :]
    keep = q >= q_lo
    if mode == 1:
        keep = keep & (q <= c - j + i)
    elif mode == 2:
        keep = keep & (q <= j - i - c)
    vals = slab[..., row0:row0 + Q, :, col0:col0 + J] + w[..., :, None, :]
    return torch.where(keep, vals, INF).amin(dim=-3).clamp(max=INF)


def minplus_group_ref(table: WindowTable, tt: int):
    """Plain PyTorch version of :func:`minplus_group`: each window of
    ``table`` evaluated at ``tt`` through :func:`minplus_window_ref`.
    Returns a new ``table.shape`` ([G, I, J] or [B, G, I, J]) int32
    tensor."""
    table.check_tt(tt)
    outs = []
    for win in table.windows:
        row0, col0, wcol, c = win.at(tt)
        outs.append(minplus_window_ref(win.slab, win.w[..., wcol:wcol + table.J],
                                       row0, col0, win.q_lo, win.mode, c))
    return torch.stack(outs, dim=-3)


def minplus_group(table: WindowTable, tt: int, out):
    """Reduce every window of ``table`` at step ``tt`` into ``out``
    (``table.shape`` int32, contiguous, on the table's device) with one
    kernel launch; returns ``out``.  Window g gives out[g] (out[b, g] for
    batch element b) = :func:`minplus_window` of its slab and weights at
    ``tt``.  The kernel writes ``out`` in stream
    order: a caller that reuses ``out`` across steps must enqueue every
    read of one step's results before the next step's launch."""
    table.check_tt(tt)
    if (tuple(out.shape) != table.shape or out.dtype != torch.int32
            or out.device != table.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {table.shape} tensor "
                         f"on {table.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if table.device.type == "cpu":
        return out.copy_(minplus_group_ref(table, tt))
    return _minplus_group_cuda(table, tt, out)


def _minplus_group_cuda(table, tt, out):
    global LAUNCHES, WINDOWS
    G, I, J = table.shape[-3:]
    B = table.batch or 1
    _launch(table._fn, table.device, "minplus_group", table._descs, table._strides,
            len(table.jobs), B, G, tt, out.data_ptr(), I, J, table.Q,
            torch.cuda.current_stream(table.device).cuda_stream)
    LAUNCHES += 1
    WINDOWS += G * B
    return out


def minplus_window(slab, w, row0, col0=0, q_lo=0, mode=0, c=0):
    """out[i, j] = min over q in [q_lo, Q) with mask(q, i, j) of
    slab[row0 + q, i, col0 + j] + w[q, j]; INF when no term survives.

    slab: [R, I, C] int32 and w: [Q, J] int32, INF-encoded, read in place
    through their strides (any views).  ``mode`` 0: no mask; 1:
    ``q <= c - j + i`` (red_k's k1 bound, c = s - 4 - tt); 2:
    ``q <= j - i - c`` (red_j's j1 bound, c = 2).  Raises when the window
    leaves the slab.  Returns a new [I, J] int32 tensor ([B, I, J] for
    operands with a leading batch axis).  On CUDA it is a group of one
    through :func:`minplus_group`'s kernel.
    """
    if slab.device.type == "cpu" and w.device.type == "cpu":
        _check_window(slab, w, row0, col0, q_lo, mode)
        return minplus_window_ref(slab, w, row0, col0, q_lo, mode, c)
    # the table checks the window as it is built
    table = WindowTable([WindowSpec(slab, w, (row0, 0), (col0, 0), (0, 0),
                                    q_lo, mode, (c, 0))], w.shape[-1], (0, 0))
    out = torch.empty(table.shape, dtype=torch.int32, device=table.device)
    return _minplus_group_cuda(table, 0, out).select(-3, 0)


def minplus_suffix_ref(slab, w, lo):
    """Plain form of :func:`minplus_suffix`."""
    return minplus_window_ref(slab, w, 0, 0, max(int(lo) + 1, 0))


def minplus_suffix(slab, w, lo):
    """out[i, j] = min over tp > lo of slab[tp, i, j] + w[tp, j], INF when
    no row survives — ``pallas_ops.minplus_suffix``'s function."""
    return minplus_window(slab, w, 0, 0, max(int(lo) + 1, 0))


# ---------------------------------------------------------------------------
# tt_step: the rest of the tt loop's step, after its 13 reductions
# ---------------------------------------------------------------------------

# csrc/ttstep.cu's operand order.  STEP_FAMILIES are the loop's 14 families
# (``ttloop.LOOP_MATS_ALL``), STEP_B_SLABS those that also keep a u-skewed
# (B) slab for the j-shrink reductions of the step-by-step loop, STEP_BASES
# the 7 span-constant cross-span reduction bases; the step's reductions are
# :data:`REDUCTIONS`, in that order.
STEP_FAMILIES = ("PLmloop00", "PLmloop01", "PLmloop10", "PRmloop00",
                 "PRmloop10", "PMmloop00", "PMmloop01", "PMmloop10",
                 "PM", "PfromL", "PfromR", "PfromM", "PfromMprime", "PK")
STEP_B_SLABS = ("PK", "PLmloop00", "PLmloop10", "PMmloop00", "PfromL",
                "PfromMprime")
STEP_BASES = ("PLmloop00", "PLmloop10", "PRmloop00", "PMmloop01",
              "PMmloop10", "PfromL", "PfromR")
STEP_REDUCTIONS = len(REDUCTIONS)
MAX_GRID_Y = 65535      # CUDA's grid.y limit: the step's batch


class Plane(ctypes.Structure):
    """One operand of the step: csrc/ttstep.cu's ``struct Plane``, its base
    pointer and its element strides over (batch, row, i, j); a null
    pointer where a family has no B slab."""
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong * 4)]


def _plane(x, lead=True):
    """A Plane of x over (batch, row, i, j): a 3-D x is [batch, row, j]
    with lead, [row, i, j] without."""
    st = list(x.stride())
    if not lead:
        st = [0] + st
    elif x.dim() == 3:
        st = st[:2] + [0] + st[2:]
    return Plane(x.data_ptr(), (ctypes.c_longlong * 4)(*st))


def _need(name, x, shape, dtype=torch.int32):
    """Raise unless x has len(shape) axes, each at least its entry (an int)
    or exactly it (a 1-tuple), and ``dtype``."""
    ok = x.dim() == len(shape) and all(
        (d == w[0]) if isinstance(w, tuple) else d >= w
        for d, w in zip(x.shape, shape))
    if not ok:
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not fit {shape} "
                         f"(an int is a least size, a 1-tuple an exact one)")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")


class StepTable(ctypes.Structure):
    """One span's operands of :func:`tt_step`, valid for every tt in
    [0, s - 2]: csrc/ttstep.cu's ``struct StepTable``, field for field, built
    and checked once per span and passed to the kernel by value.

    ``red``: the step's reductions, ``[B, 13, IB, n2]`` (what
    :func:`minplus_group` writes at each step); ``bases``: the 7
    :data:`STEP_BASES` planes ``[B, >= s - 1, IB, n2]``, read at row tt;
    ``cur``: the 14 families' A slabs ``[B, >= s + 1, IB, n2]`` (rows tt + 1
    and tt + 2 read, row tt written) and, as ``"B_" + name``, the 6 B slabs
    ``[B, >= s - 1, IB, >= n2 + s - 2]`` (row tt written at columns
    [tt, tt + n2)); ``stm``: the same-span PM slab ``[B, >= s - 1 + 2 DS, IB,
    UB + DS]`` (rows tt + 2 .. tt + 2 DS read, row tt written at columns
    [tt, tt + n2)); ``dpm``: the PM stencil weights ``[B, DS, DS, >= s - 1,
    >= UB]``; ``jk``: the (canp, ptype, ESTP) diagonal rows ``[B, >= s - 1,
    n2]``; ``valid``: ``[>= s - 1, IB, n2]`` bool, shared by the batch;
    ``pl``, ``pr``, ``po``: the span's PL / PR / PO planes ``[B, >= s - 1,
    IB, n2]``.  Every operand is int32 but ``valid``, all on one CUDA device
    or all on the CPU; raises otherwise.  Slab row r is i = ``i0`` + r.  The
    tensors stay alive with the table (``ops``), which the plain version
    reads."""
    _fields_ = [("red", Plane), ("base", Plane * len(STEP_BASES)),
                ("cur", Plane * len(STEP_FAMILIES)),
                ("bslab", Plane * len(STEP_FAMILIES)),
                ("stm", Plane), ("jk", Plane * 3), ("valid", Plane),
                ("pl", Plane), ("pr", Plane), ("po", Plane),
                ("dpm", ctypes.c_void_p), ("dpm_s", ctypes.c_longlong * 5),
                ("B", ctypes.c_int), ("s", ctypes.c_int), ("i0", ctypes.c_int),
                ("IB", ctypes.c_int), ("n2", ctypes.c_int), ("bp", ctypes.c_int),
                ("cp", ctypes.c_int), ("ap", ctypes.c_int), ("PB", ctypes.c_int),
                ("SAT16", ctypes.c_int), ("INF", ctypes.c_int)]

    def __init__(self, red, bases, cur, stm, dpm, jk, valid, pl, pr, po, *,
                 s: int, i0: int, bp: int, cp: int, ap: int, PB: int):
        super().__init__()
        if s < 2:
            raise ValueError(f"span {s} has no tt step")
        if red.dim() != 4 or red.shape[1] != STEP_REDUCTIONS:
            raise ValueError(f"red must be [B, {STEP_REDUCTIONS}, IB, n2], "
                             f"got {tuple(red.shape)}")
        B, _, IB, n2 = red.shape
        self.ops = ops = {"red": red, "bases": dict(bases), "cur": dict(cur),
                          "stm": stm, "dpm": dpm, "jk": tuple(jk), "valid": valid,
                          "pl": pl, "pr": pr, "po": po}
        self.tt_lo, self.tt_hi = 0, s - 2
        self.pm_bounds = None             # the plain stencil's, at its first call
        T = s - 1                             # rows [0, s - 2] are read
        UB = stm.shape[-1] - DS

        E = (B,), (IB,), (n2,)
        _need("red", red, (*E[:1], (STEP_REDUCTIONS,), *E[1:]))
        if set(bases) != set(STEP_BASES):
            raise ValueError(f"bases must be {STEP_BASES}, got {sorted(bases)}")
        for name in STEP_BASES:
            _need(f"bases[{name}]", bases[name], (E[0], T, *E[1:]))
        want = set(STEP_FAMILIES) | {"B_" + nm for nm in STEP_B_SLABS}
        if not want <= set(cur):
            raise ValueError(f"cur lacks {sorted(want - set(cur))}")
        for name in STEP_FAMILIES:
            _need(f"cur[{name}]", cur[name], (E[0], s + 1, *E[1:]))
        for name in STEP_B_SLABS:
            _need(f"cur[B_{name}]", cur["B_" + name], (E[0], T, E[1], n2 + s - 2))
        _need("stm", stm, (E[0], T + 2 * DS, E[1], n2 + s - 2 + DS))
        if not stm.is_contiguous():
            raise ValueError("stm must be contiguous (the plain stencil views it "
                             "through its own strides)")
        _need("dpm", dpm, (E[0], (DS,), (DS,), T, UB))
        if len(ops["jk"]) != 3:
            raise ValueError("jk must be (canp, ptype, ESTP) rows")
        for k, x in enumerate(ops["jk"]):
            _need(f"jk[{k}]", x, (E[0], T, E[2]))
        _need("valid", valid, (T, *E[1:]), torch.bool)
        for name in ("pl", "pr", "po"):
            _need(name, ops[name], (E[0], T, *E[1:]))

        tensors = [red, *bases.values(), *(cur[nm] for nm in want), stm, dpm,
                   *ops["jk"], valid, pl, pr, po]
        if all(t.device.type == "cpu" for t in tensors):
            self.device = torch.device("cpu")
        else:
            self.device = _check_devices(tensors)
            if B > MAX_GRID_Y:
                raise ValueError(f"batch {B} exceeds the grid's {MAX_GRID_Y} y blocks")
            self._fn = _library().ccj_tt_step

        self.red = _plane(red)
        for k, name in enumerate(STEP_BASES):
            self.base[k] = _plane(bases[name])
        for k, name in enumerate(STEP_FAMILIES):
            self.cur[k] = _plane(cur[name])
            if name in STEP_B_SLABS:
                self.bslab[k] = _plane(cur["B_" + name])
        self.stm = _plane(stm)
        for k, x in enumerate(ops["jk"]):
            self.jk[k] = _plane(x)
        self.valid = _plane(valid, lead=False)
        self.pl, self.pr, self.po = _plane(pl), _plane(pr), _plane(po)
        self.dpm = dpm.data_ptr()
        self.dpm_s = (ctypes.c_longlong * 5)(*dpm.stride())
        self.B, self.s, self.i0, self.IB, self.n2 = B, s, i0, IB, n2
        self.bp, self.cp, self.ap, self.PB = bp, cp, ap, PB
        self.SAT16, self.INF = SAT16, INF

    def check_tt(self, tt: int):
        if not self.tt_lo <= tt <= self.tt_hi:
            raise ValueError(f"tt={tt} outside the table's range "
                             f"[{self.tt_lo}, {self.tt_hi}]")


def _enc(v, vmask):
    """Store-encode a plane: int16-clamped value on valid cells, INF on
    invalid ones."""
    return torch.where(vmask, v.clamp(-32768, SAT16), INF)


def pm_bounds(s, IB, UB, dev, i0=0):
    """The span-constant parts of the PM stencil's loop bounds: d1 (as
    [1, DS, 1, 1]), the d1 bound's tt-free part u - i - 1, and the whole
    d2 mask d2 <= (i + s - u - 2) - 1 ([DS, 1, IB, UB]); rows are
    i = i0 + r."""
    d = torch.arange(1, DS + 1, device=dev)
    i = torch.arange(i0, i0 + IB, device=dev)[:, None]
    u = torch.arange(UB, device=dev)[None, :]
    return (d[None, :, None, None], u - i - 1,
            d[:, None, None, None] <= (i + s - u - 2) - 1)


def pm_stencil(STM, DPM, tt, bounds):
    """The PM interior-loop stencil over the same-span STM slab, in u
    coordinates: pm_acc[i, u] = min(INF, min over d1, d2 in [1, DS] of
    STM[tt + d1 + d2, i, u + d2] + DPM[d1 - 1, d2 - 1, tt, u]) under the
    d1 <= (u - tt) - i - 1 and d2 <= (i + s - u - 2) - 1 bounds
    (:func:`pm_bounds`).

    The JAX loop over d2 becomes one strided view X[b, d2, d1, i, u] of the
    slab: row tt + 2 + (d1 - 1) + (d2 - 1), column u + d2, of batch element
    b.  STM is [B, rows, IB, UB + DS], contiguous, its last DS columns INF
    (the reads past u = UB - 1); DPM is [B, DS, DS, T, U].
    """
    d1, lim1, mask2 = bounds
    B, _, IB, W = STM.shape
    UB = W - DS
    sR = IB * W
    X = STM.as_strided((B, DS, DS, IB, UB), (STM.stride(0), sR + 1, sR, W, 1),
                       STM.storage_offset() + (tt + 2) * sR + 1)
    dpm = DPM.select(3, tt).narrow(-1, 0, UB)                # [B, d1, d2, u]
    mask = (d1 <= lim1 - tt) & mask2
    vals = torch.where(mask, X + dpm.transpose(1, 2)[:, :, :, None, :], INF)
    return vals.amin(dim=(1, 2)).clamp(max=INF)


def tt_step_ref(table: StepTable, tt: int):
    """Plain PyTorch version of :func:`tt_step`: the tt loop's step body
    after its reductions, on ``table``'s tensors in place."""
    table.check_tt(tt)
    o = table.ops
    cur, bases, valid4 = o["cur"], o["bases"], o["valid"]
    bp, cp, ap, PB = table.bp, table.cp, table.ap, table.PB
    s, i0, n2 = table.s, table.i0, table.n2
    STM = o["stm"]
    if table.pm_bounds is None:
        table.pm_bounds = pm_bounds(s, table.IB, STM.shape[-1] - DS, STM.device, i0)
    (r_pl00, r_pl01, r_pl10, r_pr00, r_pr10, r_pm00_j, r_pm00_k, r_fl,
     r_fr, r_fm, r_fmp, r_pk_j, r_pk_k) = o["red"].unbind(1)

    def plane_cur(slab, c, dj):
        sl = slab.select(1, tt + c)
        if dj == -1:
            sl = torch.nn.functional.pad(sl, (1, 0), value=INF).narrow(-1, 0, n2)
        return sl

    def base_at(name):
        return bases[name].select(1, tt)

    out = {}
    out["PLmloop00"] = mmin(SAT16 + bp, base_at("PLmloop00"), r_pl00)
    out["PLmloop01"] = r_pl01
    out["PLmloop10"] = torch.minimum(base_at("PLmloop10"), r_pl10)
    out["PRmloop00"] = mmin(SAT16 + bp, base_at("PRmloop00"), r_pr00)
    out["PRmloop10"] = torch.minimum(
        plane_cur(cur["PRmloop10"], 1, 0) + cp, r_pr10)
    out["PMmloop00"] = mmin(SAT16 + bp, r_pm00_j, r_pm00_k)
    out["PMmloop01"] = torch.minimum(
        plane_cur(cur["PMmloop01"], 1, 0) + cp, base_at("PMmloop01"))
    out["PMmloop10"] = torch.minimum(
        plane_cur(cur["PMmloop10"], 1, -1) + cp, base_at("PMmloop10"))

    # PM interior stencil over the same-span STM slab (u-coordinates)
    pm_acc = pm_stencil(STM, o["dpm"], tt, table.pm_bounds)
    pm_int = pm_acc.narrow(-1, tt, n2)

    CJK, PJK, EJK = o["jk"]
    canp_jk = CJK.narrow(1, tt, 1)
    pt_jk = PJK.narrow(1, tt, 1)
    estp_jk = EJK.narrow(1, tt, 1)
    pm_stack = plane_cur(cur["PM"], 2, -1) + estp_jk
    PMiloop = torch.where(canp_jk > 0, torch.minimum(pm_stack, pm_int), INF)
    PMmloop_v = torch.minimum(plane_cur(cur["PMmloop10"], 2, -1),
                              plane_cur(cur["PMmloop01"], 2, -1)) + ap + bp
    PM_b3 = plane_cur(cur["PfromM"], 2, -1)  # k >= j+TURN-1 always holds
    # PM's base case (i == j and k == l) meets (i, j) at tt = s - 2
    ir = torch.arange(i0, i0 + table.IB, device=STM.device)[:, None]
    jr = torch.arange(n2, device=STM.device)[None, :]
    PM_b4 = torch.where((ir == jr) & (tt == s - 2), 0, INF)
    PMv = torch.where(pt_jk > 0,
                      mmin(PMiloop, PMmloop_v + bp, PM_b3, PM_b4), INF)
    out["PM"] = PMv

    vmask = valid4[tt]
    PMs_t = _enc(PMv, vmask)
    PLs_t = o["pl"].select(1, tt)
    PRs_t = o["pr"].select(1, tt)
    POs_t = o["po"].select(1, tt)

    out["PfromL"] = mmin(base_at("PfromL"), r_fl,
                         PRs_t + PB, PMs_t + PB, POs_t + PB)
    out["PfromR"] = mmin(base_at("PfromR"), r_fr, PMs_t + PB, POs_t + PB)
    out["PfromM"] = r_fm
    out["PfromMprime"] = r_fmp
    out["PK"] = mmin(r_pk_j, r_pk_k,
                     PLs_t + PB, PMs_t + PB, PRs_t + PB, POs_t + PB)

    # write-back of row tt (the B slabs store it at columns u = j + tt)
    for name in STEP_FAMILIES:
        encp = PMs_t if name == "PM" else _enc(out[name], vmask)
        cur[name].select(1, tt).copy_(encp)
        if name in STEP_B_SLABS:
            cur["B_" + name].select(1, tt).narrow(-1, tt, n2).copy_(encp)
    STM.select(1, tt).narrow(-1, tt, n2).copy_(PMs_t)


def tt_step(table: StepTable, tt: int):
    """Step ``tt`` of the tt loop after its reductions (``table.ops["red"]``,
    written by this step's :func:`minplus_group`): assemble the 14 families'
    row tt, the PM interior stencil at the columns the step keeps (u = j +
    tt), store-encode it and write it into row tt of every ``cur`` slab,
    columns [tt, tt + n2) of row tt of every B slab and of ``stm``.  One
    kernel launch on CUDA, in stream order after the reductions; the plain
    version (:func:`tt_step_ref`) for CPU tensors."""
    global TT_STEP_LAUNCHES
    table.check_tt(tt)
    if table.device.type == "cpu":
        return tt_step_ref(table, tt)
    _launch(table._fn, table.device, "tt_step", ctypes.addressof(table), tt,
            torch.cuda.current_stream(table.device).cuda_stream)
    TT_STEP_LAUNCHES += 1


# ---------------------------------------------------------------------------
# tt_span: a span's whole tt loop in one launch
# ---------------------------------------------------------------------------

MAX_SPAN_N2 = 512       # csrc/ttspan.cu kMaxN2
MAX_SPAN_JOBS = 16      # csrc/ttspan.cu kMaxJobs
SPAN_WEIGHTS = ("WP", "WB", "WBP")


def span_valid(n, s, i0, T, IB, n2, device="cpu"):
    """The span's valid cells, ``[T, IB, n2]`` bool: (tt, i0 + r, j) with
    i >= 1, j >= i, j + tt + 2 <= i + s and i + s <= n: the fills' ``valid4``
    (``gapped4.span_families``, ``pf4d``) and the plain loop's mask; the
    kernel computes the same from ``n``."""
    tt = torch.arange(T, device=device)[:, None, None]
    i = torch.arange(i0, i0 + IB, device=device)[None, :, None]
    j = torch.arange(n2, device=device)[None, None, :]
    return (i >= 1) & (j >= i) & (j + tt + 2 <= i + s) & (i + s <= n)


class SpanPlan(ctypes.Structure):
    """The knobs of one :func:`tt_span` launch and what it launched:
    csrc/ttspan.cu's ``struct SpanPlan``.  In: ``threads`` a block (0: the
    plan's), ``cluster`` blocks a row (1, 2 or 4, each holding the whole
    band and a share of the step's tasks; 0: the plan's), ``rows`` of the
    band held on chip at most (0: all that fit), ``stage`` the weights in
    shared memory (1), through ``__ldg`` (0) or the plan's choice (-1).
    Out: the same as launched, ``live`` rows a batch element, ``smem``
    bytes a block and ``active`` clusters of the launched size the card
    runs at once."""
    KNOBS = ("threads", "cluster", "rows", "stage")
    _fields_ = [(nm, ctypes.c_int) for nm in (*KNOBS, "live", "smem", "active")]


class SpanJob(ctypes.Structure):
    """One reduction descriptor of :func:`tt_span`: csrc/ttspan.cu's
    ``struct Job``.  ``src`` indexes :data:`STEP_FAMILIES` (its length:
    mdp); ``kind`` 0 is red_k, 1 red_j (read through the family's A slab);
    ``w`` / ``w2`` index the six weight planes (WKX's :data:`SPAN_WEIGHTS`,
    then WJX's), ``w2`` -1 for none; ``out`` / ``out2`` are reductions of
    :data:`REDUCTIONS`."""
    _fields_ = [(nm, ctypes.c_int)
                for nm in ("src", "kind", "masked", "w", "out", "w2", "out2")]


def span_jobs():
    """The kernel's descriptors for :data:`REDUCTIONS`: one per (family,
    kind, mask), a red_j window's B slab read through its family's A slab;
    two windows that differ only in their weights share one."""
    jobs, index = [], {}
    for g, (slab, wn, kind, masked) in enumerate(REDUCTIONS):
        fam = slab[2:] if slab.startswith("B_") else slab
        src = len(STEP_FAMILIES) if fam == "mdp" else STEP_FAMILIES.index(fam)
        w = SPAN_WEIGHTS.index(wn) + (0 if kind == "k" else len(SPAN_WEIGHTS))
        key = (src, kind, masked)
        if key in index:
            job = jobs[index[key]]
            job.w2, job.out2 = w, g
        else:
            index[key] = len(jobs)
            jobs.append(SpanJob(src, int(kind == "j"), int(masked), w, g, -1, -1))
    return jobs


class SpanTable(ctypes.Structure):
    """One span's operands of :func:`tt_span`, valid for its whole loop
    (tt = s - 2 .. 0): csrc/ttspan.cu's ``struct SpanTable``, field for
    field, built and checked once per span and passed to the kernel by
    value.

    ``cur``: the 14 families' slabs ``[B, >= s - 1 + Q, IB, n2]``; ``mdp``:
    the PfromMdoubleprime slab, the same shape, read only; ``WKX`` /
    ``WJX``: the k-shrink and j-shrink weight tables by
    :data:`SPAN_WEIGHTS` name, ``[B, Q, >= n2 + s]`` and ``[B, Q, >= n2]``
    (Q >= s - 2, the weight rows, is the span's TB); ``bases``: the 7
    :data:`STEP_BASES` planes ``[B, >= s - 1, IB, n2]``; ``dpm``: ``[B, DS,
    DS, >= s - 1, >= n2 + s - 2]``; ``jk``: the (canp, ptype, ESTP) rows
    ``[B, >= s - 1, n2]``; ``pl``, ``pr``, ``po``: ``[B, >= s - 1, IB,
    n2]``.  Slab row r is i = ``i0`` + r; ``n`` (s <= n <= n2 + 1) is the
    fill's length, from which the kernel and the plain version alike derive
    the valid cells (:func:`span_valid`).  Every operand is int32, all on
    one CUDA device or all on the CPU; raises otherwise, and past the
    kernel's limits (n2 <= :data:`MAX_SPAN_N2`, a batch within the grid's
    y blocks).

    The families' cells outside the valid band (dead rows, rows [0, s - 2]
    outside it, rows >= s - 1) must hold INF, as ``ttloop._run_span``
    initialises them: the kernel neither reads nor writes them, and the
    plain loop writes INF there (``tests/test_torch_ttspan.py`` holds
    both).  There is no B slab and no STM: the kernel reads red_j's terms
    and PM's earlier rows from the band it keeps in shared memory, and the
    plain version makes both (:func:`span_step_tables`).  The tensors stay
    alive with the table (``ops``)."""
    _fields_ = [("cur", Plane * len(STEP_FAMILIES)), ("mdp", Plane),
                ("wt", Plane * (2 * len(SPAN_WEIGHTS))),
                ("base", Plane * len(STEP_BASES)), ("jk", Plane * 3),
                ("pl", Plane), ("pr", Plane), ("po", Plane),
                ("dpm", ctypes.c_void_p), ("dpm_s", ctypes.c_longlong * 5),
                ("jobs", SpanJob * MAX_SPAN_JOBS),
                *((nm, ctypes.c_int) for nm in (
                    "njobs", "B", "n", "s", "i0", "IB", "n2", "Q", "bp", "cp", "ap",
                    "PB", "SAT16", "INF"))]

    def __init__(self, cur, mdp, WKX, WJX, bases, dpm, jk, pl, pr, po, *,
                 n: int, s: int, i0: int, bp: int, cp: int, ap: int, PB: int):
        super().__init__()
        if s < 2:
            raise ValueError(f"span {s} has no tt step")
        if not set(STEP_FAMILIES) <= set(cur):
            raise ValueError(f"cur lacks {sorted(set(STEP_FAMILIES) - set(cur))}")
        for what, x in (("bases", bases), ("WKX", WKX), ("WJX", WJX)):
            want = STEP_BASES if what == "bases" else SPAN_WEIGHTS
            if set(x) != set(want):
                raise ValueError(f"{what} must be {want}, got {sorted(x)}")
        first = cur[STEP_FAMILIES[0]]
        if first.dim() != 4:
            raise ValueError(f"cur slabs must be [B, R, IB, n2], got {tuple(first.shape)}")
        B, _, IB, n2 = first.shape
        if n2 > MAX_SPAN_N2:
            raise ValueError(f"n2 = {n2} is past tt_span's limit MAX_SPAN_N2 = "
                             f"{MAX_SPAN_N2} (a block's shared memory)")
        if B > MAX_GRID_Y:
            raise ValueError(f"batch {B} is past tt_span's limit of {MAX_GRID_Y} "
                             "(the grid's y blocks)")
        Q = WKX["WP"].shape[-2]
        T = s - 1                                 # rows [0, s - 2] are read
        R = max(s + 1, s - 1 + Q)                 # slab rows the plain loop reads
        E = (B,), (IB,), (n2,)
        for name in STEP_FAMILIES:
            _need(f"cur[{name}]", cur[name], (E[0], R, *E[1:]))
        _need("mdp", mdp, (E[0], R, *E[1:]))
        for nm in SPAN_WEIGHTS:
            _need(f"WKX[{nm}]", WKX[nm], (E[0], (Q,), n2 + s))
            _need(f"WJX[{nm}]", WJX[nm], (E[0], (Q,), n2))
        for name in STEP_BASES:
            _need(f"bases[{name}]", bases[name], (E[0], T, *E[1:]))
        _need("dpm", dpm, (E[0], (DS,), (DS,), T, n2 + s - 2))
        jk = tuple(jk)
        if len(jk) != 3:
            raise ValueError("jk must be (canp, ptype, ESTP) rows")
        for k, x in enumerate(jk):
            _need(f"jk[{k}]", x, (E[0], T, E[2]))
        for name, x in (("pl", pl), ("pr", pr), ("po", po)):
            _need(name, x, (E[0], T, *E[1:]))
        if not s <= n <= n2 + 1:
            raise ValueError(f"n = {n} must lie in [s, n2 + 1] = [{s}, {n2 + 1}] "
                             "(a live row's band within the slabs' columns)")
        if Q < s - 2:
            raise ValueError(f"the weights' {Q} rows do not reach q = s - 3 = {s - 3}")

        weights = [WKX[nm] for nm in SPAN_WEIGHTS] + [WJX[nm] for nm in SPAN_WEIGHTS]
        tensors = [*(cur[nm] for nm in STEP_FAMILIES), mdp, *weights,
                   *bases.values(), dpm, *jk, pl, pr, po]
        if all(t.device.type == "cpu" for t in tensors):
            self.device = torch.device("cpu")
        else:
            self.device = _check_devices(tensors)
            self._fn = _library().ccj_tt_span
        self.ops = {"cur": dict(cur), "mdp": mdp, "WKX": dict(WKX), "WJX": dict(WJX),
                    "bases": dict(bases), "dpm": dpm, "jk": jk, "pl": pl, "pr": pr,
                    "po": po}
        for k, name in enumerate(STEP_FAMILIES):
            self.cur[k] = _plane(cur[name])
        self.mdp = _plane(mdp)
        for k, x in enumerate(weights):
            self.wt[k] = _plane(x)
        for k, name in enumerate(STEP_BASES):
            self.base[k] = _plane(bases[name])
        for k, x in enumerate(jk):
            self.jk[k] = _plane(x)
        self.pl, self.pr, self.po = _plane(pl), _plane(pr), _plane(po)
        self.dpm = dpm.data_ptr()
        self.dpm_s = (ctypes.c_longlong * 5)(*dpm.stride())
        jobs = span_jobs()
        for k, job in enumerate(jobs):
            self.jobs[k] = job
        self.njobs = len(jobs)
        self.B, self.n, self.s, self.i0, self.IB, self.n2, self.Q = B, n, s, i0, IB, n2, Q
        self.bp, self.cp, self.ap, self.PB = bp, cp, ap, PB
        self.SAT16, self.INF = SAT16, INF

    def live_rows(self):
        """The rows [lo, hi] with a valid cell: i >= 1 and i + s <= n."""
        return max(1, self.i0), min(self.i0 + self.IB - 1, self.n - self.s)


def span_step_tables(table: SpanTable):
    """The step-by-step loop's tables on ``table``'s operands, as
    ``ttloop.run_tt_loop`` built them before :func:`tt_span`: the six B
    slabs and STM, fresh and INF, beside the A slabs, and the valid cells
    from ``table.n`` (:func:`span_valid`); returns
    (:class:`WindowTable` of :data:`REDUCTIONS`, :class:`StepTable`, the
    step's reduction buffer)."""
    o = table.ops
    B, IB, n2, s = table.B, table.IB, table.n2, table.s
    cur = dict(o["cur"])
    dev = cur["PM"].device
    for name in STEP_B_SLABS:
        cur["B_" + name] = torch.full((B, cur[name].shape[1], IB, n2 + s - 2), INF,
                                      dtype=torch.int32, device=dev)
    stm = torch.full((B, s - 1 + 2 * DS, IB, n2 + s - 2 + DS), INF,
                     dtype=torch.int32, device=dev)
    wins = reduction_table({**cur, "mdp": o["mdp"]}, o["WKX"], o["WJX"], s, n2,
                           table.i0)
    red = torch.empty(wins.shape, dtype=torch.int32, device=dev)
    valid = span_valid(table.n, s, table.i0, s - 1, IB, n2, dev)
    step = StepTable(red, o["bases"], cur, stm, o["dpm"], o["jk"], valid,
                     o["pl"], o["pr"], o["po"], s=s, i0=table.i0, bp=table.bp,
                     cp=table.cp, ap=table.ap, PB=table.PB)
    return wins, step, red


def tt_span_steps(table: SpanTable, plain: bool = False):
    """The span's tt loop one step at a time, on ``table``'s operands in
    place: per tt, the 13 reductions (:func:`minplus_group`) and the rest of
    the step (:func:`tt_step`), two launches a step on CUDA; with ``plain``
    their plain versions on any device.  What ``ttloop.run_tt_loop`` ran
    before :func:`tt_span`, which it replaces; kept as its comparator."""
    wins, step, red = span_step_tables(table)
    for tt in range(table.s - 2, -1, -1):
        if plain:
            red.copy_(minplus_group_ref(wins, tt))
            tt_step_ref(step, tt)
        else:
            minplus_group(wins, tt, red)
            tt_step(step, tt)


def tt_span_ref(table: SpanTable):
    """Plain PyTorch version of :func:`tt_span`: the loop of
    :func:`minplus_group_ref` and :func:`tt_step_ref` over tt = s - 2 .. 0."""
    tt_span_steps(table, plain=True)


def tt_span(table: SpanTable, plan: dict | None = None):
    """Run the span's whole tt loop, tt = s - 2 .. 0, on ``table``'s
    operands in place: each step's 13 reductions, assembly, PM interior
    stencil and store encoding, and row tt written into every ``cur`` slab
    at its valid cells.  One kernel launch on CUDA, a block or a
    thread-block cluster per live (b, i) row; ``plan`` sets
    :class:`SpanPlan`'s knobs by name (None: the kernel's own plan,
    csrc/ttspan.cu's ``ccj_tt_span``), and afterwards
    ``table.plan`` holds what it launched.  A span with no live row
    launches nothing (and counts none).  The plain version
    (:func:`tt_span_ref`) for CPU tensors."""
    global TT_SPAN_LAUNCHES
    if table.device.type == "cpu":
        return tt_span_ref(table)
    if _launch_span(table, plan, table._fn):
        TT_SPAN_LAUNCHES += 1


def tt_span_phases(table: SpanTable, skip: int, plan: dict | None = None):
    """Timing only: :func:`tt_span` with the phases ``skip`` names left out
    of every step (1 the reductions, 2 the PM stencil, 4 the assembly; 7
    times the empty steps, their barriers alone), at the same plan.  Its
    results are wrong; no fill calls it.  CUDA tensors only; counted in
    :data:`TT_SPAN_LAUNCHES` like every launch of the kernel."""
    global TT_SPAN_LAUNCHES
    if table.device.type == "cpu":
        raise ValueError("tt_span_phases times the kernel: it needs CUDA tensors")
    fn = _library().ccj_tt_span_phases
    if _launch_span(table, plan, lambda t, k, st, out: fn(t, k, skip, st, out)):
        TT_SPAN_LAUNCHES += 1


def _launch_span(table: SpanTable, plan, fn):
    """One launch of the kernel through ``fn`` with ``plan``'s knobs by
    name; sets ``table.plan`` to what launched and returns whether a row
    was live; raises on a failed launch."""
    knobs = SpanPlan(stage=-1)
    for name, value in (plan or {}).items():
        if name not in SpanPlan.KNOBS:
            raise ValueError(f"tt_span has no knob {name!r}")
        setattr(knobs, name, value)
    out = SpanPlan()
    _launch(fn, table.device, "tt_span", ctypes.addressof(table), ctypes.addressof(knobs),
            torch.cuda.current_stream(table.device).cuda_stream, ctypes.addressof(out))
    table.plan = {name: getattr(out, name) for name, _ in SpanPlan._fields_}
    return bool(out.live)


# ---------------------------------------------------------------------------
# history_min: every history scan of a span (the gapped step's RL / RI)
# ---------------------------------------------------------------------------

HISTORY_MAX_WINDOWS = 16   # csrc/history.cu kMaxWindows
HISTORY_MAX_PARTS = 8      # csrc/history.cu kMaxParts
HISTORY_MAX_SEGS = 16      # csrc/history.cu kMaxSegs: distinct part layouts a launch
HISTORY_MAX_TABLES = 3     # csrc/history.cu kMaxTables
RL, RI = 0, 1              # history_min's modes


class HistSeg(ctypes.Structure):
    """The strides and extents of one part position: csrc/history.cu's
    ``struct HistSeg``, field for field (element strides of the int16 view
    [B, TBw, U, Rw, n2]; span u has distance d = d0 - u)."""
    _fields_ = [("ws", ctypes.c_longlong * 5),
                *((nm, ctypes.c_int) for nm in ("TBw", "U", "Rw", "d0"))]


class HistWin(ctypes.Structure):
    """One window of a launch: csrc/history.cu's ``struct HistWin``, field
    for field."""
    _fields_ = [*((nm, ctypes.c_int) for nm in ("mode", "g1", "nparts", "nout")),
                ("tab", ctypes.c_int * 2), ("out", ctypes.c_int * 2),
                ("seg", ctypes.c_ubyte * HISTORY_MAX_PARTS)]


class HistTable(ctypes.Structure):
    """The operands of one :func:`history_min` launch: csrc/history.cu's
    ``struct HistTable``, field for field, passed to the kernel by value."""
    _fields_ = [("win", (ctypes.c_void_p * HISTORY_MAX_PARTS) * HISTORY_MAX_WINDOWS),
                ("seg", HistSeg * HISTORY_MAX_SEGS), ("w", HistWin * HISTORY_MAX_WINDOWS),
                ("X", ctypes.c_void_p * HISTORY_MAX_TABLES),
                ("xs", (ctypes.c_longlong * 3) * HISTORY_MAX_TABLES),
                ("out", ctypes.c_void_p),
                *((nm, ctypes.c_int) for nm in (
                    "nwin", "nseg", "B", "TB", "R", "n2", "s", "i0", "wmask"))]


class HistWindow(NamedTuple):
    """One window of :func:`history_min`: a family's history read in place,
    ``parts`` a list of (int16 view [B, TBw, U, Rw, n2], d0) pairs, and the
    one or two scans it serves, ``outs`` a list of (weight table index,
    output plane) pairs, all with one ``mode`` (:data:`RL` / :data:`RI`)
    and one ``g1``."""
    mode: int
    g1: int
    parts: list
    outs: list


def g2(X, a, b):
    """X[..., a, b] of square [..., n2, n2] tables, INF where (a, b) lies
    off them."""
    n2 = X.shape[-1]
    ok = (a >= 0) & (a < n2) & (b >= 0) & (b < n2)
    return torch.where(ok, X[..., a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)], INF)


def history_windows(windows, tables, R, s):
    """``windows`` as :class:`HistWindow` s checked against the tables, the
    output's R rows and the span s, every part cut to its admissible spans
    (u < d0: a span u >= d0 has d <= 0 and gives no term) and dropped where
    no span or row is left; returns (windows, K), K the output planes.
    Raises on an operand that does not fit, a part with d0 > s, and past
    the kernel's limits."""
    if not 1 <= len(tables) <= HISTORY_MAX_TABLES:
        raise ValueError(f"{len(tables)} weight tables: 1 to {HISTORY_MAX_TABLES}")
    B, n2 = tables[0].shape[0], tables[0].shape[-1]
    for X in tables:
        if X.dtype != torch.int32 or tuple(X.shape) != (B, n2, n2):
            raise ValueError(f"a weight table must be int32 [B, n2, n2] = [{B}, {n2}, {n2}], "
                             f"got {X.dtype} {tuple(X.shape)}")
    if not 1 <= len(windows) <= HISTORY_MAX_WINDOWS:
        raise ValueError(f"{len(windows)} history windows: 1 to {HISTORY_MAX_WINDOWS}")
    out, planes = [], []
    for mode, g1, parts, outs in windows:
        if mode not in (RL, RI):
            raise ValueError(f"mode must be RL ({RL}) or RI ({RI}), got {mode}")
        if not 1 <= len(outs) <= 2 or any(not 0 <= t < len(tables) for t, _ in outs):
            raise ValueError(f"a window serves one or two scans of the tables, got {outs}")
        planes += [int(k) for _, k in outs]
        cut = []
        for win, d0 in parts:
            if win.dim() != 5 or win.dtype != torch.int16:
                raise ValueError(f"a history window must be int16 [B, TBw, U, Rw, n2], "
                                 f"got {win.dtype} {tuple(win.shape)}")
            if (win.shape[0] != B or win.shape[4] != n2 or win.shape[3] > R or d0 > s
                    or win.stride(4) != 1):
                raise ValueError(f"history window {tuple(win.shape)} with d0 {d0} does not "
                                 f"fit batch {B}, {R} rows, n2 {n2}, span {s} (or its j "
                                 "axis is not contiguous)")
            U = min(win.shape[2], int(d0))
            if U > 0 and win.shape[3] > 0:
                cut.append((win[:, :, :U], int(d0)))
        if len(cut) > HISTORY_MAX_PARTS:
            raise ValueError(f"{len(cut)} history parts, past the kernel's "
                             f"{HISTORY_MAX_PARTS}")
        out.append(HistWindow(mode, int(g1), cut, [(int(t), int(k)) for t, k in outs]))
    if sorted(planes) != list(range(len(planes))):
        raise ValueError(f"the scans' output planes must be 0 .. K - 1, each once, got {planes}")
    return out, len(planes)


def history_weights(X, mode, s, d0, U, i0, R):
    """The weights of a part's spans u < U for rows i in [i0, i0 + R),
    int32 [B, U, R]: RL X(l - d + 1, l) with l = i + s, RI X(i, i + d - 1),
    d = d0 - u; INF off the table."""
    dev = X.device
    iv = torch.arange(i0, i0 + R, device=dev)[None, :]
    d = (d0 - torch.arange(U, device=dev))[:, None]
    if mode == RL:
        return g2(X, iv + s - d + 1, (iv + s).expand(U, R))
    return g2(X, iv.expand(U, R), iv + d - 1)


def history_min_ref(windows, tables, s, i0, TB, R):
    """Plain PyTorch version of :func:`history_min` (the scans as the fills
    ran them before the kernels, one scan at a time, the weights gathered
    from the tables, each part's terms over an int32 copy of its window):
    ``windows`` as :func:`history_windows` returns them."""
    B, n2, dev = tables[0].shape[0], tables[0].shape[-1], tables[0].device
    K = sum(len(w.outs) for w in windows)
    out = torch.full((K, B, TB, R, n2), INF, dtype=torch.int32, device=dev)
    tv = torch.arange(TB, device=dev)[:, None, None]          # tt
    iv = torch.arange(i0, i0 + R, device=dev)[None, :, None]  # i
    jv = torch.arange(n2, device=dev)[None, None, :]          # j
    for mode, g1, parts, outs in windows:
        if mode == RL:
            bound = (iv + s) - (jv + tv + 2) - g1               # l - k - g1
        else:
            bound = torch.where(iv >= 1, (jv - iv) - g1, 0)     # sj - g1, i >= 1
        for win, d0 in parts:
            U, Rw = win.shape[2], win.shape[3]
            x = win[:, :TB].to(torch.int32)
            x = pad_axis(x, 1, 0, TB - x.shape[1], SAT16)   # tt rows past the part's
            x = pad_axis(x, 3, 0, R - Rw, SAT16)            # rows past it: masked below
            d = (d0 - torch.arange(U, device=dev))[None, :, None, None]
            rows = (torch.arange(R, device=dev) < Rw)[:, None]
            ok = (d >= 1) & (d <= bound[:, None]) & rows
            for t, k in outs:
                w = history_weights(tables[t], mode, s, d0, U, i0, R)
                vals = torch.where(ok, x + w[:, None, :, :, None], INF)
                torch.minimum(out[k], vals.amin(dim=-3), out=out[k])
    return out


def history_min(windows, tables, *, s, i0, TB, R):
    """Every history scan of ``windows`` in one launch; returns int32
    [K, B, TB, R, n2], plane k the scan whose output index is k:

      out[k, b, tt, r, j] = min(INF, min over the window's parts (win, d0)
                                and spans u of win[b, tt, u, r, j] + w_k(d))

    over the terms with distance d = d0 - u in [1, bound]: mode :data:`RL`,
    the l-shrink scan, bound = (i + s) - (j + tt + 2) - g1 and w_k(d) =
    X(l - d + 1, l) with l = i + s; :data:`RI`, the i-shrink scan, bound =
    (j - i) - g1 and i >= 1, w_k(d) = X(i, i + d - 1); X the scan's table,
    INF off it; row r is i = i0 + r.

    ``windows``: at most :data:`HISTORY_MAX_WINDOWS` (mode, g1, parts,
    outs) (:class:`HistWindow`); each part an int16 view [B, TBw, U, Rw,
    n2] straight into the state whose tt rows past TBw read SAT16 and whose
    rows past Rw give no term, with its d0 <= s (at most
    :data:`HISTORY_MAX_PARTS` with an admissible span); ``outs`` one or two
    (table index, output plane) pairs, the planes of all windows 0 .. K - 1
    each once.  ``tables``: int32 [B, n2, n2] weight tables
    (``gapped._wx_tables``), at most :data:`HISTORY_MAX_TABLES`.  One
    kernel launch on CUDA for the whole batch, every output cell written
    once (the output is ``torch.empty``); none where no part has an
    admissible span (an INF output).  The plain version
    (:func:`history_min_ref`) for CPU tensors."""
    global HISTORY_LAUNCHES
    if TB < 1 or R < 1:
        raise ValueError(f"history_min needs TB >= 1 and R >= 1, got {TB}, {R}")
    tensors = [*tables, *(v for _m, _g, parts, _o in windows for v, _ in parts)]
    if all(t.device.type == "cpu" for t in tensors):
        windows, _K = history_windows(windows, tables, R, s)
        return history_min_ref(windows, tables, s, i0, TB, R)
    dev = _check_devices(tensors)
    fn = _library().ccj_history_min
    windows, K = history_windows(windows, tables, R, s)
    B, n2 = tables[0].shape[0], tables[0].shape[-1]
    if not any(w.parts for w in windows):
        return torch.full((K, B, TB, R, n2), INF, dtype=torch.int32, device=dev)
    out = torch.empty((K, B, TB, R, n2), dtype=torch.int32, device=dev)
    t = HistTable(out=out.data_ptr(), nwin=len(windows), B=B, TB=TB, R=R, n2=n2, s=s,
                  i0=i0)
    segs = {}
    vec2 = n2 % 2 == 0       # two neighbouring j in one 4-byte load: aligned views
    for q, X in enumerate(tables):
        t.X[q] = X.data_ptr()
        t.xs[q] = (ctypes.c_longlong * 3)(*X.stride())
    for wi, (mode, g1, parts, outs) in enumerate(windows):
        hw = t.w[wi]
        hw.mode, hw.g1, hw.nparts, hw.nout = mode, g1, len(parts), len(outs)
        for q, (tab, k) in enumerate(outs):
            hw.tab[q], hw.out[q] = tab, k
            t.wmask |= 1 << (mode * HISTORY_MAX_TABLES + tab)
        for p, (win, d0) in enumerate(parts):
            g = segs.setdefault((win.stride(), *win.shape[1:4], d0), len(segs))
            if g >= HISTORY_MAX_SEGS:
                raise ValueError(f"more than {HISTORY_MAX_SEGS} distinct part layouts "
                                 "(strides, tt rows, spans, rows, d0) in one launch")
            hw.seg[p] = g
            t.win[wi][p] = win.data_ptr()
            vec2 = (vec2 and win.data_ptr() % 4 == 0
                    and all(x % 2 == 0 for x in win.stride()[:4]))
    for (ws, TBw, U, Rw, d0), g in segs.items():
        t.seg[g] = HistSeg((ctypes.c_longlong * 5)(*ws), TBw, U, Rw, d0)
    t.nseg = len(segs)
    _launch(fn, dev, "history_min", ctypes.addressof(t), int(vec2),
            torch.cuda.current_stream(dev).cuda_stream)
    HISTORY_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# p_split: the P(i, i+s) split contraction
# ---------------------------------------------------------------------------

class PSplitTable(ctypes.Structure):
    """The operands of one :func:`p_split` launch: csrc/psplit.cu's
    ``struct PSplitTable``, field for field."""
    _fields_ = [("pke", ctypes.c_void_p), ("ks", ctypes.c_longlong * 5),
                ("pkd", ctypes.c_void_p), ("ds", ctypes.c_longlong * 5),
                ("out", ctypes.c_void_p), ("os", ctypes.c_longlong * 2),
                *((nm, ctypes.c_int) for nm in (
                    "sp0", "sp1", "ro0", "ro1", "nrows", "B", "R", "s", "n", "i0",
                    "lo", "nlive"))]


def p_split_live(n, s, i0, R):
    """The live rows [lo, hi] of a span-s P split over rows [i0, i0 + R):
    i >= 1 and i + s <= n (empty where lo > hi)."""
    return max(1, i0), min(i0 + R - 1, n - s)


def p_split_ref(pke, pkd, s, n, i0, R, sp, ro):
    """Plain PyTorch version of :func:`p_split` (the s - 1 passes over a
    the fills ran before the kernel)."""
    B, T = pke.shape[0], pke.shape[1]
    dev = pke.device
    bb = torch.arange(T, device=dev)[:, None, None]           # b-1
    cc = torch.arange(T, device=dev)[None, :, None]           # c-1
    iv = torch.arange(i0, i0 + R, device=dev)[None, None, :]  # i
    row_ok = (iv >= 1) & (iv + s <= n)
    p_min = torch.full((B, R), INF, dtype=torch.int32, device=dev)
    for a in range(max(s - 1, 0)):
        # F1[b-1, c-1, i] = PKE[b-1, (a+2)+(c-1), i, a]
        F1 = pke[:, :, a + 2: a + 2 + T, :R, a]
        # F2[b-1, c-1, i] = X[sp(a), c-1, ro(a) + r, b-1], rows past X's SAT16
        r0 = ro[0] + ro[1] * a
        F2 = pkd[:, sp[0] + sp[1] * a, :, r0:r0 + R, :T]
        F2 = pad_axis(F2, -2, 0, R - F2.shape[-2], SAT16).movedim(-1, -3)
        ok = (bb + cc + 2 <= s - 1 - a) & row_ok
        vals = torch.where(ok, F1.to(torch.int32) + F2.to(torch.int32), INF)
        p_min = torch.minimum(p_min, vals.amin(dim=(-3, -2)))
    return p_min


def p_split(pke, pkd, *, s, n, i0, R, sp, ro):
    """The P-split minima of rows i in [i0, i0 + R), int32 [B, R] (INF where
    no candidate, or i is not a span-s row: i >= 1, i + s <= n):

      min over a >= 0, b, c >= 1 with a + b + c <= s - 1 of
      PKE[b-1, a+c+1, i, a] + X[sp(a), c-1, ro(a) + r, b-1]

    with sp(a) = sp[0] + sp[1] a and ro(a) = ro[0] + ro[1] a; X's rows past
    its last read SAT16.  ``pke``: int16 [B, T, >= s + T, >= R, >= s - 1]
    whose row r is i = i0 + r; ``pkd``: int16 X [B, A, T, NR, >= T], any
    strides (the dense PKD as ``PKD.transpose(1, 2)`` with sp = (s - 1, -1),
    ro = (i0 + 1, 1); a stack of fetched rows with sp = (0, 1), ro = (0, 0)).
    The sum is plain int32, SAT16 cells taking part as values.  One kernel
    launch on CUDA for the whole batch, none for a span with no live row or
    no term (s < 3); the plain version (:func:`p_split_ref`) for CPU
    tensors."""
    global PSPLIT_LAUNCHES
    if pke.dim() != 5 or pkd.dim() != 5 or pke.dtype != torch.int16 \
            or pkd.dtype != torch.int16:
        raise ValueError(f"pke and pkd must be 5-D int16, got {pke.dtype} "
                         f"{tuple(pke.shape)}, {pkd.dtype} {tuple(pkd.shape)}")
    B, T = pke.shape[:2]
    A, NR = pkd.shape[1], pkd.shape[3]
    xs = (sp[0], sp[0] + sp[1] * (s - 2)) if s >= 2 else (0,)   # a in [0, s - 2]
    if (pkd.shape[0] != B or pkd.shape[2] != T or pkd.shape[4] < T
            or pke.shape[2] < s + T or pke.shape[3] < R
            or pke.shape[4] < s - 1 or min(xs) < 0 or max(xs) >= A
            or ro[0] < 0 or ro[1] < 0):
        raise ValueError(f"p_split operands pke {tuple(pke.shape)}, pkd "
                         f"{tuple(pkd.shape)}, sp {sp}, ro {ro} do not fit span {s}, "
                         f"{R} rows")
    if pke.device.type == "cpu" and pkd.device.type == "cpu":
        return p_split_ref(pke, pkd, s, n, i0, R, sp, ro)
    dev = _check_devices([pke, pkd])
    fn = _library().ccj_p_split
    out = torch.full((B, R), INF, dtype=torch.int32, device=dev)
    lo, hi = p_split_live(n, s, i0, R)
    if hi < lo or s < 3:
        return out
    t = PSplitTable(pke=pke.data_ptr(), ks=(ctypes.c_longlong * 5)(*pke.stride()),
                    pkd=pkd.data_ptr(), ds=(ctypes.c_longlong * 5)(*pkd.stride()),
                    out=out.data_ptr(), os=(ctypes.c_longlong * 2)(*out.stride()),
                    sp0=sp[0], sp1=sp[1], ro0=ro[0], ro1=ro[1], nrows=NR, B=B, R=R,
                    s=s, n=n, i0=i0, lo=lo, nlive=hi - lo + 1)
    _launch(fn, dev, "p_split", ctypes.addressof(t),
            torch.cuda.current_stream(dev).cuda_stream)
    PSPLIT_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# stencil_pl / stencil_pr: the gapped step's PL / PR interior-loop stencils
# ---------------------------------------------------------------------------

STENCIL_MAX_PARTS = 2   # csrc/stencil.cu kMaxParts
PL_KIND, PR_KIND = 0, 1


class StencilPart(ctypes.Structure):
    """One state view of a stencil: csrc/stencil.cu's ``struct StencilPart``,
    field for field (pointer and element strides of the int16 view
    [B, TTw, Uw, Rw, n2]; its span u row holds span u0 + u)."""
    _fields_ = [("win", ctypes.c_void_p), ("ws", ctypes.c_longlong * 5),
                *((nm, ctypes.c_int) for nm in ("TTw", "Uw", "Rw", "u0"))]


class StencilTable(ctypes.Structure):
    """The operands of one :func:`stencil_pl` / :func:`stencil_pr` launch:
    csrc/stencil.cu's ``struct StencilTable``, field for field, passed to
    the kernel by value (``ntx``, ``nty`` and ``split``, its tiles and
    blocks a tile, are the launch's own)."""
    _fields_ = [("part", StencilPart * STENCIL_MAX_PARTS), ("w", ctypes.c_void_p),
                ("wst", ctypes.c_longlong * 5), ("out", ctypes.c_void_p),
                ("os", ctypes.c_longlong * 4),
                *((nm, ctypes.c_int) for nm in (
                    "nparts", "kind", "B", "TB", "R", "n2", "s", "i0", "lo", "nlive",
                    "WK", "WL", "ntx", "nty", "split"))]


def stencil_parts(parts, B, n2, s):
    """``parts`` ((view, u0) pairs) checked and cut to the spans a span-s
    stencil reads, s - DS .. s - 1; parts left with no span, tt row or row
    are dropped.  Raises on a view that is not int16 [B, TTw, Uw, Rw, n2],
    on parts whose spans overlap, and past :data:`STENCIL_MAX_PARTS`."""
    out = []
    for win, u0 in parts:
        if win.dim() != 5 or win.dtype != torch.int16:
            raise ValueError(f"a stencil view must be int16 [B, TTw, Uw, Rw, n2], "
                             f"got {win.dtype} {tuple(win.shape)}")
        if win.shape[0] != B or win.shape[4] != n2:
            raise ValueError(f"stencil view {tuple(win.shape)} does not fit batch {B}, "
                             f"n2 {n2}")
        u0 = int(u0)
        a, b = max(u0, s - DS), min(u0 + win.shape[2], s)
        if a < b and win.shape[1] > 0 and win.shape[3] > 0:
            out.append((win[:, :, a - u0:b - u0], a))
    out.sort(key=lambda p: p[1])
    for (w1, a1), (_w2, a2) in zip(out, out[1:]):
        if a1 + w1.shape[2] > a2:
            raise ValueError(f"stencil views overlap at span {a2}")
    if len(out) > STENCIL_MAX_PARTS:
        raise ValueError(f"{len(out)} stencil views, past the kernel's "
                         f"{STENCIL_MAX_PARTS}")
    return out


def _stencil_window(parts, s, B, rows, R, n2, dev):
    """The parts as one int16 [B, rows, DS, R, n2] window, row q of axis 2
    holding span s - DS + q; spans no part holds, tt rows and rows past a
    part's read SAT16 (the windows the fills built before the kernels)."""
    win = torch.full((B, rows, DS, R, n2), SAT16, dtype=torch.int16, device=dev)
    for view, u0 in parts:
        t, rr = min(rows, view.shape[1]), min(R, view.shape[3])
        q = u0 - (s - DS)
        win[:, :t, q:q + view.shape[2], :rr] = view[:, :t, :, :rr]
    return win


def stencil_pl_ref(parts, w4pl, s, n, i0, TB, R):
    """Plain PyTorch version of :func:`stencil_pl`: the PL stencil's 29
    passes over d2 as the fills ran them before the kernel, each over an
    int32 [B, TB, DS, R, n2] temporary, its terms kept where W < INF."""
    B, n2, dev = w4pl.shape[0], n + 2, w4pl.device
    plw = _stencil_window(parts, s, B, TB + DS, R + DS, n2, dev)
    plw = torch.flip(plw, dims=(-3,))                  # row d1-1 = span s-d1
    # V1[b, tt', d1-1, i, j] = plw[b, tt', d1-1, i+d1, j]
    V1 = torch.stack([plw[:, :, d1 - 1, d1: d1 + R, :]
                      for d1 in range(1, DS + 1)], dim=2)
    W = w4pl[..., i0:i0 + R, :]                          # [B, d1, d2, i, j]
    out = torch.full((B, TB, R, n2), INF, dtype=torch.int32, device=dev)
    for d2 in range(1, DS + 1):
        sub = V1[:, d2: d2 + TB]                         # rows tt + d2
        sub = torch.nn.functional.pad(sub, (d2, 0), value=SAT16)[..., :n2]
        wd = W[:, None, :, d2 - 1]                       # [B, 1, d1, i, j]
        vals = torch.where(wd < INF, sub.to(torch.int32) + wd, INF)
        torch.minimum(out, vals.amin(dim=-3), out=out)
    return out.masked_fill_(~span_valid(n, s, i0, TB, R, n2, dev), INF)


def stencil_pr_ref(parts, w4pr, s, n, i0, TB, R):
    """Plain PyTorch version of :func:`stencil_pr`: the PR stencil's 29
    passes over d1 in u = j + tt coordinates as the fills ran them before
    the kernel, each over an int32 [B, DS, R, TB, n2 + TB] temporary, its
    terms kept where W < INF."""
    B, n2, dev = w4pr.shape[0], n + 2, w4pr.device
    UB = n2 + TB
    prw = _stencil_window(parts, s, B, TB + DS, R, n2, dev)
    prw = torch.flip(prw, dims=(-3,))                  # row d2-1 = span s-d2
    pru = skew_right(prw.movedim(1, -2), SAT16)        # [B, d2, i, tt', u]
    wpr = w4pr[..., 2:2 + UB, s + i0:s + i0 + R].transpose(-1, -2)  # [B, d1, d2, i, u]
    acc = torch.full((B, R, TB, UB), INF, dtype=torch.int32, device=dev)
    for d1 in range(1, DS + 1):
        sub = pru[..., d1: d1 + TB, d1: d1 + UB]       # [B, d2, i, tt, u]
        wd = wpr[:, d1 - 1, :, :, None, :]               # [B, d2, i, 1, u]
        vals = torch.where(wd < INF, sub.to(torch.int32) + wd, INF)
        torch.minimum(acc, vals.amin(dim=-4), out=acc)
    out = unskew_right(acc, INF, n2).movedim(-3, -2)     # [B, tt, i, j]
    return out.masked_fill_(~span_valid(n, s, i0, TB, R, n2, dev), INF)


def _stencil(kind, parts, w, s, n, i0, TB, R):
    global STENCIL_LAUNCHES, STENCIL_PL_LAUNCHES, STENCIL_PR_LAUNCHES
    name = ("stencil_pl", "stencil_pr")[kind]
    n2 = n + 2
    if w.dim() != 5 or w.dtype != torch.int32 or tuple(w.shape[1:3]) != (DS, DS):
        raise ValueError(f"{name}: weights must be int32 [B, {DS}, {DS}, ., .], got "
                         f"{w.dtype} {tuple(w.shape)}")
    fits = (w.shape[3] >= i0 + R and w.shape[4] == n2) if kind == PL_KIND else (
        w.shape[3] >= n2 + TB + 2 and w.shape[4] >= s + i0 + R)
    if not fits or TB < 1 or R < 1 or i0 < 0 or s < 0:
        raise ValueError(f"{name}: weights {tuple(w.shape)} do not fit span {s}, n {n}, "
                         f"TB {TB}, rows [{i0}, {i0 + R})")
    B = w.shape[0]
    tensors = [w, *(v for v, _ in parts)]
    if all(t.device.type == "cpu" for t in tensors):
        ref = stencil_pl_ref if kind == PL_KIND else stencil_pr_ref
        return ref(stencil_parts(parts, B, n2, s), w, s, n, i0, TB, R)
    dev = _check_devices(tensors)
    fn = _library().ccj_stencil
    parts = stencil_parts(parts, B, n2, s)
    for win, _u0 in parts:     # the kernel's offsets within a plane are int32
        if win.stride(4) != 1:
            raise ValueError(f"{name}: the kernel copies rows of a view as words: its "
                             f"j stride must be 1, got {win.stride(4)}")
        if (win.shape[1] - 1) * win.stride(1) + (n2 - 1) >= 2 ** 31:
            raise ValueError(f"{name}: view {tuple(win.shape)} spans 2^31 elements "
                             "or more along (tt, j)")
    out = torch.full((B, TB, R, n2), INF, dtype=torch.int32, device=dev)
    lo, hi = p_split_live(n, s, i0, R)
    if hi < lo or s < 2:
        return out
    t = StencilTable(w=w.data_ptr(), wst=(ctypes.c_longlong * 5)(*w.stride()),
                     out=out.data_ptr(), os=(ctypes.c_longlong * 4)(*out.stride()),
                     nparts=len(parts), kind=kind, B=B, TB=TB, R=R, n2=n2, s=s, i0=i0,
                     lo=lo, nlive=hi - lo + 1, WK=w.shape[3], WL=w.shape[4])
    for q, (win, u0) in enumerate(parts):
        t.part[q] = StencilPart(win.data_ptr(), (ctypes.c_longlong * 5)(*win.stride()),
                                win.shape[1], win.shape[2], win.shape[3], u0)
    _launch(fn, dev, name, ctypes.addressof(t), torch.cuda.current_stream(dev).cuda_stream)
    STENCIL_LAUNCHES += 1
    if kind == PL_KIND:
        STENCIL_PL_LAUNCHES += 1
    else:
        STENCIL_PR_LAUNCHES += 1
    return out


def stencil_pl(parts, w4pl, *, s, n, i0, TB, R):
    """PL's interior-loop stencil of span s for rows i in [i0, i0 + R),
    int32 [B, TB, R, n + 2]:

      out[b, tt, r, j] = min(INF, min over d1, d2 in [1, DS] with W < INF of
                             PL[b, tt + d2, s - d1, i + d1, j - d2] + W)

    with W = W4PL[b, d1 - 1, d2 - 1, i, j] and i = i0 + r
    (pseudo_loop.cc:682-703) on the span's valid cells (:func:`span_valid`),
    INF elsewhere.  ``parts``: (view, u0) pairs, each view an int16
    [B, TTw, Uw, Rw, n2] straight into the PL state whose span u row holds
    span u0 + u and whose row 0 is i = i0 (at most
    :data:`STENCIL_MAX_PARTS` holding a span in [s - DS, s); on CUDA each
    with a unit j stride, its rows copied as words); a span no part holds,
    a tt row past a view's and a row past it read SAT16, which take part as
    values.  ``w4pl``: int32 [B, DS, DS, >= i0 + R, n2]
    (``gapped4.build_sc4``, INF outside every loop bound, so the kernel may
    skip those terms).  One kernel launch on CUDA for the whole batch, none
    for a span with no live row or no tt step (s < 2); the plain version
    (:func:`stencil_pl_ref`) for CPU tensors."""
    return _stencil(PL_KIND, parts, w4pl, s, n, i0, TB, R)


def stencil_pr(parts, w4pr, *, s, n, i0, TB, R):
    """PR's interior-loop stencil of span s for rows i in [i0, i0 + R),
    int32 [B, TB, R, n + 2]:

      out[b, tt, r, j] = min(INF, min over d1, d2 in [1, DS] with W < INF of
                             PR[b, tt + d1, s - d2, i, j] + W)

    with W = W4PR[b, d1 - 1, d2 - 1, j + tt + 2, i + s] and i = i0 + r
    (pseudo_loop.cc:717-738) on the span's valid cells, INF elsewhere.
    ``parts`` as :func:`stencil_pl` takes them (PR reads row i only);
    ``w4pr``: int32 [B, DS, DS, >= n2 + TB + 2, >= s + i0 + R]
    (``gapped4.build_sc4``).  One launch on CUDA, as :func:`stencil_pl`;
    the plain version (:func:`stencil_pr_ref`) for CPU tensors."""
    return _stencil(PR_KIND, parts, w4pr, s, n, i0, TB, R)


# ---------------------------------------------------------------------------
# span_assemble / span_store: the gapped step's cross-span assembly and its
# write-back into the state
# ---------------------------------------------------------------------------

# The span's 13 fixed-offset plane reads, in csrc/assemble.cu's order:
# (family, c, b, di, dj), value[tt, i, j] = family[tt + c, s - b, i + di, j + dj]
# on the cells its own bounds admit, INF elsewhere.
ASSEMBLE_READS = (
    ("PL", 1, 1, 1, -1), ("PLmloop10", 1, 1, 1, -1), ("PLmloop01", 1, 1, 1, -1),
    ("PfromL", 1, 1, 1, -1),
    ("PR", 1, 1, 0, 0), ("PRmloop10", 1, 1, 0, 0), ("PRmloop01", 1, 1, 0, 0),
    ("PfromR", 1, 1, 0, 0),
    ("PO", 0, 2, 1, 0), ("POmloop10", 0, 2, 1, 0), ("POmloop01", 0, 2, 1, 0),
    ("PfromO", 0, 2, 1, 0),
    ("PRmloop01", 0, 1, 0, 0),
)
# the history scans span_assemble reads, in csrc/assemble.cu's order (the
# keys of gapped4.HISTORY_SCANS)
ASSEMBLE_HISTORY = ("POm00_ri", "POm00_rl", "POm01", "POm10_ri", "POm10_rl", "PRm01",
                    "PfromO_ri", "PfromO_rl", "PLmloop00", "PLmloop10", "PRmloop00",
                    "PMmloop01", "PMmloop10_ri", "PMmloop10_rl", "PfromL", "PfromR")
# the cross-span-only families span_assemble packs to int16, in its output's order
ASSEMBLED = ("PL", "PR", "PO", "PRmloop01", "POmloop00", "POmloop01", "POmloop10",
             "PfromO")
# span_store's sources: the tt loop's 14 families (int32), then ASSEMBLED (int16)
STORE_SOURCES = (*STEP_FAMILIES, *ASSEMBLED)
PLANE_MAX_PARTS = 2     # csrc/assemble.cu kParts
STORE_MAX_DESTS = 40    # csrc/store.cu kMaxDests
ASSEMBLE_LAUNCHES = 0   # span_assemble kernel launches (CUDA only)
STORE_LAUNCHES = 0      # span_store kernel launches (CUDA only)


class SpanAssembly(NamedTuple):
    """What :func:`span_assemble` gives, every array over the span's
    [B, TB, IB, n2] cells: the tt loop's operands ``PLs``, ``PRs``, ``POs``
    (INF-encoded int32: the int16-clamped value on the valid cells, INF
    elsewhere), ``mdp0`` = min(PLs, PRs) + PB and ``pmm10``, the PMmloop10
    base (the min of its two history scans); ``xs``, int16 [8, B, TB, IB,
    n2]: the :data:`ASSEMBLED` families packed for the store (the
    int16-clamped value on the valid cells, SAT16 elsewhere)."""
    PLs: torch.Tensor
    PRs: torch.Tensor
    POs: torch.Tensor
    mdp0: torch.Tensor
    pmm10: torch.Tensor
    xs: torch.Tensor


class StoreDest(NamedTuple):
    """One destination of :func:`span_store`: an int16 view [B, TTd, Rd, n2]
    into the state that receives family ``family`` (a name of
    :data:`STORE_SOURCES`), packed (the int16-clamped value on the span's
    valid cells, SAT16 elsewhere).  Without ``skew``, view[b, tt, rd, j] =
    slab[b, tt, rd + r0, j]; with it (PKD and PKE), view[b, tt, rd, a] =
    slab[b, tt, rd, i0 + rd + a] (r0 must be 0).  A tt row past the slab's
    TB, a slab row outside [0, IB) and a column past n2 give SAT16."""
    family: str
    view: torch.Tensor
    r0: int = 0
    skew: bool = False


def plane_slab(parts, B, TB, IB, n2, dev):
    """A plane read's parts as one int16 [B, TB, IB, n2] slab: each part
    (view [B, TTv, Rv, n2], t0, r0) holds the plane's rows r with 0 <= r +
    r0 < Rv (view row r + r0), their tt rows with 0 <= tt + t0 < TTv; every
    other cell is SAT16."""
    sl = torch.full((B, TB, IB, n2), SAT16, dtype=torch.int16, device=dev)
    for view, t0, r0 in parts:
        r_lo, r_hi = max(0, -r0), min(IB, view.shape[2] - r0)
        t_lo, t_hi = max(0, -t0), min(TB, view.shape[1] - t0)
        if r_lo < r_hi and t_lo < t_hi:
            sl[:, t_lo:t_hi, r_lo:r_hi] = view[:, t_lo + t0:t_hi + t0, r_lo + r0:r_hi + r0]
    return sl


def _enc16(v, vmask):
    """Pack a plane for the state: int16-clamped value on valid cells, SAT16
    on invalid ones (the fills' ``pack``)."""
    return torch.where(vmask, v.clamp(-32768, SAT16), SAT16).to(torch.int16)


def span_assemble_ref(planes, pl_int, pr_int, hist, tables, s, n, i0, TB, IB, ap, bp,
                      cp, PB):
    """Plain PyTorch version of :func:`span_assemble`: the assembly as the
    fills ran it before the kernel (``gapped4.span_families``), each plane
    read made a slab (:func:`plane_slab`), the pair planes from the tables
    as the fills' gather-free builders make them."""
    from .ttloop import diag_il, plane_ij, plane_kl

    canp, pt, ESTP = tables
    n2, dev = n + 2, pl_int.device
    B = pl_int.shape[0]
    H = dict(zip(ASSEMBLE_HISTORY, hist))
    tv = torch.arange(TB, device=dev)[:, None, None]      # tt
    iv = torch.arange(i0, i0 + IB, device=dev)[None, :, None]  # i
    jv = torch.arange(n2, device=dev)[None, None, :]      # j
    kv = jv + tv + 2
    lv = iv + s
    valid4 = span_valid(n, s, i0, TB, IB, n2, dev)

    # gather-free pair/energy planes (ttloop.py)
    ESTP_ij = plane_ij(ESTP, TB, IB, i0=i0)
    canp_ij = plane_ij(canp, TB, IB, i0=i0)
    pt_ij = plane_ij(pt, TB, IB, i0=i0)
    canp_kl = plane_kl(canp, s, TB, IB, n2, i0=i0)
    pt_kl = plane_kl(pt, s, TB, IB, n2, i0=i0)
    ESTP_klp = plane_kl(ESTP, s, TB, IB, n2, i0=i0)
    canp_il = diag_il(canp, s, TB, IB, n2, i0=i0)
    pt_il = diag_il(pt, s, TB, IB, n2, i0=i0)
    ESTP_il = diag_il(ESTP, s, TB, IB, n2, i0=i0)

    def rplane(q):
        """value[tt, i, j] = read4(name, n, tt+c, s-b, i+di, j+dj)."""
        _name, c, b, di, dj = ASSEMBLE_READS[q]
        sl = plane_slab(planes[q], B, TB, IB, n2, dev)
        if dj == -1:
            sl = torch.nn.functional.pad(sl, (1, 0), value=SAT16)[..., :n2]
        elif dj == 1:
            sl = torch.nn.functional.pad(sl, (0, 1), value=SAT16)[..., 1:]
        i2, j2 = iv + di, jv + dj
        k2 = j2 + (tv + c) + 2
        l2 = i2 + (s - b)
        ok = ((i2 >= 1) & (i2 <= j2) & (k2 <= l2) & (l2 <= n)
              & (s - b >= 0))
        return torch.where(ok, sl.to(torch.int32), INF)

    # ---- PL: interior stencil + assembly (batched over tt) ---------------
    pl_stack = torch.where(iv + TURN + 2 < jv, rplane(0) + ESTP_ij, INF)
    PLiloop = torch.where(canp_ij > 0, torch.minimum(pl_stack, pl_int), INF)
    PLmloop_v = torch.minimum(rplane(1), rplane(2)) + ap + bp
    PL_b3 = torch.where(jv >= iv + TURN + 1, rplane(3), INF)
    PLv = torch.where(pt_ij > 0, mmin(PLiloop, PLmloop_v + bp, PL_b3), INF)
    PLs = _enc(PLv, valid4)

    # ---- PR: interior stencil + assembly (batched, u-coordinates) --------
    pr_stack = torch.where(kv + TURN + 2 < lv, rplane(4) + ESTP_klp, INF)
    PRiloop = torch.where(canp_kl > 0, torch.minimum(pr_stack, pr_int), INF)
    PRmloop_v = torch.minimum(rplane(5), rplane(6)) + ap + bp
    PR_b3 = torch.where(lv >= kv + TURN + 1, rplane(7), INF)
    PRv = torch.where(pt_kl > 0, mmin(PRiloop, PRmloop_v + bp, PR_b3), INF)
    PRs = _enc(PRv, valid4)

    # ---- PO (generic interior branch is dead code; see gapped.py) --------
    po_stack = torch.where((iv < jv) & (kv < lv), rplane(8) + ESTP_il, INF)
    POiloop = torch.where(canp_il > 0, po_stack, INF)
    POmloop_v = torch.minimum(rplane(9), rplane(10)) + ap + bp
    PO_b3 = torch.where(lv >= iv + TURN + 1, rplane(11), INF)
    POv = torch.where(pt_il > 0, mmin(POiloop, POmloop_v + bp, PO_b3), INF)
    POs = _enc(POv, valid4)

    # ---- remaining cross-span-only families + the PMmloop10 base ---------
    POm00 = mmin(SAT16 + bp, H["POm00_ri"], H["POm00_rl"])
    POm01 = H["POm01"]
    POm10 = torch.minimum(H["POm10_ri"], H["POm10_rl"])
    PRm01 = torch.minimum(rplane(12) + cp, H["PRm01"])
    PfromO = mmin(H["PfromO_ri"], H["PfromO_rl"], PLs + PB, PRs + PB)
    pmm10 = torch.minimum(H["PMmloop10_ri"], H["PMmloop10_rl"])
    mdp0 = torch.minimum(PLs, PRs) + PB       # PfromMdoubleprime base
    xs = torch.stack([_enc16(v, valid4) for v in (PLv, PRv, POv, PRm01, POm00, POm01,
                                                  POm10, PfromO)])
    return SpanAssembly(PLs, PRs, POs, mdp0, pmm10, xs)


def _need_same(names, xs, shape, dtype=torch.int32):
    """:func:`_need` on operands that share one shape, checked as one: each
    must have the first's shape and ``dtype``, which must fit ``shape``;
    where they differ, each is checked on its own (``names[k]`` names
    ``xs[k]`` in the message)."""
    first = xs[0].shape
    if [x.shape for x in xs].count(first) == len(xs) and {x.dtype for x in xs} == {dtype}:
        _need(names[0], xs[0], shape, dtype)
        return
    for name, x in zip(names, xs):
        _need(name, x, shape, dtype)


def _one_device(tensors):
    """The one device every tensor lies on (the CPU or one CUDA device);
    raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("a kernel needs every operand on one CUDA device "
                         f"(or all on the CPU), got {sorted(map(str, devs))}")
    return devs.pop()


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)   # CUDA builds only


def _raw_stream(dev):
    """``dev``'s current CUDA stream as the integer a launch takes
    (``torch.cuda.current_stream(dev).cuda_stream``, without making the
    Stream object where the build offers that)."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return _RAW_STREAM(dev.index)


_tables = threading.local()    # one launch table of each kind a thread, reused


def _table(cls):
    """This thread's one ``cls`` launch table.  Each launch copies the table
    it is given (it is the kernel's by-value parameter), so the next call
    may overwrite it at once."""
    t = getattr(_tables, cls.__name__, None)
    if t is None:
        t = cls()
        setattr(_tables, cls.__name__, t)
    return t


_I32 = 1 << 31          # offsets the kernels take in 32 bits stay below it


def _packed_layout(cls, fmt, first32):
    """Raise unless ``fmt`` (its 64-bit fields, then its 32-bit ones)
    packs ``cls`` field for field: ``first32``, the first 32-bit field,
    starts where the 64-bit ones end, and ``fmt`` fits the structure."""
    n64 = int(fmt.format.lstrip("=").split("q")[0])
    if getattr(cls, first32).offset != 8 * n64 or fmt.size > ctypes.sizeof(cls):
        raise RuntimeError(f"{cls.__name__}'s struct format does not match its fields")
_RQ, _PQ = len(ASSEMBLE_READS), PLANE_MAX_PARTS


class AssembleTable(ctypes.Structure):
    """The operands of one :func:`span_assemble` launch: csrc/assemble.cu's
    ``struct AssembleTable``, field for field (its 64-bit fields first, so
    :data:`_ASSEMBLE_FMT` packs it in one call), passed to the kernel by
    value.  ``pp`` ... ``pr0``: each plane read's parts (view, strides,
    extents, offsets); ``hist``: the 16 history planes, sharing strides
    ``hs``; ``pl``, ``pr``: the stencils (strides ``pls``, ``prs``);
    ``canp``, ``ptype``, ``estp``: the tables, sharing strides ``ts``
    (unit column stride); ``out32`` / ``out16``: the outputs' 5 and 8
    planes, one after another."""
    _fields_ = [("pp", (ctypes.c_void_p * _PQ) * _RQ),
                ("pst0", (ctypes.c_longlong * _PQ) * _RQ),
                ("pst1", (ctypes.c_longlong * _PQ) * _RQ),
                ("hist", ctypes.c_void_p * len(ASSEMBLE_HISTORY)),
                *((nm, ctypes.c_void_p) for nm in (
                    "pl", "pr", "canp", "ptype", "estp", "out32", "out16")),
                *((nm, (ctypes.c_int * _PQ) * _RQ) for nm in (
                    "pst2", "pTT", "pR", "pt0", "pr0")),
                ("nparts", ctypes.c_int * _RQ), ("hs", ctypes.c_int * 3),
                ("pls", ctypes.c_int * 3), ("prs", ctypes.c_int * 3), ("ts", ctypes.c_int * 2),
                *((nm, ctypes.c_int) for nm in (
                    "B", "TB", "IB", "n2", "n", "s", "i0", "ap", "bp", "cp", "PB"))]


_ASSEMBLE_FMT = struct.Struct(f"={3 * _RQ * _PQ + len(ASSEMBLE_HISTORY) + 7}q"
                              f"{5 * _RQ * _PQ + _RQ + 22}i")
_packed_layout(AssembleTable, _ASSEMBLE_FMT, "pst2")


def _check_parts(q, parts, B, n2, IB):
    """Raise unless plane read q's parts fit (see :func:`assemble_operands`)."""
    if len(parts) > PLANE_MAX_PARTS:
        raise ValueError(f"plane read {ASSEMBLE_READS[q][0]}: {len(parts)} parts, past "
                         f"the kernel's {PLANE_MAX_PARTS}")
    for view, _t0, _r0 in parts:
        _need(f"plane read {ASSEMBLE_READS[q][0]}", view, ((B,), 0, 0, (n2,)), torch.int16)
    spans = sorted(sp for sp in ((max(0, -r0), min(IB, v.shape[2] - r0))
                                 for v, _t0, r0 in parts) if sp[0] < sp[1])
    if any(a2 < b1 for (_a1, b1), (a2, _b2) in zip(spans, spans[1:])):
        raise ValueError(f"plane read {ASSEMBLE_READS[q][0]}: parts overlap in rows")


_TABLE_DTYPES = [torch.bool, torch.int32, torch.int32]     # can_pair, ptype, ESTP


def assemble_operands(planes, pl_int, pr_int, hist, tables, s, n, i0, TB, IB):
    """Raise unless the operands fit one span's assembly: 13 plane reads
    (:data:`ASSEMBLE_READS`); ``pl_int``, ``pr_int`` and the 16 ``hist``
    planes (:data:`ASSEMBLE_HISTORY`) int32 [B, TB, IB, n2]; ``tables``
    (can_pair bool, ptype int32, ESTP int32) [B, n2, n2].  Each plane
    read's parts (:func:`_check_parts`) are checked by the CPU path and by
    :func:`assemble_table` as it reads them.  Returns the tensors, for the
    device check."""
    n2 = n + 2
    B = pl_int.shape[0]
    if TB < 1 or IB < 1 or i0 < 0 or s < 0 or i0 + IB > n2:
        raise ValueError(f"span_assemble: TB {TB}, rows [{i0}, {i0 + IB}) or span {s} "
                         f"do not fit n2 {n2}")
    if len(planes) != len(ASSEMBLE_READS) or len(hist) != len(ASSEMBLE_HISTORY):
        raise ValueError(f"span_assemble takes {len(ASSEMBLE_READS)} plane reads and "
                         f"{len(ASSEMBLE_HISTORY)} history planes, got {len(planes)}, "
                         f"{len(hist)}")
    planes32 = [pl_int, pr_int, *hist]
    _need_same(["pl_int", "pr_int", *(f"hist[{k}]" for k in ASSEMBLE_HISTORY)], planes32,
               ((B,), (TB,), (IB,), (n2,)))
    tabs = list(tables)
    if len(tabs) != 3:
        raise ValueError("span_assemble: tables are (can_pair, ptype, ESTP)")
    if ([x.shape for x in tabs].count((B, n2, n2)) != 3
            or [x.dtype for x in tabs] != _TABLE_DTYPES):
        for name, x, dt in zip(("can_pair", "ptype", "ESTP"), tabs, _TABLE_DTYPES):
            _need(name, x, ((B,), (n2,), (n2,)), dt)
    return [*planes32, *tabs, *(v for parts in planes for v, _t0, _r0 in parts)]


_NO_PART = [(0,) * 8] * _PQ      # a plane read's unused part slots


def assemble_table(planes, pl_int, pr_int, hist, tables, out32, out16, *, s, n, i0, TB,
                   IB, ap, bp, cp, PB):
    """One :func:`span_assemble` launch's operands as the kernel takes them
    (the global checks of :func:`assemble_operands` passed; each plane
    read's parts are checked here as they are read; ``out32`` / ``out16``
    contiguous [5 | 8, B·TB·IB·n2], each row a plane of the span's cells):
    this thread's :class:`AssembleTable`, packed in one call (valid until
    the next call).  Builds on tensors of any device; raises where the
    kernel cannot take them: a j stride that is not 1, history planes or
    tables that do not share their strides, an offset past 32 bits."""
    B, n2 = pl_int.shape[0], n + 2
    cells = B * TB * IB * n2
    if (tuple(out32.shape) != (5, cells) or tuple(out16.shape) != (len(ASSEMBLED), cells)
            or not out32.is_contiguous() or not out16.is_contiguous()
            or out16.numel() >= _I32):
        raise ValueError(f"span_assemble: outputs {tuple(out32.shape)}, "
                         f"{tuple(out16.shape)} are not [5 | 8, {cells}], contiguous, "
                         f"within 32-bit offsets")
    hs, pls, prs = hist[0].stride(), pl_int.stride(), pr_int.stride()
    if hs[3] != 1 or [h.stride() for h in hist].count(hs) != len(hist):
        raise ValueError("span_assemble: the history planes must share their strides with "
                         f"a unit j stride, got {[h.stride() for h in hist]}")
    if pls[3] != 1 or prs[3] != 1:
        raise ValueError(f"span_assemble: pl_int's and pr_int's j stride must be 1, got "
                         f"{pls[3]}, {prs[3]}")
    canp, pt, estp = tables
    ts = pt.stride()
    if ts[2] != 1 or canp.stride() != ts or estp.stride() != ts:
        raise ValueError("span_assemble: the tables must share their strides with a unit "
                         f"column stride, got {[x.stride() for x in tables]}")
    if (any((B - 1) * x[0] + (TB - 1) * x[1] + (IB - 1) * x[2] + n2 >= _I32
            for x in (hs, pls, prs)) or (B - 1) * ts[0] + n2 * ts[1] >= _I32):
        raise ValueError("span_assemble: an int32 plane or a table is past 32-bit offsets")
    rows, nparts, i16 = [], [], torch.int16
    for q, parts in enumerate(planes):
        nparts.append(len(parts))
        if len(parts) > 1:
            _check_parts(q, parts, B, n2, IB)
        for view, t0, r0 in parts:
            shp = view.shape
            if len(shp) != 4 or shp[0] != B or shp[3] != n2 or view.dtype != i16:
                _check_parts(q, parts, B, n2, IB)
            st = view.stride()
            if st[3] != 1:
                raise ValueError(f"span_assemble: the lanes read consecutive j: a plane "
                                 f"view's j stride must be 1, got {st[3]}")
            if (shp[2] - 1) * st[2] >= _I32:
                raise ValueError("span_assemble: a plane view's rows are past 32-bit offsets")
            rows.append((view.data_ptr(), st[0], st[1], st[2], shp[1], shp[2], t0, r0))
        rows += _NO_PART[len(parts):]
    pp, st0, st1, st2, tts, rs, t0s, r0s = zip(*rows)
    t = _table(AssembleTable)
    _ASSEMBLE_FMT.pack_into(
        t, 0, *pp, *st0, *st1, *(h.data_ptr() for h in hist), pl_int.data_ptr(),
        pr_int.data_ptr(), canp.data_ptr(), pt.data_ptr(), estp.data_ptr(),
        out32.data_ptr(), out16.data_ptr(), *st2, *tts, *rs, *t0s, *r0s, *nparts, *hs[:3],
        *pls[:3], *prs[:3], *ts[:2], B, TB, IB, n2, n, s, i0, ap, bp, cp, PB)
    return t


def span_assemble(planes, pl_int, pr_int, hist, tables, *, s, n, i0, TB, IB, ap, bp,
                  cp, PB):
    """The gapped step's cross-span assembly of span s for rows i in
    [i0, i0 + IB) and every tt of the span (pseudo_loop.cc's PL / PR / PO
    recurrences and the cross-span-only families; branch by branch as
    ``gapped4.span_families`` computed them), returned as a
    :class:`SpanAssembly`.

    ``planes``: the 13 plane reads of :data:`ASSEMBLE_READS`, each a list
    of parts read in place (:func:`plane_slab`'s rule: a cell no part holds
    reads SAT16); ``pl_int`` / ``pr_int``: the PL / PR interior stencils
    (``stencil_pl`` / ``stencil_pr``); ``hist``: the span's history scans
    in :data:`ASSEMBLE_HISTORY` order (``history_min``'s planes);
    ``tables``: (can_pair, ptype, ESTP) [B, n2, n2], from which the kernel
    takes the pair planes (X[i, j], X[k, l] with k = j + tt + 2, l = i + s,
    X[i, l]); ``ap``, ``bp``, ``cp``, ``PB`` the energies.  One kernel
    launch on CUDA for the whole batch, every output cell written once
    (:func:`assemble_table`'s operands: a unit j stride on every plane
    view and operand, one set of strides for the ``hist`` planes and one
    for the tables; the wrapper raises otherwise).  The plain version
    (:func:`span_assemble_ref`) for CPU tensors."""
    global ASSEMBLE_LAUNCHES
    dev = _one_device(assemble_operands(planes, pl_int, pr_int, hist, tables, s, n, i0,
                                        TB, IB))
    if dev.type == "cpu":
        for q, parts in enumerate(planes):
            _check_parts(q, parts, pl_int.shape[0], n + 2, IB)
        return span_assemble_ref(planes, pl_int, pr_int, hist, tables, s, n, i0, TB, IB,
                                 ap, bp, cp, PB)
    fn = _library().ccj_span_assemble
    shape = (pl_int.shape[0], TB, IB, n + 2)
    out32 = torch.empty((5, *shape), dtype=torch.int32, device=dev)
    out16 = torch.empty((len(ASSEMBLED), *shape), dtype=torch.int16, device=dev)
    t = assemble_table(planes, pl_int, pr_int, hist, tables, out32.view(5, -1),
                       out16.view(len(ASSEMBLED), -1), s=s, n=n, i0=i0, TB=TB, IB=IB, ap=ap,
                       bp=bp, cp=cp, PB=PB)
    _launch(fn, dev, "span_assemble", ctypes.addressof(t), _raw_stream(dev))
    ASSEMBLE_LAUNCHES += 1
    return SpanAssembly(*out32.unbind(0), out16)


def span_store_ref(dests, loops, xs, s, n, i0, TB, IB):
    """Plain PyTorch version of :func:`span_store`: the write-back as the
    fills ran it before the kernel (``pack`` of every slab, the
    pad-then-slice into each family and C-skew slot, ``update_pk_skews4``'s
    unskew for PKD and PKE), one copy a destination."""
    n2, dev = n + 2, xs.device
    valid4 = span_valid(n, s, i0, TB, IB, n2, dev)

    def pack(slab32):
        v = slab32[:, :TB].clamp(-32768, SAT16)
        return torch.where(valid4, v, SAT16).to(torch.int16)

    packed = {name: pack(loops[name]) for name in STEP_FAMILIES}
    packed.update(zip(ASSEMBLED, xs))
    for family, view, r0, skew in dests:
        sl = packed[family]
        TTd, Rd = view.shape[1], view.shape[2]
        if skew:       # update_pk_skews4: slab[tt, r, a] = PK[tt, r, i0 + r + a]
            if i0:
                sl = pad_axis(sl[..., i0:], -1, 0, i0, SAT16)
            sl = unskew_right(sl, SAT16, n2)
        else:          # row rd of the slot holds slab row rd + r0
            lo, hi = max(-r0, 0), max(r0 + Rd - IB, 0)
            sl = pad_axis(sl, -2, lo, hi, SAT16)[..., r0 + lo:r0 + lo + Rd, :]
        sl = pad_axis(sl, -2, 0, max(Rd - sl.shape[-2], 0), SAT16)[..., :Rd, :]
        sl = pad_axis(sl, -3, 0, max(TTd - TB, 0), SAT16)[:, :TTd]
        view.copy_(sl)


_SD = STORE_MAX_DESTS
STORE_BLOCK_VECS = 256     # csrc/store.cu kBlockVecs: 16-byte vectors (8 elements) a block
_STORE_SRC = {name: k for k, name in enumerate(STORE_SOURCES)}


class StoreTable(ctypes.Structure):
    """The operands of one :func:`span_store` launch: csrc/store.cu's
    ``struct StoreTable``, field for field (its 64-bit fields first, so
    :data:`_STORE_FMT` packs it in one call), passed to the kernel by
    value.  ``loop`` / ``lst``, ``xs`` / ``xst``: the sources and their
    strides; per destination k: ``dp[k]`` its view's pointer, ``dst0``,
    ``dst1``, ``drow`` its b, tt and row strides (a row stride of n2 makes
    each (b, tt) plane one contiguous run), ``dTT``, ``dR`` its extents,
    ``dr0``, ``dskew``, ``dsrc`` (:data:`STORE_SOURCES` index), ``dchunks``
    (blocks a run) and ``dblock0`` (the launch's first block on it)."""
    _fields_ = [("loop", ctypes.c_void_p * len(STEP_FAMILIES)), ("xs", ctypes.c_void_p),
                ("dp", ctypes.c_void_p * _SD), ("dst0", ctypes.c_longlong * _SD),
                ("dst1", ctypes.c_longlong * _SD),
                ("lst", (ctypes.c_int * 3) * len(STEP_FAMILIES)), ("xst", ctypes.c_int * 4),
                *((nm, ctypes.c_int * _SD) for nm in (
                    "drow", "dTT", "dR", "dr0", "dskew", "dsrc", "dchunks", "dblock0")),
                *((nm, ctypes.c_int) for nm in (
                    "nd", "blocks", "B", "TB", "IB", "n2", "n", "s", "i0"))]


_STORE_FMT = struct.Struct(f"={len(STEP_FAMILIES) + 1 + 3 * _SD}q"
                           f"{3 * len(STEP_FAMILIES) + 4 + 8 * _SD + 9}i")
_packed_layout(StoreTable, _STORE_FMT, "lst")


def _check_dest(family, view, r0, skew, B, n2):
    """Raise unless ``view`` (int16 [B, TT, R, n2]) can take ``family``."""
    if family not in _STORE_SRC:
        raise ValueError(f"span_store: no family {family!r}")
    _need(f"destination {family}", view, ((B,), 0, 0, (n2,)), torch.int16)
    if skew and r0:
        raise ValueError("a skewed destination takes slab row rd at its row rd (r0 = 0)")


def store_operands(dests, loops, xs, s, n, i0, TB, IB):
    """Raise unless the operands fit one span's write-back (see
    :func:`span_store`; each destination, :func:`_check_dest`, is checked by
    the CPU path and by :func:`store_table` as it reads it); returns the
    tensors, for the device check."""
    n2 = n + 2
    B = xs.shape[1]
    if TB < 1 or IB < 1 or i0 < 0 or s < 0:
        raise ValueError(f"span_store: TB {TB}, rows [{i0}, {i0 + IB}) or span {s} do not fit")
    if loops.keys() != _STEP_SET:
        raise ValueError(f"loops must be {STEP_FAMILIES}, got {sorted(loops)}")
    _need("xs", xs, ((len(ASSEMBLED),), (B,), (TB,), (IB,), (n2,)), torch.int16)
    srcs = [loops[name] for name in STEP_FAMILIES]
    _need_same([f"loops[{name}]" for name in STEP_FAMILIES], srcs,
               ((B,), TB, (IB,), (n2,)))
    if len(dests) > STORE_MAX_DESTS:
        raise ValueError(f"{len(dests)} store destinations, past the kernel's "
                         f"{STORE_MAX_DESTS}")
    return [*srcs, xs, *(d.view for d in dests)]


_STEP_SET = set(STEP_FAMILIES)


def store_table(dests, loops, xs, *, s, n, i0, TB, IB):
    """One :func:`span_store` launch's operands as the kernel takes them
    (the global checks of :func:`store_operands` passed): this thread's
    :class:`StoreTable`, packed in one call (valid until the next call),
    and the launch's blocks.  Each destination's runs are its (b, tt)
    planes where its row stride is n2 (every destination the layouts
    make), else its rows; ``dchunks`` blocks of :data:`STORE_BLOCK_VECS`
    16-byte vectors a run (the run's partial first and last vectors
    included); ``dblock0`` is the prefix sum of the destinations' blocks.
    An empty view takes no entry.  Builds on tensors of any device;
    checks each destination as it reads it (:func:`store_operands` does
    the rest) and raises where the kernel cannot take the operands: a j
    stride that is not 1, a source offset past 32 bits."""
    n2 = n + 2
    B = xs.shape[1]
    srcs = [loops[name] for name in STEP_FAMILIES]
    lsts = [x.stride() for x in srcs]
    for st in set(lsts):
        if st[3] != 1:
            raise ValueError(f"span_store: a loop family's j stride must be 1, got {st[3]}")
        if (B - 1) * st[0] + (TB - 1) * st[1] + (IB - 1) * st[2] + n2 >= _I32:
            raise ValueError("span_store: a loop family is past 32-bit offsets")
    xst = xs.stride()
    if xst[4] != 1:
        raise ValueError(f"span_store: xs' j stride must be 1, got {xst[4]}")
    if (len(ASSEMBLED) - 1) * xst[0] + (B - 1) * xst[1] + (TB - 1) * xst[2] + (
            IB - 1) * xst[3] + n2 >= _I32:
        raise ValueError("span_store: xs is past 32-bit offsets")
    rows, blocks, vpb, i16, src_of = [], 0, STORE_BLOCK_VECS, torch.int16, _STORE_SRC
    for family, view, r0, skew in dests:
        shp = view.shape
        if (len(shp) != 4 or shp[0] != B or shp[3] != n2 or view.dtype != i16
                or family not in src_of or (skew and r0)):
            _check_dest(family, view, r0, skew, B, n2)
        TT, R = shp[1], shp[2]
        if not TT or not R:
            continue
        st = view.stride()
        if st[3] != 1:
            raise ValueError(f"span_store: the lanes write consecutive j: a destination's "
                             f"j stride must be 1, got {st[3]}")
        run = st[2] == n2                  # each (b, tt) plane one contiguous run
        chunks = -(-(((R * n2 if run else n2) + 14) // 8) // vpb)
        rows.append((view.data_ptr(), st[0], st[1], st[2], TT, R, r0, skew, src_of[family],
                     chunks, blocks))
        blocks += B * TT * (R if not run else 1) * chunks
    nd = len(rows)
    pad = (0,) * (_SD - nd)
    dp, dst0, dst1, drow, dTT, dR, dr0, dskew, dsrc, dchunks, dblock0 = (
        zip(*rows) if rows else ((),) * 11)
    t = _table(StoreTable)
    _STORE_FMT.pack_into(
        t, 0, *[x.data_ptr() for x in srcs], xs.data_ptr(),
        *dp, *pad, *dst0, *pad, *dst1, *pad, *[x for st in lsts for x in st[:3]], *xst[:4],
        *drow, *pad, *dTT, *pad, *dR, *pad, *dr0, *pad, *dskew, *pad, *dsrc, *pad,
        *dchunks, *pad, *dblock0, *pad, nd, blocks, B, TB, IB, n2, n, s, i0)
    return t, blocks


def span_store(dests, loops, xs, *, s, n, i0, TB, IB):
    """Write span s's results into the state's destination views, in one
    launch on CUDA: each :class:`StoreDest` receives its family packed
    (the tt loop's 14 ``loops`` int32 [B, >= TB, IB, n2], clamped to
    int16, and the :data:`ASSEMBLED` families from ``xs``, int16 [8, B,
    TB, IB, n2], on the span's valid cells; SAT16 on every other cell),
    every element of every view written once.  ``xs`` must be SAT16 off
    the valid cells, as ``span_assemble`` leaves it: the kernel reads no
    source there, where the plain version copies ``xs`` as it is.  Rows are
    i in [i0, i0 + IB).  The views must not overlap one another; on CUDA
    every view and source needs a unit j stride (:func:`store_table`: the
    wrapper raises otherwise).  The plain version (:func:`span_store_ref`)
    for CPU tensors."""
    global STORE_LAUNCHES
    dev = _one_device(store_operands(dests, loops, xs, s, n, i0, TB, IB))
    if dev.type == "cpu":
        for family, view, r0, skew in dests:
            _check_dest(family, view, r0, skew, xs.shape[1], n + 2)
        return span_store_ref(dests, loops, xs, s, n, i0, TB, IB)
    fn = _library().ccj_span_store
    t, blocks = store_table(dests, loops, xs, s=s, n=n, i0=i0, TB=TB, IB=IB)
    if blocks == 0:
        return None
    _launch(fn, dev, "span_store", ctypes.addressof(t), _raw_stream(dev))
    STORE_LAUNCHES += 1
    return None


# ---------------------------------------------------------------------------
# span_v, span_wbp, span_wm, wx_tables: the span's 2-D recurrences
# ---------------------------------------------------------------------------

SPAN_V_LAUNCHES = 0     # span_v kernel launches (CUDA only)
SPAN_WBP_LAUNCHES = 0   # span_wbp kernel launches (CUDA only)
SPAN_WM_LAUNCHES = 0    # span_wm kernel launches (CUDA only)
WX_LAUNCHES = 0         # wx_tables kernel launches (CUDA only)

# csrc/span2d.cu's operand slots and kinds, in order
SPAN2D_OPERANDS = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP", "H", "EINT",
                   "ML0", "ML2", "ML_ip1", "ML_jm1", "ML_both",
                   "MB0", "MB2", "MB_5", "MB_3", "MB_53", "p_min", "out")
SPAN2D_KINDS = ("span_v", "span_wbp", "span_wm", "wx_tables")
_SPAN2D_STATE = frozenset(("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP"))
_SPAN2D_SLOT = {name: k for k, name in enumerate(SPAN2D_OPERANDS)}
_SPAN2D_SCALARS = ("MLbase", "PSM", "PSP", "PUP", "PPS", "b", "bp", "cp")
# the kinds whose kernels address each operand with 32-bit offsets inside a
# batch element (csrc/span2d.cu Mat32)
_SPAN2D_OFF32 = frozenset(("span_v", "span_wbp", "span_wm"))
# the key of a fill's launch tables in its tables' dict C
# (:func:`span2d_fill_tables`)
SPAN2D_FILL = "SPAN2D_FILL"


def _span2d_reads(kind, dangles):
    """The operands ``kind`` reads (or writes) at ``dangles``."""
    mb = {0: ("MB0",), 1: ("MB0", "MB_5", "MB_3", "MB_53"), 2: ("MB2",)}
    ml = {0: ("ML0",), 1: ("ML0", "ML_ip1", "ML_jm1", "ML_both"), 2: ("ML2",)}
    return {"span_v": ("V", "Vtype", "WM", "WMv", "WMp", "H", "EINT", *mb[dangles]),
            "span_wbp": ("V", "P2", "WBP", "WPP"),
            "span_wm": ("V", "P2", "WM", "WMv", "WMp", *ml[dangles]),
            "wx_tables": ("WBP", "WPP")}[kind]


_SPAN2D_READS = {(k, d): _span2d_reads(k, d) for k in SPAN2D_KINDS for d in (0, 1, 2)}


class Span2dTable(ctypes.Structure):
    """The operands of one csrc/span2d.cu launch: its ``struct
    Span2dTable``, field for field (the 64-bit fields first, so
    :data:`_SPAN2D_FMT` packs it in one call), passed to the kernel by
    value.  ``p[k]``, ``bs[k]``, ``rs[k]``, ``cs[k]``: operand slot k's
    pointer and its batch, row and column strides (:data:`SPAN2D_OPERANDS`;
    zero where the kind does not read it; ``p_min`` [B, n2] has no row
    stride, ``out`` [4, B, n2, n2] is contiguous), ``edi`` / ``edj`` EINT's
    di and dj strides; ``kind`` indexes :data:`SPAN2D_KINDS`;
    ``dependent`` (span_v) makes the launch a programmatic dependent of the
    kernel before it; the fill's scalars follow."""
    _fields_ = [*((nm, ctypes.c_longlong * len(SPAN2D_OPERANDS))
                  for nm in ("p", "bs", "rs", "cs")),
                ("edi", ctypes.c_longlong), ("edj", ctypes.c_longlong),
                *((nm, ctypes.c_int) for nm in (
                    "kind", "B", "n", "n2", "s", "dangles", "dependent", "MLbase", "PSM",
                    "PSP", "PUP", "PPS", "pkb", "bp", "cp"))]


_SPAN2D_FMT = struct.Struct(f"={4 * len(SPAN2D_OPERANDS) + 2}q15i")
_packed_layout(Span2dTable, _SPAN2D_FMT, "kind")
# a fill table's fields that change from span to span: s, dangles and
# dependent (consecutive ints), and span_wbp's p_min slot (pointer, batch
# and column strides)
_SPAN2D_STEP = struct.Struct("=3i")
_SPAN2D_Q = struct.Struct("=q")
_SPAN2D_S_AT = Span2dTable.s.offset
_SPAN2D_PMIN_AT = tuple(getattr(Span2dTable, f).offset + 8 * _SPAN2D_SLOT["p_min"]
                        for f in ("p", "bs", "cs"))
if Span2dTable.dependent.offset != _SPAN2D_S_AT + 8:
    raise RuntimeError("Span2dTable's s, dangles and dependent are not consecutive")


def span2d_operands(C, st, kind, dangles=2):
    """Raise unless the state and tables fit one ``kind`` call (every
    operand it reads int32 [B, n2, n2], Vtype int8, EINT [B, 32, 32, n2,
    n2], all on one device, n2 = C["n"] + 2); returns (device, names,
    tensors)."""
    if dangles not in (0, 1, 2):
        raise ValueError(f"{kind}: dangles must be 0, 1 or 2, got {dangles}")
    names = _SPAN2D_READS[kind, dangles]
    first = st[names[0]]
    n2 = C["n"] + 2
    if first.dim() != 3 or first.shape[1:] != (n2, n2):
        raise ValueError(f"{kind}: {names[0]} {tuple(first.shape)} is not [B, {n2}, {n2}] "
                         f"(n = {C['n']})")
    B, dev = first.shape[0], first.device
    sq, eint = (B, n2, n2), (B, MAXLOOP + 2, MAXLOOP + 2, n2, n2)
    xs = []
    for name in names:
        x = st[name] if name in _SPAN2D_STATE else C[name]
        want, dt = (eint if name == "EINT" else sq), (
            torch.int8 if name == "Vtype" else torch.int32)
        if x.shape != want or x.dtype != dt:
            _need(name, x, tuple((d,) for d in want), dt)
        if x.device != dev:
            raise ValueError(f"{kind}: every operand on one device (or all on the CPU); "
                             f"{names[0]} on {dev}, {name} on {x.device}")
        xs.append(x)
    return dev, names, xs


def _span2d_pack(t, kind, C, s, dangles, names, xs, dev, out=False, p_min=None,
                 dependent=False):
    """Pack one csrc/span2d.cu launch of ``kind`` on the checked operands
    (:func:`span2d_operands`) into the :class:`Span2dTable` ``t``, in one
    call, every operand taken with its own strides (the tables from numpy
    may be column-major).  ``out``: the [4, B, n2, n2] contiguous tensor
    of the out slot (``span_wbp``'s kept tables), True to allocate it
    (``wx_tables``' output), or None / False for none; ``p_min``:
    ``span_wbp``'s [B, n2] P-split minima, or None; ``dependent``: a
    programmatic dependent launch (:func:`span_v`, :func:`span_wm`).
    Returns the out slot's tensor (None without one)."""
    n = C["n"]
    n2 = n + 2
    k = len(SPAN2D_OPERANDS)
    ptrs, bs, rs, cs = [0] * k, [0] * k, [0] * k, [0] * k
    edi = edj = 0
    for name, x in zip(names, xs):
        slot = _SPAN2D_SLOT[name]
        st = x.stride()
        if name == "EINT":
            edi, edj = st[1], st[2]
        ptrs[slot], bs[slot], rs[slot], cs[slot] = x.data_ptr(), st[0], st[-2], st[-1]
    # every operand's last offset inside a batch element is at most this
    if kind in _SPAN2D_OFF32 and (n2 - 1) * max(map(int.__add__, rs, cs)) \
            + (MAXLOOP + 1) * (edi + edj) >= _I32:
        raise ValueError(f"{kind}: an operand's offsets inside a batch element pass 31 bits")
    if p_min is not None:
        slot = _SPAN2D_SLOT["p_min"]
        ptrs[slot], bs[slot], cs[slot] = p_min.data_ptr(), *p_min.stride()
    B = xs[0].shape[0]
    if B > MAX_GRID_Y:
        raise ValueError(f"{kind}: a batch of {B} is past the grid's {MAX_GRID_Y}")
    if out is True:
        out = torch.empty((4, B, n2, n2), dtype=torch.int32, device=dev)
    elif out is False:
        out = None
    if out is not None:
        ptrs[-1] = out.data_ptr()
    _SPAN2D_FMT.pack_into(t, 0, *ptrs, *bs, *rs, *cs, edi, edj, SPAN2D_KINDS.index(kind),
                          B, n, n2, s, dangles, int(dependent),
                          *(C[name] for name in _SPAN2D_SCALARS))
    return out


def _span2d_launch(kind, C, s, dangles, names, xs, dev, out=False, p_min=None,
                   dependent=False):
    """One csrc/span2d.cu launch of ``kind`` on the checked operands, from
    this thread's :class:`Span2dTable` (:func:`_span2d_pack`'s arguments);
    returns the out slot's tensor (None without one)."""
    fn = _library().ccj_span2d
    t = _table(Span2dTable)
    out = _span2d_pack(t, kind, C, s, dangles, names, xs, dev, out, p_min, dependent)
    _launch(fn, dev, kind, ctypes.addressof(t), _raw_stream(dev))
    return out


def _check_wbp_extra(p_min, wx, B, n2, dev):
    """Raise unless ``span_wbp``'s P-split minima (int32 [B, n2]) and kept
    tables (int32 [4, B, n2, n2], contiguous) fit, where given."""
    for name, x, shape in (("p_min", p_min, (B, n2)), ("wx", wx, (4, B, n2, n2))):
        if x is not None and (x.shape != shape or x.dtype != torch.int32 or x.device != dev
                              or name == "wx" and not x.is_contiguous()):
            raise ValueError(f"span_wbp: {name} must be int32 {shape} on {dev}"
                             f"{' and contiguous' if name == 'wx' else ''}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, strides {x.stride()}")


class Span2dFill:
    """One kind's csrc/span2d.cu launch table for a whole fill: the
    operands of ``st`` and ``C`` checked (:func:`span2d_operands`) and
    packed once (:func:`_span2d_pack`, ``out`` the kept weight tables of
    ``span_wbp``); :meth:`launch` writes the fields that change from span
    to span (s, ``dependent``, ``span_wbp``'s P-split minima) at
    :data:`_SPAN2D_FMT`'s offsets and launches.  It holds the tensors it
    points into, and :meth:`fits` takes it only for those very tensors
    and scalars: the fills update their state in place and swap no tensor,
    and a call on any other (a state entry reassigned, a copy of ``C``
    with another table) takes the checked path."""
    __slots__ = ("kind", "st", "dangles", "out", "dev", "reads", "scalars", "B", "n2",
                 "table", "addr")

    def __init__(self, kind, C, st, dangles=0, out=None):
        self.dev, names, xs = span2d_operands(C, st, kind, dangles)
        self.kind, self.st, self.dangles, self.out = kind, st, dangles, out
        self.reads = tuple((name in _SPAN2D_STATE, name, x) for name, x in zip(names, xs))
        self.scalars = tuple((name, C[name]) for name in ("n", *_SPAN2D_SCALARS))
        self.B, self.n2 = xs[0].shape[0], C["n"] + 2
        if kind == "span_wbp":
            _check_wbp_extra(None, out, self.B, self.n2, self.dev)
        self.table = Span2dTable()
        _span2d_pack(self.table, kind, C, 0, dangles, names, xs, self.dev, out)
        self.addr = ctypes.addressof(self.table)

    def fits(self, C, st, dangles, out):
        """Whether a call on ``C``, ``st``, ``dangles`` and ``out`` reads the
        very tensors and scalars this table was packed from."""
        return (self.st is st and self.dangles == dangles and self.out is out
                and all((st if state else C)[name] is x for state, name, x in self.reads)
                and all(C[name] == v for name, v in self.scalars))

    def launch(self, s, dependent=False, p_min=None):
        """One launch at span ``s`` (``p_min``: ``span_wbp``'s minima or
        None), on the device's current stream."""
        t = self.table
        _SPAN2D_STEP.pack_into(t, _SPAN2D_S_AT, s, self.dangles, int(dependent))
        if self.kind == "span_wbp":
            vals = (0, 0, 0) if p_min is None else (p_min.data_ptr(), *p_min.stride())
            for at, v in zip(_SPAN2D_PMIN_AT, vals):
                _SPAN2D_Q.pack_into(t, at, v)
        _launch(_library().ccj_span2d, self.dev, self.kind, self.addr, _raw_stream(self.dev))


def span2d_fill_tables(C, st, dangles):
    """A fill's launch tables of ``span_v``, ``span_wbp`` (with the kept
    weight tables ``C[gapped.WX]``, made first) and ``span_wm`` on its
    state ``st`` (:class:`Span2dFill`), for ``C[SPAN2D_FILL]``: the
    wrappers take them wherever ``C`` holds them for the very ``st``,
    ``dangles``, tensors and scalars they are called with, and the checked
    path otherwise (a call outside a fill, or on another state).  Built on
    tensors of any device (on the CPU the plain versions run)."""
    return {"span_v": Span2dFill("span_v", C, st, dangles),
            "span_wbp": Span2dFill("span_wbp", C, st, out=C.get(WX)),
            "span_wm": Span2dFill("span_wm", C, st, dangles)}


def _fill_table(C, st, kind, dangles=0, out=None):
    """``C``'s fill table of ``kind`` where it fits the call
    (:meth:`Span2dFill.fits`); else None (the checked path)."""
    tabs = C.get(SPAN2D_FILL)
    t = None if tabs is None else tabs[kind]
    return t if t is not None and t.fits(C, st, dangles, out) else None


def _diag_idx(n2, s, device):
    """Row index vector i (0..n2-1) and the diagonal column j = i + s."""
    ii = torch.arange(n2, device=device)
    return ii, ii + s


def e_mlstem_diag(C, st, ii, jj, dangles):
    """E_MLStem(V(i,j), V(i+1,j), V(i,j-1), V(i+1,j-1))
    (s_energy_matrix.cc:54-112) for index tensors (ii, jj)."""
    V = st["V"]
    n2 = V.shape[-1]
    iic = ii.clamp(0, n2 - 1)
    jjc = jj.clamp(0, n2 - 1)
    vij = v_get(V, iic, jjc)
    e = guarded_add(vij, (C["ML2"] if dangles == 2 else C["ML0"])[:, iic, jjc])
    if dangles == 1:
        MLbase = C["MLbase"]
        ip1 = (ii + 1).clamp(0, n2 - 1)
        jm1 = (jj - 1).clamp(0, n2 - 1)
        vi1j = torch.where(jj - ii - 1 > TURN, v_get(V, ip1, jjc), INF)
        e = torch.minimum(e, guarded_add(vi1j, MLbase + C["ML_ip1"][:, iic, jjc]))
        vij1 = torch.where(jj - 1 - ii > TURN,
                           v_get(V, iic, (jjc - 1).clamp(0, n2 - 1)), INF)
        e = torch.minimum(e, guarded_add(vij1, MLbase + C["ML_jm1"][:, iic, jjc]))
        vi1j1 = torch.where(jj - 1 - ii - 1 > TURN, v_get(V, ip1, jm1), INF)
        e = torch.minimum(
            e, guarded_add(vi1j1, 2 * MLbase + C["ML_both"][:, iic, jjc]))
    return e


def span_v_ref(C, st, s, dangles):
    """Plain PyTorch version of :func:`span_v`: V(i, i+s) for all i
    (s_energy_matrix.cc:315-358), in place, as the fills ran it before the
    kernel."""
    n = C["n"]
    n2 = n + 2
    V = st["V"]
    dev = V.device
    ii, jj = _diag_idx(n2, s, dev)
    jjc = jj.clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (jj <= n)

    # --- hairpin (H already INF where unpairable) --------------------------
    e_h = C["H"][:, ii, jjc]

    # --- interior loops (s_energy_matrix.cc:287-299) -----------------------
    # k=i+di, l=j-dj; bounds: di>=1, dj>=1, di <= MAXLOOP+1,
    # l >= k+TURN+1  <=>  di+dj <= s-TURN-1;  n1+n2 <= MAXLOOP  <=>
    # di+dj <= MAXLOOP+2;  k <= j-TURN-2  <=>  di <= s-TURN-2 (implied)
    di = torch.arange(MAXLOOP + 2, device=dev)[:, None, None]
    dj = torch.arange(MAXLOOP + 2, device=dev)[None, :, None]
    iv = ii[None, None, :]
    jv = jj[None, None, :]
    ok = ((di >= 1) & (dj >= 1)
          & (di <= MAXLOOP + 1)
          & (di + dj <= MAXLOOP + 2)
          & (di + dj <= s - TURN - 1)
          & (iv >= 1) & (jv <= n))
    eint = C["EINT"][:, di, dj, iv, jv.clamp(0, n2 - 1)]
    vin = v_get(V, (iv + di).clamp(0, n2 - 1), (jv - dj).clamp(0, n2 - 1))
    e_i = torch.where(ok, eint + vin, INF).amin(dim=(-3, -2))

    # --- multiloop (compute_energy_VM, s_energy_matrix.cc:243-268) ---------
    # split point c = i + g, g in [1, s-3]
    WM, WMv, WMp = st["WM"], st["WMv"], st["WMp"]
    gg = torch.arange(n2, device=dev)[:, None]
    iv2 = ii[None, :]
    cc = iv2 + gg
    ok2 = (gg >= 1) & (gg <= s - 3) & (iv2 >= 1) & (iv2 + s <= n)
    MLbase = C["MLbase"]

    def getter(M):
        def g(a, b):  # get_energy_WM / WMv / WMp: INF for a >= b
            return torch.where(a >= b, INF,
                               M[:, a.clamp(0, n2 - 1), b.clamp(0, n2 - 1)])
        return g

    wm_g, wmv_g, wmp_g = getter(WM), getter(WMv), getter(WMp)
    gm1 = ((gg - 1) * MLbase).to(torch.int32)
    gm2 = ((gg - 2) * MLbase).to(torch.int32)

    jm1v = iv2 + s - 1
    wm2_ij = mmin(
        wm_g(iv2 + 1, cc - 1) + wmv_g(cc, jm1v),
        wm_g(iv2 + 1, cc - 1) + wmp_g(cc, jm1v),
        gm1 + wmp_g(cc, jm1v),
    )
    if dangles == 2:
        e_c = guarded_add(wm2_ij, C["MB2"][:, None, ii, jjc])
    elif dangles == 0:
        e_c = guarded_add(wm2_ij, C["MB0"][:, None, ii, jjc])
    else:  # dangles == 1 (s_energy_matrix.cc:142-195)
        jm2v = iv2 + s - 2
        e_c = guarded_add(wm2_ij, C["MB0"][:, None, ii, jjc])
        wm2_ip1j = mmin(
            wm_g(iv2 + 2, cc - 1) + wmv_g(cc, jm1v),
            # quirk preserved: WMp(k-1, j-1) (s_energy_matrix.cc:254)
            wm_g(iv2 + 2, cc - 1) + wmp_g(cc - 1, jm1v),
            gm2 + wmp_g(cc, jm1v),
        )
        e_c = torch.minimum(e_c, guarded_add(wm2_ip1j, C["MB_5"][:, None, ii, jjc]))
        wm2_ijm1 = mmin(
            wm_g(iv2 + 1, cc - 1) + wmv_g(cc, jm2v),
            wm_g(iv2 + 1, cc - 1) + wmp_g(cc, jm2v),
            gm1 + wmp_g(cc, jm2v),
        )
        e_c = torch.minimum(e_c, guarded_add(wm2_ijm1, C["MB_3"][:, None, ii, jjc]))
        wm2_ip1jm1 = mmin(
            wm_g(iv2 + 2, cc - 1) + wmv_g(cc, jm2v),
            wm_g(iv2 + 2, cc - 1) + wmp_g(cc, jm2v),
            gm2 + wmp_g(cc, jm2v),
        )
        e_c = torch.minimum(e_c, guarded_add(wm2_ip1jm1, C["MB_53"][:, None, ii, jjc]))
    e_m = torch.where(ok2, e_c, INF).amin(dim=-2)

    # --- select & store (compute_energy min_rank; first-minimum wins) ------
    branches = torch.stack([e_h, e_i, e_m])
    vmin = branches.amin(dim=0)
    rank = torch.argmin(branches, dim=0)  # first minimum, as jnp.argmin
    is_set = vmin < INF // 2
    newV = torch.where(is_set, vmin, V_UNSET)
    newT = torch.where(is_set, rank + 1, 0).to(torch.int8)  # 1=H,2=I,3=M, 0=N

    Vt = st["Vtype"]
    write = row_valid & (jj > ii)
    V[:, ii, jjc] = torch.where(write, newV, V[:, ii, jjc])
    Vt[:, ii, jjc] = torch.where(write, newT, Vt[:, ii, jjc])


def span_v(C, st, s, dangles, dependent=False):
    """V(i, i+s) and Vtype for every live row i of span s, in place, for
    every element of the batch: one ``span_v`` launch on CUDA
    (csrc/span2d.cu), none at s = 0, whose cells j = i are never written.
    ``st``: the state's V, Vtype, WM, WMv, WMp ([B, n2, n2]); ``C`` the
    fill's tables (H, EINT, the MB tables of ``dangles``) with their batch
    axis and its scalars.  ``dependent``: launch it as a programmatic
    dependent of the kernel before it in the stream, which may then still
    run while span_v reads EINT, H and the MB tables.  Only for a caller
    that knows that kernel writes none of those three (a fill's span loop,
    after its first span); by default the launch is plain and the stream
    orders every read.  A fill's launch table (:func:`span2d_fill_tables`)
    where ``C`` holds one for ``st``.  The plain version
    (:func:`span_v_ref`) for CPU tensors."""
    global SPAN_V_LAUNCHES
    ft = _fill_table(C, st, "span_v", dangles)
    dev, names, xs = (ft.dev, (), ()) if ft else span2d_operands(C, st, "span_v", dangles)
    if dev.type == "cpu":
        return span_v_ref(C, st, s, dangles)
    if 1 <= s < C["n"]:
        if ft:
            ft.launch(s, dependent)
        else:
            _span2d_launch("span_v", C, s, dangles, names, xs, dev, dependent=dependent)
        SPAN_V_LAUNCHES += 1
    return None


def wx_tables_ref(C, st):
    """Plain PyTorch version of :func:`wx_tables`."""
    n = C["n"]
    n2 = n + 2
    dev = st["WBP"].device
    a = torch.arange(n2, device=dev)[:, None]
    b = torch.arange(n2, device=dev)[None, :]
    inb = (a >= 1) & (b >= 1) & (a <= n) & (b <= n)

    def wx(raw, unit):
        base = torch.minimum((unit * (b - a + 1)).to(torch.int32), raw)
        return torch.where(inb, torch.where(a > b, 0, base), INF)

    WB = wx(st["WBP"], C["cp"])
    WP = wx(st["WPP"], C["PUP"])
    # TriangleMatrix::get (i>j -> INF) for the >=1-pair variants
    WBPg = torch.where(a > b, INF, st["WBP"])
    WPPg = torch.where(a > b, INF, st["WPP"])
    return torch.stack((WB, WP, WBPg, WPPg))


def wx_tables(C, st):
    """The gapped step's weight tables from the state's WBP and WPP
    ([B, n2, n2] int32): one int32 [4, B, n2, n2] tensor, along its first
    axis WB, WP, WBPg, WPPg -- WB / WP as ``get_WB`` / ``get_WP``
    (pseudo_loop.cc:647-661: INF off [1, n], 0 for a > b, else
    min(unit * (b - a + 1), raw), unit cp / PUP), WBPg / WPPg as
    ``TriangleMatrix::get`` (INF for a > b).  One ``wx_tables`` launch on
    CUDA (csrc/span2d.cu): a fill makes them once and :func:`span_wbp`
    keeps them current.  The plain version (:func:`wx_tables_ref`) for CPU
    tensors."""
    global WX_LAUNCHES
    dev, names, xs = span2d_operands(C, st, "wx_tables")
    if dev.type == "cpu":
        return wx_tables_ref(C, st)
    out = _span2d_launch("wx_tables", C, 0, 0, names, xs, dev, out=True)
    WX_LAUNCHES += 1
    return out


def span_wbp_ref(C, st, s, p_min=None, wx=None):
    """Plain PyTorch version of :func:`span_wbp`: P's span-s diagonal from
    ``p_min`` (``gapped._set_P_diag``), then compute_WBP / compute_WPP for
    all blocks (i, l=i+s) (pseudo_loop.cc:134-164), then the span-s
    diagonal of the kept tables ``wx``, in place, as the fills ran it
    before the kernel."""
    from .gapped import _set_P_diag

    n = C["n"]
    n2 = n + 2
    if p_min is not None:
        _set_P_diag(st, n, s, p_min)
    dev = st["WBP"].device
    ii = torch.arange(n2, device=dev)
    ll = ii + s
    llc = ll.clamp(0, n2 - 1)
    lm1 = (ll - 1).clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (ll <= n)

    WB, WP, _, _ = wx_tables_ref(C, st)
    gg = torch.arange(n2, device=dev)[:, None]          # g = d - i in [0, s-1]
    iv2 = ii[None, :]
    dd = iv2 + gg
    ok = (gg >= 0) & (gg <= s - 1) & (iv2 >= 1) & (iv2 + s <= n)
    ddc = dd.clamp(0, n2 - 1)
    lv = (iv2 + s).clamp(0, n2 - 1)
    vdl = v_get(st["V"], ddc, lv)
    pdl = torch.where(dd > iv2 + s, INF, st["P2"][:, ddc, lv])  # P.get(d,l), d<=l
    ivc = iv2.clamp(0, n2 - 1)
    dm1 = (dd - 1).clamp(0, n2 - 1)

    WBPr = st["WBP"]
    wb_prev = torch.where(dd - 1 >= 0, WB[:, ivc, dm1], INF)
    b1 = torch.where(ok, wb_prev + vdl + C["bp"] + C["PPS"], INF).amin(dim=-2)
    b2 = torch.where(ok, wb_prev + pdl + C["PSM"] + C["PPS"], INF).amin(dim=-2)
    b3 = torch.where(ii > ll - 1, INF, WBPr[:, ii, lm1]) + C["cp"]
    wbp_min = mmin(b1, b2, b3)

    WPPr = st["WPP"]
    wp_prev = torch.where(dd - 1 >= 0, WP[:, ivc, dm1], INF)
    c1 = torch.where(ok, wp_prev + vdl + C["PPS"], INF).amin(dim=-2)
    c2 = torch.where(ok, wp_prev + pdl + C["PSP"] + C["PPS"], INF).amin(dim=-2)
    c3 = torch.where(ii > ll - 1, INF, WPPr[:, ii, lm1]) + C["PUP"]
    wpp_min = mmin(c1, c2, c3)

    old = WBPr[:, ii, llc]
    newWBP = torch.where(wbp_min < INF // 2, wbp_min, old)
    WBPr[:, ii, llc] = torch.where(row_valid, newWBP, old)
    old = WPPr[:, ii, llc]
    newWPP = torch.where(wpp_min < INF // 2, wpp_min, old)
    WPPr[:, ii, llc] = torch.where(row_valid, newWPP, old)

    if wx is not None:                  # wx_tables' rule on the span-s cells
        rows, cols = ii[row_valid], ll[row_valid]
        wbp, wpp = WBPr[:, rows, cols], WPPr[:, rows, cols]
        wx[0][:, rows, cols] = wbp.clamp(max=C["cp"] * (s + 1))
        wx[1][:, rows, cols] = wpp.clamp(max=C["PUP"] * (s + 1))
        wx[2][:, rows, cols] = wbp
        wx[3][:, rows, cols] = wpp


def span_wbp(C, st, s, p_min=None, wx=None):
    """P's span-s diagonal, WBP(i, i+s) and WPP(i, i+s) for every live row
    i of span s, in place, for every element of the batch: one ``span_wbp``
    launch on CUDA (csrc/span2d.cu) a span with a live row, the WB / WP
    weights computed in the kernel from WBP / WPP.  ``p_min``: the P
    split's minima (int32 [B, n2], :func:`p_split` over every row): P(i,
    i+s) takes p_min[b, i] where it is below INF / 2 (the rule of
    ``gapped._set_P_diag``) before the row reads it; None where P's span-s
    diagonal is written already (or no split has a term).  ``wx``: the
    fill's kept weight tables (:func:`wx_tables`' int32 [4, B, n2, n2],
    contiguous), whose span-s cells of the live rows take the new WBP /
    WPP; None to keep none.  ``st``: the state's V, P2, WBP, WPP ([B, n2,
    n2]); ``C`` the fill's scalars.  A fill's launch table
    (:func:`span2d_fill_tables`) where ``C`` holds one for ``st`` and
    ``wx``.  The plain version (:func:`span_wbp_ref`) for CPU tensors."""
    global SPAN_WBP_LAUNCHES
    ft = _fill_table(C, st, "span_wbp", out=wx)
    if ft:              # the fill's operands and tables were checked at its start
        dev = ft.dev
        _check_wbp_extra(p_min, None, ft.B, ft.n2, dev)
    else:
        dev, names, xs = span2d_operands(C, st, "span_wbp")
        _check_wbp_extra(p_min, wx, xs[0].shape[0], C["n"] + 2, dev)
    if dev.type == "cpu":
        return span_wbp_ref(C, st, s, p_min, wx)
    if 0 <= s < C["n"]:
        if ft:
            ft.launch(s, p_min=p_min)
        else:
            _span2d_launch("span_wbp", C, s, 0, names, xs, dev, out=wx, p_min=p_min)
        SPAN_WBP_LAUNCHES += 1
    return None


def span_wm_ref(C, st, s, dangles):
    """Plain PyTorch version of :func:`span_wm`: compute_WMv_WMp +
    compute_energy_WM for span s (s_energy_matrix.cc:206-241), in place, as
    the fills ran it before the kernel; no-op when s < 3 (j-i+1 < 4)."""
    n = C["n"]
    n2 = n + 2
    WM, WMv, WMp, P2 = st["WM"], st["WMv"], st["WMp"], st["P2"]
    dev = WM.device
    ii, jj = _diag_idx(n2, s, dev)
    jjc = jj.clamp(0, n2 - 1)
    jm1 = (jj - 1).clamp(0, n2 - 1)
    row_valid = (ii >= 1) & (jj <= n) & (s >= 3)

    MLbase = C["MLbase"]
    psm_b = C["PSM"] + C["b"]

    stem = e_mlstem_diag(C, st, ii, jj, dangles)
    wmv_new = torch.minimum(stem, WMv[:, ii, jm1] + MLbase)
    # WMB argument is P.get(i,j) (W_final.cc:64): i<=j -> raw cell
    wmp_new = torch.minimum(P2[:, ii, jjc] + psm_b, WMp[:, ii, jm1] + MLbase)

    WMv[:, ii, jjc] = torch.where(row_valid, wmv_new, WMv[:, ii, jjc])
    WMp[:, ii, jjc] = torch.where(row_valid, wmp_new, WMp[:, ii, jjc])

    # ---- WM (compute_energy_WM, s_energy_matrix.cc:219-241) --------------
    # k = j-TURN-1 .. i  ->  g = k-i in [0, s-TURN-1]
    gg = torch.arange(n2, device=dev)[:, None]
    iv = ii[None, :]
    kk = iv + gg
    ok = (gg >= 0) & (gg <= s - TURN - 1) & (iv >= 1) & (iv + s <= n)
    kkc = kk.clamp(0, n2 - 1)
    jv = (iv + s).clamp(0, n2 - 1)
    gml = (gg * MLbase).to(torch.int32)
    wm_kj = e_mlstem_diag(C, st, kk, iv + s, dangles)
    wmb_kj = P2[:, kkc, jv] + psm_b
    wm_ikm1 = torch.where(iv >= kk - 1, INF,
                          WM[:, iv.clamp(0, n2 - 1), (kk - 1).clamp(0, n2 - 1)])
    m1 = torch.where(ok, gml + wm_kj, INF).amin(dim=-2)
    m2 = torch.where(ok, gml + wmb_kj, INF).amin(dim=-2)
    m3 = torch.where(ok, wm_ikm1 + wm_kj, INF).amin(dim=-2)
    m4 = torch.where(ok, wm_ikm1 + wmb_kj, INF).amin(dim=-2)
    m5 = WM[:, ii, jm1] + MLbase
    wm_new = mmin(m1, m2, m3, m4, m5)
    WM[:, ii, jjc] = torch.where(row_valid, wm_new, WM[:, ii, jjc])


def span_wm(C, st, s, dangles, dependent=False):
    """WMv, WMp, then WM at (i, i+s) for every live row i of span s, in
    place, for every element of the batch: one ``span_wm`` launch on CUDA
    (csrc/span2d.cu), none at s < 3 (no cell is written there).  ``st``:
    the state's V, P2, WM, WMv, WMp ([B, n2, n2]); ``C`` the fill's ML
    tables of ``dangles`` with their batch axis and its scalars.
    ``dependent``: launch it as a programmatic dependent of the kernel
    before it in the stream, which may then still run while span_wm reads
    every operand; it writes its cells after that kernel has finished.
    Only for a caller that knows that kernel writes none of V, P2, WM, WMv,
    WMp and the ML tables (``fold._run_spans``: its step's last kernel is a
    ``span_store``, which writes only the step's destination views); by
    default the launch is plain.  A fill's launch table
    (:func:`span2d_fill_tables`) where ``C`` holds one for ``st``.  The
    plain version (:func:`span_wm_ref`) for CPU tensors."""
    global SPAN_WM_LAUNCHES
    ft = _fill_table(C, st, "span_wm", dangles)
    dev, names, xs = (ft.dev, (), ()) if ft else span2d_operands(C, st, "span_wm", dangles)
    if dev.type == "cpu":
        return span_wm_ref(C, st, s, dangles)
    if 3 <= s < C["n"]:
        if ft:
            ft.launch(s, dependent)
        else:
            _span2d_launch("span_wm", C, s, dangles, names, xs, dev, dependent=dependent)
        SPAN_WM_LAUNCHES += 1
    return None
