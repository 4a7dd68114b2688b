"""Hand-written Hopper kernels of the port, with their plain PyTorch twins.

Counterpart of ``ccj_tpu/engine/pallas_ops.py``.  Its one TPU kernel,
``_minplus_kernel`` (launched by ``minplus_suffix``), is a masked min-plus
suffix reduction; the same function is the serial tt loop's k-shrink and
j-shrink reductions ``red_k`` / ``red_j`` (``ccj_tpu/engine/ttloop.py:442-455``),
13 windows per tt step.  Here it is one CUDA C++ kernel for ``sm_90a``
(``csrc/minplus.cu``, whose header notes its bound and design) that reduces
a *group* of windows in one launch: :func:`minplus_group` takes a
:class:`WindowTable`, built once per span, and the step's ``tt``, and the
port's tt loop (``ttloop.run_tt_loop``) makes one launch per step.
:func:`minplus_window` is a group of one through the same kernel.  A table
over slabs and weights with a leading batch axis reduces every element of
the batch in the same launch (output ``[B, G, I, J]``), so a batched fill
makes one launch per step for the whole batch.

Dispatch rule: a wrapper runs its plain PyTorch version only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises; it never falls
back.  The library is built with ``nvcc`` into ``build/`` beside the
package at first use and loaded with ``ctypes``.  ``LAUNCHES`` counts
kernel launches and ``WINDOWS`` the windows those launches reduced (a
batch of B counts each window B times), and nothing else, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from .common import INF

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "libccj_minplus.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_WINDOWS = 16        # csrc/minplus.cu kMaxWindows

LAUNCHES = 0            # minplus kernel launches (CUDA only)
WINDOWS = 0             # windows reduced by those launches (B per batched window)
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
    library is newer than every source (``force`` builds regardless).
    Returns (path, compiler log); the log holds ``-Xptxas -v``'s register
    and spill report of a fresh build."""
    out = BUILD_DIR / LIB_NAME
    srcs = sorted(CSRC.glob("*.cu"))
    if not force and out.exists() and all(
            out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out, proc.stdout + proc.stderr


def _library():
    global _lib
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
        raise ValueError("minplus needs every slab and w on one CUDA device "
                         f"(or all on the CPU), got {[str(t.device) for t in tensors]}")
    return dev


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
    args = (table._descs, table._strides, len(table.jobs), B, G, tt,
            out.data_ptr(), I, J, table.Q,
            torch.cuda.current_stream(table.device).cuda_stream)
    if table.device.index == torch.cuda.current_device():
        rc = table._fn(*args)
    else:   # a launch goes to the stream's own device only
        with torch.cuda.device(table.device):
            rc = table._fn(*args)
    if rc != 0:
        raise RuntimeError(f"minplus_group launch failed: cudaError {rc}")
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
