"""Hand-written Hopper kernels of the port, with their plain PyTorch twins.

Counterpart of ``ccj_tpu/engine/pallas_ops.py``.  Its one TPU kernel,
``_minplus_kernel`` (launched by ``minplus_suffix``), is a masked min-plus
suffix reduction; the same function is the serial tt loop's k-shrink and
j-shrink reductions ``red_k`` / ``red_j`` (``ccj_tpu/engine/ttloop.py:442-455``),
13 calls per tt step.  Here it is :func:`minplus_window`, a CUDA C++ kernel
for ``sm_90a`` (``csrc/minplus.cu``, whose header notes its bound and
design), and the port's tt loop (``ttloop.run_tt_loop``) runs all 13
reductions through it.

Dispatch rule: a wrapper runs its plain PyTorch version only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises; it never falls
back.  The library is built with ``nvcc`` into ``build/`` beside the
package at first use and loaded with ``ctypes``.  ``LAUNCHES`` counts
kernel launches (and nothing else), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .common import INF

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_NAME = "libccj_minplus.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES = 0            # minplus_window kernel launches (CUDA only)

_lib = None
_lib_lock = threading.Lock()


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
            fn = lib.ccj_minplus_window
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3
                           + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                           + [ctypes.c_void_p] + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_window(slab, w, row0, col0, q_lo, mode):
    if slab.dim() != 3 or w.dim() != 2:
        raise ValueError(f"slab must be 3-D and w 2-D, got {tuple(slab.shape)}, "
                         f"{tuple(w.shape)}")
    if slab.dtype != torch.int32 or w.dtype != torch.int32:
        raise TypeError(f"slab and w must be int32, got {slab.dtype}, {w.dtype}")
    Q, J = w.shape
    R, _, C = slab.shape
    if not (0 <= row0 and row0 + Q <= R and 0 <= col0 and col0 + J <= C):
        raise ValueError(f"window rows [{row0}, {row0 + Q}) x cols "
                         f"[{col0}, {col0 + J}) leaves slab {tuple(slab.shape)}")
    if q_lo < 0 or mode not in (0, 1, 2):
        raise ValueError(f"bad q_lo={q_lo} or mode={mode}")


def minplus_window_ref(slab, w, row0, col0=0, q_lo=0, mode=0, c=0):
    """Plain PyTorch version of :func:`minplus_window` (same arguments)."""
    Q, J = w.shape
    I = slab.shape[1]
    if q_lo >= Q:
        return torch.full((I, J), INF, dtype=torch.int32, device=slab.device)
    dev = slab.device
    q = torch.arange(Q, device=dev)[:, None, None]
    i = torch.arange(I, device=dev)[None, :, None]
    j = torch.arange(J, device=dev)[None, None, :]
    keep = q >= q_lo
    if mode == 1:
        keep = keep & (q <= c - j + i)
    elif mode == 2:
        keep = keep & (q <= j - i - c)
    vals = slab[row0:row0 + Q, :, col0:col0 + J] + w[:, None, :]
    return torch.where(keep, vals, INF).amin(dim=0).clamp(max=INF)


def minplus_window(slab, w, row0, col0=0, q_lo=0, mode=0, c=0):
    """out[i, j] = min over q in [q_lo, Q) with mask(q, i, j) of
    slab[row0 + q, i, col0 + j] + w[q, j]; INF when no term survives.

    slab: [R, I, C] int32 and w: [Q, J] int32, INF-encoded, read in place
    through their strides (any views).  ``mode`` 0: no mask; 1:
    ``q <= c - j + i`` (red_k's k1 bound, c = s - 4 - tt); 2:
    ``q <= j - i - c`` (red_j's j1 bound, c = 2).  Raises when the window
    leaves the slab.  Returns a new [I, J] int32 tensor.
    """
    _check_window(slab, w, row0, col0, q_lo, mode)
    if slab.device.type == "cpu" and w.device.type == "cpu":
        return minplus_window_ref(slab, w, row0, col0, q_lo, mode, c)
    return _minplus_window_cuda(slab, w, row0, col0, q_lo, mode, c)


def _minplus_window_cuda(slab, w, row0, col0, q_lo, mode, c):
    global LAUNCHES
    if not (slab.is_cuda and w.is_cuda and slab.device == w.device):
        raise ValueError(f"minplus_window needs slab and w on one CUDA device "
                         f"(or both on the CPU), got {slab.device}, {w.device}")
    fn = _library().ccj_minplus_window
    Q, J = w.shape
    I = slab.shape[1]
    out = torch.empty((I, J), dtype=torch.int32, device=slab.device)
    ss, ws = slab.stride(), w.stride()
    rc = fn(slab.data_ptr(), ss[0], ss[1], ss[2], w.data_ptr(), ws[0], ws[1],
            out.data_ptr(), I, J, Q, row0, col0, q_lo, mode, c,
            torch.cuda.current_stream(slab.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"minplus_window launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def minplus_suffix_ref(slab, w, lo):
    """Plain form of :func:`minplus_suffix`."""
    return minplus_window_ref(slab, w, 0, 0, max(int(lo) + 1, 0))


def minplus_suffix(slab, w, lo):
    """out[i, j] = min over tp > lo of slab[tp, i, j] + w[tp, j], INF when
    no row survives — ``pallas_ops.minplus_suffix``'s function."""
    return minplus_window(slab, w, 0, 0, max(int(lo) + 1, 0))
