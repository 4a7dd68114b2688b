"""Shared constants and tensor helpers for the DP engine (PyTorch).

Counterpart of ``ccj_tpu/engine/common.py``; the numeric model is the same
(replicating the reference bit-for-bit):

* ``INF`` = 10^7 (ViennaRNA/params/constants.h:17)
* 4-D gap matrices are int16 with saturation at 32767, which doubles as
  their unset/infinite marker (matrices.hh:150,188-191); reads of *invalid*
  index tuples yield INF (matrices.hh:177-182)
* 2-D triangle matrices are int32, unset cells hold ``INF + 1``
  (matrices.hh:25); ``get`` on i>j yields INF (the default return_val)
* the V matrix's unset cells hold 10000 (h_struct.hh:100); its getter
  yields INF for i >= j (s_energy_matrix.hh:37)

Three differences from JAX shape how the rest of the engine is written:

* ``jax.lax.dynamic_slice`` / ``dynamic_update_slice`` clamp their start
  index to ``[0, dim - size]`` (after counting a negative start once from
  the end); torch slicing would return a short slice instead.
  :func:`dynamic_slice` and :func:`dynamic_update_slice` keep JAX's
  semantics, and every JAX call of those two on the fill's path goes
  through them.
* JAX gathers clamp out-of-range indices; torch raises (and a CUDA kernel
  asserts).  Every gather here clamps its indices first, as the JAX code
  does with ``jnp.clip``.
* Index tensors are int64 (torch's index type); value tensors are int32 as
  in JAX.  Scalar constants stay Python ints, which promote like JAX's
  weakly typed scalars.
"""

from __future__ import annotations

import torch

INF = 10_000_000
TRI_UNSET = INF + 1
V_UNSET = 10_000
SAT16 = 32767
TURN = 3
MAXLOOP = 30

I32 = torch.int32
I16 = torch.int16


def dynamic_slice(x, starts, sizes):
    """``jax.lax.dynamic_slice``: a view of ``x``.  As in JAX, a negative
    start counts once from the end (``allow_negative_indices``), then every
    start is clamped to ``[0, dim - size]``."""
    out = x
    for d, (st, sz) in enumerate(zip(starts, sizes)):
        dim = x.shape[d]
        if sz > dim:
            raise ValueError(f"slice size {sz} exceeds dim {d} of {tuple(x.shape)}")
        st = int(st)
        if st < 0:
            st += dim
        out = out.narrow(d, min(max(st, 0), dim - sz), sz)
    return out


def dynamic_update_slice(x, update, starts):
    """``jax.lax.dynamic_update_slice`` IN PLACE: writes ``update`` into ``x``
    at the starts :func:`dynamic_slice` resolves; returns ``x``."""
    dynamic_slice(x, starts, update.shape).copy_(update)
    return x


def pad_axis(x, axis, lo, hi, fill):
    """``jnp.pad`` of one axis with a constant (``lo``/``hi`` >= 0)."""
    shape = list(x.shape)
    shape[axis] = shape[axis] + lo + hi
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    out.narrow(axis, lo, x.shape[axis]).copy_(x)
    return out


def read4(M, n, tt, ss, ii, jj):
    """Matrix4D::get in [tt, s, i, j] layout.

    Coordinates: k = j + tt + 2, l = i + s.  Invalid tuples (matrices.hh:178:
    ``i<=j && j<k-1 && k<=l`` plus 1<=i, l<=n) yield INF; valid tuples yield
    the stored int16 value (32767 when unset).  Out-of-range array indices are
    clamped for the gather and masked via the validity predicate.
    """
    T, S, N2 = M.shape[0], M.shape[1], M.shape[2]
    dev = M.device
    tt, ss, ii, jj = (torch.as_tensor(x, device=dev) for x in (tt, ss, ii, jj))
    kk = jj + tt + 2
    ll = ii + ss
    valid = (ii >= 1) & (ii <= jj) & (kk <= ll) & (ll <= n) & (tt >= 0) & (ss >= 0)
    v = M[tt.clamp(0, T - 1), ss.clamp(0, S - 1),
          ii.clamp(0, N2 - 1), jj.clamp(0, N2 - 1)].to(I32)
    return torch.where(valid, v, INF)


def pack16(plane, valid):
    """Matrix4D::set with the int16 saturation clamp; invalid cells keep the
    init value 32767 (as the reference never writes them)."""
    v = plane.clamp(-32768, SAT16)
    return torch.where(valid, v, SAT16).to(I16)


def tri_get(Mraw, ii, jj):
    """TriangleMatrix::get — INF for i > j, raw cell otherwise."""
    return torch.where(ii > jj, INF, Mraw[ii, jj])


def v_get(Vraw, ii, jj):
    """s_energy_matrix::get_energy — INF for i >= j, raw cell otherwise."""
    return torch.where(ii >= jj, INF, Vraw[ii, jj])


def wx_get(Wraw, n, ii, jj, unit_cost):
    """pseudo_loop::get_WB / get_WP (pseudo_loop.cc:647-661).

    INF out of [1, n] bounds, 0 for i > j, else min(unit_cost*(j-i+1), raw).
    """
    n2 = Wraw.shape[0]
    inb = (ii >= 1) & (jj >= 1) & (ii <= n) & (jj <= n)
    raw = Wraw[ii.clamp(0, n2 - 1), jj.clamp(0, n2 - 1)]
    base = torch.minimum((unit_cost * (jj - ii + 1)).to(I32), raw)
    return torch.where(inb, torch.where(ii > jj, 0, base), INF)


def guarded_add(base, add):
    """``en = base; if (en != INF) en += add`` (E_MLStem-style guard)."""
    return torch.where(base == INF, INF, base + add)


def mmin(*xs):
    """Elementwise minimum of tensors and Python ints (at least one tensor)."""
    first = next(i for i, x in enumerate(xs) if isinstance(x, torch.Tensor))
    out = xs[first]
    for i, x in enumerate(xs):
        if i == first:
            continue
        out = torch.minimum(out, x) if isinstance(x, torch.Tensor) \
            else out.clamp(max=x)
    return out
