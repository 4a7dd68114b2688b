"""Lazy device->host matrix access for the traceback (PyTorch).

Counterpart of ``ccj_tpu/engine/lazy.py`` for the port's two state layouts,
the dense one of ``fold.fill6``/``fill4`` and the segment-packed one of
``fold.fill7``.  The traceback (engine/traceback.py) re-derives argmins the
way the reference's stack machine does (reference: src/W_final.cc:175-719,
src/pseudo_loop.cc:861-2820), touching O(n) cells across O(n) spans — a
vanishing fraction of the O(n^4) DP state.  Instead of copying the whole
state to the host (:func:`fold.run_fill`), :class:`LazyMats` copies the
eight 2-D matrices once and fetches one (family, span) slab of a 4-D family
on first touch, caching it.

The P-split case (pseudo_loop.cc:867-897) is the one access that scans PK
over O(n) spans at once; it runs on the state's device instead
(:meth:`LazyMats.case_p_argmin`), returning just the split indices.  Both
layouts keep PKD dense, so it reads the same array in either.  The
row-sharded state of ``dist.wavefront.fill6_sharded`` reads as the dense
one: its slabs are the shards' rows put together, and the P split gets
only the PKD cells it reads (row i, and one span of each row r in (i, l]).
The packed one of ``fill7_sharded`` reads as the packed one, each slab
asking the shards for its own rows only.
"""

from __future__ import annotations

import functools

import torch

from .common import I32, INF, SAT16
from .skew import skew_right

_TWOD = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP")


class LazyFamily:
    """Scalar-indexable view of one 4-D family held on the device."""

    def __init__(self, mats: "LazyMats", name: str):
        self._mats = mats
        self._name = name

    def __getitem__(self, idx):
        tt, ss, i, j = idx
        slab = self._mats._slab(self._name, int(ss))
        tt, i, j = int(tt), int(i), int(j)
        if tt >= slab.shape[0] or i >= slab.shape[1] or j >= slab.shape[2]:
            # beyond the stored extents: a never-written cell, which the
            # reference's Matrix4D holds at the int16 unset value
            return SAT16
        return slab[tt, i, j]


class LazyMats:
    """Mapping from matrix name to host data, fetched lazily per slab.

    ``st_device`` is the state dict a fill of ``fold`` returns.  2-D
    triangle matrices are copied at once (they are KB-sized and the
    exterior-W pass reads them densely); 4-D families come over as
    per-span slabs (``st[name][:, ss]`` in the dense layout) on first
    touch.  ``bytes_fetched`` and ``slab_fetches`` count the host-ward
    traffic (``CCJ_TRANSFER_STATS=1`` makes ``api.fold`` print them).
    """

    def __init__(self, st_device, n: int, segs=None):
        """``segs``: the segment schedule (``gapped5.segments7(n)``) when
        the state is the packed fill7 layout (family keys "name@g"); None
        for the dense layout."""
        self._dev = st_device
        self.n = n
        self._segs = segs
        self._slabs: dict = {}
        self._eager: dict = {}
        self.bytes_fetched = 0
        self.slab_fetches = 0
        for k in _TWOD:
            arr = st_device[k].cpu().numpy()
            self._eager[k] = arr
            self.bytes_fetched += arr.nbytes

    def __getitem__(self, name):
        if name in self._eager:
            return self._eager[name]
        return LazyFamily(self, name)

    def __contains__(self, name):
        return (name in self._eager or name in self._dev
                or (self._segs is not None and f"{name}@0" in self._dev))

    def _slab(self, name: str, ss: int):
        key = (name, ss)
        slab = self._slabs.get(key)
        if slab is None:
            if self._segs is None:
                slab = self._dev[name][:, ss].cpu().numpy()
            else:
                slab = self._packed_slab(name, ss)
            self._slabs[key] = slab
            self.bytes_fetched += slab.nbytes
            self.slab_fetches += 1
        return slab

    def _packed_slab(self, name: str, ss: int):
        """Span ss of ``name`` from the fill7 layouts as a [T, I, n2] host
        slab: ``name@g`` at span ``ss - lo``; the families whose canonical
        storage is dropped (gapped5.DROPPED) through the surviving layouts,
        PK through the dense PKD diagonal skew (PKD[tt, ss, i, a=j-i]) and
        PLmloop00 / PfromL through their C skews (rows ``ss - lo - 1 + i``).
        Each slab is cut to size on the device; only it comes to the host."""
        g = next(gi for gi, (lo, hi, *_r) in enumerate(self._segs)
                 if lo <= ss < hi)
        lo, _hi, TB, _IB, Lc = self._segs[g]
        n2 = self.n + 2
        if f"{name}@{g}" in self._dev:
            return self._dev[f"{name}@{g}"][:, ss - lo].cpu().numpy()
        if name == "PK":
            # slab[tt, i, j] = PKD[tt, ss, i, j - i] for j >= i
            return skew_right(self._dev["PKD"][:, ss], SAT16)[:, :, :n2] \
                .cpu().numpy()
        rows = min(Lc, n2)
        base = ss - lo - 1                                 # C row of i = 0
        a, b = max(base, 0), min(base + rows, Lc)
        c = self._dev[f"C_{name}@{g}"][:, ss - lo, a:b]    # the slab's rows only
        out = torch.full((TB, rows, n2), SAT16, dtype=c.dtype, device=c.device)
        out[:, a - base: b - base] = c
        return out.cpu().numpy()

    # ---- device-side P split (see module docstring) ----------------------
    def case_p_argmin(self, i: int, l: int):
        """argmin over the (j, d, k) cube of PK(i,j,d+1,k)+PK(j+1,d,k+1,l)
        in C (lexicographic) order — matching the reference's sequential
        strict-< scan (pseudo_loop.cc:867-897) and the numpy path in
        traceback.case_p.  Returns (j, d, k, value); (0, 0, 0, value) when
        no candidate is below INF."""
        reads = getattr(self._dev, "p_split_reads", None)
        if reads is None:
            reads = functools.partial(p_split_reads, self._dev["PKD"])
        flat, v = case_p_cube(*reads(i, l), i, l)
        self.bytes_fetched += 16
        if v >= INF:
            return 0, 0, 0, v
        m = l - i
        oj, rem = divmod(flat, m * m)
        od, ok_ = divmod(rem, m)
        return i + oj, i + od, i + ok_, v


def p_split_reads(PKD, i: int, l: int):
    """What the P-split cube of (i, l) reads of ``PKD`` ([T, S, n2, A],
    PKD[tt, span, i, a=j-i] = PK[tt, span, i, j]): row i at spans
    [0, l - i), [T, l - i, A], and each row r in (i, l] at its one span
    l - r, [T, l - i, A] (entry r - i - 1)."""
    r = torch.arange(i + 1, l + 1, device=PKD.device)
    return PKD[:, :l - i, i], PKD[:, l - r, r]


def case_p_device(PKD, i: int, l: int, n: int):
    """The P split of (i, l) on ``PKD``'s device (:func:`case_p_cube` over
    :func:`p_split_reads`)."""
    return case_p_cube(*p_split_reads(PKD, i, l), i, l)


@torch.inference_mode()
def case_p_cube(row_i, anti, i: int, l: int):
    """The masked (j, d, k) cube of the P split on the device of its PKD
    reads (:func:`p_split_reads`): PK(i, j, d+1, k) from row i at span
    k - i, PK(j+1, d, k+1, l) from row j + 1 at span l - j - 1.  Returns
    (flat index, value) as Python ints, the only data brought back.

    The cube holds the offsets j, d, k - i in [0, l - i): the same cells,
    in the same C order, as the JAX package's [n+1]^3 cube padded to a
    static shape, which torch does not need.  Ties keep the FIRST minimum
    (the smallest flat index among the cells equal to the minimum), which
    the reference's strict-< scan keeps; ``torch.argmin`` promises no tie
    rule on CUDA.  int32 throughout: out-of-cube cells hold 4*INF.
    """
    dev = row_i.device
    m = l - i
    T, M, A = row_i.shape
    ar = torch.arange(m, device=dev)
    oj = ar[:, None, None]                  # j - i
    od = ar[None, :, None]                  # d - i
    ok_ = ar[None, None, :]                 # k - i

    def pick(arr, valid, tt, span, a):
        v = arr[tt.clamp(0, T - 1), span.clamp(0, arr.shape[1] - 1),
                a.clamp(0, A - 1)].to(I32)
        return torch.where(valid, v, INF)

    # PK(i, j, d+1, k): tt = d - j - 1, span k - i, a = j - i
    f1 = pick(row_i, (od > oj) & (od < ok_), od - oj - 1, ok_, oj)
    # PK(j+1, d, k+1, l): tt = k - d - 1, entry j - i, a = d - j - 1
    f2 = pick(anti, (od >= oj + 1) & (ok_ > od) & (ok_ + 1 <= m),
              ok_ - od - 1, oj.expand(m, m, m), od - oj - 1)
    inside = (od >= oj + 1) & (ok_ >= od + 1)
    vals = torch.where(inside, f1 + f2, 4 * INF).reshape(-1)
    best = vals.min()
    idx = torch.arange(vals.numel(), device=dev)
    flat = torch.where(vals == best, idx, vals.numel()).min()
    flat, best = torch.stack([flat, best.to(flat.dtype)]).tolist()
    return flat, best
