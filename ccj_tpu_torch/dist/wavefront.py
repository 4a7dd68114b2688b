"""Wavefront (row-sharded) fills: the DP state's row axis split over shards
that one process holds on a list of devices (PyTorch).

Counterpart of ``ccj_tpu/dist/wavefront.py`` (BASELINE config 3: one long
sequence, the O(n^4) DP state partitioned across devices): its
``fill4_sharded`` as :func:`fill6_sharded`, over the dense layout of
``fold.fill6``, and its ``fill8_sharded`` as :func:`fill7_sharded`, over
the segment-packed layout of ``fold.fill7`` (engine/gapped5.py).  The
state is a dict of ``[tt, span, i, j]`` arrays whose i axis (the l axis
for the C skews) is read only through slices and shifts, so the span body
runs per shard on the shard's own rows.  The JAX module partitions that
axis over a ``wave`` mesh axis with a GSPMD ``NamedSharding`` and lets XLA
insert the collectives; here one process holds P shards, each on a torch
device (all ``"cpu"`` in the tests, all ``cuda:0`` on a one-card machine,
``cuda:0..P-1`` with P cards), and moves rows between them explicitly
through :class:`RowTransport`.

The partition (:func:`row_partition`): the n2 = n + 2 rows padded to a
multiple of P (``pad_i`` of the JAX module), shard p holding global rows
[p R, (p + 1) R) of every array (:class:`ShardedState`).  Cut on axis -2:
the families (i rows), the C skews (l rows), PKD and PKE (i rows); a
packed array stores only its own rows (``name@g`` i < IB_g, ``C_name@g``
l in [lo_g + 1, n2)), so a shard holds those of them it owns.  Replicated
once per distinct device: the eight 2-D matrices and the tables, which
are O(n^2) and O(DS^2 n^2).

Not every cross-row read is a neighbour halo.  Per span s, a shard whose
rows are i in [i0, i0 + IB) reads:

* the fixed-offset family planes: rows i + 1 — a halo of one row; in the
  packed layout the families stored only as C skews (``gapped5.DROPPED``)
  read C rows l = i + di + u — a shift by u + di;
* the PL stencil window (in the packed layout stitched from two
  segments): rows i + d1 for d1 <= DS = 29 — a halo of 29 rows, which may
  reach several shards (R < 29 at n=30, P=4);
* ``RI``: C rows l = i + s of every earlier span (of every earlier
  segment) — a shift by s.  The owner of row l reduces its history and
  ships the reduced [B, TB, rows, n2] slab, never the history itself;
* the P split: PKD rows i + a + 1 for every a <= s - 2 — a gather of every
  row up to i + s - 1, one span slice per a;
* the C-skew write-back: rows l = i + s — a shift by s, put into the
  owners.

``RL``, the PR window, the serial tt loop and the PK write-back
(``gapped4.pk_dests``) are row-local.  The transport counts the bytes a
P-device run would move, by class, in total and per span.

Why the i axis (the JAX module's reasoning, kept): the family axis caps at
22 ways with unbalanced loads and all-to-all traffic per span; the tt axis
breaks the serial tt-descending loop across devices; pipelining the
22-family DAG pipelines a critical path.  The i axis is embarrassingly
parallel inside every reduction of a span.

Memory: all shards on one card hold the unsharded state plus halos and
gathers; one shard's figure is what each card of a P-card run would hold
(shard 0 the most in the packed layout: late segments have only low
rows).  The GSPMD sharding itself and ``fill8_sharded``'s lane-tile layout
(engine/gapped6.py) are not ported (ROADMAP, "Not to port").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..engine.common import I16, I32, INF, SAT16, dynamic_slice
from ..engine.fold import add_batch, init_state_2d
from ..engine.gapped import (C_MATS, DS, M4_NAMES, WX, _wx_tables, compute_WBP_WPP_span,
                             dims)
from ..engine import cuda_ops
from ..engine.cuda_ops import StoreDest
from ..engine.gapped4 import (SpanReads, bucket_dims, dense_rl, history_groups,
                              history_launch, pk_dests, span_families, store_span)
from ..engine.gapped5 import DROPPED, M4_STORED, packed_rl, prior_segments, window_spans
from ..engine.nested import cell_major_eint, compute_V_span, compute_WMv_WMp_WM_span

# exchange classes the transport counts ("read": the traceback and gather())
CLASSES = ("halo", "shift", "gather", "allgather", "read")
# row-sharded arrays: [B, T, S(+T+2 for PKE), R, n2]
ROW_NAMES = (*M4_NAMES, *("C_" + m for m in C_MATS), "PKD", "PKE")


def row_partition(n: int, P: int):
    """(R, [(lo, hi) per shard]): the n2 = n + 2 rows padded to P * R,
    shard p holding rows [p R, (p + 1) R)."""
    if P < 1:
        raise ValueError(f"need at least one shard, got {P}")
    R = -(-(n + 2) // P)
    return R, [(p * R, (p + 1) * R) for p in range(P)]


def span_rows(n: int, R: int, P: int, s: int):
    """[(p, i0, IB)]: the shards with a span-s row (1 <= i <= n - s) and
    the rows [i0, i0 + IB) each computes (from its first row on)."""
    out = []
    for p in range(P):
        i0 = p * R
        hi = min(i0 + R, n - s + 1)
        if hi > max(i0, 1):
            out.append((p, i0, hi - i0))
    return out


class RowTransport:
    """Moves rows of row-sharded arrays between the shards' devices.

    An array is given as one tensor per shard, its row axis last but one,
    and the global rows it stores, ``rows`` = (lo, hi) (default (0, n2)):
    shard q's tensor holds rows [max(lo, q R), min(hi, (q + 1) R)) from
    its first row on (a dense array's shard holds R rows from q R, the last
    padded past n2).  ``take`` selects the leading part a read or write
    touches (a view).  Rows outside [lo, hi) read as unset and are not
    written.  ``bytes`` counts, per class, the bytes that would cross
    between devices in a P-device run (rows a shard reads from, or writes
    to, another shard's rows); ``span_bytes`` the same per span of the
    fill (``span`` is set by the fill)."""

    def __init__(self, devices, R: int, n2: int):
        self.devices, self.R, self.n2 = devices, R, n2
        self.bytes = dict.fromkeys(CLASSES, 0)
        self.span_bytes: dict = {}
        self.span = None

    def owners(self, a: int, b: int, rows=None):
        """[(q, lo, hi)]: the shards holding rows [a, b) within the stored
        rows (default [0, n2))."""
        lo, hi = rows or (0, self.n2)
        a, b = max(a, lo), min(b, hi)
        out = []
        while a < b:
            q = a // self.R
            top = min(b, (q + 1) * self.R)
            out.append((q, a, top))
            a = top
        return out

    def _first_row(self, q: int, rows=None) -> int:
        """The global row of shard q's first local row."""
        return max(q * self.R, rows[0] if rows else 0)

    def _count(self, cls: str, t):
        nbytes = t.numel() * t.element_size()
        self.bytes[cls] += nbytes
        if self.span is not None:
            per = self.span_bytes.setdefault(self.span, dict.fromkeys(CLASSES, 0))
            per[cls] += nbytes

    def fetch(self, p: int, arrs, take, a: int, b: int, cls: str, fill=SAT16,
              rows=None):
        """Rows [a, b) of ``take(arrs[q])`` over the owning shards q, on
        shard p's device; a view when p owns them all."""
        pieces = self.owners(a, b, rows)
        if len(pieces) == 1 and pieces[0] == (p, a, b):
            return take(arrs[p]).narrow(-2, a - self._first_row(p, rows), b - a)
        dev = self.devices[p]
        ref = take(arrs[p])

        def unset(k):
            return torch.full((*ref.shape[:-2], k, ref.shape[-1]), fill,
                              dtype=ref.dtype, device=dev)

        parts, cur = [], a
        for q, lo, hi in pieces:
            if lo > cur:
                parts.append(unset(lo - cur))
            t = take(arrs[q]).narrow(-2, lo - self._first_row(q, rows), hi - lo)
            if q != p:
                self._count(cls, t)
                t = t.to(dev)
            parts.append(t)
            cur = hi
        if b > cur:
            parts.append(unset(b - cur))
        return torch.cat(parts, dim=-2)

    def pieces(self, p: int, arrs, take, a: int, b: int, cls: str, rows=None):
        """[(tensor, first global row)]: rows [a, b) of ``take(arrs[q])``
        over the owning shards q, each on shard p's device without joining
        them (shard p's own rows a view, another shard's moved and
        counted); rows no shard stores are in none."""
        out = []
        for q, lo, hi in self.owners(a, b, rows):
            t = take(arrs[q]).narrow(-2, lo - self._first_row(q, rows), hi - lo)
            if q != p:
                self._count(cls, t)
                t = t.to(self.devices[p])
            out.append((t, lo))
        return out

    def put(self, p: int, arrs, take, a: int, slab, cls: str, rows=None):
        """Write shard p's ``slab`` into rows [a, a + rows) of
        ``take(arrs[q])`` on the owning shards q (rows outside the stored
        ones are dropped)."""
        for q, lo, hi in self.owners(a, a + slab.shape[-2], rows):
            src = slab.narrow(-2, lo - a, hi - lo)
            if q != p:
                self._count(cls, src)
            take(arrs[q]).narrow(-2, lo - self._first_row(q, rows), hi - lo).copy_(src)

    def move(self, t, p: int, q: int, cls: str):
        """``t`` (on shard p's device) on shard q's device."""
        if p != q:
            self._count(cls, t)
        return t.to(self.devices[q])

    def allgather(self, pieces, devices):
        """{device: int32 [B, n2]} from ``pieces`` {p: (i0, [B, rows])}:
        each shard's rows, INF elsewhere; every shard receives the others'
        rows."""
        for _i0, v in pieces.values():
            for _ in range(len(self.devices) - 1):
                self._count("allgather", v)
        out = {}
        B = next(iter(pieces.values()))[1].shape[0]
        for dev in devices:
            full = torch.full((B, self.n2), INF, dtype=I32, device=dev)
            for i0, v in pieces.values():
                full[:, i0:i0 + v.shape[-1]] = v.to(dev)
            out[dev] = full
        return out


class Rows(NamedTuple):
    """Where a row-sharded array lies on the global row axis: row r of the
    unsharded array is global row ``off + r`` (``nrows`` rows); the shards
    store the global rows [lo, hi), and the others read as unset."""
    off: int
    nrows: int
    lo: int
    hi: int


class ShardedArray:
    """One row-sharded array of a :class:`ShardedState`, as ``LazyMats``
    reads it: an index of the leading (tt, span) axes, with an optional
    third entry slicing the rows (in the unsharded array's own row
    coordinate; all rows without it), gives those rows of every shard put
    together on the first device.  The column axis is never indexed."""

    def __init__(self, state: "ShardedState", name: str):
        self._state, self._name = state, name

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        rsl = idx[2] if len(idx) > 2 else slice(None)
        a, b, step = rsl.indices(self._state.layout[self._name].nrows)
        if step != 1 or len(idx) > 3:
            raise IndexError(f"a sharded array takes (tt, span, row slice), got {idx!r}")
        return self._state.rows(self._name, a, b, idx[:2])


class ShardedState:
    """A fill's state split by rows over ``devices`` (one shard each): the
    dense layout of ``fold.fill6``, or with ``segs`` (``gapped5.segments7``)
    the segment-packed layout of ``fold.fill7``.

    Every array is cut by one global row partition (:func:`row_partition`):
    shard p holds the global rows [p R, (p + 1) R) of it that the array
    stores (``layout``, a :class:`Rows` per name).  A family row is its i
    and a C-skew row its l; a packed ``name@g`` block stores the rows
    i < IB_g, a packed ``C_name@g`` skew the rows l in [lo_g + 1, n2)
    (its row r is l = r + lo_g + 1; the rows l >= n2 are written only from
    invalid i rows and hold the unset value, so no shard stores them).
    The dense arrays (all of the dense layout, PKD and PKE of the packed
    one) hold R rows a shard, the last padded past n2.

    ``shards[p]`` holds the row-sharded arrays (batch axis 1) and, by
    reference, its device's replica of the 2-D matrices (``replicas``, one
    per distinct device).  As a mapping it reads like the plain state of
    ``fold.fill6`` / ``fill7`` for ``lazy.LazyMats``: a 2-D name gives the
    first device's replica, a sharded name a :class:`ShardedArray`;
    :meth:`rows` gives a row range, :meth:`p_split_reads` what the
    traceback's P split reads of PKD, :meth:`gather` the whole plain
    dict."""

    def __init__(self, n: int, devices, segs=None):
        self.n, self.n2 = n, n + 2
        self.segs = segs
        self.devices = [torch.device(d) for d in devices]
        self.P = len(self.devices)
        self.R, _ = row_partition(n, self.P)
        n2, T, S, U = dims(n)
        self.replicas = {dev: init_state_2d(n, dev)
                         for dev in dict.fromkeys(self.devices)}
        # a fill's tables' dict by device (set by the fill): each holds its
        # replica's kept weight tables (gapped.WX)
        self.consts = {}
        dense = Rows(0, n2, 0, n2)
        # name -> (leading axes, rows, whether every shard holds R rows)
        arrays = {}
        if segs is None:
            arrays.update({name: ((T, S), dense, True) for name in ROW_NAMES[:-1]})
        else:
            for g, (lo, hi, TB, IB, Lc) in enumerate(segs):
                for m in M4_STORED:
                    arrays[f"{m}@{g}"] = ((TB, hi - lo), Rows(0, IB, 0, IB), False)
                for m in C_MATS:
                    arrays[f"C_{m}@{g}"] = ((TB, hi - lo), Rows(
                        lo + 1, Lc, lo + 1, min(lo + 1 + Lc, n2)), False)
            arrays["PKD"] = ((T, S), dense, True)
        arrays["PKE"] = ((T, S + T + 2), dense, True)
        self.layout = {name: r for name, (_, r, _) in arrays.items()}
        self.row_names = tuple(arrays)
        self.shards = []
        for q, dev in enumerate(self.devices):
            sh = {}
            for name, (lead, r, padded) in arrays.items():
                rows = self.R if padded else max(
                    0, min((q + 1) * self.R, r.hi) - max(q * self.R, r.lo))
                sh[name] = torch.full((1, *lead, rows, n2), SAT16, dtype=I16,
                                      device=dev)
            sh.update(self.replicas[dev])
            self.shards.append(sh)
        self.transport = RowTransport(self.devices, self.R, n2)

    def keys(self):
        return [*self.replicas[self.devices[0]], *self.row_names]

    def __contains__(self, name):
        return name in self.layout or name in self.replicas[self.devices[0]]

    def __getitem__(self, name):
        if name in self.layout:
            return ShardedArray(self, name)
        return self.replicas[self.devices[0]][name][0]

    def fetch(self, p: int, name: str, take, a: int, b: int, cls: str):
        """Global rows [a, b) of ``take`` of every shard's ``name``, on
        shard p's device (:meth:`RowTransport.fetch`)."""
        r = self.layout[name]
        return self.transport.fetch(p, [sh[name] for sh in self.shards], take,
                                    a, b, cls, rows=(r.lo, r.hi))

    def pieces(self, p: int, name: str, take, a: int, b: int, cls: str):
        """Global rows [a, b) of ``take`` of every shard's ``name`` as pieces
        on shard p's device (:meth:`RowTransport.pieces`)."""
        r = self.layout[name]
        return self.transport.pieces(p, [sh[name] for sh in self.shards], take, a, b, cls,
                                     rows=(r.lo, r.hi))

    def own(self, p: int, name: str, take, a: int, b: int):
        """Global rows [a, b) of ``take(shards[p][name])``, all shard p's
        own: a view."""
        r = self.layout[name]
        first = self.transport._first_row(p, (r.lo, r.hi))
        return take(self.shards[p][name]).narrow(-2, a - first, b - a)

    def put(self, p: int, name: str, take, a: int, slab, cls: str):
        """Shard p's ``slab`` into global rows [a, a + rows) of ``name``
        (:meth:`RowTransport.put`)."""
        r = self.layout[name]
        self.transport.put(p, [sh[name] for sh in self.shards], take, a, slab,
                           cls, rows=(r.lo, r.hi))

    def rows(self, name: str, a: int = 0, b: int | None = None, lead=()):
        """Rows [a, b) (default: all) of a sharded array, in the unsharded
        array's own row coordinate, on the first device; the batch axis
        dropped and ``lead`` indexing the leading axes."""
        r = self.layout[name]
        b = r.nrows if b is None else b
        return self.fetch(0, name, lambda t: t[0][lead], r.off + a, r.off + b, "read")

    def p_split_reads(self, i: int, l: int):
        """``lazy.p_split_reads`` of the sharded PKD, on the first device:
        row i at spans [0, l - i) from its owner, and each row r in (i, l]
        at its one span l - r from r's owner; nothing else moves."""
        tr, R = self.transport, self.R
        arrs = [sh["PKD"] for sh in self.shards]
        row_i = tr.fetch(0, arrs, lambda t: t[0, :, :l - i], i, i + 1,
                         "read")[..., 0, :]
        anti = []
        for q, lo, hi in tr.owners(i + 1, l + 1):
            r = torch.arange(lo, hi, device=self.devices[q])
            anti.append(tr.move(arrs[q][0][:, l - r, r - q * R], q, 0, "read"))
        return row_i, torch.cat(anti, dim=1)

    def gather(self, device=None):
        """The plain state dict of ``fold.fill6`` (``fill7`` for a packed
        state) on ``device`` (default: the first shard's)."""
        dev = self.devices[0] if device is None else torch.device(device)
        out = {k: v[0].to(dev) for k, v in self.replicas[self.devices[0]].items()}
        for name in self.row_names:
            out[name] = self.rows(name).to(dev)
        return out

    def shard_bytes(self, p: int) -> int:
        """Bytes of shard p's row-sharded arrays (its replica apart)."""
        return sum(self.shards[p][k].nbytes for k in self.row_names)

    def replica_bytes(self) -> int:
        """Bytes of one replica of the 2-D matrices."""
        return sum(v.nbytes for v in self.replicas[self.devices[0]].values())


def _history_tables(st: ShardedState, p: int, W):
    """``q -> the weight tables on shard q's device``: ``W`` (shard p's) on
    p's own device, else the fill's kept tables of that device's replica
    (``gapped.WX`` in ``st.consts``), so an owner's RI launch takes its
    weights from its own copy of X and nothing travels."""
    cache = {st.devices[p]: W}

    def on(q):
        dev = st.devices[q]
        if dev not in cache:
            WB, WP, WBPg, _ = st.consts[dev][WX]
            cache[dev] = {"WBt": WB, "WBPg": WBPg, "WPt": WP}
        return cache[dev]
    return on


def _sharded_history(st: ShardedState, p: int, s: int, TB: int, IB: int, rl, ri_windows):
    """``SpanReads.history`` of shard p's rows [i0, i0 + IB): one launch for
    the RL windows (``rl``: row-local, ``family -> parts``) on p's device;
    the RI windows' C rows l = i + s reduced on their owners, one launch
    per owner q of rows [a, b) (``ri_windows(q, a, b)``: ``family ->
    parts`` over q's own rows, weights from q's own tables), the int32
    result shipped to p (class ``shift``); rows with l >= n2, and every row
    at span 0 (no history), are INF and move nothing."""
    tr, i0, dev = st.transport, p * st.R, st.devices[p]
    n2 = st.n + 2

    def history(W):
        keys, out = history_launch(history_groups(cuda_ops.RL), lambda m, f: rl(f), W, s,
                                   i0, TB, IB)
        got = dict(zip(keys, out))
        tables = _history_tables(st, p, W)
        groups = history_groups(cuda_ops.RI)
        keys = [key for *_g, outs in groups for _t, key in outs]
        B = W["WBt"].shape[0]
        ri = torch.full((len(keys), B, TB, IB, n2), INF, dtype=I32, device=dev)
        for q, a, b in tr.owners(i0 + s, i0 + s + IB) if s >= 1 else ():
            fam = ri_windows(q, a, b)
            _, red = history_launch(groups, lambda m, f: fam(f), tables(q), s, a - s, TB,
                                    b - a)
            ri[:, :, :, a - i0 - s: b - i0 - s] = tr.move(red, q, p, "shift")
        got.update(zip(keys, ri))
        return got

    return history


def sharded_reads(st: ShardedState, p: int, s: int, TB: int, IB: int) -> SpanReads:
    """:class:`gapped4.SpanReads` of shard p's rows [p R, p R + IB) at span
    s of a dense state: ``parts`` gives its own rows in place and the halo
    row of the next shard as a second piece (moved only from another
    device: no joined copy), ``window`` fetches its DS-row halo (a joined
    copy where it crosses shards, a view where shard p owns it); the
    history scans take the dense layout's row-local RL windows and reduce
    each C row's RI history on its owner, with the weights of the owner's
    device (``st.consts``)."""
    n = st.n
    n2, T, S, U = dims(n)
    sh, R = st.shards[p], st.R
    i0 = p * R

    def parts(name, c, b, di):
        """The family at span max(s - b, 0), rows i0 + di on: shard p's own
        rows a view, the halo row of the next shard as its own piece
        (moved, class ``halo``); rows past n2 are in no piece."""
        return [(t, c, i0 + di - lo) for t, lo in st.pieces(
            p, name, lambda t: t.select(2, max(s - b, 0)), i0 + di, i0 + di + IB, "halo")]

    sp0 = max(s - TB, 0)

    def ri_windows(q, a, b):
        """C rows [a, b) of the TB spans below s, on their owner q."""
        return lambda fam: [(dynamic_slice(st.shards[q]["C_" + fam],
                                           (0, sp0, a - q * R, 0), (TB, TB, b - a, n2)),
                             s - sp0)]

    def window(name, halo=DS):
        """The stencil window (``gapped4.SpanReads``): the spans
        max(s - DS, 0) .. s - 1 of rows [i0, i0 + IB + halo), fetched as a
        halo (a view where shard p owns them all), unset past n2."""
        lo = max(s - DS, 0)
        return [(st.fetch(p, name, lambda t: t.narrow(2, lo, s - lo),
                          i0, i0 + IB + halo, "halo"), lo)]

    history = _sharded_history(st, p, s, TB, IB, dense_rl(sh, s, TB, IB), ri_windows)
    return SpanReads(parts, history, window)


def sharded_packed_reads(st: ShardedState, p: int, s: int, gi: int, SEGS,
                         IB: int) -> SpanReads:
    """:class:`gapped4.SpanReads` of shard p's rows [p R, p R + IB) at span
    s of segment gi of a packed state, reader by reader
    ``gapped5.packed_reads``' own over the transport: a family plane's
    rows i + di (a one-row halo) and a ``DROPPED`` family's C rows
    l = i + di + u (a shift) as one piece per owner, in place on shard p's
    device; the history scans take the row-local RL windows
    (``gapped5.packed_rl``) and reduce each C row's RI history over every
    prior segment on its owner; the stencil window, stitched from segments
    gi - 1 and gi, fetches a DS-row halo.  Rows a segment does not store
    read as unset, as they do unsharded."""
    lo, _hi, TB, _IB, _Lc = SEGS[gi]
    sh = st.shards[p]
    i0 = p * st.R

    def seg_of(u):
        """gapped5.packed_reads' segment of a fixed-offset read at span u."""
        return gi if gi == 0 or u >= lo else gi - 1

    def parts(name, c, b, di):
        """name[tt+c, u=s-b, i+di, j] from the segment of u: a family's
        rows i + di (halo), a ``DROPPED`` family's C rows l = i + di + u
        (shift), each owner's rows a piece (shard p's own a view)."""
        u = s - b
        h = seg_of(u)
        loh, hih = SEGS[h][:2]
        span = min(max(u - loh, 0), hih - loh - 1)
        if name in DROPPED:
            key, r0, cls = f"C_{name}@{h}", i0 + di + u, "shift"
        else:
            key, r0, cls = f"{name}@{h}", i0 + di, "halo"
        return [(t, c, r0 - lo) for t, lo in st.pieces(
            p, key, lambda t: t.select(2, span), r0, r0 + IB, cls)]

    hist = prior_segments(SEGS, gi, s)

    def ri_windows(q, a, b):
        """C rows [a, b) of every prior segment's spans below s, on their
        owner q (its own rows: a view)."""
        return lambda fam: [(st.fetch(q, f"C_{fam}@{h}", lambda t, m=nsh: t.narrow(2, 0, m),
                                      a, b, "shift"), s - loh)
                            for h, loh, nsh in hist]

    def window(name, halo=DS):
        """The stencil window (``gapped4.SpanReads``): the spans of
        segments gi - 1 and gi that ``gapped5.window_spans`` names, rows
        [i0, i0 + IB + halo) of each fetched as a halo (a view where shard
        p owns them all), unset past the segment's rows."""
        return [(st.fetch(p, f"{name}@{h}",
                          lambda t, x=a - SEGS[h][0], y=b - SEGS[h][0]: t[:, :, x:y],
                          i0, i0 + IB + halo, "halo"), a)
                for h, a, b in window_spans(s, gi, SEGS)]

    history = _sharded_history(st, p, s, TB, IB, packed_rl(sh, s, gi, SEGS, IB),
                               ri_windows)
    return SpanReads(parts, history, window)


def resolve_devices(devices=None):
    """The shards' devices: ``devices`` as given, else one shard per card
    (``cuda:0``, ``cuda:1``, ...); raises without CUDA."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the sharded fills run on CUDA devices by default and none is "
                "available; pass devices=['cpu', ...] to run on the CPU")
        devices = [f"cuda:{p}" for p in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a sharded fill needs at least one device")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("a CUDA shard was asked for and CUDA is not available")
    return devices


def _on(tables, dev):
    return add_batch({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for k, v in tables.items()})


def _write_back(st: ShardedState, p: int, s: int, res, gi=None):
    """Shard p's span-s result (``gapped4.SpanResult``) into the state,
    in one ``cuda_ops.span_store``: the families and PKD / PKE into its
    own rows, the C-skew rows l = i + s it owns; the C rows another shard
    owns into a staging slab, then into their owners (class ``shift``).
    ``gi`` is the span's segment in a packed state (None: dense), whose C
    skews drop the invalid i = 0 row, as ``gapped5.span_gapped7`` does."""
    sh, i0 = st.shards[p], p * st.R
    TB, IB = res.TB, res.IB
    if gi is None:
        names, sfx, u = M4_NAMES, "", s
    else:
        names, sfx, u = M4_STORED, f"@{gi}", s - st.segs[gi][0]

    def at_span(t):
        return t.narrow(1, 0, TB).select(2, u)

    dests = [StoreDest(name, at_span(sh[name + sfx]).narrow(-2, 0, IB)) for name in names]
    remote = []
    first = 1 if gi is not None and i0 == 0 else 0     # the slab row of l0
    l0 = i0 + s + first
    for name in C_MATS:
        key = f"C_{name}{sfx}"
        r = st.layout[key]
        staging = None
        for q, lo, hi in st.transport.owners(l0, l0 + IB - first, (r.lo, r.hi)):
            if q == p:
                dests.append(StoreDest(name, st.own(p, key, at_span, lo, hi), lo - l0 + first))
                continue
            if staging is None:
                staging = torch.empty((sh["PKD"].shape[0], TB, IB, st.n2), dtype=I16,
                                      device=st.devices[p])
                dests.append(StoreDest(name, staging))
            remote.append((key, lo, staging.narrow(-2, lo - l0 + first, hi - lo)))
    store_span(res, dests + pk_dests(sh, s, st.n))
    for key, lo, slab in remote:
        st.put(p, key, at_span, lo, slab, "shift")


def _spans(st: ShardedState):
    """(s, TB, gi) per span in fill order: its tt extent and, in a packed
    state, its segment (None in a dense one)."""
    if st.segs is None:
        return ((s, bucket_dims(st.n, s)[0], None) for s in range(st.n))
    return ((s, TB, gi) for gi, (lo, hi, TB, *_r) in enumerate(st.segs)
            for s in range(lo, hi))


def _fill_sharded(C, SC4, dangles: int, st: ShardedState) -> ShardedState:
    """The span loop of both sharded fills, on ``st`` in place.  Per span:
    the 2-D recurrences on every replica; the P split on each shard's
    rows, all-gathered into every replica, whose WBP/WPP update writes it
    into P's diagonal; the gapped step on each shard with a span-s row
    (``gapped4.span_families`` over the layout's sharded reads with its row
    offset, one ``tt_span`` launch per span and shard on CUDA); then the
    write-back.  Each device's tables (``st.consts``) hold EINT cell-major,
    as the unsharded fills do, and its replica's own weight tables
    (``gapped.WX``), made once here and kept current by its WBP/WPP update,
    and its 2-D kernels' launch tables on its replica, packed once
    (``cuda_ops.span2d_fill_tables``); from the second span on ``span_v`` is
    a programmatic dependent launch, as in ``fold._run_spans``.  ``span_wm``
    is launched plainly: the last op before it on a device may be a
    transport copy of a staging slab (``_write_back``), not a
    ``span_store``."""
    n, tr = st.n, st.transport
    n2, T, S, U = dims(n)
    Cd = st.consts = {dev: cell_major_eint({**_on(C, dev), "n": n}) for dev in st.replicas}
    for dev, rep in st.replicas.items():
        Cd[dev][WX] = _wx_tables(Cd[dev], rep)
        Cd[dev][cuda_ops.SPAN2D_FILL] = cuda_ops.span2d_fill_tables(Cd[dev], rep, dangles)
    SC4d = {dev: _on(SC4, dev) for dev in st.replicas}
    for k, (s, TB, gi) in enumerate(_spans(st)):
        tr.span = s
        for dev, rep in st.replicas.items():
            compute_V_span(Cd[dev], rep, s, dangles, dependent=k > 0)
        active = span_rows(n, st.R, st.P, s)
        pieces = {}
        for p, i0, IB in active:
            dev = st.devices[p]

            # factor 2's PKD rows i + a + 1 at span s - a - 1 for every a,
            # fetched from their owners into one operand
            pkd = torch.empty((st.shards[p]["PKD"].shape[0], max(s - 1, 1), T, IB, n2),
                              dtype=I16, device=dev)
            for a in range(s - 1):
                pkd[:, a] = st.fetch(p, "PKD", lambda t, u=s - a - 1: t.select(2, u),
                                     i0 + a + 1, i0 + a + 1 + IB, "gather")
            pieces[p] = (i0, cuda_ops.p_split(st.shards[p]["PKE"], pkd, s=s, n=n, i0=i0,
                                              R=IB, sp=(0, 1), ro=(0, 0)))
        for dev, p_min in tr.allgather(pieces, st.replicas).items():
            compute_WBP_WPP_span(Cd[dev], st.replicas[dev], s, p_min if s >= 3 else None)
        # every shard's reads of the span come before any write-back
        packed = {}
        for p, i0, IB in active:
            dev = st.devices[p]
            reads = (sharded_reads(st, p, s, TB, IB) if gi is None else
                     sharded_packed_reads(st, p, s, gi, st.segs, IB))
            packed[p] = span_families(Cd[dev], SC4d[dev], st.shards[p], s, TB, IB,
                                      reads, i0)
        for p, slabs in packed.items():
            _write_back(st, p, s, slabs, gi)
        for dev, rep in st.replicas.items():
            compute_WMv_WMp_WM_span(Cd[dev], rep, s, dangles)
    tr.span = None
    return st


@torch.inference_mode()
def fill6_sharded(C, SC4, n: int, dangles: int, devices=None) -> ShardedState:
    """The dense fill (``fold.fill6``) with the rows split over shards.

    ``C`` / ``SC4``: ``fold.consts_from_numpy``'s tables (copied to every
    shard's device).  ``devices``: one torch device per shard (P shards on
    one card: ``["cuda:0"] * P``); without it, one shard per card, raising
    without CUDA.  Returns the :class:`ShardedState`; its ``gather()``
    equals ``fill6``'s state bit for bit."""
    return _fill_sharded(C, SC4, dangles, ShardedState(n, resolve_devices(devices)))


@torch.inference_mode()
def fill7_sharded(C, SC4, n: int, dangles: int, SEGS, devices=None) -> ShardedState:
    """The segment-packed fill (``fold.fill7``, ``SEGS`` =
    ``gapped5.segments7(n)``) with the rows split over shards: the
    counterpart of the JAX package's ``fill8_sharded``, with ``devices``
    (as :func:`fill6_sharded` takes them) in place of its mesh.  Returns
    the packed :class:`ShardedState`; its ``gather()`` equals ``fill7``'s
    state bit for bit, and ``LazyMats(st, n, segs=SEGS)`` reads it as it
    is."""
    return _fill_sharded(C, SC4, dangles,
                         ShardedState(n, resolve_devices(devices), SEGS))
