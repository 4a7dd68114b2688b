"""Wavefront (row-sharded) dense fill: the DP state's row axis split over
shards that one process holds on a list of devices (PyTorch).

Counterpart of ``ccj_tpu/dist/wavefront.py``'s ``fill4_sharded`` (BASELINE
config 3: one long sequence, the O(n^4) DP state partitioned across
devices).  The dense state is a dict of ``[tt, span, i, j]`` arrays whose i
axis (the l axis for the C skews) is read only through slices and shifts,
so the span body runs per shard on the shard's own rows.  The JAX module
partitions that axis over a ``wave`` mesh axis with a GSPMD
``NamedSharding`` and lets XLA insert the collectives; here one process
holds P shards, each on a torch device (all ``"cpu"`` in the tests, all
``cuda:0`` on a one-card machine, ``cuda:0..P-1`` with P cards), and moves
rows between them explicitly through :class:`RowTransport`.

The partition (:func:`row_partition`): the n2 = n + 2 rows padded to a
multiple of P (``pad_i`` of the JAX module), shard p holding rows
[p R, (p + 1) R).  Cut on axis -2: the 22 families (i rows), the five C
skews (l rows), PKD and PKE (i rows).  Replicated once per distinct
device: the eight 2-D matrices and the tables, which are O(n^2) and
O(DS^2 n^2).

Not every cross-row read is a neighbour halo.  Per span s, a shard whose
rows are i in [i0, i0 + IB) reads:

* ``plane(.., di)`` (``gapped4.dense_reads``' counterpart): rows i + 1 — a halo of one
  row;
* the PL stencil window: rows i + d1 for d1 <= DS = 29 — a halo of 29
  rows, which may reach several shards (R < 29 at n=30, P=4);
* ``RI``: C rows l = i + s of every earlier span — a shift by s.  The
  owner of row l reduces its history and ships the reduced
  [B, TB, rows, n2] slab, never the history itself;
* the P split: PKD rows i + a + 1 for every a <= s - 2 — a gather of every
  row up to i + s - 1, one span slice per a;
* the C-skew write-back: rows l = i + s — a shift by s, put into the
  owners.

``RL``, the PR window, the serial tt loop and ``update_pk_skews4`` are
row-local.  The transport counts the bytes a P-device run would move, by
class, in total and per span.

Why the i axis (the JAX module's reasoning, kept): the family axis caps at
22 ways with unbalanced loads and all-to-all traffic per span; the tt axis
breaks the serial tt-descending loop across devices; pipelining the
22-family DAG pipelines a critical path.  The i axis is embarrassingly
parallel inside every reduction of a span.

Memory: all shards on one card hold the unsharded state plus halos and
gathers; one shard's figure is what each card of a P-card run would hold.
The GSPMD sharding itself and ``fill8_sharded``'s lane-tile layout are not
ported (ROADMAP, "Not to port"); the packed layout's sharding is the next
step on the same transport.
"""

from __future__ import annotations

import torch

from ..engine.common import I16, I32, INF, SAT16, dynamic_slice, pad_axis
from ..engine.fold import add_batch, init_state_2d
from ..engine.gapped import C_MATS, DS, M4_NAMES, _set_P_diag, compute_WBP_WPP_span, dims
from ..engine.gapped3 import p_split_rows
from ..engine.gapped4 import (SpanReads, bucket_dims, dense_rl, g2, ri_min,
                              span_families, update_pk_skews4)
from ..engine.nested import compute_V_span, compute_WMv_WMp_WM_span

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

    An array is given as one tensor per shard, its row axis last but one;
    ``take`` selects the leading part a read or write touches (a view).
    Rows past the n2 real ones read as unset.  ``bytes`` counts, per class,
    the bytes that would cross between devices in a P-device run (rows a
    shard reads from, or writes to, another shard's rows); ``span_bytes``
    the same per span of the fill (``span`` is set by the fill)."""

    def __init__(self, devices, R: int, n2: int):
        self.devices, self.R, self.n2 = devices, R, n2
        self.bytes = dict.fromkeys(CLASSES, 0)
        self.span_bytes: dict = {}
        self.span = None

    def owners(self, a: int, b: int):
        """[(q, lo, hi)]: the shards holding rows [a, b) within [0, n2)."""
        a, b = max(a, 0), min(b, self.n2)
        out = []
        while a < b:
            q = a // self.R
            hi = min(b, (q + 1) * self.R)
            out.append((q, a, hi))
            a = hi
        return out

    def _count(self, cls: str, t):
        nbytes = t.numel() * t.element_size()
        self.bytes[cls] += nbytes
        if self.span is not None:
            per = self.span_bytes.setdefault(self.span, dict.fromkeys(CLASSES, 0))
            per[cls] += nbytes

    def fetch(self, p: int, arrs, take, a: int, b: int, cls: str, fill=SAT16):
        """Rows [a, b) of ``take(arrs[q])`` over the owning shards q, on
        shard p's device; a view when p owns them all."""
        R = self.R
        pieces = self.owners(a, b)
        if len(pieces) == 1 and pieces[0] == (p, a, b):
            return take(arrs[p]).narrow(-2, a - p * R, b - a)
        dev = self.devices[p]
        ref = take(arrs[p])

        def unset(k):
            return torch.full((*ref.shape[:-2], k, ref.shape[-1]), fill,
                              dtype=ref.dtype, device=dev)

        parts, cur = [], a
        for q, lo, hi in pieces:
            if lo > cur:
                parts.append(unset(lo - cur))
            t = take(arrs[q]).narrow(-2, lo - q * R, hi - lo)
            if q != p:
                self._count(cls, t)
                t = t.to(dev)
            parts.append(t)
            cur = hi
        if b > cur:
            parts.append(unset(b - cur))
        return torch.cat(parts, dim=-2)

    def put(self, p: int, arrs, take, a: int, slab, cls: str):
        """Write shard p's ``slab`` into rows [a, a + rows) of
        ``take(arrs[q])`` on the owning shards q."""
        R = self.R
        for q, lo, hi in self.owners(a, a + slab.shape[-2]):
            src = slab.narrow(-2, lo - a, hi - lo)
            if q != p:
                self._count(cls, src)
            take(arrs[q]).narrow(-2, lo - q * R, hi - lo).copy_(src)

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


class ShardedArray:
    """One row-sharded array of a :class:`ShardedState`, as ``LazyMats``
    reads it: indexing the leading axes (never the row and column axes)
    gives the n2 rows of every shard, concatenated on the first device."""

    def __init__(self, state: "ShardedState", name: str):
        self._state, self._name = state, name

    def __getitem__(self, idx):
        st = self._state
        return st.transport.fetch(0, [sh[self._name] for sh in st.shards],
                                  lambda t: t[0][idx], 0, st.n2, "read")


class ShardedState:
    """A dense fill's state split by rows over ``devices`` (one shard each).

    ``shards[p]`` holds the row-sharded arrays (:data:`ROW_NAMES`, rows
    [p R, (p + 1) R), batch axis 1) and, by reference, its device's replica
    of the 2-D matrices (``replicas``, one per distinct device).  As a
    mapping it reads like the plain state of ``fold.fill6`` for
    ``lazy.LazyMats``: a 2-D name gives the first device's replica, a
    sharded name a :class:`ShardedArray`; :meth:`rows` gives a row range,
    :meth:`p_split_reads` what the traceback's P split reads of PKD,
    :meth:`gather` the whole plain dict."""

    def __init__(self, n: int, devices):
        self.n, self.n2 = n, n + 2
        self.devices = [torch.device(d) for d in devices]
        self.P = len(self.devices)
        self.R, _ = row_partition(n, self.P)
        n2, T, S, U = dims(n)
        self.replicas = {dev: init_state_2d(n, dev)
                         for dev in dict.fromkeys(self.devices)}
        self.shards = []
        for dev in self.devices:
            sh = {name: torch.full((1, T, S + (T + 2) * (name == "PKE"),
                                    self.R, n2), SAT16, dtype=I16, device=dev)
                  for name in ROW_NAMES}
            sh.update(self.replicas[dev])
            self.shards.append(sh)
        self.transport = RowTransport(self.devices, self.R, n2)

    def keys(self):
        return [*self.replicas[self.devices[0]], *ROW_NAMES]

    def __contains__(self, name):
        return name in self.keys()

    def __getitem__(self, name):
        if name in ROW_NAMES:
            return ShardedArray(self, name)
        return self.replicas[self.devices[0]][name][0]

    def rows(self, name: str, a: int, b: int):
        """Rows [a, b) of a sharded array (batch axis dropped) on the first
        device."""
        return self.transport.fetch(0, [sh[name] for sh in self.shards],
                                    lambda t: t[0], a, b, "read")

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
        """The plain state dict of ``fold.fill6`` on ``device`` (default:
        the first shard's)."""
        dev = self.devices[0] if device is None else torch.device(device)
        out = {k: v[0].to(dev) for k, v in self.replicas[self.devices[0]].items()}
        for name in ROW_NAMES:
            out[name] = self.rows(name, 0, self.n2).to(dev)
        return out

    def shard_bytes(self, p: int) -> int:
        """Bytes of shard p's row-sharded arrays (its replica apart)."""
        return sum(self.shards[p][k].nbytes for k in ROW_NAMES)

    def replica_bytes(self) -> int:
        """Bytes of one replica of the 2-D matrices."""
        return sum(v.nbytes for v in self.replicas[self.devices[0]].values())


def sharded_reads(st: ShardedState, p: int, s: int, TB: int, IB: int) -> SpanReads:
    """:class:`gapped4.SpanReads` of shard p's rows [p R, p R + IB) at span
    s: ``RL`` is the dense layout's (row-local); ``plane`` and ``window``
    fetch their halos, ``RI`` reduces each C row's history on its owner."""
    n = st.n
    n2, T, S, U = dims(n)
    sh, tr, R = st.shards[p], st.transport, st.R
    i0, dev = p * R, st.devices[p]

    def arrs(name):
        return [x[name] for x in st.shards]

    def plane(name, c, b, di):
        sl = tr.fetch(p, arrs(name), lambda t: t.select(2, max(s - b, 0)),
                      i0 + di, i0 + di + IB, "halo")
        sl = pad_axis(sl, -3, 0, max(c + TB - T, 0), SAT16)
        return dynamic_slice(sl, (c, 0, 0), (TB, IB, n2))

    sp0 = max(s - TB, 0)
    spv = sp0 + torch.arange(TB, device=dev)
    i_val = torch.arange(i0, i0 + IB, device=dev)

    def RI(name, X, g1):
        """min over d in [1, sj-g1] of C_[name][tt, s-d, l, j] + X(i, i+d-1)
        for rows i (l = i + s): each owner of rows l reduces its own."""
        wi = g2(X, i_val[None, :].expand(TB, IB),
                i_val[None, :] + s - spv[:, None] - 1)     # [B, sp, i]
        out = torch.full((sh["PKD"].shape[0], TB, IB, n2), INF, dtype=I32,
                         device=dev)                      # l >= n2: INF
        for q, lo, hi in tr.owners(i0 + s, i0 + s + IB):
            devq = st.devices[q]
            win = dynamic_slice(st.shards[q]["C_" + name],
                                (0, sp0, lo - q * R, 0),
                                (TB, TB, hi - lo, n2)).to(I32)
            d = (s - sp0 - torch.arange(TB, device=devq))[None, :, None, None]
            red = ri_min(win, tr.move(wi[..., lo - i0 - s: hi - i0 - s], p, q, "shift"),
                         torch.arange(lo - s, hi - s, device=devq), d,
                         torch.arange(n2, device=devq), g1)
            out[:, :, lo - i0 - s: hi - i0 - s] = tr.move(red, q, p, "shift")
        return out

    def window(name, rows, halo=DS):
        """[B, rows(tt'), DS, IB + halo, n2]: row r of axis 2 = span
        s - DS + r (spans below 0 unset), rows from i0, unset past n2."""
        lo = max(s - DS, 0)
        w = tr.fetch(p, arrs(name), lambda t: t.narrow(2, lo, s - lo),
                     i0, i0 + IB + halo, "halo")
        w = pad_axis(w, -3, DS - (s - lo), 0, SAT16)
        w = pad_axis(w, -4, 0, max(rows - T, 0), SAT16)
        return w[:, :rows]

    return SpanReads(plane, dense_rl(sh, n, s, TB, IB, i0), RI, window)


def resolve_devices(devices=None):
    """The shards' devices: ``devices`` as given, else one shard per card
    (``cuda:0``, ``cuda:1``, ...); raises without CUDA."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fill6_sharded runs on CUDA devices by default and none is "
                "available; pass devices=['cpu', ...] to run on the CPU")
        devices = [f"cuda:{p}" for p in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("fill6_sharded needs at least one device")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("a CUDA shard was asked for and CUDA is not available")
    return devices


def _on(tables, dev):
    return add_batch({k: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for k, v in tables.items()})


def _write_back(st: ShardedState, p: int, s: int, packed):
    """Shard p's span-s slabs into the state: the families and PKD / PKE
    into its own rows, the C-skew rows l = i + s into their owners."""
    sh, i0 = st.shards[p], p * st.R
    TB, IB = packed["PK"].shape[-3], packed["PK"].shape[-2]

    def at_span(t):
        return t.narrow(1, 0, TB).select(2, s)

    for name in M4_NAMES:
        at_span(sh[name]).narrow(-2, 0, IB).copy_(packed[name])
    for name in C_MATS:
        st.transport.put(p, [x["C_" + name] for x in st.shards], at_span,
                         i0 + s, packed[name], "shift")
    update_pk_skews4(sh, packed["PK"], s, st.n, i0)


@torch.inference_mode()
def fill6_sharded(C, SC4, n: int, dangles: int, devices=None) -> ShardedState:
    """The dense fill (``fold.fill6``) with the rows split over shards.

    ``C`` / ``SC4``: ``fold.consts_from_numpy``'s tables (copied to every
    shard's device).  ``devices``: one torch device per shard (P shards on
    one card: ``["cuda:0"] * P``); without it, one shard per card, raising
    without CUDA.  Per span: the 2-D recurrences on every replica;
    the P split on each shard's rows, all-gathered into every replica's
    P diagonal; the gapped step on each shard with a span-s row
    (``gapped4.span_families`` with its row offset, one ``minplus_group``
    launch per tt step and shard on CUDA); then the write-back.  Returns
    the :class:`ShardedState`; its ``gather()`` equals ``fill6``'s state
    bit for bit."""
    st = ShardedState(n, resolve_devices(devices))
    tr = st.transport
    Cd = {dev: {**_on(C, dev), "n": n} for dev in st.replicas}
    SC4d = {dev: _on(SC4, dev) for dev in st.replicas}
    for s in range(n):
        TB, _ = bucket_dims(n, s)
        tr.span = s
        for dev, rep in st.replicas.items():
            compute_V_span(Cd[dev], rep, s, dangles)
        active = span_rows(n, st.R, st.P, s)
        pieces = {}
        for p, i0, IB in active:
            dev = st.devices[p]

            def pkd_rows(span, r0, rows, p=p):
                return tr.fetch(p, [x["PKD"] for x in st.shards],
                                lambda t: t.select(2, span), r0, r0 + rows, "gather")

            pieces[p] = (i0, p_split_rows(Cd[dev], st.shards[p]["PKE"], pkd_rows,
                                          s, i0, IB))
        for dev, p_min in tr.allgather(pieces, st.replicas).items():
            _set_P_diag(st.replicas[dev], n, s, p_min)
        for dev, rep in st.replicas.items():
            compute_WBP_WPP_span(Cd[dev], rep, s)
        # every shard's reads of the span come before any write-back
        packed = {}
        for p, i0, IB in active:
            dev = st.devices[p]
            packed[p] = span_families(Cd[dev], SC4d[dev], st.shards[p], s, TB, IB,
                                      sharded_reads(st, p, s, TB, IB), i0)
        for p, slabs in packed.items():
            _write_back(st, p, s, slabs)
        for dev, rep in st.replicas.items():
            compute_WMv_WMp_WM_span(Cd[dev], rep, s, dangles)
    tr.span = None
    return st
