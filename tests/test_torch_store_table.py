"""The launch tables of ``span_assemble`` and ``span_store`` (``csrc/assemble.cu``,
``csrc/store.cu``), built on the CPU by ``cuda_ops.assemble_table`` and
``cuda_ops.store_table`` from the fills' own calls, held against the views
and operands themselves:

* each plane read's parts (pointer, strides, extents, offsets), the
  history planes' shared strides, ``pl_int``'s and ``pr_int``'s, the
  tables', the outputs (a plane of the span's cells each);
* each destination's pointer, strides, extents, r0, skew, source and run
  flag (every destination the layouts make takes the run path: its row
  stride is n2), the loops' and ``xs``' strides, the block-to-destination
  prefix table;
* the store kernel's block, run, chunk and 16-byte vector decode, restated
  in Python: every element of every view written exactly once (a
  destination off a 16-byte boundary and one whose row stride is not n2
  among them), and its band rule against ``span_store_ref``;
* the assembly kernel's plane-read decode (the part that holds a row, its
  tt test, the read's own bounds) restated against ``plane_slab`` and the
  plain version's bounds;
* what the store kernel relies on where it loads no ``xs``: the plain
  assembly leaves ``xs`` SAT16 on every cell off the span's valid ones;

at a dense n=24 span, a packed n=37 span whose reads cross two segments
and a row shard of a P=3 dense state with its staging slab.  Refusals of
operands the kernels cannot take.  No JAX: the tables are the port's own.
"""

import pytest
import torch

from ccj_tpu_torch.dist import wavefront
from ccj_tpu_torch.engine import cuda_ops, gapped4, gapped5
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF, SAT16
from ccj_tpu_torch.engine.gapped import step_tables
from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu_torch" / "params" / "rna_DirksPierce09.par"
SEQ = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"          # n = 37


def _consts(n):
    sp = scale_parameters(parse_par(PAR))
    tabs = build_seq_tables(SEQ[:n], sp, DEFAULT_PK)
    C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), "cpu")
    return tfold.add_batch(C), tfold.add_batch(SC4)


def _rand16_(x, gen):
    x.random_(-3000, 4000, generator=gen)
    return x.masked_fill_(x >= 3000, SAT16)


def _spied(run):
    """The (args, keywords) of the span_assemble and span_store calls ``run()``
    makes (the plain versions run: CPU tensors)."""
    seen = {}
    real = cuda_ops.span_assemble, cuda_ops.span_store
    mp = pytest.MonkeyPatch()

    def spy(k):
        def call(*a, **kw):
            seen[k] = (a, kw)
            return real[k](*a, **kw)
        return call

    mp.setattr(cuda_ops, "span_assemble", spy(0))
    mp.setattr(cuda_ops, "span_store", spy(1))
    try:
        with torch.inference_mode():
            run()
    finally:
        mp.undo()
    return seen[0], seen[1]


def _dense():
    n, s = 24, 12
    C, SC4 = _consts(n)
    gen = torch.Generator().manual_seed(1)
    st = tfold._init_dense(n, "cpu")
    for v in st.values():
        if v.dim() == 5:
            _rand16_(v, gen)
    TB, IB = gapped4.bucket_dims(n, s)
    return _spied(lambda: gapped4.span_gapped4(step_tables(C, st), SC4, st, s, TB, IB))


def _packed():
    n, s = 37, 32                       # reads at spans 31 (segment 1) and 30 (segment 0)
    C, SC4 = _consts(n)
    segs = gapped5.segments7(n)
    gi = next(g for g, (lo, hi, *_r) in enumerate(segs) if lo <= s < hi)
    assert gi == 1 and segs[gi][0] == 31
    gen = torch.Generator().manual_seed(2)
    st = tfold.init_state_2d(n, "cpu")
    st.update(gapped5.init_big_state7(n, segs, "cpu"))
    for v in st.values():
        if v.dim() == 5:
            _rand16_(v, gen)
    return _spied(lambda: gapped5.span_gapped7(step_tables(C, st), SC4, st, s, gi, segs))


def _row_shard():
    n, s, P = 24, 12, 3
    C, SC4 = _consts(n)
    gen = torch.Generator().manual_seed(3)
    st = wavefront.ShardedState(n, ["cpu"] * P)
    for sh in st.shards:
        for k in st.row_names:
            _rand16_(sh[k], gen)
    TB = gapped4.bucket_dims(n, s)[0]
    p, i0, rows = wavefront.span_rows(n, st.R, P, s)[1]

    def run():
        reads = wavefront.sharded_reads(st, p, s, TB, rows)
        Cw = step_tables(C, st.replicas[st.devices[p]])
        res = gapped4.span_families(Cw, SC4, st.shards[p], s, TB, rows, reads, i0)
        wavefront._write_back(st, p, s, res, None)

    return _spied(run)


CASES = {"dense n=24 s=12": _dense, "packed n=37 s=32 (two segments)": _packed,
         "dense row shard 1 of 3, n=24 s=12": _row_shard}


@pytest.fixture(scope="module", params=list(CASES))
def calls(request):
    return request.param, CASES[request.param]()


# ---------------------------------------------------------------------------
# span_assemble's table
# ---------------------------------------------------------------------------

def _assemble_outputs(aa, akw):
    """The wrapper's outputs: 5 and 8 planes of the span's cells."""
    cells = aa[1].shape[0] * akw["TB"] * akw["IB"] * (akw["n"] + 2)
    return (torch.empty((5, cells), dtype=torch.int32),
            torch.empty((len(cuda_ops.ASSEMBLED), cells), dtype=torch.int16))


def test_assemble_table_holds_the_operands(calls):
    _label, ((aa, akw), _store) = calls
    planes, pl, pr, hist, tables = aa
    out32, out16 = _assemble_outputs(aa, akw)
    t = cuda_ops.assemble_table(*aa, out32, out16, **akw)
    B, n2 = pl.shape[0], akw["n"] + 2
    for q, parts in enumerate(planes):
        assert t.nparts[q] == len(parts)
        for k in range(cuda_ops.PLANE_MAX_PARTS):
            got = (t.pp[q][k] or 0, t.pst0[q][k], t.pst1[q][k], t.pst2[q][k], t.pTT[q][k],
                   t.pR[q][k], t.pt0[q][k], t.pr0[q][k])
            if k < len(parts):
                view, t0, r0 = parts[k]
                assert view.stride(3) == 1
                assert got == (view.data_ptr(), *view.stride()[:3], *view.shape[1:3], t0, r0)
            else:
                assert got == (0,) * 8
    assert [t.hist[k] for k in range(len(hist))] == [h.data_ptr() for h in hist]
    assert (t.pl, t.pr) == (pl.data_ptr(), pr.data_ptr())
    assert tuple(t.hs) == hist[0].stride()[:3]       # one set of strides for all 16
    assert all(h.stride() == hist[0].stride() for h in hist)
    assert (tuple(t.pls), tuple(t.prs)) == (pl.stride()[:3], pr.stride()[:3])
    assert (t.canp, t.ptype, t.estp) == tuple(x.data_ptr() for x in tables)
    assert tuple(t.ts) == tables[1].stride()[:2]
    assert all(x.stride() == tables[1].stride() for x in tables)
    assert (t.out32, t.out16) == (out32.data_ptr(), out16.data_ptr())
    assert (t.B, t.TB, t.IB, t.n2, t.n, t.s, t.i0) == (
        B, akw["TB"], akw["IB"], n2, akw["n"], akw["s"], akw["i0"])
    assert (t.ap, t.bp, t.cp, t.PB) == (akw["ap"], akw["bp"], akw["cp"], akw["PB"])
    assert out32.shape[1] == out16.shape[1] == B * t.TB * t.IB * n2


def test_assemble_row_reads_restated(calls):
    """The kernel's decode of each plane read (``rp``: the first part whose
    rows hold the row decides, its tt test, the read's own bounds as a j
    range of the row), restated from the table's fields and the part
    views, against ``plane_slab`` under the plain version's bounds, at
    every (tt, row) of the span."""
    _label, ((aa, akw), _store) = calls
    planes, pl = aa[0], aa[1]
    out32, out16 = _assemble_outputs(aa, akw)
    t = cuda_ops.assemble_table(*aa, out32, out16, **akw)
    s, n, i0, TB, IB = (akw[k] for k in ("s", "n", "i0", "TB", "IB"))
    B, n2 = pl.shape[0], n + 2
    tv = torch.arange(TB)[:, None, None]
    iv = torch.arange(i0, i0 + IB)[None, :, None]
    jv = torch.arange(n2)[None, None, :]
    for q, (_name, c, bb, di, dj) in enumerate(cuda_ops.ASSEMBLE_READS):
        # the plain version's plane: plane_slab, shifted by dj, INF off its bounds
        sl = cuda_ops.plane_slab(planes[q], B, TB, IB, n2, "cpu")
        if dj == -1:
            sl = torch.nn.functional.pad(sl, (1, 0), value=SAT16)[..., :n2]
        i2, j2 = iv + di, jv + dj
        ok = ((i2 >= 1) & (i2 <= j2) & (j2 + tv + c + 2 <= i2 + s - bb) & (i2 + s - bb <= n)
              & (s - bb >= 0))
        want = torch.where(ok, sl.to(torch.int32), INF)
        got = torch.full_like(want, INF)
        by_ptr = {v.data_ptr(): v for v, _t0, _r0 in planes[q]}
        for tt in range(TB):
            for r in range(IB):
                i = i0 + r
                i2, u = i + di, s - bb
                if i2 < 1 or i2 + u > n or u < 0:
                    continue
                lo, hi = i2 - dj, i2 + u - tt - c - 2 - dj
                if lo > hi:
                    continue
                row = None                       # None: SAT16 on [lo, hi]
                for k in range(t.nparts[q]):
                    vr = r + t.pr0[q][k]
                    if not 0 <= vr < t.pR[q][k]:
                        continue
                    vt = tt + t.pt0[q][k]
                    if 0 <= vt < t.pTT[q][k]:
                        row = by_ptr[t.pp[q][k]][:, vt, vr]
                    break
                lo_c, hi_c = max(lo, 0), min(hi, n2 - 1)
                if row is None:
                    got[:, tt, r, lo_c:hi_c + 1] = SAT16
                else:
                    got[:, tt, r, lo_c:hi_c + 1] = row[:, lo_c + dj:hi_c + dj + 1].to(
                        torch.int32)
        assert torch.equal(got, want), cuda_ops.ASSEMBLE_READS[q]


def test_assembled_families_are_sat16_off_the_valid_cells(calls):
    """``span_store`` loads no ``xs`` element off the span's valid cells and
    writes SAT16 there, where ``span_store_ref`` copies ``xs`` as it is:
    they agree because the assembly leaves ``xs`` SAT16 there.  Held for
    the plain assembly on the fills' operands and on random int32 operands
    (stencils and history planes far past int16), with values on the
    valid cells."""
    _label, ((aa, akw), (sa, _skw)) = calls
    planes, pl, pr, hist, tables = aa
    B, n2 = pl.shape[0], akw["n"] + 2
    valid = cuda_ops.span_valid(akw["n"], akw["s"], akw["i0"], akw["TB"], akw["IB"], n2)
    gen = torch.Generator().manual_seed(5)

    def rnd(x):
        return torch.randint(-40000, 40000, x.shape, generator=gen, dtype=x.dtype)

    with torch.inference_mode():
        fills = cuda_ops.span_assemble_ref(*aa, **akw).xs
        assert torch.equal(fills, sa[2])               # what the fill handed the store
        rand = cuda_ops.span_assemble_ref(planes, rnd(pl), rnd(pr), [rnd(h) for h in hist],
                                          tables, **akw).xs
    for xs in (fills, rand):
        assert xs.shape == (len(cuda_ops.ASSEMBLED), B, akw["TB"], akw["IB"], n2)
        assert bool((xs[:, :, ~valid] == SAT16).all())
        assert bool((xs[:, :, valid] != SAT16).any())


def test_assemble_table_refuses_what_the_kernel_cannot_take(calls):
    _label, ((aa, akw), _store) = calls
    planes, pl, pr, hist, tables = aa
    out32, out16 = _assemble_outputs(aa, akw)
    loose = torch.zeros((*hist[3].shape[:-1], hist[3].shape[-1] + 1), dtype=torch.int32)
    loose = loose[..., :-1]                      # the same shape, another row stride
    loose.copy_(hist[3])
    with pytest.raises(ValueError, match="share their strides"):
        cuda_ops.assemble_table(planes, pl, pr, [*hist[:3], loose, *hist[4:]], tables,
                                out32, out16, **akw)
    view, t0, r0 = planes[0][0]
    wide = torch.zeros((*view.shape[:-1], 2 * view.shape[-1]), dtype=torch.int16)[..., ::2]
    with pytest.raises(ValueError, match="j stride must be 1"):
        cuda_ops.assemble_table([[(wide, t0, r0)], *planes[1:]], pl, pr, hist, tables,
                                out32, out16, **akw)
    with pytest.raises(ValueError, match="outputs"):
        cuda_ops.assemble_table(*aa, out32[:, :-2], out16[:, :-2], **akw)


# ---------------------------------------------------------------------------
# span_store's table
# ---------------------------------------------------------------------------

def _chunks(L):
    return -(-((L + 14) // 8) // cuda_ops.STORE_BLOCK_VECS)


def test_store_table_holds_the_destinations(calls):
    label, (_assemble, (sa, skw)) = calls
    dests, loops, xs = sa
    t, blocks = cuda_ops.store_table(*sa, **skw)
    B, n2 = xs.shape[1], skw["n"] + 2
    assert t.nd == len(dests)
    total = 0
    for k, (family, view, r0, skew) in enumerate(dests):
        st = view.stride()
        assert st[3] == 1
        assert st[2] == n2, f"{family}: a layout's destination off the run path"
        assert (t.dp[k], t.dst0[k], t.dst1[k], t.drow[k]) == (view.data_ptr(), *st[:3])
        assert (t.dTT[k], t.dR[k], t.dr0[k], t.dskew[k]) == (*view.shape[1:3], r0, int(skew))
        assert t.dsrc[k] == cuda_ops.STORE_SOURCES.index(family)
        assert t.dchunks[k] == _chunks(view.shape[2] * n2)
        assert t.dblock0[k] == total                       # the prefix table
        total += B * view.shape[1] * t.dchunks[k]
    assert t.blocks == blocks == total
    assert all(t.dp[k] is None for k in range(len(dests), cuda_ops.STORE_MAX_DESTS))
    assert [t.loop[k] for k in range(len(cuda_ops.STEP_FAMILIES))] == [
        loops[nm].data_ptr() for nm in cuda_ops.STEP_FAMILIES]
    assert [tuple(t.lst[k]) for k in range(len(cuda_ops.STEP_FAMILIES))] == [
        loops[nm].stride()[:3] for nm in cuda_ops.STEP_FAMILIES]
    assert (t.xs, tuple(t.xst)) == (xs.data_ptr(), xs.stride()[:4])
    assert (t.B, t.TB, t.IB, t.n2, t.n, t.s, t.i0) == (
        B, skw["TB"], skw["IB"], n2, skw["n"], skw["s"], skw["i0"])
    # the layouts' own destinations: PKE's anti-diagonal, and the case's kind
    assert sum(d.skew for d in dests) == 2
    if "row shard" in label:                 # C rows another shard owns: a staging slab
        assert any(d.view._base is None for d in dests)
    if "packed" in label:                    # a run that starts off a 16-byte boundary
        assert any(d.view.data_ptr() % 16 for d in dests)


def _written_once(t, views, n2):
    """The store kernel's decode restated: every block's destination (the
    binary search over dblock0), run and chunk, the chunk's 16-byte vectors
    from the run's base address, the elements they write; returns a count
    a view element."""
    counts = [torch.zeros(v.shape, dtype=torch.int32) for v in views]
    vpb = cuda_ops.STORE_BLOCK_VECS
    for blk in range(t.blocks):
        d = 0
        step = 32
        while step:
            if d + step < t.nd and t.dblock0[d + step] <= blk:
                d += step
            step >>= 1
        run, chunk = divmod(blk - t.dblock0[d], t.dchunks[d])
        rowrun = t.drow[d] != n2
        rd0 = 0
        if rowrun:
            run, rd0 = divmod(run, t.dR[d])
        b, tt = divmod(run, t.dTT[d])
        base = t.dp[d] + 2 * (b * t.dst0[d] + tt * t.dst1[d] + rd0 * t.drow[d])
        L = n2 if rowrun else t.dR[d] * n2
        a0 = (base >> 1) & 7
        nvec = (L + a0 + 7) >> 3
        lo = max(0, 8 * chunk * vpb - a0)
        hi = min(L, 8 * min((chunk + 1) * vpb, nvec) - a0)
        if lo >= hi:
            continue
        if rowrun:
            counts[d][b, tt, rd0, lo:hi] += 1
        else:
            counts[d][b, tt].view(-1)[lo:hi] += 1
    return counts


def test_store_kernel_writes_every_element_once(calls):
    _label, (_assemble, (sa, skw)) = calls
    dests, loops, xs = sa
    n2 = skw["n"] + 2
    # one more destination whose row stride is not n2: every other row of a
    # slab, the kernel's row-a-run branch
    big = torch.zeros((xs.shape[1], 3, 2 * 5, n2), dtype=torch.int16)
    extra = cuda_ops.StoreDest("PL", big[:, :, ::2], 1)
    t, _blocks = cuda_ops.store_table([*dests, extra], loops, xs, **skw)
    assert t.drow[len(dests)] == 2 * n2
    for d, c in zip([*dests, extra], _written_once(t, [d.view for d in (*dests, extra)], n2)):
        assert int(c.min()) == int(c.max()) == 1, d.family


def test_store_band_rule_restated(calls):
    """The kernel's band rule (a view element takes its source where the
    slab row's i is live and the column lies in [i, i + s - tt - 2], a
    loop family clamped to int16; SAT16 everywhere else, without a load)
    against ``span_store_ref`` on the same operands."""
    _label, (_assemble, (sa, skw)) = calls
    dests, loops, xs = sa
    s, n, i0, TB, IB = (skw[k] for k in ("s", "n", "i0", "TB", "IB"))
    with torch.inference_mode():            # the state's views are inference tensors
        _band_rule(dests, loops, xs, s, n, i0, TB, IB)


def _band_rule(dests, loops, xs, s, n, i0, TB, IB):
    views = [d.view.clone() for d in dests]
    for d in dests:
        d.view.fill_(-7)
    cuda_ops.span_store_ref(dests, loops, xs, s, n, i0, TB, IB)
    for (family, view, r0, skew), before in zip(dests, views):
        got = torch.full_like(view, SAT16)
        src = (loops[family].clamp(-32768, SAT16) if family in loops
               else xs[cuda_ops.ASSEMBLED.index(family)])
        TT, R = view.shape[1:3]
        for tt in range(min(TT, TB)):
            for rd in range(R):
                r = rd + r0
                i = i0 + r
                if not (0 <= r < IB and i >= 1 and i + s <= n):
                    continue
                c0 = i if skew else 0
                lo, hi = i - c0, i + s - tt - 2 - c0
                if lo <= hi:
                    got[:, tt, rd, lo:hi + 1] = src[:, tt, r, lo + c0:hi + c0 + 1].to(
                        torch.int16)
        assert torch.equal(view, got), family
        view.copy_(before)


def test_store_table_refuses_what_the_kernel_cannot_take(calls):
    _label, (_assemble, (sa, skw)) = calls
    dests, loops, xs = sa
    view = dests[0].view
    wide = torch.zeros((*view.shape[:-1], 2 * view.shape[-1]), dtype=torch.int16)[..., ::2]
    with pytest.raises(ValueError, match="j stride must be 1"):
        cuda_ops.store_table([cuda_ops.StoreDest(dests[0].family, wide), *dests[1:]],
                             loops, xs, **skw)
    pk = loops["PK"]
    wide32 = torch.zeros((*pk.shape[:-1], 2 * pk.shape[-1]), dtype=torch.int32)[..., ::2]
    with pytest.raises(ValueError, match="j stride must be 1"):
        cuda_ops.store_table(dests, {**loops, "PK": wide32}, xs, **skw)
