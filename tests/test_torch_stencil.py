"""The gapped step's PL / PR interior-loop stencils, ``cuda_ops.stencil_pl``
and ``stencil_pr`` (``csrc/stencil.cu`` on the card, their plain versions
``stencil_pl_ref`` / ``stencil_pr_ref`` here), bit for bit (tolerance
zero: integer data):

* the port's PLs / PRs slabs, which the span step assembles from the
  stencils over the layout's in-place window, against the JAX span step's
  own (the 7th and 8th arguments of its tt loop, taken by a spy on
  ``ccj_tpu.engine.ttloop.tt_loop`` under one jit of the step):
  - dense: the state of an n=24 ``fill6`` before span 12 (the window
    reaches spans below 0), for B=1, B=2 (two sequences' states stacked)
    and the rows [9, 13) of a row shard (``dist.wavefront.fill6_sharded``
    with P=3 CPU shards, its halo fetched across shards);
  - packed: a random n=37 state in ``segments7(37)``'s two segments at span
    33, whose window straddles them (segment 0's tt rows, fewer than the
    span's, read unset);
* the plain versions against the formulation the fills ran before the
  kernels (kept here: the padded, flipped, stacked window and the 2 x 29
  passes), on random int16 states with SAT16 cells, dense windows reaching
  spans below 0 and tt rows past the view, and a packed two-segment one:
  equal on every cell where the old value is below INF - 32768 (the least
  sum a term of weight >= INF gives), INF where it is not;
* the kernel's walk restated (per row, tile, outer offset and column the
  mask of the inner offsets whose weight is below INF, terms from that
  mask only; SAT16 for spans, tt rows and rows no view holds) against the
  plain version on tiny random operands whose weights follow the fills'
  contract (INF outside every loop bound): random INF inside the bounds,
  whole inner columns INF for some outer offsets, none INF inside; and
  its count of lane terms against ``chip_smoke.stencil_walked``;
* refusals; no launch counted on the CPU; CUDA operands without the kernel
  library raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine import gapped4 as jg4
from ccj_tpu.engine import gapped5 as jg5
from ccj_tpu.engine import ttloop as jttloop
from ccj_tpu.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu.precompute import build_seq_tables
from ccj_tpu_torch.dist import wavefront
from ccj_tpu_torch.engine import cuda_ops, gapped4, gapped5
from ccj_tpu_torch.engine import fold as tfold
from ccj_tpu_torch.engine.common import INF, MAXLOOP, SAT16, TURN, pad_axis
from ccj_tpu_torch.engine.gapped import C_MATS, DS, WX, step_tables
from ccj_tpu_torch.engine.skew import skew_right, unskew_right

from oracle_util import REPO

torch.set_num_threads(1)

PAR = REPO / "ccj_tpu" / "params" / "rna_DirksPierce09.par"
SEQS = ("GGGAAACGGGCGAUCCUUCCCGAA", "GCGCAAUUGCGCGGCGCUUGCGCC")   # n = 24
SEQ37 = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
SPAN = 12


class _Stop(Exception):
    pass


def _spy_run(fn, mp_target, name, grab):
    """Run ``fn()`` with ``mp_target.name`` replaced by a spy that hands
    its arguments to ``grab`` (which raises _Stop to end the run)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(mp_target, name, grab)
    try:
        fn()
    except _Stop:
        pass
    finally:
        mp.undo()


def _jax_slabs(step, st):
    """(PLs, PRs) that the JAX span step ``step(st)`` hands its tt loop,
    from one jit of the step traced up to the loop."""
    def run(st):
        got = {}

        def grab(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, *rest):
            got.update(PLs=PLs, PRs=PRs)
            raise _Stop

        _spy_run(lambda: step(st), jttloop, "tt_loop", grab)
        return got

    got = jax.jit(run)(st)
    return np.asarray(got["PLs"]), np.asarray(got["PRs"])


def _port_slabs(fn):
    """(PLs, PRs) that the port's span step run by ``fn()`` hands its tt
    loop (``gapped4.run_tt_loop``'s 7th and 8th arguments)."""
    got = {}

    def grab(C, SC4, WBt, WPt, WBPg, bases, PLs, PRs, *rest):
        got.update(PLs=PLs.clone(), PRs=PRs.clone())
        raise _Stop

    _spy_run(fn, gapped4, "run_tt_loop", grab)
    return got["PLs"], got["PRs"]


def _consts(seq):
    sp = scale_parameters(parse_par(PAR))
    tabs = build_seq_tables(seq, sp, DEFAULT_PK)
    C_np = {**jfold.build_consts(tabs, sp, DEFAULT_PK, device=False), "n": tabs.n}
    C, SC4 = tfold.consts_from_numpy(C_np, "cpu")
    return sp, tabs, C_np, SC4, {**C, "n": tabs.n}


# ---------------------------------------------------------------------------
# dense: the n=24 fill's state before span 12
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """Per sequence: (the port's batched C and SC4, its fill6 state before
    span SPAN, TB, IB, the JAX PLs / PRs of that span)."""
    out = []
    for seq in SEQS:
        sp, tabs, C_np, SC4, C = _consts(seq)
        seen = {}
        real = tfold.span_gapped4

        def spy(C_, SC4_, st, s, TB, IB):
            if s == SPAN:
                # the tables without the fill's kept weight tables (derived
                # from the state: the cases below build their own states and
                # add their tables, step_tables)
                seen.update(st={k: v.clone() for k, v in st.items()},
                            C={k: v for k, v in C_.items() if k != WX}, SC4=SC4_,
                            TB=TB, IB=IB)
                raise _Stop
            return real(C_, SC4_, st, s, TB, IB)

        _spy_run(lambda: tfold.fill6(C, SC4, tabs.n, sp.dangles), tfold, "span_gapped4",
                 spy)
        st, TB, IB = seen["st"], seen["TB"], seen["IB"]
        st_j = {k: jnp.asarray(v[0].numpy()) for k, v in st.items()}
        sc4_np = {k: v.numpy() for k, v in SC4.items()}
        want = _jax_slabs(lambda st: jg4.span_gapped4(C_np, sc4_np, st, SPAN, TB, IB), st_j)
        out.append((seen["C"], seen["SC4"], st, TB, IB, want, (C, SC4, sp, tabs)))
    return out


def _dense_port(C, SC4, st, TB, IB):
    n = C["n"]
    return _port_slabs(lambda: gapped4.span_families(
        step_tables(C, st), SC4, st, SPAN, TB, IB, gapped4.dense_reads(st, n, SPAN, TB, IB)))


@pytest.mark.parametrize("b", [0, 1])
def test_dense_slabs_match_jax(dense, b):
    C, SC4, st, TB, IB, (pl, pr), _ = dense[b]
    got_pl, got_pr = _dense_port(C, SC4, st, TB, IB)
    assert np.array_equal(got_pl[0].numpy(), pl)
    assert np.array_equal(got_pr[0].numpy(), pr)
    assert (pl < SAT16).any() and (pr < SAT16).any()


def test_dense_slabs_batch_of_two(dense):
    (C0, S0, st0, TB, IB, want0, _), (C1, S1, st1, _, _, want1, _) = dense
    C = {k: torch.cat([v, C1[k]]) if isinstance(v, torch.Tensor) else v for k, v in C0.items()}
    SC4 = {k: torch.cat([v, S1[k]]) for k, v in S0.items()}
    st = {k: torch.cat([st0[k], st1[k]]) for k in st0}
    got_pl, got_pr = _dense_port(C, SC4, st, TB, IB)
    for b, (pl, pr) in ((0, want0), (1, want1)):
        assert np.array_equal(got_pl[b].numpy(), pl), b
        assert np.array_equal(got_pr[b].numpy(), pr), b


def test_dense_slabs_row_shard_match_jax(dense):
    """Shard 1 of 3 at span 12 (rows [9, 13), its PL window's halo fetched
    from shard 2 and past n2): the row-sharded span step's PLs / PRs equal
    the JAX step's rows."""
    *_, (pl, pr), (C, SC4, sp, tabs) = dense[0]
    got = {}

    def grab(C_, SC4_, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0, valid4, s, TB, IB,
             i0=0):
        if s == SPAN and i0 > 0:
            got.update(PLs=PLs.clone(), PRs=PRs.clone(), i0=i0, IB=IB)
            raise _Stop
        return real(C_, SC4_, WBt, WPt, WBPg, bases, PLs, PRs, POs, mdp0, valid4, s,
                    TB, IB, i0)

    real = gapped4.run_tt_loop
    _spy_run(lambda: wavefront.fill6_sharded(C, SC4, tabs.n, sp.dangles,
                                             devices=["cpu"] * 3),
             gapped4, "run_tt_loop", grab)
    i0, IB = got["i0"], got["IB"]
    assert (i0, IB) == (9, 4)
    assert np.array_equal(got["PLs"][0].numpy(), pl[:, i0:i0 + IB])
    assert np.array_equal(got["PRs"][0].numpy(), pr[:, i0:i0 + IB])


# ---------------------------------------------------------------------------
# packed: a random n=37 state in segments7(37)'s two segments
# ---------------------------------------------------------------------------

def _random_packed(n, SEGS, rng, st):
    """Random int16 blocks for every packed family and C skew (one in three
    SAT16), random WBP / WPP, a placeholder PKD (the span step before its
    tt loop reads none)."""
    for k in ("WBP", "WPP"):
        x = rng.integers(-600, 600, st[k].shape).astype(np.int32)
        x[rng.random(x.shape) < 0.2] = INF + 1
        st[k] = torch.from_numpy(x)

    def block(shape):
        x = rng.integers(-2000, 2000, shape).astype(np.int16)
        x[rng.random(shape) < 0.3] = SAT16
        return torch.from_numpy(x)

    for g, (lo, hi, TB, IB, Lc) in enumerate(SEGS):
        for m in gapped5.M4_STORED:
            st[f"{m}@{g}"] = block((1, TB, hi - lo, IB, n + 2))
        for m in C_MATS:
            st[f"C_{m}@{g}"] = block((1, TB, hi - lo, Lc, n + 2))
    st["PKD"] = torch.zeros((1, 1, 1, 1, n + 2), dtype=torch.int16)
    return st


def test_packed_slabs_match_jax():
    n, s, gi = len(SEQ37), 33, 1
    SEGS = gapped5.segments7(n)
    assert len(SEGS) == 2 and SEGS[1][0] == 31            # window: spans 4..32
    assert [h for h, *_ in gapped5.window_spans(s, gi, SEGS)] == [0, 1]
    sp, tabs, C_np, SC4, C = _consts(SEQ37)
    st = _random_packed(n, SEGS, np.random.default_rng(33), tfold.init_state_2d(n, "cpu"))
    st_j = {k: jnp.asarray(v[0].numpy()) for k, v in st.items()}
    sc4_np = {k: v.numpy() for k, v in SC4.items()}
    pl, pr = _jax_slabs(lambda st: jg5.span_gapped7(C_np, sc4_np, st, s, gi, SEGS), st_j)
    Cb, SC4b = tfold.add_batch(C), tfold.add_batch(SC4)
    lo, hi, TB, IB, _ = SEGS[gi]
    assert SEGS[0][2] < TB + DS                           # tt rows past segment 0's
    got_pl, got_pr = _port_slabs(lambda: gapped4.span_families(
        step_tables(Cb, st), SC4b, st, s, TB, IB, gapped5.packed_reads(st, n, s, gi, SEGS)))
    assert np.array_equal(got_pl[0].numpy(), pl)
    assert np.array_equal(got_pr[0].numpy(), pr)
    assert (pl < SAT16).any() and (pr < SAT16).any()


# ---------------------------------------------------------------------------
# the plain versions against the formulation the fills ran before
# ---------------------------------------------------------------------------

def _old_window(parts, s, B, rows, n2):
    """The fills' old [B, rows(tt'), DS, rows, n2] window: row q of axis 2
    = span s - DS + q, unset where no part holds it (the dense and packed
    ``SpanReads.window`` before the kernels, as one function of the views)."""
    R = max(p.shape[3] for p, _ in parts)
    win = torch.full((B, rows, DS, R, n2), SAT16, dtype=torch.int16)
    for view, u0 in parts:
        for u in range(view.shape[2]):
            q = u0 + u - (s - DS)
            if 0 <= q < DS:
                t = min(rows, view.shape[1])
                win[:, :t, q, :view.shape[3]] = view[:, :t, u]
    return win


def _old_pl(parts, W4PL, TB, IB, n2, s, i0):
    """``gapped4.pl_stencil`` as the fills ran it before the kernel."""
    plw = _old_window(parts, s, W4PL.shape[0], TB + DS, n2)
    B = plw.shape[0]
    plw = torch.flip(plw, dims=(-3,))
    plw = pad_axis(plw, -2, 0, max(IB + DS - plw.shape[-2], 0), SAT16)
    V1 = torch.stack([plw[:, :, d1 - 1, d1: d1 + IB, :] for d1 in range(1, DS + 1)], dim=2)
    W = W4PL[..., i0:i0 + IB, :]
    pl_int = torch.full((B, TB, IB, n2), INF, dtype=torch.int32)
    for d2 in range(1, DS + 1):
        sub = V1[:, d2: d2 + TB]
        sub = torch.nn.functional.pad(sub, (d2, 0), value=SAT16)[..., :n2]
        vals = sub.to(torch.int32) + W[:, None, :, d2 - 1]
        pl_int = torch.minimum(pl_int, vals.amin(dim=-3))
    return pl_int


def _old_pr(parts, W4PR, TB, IB, n2, s, i0):
    """``gapped4.pr_stencil`` as the fills ran it before the kernel."""
    UB = n2 + TB
    prw = _old_window(parts, s, W4PR.shape[0], TB + DS, n2)[..., :IB, :]
    prw = pad_axis(prw, -2, 0, max(IB - prw.shape[-2], 0), SAT16)
    B = prw.shape[0]
    prw = torch.flip(prw, dims=(-3,))
    pru = skew_right(prw.movedim(1, -2), SAT16)
    wpr = W4PR[..., 2:2 + UB, s + i0:s + i0 + IB].transpose(-1, -2)
    pr_acc = torch.full((B, IB, TB, UB), INF, dtype=torch.int32)
    for d1 in range(1, DS + 1):
        sub = pru[..., d1: d1 + TB, d1: d1 + UB]
        vals = sub.to(torch.int32) + wpr[:, d1 - 1, :, :, None, :]
        pr_acc = torch.minimum(pr_acc, vals.amin(dim=-4))
    return unskew_right(pr_acc, INF, n2).movedim(-3, -2)


def _rand_state(rng, shape):
    x = rng.integers(-3000, 3000, shape).astype(np.int16)
    x[rng.random(shape) < 0.25] = SAT16
    return torch.from_numpy(x)


def _rand_weights(rng, shape, inf_share=0.3):
    w = rng.integers(-900, 600, shape).astype(np.int32)
    w[rng.random(shape) < inf_share] = INF
    return torch.from_numpy(w)


def _old_new_cases():
    """(label, parts, W4PL, W4PR, s, n, i0, TB, IB) on random states."""
    rng = np.random.default_rng(13)
    out = []
    n = 24
    n2, T = n + 2, n - 1
    st = _rand_state(rng, (2, T, n, n2, n2))                      # dense, B = 2
    for s, i0, IB in ((12, 0, 16), (20, 0, 8), (12, 3, 6)):
        TB = gapped4.bucket_dims(n, s)[0]
        lo = max(s - DS, 0)
        W4PL = _rand_weights(rng, (2, DS, DS, n2, n2))
        W4PR = _rand_weights(rng, (2, DS, DS, n2 + T + 2, 2 * n2))
        parts = [(st[:, :, lo:s, i0:], lo)]
        out.append((f"dense s={s} i0={i0}", parts, W4PL, W4PR, s, n, i0, TB, IB))
    n = 37
    n2, T = n + 2, n - 1
    SEGS = gapped5.segments7(n)
    blocks = [_rand_state(rng, (1, TBg, hi - lo, IBg, n2)) for lo, hi, TBg, IBg, _ in SEGS]
    s, gi = 33, 1
    lo, hi, TB, IB, _ = SEGS[gi]
    parts = [(blocks[h][:, :, a - SEGS[h][0]:b - SEGS[h][0]], a)
             for h, a, b in gapped5.window_spans(s, gi, SEGS)]
    out.append(("packed n=37 s=33", parts, _rand_weights(rng, (1, DS, DS, n2, n2)),
                _rand_weights(rng, (1, DS, DS, n2 + T + 2, 2 * n2)), s, n, 0, TB, IB))
    return out


@pytest.mark.parametrize("case", _old_new_cases(), ids=lambda c: c[0])
def test_plain_versions_match_the_old_formulation(case):
    _, parts, W4PL, W4PR, s, n, i0, TB, IB = case
    n2 = n + 2
    valid = cuda_ops.span_valid(n, s, i0, TB, IB, n2)
    kw = dict(s=s, n=n, i0=i0, TB=TB, R=IB)
    for new, old in ((cuda_ops.stencil_pl(parts, W4PL, **kw),
                      _old_pl(parts, W4PL, TB, IB, n2, s, i0)),
                     (cuda_ops.stencil_pr(parts, W4PR, **kw),
                      _old_pr(parts, W4PR, TB, IB, n2, s, i0))):
        assert tuple(new.shape) == tuple(old.shape)
        want = torch.where(valid & (old < INF - 32768), old, INF)
        assert torch.equal(new, want)
        assert bool((new < INF).any())


# ---------------------------------------------------------------------------
# the kernel's walk, restated, on tiny random operands
# ---------------------------------------------------------------------------

def _kernel_walk(kind, parts, w, s, n, i0, TB, R):
    """csrc/stencil.cu's walk restated: (out, lane terms walked).  Per live
    row, tile of 128 (PL) or 64 (PR) tt rows x 32 columns (x = j - i for
    PL; x = u - i, u = j + tt, for PR) with a valid cell, outer offset d in [1, min(DS, G - 5)] at
    the tile's largest loop bound G, and column with a valid cell in the
    tile: the mask of the inner offsets whose weight is below INF, and
    terms from that mask only, each on the 32 lanes (tt rows) of every
    chunk of 32 tt rows that holds a valid cell of the column.  The state
    value comes from the view holding the span, SAT16 for a span none
    holds, a tt row past a view's or a row past it (or a column off
    [0, n2)).  Lanes past the column's last valid tt row are counted and
    never written."""
    n2 = n + 2
    B = w.shape[0]
    out = torch.full((B, TB, R, n2), INF, dtype=torch.int32)
    walked = 0
    cols, last_tt = s - 1, min(TB, s - 1) - 1
    PL = kind == cuda_ops.PL_KIND
    chunks = 4 if PL else 2                  # chunks of 32 tt rows a tile

    def value(b, t, span, row, col):
        for view, u0 in parts:
            if u0 <= span < u0 + view.shape[2]:
                if t < view.shape[1] and row < view.shape[3] and 0 <= col < n2:
                    return int(view[b, t, span - u0, row, col])
        return SAT16

    def weight(b, d, dd, i, x):
        if PL:                                  # W4PL[b, d1 - 1, d2 - 1, i, j]
            return int(w[b, d - 1, dd, i, i + x]) if i + x < n2 else INF
        k, l = i + x + 2, i + s                 # W4PR[b, d1 - 1, d2 - 1, k, l]
        return int(w[b, dd, d - 1, k, l]) if k < w.shape[3] and l < w.shape[4] else INF

    lo, hi = cuda_ops.p_split_live(n, s, i0, R)
    for b in range(B):
        for i in range(lo, hi + 1):
            r = i - i0
            for t0 in range(0, min(TB, cols), 32 * chunks):
                for x0 in range(0, cols, 32):
                    if PL:
                        if t0 + x0 > s - 2:
                            continue
                        gmax = min(x0 + 31, s - 2 - t0)
                    elif t0 > min(x0 + 31, s - 2):
                        continue
                    else:
                        gmax = s - 2 - max(x0, t0)
                    acc = {}
                    for d in range(1, min(DS, gmax - TURN - 2) + 1):
                        for x in range(x0, x0 + 32):
                            last = (min(last_tt, s - 2 - x) if PL
                                    else -1 if x > s - 2 else min(last_tt, x))
                            if last < t0:
                                continue
                            nk = min(chunks, (last - t0) // 32 + 1)
                            ws = [weight(b, d, dd, i, x) for dd in range(DS)]
                            mask = [dd for dd in range(DS) if ws[dd] < INF]
                            walked += 32 * nk * len(mask)
                            for dd in mask:
                                for tt in range(t0, min(t0 + 32 * nk, last + 1)):
                                    if PL:
                                        v = value(b, tt + dd + 1, s - d, r + d, i + x - dd - 1)
                                    else:
                                        v = value(b, tt + dd + 1, s - d, r, i + x - tt)
                                    acc[tt, x] = min(acc.get((tt, x), INF), v + ws[dd])
                    for (tt, x), a in acc.items():
                        out[b, tt, r, i + x if PL else i + x - tt] = a
    return out, walked


def _contract_weights(rng, kind, B, n, TB, inf_share=0.2):
    """Random weights that follow the fills' contract: INF outside every
    cell's loop bound (PL at (i, j): d1 <= min(j - i, MAXLOOP) - 1,
    d1 + d2 <= j - i - TURN - 1; PR at (k, l) the same in G = l - k),
    ``inf_share`` of them INF inside."""
    n2, T = n + 2, n - 1
    d1 = np.arange(1, DS + 1)[:, None, None, None]
    d2 = np.arange(1, DS + 1)[None, :, None, None]
    if kind == cuda_ops.PL_KIND:
        a, c = np.arange(n2)[:, None], np.arange(n2)[None, :]
        shape = (B, DS, DS, n2, n2)
    else:
        a, c = np.arange(n2 + T + 2)[:, None], np.arange(2 * n2)[None, :]
        shape = (B, DS, DS, n2 + T + 2, 2 * n2)
    G = (c - a)[None, None]
    ok = (d1 <= np.minimum(G, MAXLOOP) - 1) & (d1 + d2 <= G - TURN - 1)
    w = _rand_weights(rng, shape, inf_share).numpy()
    return torch.from_numpy(np.where(ok[None], w, INF).astype(np.int32))


def _outer_columns_inf(rng, kind, w, i0, R, s):
    """``w`` with every inner weight INF at a third of the (outer offset,
    row, column) triples that had one below INF: for those outer offsets a
    warp's whole column mask is empty."""
    w = w.clone()
    rows = torch.arange(i0, i0 + R)
    if kind == cuda_ops.PL_KIND:            # W4PL[b, d1, :, i, j]
        live = (w[:, :, :, i0:i0 + R] < INF).any(dim=2)           # [B, d1, R, n2]
        hit = live & torch.from_numpy(rng.random(tuple(live.shape)) < 1 / 3)
        b, d, r, j = hit.nonzero(as_tuple=True)
        w[b, d, :, rows[r], j] = INF
    else:                                   # W4PR[b, :, d2, k, i + s]
        live = (w[..., rows + s] < INF).any(dim=1)                 # [B, d2, K, R]
        hit = live & torch.from_numpy(rng.random(tuple(live.shape)) < 1 / 3)
        b, d, k, r = hit.nonzero(as_tuple=True)
        w[b, :, d, k, rows[r] + s] = INF
    assert int(hit.sum()) > 0
    return w


# (s, i0, R, weights): "random" one in five weights INF inside the loop
# bounds, "columns" besides whole inner columns INF for some outer
# offsets, "dense" no INF inside the loop bounds
WALK_CASES = [pytest.param(12, 0, 5, "random", id="12-0-5"),
              pytest.param(13, 2, 4, "random", id="13-2-4"),
              pytest.param(12, 0, 5, "columns", id="12-0-5-columns"),
              pytest.param(13, 2, 4, "dense", id="13-2-4-dense")]


def _walk_operands(kind, s, i0, R, weights):
    rng = np.random.default_rng(100 * kind + s)
    n, B, TB = 16, 2, 12
    n2 = n + 2
    # two views with their own tt rows and rows, spans below 0 held by none
    # (s - DS < 0), span s - 1 held by the second
    parts = [(_rand_state(rng, (B, 6, 4, R + 3, n2)), 1),
             (_rand_state(rng, (B, 9, s - 5, R + 30, n2)), 5)]
    w = _contract_weights(rng, kind, B, n, TB, 0.0 if weights == "dense" else 0.2)
    if weights == "columns":
        w = _outer_columns_inf(rng, kind, w, i0, R, s)
    return parts, w, dict(s=s, n=n, i0=i0, TB=TB, R=R)


def _admissible_terms(kind, w, s, n, i0, TB, R):
    """The (valid cell, d1, d2) terms whose weight is below INF."""
    tt, r, j = cuda_ops.span_valid(n, s, i0, TB, R, n + 2).nonzero(as_tuple=True)
    i = i0 + r
    W = w[:, :, :, i, j] if kind == cuda_ops.PL_KIND else w[:, :, :, j + tt + 2, i + s]
    return int((W < INF).sum())


@pytest.mark.parametrize("kind", [cuda_ops.PL_KIND, cuda_ops.PR_KIND], ids=["PL", "PR"])
@pytest.mark.parametrize("s,i0,R,weights", WALK_CASES)
def test_kernel_loop_equals_plain(kind, s, i0, R, weights):
    parts, w, kw = _walk_operands(kind, s, i0, R, weights)
    want, _ = _kernel_walk(kind, parts, w, **kw)
    fn = cuda_ops.stencil_pl if kind == cuda_ops.PL_KIND else cuda_ops.stencil_pr
    got = fn(parts, w, **kw)
    assert torch.equal(got, want)
    assert bool((got < INF).any())                        # terms were taken


@pytest.mark.parametrize("kind", [cuda_ops.PL_KIND, cuda_ops.PR_KIND], ids=["PL", "PR"])
@pytest.mark.parametrize("s,i0,R,weights", WALK_CASES)
def test_walked_count_equals_the_walk(kind, s, i0, R, weights):
    """``chip_smoke.stencil_walked``, the host count phase 2e reports beside
    the admissible terms, equals the restated walk's own count, which lies
    between the admissible terms and 32 lanes for each."""
    import chip_smoke

    parts, w, kw = _walk_operands(kind, s, i0, R, weights)
    _, walked = _kernel_walk(kind, parts, w, **kw)
    name = "PL" if kind == cuda_ops.PL_KIND else "PR"
    assert chip_smoke.stencil_walked(name, w, **kw) == walked
    terms = _admissible_terms(kind, w, **kw)
    assert 0 < terms <= walked <= 32 * terms


# ---------------------------------------------------------------------------
# refusals, counts, no fallback
# ---------------------------------------------------------------------------

def _small(rng, B=1, n=10):
    n2, T = n + 2, n - 1
    view = _rand_state(rng, (B, T, 6, n2, n2))
    return ([(view, 2)], _rand_weights(rng, (B, DS, DS, n2, n2)),
            _rand_weights(rng, (B, DS, DS, n2 + T + 2, 2 * n2)))


def test_stencils_refuse_operands_that_do_not_fit():
    rng = np.random.default_rng(5)
    parts, W4PL, W4PR = _small(rng)
    view = parts[0][0]
    kw = dict(s=8, n=10, i0=0, TB=8, R=12)
    for fn, w in ((cuda_ops.stencil_pl, W4PL), (cuda_ops.stencil_pr, W4PR)):
        fn(parts, w, **kw)                                 # fits
        for bad_parts in ([(view.to(torch.int32), 2)], [(view[..., :5], 2)],
                          [(torch.cat([view, view]), 2)], [(view[0], 2)],
                          [(view, 2), (view, 4)],          # overlapping spans
                          [(view[:, :, :1], 2), (view[:, :, :1], 4), (view[:, :, :1], 6)]):
            with pytest.raises(ValueError):
                fn(bad_parts, w, **kw)
        for bad_w in (w.to(torch.int64), w[:, :5], w[..., :3, :], w[0]):
            with pytest.raises(ValueError):
                fn(parts, bad_w, **kw)
        with pytest.raises(ValueError):
            fn(parts, w, **{**kw, "TB": 0})
    with pytest.raises(ValueError):                         # W4PL rows past i0 + R
        cuda_ops.stencil_pl(parts, W4PL, **{**kw, "i0": 3})


def test_stencils_on_cpu_count_no_launch():
    rng = np.random.default_rng(6)
    parts, W4PL, W4PR = _small(rng)
    before = cuda_ops.STENCIL_LAUNCHES
    for fn, w in ((cuda_ops.stencil_pl, W4PL), (cuda_ops.stencil_pr, W4PR)):
        out = fn(parts, w, s=8, n=10, i0=0, TB=8, R=12)
        assert out.dtype == torch.int32 and tuple(out.shape) == (1, 8, 12, 12)
    assert cuda_ops.STENCIL_LAUNCHES == before


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    wrapper inspects before it needs the kernel library."""

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)


def test_stencils_on_cuda_raise_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernel: without nvcc the wrappers raise (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    rng = np.random.default_rng(7)
    parts, W4PL, W4PR = _small(rng)
    parts = [(_CudaTyped(v), u0) for v, u0 in parts]
    before = cuda_ops.STENCIL_LAUNCHES
    for fn, w in ((cuda_ops.stencil_pl, W4PL), (cuda_ops.stencil_pr, W4PR)):
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(parts, _CudaTyped(w), s=8, n=10, i0=0, TB=8, R=12)
    assert cuda_ops.STENCIL_LAUNCHES == before
