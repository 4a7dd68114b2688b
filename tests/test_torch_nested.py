"""The span's 2-D recurrences, bit for bit (tolerance zero: integer data):
``nested.compute_V_span``, ``gapped.compute_WBP_WPP_span``,
``nested.compute_WMv_WMp_WM_span`` and ``gapped._wx_tables`` of the port
(on the card ``cuda_ops.span_v`` / ``span_wbp`` / ``span_wm`` /
``wx_tables``, csrc/span2d.cu; here their plain versions) against the JAX
package's functions of the same names:

* tables of real sequences, each package's own (``build_seq_tables``,
  ``build_consts``; the port's through ``fold.consts_from_numpy``), on
  random int32 states with INF, TRI_UNSET, V_UNSET and negative cells
  sprinkled in, so that every guard (``guarded_add``'s ``== INF``, the
  getters, the ``< INF // 2`` writes) is hit; n in {16, 23}, spans 0, 2,
  3, 4, 5, a middle one and n - 1, dangles 0, 1 and 2; a batch of two
  sequences against two JAX calls;
* Vtype's first minimum on cells forced to H = I = M and I = M < H;
* csrc/span2d.cu's walk restated in Python (per live row: the kernel's
  (di, dj) enumeration, its multiloop, WBP / WPP and WM splits, the WB /
  WP weights computed inline, span_wbp's P write and kept tables' cells,
  span_wm's row cells loaded first and its splits in rounds, loads
  first, int32 sums that wrap) against the plain
  versions; span_v's closed-form walk of the interior terms against the
  plain version's mask for every L in [2, 32]; span_wm's rounds take
  every split once up to n = 260;
* the span body of small fills (dense n=20, odd n2, a batch of two,
  dangles 0 / 1 / 2, the packed layout): after every span's WBP/WPP
  update (the P split's minima into span_wbp), P2 / WBP / WPP against
  gapped3.compute_P_span3 + gapped.compute_WBP_WPP_span run apart and the
  JAX package's functions, the kept weight tables against _wx_tables from
  scratch and the JAX one;
* the fills' launch tables (cuda_ops.span2d_fill_tables): at every
  span of the dense, packed, batched, resumed fill4 and P=2 row-sharded
  fills every tensor a table points into keeps the data_ptr and strides
  packed into it; a launch through a table equals the checked path's
  table byte for byte; a table is taken only for the very tensors and
  scalars it was packed from (a swapped state entry, table, scalar or
  kept tables, or another state, takes the checked path); span_wm is a
  dependent launch only right after a
  span_store that launches and writes none of its operands (the call
  order recorded on the CPU path), never in the row-sharded fill;
* refusals of operands that do not fit; no launch counted on the CPU;
  CUDA operands without the kernel library raise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccj_tpu.engine import fold as jfold
from ccj_tpu.engine import gapped as jgapped
from ccj_tpu.engine import nested as jnested
from ccj_tpu.params import DEFAULT_PK as JPK
from ccj_tpu.params import parse_par as jparse
from ccj_tpu.params import scale_parameters as jscale
from ccj_tpu.precompute import build_seq_tables as jtables
from ccj_tpu_torch.engine import cuda_ops, fold, gapped, nested
from ccj_tpu_torch.engine.common import INF, MAXLOOP, TRI_UNSET, TURN, V_UNSET
from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
from ccj_tpu_torch.precompute import build_seq_tables

from oracle_util import REPO

torch.set_num_threads(1)

PAR = "ccj_tpu/params/rna_Turner04.par"
SEQS = {16: ("GCGCUUCGCCGCGCCA", "GGGAAACUUCGGUUCC"),
        23: ("GGGAAACGGGCGAUCCUUCCCGA", "GCAUCCGGAUGCAAAGCUUCGGC")}
KEYS_2D = ("V", "Vtype", "WM", "WMv", "WMp", "P2", "WBP", "WPP")
I32 = np.int32


def _spans(n):
    return (0, 2, 3, 4, 5, n // 2, n - 1)


@functools.cache
def _params(dangles):
    """(the JAX package's scaled parameters, the port's) at ``dangles``:
    each parameter file parsed once a module."""
    return (jscale(jparse(REPO / PAR), dangles=dangles),
            scale_parameters(parse_par(REPO / PAR), dangles=dangles))


@functools.cache
def _consts(seq, dangles):
    """(the JAX package's C as jnp arrays, the port's C without a batch
    axis) of ``seq``, each package's own chain from the parameter file;
    built once a module."""
    jsp, sp = _params(dangles)
    jC = jfold.build_consts(jtables(seq, jsp, JPK), jsp, JPK, device=False)
    jC = {k: jnp.asarray(np.asarray(v)) if not isinstance(v, int) else v
          for k, v in jC.items()}
    C_np = fold.build_consts(build_seq_tables(seq, sp, DEFAULT_PK), sp, DEFAULT_PK)
    C, _ = fold.consts_from_numpy(C_np, "cpu", sc4_np={})
    return jC, C


def _state(rng, B, n):
    """Random [B, n2, n2] 2-D state: energies in [-3000, 3000) with 10 %
    INF, 10 % TRI_UNSET and 5 % V_UNSET cells; Vtype in 0..3."""
    n2 = n + 2
    st = {}
    for k in KEYS_2D:
        if k == "Vtype":
            st[k] = rng.integers(0, 4, (B, n2, n2)).astype(np.int8)
            continue
        x = rng.integers(-3000, 3000, (B, n2, n2)).astype(I32)
        u = rng.random((B, n2, n2))
        x[u < 0.1] = INF
        x[(u >= 0.1) & (u < 0.2)] = TRI_UNSET
        x[(u >= 0.2) & (u < 0.25)] = V_UNSET
        st[k] = x
    return st


def _port(fn, Cs, st_np, *args):
    """The port's ``fn`` on a batch (one C per element) of numpy states;
    returns the state as numpy."""
    C = fold.stack_consts(Cs)
    st = {k: torch.from_numpy(v.copy()) for k, v in st_np.items()}
    out = fn(C, st, *args)
    assert out is st
    return {k: v.numpy() for k, v in st.items()}


def _jax(fn, jC, st_np, b, *args):
    """The JAX package's ``fn`` on element b of the numpy states."""
    out = fn(jC, {k: jnp.asarray(v[b]) for k, v in st_np.items()}, *args)
    return {k: np.asarray(out[k]) for k in KEYS_2D}


def _same(got, want, what):
    for k in KEYS_2D:
        bad = np.argwhere(got[k] != want[k])
        assert len(bad) == 0, (f"{what} {k}: {len(bad)} cells differ, first at "
                               f"{tuple(bad[0])}: port={got[k][tuple(bad[0])]} "
                               f"jax={want[k][tuple(bad[0])]}")


FUNCS = {"V": (nested.compute_V_span, jnested.compute_V_span, True),
         "WBP": (gapped.compute_WBP_WPP_span, jgapped.compute_WBP_WPP_span, False),
         "WM": (nested.compute_WMv_WMp_WM_span, jnested.compute_WMv_WMp_WM_span, True)}


SPAN_IDS = ["0", "2", "3", "4", "5", "mid", "n-1"]


@pytest.mark.parametrize("span", range(len(SPAN_IDS)), ids=SPAN_IDS)
@pytest.mark.parametrize("dangles", [0, 1, 2])
@pytest.mark.parametrize("n", sorted(SEQS))
@pytest.mark.parametrize("name", ["V", "WM"])
def test_nested_span_matches_jax(name, n, dangles, span):
    """compute_V_span / compute_WMv_WMp_WM_span at one span of
    :func:`_spans`, on its own random state."""
    port_fn, jax_fn, _ = FUNCS[name]
    jC, C = _consts(SEQS[n][0], dangles)
    s = _spans(n)[span]
    st = _state(np.random.default_rng(100 * n + 10 * dangles + s), 1, n)
    got = _port(port_fn, [C], st, s, dangles)
    want = _jax(jax_fn, jC, st, 0, s, dangles)
    _same({k: v[0] for k, v in got.items()}, want, f"{name} n={n} s={s} d={dangles}")
    changed = any((got[k] != st[k]).any() for k in KEYS_2D)
    assert changed == (s >= (1 if name == "V" else 3)), (name, s)


@pytest.mark.parametrize("span", range(len(SPAN_IDS)), ids=SPAN_IDS)
@pytest.mark.parametrize("n", sorted(SEQS))
def test_wbp_span_matches_jax(n, span):
    port_fn, jax_fn, _ = FUNCS["WBP"]
    jC, C = _consts(SEQS[n][0], 2)
    s = _spans(n)[span]
    st = _state(np.random.default_rng(7 * n + s), 1, n)
    got = _port(port_fn, [C], st, s)
    want = _jax(jax_fn, jC, st, 0, s)
    _same({k: v[0] for k, v in got.items()}, want, f"WBP n={n} s={s}")
    assert any((got[k] != st[k]).any() for k in KEYS_2D) == (s >= 1)


@pytest.mark.parametrize("n", sorted(SEQS))
def test_wx_tables_match_jax(n):
    jC, C = _consts(SEQS[n][0], 2)
    st = _state(np.random.default_rng(n), 1, n)
    got = gapped._wx_tables(fold.add_batch(C), {k: torch.from_numpy(v)
                                                for k, v in st.items()})
    want = jgapped._wx_tables(jC, {k: jnp.asarray(v[0]) for k, v in st.items()})
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (1, n + 2, n + 2)
        assert np.array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["V", "WBP", "WM", "WX"])
def test_batch_of_two_matches_two_jax_calls(name):
    """Two sequences of one length in one batch against each alone."""
    n, s, dangles = 23, 13, 1
    (jC0, C0), (jC1, C1) = (_consts(q, dangles) for q in SEQS[n])
    st = _state(np.random.default_rng(31), 2, n)
    if name == "WX":
        got = gapped._wx_tables(fold.stack_consts([C0, C1]),
                                {k: torch.from_numpy(v) for k, v in st.items()})
        for b, jC in enumerate((jC0, jC1)):
            want = jgapped._wx_tables(jC, {k: jnp.asarray(v[b]) for k, v in st.items()})
            for g, w in zip(got, want):
                assert np.array_equal(g[b].numpy(), np.asarray(w))
        return
    port_fn, jax_fn, takes_dangles = FUNCS[name]
    args = (s, dangles) if takes_dangles else (s,)
    got = _port(port_fn, [C0, C1], st, *args)
    for b, jC in enumerate((jC0, jC1)):
        _same({k: v[b] for k, v in got.items()}, _jax(jax_fn, jC, st, b, *args),
              f"{name} element {b}")


@pytest.mark.parametrize("dangles", [0, 2])
@pytest.mark.parametrize("h,eint,want_type", [(100, 100, 1), (101, 100, 2), (101, 101, 3)])
def test_vtype_takes_the_first_minimum(dangles, h, eint, want_type):
    """At one cell, H = h, every interior term EINT = eint (V = 0 inside)
    and the multiloop 40 + 60 = 100 (WM = WMv = WMp = 40, MB = 60): ties
    go to the first of H, I, M, as argmin takes them."""
    n, s, i = 23, 12, 4
    j = i + s
    jC, C = _consts(SEQS[n][0], dangles)
    st = _state(np.random.default_rng(5), 1, n)
    st["V"][:] = 0
    for k in ("WM", "WMv", "WMp"):
        st[k][:] = 40
    C = dict(C)
    jC = dict(jC)
    mb = "MB2" if dangles == 2 else "MB0"
    for k, val in (("H", h), (mb, 60)):
        x = C[k].clone()
        x[i, j] = val
        C[k] = x
        jC[k] = jnp.asarray(x.numpy())
    x = C["EINT"].clone()
    x[:, :, i, j] = eint
    C["EINT"] = x
    jC["EINT"] = jnp.asarray(x.numpy())
    assert C["MLbase"] >= 0         # the multiloop's minimum is its g = 1 term
    got = _port(nested.compute_V_span, [C], st, s, dangles)
    want = _jax(jnested.compute_V_span, jC, st, 0, s, dangles)
    _same({k: v[0] for k, v in got.items()}, want, "V")
    assert got["V"][0, i, j] == 100
    assert got["Vtype"][0, i, j] == want_type


# ---------------------------------------------------------------------------
# csrc/span2d.cu's walk, restated
# ---------------------------------------------------------------------------

def _wadd(*xs):
    """An int32 sum that wraps, as the kernels' (unsigned) adds do."""
    return (sum(int(x) for x in xs) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _gadd(base, add):
    return INF if base == INF else _wadd(base, add)


def _getm(M, a, b):
    return INF if a >= b else int(M[a, b])


def _mlstem(C, V, b, k, j, dangles):
    e = _gadd(INF if k >= j else int(V[k, j]),
              C["ML2" if dangles == 2 else "ML0"][b, k, j])
    if dangles == 1:
        ML = C["MLbase"]
        v1 = int(V[k + 1, j]) if (j - k - 1 > TURN and k + 1 < j) else INF
        e = min(e, _gadd(v1, _wadd(ML, C["ML_ip1"][b, k, j])))
        v2 = int(V[k, j - 1]) if (j - 1 - k > TURN and k < j - 1) else INF
        e = min(e, _gadd(v2, _wadd(ML, C["ML_jm1"][b, k, j])))
        v3 = int(V[k + 1, j - 1]) if (j - k - 2 > TURN and k + 1 < j - 1) else INF
        e = min(e, _gadd(v3, _wadd(2 * ML, C["ML_both"][b, k, j])))
    return e


V_THREADS, V_TERMS = 128, 4    # csrc/span2d.cu kThreads, kVTerms


def _interior_term(q, L, nq):
    """csrc/span2d.cu interior_term: the admissible (di, dj) of term q, in
    float32 as the kernel's sqrtf takes it."""
    p = nq - 1 - q
    f32 = np.float32
    k = int((np.sqrt(f32(8) * f32(p) + f32(1), dtype=f32) - f32(1)) * f32(0.5))
    di = L - 1 - k
    return di, 1 + k - (p - k * (k + 1) // 2)


def _kernel_v(C, st, s, dangles):
    """span_v_kernel: per live row each thread takes the admissible
    interior terms q = tid + k * threads (k < kVTerms) through
    interior_term, and the multiloop splits g = 1 + tid + k * threads in
    rounds of two; then the block's minima."""
    threads = V_THREADS
    n = C["n"]
    E = C["EINT"]
    for b in range(st["V"].shape[0]):
        V, WM, WMv, WMp = (st[k][b] for k in ("V", "WM", "WMv", "WMp"))
        for i in range(1, n - s + 1):
            j = i + s
            ei = [INF] * threads
            L = min(MAXLOOP + 2, s - TURN - 1)
            nq = L * (L - 1) // 2 if L >= 2 else 0
            for t in range(threads):
                for k in range(V_TERMS):
                    q = t + k * threads
                    if q < nq:
                        di, dj = _interior_term(q, L, nq)
                        ei[t] = min(ei[t], _wadd(E[b, di, dj, i, j], V[i + di, j - dj]))
            assert nq <= V_TERMS * threads
            em = [INF] * threads
            if s >= 4:
                ML = C["MLbase"]
                mb = int(C["MB2" if dangles == 2 else "MB0"][b, i, j])
                for t in range(threads):
                    for g0 in range(1 + t, s - 2, 2 * threads):
                        for g in (g0, g0 + threads):
                            if g > s - 3:
                                continue
                            c, gm1, gm2 = i + g, (g - 1) * ML, (g - 2) * ML
                            w1, p1 = _getm(WM, i + 1, c - 1), _getm(WMp, c, j - 1)
                            e = _gadd(min(_wadd(w1, _getm(WMv, c, j - 1)), _wadd(w1, p1),
                                          _wadd(gm1, p1)), mb)
                            if dangles == 1:
                                w2 = _getm(WM, i + 2, c - 1)
                                e = min(e, _gadd(min(_wadd(w2, _getm(WMv, c, j - 1)),
                                                     _wadd(w2, _getm(WMp, c - 1, j - 1)),
                                                     _wadd(gm2, p1)), int(C["MB_5"][b, i, j])))
                                v2, p2 = _getm(WMv, c, j - 2), _getm(WMp, c, j - 2)
                                e = min(e, _gadd(min(_wadd(w1, v2), _wadd(w1, p2),
                                                     _wadd(gm1, p2)), int(C["MB_3"][b, i, j])))
                                e = min(e, _gadd(min(_wadd(w2, v2), _wadd(w2, p2),
                                                     _wadd(gm2, p2)), int(C["MB_53"][b, i, j])))
                            em[t] = min(em[t], e)
            vmin, rank = int(C["H"][b, i, j]), 0
            if min(ei) < vmin:
                vmin, rank = min(ei), 1
            if min(em) < vmin:
                vmin, rank = min(em), 2
            ok = vmin < INF // 2
            V[i, j] = vmin if ok else V_UNSET
            st["Vtype"][b][i, j] = rank + 1 if ok else 0


def _kernel_wbp(C, st, s, p_min=None, wx=None):
    """span_wbp_kernel: thread 0 sets P(i, l) from p_min (below INF / 2)
    and takes it for the g = 0 term; the WB / WP weights from WBP / WPP
    inline; thread 0 writes WBP, WPP and the kept tables' span-s cell from
    the value each cell now holds."""
    n = C["n"]
    for b in range(st["V"].shape[0]):
        V, P2, WBP, WPP = (st[k][b] for k in ("V", "P2", "WBP", "WPP"))
        for i in range(1, n - s + 1):
            l = i + s
            if p_min is not None and p_min[b, i] < INF // 2:
                P2[i, l] = p_min[b, i]
            r0 = r1 = INF
            for g in range(s):
                d = i + g
                vdl, pdl = int(V[d, l]), int(P2[d, l])
                if g > 0:
                    wb = min(C["cp"] * g, int(WBP[i, d - 1]))
                    wp = min(C["PUP"] * g, int(WPP[i, d - 1]))
                else:
                    wb = wp = 0 if d - 1 >= 1 else INF
                r0 = min(r0, _wadd(wb, vdl, C["bp"], C["PPS"]),
                         _wadd(wb, pdl, C["PSM"], C["PPS"]))
                r1 = min(r1, _wadd(wp, vdl, C["PPS"]), _wadd(wp, pdl, C["PSP"], C["PPS"]))
            wbp = min(r0, _wadd(int(WBP[i, l - 1]) if s >= 1 else INF, C["cp"]))
            wpp = min(r1, _wadd(int(WPP[i, l - 1]) if s >= 1 else INF, C["PUP"]))
            if wbp < INF // 2:
                WBP[i, l] = wbp
            if wpp < INF // 2:
                WPP[i, l] = wpp
            if wx is not None:
                wx[:, b, i, l] = (min(C["cp"] * (s + 1), WBP[i, l]),
                                  min(C["PUP"] * (s + 1), WPP[i, l]), WBP[i, l], WPP[i, l])


# csrc/span2d.cu span_wm: a block of 128 threads a row (kThreads), two
# splits a thread and round (kWMTerms)
WM_LANES, WM_TERMS = 128, 2


def _wm_load(C, b, st, i, j, k, dangles):
    """wm_load: E_MLStem(k, j)'s V and ML cells (at dangles 1 the three
    other V cells and their ML tables only where E_MLStem takes them, INF
    and 0 otherwise), P2(k, j), WM(i, k - 1) (INF for i >= k - 1)."""
    V = st["V"][b]
    m = {"v0": _getm(V, k, j), "m0": int(C["ML2" if dangles == 2 else "ML0"][b, k, j]),
         "p": int(st["P2"][b][k, j]),
         "w": INF if i >= k - 1 else int(st["WM"][b][i, k - 1]),
         "v": [INF] * 3, "m": [0] * 3}
    if dangles == 1:
        for q, (cond, a, c, tab) in enumerate(((j - k - 1 > TURN, k + 1, j, "ML_ip1"),
                                               (j - 1 - k > TURN, k, j - 1, "ML_jm1"),
                                               (j - k - 2 > TURN, k + 1, j - 1, "ML_both"))):
            if cond:
                m["v"][q], m["m"][q] = int(V[a, c]), int(C[tab][b, k, j])
    return m


def _wm_stem(m, ML, dangles):
    """wm_stem: E_MLStem of the loaded cells."""
    e = _gadd(m["v0"], m["m0"])
    if dangles == 1:
        for q, times in enumerate((1, 1, 2)):
            e = min(e, _gadd(m["v"][q], _wadd(times * ML, m["m"][q])))
    return e


def _wm_rounds(s, lanes, terms):
    """Each lane's rounds of WM splits g in [0, s - TURN - 1]: lists of the
    g a round loads before its first min."""
    return [[[g0 + q * lanes for q in range(terms) if g0 + q * lanes <= s - TURN - 1]
             for g0 in range(lane, s - TURN, terms * lanes)] for lane in range(lanes)]


def _kernel_wm(C, st, s, dangles):
    """span_wm_kernel: thread 0 loads its row's own cells first (E_MLStem(i,
    j)'s and P2(i, j) through wm_load at k = i, WMv / WMp / WM(i, j - 1));
    every thread walks its rounds of splits (:func:`_wm_rounds`), all loads
    of a round before its first min; the row's minimum of the threads',
    then thread 0 writes WMv, WMp and WM."""
    n = C["n"]
    if s < 3:
        return
    ML, psmb = C["MLbase"], C["PSM"] + C["b"]
    rounds = _wm_rounds(s, WM_LANES, WM_TERMS)
    for b in range(st["V"].shape[0]):
        WM, WMv, WMp = (st[k][b] for k in ("WM", "WMv", "WMp"))
        for i in range(1, n - s + 1):
            j = i + s
            own = _wm_load(C, b, st, i, j, i, dangles)
            prev = int(WMv[i, j - 1]), int(WMp[i, j - 1]), int(WM[i, j - 1])
            red = [INF] * WM_LANES
            for lane, lane_rounds in enumerate(rounds):
                for gs in lane_rounds:
                    loads = [_wm_load(C, b, st, i, j, i + g, dangles) for g in gs]
                    for g, m in zip(gs, loads):
                        stem, wmb = _wm_stem(m, ML, dangles), _wadd(m["p"], psmb)
                        red[lane] = min(red[lane], _wadd(g * ML, stem), _wadd(g * ML, wmb),
                                        _wadd(m["w"], stem), _wadd(m["w"], wmb))
            WMv[i, j] = min(_wm_stem(own, ML, dangles), _wadd(prev[0], ML))
            WMp[i, j] = min(_wadd(own["p"], psmb), _wadd(prev[1], ML))
            WM[i, j] = min(min(red), _wadd(prev[2], ML))


def test_wm_rounds_take_every_split_once():
    """span_wm's rounds visit every split g in [0, s - TURN - 1] once, at
    most kWMTerms a thread and round, for every span s >= 3 up to n = 260,
    in one round there (s - 3 <= 256)."""
    for s in range(3, 260):
        rounds = _wm_rounds(s, WM_LANES, WM_TERMS)
        got = [g for lane_rounds in rounds for gs in lane_rounds for g in gs]
        assert sorted(got) == list(range(s - TURN)), s
        assert all(1 <= len(gs) <= WM_TERMS for lane_rounds in rounds for gs in lane_rounds)
        assert max(len(r) for r in rounds) == (s > 3), s      # s = 3: no split


@pytest.mark.parametrize("dangles", [0, 1, 2])
@pytest.mark.parametrize("name", ["V", "WBP", "WM"])
def test_kernel_walk_restated_matches_plain(name, dangles):
    """The kernels' walks, restated row by row in Python, against the
    plain versions on random states at n = 16 (B = 2, spans 1 .. n - 1;
    span_wbp with and without the P-split minima and the kept tables)."""
    n = 16
    Cs = [_consts(q, dangles)[1] for q in SEQS[n]]
    C = fold.stack_consts(Cs)
    Cn = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in C.items()}
    kernel = {"V": _kernel_v, "WBP": _kernel_wbp, "WM": _kernel_wm}[name]
    plain = {"V": cuda_ops.span_v_ref, "WBP": cuda_ops.span_wbp_ref,
             "WM": cuda_ops.span_wm_ref}[name]
    for s in range(1, n):
        rng = np.random.default_rng(s + 50 * dangles)
        st = _state(rng, 2, n)
        args = (s,) if name == "WBP" else (s, dangles)
        extra = [{}]
        if name == "WBP":
            p_min = rng.integers(-3000, 3000, (2, n + 2)).astype(I32)
            p_min[rng.random((2, n + 2)) < 0.3] = INF
            wx = cuda_ops.wx_tables_ref(C, {k: torch.from_numpy(v) for k, v in st.items()})
            extra.append({"p_min": p_min, "wx": wx.numpy()})
        for kw in extra:
            mine = {k: v.copy() for k, v in st.items()}
            kw_mine = {k: v.copy() for k, v in kw.items()}
            kernel(Cn, mine, *args, **kw_mine)
            want = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
            kw_plain = {k: torch.from_numpy(v.copy()) for k, v in kw.items()}
            plain(C, want, *args, **kw_plain)
            _same(mine, {k: v.numpy() for k, v in want.items()}, f"{name} s={s} {sorted(kw)}")
            if "wx" in kw:
                assert np.array_equal(kw_mine["wx"], kw_plain["wx"].numpy()), s


def test_wx_kernel_rule_restated():
    """wx_kernel's per-cell rule against the plain tables."""
    n = 16
    C = fold.stack_consts([_consts(q, 2)[1] for q in SEQS[n]])
    st = _state(np.random.default_rng(3), 2, n)
    got = cuda_ops.wx_tables_ref(C, {k: torch.from_numpy(v) for k, v in st.items()})
    for b in range(2):
        for a in range(n + 2):
            for c in range(n + 2):
                inb = 1 <= a <= n and 1 <= c <= n
                rb, rp = int(st["WBP"][b, a, c]), int(st["WPP"][b, a, c])
                want = (INF if not inb else 0 if a > c else min(C["cp"] * (c - a + 1), rb),
                        INF if not inb else 0 if a > c else min(C["PUP"] * (c - a + 1), rp),
                        INF if a > c else rb, INF if a > c else rp)
                assert tuple(int(x[b, a, c]) for x in got) == want


@pytest.mark.parametrize("L", range(2, MAXLOOP + 3))
def test_interior_enumeration_restated_matches_the_plain_mask(L):
    """span_v's walk of the interior terms (interior_term, restated): the
    q in [0, L(L-1)/2) give each admissible (di, dj) of the plain
    version's mask once, di-major with dj rising (so a warp's V reads run
    along a row), within kVTerms a thread at 128 threads."""
    s = L + TURN + 1                    # the span whose loops reach di + dj <= L
    assert min(MAXLOOP + 2, s - TURN - 1) == L
    nq = L * (L - 1) // 2
    got = [_interior_term(q, L, nq) for q in range(nq)]
    di = np.arange(MAXLOOP + 2)[:, None]
    dj = np.arange(MAXLOOP + 2)[None, :]
    mask = ((di >= 1) & (dj >= 1) & (di <= MAXLOOP + 1) & (di + dj <= MAXLOOP + 2)
            & (di + dj <= s - TURN - 1))
    assert sorted(got) == got == [tuple(map(int, x)) for x in np.argwhere(mask)]
    assert nq <= V_TERMS * V_THREADS


# ---------------------------------------------------------------------------
# the span body: the P split's minima into span_wbp, the kept weight tables
# ---------------------------------------------------------------------------

# small fills, each with its own span steps: (n, dangles, batch, packed)
SPAN_BODY_FILLS = {"dense n=20": (20, 2, 1, False), "odd n2 (n=17) dangles 0": (17, 0, 1, False),
                   "batch of two n=16 dangles 1": (16, 1, 2, False),
                   "packed n=16": (16, 2, 1, True)}
_JAX_SPAN = {}


def _jax_span(n):
    """The JAX package's compute_P_span3 + compute_WBP_WPP_span (P2, WBP,
    WPP after span s) and its _wx_tables, each jitted once for length n,
    with its own PK penalties (the only entries of C they read)."""
    if n not in _JAX_SPAN:
        import jax

        from ccj_tpu.engine import gapped3 as jgapped3

        jC = {"n": n, **{k: getattr(JPK, k) for k in ("PSM", "PSP", "PUP", "PPS", "bp", "cp")}}

        def span(st, s):
            out = jgapped.compute_WBP_WPP_span(jC, jgapped3.compute_P_span3(jC, st, s), s)
            return out["P2"], out["WBP"], out["WPP"]

        _JAX_SPAN[n] = (jax.jit(span), jax.jit(lambda st: jnp.stack(jgapped._wx_tables(jC, st))))
    return _JAX_SPAN[n]


@pytest.mark.parametrize("case", list(SPAN_BODY_FILLS))
def test_span_body_matches_p_split_and_wbp_apart_and_jax(case, monkeypatch):
    """A small fill's span body (fold._run_spans: the P split's minima into
    span_wbp, the weight tables kept by it), checked after every span's
    WBP/WPP update: P2, WBP and WPP equal gapped3.compute_P_span3 +
    gapped.compute_WBP_WPP_span run apart on the state before it (no kept
    tables) and the JAX package's functions on the same state; the kept
    tables equal gapped._wx_tables from scratch and the JAX one.  Minima
    only on the spans with a P-split term (3 <= s < n); span_v a dependent
    launch from the fill's second span on."""
    from ccj_tpu_torch.engine import gapped3, gapped5

    n, dangles, B, packed = SPAN_BODY_FILLS[case]
    sp = _params(dangles)[1]
    rng = np.random.default_rng(n + 10 * B)
    consts = [fold.consts_from_numpy(fold.build_consts(build_seq_tables(
        "".join("ACGU"[k] for k in rng.integers(0, 4, n)), sp, DEFAULT_PK), sp, DEFAULT_PK),
        "cpu") for _ in range(B)]
    jspan, jwx = _jax_span(n)
    real = fold.compute_WBP_WPP_span
    seen = []

    def checked(C, st, s, p_min=None):
        assert (p_min is not None) == (3 <= s < n), s
        before = {k: st[k].clone() for k in ("V", "P2", "WBP", "WPP")}
        real(C, st, s, p_min)
        bare = {k: v for k, v in C.items() if k != gapped.WX}
        apart = {**before, "PKD": st["PKD"], "PKE": st["PKE"]}
        gapped.compute_WBP_WPP_span(bare, gapped3.compute_P_span3(bare, apart, s), s)
        for k in ("P2", "WBP", "WPP"):
            assert torch.equal(st[k], apart[k]), (case, s, k)
        assert torch.equal(C[gapped.WX], gapped._wx_tables(bare, st)), (case, s)
        for b in range(B):
            want = jspan({k: jnp.asarray(v[b].numpy()) for k, v in apart.items()
                          if k in ("PKD", "PKE")} | {k: jnp.asarray(v[b].numpy())
                                                      for k, v in before.items()}, s)
            for k, w in zip(("P2", "WBP", "WPP"), want):
                assert np.array_equal(st[k][b].numpy(), np.asarray(w)), (case, s, b, k)
            wx = jwx({k: jnp.asarray(st[k][b].numpy()) for k in ("WBP", "WPP")})
            assert np.array_equal(C[gapped.WX][:, b].numpy(), np.asarray(wx)), (case, s, b)
        seen.append(s)
        return st

    real_v, launches = fold.compute_V_span, []

    def v_span(C, st, s, d, dependent=False):
        launches.append(dependent)
        return real_v(C, st, s, d, dependent)

    monkeypatch.setattr(fold, "compute_WBP_WPP_span", checked)
    monkeypatch.setattr(fold, "compute_V_span", v_span)
    if B > 1:
        fold.fill6_batched(fold.stack_consts([c for c, _ in consts]),
                           fold.stack_consts([s4 for _, s4 in consts]), n, dangles)
    elif packed:
        fold.fill7(*consts[0], n, dangles, gapped5.segments7(n))
    else:
        fold.fill6(*consts[0], n, dangles)
    assert seen == list(range(n))
    assert launches == [False] + [True] * (n - 1)


def test_sharded_fill_keeps_one_table_home_and_launches_span_v_dependent(monkeypatch):
    """A P=2 row-sharded fill (n=14, one CPU device): span_v a dependent
    launch from its second span on, and the weight tables kept in the one
    home, the device's tables' dict (st.consts), equal to gapped._wx_tables
    of its replica after the fill."""
    from ccj_tpu_torch.dist import wavefront

    n = 14
    sp = _params(2)[1]
    C, SC4 = fold.consts_from_numpy(fold.build_consts(build_seq_tables(
        SEQS[16][0][:n], sp, DEFAULT_PK), sp, DEFAULT_PK), "cpu")
    real_v, launches = wavefront.compute_V_span, []

    def v_span(C, st, s, d, dependent=False):
        launches.append(dependent)
        return real_v(C, st, s, d, dependent)

    monkeypatch.setattr(wavefront, "compute_V_span", v_span)
    st = wavefront.fill6_sharded(C, SC4, n, sp.dangles, devices=["cpu"] * 2)
    assert launches == [False] + [True] * (n - 1)
    (dev, Cd), = st.consts.items()
    assert torch.equal(Cd[gapped.WX], gapped._wx_tables(Cd, st.replicas[dev]))


# ---------------------------------------------------------------------------
# the fills' launch tables and span_wm's dependent launch
# ---------------------------------------------------------------------------

FILL_CASES = ("dense n=16", "packed n=16", "batch of two n=16", "fill4 resumed at span 8",
              "row-sharded P=2 n=14")


class _Stop(Exception):
    pass


def _fill_case(case, ckpt):
    """(the module whose span functions the fill looks up, a callable
    running the fill on the CPU, the spans its span_wm calls take): one of
    :data:`FILL_CASES` at dangles 2.  The resumed ``fill4`` snapshots every
    4 spans, stops after span 9 and resumes from its span-8 snapshot."""
    from ccj_tpu_torch.dist import wavefront
    from ccj_tpu_torch.engine import gapped5

    sp = _params(2)[1]

    def consts(seq):
        return fold.consts_from_numpy(fold.build_consts(build_seq_tables(
            seq, sp, DEFAULT_PK), sp, DEFAULT_PK), "cpu")

    if case == "row-sharded P=2 n=14":
        C, SC4 = consts(SEQS[16][0][:14])
        return wavefront, lambda: wavefront.fill6_sharded(C, SC4, 14, 2, ["cpu"] * 2), \
            list(range(14))
    n = 16
    (C, SC4), (C1, SC41) = consts(SEQS[n][0]), consts(SEQS[n][1])
    if case == "dense n=16":
        return fold, lambda: fold.fill6(C, SC4, n, 2), list(range(n))
    if case == "packed n=16":
        return fold, lambda: fold.fill7(C, SC4, n, 2, gapped5.segments7(n)), list(range(n))
    if case == "batch of two n=16":
        return fold, lambda: fold.fill6_batched(fold.stack_consts([C, C1]),
                                                fold.stack_consts([SC4, SC41]), n, 2), \
            list(range(n))

    def resumed():
        def stop(s, _dt):
            if s == 9:
                raise _Stop
        with pytest.raises(_Stop):
            fold.fill4(C, SC4, n, 2, checkpoint_dir=ckpt, checkpoint_every=4, on_span=stop)
        return fold.fill4(C, SC4, n, 2, checkpoint_dir=ckpt, checkpoint_every=4)

    return fold, resumed, list(range(10)) + list(range(8, n))


@pytest.mark.parametrize("case", FILL_CASES)
def test_fill_tables_point_into_tensors_that_keep_their_storage(case, monkeypatch, tmp_path):
    """Every span of the fill's loop (checked at its span_wm call, the
    span's last): C holds the three launch tables packed at the loop's
    start (cuda_ops.span2d_fill_tables), the wrappers take them for the
    fill's state, and every operand each table points into -- the state's
    2-D arrays, the fill's tables, EINT cell-major, the kept weight tables
    -- still has the data_ptr and strides packed into it: the loop swaps
    no tensor."""
    mod, run, spans = _fill_case(case, str(tmp_path))
    real, seen, built = mod.compute_WMv_WMp_WM_span, [], set()

    def checked(C, st, s, d, dependent=False):
        tabs = C[cuda_ops.SPAN2D_FILL]
        built.add(id(tabs))
        assert sorted(tabs) == ["span_v", "span_wbp", "span_wm"]
        for kind, t in tabs.items():
            kw = {"out": C[gapped.WX]} if kind == "span_wbp" else {"dangles": d}
            assert cuda_ops._fill_table(C, st, kind, **kw) is t, (case, s, kind)
            tb = t.table
            assert (tb.kind, tb.n, tb.B) == (cuda_ops.SPAN2D_KINDS.index(kind), C["n"],
                                             st["V"].shape[0])
            for state, name, held in t.reads:
                x = (st if state else C)[name]
                assert x is held, (case, s, kind, name)
                k, sd = cuda_ops._SPAN2D_SLOT[name], x.stride()
                assert (tb.p[k], tb.bs[k], tb.rs[k], tb.cs[k]) == (
                    x.data_ptr(), sd[0], sd[-2], sd[-1]), (case, s, kind, name)
                if name == "EINT":
                    assert (tb.edi, tb.edj) == sd[1:3]
            if kind == "span_wbp":
                assert tb.p[-1] == C[gapped.WX].data_ptr() and t.out is C[gapped.WX]
        seen.append(s)
        return real(C, st, s, d, dependent)

    monkeypatch.setattr(mod, "compute_WMv_WMp_WM_span", checked)
    run()
    assert seen == spans
    # one set of tables a span loop: the resumed fill4 builds its own
    assert len(built) == (2 if "resumed" in case else 1)


@pytest.mark.parametrize("case", FILL_CASES)
def test_span_wm_is_a_dependent_launch_only_right_after_a_span_store(case, monkeypatch,
                                                                       tmp_path):
    """The order the fill's span body dispatches, recorded on the CPU path:
    every span_wm call that asks for the dependent launch (fold._run_spans:
    every span) comes right after a span_store, with no aten op (on the
    card: a kernel) between them, and that span_store launches (its
    destinations are not empty: cuda_ops.store_table's blocks > 0) and
    writes none of span_wm's operands; the row-sharded fill launches
    span_wm plainly."""
    from torch.utils._python_dispatch import TorchDispatchMode

    mod, run, spans = _fill_case(case, str(tmp_path))
    events, inside = [], []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside and not func.is_view:
                events.append(("op", str(func)))
            return func(*args, **(kwargs or {}))

    def spy(name, real):
        def call(*a, **kw):
            inside.append(name)
            try:
                return real(*a, **kw)
            finally:
                inside.pop()
                if not inside:
                    events.append((name, a, kw))
        return call

    real_store, real_wm = cuda_ops.span_store, cuda_ops.span_wm
    monkeypatch.setattr(cuda_ops, "span_store", spy("span_store", real_store))
    monkeypatch.setattr(cuda_ops, "span_wm", spy("span_wm", real_wm))
    with Record():
        run()
    wm = [(k, e) for k, e in enumerate(events) if e[0] == "span_wm"]
    assert [e[1][2] for _, e in wm] == spans
    dependent = [len(e[1]) > 4 and e[1][4] for _, e in wm]
    assert dependent == [not case.startswith("row-sharded")] * len(spans), case
    for k, (_, a, _kw) in wm:
        if not a[4]:
            continue
        kind, sa, skw = events[k - 1]
        assert kind == "span_store", (case, a[2], kind)
        dests, loops, xs = sa
        assert cuda_ops.store_table(dests, loops, xs, **skw)[1] > 0
        C, st = a[0], a[1]
        operands = {(st[nm] if nm in cuda_ops._SPAN2D_STATE else C[nm]).untyped_storage()
                    .data_ptr() for nm in cuda_ops._SPAN2D_READS["span_wm", a[3]]}
        assert not operands & {d.view.untyped_storage().data_ptr() for d in dests}


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _small(B=1, n=16, dangles=2):
    C = fold.stack_consts([_consts(SEQS[n][0], dangles)[1]] * B)
    st = {k: torch.from_numpy(v) for k, v in _state(np.random.default_rng(1), B, n).items()}
    return C, st


def _counts():
    return (cuda_ops.SPAN_V_LAUNCHES, cuda_ops.SPAN_WBP_LAUNCHES, cuda_ops.SPAN_WM_LAUNCHES,
            cuda_ops.WX_LAUNCHES)


def test_cpu_tensors_run_the_plain_versions_and_count_nothing(monkeypatch):
    C, st = _small(B=2)
    want = {k: v.clone() for k, v in st.items()}
    calls = []
    for name in ("span_v_ref", "span_wbp_ref", "span_wm_ref", "wx_tables_ref"):
        real = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name,
                            lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    before = _counts()
    nested.compute_V_span(C, st, 9, 2)
    gapped.compute_WBP_WPP_span(C, st, 9)
    nested.compute_WMv_WMp_WM_span(C, st, 9, 2)
    gapped._wx_tables(C, st)
    assert _counts() == before
    assert calls == ["span_v_ref", "span_wbp_ref", "wx_tables_ref", "span_wm_ref",
                     "wx_tables_ref"]
    cuda_ops.span_v_ref(C, want, 9, 2)
    cuda_ops.span_wbp_ref(C, want, 9)
    cuda_ops.span_wm_ref(C, want, 9, 2)
    for k in KEYS_2D:
        assert torch.equal(st[k], want[k]), k


@pytest.mark.parametrize("fault", ["dtype", "shape", "vtype", "eint", "device", "n",
                                   "dangles", "p_min", "wx"])
def test_wrappers_refuse_operands_that_do_not_fit(fault):
    C, st = _small()
    C, st = dict(C), dict(st)
    if fault == "dtype":
        st["WM"] = st["WM"].to(torch.int64)
    elif fault == "shape":
        st["P2"] = st["P2"][:, :-1]
    elif fault == "vtype":
        st["Vtype"] = st["Vtype"].to(torch.int32)
    elif fault == "eint":
        C["EINT"] = C["EINT"][:, :31]
    elif fault == "device":
        st["WBP"] = st["WBP"].to("meta")
    elif fault == "n":
        C["n"] = 15
    elif fault == "wx":                 # kept tables must be contiguous
        C[gapped.WX] = torch.zeros((4, 1, 18, 18), dtype=torch.int32).transpose(2, 3)
    p_min = torch.zeros((1, 17 if fault == "p_min" else 18), dtype=torch.int32)
    calls = [lambda: nested.compute_V_span(C, st, 9, 2),
             lambda: gapped.compute_WBP_WPP_span(C, st, 9, p_min),
             lambda: nested.compute_WMv_WMp_WM_span(C, st, 9, 2),
             lambda: gapped._wx_tables(C, st)]
    if fault == "dangles":
        calls = [lambda: nested.compute_V_span(C, st, 9, 3),
                 lambda: nested.compute_WMv_WMp_WM_span(C, st, 9, -1)]
    reads = {"dtype": (0, 2), "shape": (1, 2), "vtype": (0,), "eint": (0,),
             "device": (1, 3), "n": (0, 1, 2, 3), "dangles": (0, 1), "p_min": (1,),
             "wx": (1,)}[fault]
    for k in reads:
        with pytest.raises((ValueError, TypeError)):
            calls[k]()


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without one: what the
    wrappers inspect before they need the kernel library, and what a
    launch takes of a CPU tensor (its pointer and strides)."""

    def __init__(self, x):
        self.x, self.shape, self.dtype = x, x.shape, x.dtype
        self.device = torch.device("cuda", 0)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)

    def data_ptr(self):
        return self.x.data_ptr()

    def stride(self):
        return self.x.stride()


def test_cuda_operands_raise_without_the_library(monkeypatch, tmp_path):
    """CUDA operands need the kernels: without nvcc the wrappers raise (no
    plain fallback) and nothing is counted."""
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    C, st = _small()
    C = {k: _CudaTyped(v) if isinstance(v, torch.Tensor) else v for k, v in C.items()}
    st = {k: _CudaTyped(v) for k, v in st.items()}
    before = _counts()
    for call in (lambda: nested.compute_V_span(C, st, 9, 2),
                 lambda: gapped.compute_WBP_WPP_span(C, st, 9),
                 lambda: nested.compute_WMv_WMp_WM_span(C, st, 9, 1),
                 lambda: gapped._wx_tables(C, st)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert _counts() == before


def test_table_mirrors_the_kernel_layout():
    """Span2dTable: 22 operand slots (pointer and batch, row and column
    strides; span_wbp's P-split minima and the out slot last), EINT's two
    inner strides, then the 15 ints, every field packed by one struct
    format."""
    import ctypes
    assert len(cuda_ops.SPAN2D_OPERANDS) == 22
    assert cuda_ops.SPAN2D_OPERANDS[-2:] == ("p_min", "out")
    # the 15 ints end 4 bytes short of the struct's 8-byte alignment
    assert ctypes.sizeof(cuda_ops.Span2dTable) == 22 * 32 + 16 + 15 * 4 + 4
    assert cuda_ops._SPAN2D_FMT.size == cuda_ops.Span2dTable.cp.offset + 4
    for kind in cuda_ops.SPAN2D_KINDS:
        for d in (0, 1, 2):
            assert set(cuda_ops._SPAN2D_READS[kind, d]) <= set(cuda_ops.SPAN2D_OPERANDS)


@pytest.mark.parametrize("kind", ["span_v", "span_wbp", "span_wm"])
def test_fill_table_launch_equals_the_checked_launch(monkeypatch, kind):
    """A fill's launch table (cuda_ops.Span2dFill), packed once, and then
    only its span fields written (s, dangles, dependent, span_wbp's P-split
    minima), gives at two spans the bytes the checked path packs for the
    same call; the wrapper takes it for the fill's state (on a card: here
    the table's device is set to cuda:0 and the launch captured), counts
    each launch, and takes the checked path for another state."""
    import ctypes

    packed = []
    monkeypatch.setattr(cuda_ops, "_library", lambda: type("Lib", (), {"ccj_span2d": None}))
    monkeypatch.setattr(cuda_ops, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(cuda_ops, "_launch", lambda fn, dev, what, addr, stream: packed.append(
        bytes((ctypes.c_char * ctypes.sizeof(cuda_ops.Span2dTable)).from_address(addr))))
    counter = {"span_v": "SPAN_V_LAUNCHES", "span_wbp": "SPAN_WBP_LAUNCHES",
               "span_wm": "SPAN_WM_LAUNCHES"}[kind]
    monkeypatch.setattr(cuda_ops, counter, 0)
    dangles = 1
    C, st = _small(B=2, dangles=dangles)
    C = nested.cell_major_eint({**C})
    C[gapped.WX] = cuda_ops.wx_tables_ref(C, st)
    C[cuda_ops.SPAN2D_FILL] = cuda_ops.span2d_fill_tables(C, st, dangles)
    ft = C[cuda_ops.SPAN2D_FILL][kind]
    ft.dev = torch.device("cuda", 0)
    p_min = torch.arange(2 * 18 * 3, dtype=torch.int32).reshape(2, 18, 3)[..., 1]
    calls = [(9, True, p_min), (10, False, None)]
    for s, dependent, pm in calls:
        if kind == "span_wbp":
            cuda_ops.span_wbp(C, st, s, None if pm is None else _CudaTyped(pm), C[gapped.WX])
        else:
            getattr(cuda_ops, kind)(C, st, s, dangles, dependent)
        _dev, names, xs = cuda_ops.span2d_operands(C, st, kind, dangles)
        cuda_ops._span2d_launch(kind, C, s, 0 if kind == "span_wbp" else dangles, names, xs,
                                ft.dev, out=C[gapped.WX] if kind == "span_wbp" else False,
                                p_min=pm if kind == "span_wbp" else None,
                                dependent=dependent and kind != "span_wbp")
        assert packed[-2] == packed[-1], (kind, s)
    assert getattr(cuda_ops, counter) == len(calls)
    other = {k: v.clone() for k, v in st.items()}
    assert cuda_ops._fill_table(C, other, kind, dangles=0 if kind == "span_wbp" else dangles,
                                out=C[gapped.WX] if kind == "span_wbp" else None) is None
    assert cuda_ops._fill_table(C, st, kind, dangles=0 if kind == "span_wbp" else dangles,
                                out=C[gapped.WX] if kind == "span_wbp" else None) is ft


SWAPS = {   # what a call changes after the fill's tables were packed: the kinds it stales
    "state entry reassigned": ("span_v", "span_wbp", "span_wm"),
    "a table in a copy of C": ("span_v", "span_wm"),
    "a scalar in a copy of C": ("span_v", "span_wbp", "span_wm"),
    "other kept tables": ("span_wbp",),
    "another state": ("span_v", "span_wbp", "span_wm"),
}


@pytest.mark.parametrize("swap", sorted(SWAPS))
@pytest.mark.parametrize("kind", ["span_v", "span_wbp", "span_wm"])
def test_fill_table_is_not_taken_after_a_swap(monkeypatch, swap, kind):
    """A fill's launch table holds the tensors it points into and is taken
    only for those very tensors and scalars (cuda_ops.Span2dFill.fits):
    after a state entry is reassigned, in a copy of C that carries the
    tables with another operand or scalar, for other kept tables or on
    another state, a wrapper whose operands changed takes the checked path
    (here the CPU's plain version: no launch from the stale table, the
    plain version's cells), and one whose operands did not still launches
    through its table."""
    import ctypes

    launched = []
    monkeypatch.setattr(cuda_ops, "_library", lambda: type("Lib", (), {"ccj_span2d": None}))
    monkeypatch.setattr(cuda_ops, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(cuda_ops, "_launch", lambda fn, dev, what, addr, stream: launched.append(
        (what, ctypes.cast(addr, ctypes.POINTER(cuda_ops.Span2dTable)).contents.s)))
    for counter in ("SPAN_V_LAUNCHES", "SPAN_WBP_LAUNCHES", "SPAN_WM_LAUNCHES"):
        monkeypatch.setattr(cuda_ops, counter, 0)
    dangles = 1
    C, st = _small(B=2, dangles=dangles)
    C = nested.cell_major_eint({**C})
    C[gapped.WX] = cuda_ops.wx_tables_ref(C, st)
    for t in cuda_ops.span2d_fill_tables(C, st, dangles).values():
        t.dev = torch.device("cuda", 0)      # a launch through a table is captured
        C.setdefault(cuda_ops.SPAN2D_FILL, {})[t.kind] = t
    wx = C[gapped.WX]
    if swap == "state entry reassigned":
        st["V"] = st["V"].clone()
    elif swap == "a table in a copy of C":
        C = {**C, "EINT": C["EINT"].clone(), "ML0": C["ML0"].clone()}
    elif swap == "a scalar in a copy of C":
        C = {**C, "MLbase": C["MLbase"] + 1}
    elif swap == "other kept tables":
        wx = wx.clone()
    else:
        st = {k: v.clone() for k, v in st.items()}
    want = {k: v.clone() for k, v in st.items()}
    wx_want = wx.clone()
    if kind == "span_wbp":
        cuda_ops.span_wbp(C, st, 9, None, wx)
        cuda_ops.span_wbp_ref(C, want, 9, None, wx_want)
    else:
        getattr(cuda_ops, kind)(C, st, 9, dangles, True)
        getattr(cuda_ops, kind + "_ref")(C, want, 9, dangles)
    stale = kind in SWAPS[swap]
    assert launched == ([] if stale else [(kind, 9)]), (swap, kind)
    if stale:
        _same({k: v.numpy() for k, v in st.items()}, {k: v.numpy() for k, v in want.items()},
              f"{kind} after {swap}")
        assert torch.equal(wx, wx_want)


@pytest.mark.parametrize("kind,dangles", [("span_v", 1), ("span_v", 2), ("span_wbp", 2),
                                          ("span_wm", 1), ("wx_tables", 2)])
def test_launch_table_reads_each_operand_through_its_strides(monkeypatch, kind, dangles):
    """The packed Span2dTable, read back as the kernel reads it (pointer
    plus batch, row and column strides; EINT's di and dj strides), gives
    every operand's elements: tables from numpy as the fills hold them
    (some column-major, a batch of one as a view) and a state array read
    through a strided view; span_wbp's P-split minima (a strided view too)
    and its kept tables in the out slot; span_v's dependent-launch flag."""
    import ctypes

    packed = {}
    monkeypatch.setattr(cuda_ops, "_library",
                        lambda: type("Lib", (), {"ccj_span2d": None}))
    monkeypatch.setattr(cuda_ops, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(cuda_ops, "_launch", lambda fn, dev, what, addr, stream: packed.update(
        t=cuda_ops.Span2dTable.from_buffer_copy(
            (ctypes.c_char * ctypes.sizeof(cuda_ops.Span2dTable)).from_address(addr))))
    n = 16
    C = fold.add_batch(_consts(SEQS[n][0], dangles)[1])
    C = {**C, "MB0": C["MB0"].transpose(1, 2).contiguous().transpose(1, 2),
         "ML0": C["ML0"].transpose(1, 2).contiguous().transpose(1, 2)}
    st = {k: torch.from_numpy(v) for k, v in _state(np.random.default_rng(2), 1, n).items()}
    wide = torch.zeros((1, n + 2, 2 * (n + 2)), dtype=torch.int32)
    wide[..., 1::2] = st["WM"]
    st["WM"] = wide[..., 1::2]
    assert any(C[k].stride()[-1] != 1 for k in C if isinstance(C[k], torch.Tensor))
    dev, names, xs = cuda_ops.span2d_operands(C, st, kind, dangles)
    p_min = wx = None
    if kind == "span_wbp":
        p_min = torch.arange(3 * (n + 2), dtype=torch.int32).reshape(1, n + 2, 3)[..., 1]
        wx = cuda_ops.wx_tables(C, st)
    dependent = kind == "span_v" and dangles == 2
    cuda_ops._span2d_launch(kind, C, 9, dangles, names, xs, dev,
                            out=wx if kind == "span_wbp" else kind == "wx_tables",
                            p_min=p_min, dependent=dependent)
    t = packed["t"]
    assert (t.kind, t.B, t.n, t.n2, t.s, t.dangles, t.dependent) == (
        cuda_ops.SPAN2D_KINDS.index(kind), 1, n, n + 2, 9, dangles, int(dependent))
    assert (t.MLbase, t.PSM, t.PSP, t.PUP, t.PPS, t.pkb, t.bp, t.cp) == tuple(
        C[k] for k in ("MLbase", "PSM", "PSP", "PUP", "PPS", "b", "bp", "cp"))
    rng = np.random.default_rng(4)
    for name, x in zip(names, xs):
        k = cuda_ops._SPAN2D_SLOT[name]
        elem = ctypes.c_int8 if name == "Vtype" else ctypes.c_int32
        for _ in range(20):
            a, c = (int(v) for v in rng.integers(0, n + 2, 2))
            off = a * t.rs[k] + c * t.cs[k]
            if name == "EINT":
                di, dj = (int(v) for v in rng.integers(0, MAXLOOP + 2, 2))
                off += di * t.edi + dj * t.edj
                want = x[0, di, dj, a, c]
            else:
                want = x[0, a, c]
            got = elem.from_address(t.p[k] + ctypes.sizeof(elem) * off).value
            assert got == int(want), (name, a, c)
    used = {cuda_ops._SPAN2D_SLOT[nm] for nm in names} | (
        {len(cuda_ops.SPAN2D_OPERANDS) - 1} if kind in ("wx_tables", "span_wbp") else set())
    if kind == "span_wbp":
        k = cuda_ops._SPAN2D_SLOT["p_min"]
        used.add(k)
        for a in range(n + 2):
            got = ctypes.c_int32.from_address(t.p[k] + 4 * (a * t.cs[k])).value
            assert got == int(p_min[0, a]), a
        assert t.p[-1] == wx.data_ptr() and wx.is_contiguous()
    assert all((t.p[k] != 0) == (k in used) for k in range(len(cuda_ops.SPAN2D_OPERANDS)))
