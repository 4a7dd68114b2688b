"""The partition function's span kernels (``ccj_tpu_torch/engine/pf_ops.py``:
``pf_tt_span``, ``pf_history``, ``pf_stencil``, ``pf_p_split``;
``csrc/pfspan.cu`` on the card, their plain versions here; the other three,
``pf_span2d``, ``pf_assemble``, ``pf_store``, in
``tests/test_torch_pf_body.py``):

* per span: the port's ``pf4d.pf_span_step`` (the seven wrappers' plain
  versions inside) against the JAX package's ``pf_span_step`` on one random
  non-negative float64 state at n = 36 (``jax_enable_x64`` on, restored
  after), at spans 0, 1, 2, 3, 20 (IB < n2), 33 (all 29 stencil offsets
  live) and 35 (the last), every state array to rtol 1e-12;
* per kernel: each plain version against the sums it replaced, restated
  cell by cell as the kernel walks them (per live row, tt and column the
  kernel's loop bounds; the tt loop's three phases, its j-shrink reading
  the family's own slab at j + tt - tp, its k- and j-weights from the
  [n2, n2] tables), at n = 13 on random operands under the fill's contract
  (the per-cell inputs 0 off the span's valid cells), rtol 1e-12;
* no fallback: each of the seven wrappers refuses a wrong dtype, shape or
  device; a CUDA tensor without the kernel library raises; no launch is
  counted on the CPU;
* each kernel's bound counts the cells its plain version reads.
"""

import jax
import numpy as np
import pytest
import torch

from ccj_tpu.engine import pf4d as jpf4d
from ccj_tpu_torch.engine import cuda_ops, pf4d, pf_ops
from ccj_tpu_torch.engine.gapped import DS, dims
from ccj_tpu_torch.engine.gapped4 import LOOP_MATS, bucket_dims
from ccj_tpu_torch.params import DEFAULT_PK

from test_pf_device import SEQS, _setup

torch.set_num_threads(1)

N = 36          # the per-span test: all 29 stencil offsets live for s >= 32
NK = 13         # the per-kernel walks (Python loops)
RTOL = 1e-12


def _counts():
    return tuple(getattr(pf_ops, c) for c in pf_ops.PF_COUNTERS.values())


def _random_state(n, seed):
    """A random non-negative float64 fill state (numpy) with the keys and
    shapes of ``init_pf_state``."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              pf4d.init_pf_state(n, torch.float64, "meta").items()}
    return {k: rng.random(shape) for k, shape in shapes.items()}


@pytest.fixture(scope="module")
def span_case():
    """The JAX constants at n = 36 (float64) and a random state."""
    seq = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUU"
    assert len(seq) == N
    sp, tabs = _setup(seq)
    C_np, _ = pf4d.pfc_numpy(tabs, sp, DEFAULT_PK)
    return C_np, _random_state(N, 7)


@pytest.mark.parametrize("s", [0, 1, 2, 3, 20, 33, N - 1])
def test_span_step_matches_jax(span_case, s):
    C_np, st_np = span_case
    TB, IB = bucket_dims(N, s)
    before = _counts()
    got = pf4d.pf_span_step(pf4d.pfc_from_numpy(C_np, "cpu", torch.float64),
                            pf4d.pf_state_from_numpy(st_np, "cpu"), s, n=N, TB=TB, IB=IB)
    assert _counts() == before
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        C = {k: jax.numpy.asarray(v) for k, v in C_np.items()}
        st = {k: jax.numpy.asarray(v) for k, v in st_np.items()}
        want = {k: np.asarray(v) for k, v in
                jpf4d.pf_span_step(C, st, s, n=N, TB=TB, IB=IB).items()}
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert set(got) == set(want)
    changed = 0
    for k, v in want.items():
        assert v.dtype == np.float64, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=RTOL, atol=0, err_msg=k)
        changed += int(not np.array_equal(v, st_np[k]))
    assert changed >= 10       # the span wrote V, P2, WBP, WPP, the families, ...


def test_pf_state_from_numpy_keeps_the_state():
    st_np = _random_state(8, 1)
    st = pf4d.pf_state_from_numpy(st_np, "cpu")
    assert set(st) == set(st_np)
    for k, v in st.items():
        assert v.dtype == torch.float64 and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), st_np[k])
    assert pf4d.pf_state_from_numpy(st_np, "cpu", torch.float32)["V"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the kernels' walks restated, cell by cell
# ---------------------------------------------------------------------------

def _live(n, s, IB):
    lo, hi = pf_ops.pf_live_rows(n, s, IB)
    return range(lo, hi + 1)


def _tt_operands(n, s, rng):
    """The tt loop's operands (float64 tensors) under the fill's contract."""
    n2, T, S, U = dims(n)
    TB, IB = bucket_dims(n, s)
    valid = cuda_ops.span_valid(n, s, 0, TB, IB, n2).numpy()

    def cells():
        return torch.from_numpy(np.where(valid, rng.random((TB, IB, n2)), 0.0))

    def table():
        return torch.from_numpy(rng.random((n2, n2)))

    C = {"DPM": torch.from_numpy(rng.random((DS, DS, T, U))),
         "can_pair": torch.from_numpy(rng.random((n2, n2)) < 0.6),
         "ptype": torch.from_numpy(rng.integers(0, 3, (n2, n2)).astype(np.int32)),
         "expESTP": table(), "expbp": torch.tensor(rng.random(), dtype=torch.float64),
         "expap": torch.tensor(rng.random(), dtype=torch.float64),
         "expPB": torch.tensor(rng.random(), dtype=torch.float64),
         "expcp": torch.from_numpy(rng.random(n2))}
    bases = {k: cells() for k in pf_ops.PF_BASES}
    return C, table(), table(), table(), cells(), cells(), cells(), bases, TB, IB


def _tt_walk(C, WB, WP, WBPg, PLs, PRs, POs, bases, n, s, TB, IB):
    """csrc/pfspan.cu's pf_tt_span in Python: per live row, tt from s - 2
    down, (1)-(2) PM's row, (3) the other 13 families'."""
    n2, T, S, U = dims(n)
    f = {nm: k for k, nm in enumerate(LOOP_MATS)}
    out = np.zeros((len(LOOP_MATS), TB + 2, IB, n2))
    X = {"WB": WB.numpy(), "WP": WP.numpy(), "WBP": WBPg.numpy()}
    dpm, canp, pt = C["DPM"].numpy(), C["can_pair"].numpy(), C["ptype"].numpy()
    estp = C["expESTP"].numpy()
    bp, ap, PB = float(C["expbp"]), float(C["expap"]), float(C["expPB"])
    cp1 = float(C["expcp"][1])
    pls, prs, pos = PLs.numpy(), PRs.numpy(), POs.numpy()
    base = {k: v.numpy() for k, v in bases.items()}

    for i in _live(n, s, IB):
        o = out[:, :, i, :]
        for tt in range(s - 2, -1, -1):
            nj = s - tt - 1

            def red_k(slab, tab, hi, j):
                k = j + tt + 2
                return sum(slab[tp, j] * X[tab][k, k + tp - tt - 1]
                           for tp in range(tt + 1, min(hi, n2 + tt - k) + 1))

            def red_j(slab, tab, hi, j):
                return sum(slab[tp, j + tt - tp] * X[tab][j + tt - tp + 1, j]
                           for tp in range(tt + 1, min(hi, j + tt) + 1))

            for jr in range(nj):
                j, k = i + jr, i + jr + tt + 2
                pm_int = sum(o[f["PM"], tt + d1 + d2, j - d1] * dpm[d1 - 1, d2 - 1, tt, j + tt]
                             for d1 in range(1, min(DS, jr - 1) + 1)
                             for d2 in range(1, min(DS, s - tt - jr - 3) + 1))
                iloop = o[f["PM"], tt + 2, j - 1] * estp[j - 1, k + 1] + pm_int \
                    if canp[j, k] else 0.0
                ml = (o[f["PMmloop10"], tt + 2, j - 1] + o[f["PMmloop01"], tt + 2, j - 1]) \
                    * ap * bp * bp
                b4 = 1.0 if (jr == 0 and tt == s - 2) else 0.0
                o[f["PM"], tt, j] = iloop + ml + o[f["PfromM"], tt + 2, j - 1] + b4 \
                    if pt[j, k] > 0 else 0.0
            row = {}
            for jr in range(nj):
                j, hi, hk, hj = i + jr, s - 2, s - 3 - jr, jr + tt - 1
                PL, PR, PO, PM = pls[tt, i, j], prs[tt, i, j], pos[tt, i, j], o[f["PM"], tt, j]

                def b(name):
                    return base[name][tt, i, j]

                def sl(name):
                    return o[f[name]]
                mdp = (pls[:, i, :] + prs[:, i, :]) * PB
                row[j] = {
                    "PLmloop00": PL * bp + b("PLmloop00") + red_j(sl("PLmloop00"), "WB", hi, j),
                    "PLmloop01": red_j(sl("PLmloop00"), "WBP", hi, j),
                    "PLmloop10": b("PLmloop10") + red_j(sl("PLmloop10"), "WB", min(hi, hj), j),
                    "PRmloop00": PR * bp + b("PRmloop00") + red_k(sl("PRmloop00"), "WB", hi, j),
                    "PRmloop10": o[f["PRmloop10"], tt + 1, j] * cp1
                    + red_k(sl("PRmloop00"), "WBP", hi, j),
                    "PMmloop00": PM * bp + red_j(sl("PMmloop00"), "WB", hi, j)
                    + red_k(sl("PMmloop00"), "WB", hi, j),
                    "PMmloop01": o[f["PMmloop01"], tt + 1, j] * cp1 + b("PMmloop01"),
                    "PMmloop10": o[f["PMmloop10"], tt + 1, j - 1] * cp1 + b("PMmloop10"),
                    "PfromL": b("PfromL") + red_j(sl("PfromL"), "WP", min(hi, hj), j)
                    + (PR + PM + PO) * PB,
                    "PfromR": b("PfromR") + red_k(sl("PfromR"), "WP", min(hi, hk), j)
                    + (PM + PO) * PB,
                    "PfromM": red_j(sl("PfromMprime"), "WP", min(hi, hj), j),
                    "PfromMprime": red_k(mdp, "WP", min(hi, hk), j),
                    "PK": red_j(sl("PK"), "WP", min(hi, hj), j)
                    + red_k(sl("PK"), "WP", min(hi, hk), j) + (PL + PM + PR + PO) * PB}
            for j, vals in row.items():     # phase (3) writes after its reads
                for name, v in vals.items():
                    o[f[name], tt, j] = v
    return out


@pytest.mark.parametrize("s", [2, 3, 7, NK - 2, NK - 1])
def test_tt_span_ref_matches_the_kernel_walk(s):
    C, WB, WP, WBPg, PLs, PRs, POs, bases, TB, IB = _tt_operands(
        NK, s, np.random.default_rng(s))
    got = pf_ops.pf_tt_span(C, WB, WP, WBPg, PLs, PRs, POs, bases, n=NK, s=s, TB=TB, IB=IB)
    assert got.shape == (len(LOOP_MATS), TB + 2, IB, NK + 2)
    want = _tt_walk(C, WB, WP, WBPg, PLs, PRs, POs, bases, NK, s, TB, IB)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert (want != 0).sum() > 0


def _state(n, rng):
    return pf4d.pf_state_from_numpy(_random_state(n, int(rng.integers(1 << 30))), "cpu")


@pytest.mark.parametrize("s", [1, 2, 5, NK - 1])
def test_history_ref_matches_the_kernel_walk(s):
    rng = np.random.default_rng(100 + s)
    n2, T, S, U = dims(NK)
    TB, IB = bucket_dims(NK, s)
    st = _state(NK, rng)
    X = {k: torch.from_numpy(rng.random((n2, n2))) for k in pf_ops.PF_TABLES}
    got = pf_ops.pf_history(st, X["WB"], X["WP"], X["WBPg"], n=NK, s=s, TB=TB, IB=IB)
    want = np.zeros((len(pf_ops.PF_HISTORY), TB, IB, n2))
    sp0 = max(s - TB, 0)
    for w, (mode, name, tab, g1) in enumerate(pf_ops.PF_HISTORY):
        x = X[tab].numpy()
        src = st[name if mode == "RL" else "C_" + name].numpy()
        for i in _live(NK, s, IB):
            for tt in range(s - 1):
                for jr in range(s - tt - 1):
                    j = i + jr
                    lo = sp0
                    if g1:
                        lo = max(lo, s - jr + 1 if mode == "RI" else jr + tt + 3)
                    want[w, tt, i, j] = sum(
                        (src[tt, sp, i + s, j] * x[i, i + s - sp - 1] if mode == "RI"
                         else src[tt, sp, i, j] * x[i + sp + 1, i + s])
                        for sp in range(lo, s))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert (want != 0).any() == (s >= 2)


@pytest.mark.parametrize("s", [1, 2, 4, NK - 1])
def test_stencil_ref_matches_the_kernel_walk(s):
    rng = np.random.default_rng(200 + s)
    n2, T, S, U = dims(NK)
    TB, IB = bucket_dims(NK, s)
    st = _state(NK, rng)
    W4PL = torch.from_numpy(rng.random((DS, DS, n2, n2)))
    W4PR = torch.from_numpy(rng.random((DS, DS, n2 + T + 2, 2 * n2)))
    W4POD = torch.from_numpy(rng.random((DS, DS, n2, n2)))
    got = pf_ops.pf_stencil(st, W4PL, W4PR, W4POD, n=NK, s=s, TB=TB, IB=IB)
    PL, PR, PO = (st[k].numpy() for k in pf_ops.PF_STENCILS)
    wl, wr, wo = W4PL.numpy(), W4PR.numpy(), W4POD.numpy()
    want = np.zeros((3, TB, IB, n2))
    for i in _live(NK, s, IB):
        for tt in range(s - 1):
            for jr in range(s - tt - 1):
                j = i + jr
                want[0, tt, i, j] = sum(
                    PL[tt + d2, s - d1, i + d1, j - d2] * wl[d1 - 1, d2 - 1, i, j]
                    for d1 in range(1, min(DS, s, n2 - 1 - i) + 1)
                    for d2 in range(1, min(DS, T - 1 - tt, j) + 1))
                want[1, tt, i, j] = sum(
                    PR[tt + d1, s - d2, i, j] * wr[d1 - 1, d2 - 1, j + tt + 2, s + i]
                    for d1 in range(1, min(DS, T - 1 - tt) + 1)
                    for d2 in range(1, min(DS, s) + 1))
                want[2, tt, i, j] = sum(
                    PO[tt, s - d1 - d2, i + d1, j] * wo[d1 - 1, d2 - 1, i, s]
                    for d1 in range(1, min(DS, jr - 1) + 1)
                    for d2 in range(1, min(DS, s - tt - jr - 3) + 1))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("s", [2, 3, 6, NK - 1])
def test_p_split_ref_matches_the_kernel_walk(s):
    rng = np.random.default_rng(300 + s)
    st = _state(NK, rng)
    got = pf_ops.pf_p_split(st["PKE"], st["PKD"], n=NK, s=s)
    pke, pkd = st["PKE"].numpy(), st["PKD"].numpy()
    want = np.zeros(NK + 2)
    for i in _live(NK, s, NK + 2):
        acc = 0.0
        for a in range(s - 2):                 # the kernel's (a, c) pairs, b inside
            for c in range(s - 2 - a):
                acc += sum(pke[b, a + c + 2, i, a] * pkd[c, s - a - 1, i + a + 1, b]
                           for b in range(s - 2 - a - c))
        want[i] = acc
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert (want > 0).any() == (s >= 3)


# ---------------------------------------------------------------------------
# refusals, no fallback, no launch on the CPU
# ---------------------------------------------------------------------------

def _calls(n, s, dtype=torch.float64, device="cpu"):
    """One call of each wrapper on a small random float state."""
    rng = np.random.default_rng(5)
    n2, T, S, U = dims(n)
    TB, IB = bucket_dims(n, s)
    st = pf4d.pf_state_from_numpy(_random_state(n, 3), device, dtype)
    C_tt, WB, WP, WBPg, PLs, PRs, POs, bases, _, _ = _tt_operands(n, s, rng)

    def dev(x):
        return x.to(device, dtype if x.is_floating_point() else x.dtype)
    C_tt = {k: dev(v) for k, v in C_tt.items()}
    WB, WP, WBPg, PLs, PRs, POs = map(dev, (WB, WP, WBPg, PLs, PRs, POs))
    bases = {k: dev(v) for k, v in bases.items()}
    W4PL = dev(torch.from_numpy(rng.random((DS, DS, n2, n2))))
    W4PR = dev(torch.from_numpy(rng.random((DS, DS, n2 + T + 2, 2 * n2))))
    C = {**C_tt, **{k: dev(v) for k, v in _body_consts(n, rng).items()}}
    wx = {"WB": WB, "WP": WP, "WBPg": WBPg}
    hist = dev(torch.from_numpy(rng.random((len(pf_ops.PF_HISTORY), TB, IB, n2))))
    stn = dev(torch.from_numpy(rng.random((len(pf_ops.PF_STENCILS), TB, IB, n2))))
    loops = dev(torch.from_numpy(rng.random((len(LOOP_MATS), TB + 2, IB, n2))))
    fams = {k: PLs for k in pf_ops.PF_STORED}
    kw = {"n": n, "s": s, "TB": TB, "IB": IB}
    return {
        "pf_tt_span": lambda: pf_ops.pf_tt_span(C_tt, WB, WP, WBPg, PLs, PRs, POs, bases, **kw),
        "pf_history": lambda: pf_ops.pf_history(st, WB, WP, WBPg, **kw),
        "pf_stencil": lambda: pf_ops.pf_stencil(st, W4PL, W4PR, W4PL, **kw),
        "pf_p_split": lambda: pf_ops.pf_p_split(st["PKE"], st["PKD"], n=n, s=s),
        # the in-place wrappers: the first array they write, after the call
        "pf_span2d": lambda: (pf_ops.pf_span2d(C, st, st["VD"][0], wx, n=n, s=s), st["V"])[1],
        "pf_assemble": lambda: pf_ops.pf_assemble(C, st, hist, stn, **kw)[0]["PL"],
        "pf_store": lambda: (pf_ops.pf_store(st, loops, fams, **kw), st["PL"])[1]}


def _body_consts(n, rng):
    """Random float64 constants of the span's 2-D part (``pf_span2d``)."""
    n2 = n + 2
    C = {k: torch.from_numpy(rng.random((n2, n2))) for k in ("HD", "expMB", "expML")}
    C["EINTD"] = torch.from_numpy(rng.random((pf_ops.ML + 2, pf_ops.ML + 2, n2, n2)))
    C.update((k, torch.from_numpy(rng.random(n2))) for k in ("expMLbase", "expcp", "expPUP"))
    C.update((k, torch.tensor(rng.random(), dtype=torch.float64))
             for k in pf_ops.PF_SPAN2D_SCALARS)
    return C


@pytest.mark.parametrize("name", pf_ops.PF_KERNELS)
def test_wrappers_refuse_and_count_nothing_on_the_cpu(name, monkeypatch, tmp_path):
    before = _counts()
    assert _calls(9, 5)[name]().dtype == torch.float64
    assert _calls(9, 5, torch.float32)[name]().dtype == torch.float32
    with pytest.raises(TypeError):                       # integer operands
        _calls(9, 5, torch.int32)[name]()
    with pytest.raises(ValueError, match="CUDA"):        # neither CPU nor CUDA
        _calls(9, 5, device="meta")[name]()
    assert _counts() == before

    # a CUDA operand without the kernel library raises (no fallback)
    monkeypatch.setattr(cuda_ops, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_ops, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    calls = _calls(9, 5, device="meta")
    monkeypatch.setattr(cuda_ops, "_check_devices", lambda xs: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nvcc"):
        calls[name]()
    assert _counts() == before


def test_wrappers_refuse_wrong_shapes():
    rng = np.random.default_rng(0)
    n, s = 9, 5
    n2, T, S, U = dims(n)
    TB, IB = bucket_dims(n, s)
    st = pf4d.pf_state_from_numpy(_random_state(n, 3), "cpu")
    C, WB, WP, WBPg, PLs, PRs, POs, bases, _, _ = _tt_operands(n, s, rng)
    with pytest.raises(ValueError, match="PLs"):
        pf_ops.pf_tt_span(C, WB, WP, WBPg, PLs[:, :-1], PRs, POs, bases,
                          n=n, s=s, TB=TB, IB=IB)
    with pytest.raises(ValueError, match="WB"):
        pf_ops.pf_history(st, WB[:-1], WP, WBPg, n=n, s=s, TB=TB, IB=IB)
    with pytest.raises(ValueError, match="W4PR"):
        pf_ops.pf_stencil(st, st["PL"][0, 0][None, None].expand(DS, DS, n2, n2),
                          WB, WB, n=n, s=s, TB=TB, IB=IB)
    with pytest.raises(ValueError, match="PKD"):
        pf_ops.pf_p_split(st["PKE"], st["PKE"], n=n, s=s)
    with pytest.raises(TypeError, match="expbp"):     # a float32 scalar in a float64 call
        pf_ops.pf_tt_span({**C, "expbp": C["expbp"].float()}, WB, WP, WBPg, PLs, PRs, POs,
                          bases, n=n, s=s, TB=TB, IB=IB)


def test_span_step_calls_its_kernels_through_the_given_wrappers():
    """``pf_span_step(..., kernels=...)`` calls each of the seven wrappers
    through the object given, once a span, and fills as the default
    does."""
    from types import SimpleNamespace

    n, s = NK, 7
    TB, IB = bucket_dims(n, s)
    sp, tabs = _setup("GGGAAACGGGCGA")
    C = pf4d.pfc_from_numpy(pf4d.pfc_numpy(tabs, sp, DEFAULT_PK)[0], "cpu", torch.float64)
    st_np = _random_state(n, 2)
    seen = []

    def spy(name):
        def call(*args, **kw):
            seen.append(name)
            return getattr(pf_ops, name)(*args, **kw)
        return call
    kernels = SimpleNamespace(**{k: spy(k) for k in pf_ops.PF_KERNELS})
    got = pf4d.pf_span_step(C, pf4d.pf_state_from_numpy(st_np, "cpu"), s, n=n, TB=TB, IB=IB,
                            kernels=kernels)
    want = pf4d.pf_span_step(C, pf4d.pf_state_from_numpy(st_np, "cpu"), s, n=n, TB=TB, IB=IB)
    assert sorted(seen) == sorted(pf_ops.PF_KERNELS)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_fill_times_its_parts_in_one_run():
    """``pf_fill_device(..., times=...)`` fills the dict with its four
    parts' seconds and computes the same result."""
    sp, tabs = _setup(SEQS[0])
    times = {}
    got = pf4d.pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device="cpu",
                              times=times)
    assert list(times) == ["constants_s", "span_loop_s", "copy_out_s", "exterior_s"]
    assert all(t >= 0 for t in times.values())
    want = pf4d.pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(got["W"], want["W"])
    np.testing.assert_array_equal(got["P2"], want["P2"])


def test_fill_launches_no_kernel_on_the_cpu():
    """A whole float64 fill on the CPU runs the plain versions: the counters
    do not move, and the fill equals the host engine (tests/test_torch_pf.py
    holds the rest)."""
    from ccj_tpu_torch.engine import pf as tpf

    sp, tabs = _setup(SEQS[0])
    before = _counts()
    got = pf4d.pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device="cpu")
    assert _counts() == before
    host = tpf.pf_fill(tabs, sp, DEFAULT_PK)
    np.testing.assert_allclose(got["W"], host["W"], rtol=1e-9)


# ---------------------------------------------------------------------------
# the bound's count of the cells each kernel needs (chip_smoke.pf_work)
# ---------------------------------------------------------------------------

def _valid_state_cells(n):
    """[T, S, n2, n2]: the cells of a family that a fill can make nonzero
    (tt <= sp - 2, 1 <= i <= j, j + tt + 2 <= i + sp <= n)."""
    n2, T, S, U = dims(n)
    tt, sp, i, j = np.ogrid[:T, :S, :n2, :n2]
    return (tt <= sp - 2) & (i >= 1) & (j >= i) & (j + tt + 2 <= i + sp) & (i + sp <= n)


def _reads(fn, tensors, within=None):
    """How many cells of each named tensor the sum of ``fn()`` depends on,
    by autograd through a plain version (each saved tensor cloned, as the
    tt loop writes its slabs in place), counted inside ``within[name]``
    where given (none where the result does not reach the tensor); the
    operands are non-negative, so no term cancels."""
    for x in tensors.values():
        x.requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(torch.clone, lambda x: x):
        out = fn()
    out.sum().backward()
    within = within or {}
    return {k: 0 if x.grad is None else int(((x.grad != 0) & within.get(k, True)).sum())
            for k, x in tensors.items()}


@pytest.mark.parametrize("name,n,s", [
    ("pf_tt_span", NK, 7), ("pf_tt_span", NK, NK - 1), ("pf_history", NK, 7),
    ("pf_history", NK, NK - 1), ("pf_stencil", NK, 7), ("pf_stencil", N, 33),
    ("pf_p_split", NK, 7), ("pf_p_split", NK, NK - 1), ("pf_span2d", NK, 2),
    ("pf_span2d", NK, 7), ("pf_span2d", N, 33), ("pf_assemble", NK, 7),
    ("pf_assemble", NK, NK - 1), ("pf_store", NK, 1), ("pf_store", NK, 7)])
def test_bound_counts_the_cells_the_plain_version_reads(name, n, s):
    """``chip_smoke.pf_work`` counts, for each state array and weight table
    a kernel reads, the cells its plain version's result depends on when
    every valid cell of the state is positive, and of a state array only
    its valid cells (the tt loop's expESTP: at least those, no more than
    one a PM cell).  The in-place kernels' result is what they write: the
    2-D part's span-s cells of the live rows and VD / PD's row s, the
    write-back's destination planes."""
    import chip_smoke

    rng = np.random.default_rng(s)
    TB, IB = bucket_dims(n, s)
    want, _, _ = chip_smoke.pf_work(name, n, s, TB, IB)
    n2 = n + 2
    if name == "pf_span2d":
        st = pf4d.pf_state_from_numpy(_random_state(n, s), "cpu")
        C = _body_consts(n, rng)
        consts = ("HD", "EINTD", "expMB", "expML", "expMLbase", "expcp", "expPUP")
        ops = {**{k: st[k] for k in pf_ops.PF_2D if k != "PD"}, **{k: C[k] for k in consts},
               "p_new": torch.from_numpy(rng.random(n2)),
               **{k: torch.from_numpy(rng.random((n2, n2))) for k in ("WB", "WP")}}
        lo, hi = pf_ops.pf_live_rows(n, s, n2)
        i = torch.arange(lo, hi + 1)

        def fn():
            st2 = {**st, **{k: v.clone() for k, v in ops.items() if k in st}, "PD": st["PD"]}
            wx = {"WB": ops["WB"].clone(), "WP": ops["WP"].clone(),
                  "WBPg": torch.zeros(n2, n2, dtype=torch.float64)}
            pf_ops.pf_span2d_ref({**C, **{k: ops[k] for k in consts}}, st2, ops["p_new"], wx,
                                 n, s)
            cells = [st2[k][i, i + s] for k in ("V", "P2", "WBP", "WPP")] \
                + [wx[k][i, i + s] for k in wx] + [st2["VD"][s], st2["PD"][s]]
            if s >= 3:
                cells += [st2[k][i, i + s] for k in ("WM", "WMv", "WMp")]
            return torch.cat(cells)
        got = _reads(fn, ops)
    elif name == "pf_assemble":
        C, *_ = _tt_operands(n, s, rng)
        C["can_pair"][:] = True
        C["ptype"][:] = 1
        valid = torch.from_numpy(_valid_state_cells(n))
        st = pf4d.pf_state_from_numpy(_random_state(n, s), "cpu")
        reads = {fam for fam, *_ in pf_ops.PF_PLANE_READS}
        ops = {**{k: st[k].where(valid, 0.0) for k in reads}, "expESTP": C["expESTP"],
               "hist": torch.from_numpy(rng.random((len(pf_ops.PF_HISTORY), TB, IB, n2))),
               "stn": torch.from_numpy(rng.random((len(pf_ops.PF_STENCILS), TB, IB, n2)))}
        got = _reads(lambda: torch.stack(
            [*(pf_ops.pf_assemble_ref(
                {**C, "expESTP": ops["expESTP"]}, ops, ops["hist"], ops["stn"],
                n, s, TB, IB)[0][k] for k in pf_ops.PF_ASSEMBLED),
             pf_ops.pf_assemble_ref({**C, "expESTP": ops["expESTP"]}, ops, ops["hist"],
                                    ops["stn"], n, s, TB, IB)[1]["PMmloop10"]]),
            ops, dict.fromkeys(reads, valid))
    elif name == "pf_store":
        st = pf4d.pf_state_from_numpy(_random_state(n, s), "cpu")
        ops = {"loops": torch.from_numpy(rng.random((len(LOOP_MATS), TB + 2, IB, n2))),
               "fams": torch.from_numpy(rng.random((len(pf_ops.PF_STORED), TB, IB, n2)))}

        def fn():
            st2 = {k: v.clone() for k, v in st.items()}
            pf_ops.pf_store_ref(st2, ops["loops"].clone(),
                                dict(zip(pf_ops.PF_STORED, ops["fams"].clone())), n, s, TB, IB)
            return torch.cat([v.flatten() for v in chip_smoke.pf_store_views(st2, n, s, TB)])
        got = _reads(fn, ops)
    elif name == "pf_tt_span":
        C, WB, WP, WBPg, PLs, PRs, POs, bases, _, _ = _tt_operands(n, s, rng)
        C["can_pair"][:] = True
        C["ptype"][:] = 1
        ops = {"WB": WB, "WP": WP, "WBPg": WBPg, "DPM": C["DPM"], "expESTP": C["expESTP"]}
        got = _reads(lambda: pf_ops.pf_tt_span_ref(C, WB, WP, WBPg, PLs, PRs, POs, bases,
                                                   n, s, TB, IB), ops)
        assert got.pop("expESTP") <= want["expESTP"] <= chip_smoke.pf_work(
            name, n, s, TB, IB)[2] // 5
    else:
        st = pf4d.pf_state_from_numpy(_random_state(n, s), "cpu")
        if name == "pf_history":
            ops = {k: st[k] for k in want if k != "cells" and not k.startswith("W")}
            ops.update(zip(("WB", "WP", "WBPg"), (torch.from_numpy(rng.random(st["V"].shape))
                                                  for _ in range(3))))
            got = _reads(lambda: pf_ops.pf_history_ref(st, ops["WB"], ops["WP"], ops["WBPg"],
                                                       n, s, TB, IB), ops)
        elif name == "pf_stencil":
            valid = torch.from_numpy(_valid_state_cells(n))
            ops = {k: st[k].where(valid, 0.0) for k in pf_ops.PF_STENCILS}
            ops.update((k, torch.from_numpy(rng.random(shape))) for k, shape in (
                ("W4PL", (DS, DS, n + 2, n + 2)), ("W4PR", (DS, DS, 2 * n + 3, 2 * n + 4)),
                ("W4POD", (DS, DS, n + 2, n + 2))))
            got = _reads(lambda: pf_ops.pf_stencil_ref(ops, ops["W4PL"], ops["W4PR"],
                                                       ops["W4POD"], n, s, TB, IB), ops,
                         dict.fromkeys(pf_ops.PF_STENCILS, valid))
        else:
            ops = {"PKE": st["PKE"], "PKD": st["PKD"]}
            got = _reads(lambda: pf_ops.pf_p_split_ref(ops["PKE"], ops["PKD"], n, s), ops)
    assert got == {k: v for k, v in want.items() if k in got}
    assert set(want) - set(got) <= {"cells", "scalars", "expESTP"}
