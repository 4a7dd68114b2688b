"""The CUDA kernels (``tt_span``, ``minplus_group``, ``tt_step``,
``history_min``, ``p_split``, ``stencil_pl``, ``stencil_pr``,
``span_assemble``, ``span_store``, ``span_v``, ``span_wbp``, ``span_wm``,
``wx_tables``) against
their plain PyTorch versions, on the card (exact: integer data), the
partition fill's seven (``pf_tt_span``, ``pf_history``, ``pf_stencil``,
``pf_p_split``, ``pf_span2d``, ``pf_assemble``, ``pf_store``) within rtol
1e-13 (float64) / 2e-6 or 1e-5 (float32), ``tt_span``
against the two-launch loop it replaces, ``fold_many``'s
fill-ahead pipeline against per-sequence folds, the card's lazy traceback, P-split argmin and float64
partition function against the CPU's, the long reference anchors
(n = 134 ... 200) through the packed fill, the batched and the row-sharded
fills (dense and packed) against single fills, ``span_wm`` as a dependent
launch after ``span_store``, ``wx_tables`` on every operand layout and a
fill through its launch tables against the checked path.  Marked ``gpu``; each test skips
where no CUDA device is present.  This file imports neither JAX nor
``ccj_tpu``, so on a machine without JAX it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from ccj_tpu_torch.engine import cuda_ops
from ccj_tpu_torch.engine.common import INF
from ccj_tpu_torch.engine.ttloop import REDUCTIONS, reduction_table

pytestmark = pytest.mark.gpu


def _loop_counts():
    return (cuda_ops.TT_SPAN_LAUNCHES, cuda_ops.LAUNCHES, cuda_ops.TT_STEP_LAUNCHES)


def _loop_launches(before):
    """(tt_span, minplus_group, tt_step) launches since ``before``."""
    return tuple(a - b for a, b in zip(_loop_counts(), before))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, gen, dev):
    x = torch.randint(-30000, 32767, shape, generator=gen, dtype=torch.int32)
    x[torch.rand(shape, generator=gen) < 0.3] = INF
    return x.to(dev)


@pytest.mark.parametrize("TB,IB,n2,s", [(16, 16, 18, 12), (64, 102, 102, 40),
                                        (99, 64, 102, 66), (127, 64, 130, 70)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_kernel_matches_plain(cuda, TB, IB, n2, s, mode):
    gen = torch.Generator().manual_seed(TB * 7 + mode)
    for tt in (0, (s - 2) // 2, s - 2):
        if mode == 2:
            slab = _rand((2 * TB + 2, IB, n2 + TB), gen, cuda)
            w = _rand((TB, n2), gen, cuda)
            args = (tt + 1, tt, 0, mode, 2)
        else:
            slab = _rand((2 * TB + 2, IB, n2), gen, cuda)
            w = _rand((TB, n2 + TB + 1), gen, cuda)[:, tt + 2: tt + 2 + n2]
            args = (tt + 1, 0, 0, mode, s - 4 - tt)
        before = cuda_ops.LAUNCHES
        got = cuda_ops.minplus_window(slab, w, *args)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES == before + 1
        assert torch.equal(got, cuda_ops.minplus_window_ref(slab, w, *args))


SPANS = [(16, 16, 18, 12), (64, 102, 102, 40), (99, 64, 102, 66), (127, 64, 130, 70)]


@pytest.mark.parametrize("TB,IB,n2,s", SPANS)
def test_group_kernel_matches_plain(cuda, TB, IB, n2, s):
    """A span's 13-window table (modes 0, 1 and 2) in one launch per tt."""
    gen = torch.Generator().manual_seed(TB * 11 + s)
    slabs = {}
    for name, *_ in REDUCTIONS:
        cols = n2 + TB if name.startswith("B_") else n2
        slabs.setdefault(name, _rand((2 * TB + 2, IB, cols), gen, cuda))
    WKX = {nm: _rand((TB, n2 + TB + 1), gen, cuda) for nm in ("WP", "WB", "WBP")}
    WJX = {nm: _rand((TB, n2), gen, cuda) for nm in ("WP", "WB", "WBP")}
    table = reduction_table(slabs, WKX, WJX, s, n2)
    out = torch.empty(table.shape, dtype=torch.int32, device=cuda)
    for tt in (0, (s - 2) // 2, s - 2):
        before = (cuda_ops.LAUNCHES, cuda_ops.WINDOWS)
        cuda_ops.minplus_group(table, tt, out)
        torch.cuda.synchronize()
        assert (cuda_ops.LAUNCHES, cuda_ops.WINDOWS) == (before[0] + 1, before[1] + 13)
        assert torch.equal(out, cuda_ops.minplus_group_ref(table, tt))


def test_group_kernel_pairs_windows_with_differently_strided_weights(cuda):
    """Two windows on one slab window (one descriptor with w and w2) whose
    weight tables have different strides, beside an unpaired window."""
    gen = torch.Generator().manual_seed(5)
    TB, IB, n2, s = 64, 102, 102, 40
    slab = _rand((2 * TB + 2, IB, n2 + TB), gen, cuda)
    w = _rand((TB, n2), gen, cuda)
    w2 = _rand((n2, TB), gen, cuda).T                 # strides (1, TB)
    spec = dict(slab=slab, row0=(1, 1), col0=(0, 1), mode=2, c=(2, 0))
    table = cuda_ops.WindowTable(
        [cuda_ops.WindowSpec(w=w, **spec), cuda_ops.WindowSpec(w=w2, **spec),
         cuda_ops.WindowSpec(w=w2, **{**spec, "mode": 0})], n2, (0, s - 2))
    assert table.jobs == [(0, 1), (2,)]
    out = torch.empty(table.shape, dtype=torch.int32, device=cuda)
    for tt in (0, (s - 2) // 2, s - 2):
        cuda_ops.minplus_group(table, tt, out)
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_ops.minplus_group_ref(table, tt))


@pytest.mark.parametrize("lo", [-1, 0, 5, 40])
def test_suffix_kernel_matches_plain(cuda, lo):
    gen = torch.Generator().manual_seed(lo + 1)
    slab, w = _rand((23, 13, 150), gen, cuda), _rand((23, 150), gen, cuda)
    got = cuda_ops.minplus_suffix(slab, w, lo)
    assert torch.equal(got, cuda_ops.minplus_suffix_ref(slab, w, lo))


def test_fold_on_cuda_matches_cpu(cuda):
    from ccj_tpu_torch import fold

    seq = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
    from ccj_tpu_torch.api import _fill_length

    before = _loop_counts()
    res = fold(seq)
    assert _loop_launches(before) == (_fill_length(len(seq)) - 2, 0, 0)   # one a span
    assert (res.structure, res.energy) == ("(((([[[...[[[[[[[))))....]]]]]]].]]].", -9.94)


def test_lazy_fold_on_cuda_matches_eager_cpu(cuda):
    from ccj_tpu_torch import fold

    seq = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"
    lazy = fold(seq, lazy=True)
    eager = fold(seq, device="cpu", lazy=False)
    assert (lazy.structure, lazy.energy_dcal) == (eager.structure, eager.energy_dcal)


def test_case_p_argmin_on_cuda_matches_cpu(cuda):
    from ccj_tpu_torch.engine.lazy import case_p_device

    gen = torch.Generator().manual_seed(11)
    n = 37
    PKD = torch.randint(-3, 2, (n - 1, n, n + 2, n + 2), generator=gen,
                        dtype=torch.int16)
    PKD[torch.rand(PKD.shape, generator=gen) < 0.2] = 32767
    PKD_cuda = PKD.to(cuda)
    for i, l in ((1, 4), (1, n), (5, 30), (12, 20), (2, n - 1)):
        assert case_p_device(PKD_cuda, i, l, n) == case_p_device(PKD, i, l, n)


def test_pf_float64_on_cuda_matches_cpu(cuda):
    import numpy as np

    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine.pf4d import pf_fill_device
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    tabs = build_seq_tables("GGGAAACGGGCGAUCCUUCCCGAAAGGG", sp, DEFAULT_PK)
    got = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device=cuda)
    want = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device="cpu")
    for k in ("V", "WM", "WMv", "WMp", "P2", "WBP", "WPP", "W"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-300, err_msg=k)
    for name, view in want["M4"].items():
        np.testing.assert_allclose(got["M4"][name].arr, view.arr, rtol=1e-12,
                                   atol=1e-300, err_msg=name)


PF_SPANS48 = (20, 33, 46)


def _pf_visit(seen, dtype, spans):
    """A ``chip_smoke.pf_kernel_calls`` visit: at ``spans[name]``, the kernel
    against its plain version (``chip_smoke.pf_pair``) within
    ``chip_smoke.pf_rtol``, one launch a call; appends (name, span,
    nonzero outputs) to ``seen``."""
    import chip_smoke
    from ccj_tpu_torch.engine import pf_ops

    def visit(name, s, fn, ref, args, kw):
        if s not in spans.get(name, ()):
            return fn(*args, **kw)
        before = getattr(pf_ops, chip_smoke.PF_COUNTERS[name])
        result, got, want, _, _ = chip_smoke.pf_pair(name, fn, ref, args, kw)
        assert getattr(pf_ops, chip_smoke.PF_COUNTERS[name]) == before + 1, (name, s)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and bool(torch.isfinite(g).all()), (name, s)
            err = chip_smoke.pf_rel_err(g, w)
            assert err <= chip_smoke.pf_rtol(name, dtype), (name, s, err)
        seen.append((name, s, sum(int((g != 0).sum()) for g in got)))
        return result
    return visit


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_pf_kernels_match_plain(cuda, dtype):
    """The partition fill's seven kernels (``pf_ops.PF_KERNELS``) against
    their plain versions on the card, on the n=48 fill's own operands at
    spans 20, 33 and 46 (``chip_smoke.pf_kernel_calls``): rtol 1e-13 in
    float64, in float32 2e-6 (1e-5 for ``pf_span2d``, ``pf_assemble``,
    ``pf_store``), one launch a call."""
    import chip_smoke

    seen = []
    spans = dict.fromkeys(chip_smoke.PF_KERNELS, PF_SPANS48)
    chip_smoke.pf_kernel_calls(48, PF_SPANS48, dtype, cuda, _pf_visit(seen, dtype, spans))
    assert sorted(x[:2] for x in seen) == sorted(
        (k, s) for k in chip_smoke.PF_KERNELS for s in PF_SPANS48)
    assert all(nz > 0 for name, s, nz in seen if name != "pf_p_split")


@pytest.mark.parametrize("n", [40, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_pf_body_kernels_match_plain(cuda, dtype, n):
    """``pf_span2d``, ``pf_assemble`` and ``pf_store`` against their plain
    versions on the card, on the length-n fill's own operands at its first
    three spans, a middle one and its last two (the store's destinations
    set to NaN before each run, so an element left unwritten shows)."""
    import chip_smoke

    spans = (0, 1, 2, n // 2 + 8, n - 2, n - 1)
    seen = []
    chip_smoke.pf_kernel_calls(n, spans, dtype, cuda, _pf_visit(
        seen, dtype, {k: spans if k != "pf_assemble" else spans[2:] for k in chip_smoke.PF_NEW}))
    assert sorted(x[:2] for x in seen) == sorted(
        [("pf_span2d", s) for s in spans] + [("pf_store", s) for s in spans]
        + [("pf_assemble", s) for s in spans[2:]])
    assert all(nz > 0 for name, s, nz in seen if s >= n // 2)


def test_pf_fill_n40_float64_on_cuda_matches_cpu(cuda):
    """A whole float64 fill at n=40 on the card (the seven kernels, each
    launched as ``chip_smoke.pf_counts`` says) against the CPU's (their
    plain versions), rtol 1e-9 on every array."""
    import chip_smoke
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine import pf_ops
    from ccj_tpu_torch.engine.pf4d import pf_fill_device
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    tabs = build_seq_tables(chip_smoke.bench_seq(40), sp, DEFAULT_PK)
    before = chip_smoke.pf_launches(pf_ops)
    got = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device=cuda)
    after = chip_smoke.pf_launches(pf_ops)
    assert {k: after[k] - before[k] for k in after} == chip_smoke.pf_counts(40)
    want = pf_fill_device(tabs, sp, DEFAULT_PK, dtype=torch.float64, device="cpu")
    assert chip_smoke.pf_fill_err(got, want) <= 1e-9


LONG_ANCHORS = (134, 140, 150, 160, 170, 180, 200)


@pytest.mark.parametrize("n", LONG_ANCHORS)
def test_long_anchor_folds_on_cuda(cuda, n):
    """Every long reference anchor past the dense reach, byte for byte,
    through the packed fill (one tt_span launch per span)."""
    from pathlib import Path

    from ccj_tpu_torch import fold
    from ccj_tpu_torch.cli import _format_energy

    seq, line = (Path(__file__).parent / "golden" / "long" / f"seed42_n{n}.txt") \
        .read_text().splitlines()[:2]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = _loop_counts()
    res = fold(seq)
    peak = torch.cuda.max_memory_allocated()
    got = f"{res.structure} ({_format_energy(res.energy)})"   # the CLI's line
    assert got == line, f"n={n}: {got!r} != {line!r} (peak device memory {peak} B)"
    assert _loop_launches(before) == (n - 2, 0, 0), \
        f"n={n}: launches (peak device memory {peak} B)"


def _bench_seq(n, seed):
    import random

    rng = random.Random(seed)
    return "".join(rng.choice("ACGU") for _ in range(n))


def test_batched_group_kernel_matches_plain(cuda):
    """The main tt step of a bucket-64 fill for a batch of 8: one launch
    reduces the 13 windows of all 8 elements."""
    from ccj_tpu_torch.engine.gapped4 import bucket_dims

    n, B = 64, 8
    n2 = n + 2
    s = max(range(2, n), key=lambda s: (bucket_dims(n, s)[0] * bucket_dims(n, s)[1], s))
    TB, IB = bucket_dims(n, s)
    gen = torch.Generator().manual_seed(64)
    slabs = {}
    for name, *_ in REDUCTIONS:
        cols = n2 + TB if name.startswith("B_") else n2
        slabs.setdefault(name, _rand((B, 2 * TB + 2, IB, cols), gen, cuda))
    WKX = {nm: _rand((B, TB, n2 + TB + 1), gen, cuda) for nm in ("WP", "WB", "WBP")}
    WJX = {nm: _rand((B, TB, n2), gen, cuda) for nm in ("WP", "WB", "WBP")}
    table = reduction_table(slabs, WKX, WJX, s, n2)
    assert table.shape == (B, 13, IB, n2)
    out = torch.empty(table.shape, dtype=torch.int32, device=cuda)
    for tt in (0, (s - 2) // 2, s - 2):
        before = (cuda_ops.LAUNCHES, cuda_ops.WINDOWS)
        cuda_ops.minplus_group(table, tt, out)
        torch.cuda.synchronize()
        assert (cuda_ops.LAUNCHES, cuda_ops.WINDOWS) == (before[0] + 1, before[1] + 13 * B)
        assert torch.equal(out, cuda_ops.minplus_group_ref(table, tt))


def test_batched_fill_on_cuda_equals_single_fills(cuda):
    """batched_fill6 at bucket 48 with B=4 (lengths 41-48, padding inside
    the batch), bit-equal on every array to each sequence's own fill6, with
    one tt_span launch per span for the whole batch."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.dist.batch import batched_fill6
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables, pad_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    seqs = [_bench_seq(n, seed) for seed, n in enumerate((48, 41, 45, 47))]
    before = _loop_counts()
    st, n_pad = batched_fill6(seqs, sp, DEFAULT_PK)
    torch.cuda.synchronize()
    assert n_pad == 48
    assert _loop_launches(before) == (n_pad - 2, 0, 0)
    for b, seq in enumerate(seqs):
        tabs = pad_seq_tables(build_seq_tables(seq, sp, DEFAULT_PK), n_pad, sp, DEFAULT_PK)
        C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)
        single = tfold.fill6(C, SC4, n_pad, sp.dangles)
        assert set(single) == set(st)
        for k, v in single.items():
            assert torch.equal(st[k][b], v), f"{seq}: {k}"


def test_sharded_fill_on_cuda_equals_fill6(cuda):
    """fill6_sharded at n=48 with P=3 shards on cuda:0 (n2 = 50 padded to
    51 rows): gather() bit-equal to fill6 on every array, with one launch
    per tt step and shard with a span-s row."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.dist.wavefront import fill6_sharded
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    n, P = 48, 3
    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    tabs = build_seq_tables(_bench_seq(n, 3), sp, DEFAULT_PK)
    C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)
    single = tfold.fill6(C, SC4, n, sp.dangles)
    before = _loop_counts()
    st = fill6_sharded(C, SC4, n, sp.dangles, devices=[cuda] * P)
    torch.cuda.synchronize()
    R = -(-(n + 2) // P)
    want = sum((s >= 2) * sum(p * R <= n - s for p in range(P)) for s in range(n))
    assert _loop_launches(before) == (want, 0, 0)
    got = st.gather()
    assert set(got) == set(single)
    for k, v in single.items():
        assert torch.equal(got[k], v), k


def test_sharded_packed_fill_on_cuda_equals_fill7(cuda):
    """fill7_sharded at n=64 (3 segments) with P=3 shards on cuda:0:
    gather() bit-equal to fill7 on every array, with one tt_span launch per
    span and shard with a span-s row."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.dist.wavefront import fill7_sharded
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    n, P = 64, 3
    SEGS = segments7(n)
    assert len(SEGS) == 3
    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    tabs = build_seq_tables(_bench_seq(n, 5), sp, DEFAULT_PK)
    C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)
    single = tfold.fill7(C, SC4, n, sp.dangles, SEGS)
    before = _loop_counts()
    st = fill7_sharded(C, SC4, n, sp.dangles, SEGS, devices=[cuda] * P)
    torch.cuda.synchronize()
    R = -(-(n + 2) // P)
    want = sum((s >= 2) * sum(p * R <= n - s for p in range(P)) for s in range(n))
    assert _loop_launches(before) == (want, 0, 0)
    got = st.gather()
    assert set(got) == set(single)
    for k, v in single.items():
        assert torch.equal(got[k], v), k


def test_two_process_corpus_on_cuda(cuda, tmp_path):
    """python -m ccj_tpu_torch.dist.corpus, two processes on the card(s),
    merged through a loopback TCPStore: the goldens, in corpus order."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    golden = [e for e in json.loads((root / "tests" / "golden" / "corpus.json").read_text())
              if not e["args"] and len(e["seq"]) <= 40]
    corpus, out = tmp_path / "corpus.txt", tmp_path / "out.json"
    corpus.write_text("\n".join(e["seq"] for e in golden) + "\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ccj_tpu_torch.dist.corpus", str(corpus), str(out),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid)],
        env={**os.environ, "PYTHONPATH": str(root)}, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    merged = json.loads(out.read_text())
    assert [r["seq"] for r in merged] == [e["seq"] for e in golden]
    for r, e in zip(merged, golden):
        assert r["error"] is None, r
        assert r["structure"] == e["structure"] and abs(r["energy"] - e["energy"]) < 1e-9, r


def _step_operands(n, s, TB, IB, gen, dev, B):
    """Random operands of one span's tt_step in run_tt_loop's shapes."""
    from ccj_tpu_torch.engine.gapped import DS, PADT

    def small(shape):
        x = _rand(shape, gen, dev)
        return torch.where(x == INF, INF, x.clamp(-400, 400))

    n2 = n + 2
    UB = n2 + TB
    plane = lambda: _rand((B, TB, IB, n2), gen, dev)              # noqa: E731
    bits = lambda: torch.randint(0, 2, (B, TB, n2), generator=gen,  # noqa: E731
                                 dtype=torch.int32).to(dev)
    cur = {k: _rand((B, 2 * TB + 2, IB, n2), gen, dev) for k in cuda_ops.STEP_FAMILIES}
    cur.update({"B_" + k: _rand((B, 2 * TB + 2, IB, UB), gen, dev)
                for k in cuda_ops.STEP_B_SLABS})
    return (_rand((B, cuda_ops.STEP_REDUCTIONS, IB, n2), gen, dev),
            {k: plane() for k in cuda_ops.STEP_BASES}, cur,
            _rand((B, TB + 2 * PADT, IB, UB + DS), gen, dev),
            small((B, DS, DS, TB, UB)), (bits(), bits(), small((B, TB, n2))),
            (torch.rand((TB, IB, n2), generator=gen) < 0.8).to(dev),
            plane(), plane(), plane())


# (n, s, TB, IB, B, i0): the main steps of the dense fill at n=100 and 128,
# the packed fill at n=200 (segment 3), the batched fills (100 x 4, 64 x 8),
# a dense row shard (n=100, P=4, shard 1) and a packed one (n=200, P=4,
# segment 3, shard 1), and the n=100 step with the most stencil terms
STEP_CASES = [(100, 37, 64, 102, 1, 0), (128, 65, 64, 128, 1, 0),
              (200, 135, 134, 100, 1, 0), (100, 37, 64, 102, 4, 0),
              (64, 33, 32, 64, 8, 0), (100, 37, 64, 26, 1, 26),
              (200, 102, 134, 48, 1, 51), (100, 69, 99, 64, 1, 0)]


@pytest.mark.parametrize("n,s,TB,IB,B,i0", STEP_CASES)
def test_tt_step_kernel_matches_plain(cuda, n, s, TB, IB, B, i0):
    """tt_step on one copy of random operands, tt_step_ref on another, at
    the last, a middle and the first tt step in the loop's order; every
    slab equal after each, one launch each."""
    gen = torch.Generator().manual_seed(n * 31 + B + i0)
    ops_k = _step_operands(n, s, TB, IB, gen, cuda, B)
    ops_p = tuple({k: v.clone() for k, v in x.items()} if isinstance(x, dict)
                  else tuple(v.clone() for v in x) if isinstance(x, tuple)
                  else x.clone() for x in ops_k)
    kw = dict(s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
    tk, tp = cuda_ops.StepTable(*ops_k, **kw), cuda_ops.StepTable(*ops_p, **kw)
    for tt in (s - 2, (s - 2) // 2, 0):
        before = (cuda_ops.TT_STEP_LAUNCHES, cuda_ops.LAUNCHES)
        cuda_ops.tt_step(tk, tt)
        cuda_ops.tt_step_ref(tp, tt)
        torch.cuda.synchronize()
        assert (cuda_ops.TT_STEP_LAUNCHES, cuda_ops.LAUNCHES) == (before[0] + 1, before[1])
        for name, x in ops_k[2].items():
            assert torch.equal(x, ops_p[2][name]), (tt, name)
        assert torch.equal(ops_k[3], ops_p[3]), (tt, "STM")


def test_fold_many_pipeline_on_cuda_matches_fold(cuda):
    """fold_many over two buckets at batch_limit 1, 2 and the default
    equals each sequence's own fold, with one tt_span launch per span."""
    from ccj_tpu_torch import fold, fold_many
    from ccj_tpu_torch.api import bucket_for

    seqs = [_bench_seq(n, seed) for seed, n in enumerate((30, 47, 41, 26, 45, 31))]
    want = [(r.structure, r.energy_dcal) for r in map(fold, seqs)]
    spans = sum(bucket_for(len(q)) - 2 for q in seqs)
    for kw in ({"batch_limit": 1}, {"batch_limit": 2}, {}):
        before = _loop_counts()
        got = fold_many(seqs, **kw)
        assert [r.seq for r in got] == seqs
        assert [(r.structure, r.energy_dcal) for r in got] == want, kw
        assert _loop_launches(before) == (spans, 0, 0), kw


def _span_operands(n, s, TB, IB, gen, dev, B, i0):
    """Random operands of one span's tt_span in run_tt_loop's shapes and
    under its contract: the family slabs SAT16 on the span's valid cells
    (``cuda_ops.span_valid`` of n and i0) and INF elsewhere; mdp, the
    bases, PL / PR / PO, the weights, DPM and jk random."""
    from ccj_tpu_torch.engine.common import SAT16
    from ccj_tpu_torch.engine.gapped import DS

    def small(shape):
        x = _rand(shape, gen, dev)
        return torch.where(x == INF, INF, x.clamp(-400, 400))

    n2 = n + 2
    R = 2 * TB + 2
    validp = cuda_ops.span_valid(n, s, i0, R, IB, n2, dev)
    init = torch.where(validp, SAT16, INF).to(torch.int32)
    plane = lambda: _rand((B, TB, IB, n2), gen, dev)              # noqa: E731
    bits = lambda: torch.randint(0, 2, (B, TB, n2), generator=gen,  # noqa: E731
                                 dtype=torch.int32).to(dev)
    return ({k: init.repeat(B, 1, 1, 1) for k in cuda_ops.STEP_FAMILIES},
            _rand((B, R, IB, n2), gen, dev),
            {k: _rand((B, TB, n2 + TB + 1), gen, dev) for k in cuda_ops.SPAN_WEIGHTS},
            {k: _rand((B, TB, n2), gen, dev) for k in cuda_ops.SPAN_WEIGHTS},
            {k: plane() for k in cuda_ops.STEP_BASES}, small((B, DS, DS, TB, n2 + TB)),
            (bits(), bits(), small((B, TB, n2))), plane(), plane(), plane())


def _clone_ops(ops):
    return tuple({k: v.clone() for k, v in x.items()} if isinstance(x, dict)
                 else tuple(v.clone() for v in x) if isinstance(x, tuple)
                 else x.clone() for x in ops)


@pytest.mark.parametrize("n,s,TB,IB,B,i0", STEP_CASES)
def test_tt_span_kernel_matches_plain(cuda, n, s, TB, IB, B, i0):
    """tt_span (one launch) on one copy of a span's random operands, its
    plain version tt_span_ref on another and the two-launch loop it
    replaces (tt_span_steps: minplus_group + tt_step a step) on a third:
    every slab equal."""
    gen = torch.Generator().manual_seed(n * 37 + B + i0 + s)
    ops = _span_operands(n, s, TB, IB, gen, cuda, B, i0)
    kw = dict(n=n, s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
    copies = [_clone_ops(ops) for _ in range(3)]
    tk, tp, ts = (cuda_ops.SpanTable(*c, **kw) for c in copies)
    before = _loop_counts()
    cuda_ops.tt_span(tk)
    torch.cuda.synchronize()
    assert _loop_launches(before) == (1, 0, 0)
    cuda_ops.tt_span_ref(tp)
    before = _loop_counts()
    cuda_ops.tt_span_steps(ts)
    torch.cuda.synchronize()
    assert _loop_launches(before) == (0, s - 1, s - 1)
    for name in cuda_ops.STEP_FAMILIES:
        assert torch.equal(copies[0][0][name], copies[1][0][name]), (name, "plain")
        assert torch.equal(copies[0][0][name], copies[2][0][name]), (name, "two-launch")


@pytest.mark.parametrize("cluster", [2, 4])
def test_tt_span_cluster_variants_match_plain(cuda, cluster):
    """The thread-block-cluster plans (several blocks per row, each with the
    whole band and a share of the step's tasks, their partial minima met
    through distributed shared memory) at the n=100 fill's heaviest span
    and a row shard of the main one; alone, with only 1 / ``cluster`` of
    the band's rows on chip (the rest read back from device memory, as a
    band too large for shared memory is), and with 512 threads a block and
    the weights through __ldg."""
    for n, s, TB, IB, B, i0 in ((100, 69, 99, 64, 1, 0), (100, 37, 64, 26, 1, 26)):
        seed = cluster * 101 + s
        ops = _span_operands(n, s, TB, IB, torch.Generator().manual_seed(seed), cuda, B, i0)
        kw = dict(n=n, s=s, i0=i0, bp=-90, cp=-60, ap=340, PB=960)
        cuda_ops.tt_span_ref(cuda_ops.SpanTable(*ops, **kw))
        for plan in ({"cluster": cluster}, {"cluster": cluster, "rows": (s - 1) // cluster},
                     {"cluster": cluster, "stage": 0, "threads": 512}):
            got = _span_operands(n, s, TB, IB, torch.Generator().manual_seed(seed), cuda, B, i0)
            table = cuda_ops.SpanTable(*got, **kw)
            cuda_ops.tt_span(table, plan)
            torch.cuda.synchronize()
            assert table.plan["cluster"] == cluster
            assert table.plan["rows"] == plan.get("rows", s - 1), table.plan
            for name in cuda_ops.STEP_FAMILIES:
                assert torch.equal(got[0][name], ops[0][name]), (n, s, name, plan)


# ---------------------------------------------------------------------------
# history_min and p_split (chip_smoke.py phase 2d's shapes)
# ---------------------------------------------------------------------------

# (n, s, B, i0, rows, packed): the n=100 main span, n=128's, the packed n=200
# span 135 (segment 3, four prior segments), bucket 100 x 4, a dense row
# shard (26 rows from i0 = 26), a packed one (48 rows from i0 = 51), and
# n=37, whose odd n2 takes history_min's one-cell-a-load path
HP_CASES = [(100, 37, 1, 0, None, False), (128, 65, 1, 0, None, False),
            (200, 135, 1, 0, None, True), (100, 37, 4, 0, None, False),
            (100, 37, 1, 26, 26, False), (200, 102, 1, 51, 48, True),
            (37, 20, 1, 0, None, False)]


def _rand16(shape, gen, dev):
    x = torch.randint(-3000, 4000, shape, generator=gen, dtype=torch.int16, device=dev)
    return x.masked_fill_(x >= 3000, 32767)


def _history_launches(n, s, B, i0, rows, packed, gen, dev):
    """The history_min launches the fills make at this shape on a random
    state, each as (windows, tables, keywords) taken by a spy: the
    unsharded reader's one launch (``SpanReads.history``), or a row
    shard's two (its RL windows on its own rows, its RI windows on the C
    rows l = i + s, one owner holding them all)."""
    from ccj_tpu_torch.engine import gapped4, gapped5

    n2, T, S = n + 2, n - 1, n
    W = {}
    for k in gapped4.HISTORY_TABLES:
        W[k] = torch.randint(-500, 600, (B, n2, n2), generator=gen, dtype=torch.int32,
                             device=dev)
        W[k].masked_fill_(W[k] >= 500, INF)
    fams = {(m, f) for _k, m, f, _t, _g in gapped4.HISTORY_SCANS}
    st = {}
    if packed:
        segs = gapped5.segments7(n)
        gi = next(g for g, (lo, hi, *_r) in enumerate(segs) if lo <= s < hi)
        TB, IB = segs[gi][2], segs[gi][3]
        for h in range(gi + 1):
            lo, hi, TBh, IBh, Lc = segs[h]
            for m, f in fams:
                key, R_ = (f"{f}@{h}", IBh) if m == cuda_ops.RL else (f"C_{f}@{h}", Lc)
                st[key] = _rand16((B, TBh, hi - lo, R_, n2), gen, dev)
        hist = gapped5.prior_segments(segs, gi, s)
        full = lambda: gapped5.packed_reads(st, n, s, gi, segs)  # noqa: E731
        rl = lambda cut: gapped5.packed_rl(cut, s, gi, segs, rows)  # noqa: E731
        nr = min(rows or 0, n2 - i0 - s)
        ri = lambda f: [(st[f"C_{f}@{h}"][:, :, :nsh, i0 + s - lo - 1:i0 + s - lo - 1 + nr],  # noqa: E731
                         s - lo) for h, lo, nsh in hist]
    else:
        TB, IB = gapped4.bucket_dims(n, s)
        for m, f in fams:
            st[f if m == cuda_ops.RL else "C_" + f] = _rand16((B, T, S, n2, n2), gen, dev)
        sp0 = max(s - TB, 0)
        full = lambda: gapped4.dense_reads(st, n, s, TB, IB)  # noqa: E731
        rl = lambda cut: gapped4.dense_rl(cut, s, TB, rows)  # noqa: E731
        ri = lambda f: [(st["C_" + f][:, :TB, sp0:sp0 + TB, i0 + s:min(i0 + s + rows, n2)],  # noqa: E731
                         s - sp0)]
    seen = []
    real = cuda_ops.history_min

    def spy(windows, tables, **kw):
        seen.append((windows, tables, kw))
        return real(windows, tables, **kw)

    cuda_ops.history_min = spy
    try:
        if rows is None:
            full().history(W)
        else:
            cut = {k: v[..., i0:i0 + rows, :] for k, v in st.items() if not k.startswith("C_")}
            for mode, fam_of in ((cuda_ops.RL, rl(cut)), (cuda_ops.RI, ri)):
                gapped4.history_launch(gapped4.history_groups(mode), lambda m, f: fam_of(f),
                                       W, s, i0, TB, rows)
    finally:
        cuda_ops.history_min = real
    assert len(seen) == (1 if rows is None else 2)
    return seen


@pytest.mark.parametrize("n,s,B,i0,rows,packed", HP_CASES)
def test_history_kernel_matches_plain(cuda, n, s, B, i0, rows, packed):
    """Every launch of the span's scans (16 planes unsharded; 9 and 7 in a
    row shard's two) exact against the plain version, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(n + s + B + i0)
    for windows, tables, kw in _history_launches(n, s, B, i0, rows, packed, gen, cuda):
        cut, K = cuda_ops.history_windows(windows, tables, kw["R"], kw["s"])
        want = cuda_ops.history_min_ref(cut, tables, kw["s"], kw["i0"], kw["TB"], kw["R"])
        before = cuda_ops.HISTORY_LAUNCHES
        got = cuda_ops.history_min(windows, tables, **kw)
        torch.cuda.synchronize()
        assert cuda_ops.HISTORY_LAUNCHES == before + 1
        assert K in (16, 9, 7) and tuple(got.shape) == tuple(want.shape)
        assert torch.equal(got, want)
        assert bool((got < INF).any())
        del got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("n,s,B,i0,rows,packed", HP_CASES)
def test_p_split_kernel_matches_plain(cuda, n, s, B, i0, rows, packed):
    """PKD in place (the unsharded fills) or its rows stacked per a (a row
    shard's operand); exact against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(n * s + B + i0)
    n2, T, S = n + 2, n - 1, n
    PKD = _rand16((B, T, S, n2, n2), gen, cuda)
    PKE = _rand16((B, T, S + T + 2, n2, n2), gen, cuda)
    if rows is None:
        pke, pkd, kw = PKE, PKD.transpose(1, 2), dict(s=s, n=n, i0=0, R=n2, sp=(s - 1, -1),
                                                      ro=(1, 1))
    else:
        pkd = torch.full((B, s - 1, T, rows, n2), 32767, dtype=torch.int16, device=cuda)
        for a in range(s - 1):
            got = PKD[:, :, s - a - 1, i0 + a + 1:i0 + a + 1 + rows]
            pkd[:, a, :, :got.shape[2]] = got
        pke, kw = PKE[..., i0:i0 + rows, :], dict(s=s, n=n, i0=i0, R=rows, sp=(0, 1),
                                                 ro=(0, 0))
    want = cuda_ops.p_split_ref(pke, pkd, kw["s"], kw["n"], kw["i0"], kw["R"], kw["sp"],
                                kw["ro"])
    before = cuda_ops.PSPLIT_LAUNCHES
    got = cuda_ops.p_split(pke, pkd, **kw)
    torch.cuda.synchronize()
    assert cuda_ops.PSPLIT_LAUNCHES == before + 1
    assert torch.equal(got, want)
    assert bool((want < INF).any())


@pytest.mark.parametrize("n,packed", [(100, False), (134, True)])
def test_fill_launches_history_and_p_split(cuda, n, packed):
    """A dense (n=100) and a packed (n=134) fill: one history_min a span
    s >= 1 (all 16 RL / RI scans), one p_split per span with a term (3 <= s
    <= n - 1), one tt_span, one stencil_pl and one stencil_pr per span with
    a tt step."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    tabs = build_seq_tables(_bench_seq(n, 42), sp, DEFAULT_PK)
    C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)
    def counts():
        return (*_loop_counts(), cuda_ops.HISTORY_LAUNCHES, cuda_ops.PSPLIT_LAUNCHES,
                cuda_ops.STENCIL_PL_LAUNCHES, cuda_ops.STENCIL_PR_LAUNCHES,
                cuda_ops.STENCIL_LAUNCHES)

    before = counts()
    st = (tfold.fill7(C, SC4, n, sp.dangles, segments7(n)) if packed
          else tfold.fill6(C, SC4, n, sp.dangles))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        n - 2, 0, 0, n - 1, n - 3, n - 2, n - 2, 2 * (n - 2))
    if n == 100:
        assert int(st["V"][1, n]) == -1528


def _stencil_operands(n, s, B, i0, rows, packed, gen, dev, mixed=False):
    """The PL and PR stencil calls the fills make at this shape on a random
    state, the bench sequence's weights (``mixed``: element b those of the
    seed 42 + b sequence): ({"PL": (parts, W4PL), "PR": (parts, W4PR)},
    keywords); a row shard's window is its rows (and PL's 29-row halo) of
    the state's."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine import gapped4, gapped5
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))

    def weights(seed):
        tabs = build_seq_tables(_bench_seq(n, seed), sp, DEFAULT_PK)
        return tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), dev)[1]

    if mixed:
        per = [weights(42 + b) for b in range(B)]
        SC4 = {k: torch.stack([p[k] for p in per]) for k in ("W4PL", "W4PR")}
    else:
        SC4 = {k: v[None].expand(B, *v.shape) for k, v in weights(42).items()}
    n2, T, S = n + 2, n - 1, n
    st = {"PKD": torch.zeros((B, 1, 1, 1, n2), dtype=torch.int16, device=dev)}
    if packed:
        segs = gapped5.segments7(n)
        gi = next(g for g, (lo, hi, *_r) in enumerate(segs) if lo <= s < hi)
        TB, IB = segs[gi][2], segs[gi][3]
        for name in ("PL", "PR"):
            for h in range(gi + 1):
                lo, hi, TBh, IBh, _ = segs[h]
                st[f"{name}@{h}"] = _rand16((B, TBh, hi - lo, IBh, n2), gen, dev)
        reads = gapped5.packed_reads(st, n, s, gi, segs)
    else:
        TB, IB = gapped4.bucket_dims(n, s)
        for name in ("PL", "PR"):
            st[name] = _rand16((B, T, S, n2, n2), gen, dev)
        reads = gapped4.dense_reads(st, n, s, TB, IB)
    ops = {}
    for name, halo in (("PL", 29), ("PR", 0)):
        parts = reads.window(name, halo)
        if rows is not None:
            parts = [(v[..., i0:i0 + rows + halo, :], u0) for v, u0 in parts]
        ops[name] = (parts, SC4["W4" + name])
    return ops, dict(s=s, n=n, i0=i0, TB=TB, R=IB if rows is None else rows)


# phase 2e's shapes: the n=100 main span, n=128's, the packed n=200 span 135
# and span 110 (its window over segments 2 and 3), bucket 100 x 4, a dense
# row shard (26 rows from i0 = 26), a packed one (48 rows from i0 = 51), a
# batch of two sequences' weights (the kernel's masks differ per element)
# the n=100 span 8 (1-7 valid tt rows a column) and the n=37 span 20 (n2 and
# the tt stride odd: the staged rows' word parity alternates)
STENCIL_CASES = [pytest.param(*c, False, id="-".join(map(str, c))) for c in (
    (100, 37, 1, 0, None, False), (128, 65, 1, 0, None, False),
    (200, 135, 1, 0, None, True), (200, 110, 1, 0, None, True),
    (100, 37, 4, 0, None, False), (100, 37, 1, 26, 26, False),
    (200, 102, 1, 51, 48, True))] + [
    pytest.param(100, 37, 2, 0, None, False, True, id="100-37-2-mixed"),
    pytest.param(100, 8, 1, 0, None, False, False, id="100-8-1-small-span"),
    pytest.param(37, 20, 1, 0, None, False, False, id="37-20-1-odd-n2")]


@pytest.mark.parametrize("n,s,B,i0,rows,packed,mixed", STENCIL_CASES)
def test_stencil_kernels_match_plain(cuda, n, s, B, i0, rows, packed, mixed):
    gen = torch.Generator(device=cuda).manual_seed(n + 3 * s + B + i0)
    ops, kw = _stencil_operands(n, s, B, i0, rows, packed, gen, cuda, mixed)
    if mixed:                  # the elements' weights differ
        assert not torch.equal(ops["PL"][1][0], ops["PL"][1][1])
    for name, fn, ref in (("PL", cuda_ops.stencil_pl, cuda_ops.stencil_pl_ref),
                          ("PR", cuda_ops.stencil_pr, cuda_ops.stencil_pr_ref)):
        parts, w = ops[name]
        want = ref(cuda_ops.stencil_parts(parts, B, n + 2, s), w, s, n, i0, kw["TB"],
                   kw["R"])
        before = (cuda_ops.STENCIL_LAUNCHES, cuda_ops.STENCIL_PL_LAUNCHES,
                  cuda_ops.STENCIL_PR_LAUNCHES)
        got = fn(parts, w, **kw)
        torch.cuda.synchronize()
        after = (cuda_ops.STENCIL_LAUNCHES, cuda_ops.STENCIL_PL_LAUNCHES,
                 cuda_ops.STENCIL_PR_LAUNCHES)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (1, 1, 0) if name == "PL" else (1, 0, 1))
        assert torch.equal(got, want), name
        assert bool((want < INF).any()), name


def test_stencil_refuses_a_view_with_a_j_stride(cuda):
    """The kernels copy a view's rows as 4-byte words: a view whose j axis
    is not contiguous is refused, not read wrong."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    ops, kw = _stencil_operands(100, 37, 1, 0, None, False, gen, cuda)
    for name, fn in (("PL", cuda_ops.stencil_pl), ("PR", cuda_ops.stencil_pr)):
        parts, w = ops[name]
        strided = []
        for v, u0 in parts:        # the same values, every other element of j
            wide = torch.zeros((*v.shape[:-1], 2 * v.shape[-1]), dtype=v.dtype,
                               device=cuda)
            wide[..., ::2] = v
            strided.append((wide[..., ::2], u0))
        assert strided[0][0].stride(4) == 2
        before = cuda_ops.STENCIL_LAUNCHES
        with pytest.raises(ValueError, match="j stride must be 1"):
            fn(strided, w, **kw)
        assert cuda_ops.STENCIL_LAUNCHES == before, name


# span_assemble and span_store (chip_smoke.py phase 2f's calls: the fills'
# own, on a random state): the odd-n2 n=37 span 20, a batch of two and one
# of four at n2 = 102 (not a multiple of 8: runs that start off a 16-byte
# boundary), a dense row shard (its halo row a second view, another
# shard's; a staging slab for the C rows other shards own), the packed
# n=134 span 93 (its reads in segments 2 and 3) and a packed row shard;
# every case writes PKE's anti-diagonal view
SPAN_CASES = [pytest.param(dict(B=B, i0=i0, rows=rows, packed=packed, n=n, s=s, label=lab),
                           id=lab) for lab, n, s, B, i0, rows, packed in (
    ("37-20-odd-n2", 37, 20, 1, 0, None, False),
    ("100-37-batch-2", 100, 37, 2, 0, None, False),
    ("100-37-batch-4", 100, 37, 4, 0, None, False),
    ("100-37-row-shard", 100, 37, 1, 26, 26, False),
    ("134-93-packed", 134, 93, 1, 0, None, True),
    ("134-62-packed-row-shard", 134, 62, 1, 34, 34, True))]


def _span_calls(case, dev):
    import chip_smoke

    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.params import parse_par, scale_parameters

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    gen = torch.Generator(device=dev).manual_seed(case["n"] + case["s"])
    return chip_smoke.span_kernel_calls(cuda_ops, case, sp, gen, dev)


def _store_matches_plain(sa, skw):
    """span_store (one launch) against span_store_ref on the same
    destinations, each filled with -7 before the plain version writes it."""
    dests = sa[0]
    before = cuda_ops.STORE_LAUNCHES
    cuda_ops.span_store(*sa, **skw)
    torch.cuda.synchronize()
    assert cuda_ops.STORE_LAUNCHES == before + 1
    kernel_views = [d.view.clone() for d in dests]
    for d in dests:
        d.view.fill_(-7)
    cuda_ops.span_store_ref(*sa, **skw)
    for d, k in zip(dests, kernel_views):
        assert torch.equal(d.view, k), d.family


@pytest.mark.parametrize("case", SPAN_CASES)
def test_span_kernels_match_plain(cuda, case):
    with torch.inference_mode():
        (aa, akw), (sa, skw), _st = _span_calls(case, cuda)
        dests = sa[0]
        assert sum(d.skew for d in dests) == 2          # PKD[:, :, s] and PKE's diagonal
        if case["rows"] is not None and not case["packed"]:
            assert any(d.view._base is None for d in dests), "no staging slab"
        if (case["n"] + 2) % 8:
            assert any(d.view.data_ptr() % 16 for d in dests), "no run off 16 bytes"
        want = cuda_ops.span_assemble_ref(*aa, **akw)
        before = (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES)
        got = cuda_ops.span_assemble(*aa, **akw)
        torch.cuda.synchronize()
        for name, g, w in zip(cuda_ops.SpanAssembly._fields, got, want):
            assert torch.equal(g, w), name
        assert bool((want.PLs < INF).any())
        _store_matches_plain(sa, skw)
        assert (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 1)


def test_span_store_takes_a_destination_whose_row_stride_is_not_n2(cuda):
    """No layout makes one, but the kernel takes it a row a run: every
    other row of a slab, beside the span's own destinations."""
    with torch.inference_mode():
        (_aa, _akw), (sa, skw), _st = _span_calls(dict(SPAN_CASES[1].values[0]), cuda)
        dests, loops, xs = sa
        n2 = skw["n"] + 2
        big = torch.zeros((xs.shape[1], skw["TB"] + 3, 2 * 40, n2), dtype=torch.int16,
                          device=cuda)
        extra = [cuda_ops.StoreDest("PL", big[:, :, ::2], 5),
                 cuda_ops.StoreDest("PK", big[:, 1:, 1::2], skew=True)]
        assert all(d.view.stride(2) == 2 * n2 for d in extra)
        _store_matches_plain(([*dests[:20], *extra], loops, xs), skw)


def test_span_kernels_refuse_a_view_with_a_j_stride(cuda):
    """The warps' lanes take consecutive j: a plane view or a destination
    whose j axis is not contiguous is refused, not read or written wrong."""
    with torch.inference_mode():
        (aa, akw), (sa, skw), _st = _span_calls(dict(SPAN_CASES[0].values[0]), cuda)

        def strided(v):             # the same values, every other element of j
            wide = torch.zeros((*v.shape[:-1], 2 * v.shape[-1]), dtype=v.dtype, device=cuda)
            wide[..., ::2] = v
            return wide[..., ::2]

        planes = [[(strided(v), t0, r0) for v, t0, r0 in p] for p in aa[0]]
        before = (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES)
        with pytest.raises(ValueError, match="j stride must be 1"):
            cuda_ops.span_assemble(planes, *aa[1:], **akw)
        dests = [cuda_ops.StoreDest(d.family, strided(d.view), d.r0, d.skew) for d in sa[0]]
        with pytest.raises(ValueError, match="j stride must be 1"):
            cuda_ops.span_store(dests, *sa[1:], **skw)
        assert (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES) == before


def test_fill_launches_span_kernels(cuda):
    """One span_assemble and one span_store a span on the dense (n=60) and
    the packed (n=134) fill, and a span and row shard on the row-sharded
    one (n=60, P=3)."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.dist.wavefront import fill6_sharded, row_partition, span_rows
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))

    def counts():
        return (cuda_ops.ASSEMBLE_LAUNCHES, cuda_ops.STORE_LAUNCHES)

    for n, run, want in (
            (60, lambda C, S: tfold.fill6(C, S, 60, sp.dangles), 60),
            (134, lambda C, S: tfold.fill7(C, S, 134, sp.dangles, segments7(134)), 134),
            (60, lambda C, S: fill6_sharded(C, S, 60, sp.dangles, devices=[cuda] * 3),
             sum(len(span_rows(60, row_partition(60, 3)[0], 3, s)) for s in range(60)))):
        tabs = build_seq_tables(_bench_seq(n, 42), sp, DEFAULT_PK)
        C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)
        before = counts()
        run(C, SC4)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (want, want), n


# ---------------------------------------------------------------------------
# span_v, span_wbp, span_wm, wx_tables: the span's 2-D recurrences
# ---------------------------------------------------------------------------

SPAN2D = {"span_v": "SPAN_V_LAUNCHES", "span_wbp": "SPAN_WBP_LAUNCHES",
          "span_wm": "SPAN_WM_LAUNCHES", "wx_tables": "WX_LAUNCHES"}


def _span2d_consts(n, dangles, B, dev):
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE), dangles=dangles)
    Cs = [tfold.consts_from_numpy(tfold.build_consts(
        build_seq_tables(_bench_seq(n, 42 + b), sp, DEFAULT_PK), sp, DEFAULT_PK), dev,
        sc4_np={})[0] for b in range(B)]
    return tfold.stack_consts(Cs)


@pytest.mark.parametrize("dangles", [0, 1, 2])
@pytest.mark.parametrize("n,spans", [(37, tuple(range(37))), (100, (0, 1, 3, 4, 37, 99)),
                                     (200, (2, 5, 135, 199))])
def test_span2d_kernels_match_plain(cuda, n, spans, dangles):
    """Each 2-D kernel against its plain version on a batch of four random
    states (INF, TRI_UNSET and V_UNSET cells among them): the whole 2-D
    state after the kernel (span_wbp also as the fills call it, with random
    P-split minima and the kept weight tables, compared too), one launch a
    call where the span has cells to write (span_v s >= 1, span_wm
    s >= 3), none elsewhere."""
    import chip_smoke

    C = _span2d_consts(n, dangles, 4, cuda)
    gen = torch.Generator().manual_seed(n + dangles)
    for s in spans:
        st0 = chip_smoke.span2d_state(4, n, gen, cuda)
        calls = [(name, counter, {}) for name, counter in SPAN2D.items()]
        calls.append(("span_wbp", SPAN2D["span_wbp"], {
            "p_min": chip_smoke.span2d_pmin(4, n, gen, cuda),
            "wx": cuda_ops.wx_tables_ref(C, {k: v.cpu() for k, v in st0.items()}).to(cuda)}))
        for name, counter, kw in calls:
            args = (s, dangles) if name in ("span_v", "span_wm") else (
                (s,) if name == "span_wbp" else ())
            got = {k: v.clone() for k, v in st0.items()}
            want = {k: v.clone() for k, v in st0.items()}
            kw_k = {k: v.clone() for k, v in kw.items()}
            kw_p = {k: v.clone() for k, v in kw.items()}
            before = getattr(cuda_ops, counter)
            out_k = getattr(cuda_ops, name)(C, got, *args, **kw_k)
            torch.cuda.synchronize()
            launched = {"span_v": s >= 1, "span_wm": s >= 3}.get(name, True)
            assert getattr(cuda_ops, counter) == before + launched, (name, s)
            out_p = getattr(cuda_ops, f"{name}_ref")(C, want, *args, **kw_p)
            if name == "wx_tables":
                for g, w in zip(out_k, out_p):
                    assert torch.equal(g, w), (name, s)
            for k in st0:
                assert torch.equal(got[k], want[k]), (name, s, k, sorted(kw))
            for k in kw:
                assert torch.equal(kw_k[k], kw_p[k]), (name, s, k)


def test_span2d_kernels_take_operands_through_their_strides(cuda):
    """Column-major tables (as numpy hands some of them to the fills), a
    batch of one as a view, and a state array read through a strided view:
    each kernel equals its plain version on the same operands."""
    import chip_smoke

    from ccj_tpu_torch.engine import fold as tfold

    for dangles in (1, 2):
        C = tfold.add_batch({k: v[0] if isinstance(v, torch.Tensor) else v
                             for k, v in _span2d_consts(100, dangles, 1, cuda).items()})
        C = {**C, **{k: C[k].transpose(1, 2).contiguous().transpose(1, 2)
                     for k in ("H", "MB0", "MB2", "MB_5", "ML0", "ML2", "ML_ip1")},
             "EINT": C["EINT"].permute(0, 4, 3, 2, 1).contiguous().permute(0, 4, 3, 2, 1)}
        st0 = chip_smoke.span2d_state(1, 100, torch.Generator().manual_seed(dangles), cuda)
        for name, args in (("span_v", (37, dangles)), ("span_wbp", (37,)),
                           ("span_wm", (37, dangles)), ("wx_tables", ())):
            got = {k: v.clone() for k, v in st0.items()}
            wide = torch.zeros((1, 102, 204), dtype=torch.int32, device=cuda)
            wide[..., ::2] = got["WM"]
            got["WM"] = wide[..., ::2]
            want = {k: v.clone() for k, v in st0.items()}
            out_k = getattr(cuda_ops, name)(C, got, *args)
            out_p = getattr(cuda_ops, f"{name}_ref")(C, want, *args)
            torch.cuda.synchronize()
            if name == "wx_tables":
                for g, w in zip(out_k, out_p):
                    assert torch.equal(g, w), name
            for k in st0:
                assert torch.equal(got[k], want[k]), (name, k)


def test_span2d_kernels_refuse_operands_on_two_devices(cuda):
    import chip_smoke

    C = _span2d_consts(37, 2, 1, cuda)
    st = chip_smoke.span2d_state(1, 37, torch.Generator().manual_seed(1), cuda)
    before = tuple(getattr(cuda_ops, c) for c in SPAN2D.values())
    with pytest.raises(ValueError, match="one device"):
        cuda_ops.span_wbp(C, {**st, "P2": st["P2"].cpu()}, 20)
    with pytest.raises(ValueError, match="one device"):
        cuda_ops.span_v({**C, "EINT": C["EINT"].cpu()}, st, 20, 2)
    assert tuple(getattr(cuda_ops, c) for c in SPAN2D.values()) == before


def test_fill_launches_span2d_kernels(cuda):
    """fill6 at n=100 and fill7 at n=134 (its tables as numpy gives them,
    some column-major): one span_v a span s >= 1, one span_wbp a span, one
    span_wm a span s >= 3 and one wx_tables a fill (the weight tables kept
    by span_wbp); V(1, 100) is bench.py's golden."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    for n in (100, 134):
        tabs = build_seq_tables(_bench_seq(n, 42), sp, DEFAULT_PK)
        C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)
        before = tuple(getattr(cuda_ops, c) for c in SPAN2D.values())
        st = (tfold.fill6(C, SC4, n, sp.dangles) if n <= 128 else
              tfold.fill7(C, SC4, n, sp.dangles, segments7(n)))
        torch.cuda.synchronize()
        got = tuple(getattr(cuda_ops, c) - b for c, b in zip(SPAN2D.values(), before))
        assert got == (n - 1, n, n - 3, 1)
        if n == 100:
            assert int(st["V"][1, 100]) == -1528


def test_kept_weight_tables_equal_wx_tables_after_every_span(cuda):
    """The fills' kept weight tables against a from-scratch wx_tables after
    every span's WBP/WPP update: fill6 at n=100, fill7 on the n=134 anchor,
    fill6_sharded at n=100 with P=2 (chip_smoke.kept_tables_check)."""
    import chip_smoke

    got = chip_smoke.kept_tables_check(cuda_ops, cuda)
    assert got["spans_checked"] == {"fill6 n=100": 100, "fill7 n=134": 134,
                                    "fill6_sharded n=100 P=2": 100}


def _span2d_case_operands(case, dev, gen):
    """The bench tables of one ``chip_smoke.span2d_cases`` shape as the
    fills hand them (a batch of one as a view, EINT cell-major) and a
    random 2-D state."""
    import chip_smoke

    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine.nested import cell_major_eint

    n, B, d = case["n"], case["B"], case["dangles"]
    C = _span2d_consts(n, d, B, dev)
    if B == 1:
        C = tfold.add_batch({k: v[0] if isinstance(v, torch.Tensor) else v
                             for k, v in C.items()})
    return cell_major_eint({**C, "n": n}), chip_smoke.span2d_state(B, n, gen, dev)


def test_span_wm_matches_plain_plainly_and_as_a_dependent_after_span_store(cuda):
    """span_wm at every phase-2g shape, exactly against its plain version:
    launched plainly, and right after a span_store (n=37 span 20's, on a
    random 4-D state) as its programmatic dependent, as the fills launch
    it; one launch a call.  This holds the dependent launch's own path
    (its loads before griddepcontrol.wait, its writes after); the two
    kernels share no memory, so it shows no race: the fills through their
    launch tables (below) and the golden folds hold the condition."""
    import chip_smoke

    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine.gapped4 import bucket_dims
    from ccj_tpu_torch.params import parse_par, scale_parameters

    store_case = next(c for c in chip_smoke.span_cases(bucket_dims) if c["n"] == 37)
    _a, (sa, skw), _st = chip_smoke.span_kernel_calls(
        cuda_ops, store_case, scale_parameters(parse_par(DEFAULT_PARAM_FILE)),
        torch.Generator(device=cuda).manual_seed(3), cuda)
    gen = torch.Generator().manual_seed(11)
    for case in chip_smoke.span2d_cases(bucket_dims):
        C, st0 = _span2d_case_operands(case, cuda, gen)
        s, d = case["s"], case["dangles"]
        want = {k: v.clone() for k, v in st0.items()}
        cuda_ops.span_wm_ref(C, want, s, d)
        for after_store in (False, True):
            got = {k: v.clone() for k, v in st0.items()}
            before = cuda_ops.SPAN_WM_LAUNCHES
            if after_store:
                cuda_ops.span_store(*sa, **skw)
            cuda_ops.span_wm(C, got, s, d, dependent=after_store)
            torch.cuda.synchronize()
            assert cuda_ops.SPAN_WM_LAUNCHES == before + 1
            for k in st0:
                assert torch.equal(got[k], want[k]), (case["label"], after_store, k)


@pytest.mark.parametrize("n,B,layout", [(100, 1, "contiguous"), (100, 4, "contiguous"),
                                        (100, 2, "column-major"), (37, 1, "contiguous"),
                                        (37, 4, "contiguous"), (37, 3, "column-major"),
                                        (38, 3, "strided")])
def test_wx_tables_matches_plain_on_every_layout(cuda, n, B, layout):
    """wx_tables exactly against its plain version: contiguous WBP / WPP
    (read at the cell's flat offset), column-major ones and a strided view
    (through their strides), even and odd n2, batches of 1 to 4."""
    import chip_smoke

    C = _span2d_consts(n, 2, B, cuda)
    st = chip_smoke.span2d_state(B, n, torch.Generator().manual_seed(n + B), cuda)
    for k in ("WBP", "WPP"):
        if layout == "column-major":
            st[k] = st[k].transpose(1, 2).contiguous().transpose(1, 2)
        elif layout == "strided":
            wide = torch.zeros((B, n + 2, 2 * (n + 2)), dtype=torch.int32, device=cuda)
            wide[..., 1::2] = st[k]
            st[k] = wide[..., 1::2]
    before = cuda_ops.WX_LAUNCHES
    got = cuda_ops.wx_tables(C, st)
    torch.cuda.synchronize()
    assert cuda_ops.WX_LAUNCHES == before + 1
    assert torch.equal(got, cuda_ops.wx_tables_ref(C, st)), (n, B, layout)


@pytest.mark.parametrize("n", [100, 134])
def test_fill_through_its_launch_tables_equals_the_checked_fill(cuda, n, monkeypatch):
    """fill6 at n=100 and fill7 at n=134 with the 2-D kernels launched
    through the fill's launch tables (cuda_ops.span2d_fill_tables, packed
    once, span_wm a dependent launch after each span_store) against the
    same fill with every launch packed on the checked path (no table in the
    fill's dict), array by array; the same launch counts."""
    from ccj_tpu_torch.api import DEFAULT_PARAM_FILE
    from ccj_tpu_torch.engine import fold as tfold
    from ccj_tpu_torch.engine.gapped5 import segments7
    from ccj_tpu_torch.params import DEFAULT_PK, parse_par, scale_parameters
    from ccj_tpu_torch.precompute import build_seq_tables

    sp = scale_parameters(parse_par(DEFAULT_PARAM_FILE))
    tabs = build_seq_tables(_bench_seq(n, 42), sp, DEFAULT_PK)
    C, SC4 = tfold.consts_from_numpy(tfold.build_consts(tabs, sp, DEFAULT_PK), cuda)

    def fill():
        before = tuple(getattr(cuda_ops, c) for c in SPAN2D.values())
        st = (tfold.fill6(C, SC4, n, sp.dangles) if n <= 128 else
              tfold.fill7(C, SC4, n, sp.dangles, segments7(n)))
        torch.cuda.synchronize()
        return st, tuple(getattr(cuda_ops, c) - b for c, b in zip(SPAN2D.values(), before))

    tables, counts = fill()
    assert counts == (n - 1, n, n - 3, 1)
    monkeypatch.setattr(cuda_ops, "span2d_fill_tables",
                        lambda C, st, dangles: dict.fromkeys(("span_v", "span_wbp", "span_wm")))
    checked, counts_checked = fill()
    assert counts_checked == counts
    assert tables.keys() == checked.keys()
    for k in tables:
        assert torch.equal(tables[k], checked[k]), k
