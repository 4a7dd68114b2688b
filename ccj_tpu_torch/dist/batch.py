"""Batched data-parallel folding on one CUDA device (PyTorch).

Counterpart of ``ccj_tpu/dist/batch.py``'s ``batched_fill6``.  Sequences
are padded to a common length bucket (``api.bucket_for``), each one's
tables are built and padded (``precompute.pad_seq_tables``: the
true-length window of a padded fill is bit-identical to an unpadded one)
and stacked with a leading batch axis, and the dense fill runs the whole
batch in one span loop (``fold.fill6_batched``).  Every operation of the
fill is issued once for the B sequences, among them one ``tt_span``
launch per span, where the single fill issues it once per sequence.

The JAX function's ``mesh`` argument (the batch axis sharded over a
``data`` mesh of devices) has no counterpart here.  Data parallelism over
several cards is one process per card, which is ``dist/corpus.py``:

* the port's fill is bound by host dispatch (the device is busy about a
  fifth of an n=100 fill), so one host thread driving two cards would
  issue every span's operations once per card and gain nothing;
* one process per GPU is PyTorch's own idiom for data parallelism.

Not ported (ROADMAP, "Not to port"): ``stack_consts``, ``batched_fill``,
``_batched_fill`` and ``fold_batch`` run the v3 oracle engine (``fill3``,
``gapped2.build_stencil_consts``); ``batched_fill4`` /
``_span_step4_batched`` differ from ``batched_fill6`` only in JAX's
per-span dispatch, and the port's ``fill4`` already runs ``fill6``'s span
body.
"""

from __future__ import annotations

from ..api import bucket_for, resolve_device
from ..engine.fold import (DENSE_MAX_N, build_consts, consts_from_numpy,
                           fill6_batched, stack_consts)
from ..params.pk import PKPenalties
from ..params.scaling import ScaledParams
from ..precompute import build_seq_tables, pad_seq_tables


def _stack_v4_consts(seqs, P_: ScaledParams, pk: PKPenalties, no_gu=False,
                     pad_to=None, device="cpu"):
    """Each sequence's fill constants and stencil weight tables, padded to
    the bucket of the longest (or ``pad_to``) and stacked on ``device``:
    returns (Cb, SC4b, n_pad).  Scalar energies stay shared Python ints."""
    n_pad = pad_to or bucket_for(max(len(s) for s in seqs))
    if n_pad > DENSE_MAX_N:
        raise ValueError(f"a batched fill is dense, which reaches n = "
                         f"{DENSE_MAX_N}; this batch pads to {n_pad}")
    Cs, SC4s = [], []
    for s in seqs:
        tabs = pad_seq_tables(build_seq_tables(s, P_, pk, no_gu=no_gu),
                              n_pad, P_, pk, no_gu=no_gu)
        C, SC4 = consts_from_numpy(build_consts(tabs, P_, pk), device)
        Cs.append(C)
        SC4s.append(SC4)
    return stack_consts(Cs), stack_consts(SC4s), n_pad


def batched_fill6(seqs, P_: ScaledParams, pk: PKPenalties, no_gu=False,
                  device=None, pad_to=None):
    """Fill ``seqs`` as one batch on ``device`` (default: CUDA, raising when
    there is none).  Returns (state, n_pad): every array of the dense state
    as ``[B, ...]`` on ``device``, B = ``len(seqs)``, each sequence padded
    to ``n_pad``.  ``{k: v[b] for k, v in state.items()}`` is sequence b's
    dense state, equal to its own ``fold.fill6`` at ``n_pad``, which
    ``lazy.LazyMats(.., n_pad)`` reads as it is."""
    dev = resolve_device(device)
    Cb, SC4b, n_pad = _stack_v4_consts(seqs, P_, pk, no_gu=no_gu,
                                       pad_to=pad_to, device=dev)
    return fill6_batched(Cb, SC4b, n_pad, P_.dangles), n_pad
