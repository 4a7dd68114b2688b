"""P(i, l) split contraction over the diagonal-skewed PK copies (PyTorch).

Counterpart of ``compute_P_span3`` in ``ccj_tpu/engine/gapped3.py``, the one
part of that module the dense fill runs.  The contraction itself is
``cuda_ops.p_split`` (one launch a span on the card), which takes any range
of rows, so the row shards of dist/wavefront.py run it on theirs.  The
fills take its minima (:func:`p_split_minima`) into ``cuda_ops.span_wbp``,
which writes P's span-s diagonal in its own launch;
:func:`compute_P_span3` writes it apart.
"""

from __future__ import annotations

from . import cuda_ops
from .gapped import _set_P_diag, dims


def compute_P_span3(C, st, s):
    """P(i, i+s) = min over j<d<k of PK(i,j,d+1,k) + PK(j+1,d,k+1,l)
    (pseudo_loop.cc:166-179) for every row; writes P's span-s diagonal in
    place, for every element of the state's batch.

    With a = j-i, b = d-j >= 1, c = k-d >= 1 (a+b+c <= s-1):
      factor1 = PK(i, i+a, d+1, k)   = PKE[b-1, a+c+1, i, a]
      factor2 = PK(j+1, d, k+1, i+s) = PKD[c-1, s-a-1, i+a+1, b-1]
    so for fixed a both factors are slices: no 4-D gathers
    (``cuda_ops.p_split``, PKD read in place: span s-1-a, rows from 1+a).
    The JAX version runs the a lanes in chunks of 8 and masks the overrun
    lanes a > s-2 of the last chunk to INF; here only a in [0, s-2] is
    visited, which leaves the minimum unchanged.
    """
    p_min = p_split_minima(C, st, s)
    return st if p_min is None else _set_P_diag(st, C["n"], s, p_min)


def p_split_minima(C, st, s):
    """The P split's minima of span s for every row (int32 [B, n2], INF
    where no candidate: :func:`compute_P_span3`'s, unwritten), or None for a
    span without a term or a live row (s < 3 or s >= n), which leaves P's
    diagonal as it is."""
    n = C["n"]
    if not 3 <= s < n:
        return None
    pkd = st["PKD"].transpose(1, 2)                 # [B, span, c-1, row, b-1]
    return cuda_ops.p_split(st["PKE"], pkd, s=s, n=n, i0=0, R=dims(n)[0],
                            sp=(s - 1, -1), ro=(1, 1))
