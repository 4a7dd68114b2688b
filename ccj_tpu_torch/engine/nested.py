"""Nested (pseudoknot-free) DP: V / WM / WMv / WMp span updates (PyTorch).

Counterpart of ``ccj_tpu/engine/nested.py``: an exact port of
s_energy_matrix (reference: src/s_energy_matrix.cc) in span-wavefront form,
all cells (i, j=i+s) of one span updated in parallel.  The span functions
update the state dict IN PLACE (each reads every cell it needs before its
write, as the JAX data flow does) and return it.  State arrays and tables
carry a leading batch axis ([B, n2, n2]; fill.fill6 is a batch of one).
Each is one kernel launch a span on the card (``cuda_ops.span_v`` and
``cuda_ops.span_wm``, csrc/span2d.cu); on the CPU their plain versions
(``cuda_ops.span_v_ref``, ``span_wm_ref``) run.  The fills hand
``span_v`` EINT cell-major (:func:`cell_major_eint`) and both kernels
their launch tables, packed once a fill (``cuda_ops.span2d_fill_tables``).
"""

from __future__ import annotations

from . import cuda_ops


def cell_major_eint(C):
    """``C`` with EINT cell-major in memory ([B, n2, n2, 32, 32], the same
    [B, 32, 32, n2, n2] tensor through its strides), as the fills hand it
    to ``span_v``: a cell's interior terms lie in 4 KB, not n2^2 * 4 B
    apart each.  One copy (none where EINT is so already)."""
    E = C["EINT"]
    return {**C, "EINT": E.permute(0, 3, 4, 1, 2).contiguous().permute(0, 3, 4, 1, 2)}


def compute_V_span(C, st, s, dangles, dependent=False):
    """V(i, i+s) for all i (s_energy_matrix.cc:315-358); in place: one
    ``cuda_ops.span_v`` (``dependent``: its programmatic dependent launch,
    for a span loop whose kernels write no EINT, H or MB table)."""
    cuda_ops.span_v(C, st, s, dangles, dependent)
    return st


def compute_WMv_WMp_WM_span(C, st, s, dangles, dependent=False):
    """compute_WMv_WMp + compute_energy_WM for span s
    (s_energy_matrix.cc:206-241); no-op when span < 3 (j-i+1 < 4); in place:
    one ``cuda_ops.span_wm`` (``dependent``: its programmatic dependent
    launch, for a caller whose last kernel before it writes none of V, P2,
    WM, WMv, WMp and the ML tables)."""
    cuda_ops.span_wm(C, st, s, dangles, dependent)
    return st
