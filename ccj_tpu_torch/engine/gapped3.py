"""P(i, l) split contraction over the diagonal-skewed PK copies (PyTorch).

Counterpart of ``compute_P_span3`` in ``ccj_tpu/engine/gapped3.py``, the one
part of that module the dense fill runs.
"""

from __future__ import annotations

import torch

from .common import INF, SAT16, dynamic_slice
from .gapped import _set_P_diag, dims


def compute_P_span3(C, st, s):
    """P(i, i+s) = min over j<d<k of PK(i,j,d+1,k) + PK(j+1,d,k+1,l)
    (pseudo_loop.cc:166-179), as slice reductions over the skewed layouts.

    With a = j-i, b = d-j >= 1, c = k-d >= 1 (a+b+c <= s-1):
      factor1 = PK(i, i+a, d+1, k)   = PKE[b-1, a+c+1, i, a]
      factor2 = PK(j+1, d, k+1, i+s) = PKD[c-1, s-a-1, i+a+1, b-1]
    so for fixed a both factors are slices: no 4-D gathers.

    The JAX version runs the a lanes in chunks of 8 and masks the overrun
    lanes a > s-2 of the last chunk to INF; here the loop visits only
    a in [0, s-2], which leaves the minimum unchanged (and has no use for
    the JAX version's ``s_cap`` bound on the chunk count).  Writes P's
    span-s diagonal in place.
    """
    n = C["n"]
    n2, T, S, U = dims(n)
    PKD, PKE = st["PKD"], st["PKE"]
    dev = PKD.device

    bb = torch.arange(T, device=dev)[:, None, None]       # b-1
    cc = torch.arange(T, device=dev)[None, :, None]       # c-1
    iv = torch.arange(n2, device=dev)[None, None, :]      # i
    sat_rows = torch.full((T, n2, n2), SAT16, dtype=torch.int16, device=dev)
    row_ok = (iv >= 1) & (iv + s <= n)

    p_min = torch.full((n2,), INF, dtype=torch.int32, device=dev)
    for a in range(max(s - 1, 0)):
        # F1[b-1, c-1, i] = PKE[b-1, (a+2)+(c-1), i, a]
        F1 = dynamic_slice(PKE, (0, a + 2, 0, a), (T, T, n2, 1))[..., 0]
        # F2[c-1, i, b-1] = PKD[c-1, s-a-1, i+a+1, b-1]
        sl2 = dynamic_slice(PKD, (0, s - a - 1, 0, 0), (T, 1, n2, n2))[:, 0]
        sl2 = torch.cat([sl2, sat_rows], dim=1)
        F2 = dynamic_slice(sl2, (0, a + 1, 0), (T, n2, T)).permute(2, 0, 1)
        ok = (bb + cc + 2 <= s - 1 - a) & row_ok
        vals = torch.where(ok, F1.to(torch.int32) + F2.to(torch.int32), INF)
        p_min = torch.minimum(p_min, vals.amin(dim=(0, 1)))
    return _set_P_diag(st, n, s, p_min)
