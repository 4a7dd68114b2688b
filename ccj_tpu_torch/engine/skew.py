"""Constant-time diagonal skew/unskew of the trailing axis, batched.

Counterpart of ``ccj_tpu/engine/skew.py``.  The gapped DP's B-layouts store
values at u = j + tt so that j-shrink reductions become fixed-column suffix
scans.  Building a whole span's B-layout at once needs, for every leading
index t, the row shifted right by t: padding each row of a [T, W] matrix to
width W + T + 1 and re-viewing the flat buffer as rows of width W + T
shifts row t right by exactly t positions.

Both directions are exact data movement (no arithmetic): one pad, one
reshape and one slice, over any leading batch axes.
"""

from __future__ import annotations

import torch.nn.functional as F


def skew_right(x, fill):
    """Y[..., t, u] = x[..., t, u - t] for 0 <= u - t < W, else ``fill``.

    x: [..., T, W]  ->  Y: [..., T, W + T]
    """
    *lead, T, W = x.shape
    # rows padded to W + T + 1, then re-viewed as rows of W + T: row t
    # starts t elements later in the flat buffer, i.e. shifts right by t
    xp = F.pad(x, (0, T + 1), value=fill)
    flat = xp.reshape(*lead, T * (W + T + 1))[..., : T * (W + T)]
    return flat.reshape(*lead, T, W + T)


def unskew_right(y, fill, W):
    """Inverse of skew_right: A[..., t, j] = y[..., t, j + t].

    y: [..., T, U]  ->  A: [..., T, W]; reads past a row's end give ``fill``.
    """
    *lead, T, U = y.shape
    # re-view rows of width U + T + 1 as rows of width U + T + 2: row t of
    # the target starts at flat index t * (U + T + 1) + t
    yp = F.pad(y, (0, T + 1), value=fill)
    flat = F.pad(yp.reshape(*lead, T * (U + T + 1)), (0, T), value=fill)
    return flat.reshape(*lead, T, U + T + 2)[..., :W]
