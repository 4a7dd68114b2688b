"""Sequence encoding and base-pair typing.

Replicates reference encode_char / encode_sequence / make_pair_matrix
(reference: src/ViennaRNA/pair_mat.h:47-185) for the standard energy set.
Codes: A=1, C=2, G=3, U/T=4; pair types CG=1 GC=2 GU=3 UG=4 AU=5 UA=6 NN=7.
"""

from __future__ import annotations

import numpy as np

TURN = 3

_CODE = {"A": 1, "C": 2, "G": 3, "U": 4, "T": 4}

# BP_pair table restricted to codes 0..4 (reference: pair_mat.h:20-29)
_BP_PAIR = np.array(
    [
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 5],
        [0, 0, 0, 1, 0],
        [0, 0, 2, 0, 3],
        [0, 6, 0, 4, 0],
    ],
    dtype=np.int32,
)

RTYPE = np.array([0, 2, 1, 4, 3, 6, 5, 7], dtype=np.int32)


def validate_sequence(seq: str) -> None:
    if len(seq) == 0:
        raise ValueError("sequence is missing")
    bad = set(seq) - set("GCAUT")
    if bad:
        raise ValueError(
            f"Sequence contains character {sorted(bad)[0]} that is not G,C,A,U, or T."
        )


def seq_to_rna(seq: str) -> str:
    return seq.upper().replace("T", "U")


def encode(seq: str) -> np.ndarray:
    """S encoding, 1-based with S[0]=n and S[n+1]=S[1] (pair_mat.h:158-183).

    For the standard GCAUT alphabet the S1 (alias) encoding has identical
    base codes; only S1[0]=S[n] differs, which nothing downstream reads.
    """
    n = len(seq)
    S = np.zeros(n + 2, dtype=np.int32)
    for i, c in enumerate(seq.upper()):
        S[i + 1] = _CODE.get(c, 0)
    S[0] = n
    if n:
        S[n + 1] = S[1]
    return S


def pair_matrix(no_gu: bool = False) -> np.ndarray:
    pm = _BP_PAIR.copy()
    if no_gu:
        pm[3, 4] = pm[4, 3] = 0
    return pm


def ptype_table(S: np.ndarray, no_gu: bool = False) -> np.ndarray:
    """ptype[i, j] = pair type of (S[i], S[j]); index 0 row/col unused."""
    pm = pair_matrix(no_gu)
    # S[0] holds the sequence length (pair_mat.h encoding); rows/cols 0 and
    # n+1 of the table are never consumed by the DP, so clip for indexing.
    Sc = np.clip(S, 0, 4)
    return pm[Sc[:, None], Sc[None, :]].astype(np.int32)


def can_pair_table(S: np.ndarray, no_gu: bool = False) -> np.ndarray:
    """can_pair[i, j]: canonical pair with hairpin distance j > i + TURN
    (reference: src/pseudo_loop.hh:117-136)."""
    pt = ptype_table(S, no_gu)
    n = len(S) - 2
    idx = np.arange(n + 2)
    dist_ok = idx[None, :] > idx[:, None] + TURN
    return (pt > 0) & dist_ok
