"""Temperature scaling of raw parameter tables into fold-ready tables.

Replicates the reference ``get_scaled_params``
(reference: src/ViennaRNA/params/params.c:399-556):

    G(T) = dH - (dH - G37) * T/T0,  truncated toward zero (C int cast)

Quirk preserved: the reference calls ``scale_parameters()`` *before* the CLI
dangle model is applied (src/W_final.cc:20,25), so the mismatchM/mismatchExt
"clamp to <= 0" rule always runs with the default model (dangles=2).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .io_par import INF, LXC37, MAXLOOP, NBPAIRS, RawTables

K0 = 273.15
TMEASURE = 37.0 + K0
GASCONST = 1.98717  # cal/K


def _rescale(g37, dh, tempf):
    """RESCALE_dG with C double->int truncation."""
    val = np.asarray(dh, dtype=np.float64) - (
        np.asarray(dh, dtype=np.float64) - np.asarray(g37, dtype=np.float64)
    ) * tempf
    return np.trunc(val).astype(np.int32)


@dataclasses.dataclass
class ScaledParams:
    """Temperature-scaled tables (the TPU-native ``vrna_param_t``).

    All arrays int32 in dcal/mol; uploaded to device as constants.
    """

    temperature: float
    dangles: int
    special_hp: bool
    lxc: float
    ninio2: int
    TerminalAU: int
    DuplexInit: int
    MLbase: int
    MLclosing: int
    MLintern: np.ndarray          # [8]
    MAX_NINIO: int
    stack: np.ndarray             # [8,8]
    hairpin: np.ndarray           # [31]
    bulge: np.ndarray             # [31]
    internal_loop: np.ndarray     # [31]
    mismatchExt: np.ndarray       # [8,5,5]
    mismatchI: np.ndarray
    mismatch1nI: np.ndarray
    mismatch23I: np.ndarray
    mismatchH: np.ndarray
    mismatchM: np.ndarray
    dangle5: np.ndarray           # [8,5]
    dangle3: np.ndarray
    int11: np.ndarray             # [8,8,5,5]
    int21: np.ndarray             # [8,8,5,5,5]
    int22: np.ndarray             # [8,8,5,5,5,5]
    Tetraloops: list              # [(seq6, E)]
    Triloops: list                # [(seq5, E)]
    Hexaloops: list               # [(seq8, E)]


def scale_parameters(
    tables: RawTables, temperature: float = 37.0, dangles: int = 2
) -> ScaledParams:
    tempf = (temperature + K0) / TMEASURE
    R = lambda g, h: _rescale(g, h, tempf)

    lxc = tables.lxc37 * tempf

    hairpin = R(tables.hairpin37, tables.hairpindH)
    bulge = R(tables.bulge37, tables.bulgedH)
    internal = R(tables.internal_loop37, tables.internal_loopdH)
    # (reference extrapolates entries past index 30; MAXLOOP == 30, so none)

    # mismatchM / mismatchExt clamp runs under the *default* model (dangles=2)
    mm_m = R(tables.mismatchM37, tables.mismatchMdH)
    mm_e = R(tables.mismatchExt37, tables.mismatchExtdH)
    mm_m = np.minimum(mm_m, 0).astype(np.int32)
    mm_e = np.minimum(mm_e, 0).astype(np.int32)

    d5 = np.minimum(R(tables.dangle5_37, tables.dangle5_dH), 0).astype(np.int32)
    d3 = np.minimum(R(tables.dangle3_37, tables.dangle3_dH), 0).astype(np.int32)

    mlintern = np.full(NBPAIRS + 1, int(R(tables.ML_intern37, tables.ML_interndH)),
                       dtype=np.int32)

    scale_loops = lambda loops: [(s, int(R(e37, edh))) for (s, e37, edh) in loops]

    return ScaledParams(
        temperature=temperature,
        dangles=dangles,
        special_hp=True,
        lxc=lxc,
        ninio2=int(R(tables.ninio37, tables.niniodH)),
        TerminalAU=int(R(tables.TerminalAU37, tables.TerminalAUdH)),
        DuplexInit=int(R(tables.DuplexInit37, tables.DuplexInitdH)),
        MLbase=int(R(tables.ML_BASE37, tables.ML_BASEdH)),
        MLclosing=int(R(tables.ML_closing37, tables.ML_closingdH)),
        MLintern=mlintern,
        MAX_NINIO=int(tables.MAX_NINIO),
        stack=R(tables.stack37, tables.stackdH),
        hairpin=hairpin,
        bulge=bulge,
        internal_loop=internal,
        mismatchExt=mm_e,
        mismatchI=R(tables.mismatchI37, tables.mismatchIdH),
        mismatch1nI=R(tables.mismatch1nI37, tables.mismatch1nIdH),
        mismatch23I=R(tables.mismatch23I37, tables.mismatch23IdH),
        mismatchH=R(tables.mismatchH37, tables.mismatchHdH),
        mismatchM=mm_m,
        dangle5=d5,
        dangle3=d3,
        int11=R(tables.int11_37, tables.int11_dH),
        int21=R(tables.int21_37, tables.int21_dH),
        int22=R(tables.int22_37, tables.int22_dH),
        Tetraloops=scale_loops(tables.Tetraloops),
        Triloops=scale_loops(tables.Triloops),
        Hexaloops=scale_loops(tables.Hexaloops),
    )
