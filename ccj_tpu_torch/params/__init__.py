from .io_par import (
    INF,
    MAXLOOP,
    NBPAIRS,
    TURN,
    RawTables,
    default_tables,
    dna_mathews2004_tables,
    parse_par,
)
from .pk import DEFAULT_PK, PKPenalties
from .scaling import ScaledParams, scale_parameters

__all__ = [
    "INF",
    "MAXLOOP",
    "NBPAIRS",
    "TURN",
    "RawTables",
    "default_tables",
    "dna_mathews2004_tables",
    "parse_par",
    "PKPenalties",
    "DEFAULT_PK",
    "ScaledParams",
    "scale_parameters",
]
