"""High-level folding API: sequence in, MFE structure + energy out (PyTorch).

Counterpart of ``ccj_tpu/api.py`` on the dense, non-lazy path.  Mirrors the
reference CLI pipeline (reference: src/CCJ.cc:58-108): validate, T->U
unless noConv, select parameter set (DirksPierce09 default; embedded DNA
Mathews2004 when the unconverted sequence contains T), fill on the device,
traceback on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import torch

from .engine.fold import DENSE_MAX_N, run_fill
from .engine.traceback import Traceback
from .params import (
    DEFAULT_PK,
    PKPenalties,
    RawTables,
    dna_mathews2004_tables,
    parse_par,
    scale_parameters,
)
from .precompute import build_seq_tables, pad_seq_tables
from .seq import seq_to_rna, validate_sequence

PARAMS_DIR = Path(__file__).resolve().parent / "params"
DEFAULT_PARAM_FILE = PARAMS_DIR / "rna_DirksPierce09.par"

# Length buckets (from ccj_tpu/dist/batch.py): a fill padded to a bucket
# gives the same true-length window as an unpadded one
# (precompute.pad_seq_tables), so the bucket shapes are the JAX package's.
BUCKETS = (16, 24, 32, 48, 64, 80, 100, 110, 128, 160, 200, 256, 320)


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return n


@dataclasses.dataclass
class FoldResult:
    seq: str
    structure: str
    energy: float          # kcal/mol
    energy_dcal: int       # exact integer energy (dcal/mol)


@functools.lru_cache(maxsize=8)
def _load_tables(param_file: str | None, dna: bool) -> RawTables:
    if dna:
        return dna_mathews2004_tables()
    if param_file is None:
        return parse_par(DEFAULT_PARAM_FILE)
    return parse_par(param_file)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that raises (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ccj_tpu_torch.fold runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def fold(
    seq: str,
    dangles: int = 2,
    param_file: str | None = None,
    no_gu: bool = False,
    no_conv: bool = False,
    pk: PKPenalties = DEFAULT_PK,
    temperature: float = 37.0,
    bucket: bool = True,
    device=None,
) -> FoldResult:
    """Predict the MFE pseudoknotted secondary structure of one sequence.

    ``device`` is where the fill runs (default: CUDA, raising when there is
    none).  ``bucket`` pads the fill to a length bucket (``BUCKETS``); the
    padded tables' true-length window is bit-identical to an unpadded
    fill, and the host traceback only visits regions inside [1, n].
    Lengths whose fill exceeds ``DENSE_MAX_N`` raise: they need the packed
    storage that ROADMAP queues ("Reach past dense").
    """
    dev = resolve_device(device)
    seq = seq.upper()
    if not no_conv:
        seq = seq_to_rna(seq)
    validate_sequence(seq)

    # DNA auto-selection (embedded Mathews2004 tables + forced noGU) happens
    # ONLY when no -P file is given (reference: src/CCJ.cc:80-98)
    dna = no_conv and "T" in seq and param_file is None
    if dna:
        no_gu = True
    tables = _load_tables(param_file, dna)
    sp = scale_parameters(tables, temperature=temperature, dangles=dangles)
    tabs = build_seq_tables(seq, sp, pk, no_gu=no_gu)
    n_fill = bucket_for(len(seq)) if bucket else len(seq)
    if n_fill > DENSE_MAX_N:
        n_fill = len(seq)
    if n_fill > DENSE_MAX_N:
        raise ValueError(
            f"n={len(seq)} exceeds the dense engine's reach (DENSE_MAX_N="
            f"{DENSE_MAX_N}); longer folds need packed storage (ROADMAP, "
            "'Reach past dense')")
    tabs_fill = pad_seq_tables(tabs, n_fill, sp, pk, no_gu=no_gu)
    mats = run_fill(tabs_fill, sp, pk, dev)
    e_dcal, structure = Traceback(tabs, sp, pk, mats).run()
    return FoldResult(
        seq=seq, structure=structure, energy=e_dcal / 100.0, energy_dcal=e_dcal
    )
