"""Pseudoknot penalty constants (HotKnots v2 derived).

The reference hardcodes these as globals (reference: src/h_globals.hh:7-25);
here they are an overridable config object. Values in dcal/mol.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PKPenalties:
    PS: int = -138     # exterior pseudoloop initiation
    PSM: int = 1007    # pseudoknot inside a multiloop
    PSP: int = 1500    # pseudoknot inside a pseudoloop
    PB: int = 246      # band penalty
    PUP: int = 6       # unpaired base in a pseudoloop / band
    PPS: int = 96      # nested closed region inside pseudoloop / band-multiloop
    e_stP: float = 0.89   # stack-within-pseudoknot scale
    e_intP: float = 0.74  # internal-loop-within-pseudoknot scale
    a: int = 339       # multiloop init
    b: int = 3         # multiloop branch
    c: int = 2         # multiloop unpaired
    ap: int = 341      # band-spanning multiloop init
    bp: int = 56       # band-spanning multiloop branch
    cp: int = 12       # band-spanning multiloop unpaired


DEFAULT_PK = PKPenalties()
