"""RNAfold v2.0 ``.par`` energy-parameter file parser.

Replicates the reference reader semantics exactly
(reference: src/ViennaRNA/params/io.c:440-780):

* sections are introduced by ``# <name>`` lines; unknown sections are ignored
* ``/* ... */`` comments are excised (one per line)
* tokens: integers, ``INF`` (10^7), ``NST`` (0), ``DEF`` (-50), ``*`` (keep the
  current/default value), ``x`` (log-extrapolate from the last integer entry)
* a loaded file *overlays* the built-in default parameter set: sections that
  are absent keep their default values (io.c mutates global tables in place)
* ``int22`` sections only cover standard pairs/bases; non-standard entries are
  recomputed with the max-rule (io.c:1184 ``update_nst``)
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path

import numpy as np

INF = 10_000_000
NBPAIRS = 7
MAXLOOP = 30
TURN = 3
LXC37 = 107.856  # reference: src/ViennaRNA/params/default.c:64 (not read from file)

_DATA_DIR = Path(__file__).resolve().parent
_BASE_RNA_JSON = Path(__file__).resolve().parent / "base_defaults_rna.json"
_BASE_DNA_JSON = Path(__file__).resolve().parent / "base_defaults_dna.json"


@dataclasses.dataclass
class RawTables:
    """Un-scaled parameter tables: free energies at 37C plus enthalpies.

    Mirrors the globals in the reference's params/default.c; all energies in
    dcal/mol (int32).
    """

    stack37: np.ndarray
    stackdH: np.ndarray
    hairpin37: np.ndarray
    hairpindH: np.ndarray
    bulge37: np.ndarray
    bulgedH: np.ndarray
    internal_loop37: np.ndarray
    internal_loopdH: np.ndarray
    mismatchExt37: np.ndarray
    mismatchExtdH: np.ndarray
    mismatchH37: np.ndarray
    mismatchHdH: np.ndarray
    mismatchI37: np.ndarray
    mismatchIdH: np.ndarray
    mismatch1nI37: np.ndarray
    mismatch1nIdH: np.ndarray
    mismatch23I37: np.ndarray
    mismatch23IdH: np.ndarray
    mismatchM37: np.ndarray
    mismatchMdH: np.ndarray
    dangle5_37: np.ndarray
    dangle5_dH: np.ndarray
    dangle3_37: np.ndarray
    dangle3_dH: np.ndarray
    int11_37: np.ndarray
    int11_dH: np.ndarray
    int21_37: np.ndarray
    int21_dH: np.ndarray
    int22_37: np.ndarray
    int22_dH: np.ndarray
    ML_BASE37: int
    ML_BASEdH: int
    ML_closing37: int
    ML_closingdH: int
    ML_intern37: int
    ML_interndH: int
    ninio37: int
    niniodH: int
    MAX_NINIO: int
    DuplexInit37: int
    DuplexInitdH: int
    TerminalAU37: int
    TerminalAUdH: int
    # special hairpin loops: parallel lists of (sequence, dG37, dH)
    Tetraloops: list
    Triloops: list
    Hexaloops: list
    lxc37: float = LXC37

    def copy(self) -> "RawTables":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                kw[f.name] = v.copy()
            elif isinstance(v, list):
                kw[f.name] = list(v)
            else:
                kw[f.name] = v
        return RawTables(**kw)


class _TokenStream:
    """Token-by-token reader over the file lines (io.c get_array1 semantics)."""

    def __init__(self, lines, pos):
        self.lines = lines
        self.pos = pos  # index of next line to consume
        self._cur = []  # remaining tokens on the current line
        self.lxc_base = None

    @staticmethod
    def _strip_comment(line):
        # one C-style comment per line (io.c:1100 ignore_comment)
        m = re.search(r"/\*.*?\*/", line)
        if m:
            line = line[: m.start()] + line[m.end() :]
        return line

    def _next_token(self):
        while not self._cur:
            if self.pos >= len(self.lines):
                raise ValueError("unexpected end of file in get_array1")
            line = self._strip_comment(self.lines[self.pos])
            self.pos += 1
            self._cur = line.split()
        return self._cur.pop(0)

    def finish_line(self):
        """Discard leftover tokens on the current line (reader stops mid-line)."""
        self._cur = []

    def read_array(self, flat_view, size):
        """Fill ``size`` entries of the 1-D int view, honoring special tokens."""
        i = 0
        last = 0
        while i < size:
            tok = self._next_token()
            if tok.startswith("*"):
                i += 1  # '*': keep the existing (default) entry
                continue
            if tok.startswith("x"):
                if i == 0:
                    raise ValueError("can't extrapolate first value")
                p = int(flat_view[last] + int(0.5 + LXC37 * math.log(i / last)))
            elif tok == "DEF":
                p = -50
            elif tok == "INF":
                p = INF
            elif tok == "NST":
                p = 0
            else:
                p = int(tok)
                last = i
            flat_view[i] = p
            i += 1
        self.finish_line()


def _rd_slice(ts, array, shift, post):
    """rd_Ndim_slice: read the [shift, dim-post) hyper-rectangle row-major."""
    dims = array.shape
    sub = array[tuple(slice(s, d - p) for s, d, p in zip(shift, dims, post))]
    # row-major fill of the sub-block while keeping other entries untouched
    flat = np.ascontiguousarray(sub).reshape(-1)
    ts.read_array(flat, flat.size)
    array[tuple(slice(s, d - p) for s, d, p in zip(shift, dims, post))] = flat.reshape(
        sub.shape
    )


def _rd_special_loops(ts, seqlen):
    """Triloops/Tetraloops/Hexaloops: '<seq> <dG> <dH>' lines until mismatch."""
    out = []
    while ts.pos < len(ts.lines):
        line = ts.lines[ts.pos]
        ts.pos += 1  # io.c consumes the terminating line too (rd_Tetraloop37)
        parts = line.split()
        if len(parts) < 3:
            break
        try:
            e37, edh = int(parts[1]), int(parts[2])
        except ValueError:
            break
        out.append((parts[0][:seqlen], e37, edh))
        if len(out) >= 40:
            break
    return out


def _update_nst(a):
    """Fill non-standard-base entries of int22 (io.c:1184 update_nst)."""
    # one non-standard nucleotide
    for i in range(1, NBPAIRS):
        for j in range(1, NBPAIRS):
            blk = a[i, j]
            for k in range(1, 5):
                for l in range(1, 5):
                    for m in range(1, 5):
                        blk[k, l, m, 0] = blk[k, l, m, 1:5].max()
                        blk[k, l, 0, m] = blk[k, l, 1:5, m].max()
                        blk[k, 0, l, m] = blk[k, 1:5, l, m].max()
                        blk[0, k, l, m] = blk[1:5, k, l, m].max()
            for k in range(1, 5):
                for l in range(1, 5):
                    blk[k, l, 0, 0] = max(blk[k, l, m, 0] for m in range(1, 5))
                    blk[k, 0, 0, l] = max(blk[k, m, 0, l] for m in range(1, 5))
                    blk[0, 0, k, l] = max(blk[m, 0, k, l] for m in range(1, 5))
                    blk[k, 0, l, 0] = max(blk[k, 0, l, m] for m in range(1, 5))
                    blk[0, k, 0, l] = max(blk[0, k, m, l] for m in range(1, 5))
                    blk[0, k, l, 0] = max(blk[0, k, l, m] for m in range(1, 5))
            for k in range(1, 5):
                blk[k, 0, 0, 0] = max(blk[k, l, 0, 0] for l in range(1, 5))
                blk[0, k, 0, 0] = max(blk[0, k, l, 0] for l in range(1, 5))
                blk[0, 0, k, 0] = max(blk[0, 0, k, l] for l in range(1, 5))
                blk[0, 0, 0, k] = max(blk[0, 0, l, k] for l in range(1, 5))
            blk[0, 0, 0, 0] = max(blk[k, 0, 0, 0] for k in range(1, 5))
    # non-standard base pairs (pair type 7): maxima over standard pairs
    for i in range(1, NBPAIRS):
        a[i, NBPAIRS] = a[i, 1:NBPAIRS].max(axis=0)
        a[NBPAIRS, i] = a[1:NBPAIRS, i].max(axis=0)
    a[NBPAIRS, NBPAIRS] = a[NBPAIRS, 1:NBPAIRS].max(axis=0)


_SECTION_SPECS = {
    # name -> (field, shift, post)
    "stack": ("stack37", (1, 1), (0, 0)),
    "stack_enthalpies": ("stackdH", (1, 1), (0, 0)),
    "mismatch_exterior": ("mismatchExt37", (1, 0, 0), (0, 0, 0)),
    "mismatch_exterior_enthalpies": ("mismatchExtdH", (1, 0, 0), (0, 0, 0)),
    "mismatch_hairpin": ("mismatchH37", (1, 0, 0), (0, 0, 0)),
    "mismatch_hairpin_enthalpies": ("mismatchHdH", (1, 0, 0), (0, 0, 0)),
    "mismatch_interior": ("mismatchI37", (1, 0, 0), (0, 0, 0)),
    "mismatch_interior_enthalpies": ("mismatchIdH", (1, 0, 0), (0, 0, 0)),
    "mismatch_interior_1n": ("mismatch1nI37", (1, 0, 0), (0, 0, 0)),
    "mismatch_interior_1n_enthalpies": ("mismatch1nIdH", (1, 0, 0), (0, 0, 0)),
    "mismatch_interior_23": ("mismatch23I37", (1, 0, 0), (0, 0, 0)),
    "mismatch_interior_23_enthalpies": ("mismatch23IdH", (1, 0, 0), (0, 0, 0)),
    "mismatch_multi": ("mismatchM37", (1, 0, 0), (0, 0, 0)),
    "mismatch_multi_enthalpies": ("mismatchMdH", (1, 0, 0), (0, 0, 0)),
    "int11": ("int11_37", (1, 1, 0, 0), (0, 0, 0, 0)),
    "int11_enthalpies": ("int11_dH", (1, 1, 0, 0), (0, 0, 0, 0)),
    "int21": ("int21_37", (1, 1, 0, 0, 0), (0, 0, 0, 0, 0)),
    "int21_enthalpies": ("int21_dH", (1, 1, 0, 0, 0), (0, 0, 0, 0, 0)),
    "int22": ("int22_37", (1, 1, 1, 1, 1, 1), (1, 1, 0, 0, 0, 0)),
    "int22_enthalpies": ("int22_dH", (1, 1, 1, 1, 1, 1), (1, 1, 0, 0, 0, 0)),
    "dangle5": ("dangle5_37", (1, 0), (0, 0)),
    "dangle5_enthalpies": ("dangle5_dH", (1, 0), (0, 0)),
    "dangle3": ("dangle3_37", (1, 0), (0, 0)),
    "dangle3_enthalpies": ("dangle3_dH", (1, 0), (0, 0)),
}
_SECTION_1D = {
    "hairpin": ("hairpin37", 31),
    "hairpin_enthalpies": ("hairpindH", 31),
    "bulge": ("bulge37", 31),
    "bulge_enthalpies": ("bulgedH", 31),
    "interior": ("internal_loop37", 31),
    "interior_enthalpies": ("internal_loopdH", 31),
}


def _empty_tables() -> RawTables:
    z = lambda *shape: np.zeros(shape, dtype=np.int64)
    return RawTables(
        stack37=z(8, 8), stackdH=z(8, 8),
        hairpin37=z(31), hairpindH=z(31),
        bulge37=z(31), bulgedH=z(31),
        internal_loop37=z(31), internal_loopdH=z(31),
        mismatchExt37=z(8, 5, 5), mismatchExtdH=z(8, 5, 5),
        mismatchH37=z(8, 5, 5), mismatchHdH=z(8, 5, 5),
        mismatchI37=z(8, 5, 5), mismatchIdH=z(8, 5, 5),
        mismatch1nI37=z(8, 5, 5), mismatch1nIdH=z(8, 5, 5),
        mismatch23I37=z(8, 5, 5), mismatch23IdH=z(8, 5, 5),
        mismatchM37=z(8, 5, 5), mismatchMdH=z(8, 5, 5),
        dangle5_37=z(8, 5), dangle5_dH=z(8, 5),
        dangle3_37=z(8, 5), dangle3_dH=z(8, 5),
        int11_37=z(8, 8, 5, 5), int11_dH=z(8, 8, 5, 5),
        int21_37=z(8, 8, 5, 5, 5), int21_dH=z(8, 8, 5, 5, 5),
        int22_37=z(8, 8, 5, 5, 5, 5), int22_dH=z(8, 8, 5, 5, 5, 5),
        ML_BASE37=0, ML_BASEdH=0, ML_closing37=0, ML_closingdH=0,
        ML_intern37=0, ML_interndH=0,
        ninio37=0, niniodH=0, MAX_NINIO=300,
        DuplexInit37=0, DuplexInitdH=0, TerminalAU37=0, TerminalAUdH=0,
        Tetraloops=[], Triloops=[], Hexaloops=[],
    )


def parse_par(path, base: RawTables | None = None) -> RawTables:
    """Parse a ``.par`` file, overlaying onto ``base`` (default: built-ins)."""
    tables = (base or default_tables()).copy()
    lines = Path(path).read_text().splitlines()
    if not lines or not lines[0].startswith("## RNAfold parameter file v2.0"):
        raise ValueError(f"{path}: missing 'RNAfold parameter file v2.0' header")

    ts = _TokenStream(lines, 1)
    while ts.pos < len(ts.lines):
        line = ts.lines[ts.pos]
        ts.pos += 1
        m = re.match(r"#\s*(\S+)", line)
        if not m:
            continue
        ident = m.group(1)
        if ident == "END":
            break
        if ident in _SECTION_SPECS:
            field, shift, post = _SECTION_SPECS[ident]
            arr = getattr(tables, field)
            _rd_slice(ts, arr, shift, post)
            if ident.startswith("int22"):
                _update_nst(arr)
        elif ident in _SECTION_1D:
            field, size = _SECTION_1D[ident]
            ts.read_array(getattr(tables, field), size)
        elif ident == "ML_params":
            v = np.zeros(6, dtype=np.int64)
            ts.read_array(v, 6)
            (tables.ML_BASE37, tables.ML_BASEdH, tables.ML_closing37,
             tables.ML_closingdH, tables.ML_intern37, tables.ML_interndH) = map(int, v)
        elif ident == "NINIO":
            v = np.zeros(3, dtype=np.int64)
            ts.read_array(v, 3)
            tables.ninio37, tables.niniodH, tables.MAX_NINIO = map(int, v)
        elif ident == "Misc":
            v = np.zeros(4, dtype=np.int64)
            ts.read_array(v, 4)
            (tables.DuplexInit37, tables.DuplexInitdH,
             tables.TerminalAU37, tables.TerminalAUdH) = map(int, v)
        elif ident == "Tetraloops":
            tables.Tetraloops = _rd_special_loops(ts, 6)
        elif ident == "Triloops":
            tables.Triloops = _rd_special_loops(ts, 5)
        elif ident == "Hexaloops":
            tables.Hexaloops = _rd_special_loops(ts, 8)
        # unknown sections: ignored (io.c warns only)
    return tables


_DEFAULT_CACHE: dict = {}


def _loops_from_json(cat: str, e37, edh, slot: int):
    out = []
    seqs = [s for s in cat.split(" ") if s]
    for i, s in enumerate(seqs):
        out.append((s, int(e37[i]), int(edh[i])))
    return out


def _tables_from_json(path) -> RawTables:
    import json

    d = json.loads(Path(path).read_text())
    t = _empty_tables()
    arr = lambda k, shape: np.array(d[k], dtype=np.int64).reshape(shape)
    t.stack37 = arr("stack37", (8, 8)); t.stackdH = arr("stackdH", (8, 8))
    t.hairpin37 = arr("hairpin37", (31,)); t.hairpindH = arr("hairpindH", (31,))
    t.bulge37 = arr("bulge37", (31,)); t.bulgedH = arr("bulgedH", (31,))
    t.internal_loop37 = arr("internal_loop37", (31,))
    t.internal_loopdH = arr("internal_loopdH", (31,))
    for nm in ("mismatchI", "mismatch1nI", "mismatch23I", "mismatchH",
               "mismatchM", "mismatchExt"):
        setattr(t, nm + "37", arr(nm + "37", (8, 5, 5)))
        setattr(t, nm + "dH", arr(nm + "dH", (8, 5, 5)))
    t.dangle5_37 = arr("dangle5_37", (8, 5)); t.dangle5_dH = arr("dangle5_dH", (8, 5))
    t.dangle3_37 = arr("dangle3_37", (8, 5)); t.dangle3_dH = arr("dangle3_dH", (8, 5))
    t.int11_37 = arr("int11_37", (8, 8, 5, 5)); t.int11_dH = arr("int11_dH", (8, 8, 5, 5))
    t.int21_37 = arr("int21_37", (8, 8, 5, 5, 5)); t.int21_dH = arr("int21_dH", (8, 8, 5, 5, 5))
    t.int22_37 = arr("int22_37", (8, 8, 5, 5, 5, 5)); t.int22_dH = arr("int22_dH", (8, 8, 5, 5, 5, 5))
    t.ML_BASE37 = int(d["ML_BASE37"]); t.ML_BASEdH = int(d["ML_BASEdH"])
    t.ML_closing37 = int(d["ML_closing37"]); t.ML_closingdH = int(d["ML_closingdH"])
    t.ML_intern37 = int(d["ML_intern37"]); t.ML_interndH = int(d["ML_interndH"])
    t.ninio37 = int(d["ninio37"]); t.niniodH = int(d["niniodH"])
    t.MAX_NINIO = int(d["MAX_NINIO"])
    t.DuplexInit37 = int(d["DuplexInit37"]); t.DuplexInitdH = int(d["DuplexInitdH"])
    t.TerminalAU37 = int(d["TerminalAU37"]); t.TerminalAUdH = int(d["TerminalAUdH"])
    t.Tetraloops = _loops_from_json(d["Tetraloops"], d["Tetraloop37"], d["TetraloopdH"], 7)
    t.Triloops = _loops_from_json(d["Triloops"], d["Triloop37"], d["TriloopdH"], 6)
    t.Hexaloops = _loops_from_json(d["Hexaloops"], d["Hexaloop37"], d["HexaloopdH"], 9)
    t.lxc37 = float(d["lxc37"])
    return t


def default_tables() -> RawTables:
    """Built-in Turner 2004 defaults (reference: ViennaRNA/params/default.c)."""
    if "rna" not in _DEFAULT_CACHE:
        _DEFAULT_CACHE["rna"] = _tables_from_json(_BASE_RNA_JSON)
    return _DEFAULT_CACHE["rna"]


def dna_mathews2004_tables() -> RawTables:
    """Embedded DNA Mathews 2004 set (reference: static/energy_parameter_sets.h)."""
    if "dna" not in _DEFAULT_CACHE:
        _DEFAULT_CACHE["dna"] = _tables_from_json(_BASE_DNA_JSON)
    return _DEFAULT_CACHE["dna"]
