"""The port's host inputs equal the JAX package's: copied data files, parsed
and scaled parameter tables, and per-sequence tables (exact: all integer
or identically computed float data)."""

import dataclasses
import filecmp

import numpy as np
import pytest

from ccj_tpu import params as jparams
from ccj_tpu import precompute as jpre
from ccj_tpu_torch import params as tparams
from ccj_tpu_torch import precompute as tpre

from oracle_util import REPO

PAR_NAMES = [
    "rna_DirksPierce09.par",
    "rna_Turner04.par",
    "rna_DirksPierce03.par",
    "rna_CaoChen06.par",
    "rna_CaoChen09.par",
    "dna_Matthews04.par",
]
DATA_FILES = PAR_NAMES + ["base_defaults_rna.json", "base_defaults_dna.json"]
SEQ = "GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU"


def assert_same(a, b, where=""):
    """Field-by-field equality of two parameter / table dataclasses."""
    assert type(a).__name__ == type(b).__name__, where
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f"{where}{f.name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{where}{f.name}")
        else:
            assert x == y, f"{where}{f.name}"


@pytest.mark.parametrize("name", DATA_FILES)
def test_data_file_is_byte_identical(name):
    assert filecmp.cmp(REPO / "ccj_tpu" / "params" / name,
                       REPO / "ccj_tpu_torch" / "params" / name, shallow=False)


@pytest.mark.parametrize("name", PAR_NAMES)
def test_parse_and_scale_match(name):
    jt = jparams.parse_par(REPO / "ccj_tpu" / "params" / name)
    tt = tparams.parse_par(REPO / "ccj_tpu_torch" / "params" / name)
    assert_same(jt, tt, f"{name}: ")
    for dangles in (0, 1, 2):
        assert_same(jparams.scale_parameters(jt, dangles=dangles),
                    tparams.scale_parameters(tt, dangles=dangles),
                    f"{name} d{dangles}: ")


@pytest.mark.parametrize("which", ["rna", "dna"])
def test_json_defaults_match(which):
    jf = jparams.default_tables if which == "rna" else jparams.dna_mathews2004_tables
    tf = tparams.default_tables if which == "rna" else tparams.dna_mathews2004_tables
    assert_same(jf(), tf(), f"{which}: ")
    assert_same(jparams.scale_parameters(jf(), temperature=25.0),
                tparams.scale_parameters(tf(), temperature=25.0), f"{which} 25C: ")


@pytest.mark.parametrize("name", PAR_NAMES)
@pytest.mark.parametrize("no_gu", [False, True])
def test_build_seq_tables_match(name, no_gu):
    seq = SEQ[:24]
    jsp = jparams.scale_parameters(jparams.parse_par(REPO / "ccj_tpu" / "params" / name))
    tsp = tparams.scale_parameters(tparams.parse_par(REPO / "ccj_tpu_torch" / "params" / name))
    jt = jpre.build_seq_tables(seq, jsp, jparams.DEFAULT_PK, no_gu=no_gu)
    tt = tpre.build_seq_tables(seq, tsp, tparams.DEFAULT_PK, no_gu=no_gu)
    assert_same(jt, tt, f"{name}: ")
    assert_same(jpre.pad_seq_tables(jt, 32, jsp, jparams.DEFAULT_PK, no_gu=no_gu),
                tpre.pad_seq_tables(tt, 32, tsp, tparams.DEFAULT_PK, no_gu=no_gu),
                f"{name} padded: ")
