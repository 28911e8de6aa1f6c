"""dna_nib vs reference goldens (nib codec round-trip included)."""

import io
import os

import pytest

from multiz_jax.cli.dna_nib import main as dna_nib_main

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


@pytest.mark.parametrize(
    "tag,frm,to",
    [("fwd", "100", "300"), ("rev", "300", "100"), ("clamp", "-5", "99999")],
)
def test_dna_nib(tag, frm, to):
    out = io.StringIO()
    rc = dna_nib_main(
        [os.path.join(DATA, "test.nib"), frm, to, "myseq"], out=out
    )
    assert rc == 0
    with open(os.path.join(EXPECT, f"dna_nib_{tag}.fa")) as fh:
        assert out.getvalue() == fh.read()
