"""maf2fasta / get_standard_headers vs reference goldens."""

import io
import os

import pytest

from multiz_jax.cli import get_standard_headers as cli_gsh
from multiz_jax.cli import maf2fasta as cli_m2f

from .conftest import GOLDEN
from .make_golden import M2F_CASES

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


def read(path):
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("name,args", M2F_CASES)
def test_maf2fasta(name, args, monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    assert cli_m2f.main(args, out=out) == 0
    assert out.getvalue() == read(os.path.join(EXPECT, name))


def test_maf2fasta_atoi_wrap(monkeypatch):
    # C atoi wraps 3000000000 negative -> BEG > END fatal (maf2fasta.c:164)
    monkeypatch.chdir(DATA)
    out, err = io.StringIO(), io.StringIO()
    rc = cli_m2f.main(
        ["human", "multi.maf", "0", "3000000000", "fasta"], out=out, err=err
    )
    assert rc == 1
    assert "BEG = 0 > END = -1294967296" in err.getvalue()


def test_get_standard_headers(monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    assert cli_gsh.main(["human"], out=out) == 0
    assert out.getvalue() == read(
        os.path.join(EXPECT, "standard_headers.txt")
    )
