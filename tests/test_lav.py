"""lav2maf / maf2lav vs reference goldens (round-trip through lav)."""

import io
import os

from multiz_jax.cli import lav2maf as cli_l2m, maf2lav as cli_m2l

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


def read(path):
    with open(path) as fh:
        return fh.read()


def test_maf2lav(monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    cli_m2l.main(["human.chimp.sing.maf", "human", "chimp"], out=out)
    assert out.getvalue() == read(os.path.join(EXPECT, "human.chimp.lav"))


def test_lav2maf(monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    cli_l2m.main(
        [os.path.join(EXPECT, "human.chimp.lav"), "human", "chimp"], out=out
    )
    assert out.getvalue() == read(os.path.join(EXPECT, "lav2maf.maf"))
