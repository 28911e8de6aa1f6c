"""maf_project and mafFind vs reference goldens.

maf_project goldens embed absolute build paths in their '#' provenance
comments, so those compare block lines only; mafFind goldens were
generated with cwd-relative args and compare byte-exact.
"""

import io
import os

import pytest

from multiz_jax.cli import maf_find as find_cli
from multiz_jax.cli import maf_project as proj_cli

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")
MULTI = os.path.join(DATA, "multi.maf")


def block_lines(text: str):
    return [l for l in text.split("\n") if l and not l.startswith("#")]


def expect(name: str) -> str:
    with open(os.path.join(EXPECT, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("species", ["human", "mouse"])
def test_maf_project_golden(species, capsys):
    proj_cli.main([MULTI, species])
    got = capsys.readouterr().out
    want = expect(f"maf_project_{species}.maf")
    assert block_lines(got) == block_lines(want)


@pytest.mark.parametrize(
    "args,golden",
    [
        (["multi.maf", "5000", "5400"], "maf_find_range.txt"),
        (["multi.maf", "5000", "5400", "mouse"], "maf_find_species.txt"),
        (["multi.maf", "5000", "5400", "slice"], "maf_find_slice.txt"),
        (
            ["multi.maf", "5000", "5400", "mouse", "slice"],
            "maf_find_mouse_slice.txt",
        ),
    ],
)
def test_maf_find_golden(args, golden, monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    find_cli.main(args, out=out)
    assert out.getvalue() == expect(golden)
