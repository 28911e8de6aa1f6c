"""multic (paralog-tolerant aligner) vs reference goldens."""

import io
import os

import pytest

from multiz_jax.cli import multic as cli_mc

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


def read(path):
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("v", [0, 1])
def test_multic_stdout(v):
    out = io.StringIO()
    cli_mc.main(
        [
            os.path.join(DATA, "human.chimp.sing.maf"),
            os.path.join(DATA, "human.mouse.orig.maf"),
            str(v),
        ],
        out=out,
    )
    assert out.getvalue() == read(os.path.join(EXPECT, f"multic_v{v}.maf"))


def test_multic_unused_files(tmp_path):
    out = io.StringIO()
    u1 = str(tmp_path / "u1.maf")
    u2 = str(tmp_path / "u2.maf")
    cli_mc.main(
        [
            os.path.join(DATA, "human.chimp.orig.maf"),
            os.path.join(DATA, "human.rat.orig.maf"),
            "1",
            u1,
            u2,
        ],
        out=out,
    )
    # the golden args line embeds the generator's paths; compare block lines
    got = [l for l in out.getvalue().split("\n") if not l.startswith("#")]
    want = [
        l
        for l in read(os.path.join(EXPECT, "multic_v1_main.maf")).split("\n")
        if not l.startswith("#")
    ]
    assert got == want
    assert read(u1) == read(os.path.join(EXPECT, "multic_v1_u1.maf"))
    assert read(u2) == read(os.path.join(EXPECT, "multic_v1_u2.maf"))
