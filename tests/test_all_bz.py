"""all_bz + blastzWrapper vs reference goldens (fake-lastz driven)."""

import io
import os
import stat
import subprocess
import sys

import pytest

from multiz_jax.blastz_wrapper import main as bzw_main
from multiz_jax.cli.all_bz import main as all_bz_main

from .conftest import GOLDEN
from .make_golden import ALL_BZ_DRY_CASES

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")


def read(path):
    with open(path) as fh:
        return fh.read()


@pytest.fixture()
def fake_lastz(tmp_path, monkeypatch):
    """PATH shim emitting canned lav fixtures instead of real lastz."""
    path = tmp_path / "lastz"
    path.write_text(
        "#!/bin/sh\n"
        "cat /dev/stdin > /dev/null 2>/dev/null || true\n"
        'case "$1 $2" in\n'
        f'  *chimp*) cat {os.path.join(EXPECT, "human.chimp.lav")} ;;\n'
        f'  *two.fa*) cat {os.path.join(DATA, "canned.lav")} ;;\n'
        '  *) echo "#:lav"; echo "#:eof" ;;\n'
        "esac\n"
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv(
        "PATH", str(tmp_path) + os.pathsep + os.environ.get("PATH", "")
    )
    return path


@pytest.mark.parametrize("name,args", ALL_BZ_DRY_CASES)
def test_all_bz_dry_run(name, args, monkeypatch):
    monkeypatch.chdir(DATA)
    args = [os.path.join(DATA, "bz_spec") if a == "SPEC" else a for a in args]
    out, err = io.StringIO(), io.StringIO()
    assert all_bz_main(args, out=out, err=err) == 0
    assert out.getvalue() == read(os.path.join(EXPECT, name))


@pytest.mark.parametrize(
    "tag,pair",
    [
        ("fwd", ["one.fa", "two.fa"]),
        ("rev", ["two.fa", "one.fa"]),
        ("multi", ["two.fa", "two.fa"]),
    ],
)
def test_blastz_wrapper(tag, pair, fake_lastz, monkeypatch):
    monkeypatch.chdir(DATA)
    out = io.StringIO()
    assert bzw_main([*pair, "Y=9000"], out=out) == 0
    assert out.getvalue() == read(os.path.join(EXPECT, f"bzw_{tag}.lav"))


def test_all_bz_execute(fake_lastz, tmp_path, monkeypatch):
    """In-process concurrent execution: blastzWrapper -> lav2maf ->
    maf_sort -> single_cov2, vs the reference shell pipeline's outputs
    (tests/golden/expect, '#' provenance lines stripped)."""
    for f in ("human", "chimp"):
        (tmp_path / f).write_bytes(
            open(os.path.join(DATA, f), "rb").read()
        )
    monkeypatch.chdir(tmp_path)
    out, err = io.StringIO(), io.StringIO()
    assert all_bz_main(["((human chimp))"], out=out, err=err) == 0

    def body(text):
        return [l for l in text.split("\n") if not l.startswith("#")]

    got = read(str(tmp_path / "human.chimp.sing.maf"))
    want = read(os.path.join(EXPECT, "human.chimp.sing.maf"))
    assert body(got) == body(want)
